"""``remat`` (the trunk blocks under ``torch.utils.checkpoint``) on the CPU.

- Remat on and off give bitwise-equal losses, gradients and updated
  weights for both trainers, with ``use_dropout`` (the masks are drawn once,
  ahead of the checkpoint, so the recomputed forward drops the same
  elements: checkpoint's RNG preservation does not cover an explicit
  ``torch.Generator``) and with ``norm='batch'`` (the recomputed forward
  leaves the running averages alone); the state dict keys do not depend on
  remat.
- Remat on against the JAX step with ``remat=True``: 3 steps of each
  trainer within the 3-step bars (rtol 2e-3 on the total losses, ``d_total``
  1e-2 / atol 1e-3).
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from cyclegan_tpu.train.cyclegan import CycleGANTrainer as JaxCycleGAN
from cyclegan_tpu.train.supervised import SupervisedTrainer as JaxSupervised
from cyclegan_tpu.utils import config as jconfig
from cyclegan_tpu_torch import weights
from cyclegan_tpu_torch.train.cyclegan import CycleGANTrainer
from cyclegan_tpu_torch.train.supervised import SupervisedTrainer
from cyclegan_tpu_torch.utils.config import Config

N_CLASSES, SIZE = 5, 32
KW = dict(ngf=4, ndf=4, crop_height=SIZE, crop_width=SIZE, bf16=False, pool_size=2,
          batch_size=2, epochs=200, decay_epoch=100)


@pytest.fixture(autouse=True, scope="module")
def _few_torch_threads():
    """Two intra-op threads: the suite runs several workers on one host."""
    n = torch.get_num_threads()
    torch.set_num_threads(2)
    yield
    torch.set_num_threads(n)


def _batch(seed=5):
    r = np.random.default_rng(seed)
    lab = r.integers(0, N_CLASSES, (2, SIZE, SIZE)).astype(np.int32)
    lab[:, :3] = 255
    return {"lab_image": r.uniform(-1, 1, (2, SIZE, SIZE, 3)).astype(np.float32),
            "unlab_image": r.uniform(-1, 1, (2, SIZE, SIZE, 3)).astype(np.float32),
            "lab_label": lab}


def _run(make, remat: bool, batch: dict, steps: int = 2):
    trainer = make(remat)
    state = trainer.init_state(torch.Generator().manual_seed(0))
    out = []
    for _ in range(steps):
        state, m = trainer.train_step(state, {k: torch.from_numpy(v) for k, v in batch.items()})
        grads = {f"{i}.{n}": p.grad.clone() for i, net in enumerate(trainer.nets())
                 for n, p in net.named_parameters()}
        out.append(({k: float(v) for k, v in m.items()}, grads))
    sd = {f"{i}.{k}": v.clone() for i, net in enumerate(trainer.nets())
          for k, v in net.state_dict().items()}
    return out, sd


@pytest.mark.parametrize("kind,norm", [("cyclegan", "instance"), ("cyclegan", "batch"),
                                       ("supervised", "instance"), ("supervised", "batch")])
def test_remat_is_bitwise_remat_off(kind, norm):
    cfg = Config(gen_net="resnet_2blocks", norm=norm, use_dropout=True, **KW)
    if kind == "cyclegan":
        batch = _batch()

        def make(remat):
            return CycleGANTrainer(cfg.replace(remat=remat), N_CLASSES, 3, 4, device="cpu")
    else:
        b = _batch()
        batch = {"image": b["lab_image"], "label": b["lab_label"]}

        def make(remat):
            return SupervisedTrainer(cfg.replace(remat=remat), N_CLASSES, 3, 4, device="cpu")

    (off, sd_off), (on, sd_on) = _run(make, False, batch), _run(make, True, batch)
    assert sd_off.keys() == sd_on.keys()
    for (m_off, g_off), (m_on, g_on) in zip(off, on):
        assert m_off == m_on
        assert g_off.keys() == g_on.keys()
        for k in g_off:
            assert torch.equal(g_off[k], g_on[k]), k
    for k in sd_off:
        assert torch.equal(sd_off[k], sd_on[k]), k


def test_remat_recomputes_the_trunk_in_the_backward():
    """The trunk's forward runs twice under remat (the recompute), once
    without; a forward without gradients never checkpoints."""
    calls = []
    t = SupervisedTrainer(Config(gen_net="resnet_2blocks", remat=True, **KW), N_CLASSES, 3, 4,
                          device="cpu")
    t.model.trunk[0].register_forward_pre_hook(lambda *a: calls.append(1))
    st = t.init_state(torch.Generator().manual_seed(0))
    b = _batch()
    t.train_step(st, {"image": torch.from_numpy(b["lab_image"]),
                      "label": torch.from_numpy(b["lab_label"])})
    assert len(calls) == 2
    t.predict(torch.from_numpy(b["lab_image"]))
    assert len(calls) == 3


def test_remat_steps_match_jax_remat():
    b = _batch()
    kw = dict(KW, gen_net="resnet_6blocks", pool_size=0, remat=True, ngf=8, ndf=8)
    # Supervised, 3 steps.
    jt = JaxSupervised(jconfig.Config(**kw), N_CLASSES, 3, steps_per_epoch=1000)
    js = jt.init_state(jax.random.PRNGKey(0))
    tt = SupervisedTrainer(Config(**kw), N_CLASSES, 3, 1000, device="cpu")
    ts = tt.init_state(torch.Generator().manual_seed(0))
    weights.load_flax_module(tt.model, jax.device_get(js.params))
    sb = {"image": b["lab_image"], "label": b["lab_label"]}
    step = jax.jit(jt.train_step)
    for s in range(3):
        js, jm = step(js, {k: jnp.asarray(v) for k, v in sb.items()})
        ts, tm = tt.train_step(ts, {k: torch.from_numpy(v) for k, v in sb.items()})
        np.testing.assert_allclose(float(tm["ce_loss"]), float(jm["ce_loss"]), rtol=2e-3,
                                   err_msg=f"supervised ce_loss, step {s}")
    # CycleGAN, 3 steps (2 trunk blocks, batch 1).
    kw = dict(kw, batch_size=1)
    jc = JaxCycleGAN(jconfig.Config(**kw), N_CLASSES, 3, steps_per_epoch=1000)
    jc.G_i2l = jc.G_i2l.clone(n_blocks=2)
    jc.G_l2i = jc.G_l2i.clone(n_blocks=2)
    jcs = jc.init_state(jax.random.PRNGKey(0))
    tc = CycleGANTrainer(Config(**dict(kw, gen_net="resnet_2blocks")), N_CLASSES, 3, 1000,
                         device="cpu")
    tcs = tc.init_state(torch.Generator().manual_seed(0))
    weights.load_flax_cyclegan(tc, jcs)
    cb = {k: v[:1] for k, v in b.items()}
    step = jax.jit(jc.train_step)
    for s in range(3):
        jcs, jm = step(jcs, {k: jnp.asarray(v) for k, v in cb.items()})
        tcs, tm = tc.train_step(tcs, {k: torch.from_numpy(v) for k, v in cb.items()})
        np.testing.assert_allclose(float(tm["g_total"]), float(jm["g_total"]), rtol=2e-3,
                                   err_msg=f"g_total, step {s}")
        np.testing.assert_allclose(float(tm["d_total"]), float(jm["d_total"]), rtol=1e-2,
                                   atol=1e-3, err_msg=f"d_total, step {s}")
