"""The port's training slice against the JAX package, on the CPU.

Discriminators, losses, the LR schedule with Adam, the replay pool, the
config and the synthetic data against their JAX counterparts; then the whole
``CycleGANTrainer.train_step`` against the jitted JAX step on the same
bridged weights, batch and injected pool decisions (ngf 8, ndf 8, 5 classes,
32x32, 2 trunk blocks, float32). Bars are those of
``tests/test_train_parity.py``: per-step ``g_total`` rtol 2e-3, ``d_total``
rtol 1e-2 / atol 1e-3, final G_i2l logits atol 2e-3; the pool bit-exact.
"""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch

from cyclegan_tpu.data.datasets import DATASET_SPECS as JAX_SPECS
from cyclegan_tpu.data.datasets import _synthetic_sample as jax_synthetic
from cyclegan_tpu.models.discriminators import define_Dis as jax_define_Dis
from cyclegan_tpu.train import losses as jl
from cyclegan_tpu.train import pool as jpool
from cyclegan_tpu.train import schedule as jsched
from cyclegan_tpu.train.cyclegan import CycleGANTrainer as JaxTrainer
from cyclegan_tpu.utils import config as jconfig
from cyclegan_tpu_torch import weights
from cyclegan_tpu_torch.data.datasets import DATASET_SPECS, _synthetic_sample
from cyclegan_tpu_torch.models import define_Dis
from cyclegan_tpu_torch.train import losses as tl
from cyclegan_tpu_torch.train import pool as tpool
from cyclegan_tpu_torch.train import schedule as tsched
from cyclegan_tpu_torch.train.cyclegan import CycleGANTrainer
from cyclegan_tpu_torch.utils import config as tconfig

N_CLASSES, SIZE, NGF, NDF, NB = 5, 32, 8, 8, 2
CFG_KW = dict(ngf=NGF, ndf=NDF, crop_height=SIZE, crop_width=SIZE, bf16=False,
              epochs=200, decay_epoch=100)


def _rng(seed):
    return np.random.default_rng(seed)


# ---------------------------------------------------------------- models
@pytest.mark.parametrize("netD,in_ch", [("n_layers", 3), ("n_layers", N_CLASSES),
                                        ("pixel", 3)])
def test_discriminator_matches_flax(netD, in_ch):
    jd = jax_define_Dis(NDF, netD, 3, "instance")
    x = _rng(1).uniform(-1, 1, (2, SIZE, SIZE, in_ch)).astype(np.float32)
    params = jax.device_get(jd.init(jax.random.PRNGKey(0), jnp.asarray(x)))
    ref = np.asarray(jd.apply(params, jnp.asarray(x)))
    td = define_Dis(in_ch, NDF, netD, 3, "instance")
    weights.load_flax_module(td, params["params"])
    with torch.inference_mode():
        got = td(torch.from_numpy(x).permute(0, 3, 1, 2)).permute(0, 2, 3, 1).numpy()
    assert got.shape == ref.shape
    np.testing.assert_allclose(got, ref, atol=5e-5)


# ---------------------------------------------------------------- losses
def test_losses_match_jax():
    r = _rng(2)
    scores = r.standard_normal((2, 3, 3, 1)).astype(np.float32)
    a, b = r.standard_normal((2, 6, 6, 3)).astype(np.float32), \
        r.standard_normal((2, 6, 6, 3)).astype(np.float32)
    logits = r.standard_normal((2, 6, 6, N_CLASSES)).astype(np.float32) * 3
    labels = r.integers(0, N_CLASSES, (2, 6, 6)).astype(np.int32)
    labels[0, :2] = 255
    void = np.full_like(labels, 255)
    T = torch.from_numpy
    for real in (True, False):
        np.testing.assert_allclose(float(tl.lsgan_loss(T(scores), real)),
                                   float(jl.lsgan_loss(jnp.asarray(scores), real)), rtol=1e-6)
    np.testing.assert_allclose(float(tl.l1_loss(T(a), T(b))),
                               float(jl.l1_loss(jnp.asarray(a), jnp.asarray(b))), rtol=1e-6)
    for lab in (labels, void):
        got = float(tl.cross_entropy_loss(T(logits), T(lab)))
        ref = float(jl.cross_entropy_loss(jnp.asarray(logits), jnp.asarray(lab)))
        np.testing.assert_allclose(got, ref, rtol=1e-6, atol=1e-7)
    assert float(tl.cross_entropy_loss(T(logits), T(void))) == 0.0


# ---------------------------------------------------------------- schedule
def test_lambda_lr_factor_matches_jax():
    for e in range(0, 260, 7):
        for epochs, decay in ((200, 100), (10, 10), (5, 2)):
            kw = dict(epochs=epochs, offset=0, decay_epoch=decay)
            # JAX computes in float32, the port in Python floats.
            np.testing.assert_allclose(tsched.lambda_lr_factor(e, **kw),
                                       float(jsched.lambda_lr_factor(e, **kw)), rtol=1e-6)


def test_adam_with_lambda_lr_matches_optax():
    """Three updates through the staircase (steps_per_epoch 2, decay from
    epoch 0 over 3 epochs, so the LR changes between updates)."""
    r = _rng(3)
    p0 = r.standard_normal((4, 5)).astype(np.float32)
    grads = [r.standard_normal((4, 5)).astype(np.float32) * 10 ** -k for k in range(3)]
    kw = dict(epochs=3, decay_epoch=0, steps_per_epoch=2)
    tx = jsched.make_adam(jsched.make_lambda_lr(2e-4, **kw))
    jp = jnp.asarray(p0)
    jstate = tx.init(jp)
    tp = torch.nn.Parameter(torch.from_numpy(p0.copy()))
    opt = tsched.make_adam([tp], 2e-4)
    sched = tsched.make_scheduler(opt, **kw)
    for g in grads:
        upd, jstate = tx.update(jnp.asarray(g), jstate, jp)
        jp = optax.apply_updates(jp, upd)
        tp.grad = torch.from_numpy(g)
        opt.step()
        sched.step()
    np.testing.assert_allclose(tp.detach().numpy(), np.asarray(jp), rtol=1e-6, atol=1e-9)


# ---------------------------------------------------------------- pool
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_pool_matches_jax_bit_exact(dtype):
    """100 queries of 2 items through a pool of 5 with injected decisions;
    the fakes arrive in float32 and are cast to the buffer's type."""
    r = _rng(4)
    jd, td = (jnp.float32, torch.float32) if dtype == "float32" else \
        (jnp.bfloat16, torch.bfloat16)
    js = jpool.init_pool(5, (4, 4, 3), jd)
    ts = tpool.init_pool(5, (4, 4, 3), td)
    jquery = jax.jit(jpool.pool_query_with_decisions)
    for _ in range(100):
        items = r.standard_normal((2, 4, 4, 3)).astype(np.float32)
        use_new, idx = r.random(2) > 0.5, r.integers(0, 5, 2)
        js, jout = jquery(js, jnp.asarray(items), jnp.asarray(use_new), jnp.asarray(idx))
        ts, tout = tpool.pool_query_with_decisions(ts, torch.from_numpy(items), use_new, idx)
        assert tout.dtype == td
        np.testing.assert_array_equal(tout.float().numpy(), np.asarray(jout, np.float32))
    assert ts.count == int(js.count) == 5
    np.testing.assert_array_equal(ts.buffer.float().numpy(), np.asarray(js.buffer, np.float32))


def test_pool_query_draws_from_the_generator():
    outs = []
    for seed in (0, 0):
        g = torch.Generator().manual_seed(seed)
        s = tpool.init_pool(2, (1, 1, 1))
        seq = []
        for i in range(20):
            s, out = tpool.pool_query(s, torch.full((1, 1, 1, 1), float(i)), g)
            seq.append(float(out))
        outs.append(seq)
    assert outs[0] == outs[1] and outs[0][:2] == [0.0, 1.0]


# ---------------------------------------------------------------- config, data
def test_config_and_presets_match_jax():
    assert dataclasses.asdict(tconfig.Config()) == dataclasses.asdict(jconfig.Config())
    assert set(tconfig.PRESETS) == set(jconfig.PRESETS)
    for name in jconfig.PRESETS:
        assert dataclasses.asdict(tconfig.preset(name)) == \
            dataclasses.asdict(jconfig.preset(name))
    with pytest.raises(ValueError, match="unknown preset"):
        tconfig.preset("nope")


@pytest.mark.parametrize("idx,in_ch", [(0, 3), (7, 1)])
def test_synthetic_sample_matches_jax(idx, in_ch):
    assert DATASET_SPECS == JAX_SPECS
    for a, b in zip(_synthetic_sample(idx, (40, 48), 21, in_ch),
                    jax_synthetic(idx, (40, 48), 21, in_ch)):
        np.testing.assert_array_equal(a, b)


# ---------------------------------------------------------------- train step
def _pair(pool_size):
    """(JAX trainer, JAX state, port trainer, port state) on the same
    weights: the JAX init, bridged into the port."""
    jcfg = jconfig.Config(gen_net="resnet_6blocks", pool_size=pool_size, **CFG_KW)
    jt = JaxTrainer(jcfg, N_CLASSES, 3, steps_per_epoch=1000)
    jt.G_i2l = jt.G_i2l.clone(n_blocks=NB)
    jt.G_l2i = jt.G_l2i.clone(n_blocks=NB)
    js = jt.init_state(jax.random.PRNGKey(0))
    tcfg = tconfig.Config(gen_net=f"resnet_{NB}blocks", pool_size=pool_size, **CFG_KW)
    tt = CycleGANTrainer(tcfg, N_CLASSES, 3, steps_per_epoch=1000, device="cpu")
    ts = tt.init_state(torch.Generator().manual_seed(0))
    weights.load_flax_cyclegan(tt, js)
    return jt, js, tt, ts


def _batch(seed=5):
    r = _rng(seed)
    lab = r.integers(0, N_CLASSES, (1, SIZE, SIZE)).astype(np.int32)
    lab[:, :3] = 255  # a void border
    return {"lab_image": r.uniform(-1, 1, (1, SIZE, SIZE, 3)).astype(np.float32),
            "unlab_image": r.uniform(-1, 1, (1, SIZE, SIZE, 3)).astype(np.float32),
            "lab_label": lab}


def _run_both(pool_size, steps, decisions=None):
    jt, js, tt, ts = _pair(pool_size)
    base = _batch()
    step_jit = jax.jit(jt.train_step)
    for s in range(steps):
        nb = dict(base)
        if decisions is not None:
            use_new, idx = decisions
            nb.update(pool_use_new_img=use_new[s, 0], pool_idx_img=idx[s, 0],
                      pool_use_new_lab=use_new[s, 1], pool_idx_lab=idx[s, 1])
        js, jm = step_jit(js, {k: jnp.asarray(v) for k, v in nb.items()})
        ts, tm = tt.train_step(ts, {k: torch.from_numpy(np.asarray(v)) for k, v in nb.items()})
        assert set(tm) == set(jm)
        np.testing.assert_allclose(float(tm["g_total"]), float(jm["g_total"]), rtol=2e-3,
                                   err_msg=f"g_total, step {s}")
        np.testing.assert_allclose(float(tm["d_total"]), float(jm["d_total"]), rtol=1e-2,
                                   atol=1e-3, err_msg=f"d_total, step {s}")
    ref = np.asarray(jt.G_i2l.apply(js.g_i2l, jnp.asarray(base["lab_image"])))
    got = tt.logits(torch.from_numpy(base["lab_image"])).numpy()
    np.testing.assert_allclose(got, ref, atol=2e-3)
    return jt, js, tt, ts


def test_train_step_three_steps_match_jax():
    _, _, tt, ts = _run_both(pool_size=0, steps=3)
    assert ts.step == 3
    # The G phase gave the discriminators no .grad of their own: what they
    # hold is the D phase's.
    assert all(p.grad is not None for p in tt.d_params())


def test_train_step_with_active_pool_matches_jax():
    """Pool of 2 over 4 steps: it fills in steps 1-2, then swaps or passes
    through per the injected decisions."""
    r = _rng(9)
    use_new = r.random((4, 2, 1)) > 0.5
    use_new[2:, :, 0] = [[False, True], [True, False]]  # one swap per pool
    idx = r.integers(0, 2, (4, 2, 1)).astype(np.int32)
    _, js, _, ts = _run_both(pool_size=2, steps=4, decisions=(use_new, idx))
    assert ts.pool_img.count == int(js.pool_img.count) == 2
    np.testing.assert_allclose(ts.pool_img.buffer.numpy(), np.asarray(js.pool_img.buffer),
                               atol=2e-3)


def test_train_step_refuses_a_partial_set_of_pool_keys():
    _, _, tt, ts = _pair(pool_size=2)
    b = {k: torch.from_numpy(v) for k, v in _batch().items()}
    b["pool_use_new_img"] = torch.ones(1, dtype=torch.bool)
    with pytest.raises(ValueError, match="all four batch keys"):
        tt.train_step(ts, b)


def test_onehot_eval_and_generate():
    _, _, tt, _ = _pair(pool_size=0)
    lab = torch.tensor([[[0, 4], [255, 2]]])
    oh = tt._onehot(lab)
    assert oh.shape == (1, 2, 2, N_CLASSES) and float(oh[0, 1, 0].sum()) == 0.0
    assert float(oh[0, 0, 1, 4]) == 1.0
    b = _batch()
    img = torch.from_numpy(b["lab_image"])
    hist = tt.eval_step({"image": img, "label": torch.from_numpy(b["lab_label"])})
    assert int(hist.sum()) == int((b["lab_label"] != 255).sum())
    assert tt.predict(img).shape == (1, SIZE, SIZE)
    gen = tt.generate_image(torch.from_numpy(b["lab_label"]))
    assert gen.shape == (1, SIZE, SIZE, 3) and float(gen.abs().max()) <= 1.0


def test_bridge_rejects_a_missing_net_layer():
    jt, js, tt, _ = _pair(pool_size=0)
    bad = dict(js.d_lab["params"])
    bad.pop("ConvBlock_4")
    with pytest.raises(KeyError, match="ConvBlock_4"):
        weights.load_flax_cyclegan(tt, {"g_i2l": js.g_i2l, "g_l2i": js.g_l2i,
                                        "d_img": js.d_img, "d_lab": {"params": bad}})


def test_trainer_refuses_unported_options():
    """use_dropout, remat, norm='batch' and the U-Nets are ported
    (tests/test_torch_dropout.py, test_torch_remat.py,
    test_torch_norm_batch.py, test_torch_unet.py); names the JAX package
    does not know are refused."""
    for kw in (dict(remat=True), dict(norm="batch"), dict(gen_net="unet_128")):
        CycleGANTrainer(tconfig.Config(**kw, **CFG_KW), N_CLASSES, 3, 1, device="cpu")
    with pytest.raises(ValueError, match="unknown norm"):
        CycleGANTrainer(tconfig.Config(norm="group", **CFG_KW), N_CLASSES, 3, 1,
                        device="cpu")
    with pytest.raises(ValueError, match="unknown netG"):
        CycleGANTrainer(tconfig.Config(gen_net="unet_64", **CFG_KW), N_CLASSES, 3, 1,
                        device="cpu")
