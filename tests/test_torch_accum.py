"""``multi_step``, ``accum_step`` and ``select_step`` of the port, on the CPU.

- ``multi_step`` on K stacked batches is bitwise K ``train_step`` calls
  (the same code runs; pools and generators included).
- Against the JAX package at pool 0 on bridged weights (ngf 8, ndf 8, 5
  classes, 32x32, 2 trunk blocks, float32), at the 3-step bars of
  ``tests/test_torch_train.py``: ``g_total`` rtol 2e-3, ``d_total`` rtol
  1e-2 / atol 1e-3, the trained G_i2l's logits atol 2e-3. The JAX
  ``accum_step`` splits its own PRNG key for the pools, so its pool
  behaviour is held by the port's own properties instead.
- ``accum_step`` (K=2, b=2) equals ``train_step`` (b=4) at pool 0, as
  ``tests/test_grad_accum.py`` holds the JAX one: losses rtol 1e-4, every
  parameter within 3 lr (Adam turns float-reassociation noise in a
  near-zero gradient into up to an lr-sized step).
- With pools on, ``accum_step`` queries them once per microbatch, in order.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from cyclegan_tpu.parallel.mesh import select_step as jax_select_step
from cyclegan_tpu.train.cyclegan import CycleGANTrainer as JaxTrainer
from cyclegan_tpu.utils import config as jconfig
from cyclegan_tpu_torch import weights
from cyclegan_tpu_torch.train import pool as tpool
from cyclegan_tpu_torch.train.cyclegan import CycleGANTrainer
from cyclegan_tpu_torch.train.runner import select_step
from cyclegan_tpu_torch.utils import config as tconfig

N_CLASSES, SIZE, NGF, NDF, NB = 5, 32, 8, 8, 2
CFG = dict(ngf=NGF, ndf=NDF, crop_height=SIZE, crop_width=SIZE, bf16=False, epochs=200,
           decay_epoch=100)


@pytest.fixture(autouse=True, scope="module")
def _few_torch_threads():
    """Two intra-op threads: the suite runs several workers on one host,
    and torch's default (a thread per core in every worker) oversubscribes
    it many times over."""
    n = torch.get_num_threads()
    torch.set_num_threads(2)
    yield
    torch.set_num_threads(n)


def _port(pool_size=0, seed=0, ngf=NGF):
    cfg = tconfig.Config(gen_net=f"resnet_{NB}blocks", pool_size=pool_size,
                         **dict(CFG, ngf=ngf, ndf=ngf))
    tt = CycleGANTrainer(cfg, N_CLASSES, 3, steps_per_epoch=1000, device="cpu")
    return tt, tt.init_state(torch.Generator().manual_seed(seed))


def _pair():
    jt = JaxTrainer(jconfig.Config(gen_net="resnet_6blocks", pool_size=0, **CFG), N_CLASSES,
                    3, steps_per_epoch=1000)
    jt.G_i2l = jt.G_i2l.clone(n_blocks=NB)
    jt.G_l2i = jt.G_l2i.clone(n_blocks=NB)
    js = jt.init_state(jax.random.PRNGKey(0))
    tt, ts = _port()
    weights.load_flax_cyclegan(tt, js)
    return jt, js, tt, ts


def _stack(k, b=1, seed=5):
    """K microbatches stacked on a leading axis; all labels valid (equal CE
    pixel counts per microbatch)."""
    r = np.random.default_rng(seed)
    return {"lab_image": r.uniform(-1, 1, (k, b, SIZE, SIZE, 3)).astype(np.float32),
            "unlab_image": r.uniform(-1, 1, (k, b, SIZE, SIZE, 3)).astype(np.float32),
            "lab_label": r.integers(0, N_CLASSES, (k, b, SIZE, SIZE)).astype(np.int32)}


def _torch(b):
    return {k: torch.from_numpy(v) for k, v in b.items()}


def _params(tt):
    return [p.detach().clone() for net in tt.nets() for p in net.parameters()]


def test_multi_step_is_k_train_steps_bitwise():
    ta, sa = _port(pool_size=2)
    tb, sb = _port(pool_size=2)
    stacked = _torch(_stack(3))
    sa, ma = ta.multi_step(sa, stacked)
    for i in range(3):
        sb, mb = tb.train_step(sb, {k: v[i] for k, v in stacked.items()})
    assert sa.step == sb.step == 3
    for a, b in zip(_params(ta), _params(tb)):
        assert torch.equal(a, b)
    assert {k: float(v) for k, v in ma.items()} == {k: float(v) for k, v in mb.items()}
    assert sa.pool_img.count == sb.pool_img.count == 2
    assert torch.equal(sa.pool_lab.buffer, sb.pool_lab.buffer)
    assert torch.equal(sa.generator.get_state(), sb.generator.get_state())


def _check_against_jax(tm, jm, tt, js, jt, image):
    assert set(tm) == set(jm)
    np.testing.assert_allclose(float(tm["g_total"]), float(jm["g_total"]), rtol=2e-3)
    np.testing.assert_allclose(float(tm["d_total"]), float(jm["d_total"]), rtol=1e-2,
                               atol=1e-3)
    ref = np.asarray(jt.G_i2l.apply(js.g_i2l, jnp.asarray(image)))
    np.testing.assert_allclose(tt.logits(torch.from_numpy(image)).numpy(), ref, atol=2e-3)


@pytest.mark.parametrize("kind,k", [("multi", 3), ("accum", 2)])
def test_stacked_steps_match_jax(kind, k):
    jt, js, tt, ts = _pair()
    stacked = _stack(k)
    js, jm = jax.jit(getattr(jt, f"{kind}_step"))(
        js, {key: jnp.asarray(v) for key, v in stacked.items()})
    ts, tm = getattr(tt, f"{kind}_step")(ts, _torch(stacked))
    assert ts.step == int(js.step) == (k if kind == "multi" else 1)
    _check_against_jax(tm, jm, tt, js, jt, stacked["lab_image"][0])


def test_accum_step_equals_one_big_batch():
    ta, sa = _port()
    tb, sb = _port()
    stacked = _torch(_stack(2, b=2))
    sa, ma = ta.accum_step(sa, stacked)
    sb, mb = tb.train_step(sb, {k: v.reshape(4, *v.shape[2:]) for k, v in stacked.items()})
    assert set(ma) == set(mb) and sa.step == sb.step == 1
    for key in mb:
        np.testing.assert_allclose(float(ma[key]), float(mb[key]), rtol=1e-4, err_msg=key)
    lr = ta.cfg.lr
    for a, b in zip(_params(ta), _params(tb)):
        assert float((a - b).abs().max()) < 3 * lr


def test_accum_step_queries_the_pools_once_per_microbatch():
    """K=3 microbatches of 2 into pools of 8: 6 items stored, and the
    decision generator advanced by exactly 3 queries of 2 per pool (the
    image pool's, then the label pool's, microbatch by microbatch)."""
    tt, st = _port(pool_size=8, ngf=4)
    g0 = st.generator.get_state()
    st, m = tt.accum_step(st, _torch(_stack(3, b=2)))
    assert st.pool_img.count == st.pool_lab.count == 6
    assert all(np.isfinite(float(v)) for v in m.values())
    replay = torch.Generator()
    replay.set_state(g0)
    for _ in range(3 * 2):  # K microbatches x two pools
        tpool.pool_query(tpool.init_pool(8, (1, 1, 1)), torch.zeros(2, 1, 1, 1), replay)
    assert torch.equal(replay.get_state(), st.generator.get_state())


def test_select_step_dispatch_and_exclusion():
    tt, _ = _port(ngf=4)
    assert select_step(tt) == tt.train_step
    assert select_step(tt, steps_per_call=3) == tt.multi_step
    assert select_step(tt, grad_accum=2) == tt.accum_step
    with pytest.raises(ValueError, match="mutually exclusive"):
        select_step(tt, steps_per_call=2, grad_accum=2)
    # The JAX function's rule, on the same arguments.
    with pytest.raises(ValueError, match="mutually exclusive"):
        jax_select_step(object(), 2, 2)
