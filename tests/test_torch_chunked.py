"""The port's chunked residual block (path A) against the JAX package, on the CPU.

On the CPU ``residual_block_chunked`` runs its plain forward and VJP through
the same ``autograd.Function`` as on the card. These tests hold them against
the JAX package's Pallas kernels in interpret mode (forward: y, vhat, stats;
VJP: dx, dw1, dw2 and exactly zero bias gradients) on the shape/hc cases of
``tests/test_resblock_chunked.py`` at its bars (rtol 1e-4 / atol 1e-5
forward, 1e-5 of the largest entry backward; float32, where the roundings to
x's type are the identity), then the whole train step with
``CYCLEGAN_TPU_RESBLOCK=chunked`` against the JAX step, which takes its XLA
path on the CPU (the same maths), at the bars of ``tests/test_torch_train.py``.
The CUDA kernels run only on the card (``tests/test_torch_cuda.py``,
``chip_smoke.py``).
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from cyclegan_tpu.kernels.resblock_chunked import residual_block_chunked as jax_chunked
from cyclegan_tpu.kernels.resblock_chunked import residual_block_chunked_fwd as jax_chunked_fwd
from cyclegan_tpu.train.cyclegan import CycleGANTrainer as JaxTrainer
from cyclegan_tpu.utils import config as jconfig
from cyclegan_tpu_torch import weights
from cyclegan_tpu_torch.kernels import resblock_chunked as RC
from cyclegan_tpu_torch.models.generators import define_Gen
from cyclegan_tpu_torch.ops import blocks
from cyclegan_tpu_torch.train.cyclegan import CycleGANTrainer
from cyclegan_tpu_torch.utils import config as tconfig

CASES = [((1, 8, 8, 8), 4),     # 2 chunks
         ((2, 16, 8, 8), 4),    # batch > 1, 4 chunks
         ((1, 12, 16, 8), 6),   # W != H
         ((1, 8, 8, 8), 8)]     # one chunk: both reflect folds in it


def _mk(n, h, w, c, seed=0):
    rng = np.random.default_rng(seed)
    f = lambda *s: rng.normal(size=s).astype(np.float32)  # noqa: E731
    return (f(n, h, w, c), f(3, 3, c, c) * 0.1, f(c) * 0.1, f(3, 3, c, c) * 0.1, f(c) * 0.1)


@pytest.mark.parametrize("shape,hc", CASES)
def test_chunked_forward_and_vjp_match_pallas(shape, hc):
    args = _mk(*shape, seed=1)
    dy = np.random.default_rng(2).normal(size=shape).astype(np.float32)
    jargs = [jnp.asarray(a) for a in args]
    jy, jvhat, jstats = jax.jit(
        lambda *a: jax_chunked_fwd(*a, hc=hc, interpret=True))(*jargs)
    jgrads = jax.jit(lambda a, d: jax.vjp(
        lambda *q: jax_chunked(*q, 1e-5, hc, True), *a)[1](d))(jargs, jnp.asarray(dy))

    y, vhat, stats = RC.residual_block_chunked_fwd(*(torch.from_numpy(a) for a in args),
                                                   hc=hc)
    for got, ref in ((y, jy), (vhat, jvhat), (stats, jstats)):
        np.testing.assert_allclose(got.numpy(), np.asarray(ref), rtol=1e-4, atol=1e-5)

    leaves = [torch.from_numpy(a).requires_grad_() for a in args]
    out = RC.residual_block_chunked(*leaves, 1e-5, hc)
    np.testing.assert_allclose(out.detach().numpy(), np.asarray(jy), rtol=1e-4, atol=1e-5)
    grads = torch.autograd.grad(out, leaves, torch.from_numpy(dy))
    for name, g, r in zip(("dx", "dw1", "db1", "dw2", "db2"), grads, jgrads):
        if name in ("db1", "db2"):
            assert torch.count_nonzero(g) == 0 and float(jnp.abs(r).max()) == 0.0
            continue
        rel = float(np.abs(g.numpy() - np.asarray(r)).max()) / float(jnp.abs(r).max())
        assert rel < 1e-5, f"{name}: max-rel {rel}"


def test_chunked_backward_reads_the_residuals_and_runs_no_forward_conv(monkeypatch):
    """The VJP uses the saved (x, vhat, s, stats): with the forward's
    convolution made to raise after the forward, the backward still runs
    and gives the same gradients."""
    args = [torch.from_numpy(a).requires_grad_() for a in _mk(1, 8, 8, 8, seed=3)]
    dy = torch.from_numpy(np.random.default_rng(4).normal(size=(1, 8, 8, 8)).astype(np.float32))
    ref = torch.autograd.grad(RC.residual_block_chunked(*args, 1e-5, 4), args, dy)
    out = RC.residual_block_chunked(*args, 1e-5, 4)

    def no_forward(*_a, **_k):
        raise AssertionError("the chunked backward re-ran a forward convolution")

    monkeypatch.setattr(RC.RB, "_conv3x3_plain", no_forward)
    for g, r in zip(torch.autograd.grad(out, args, dy), ref):
        torch.testing.assert_close(g, r, rtol=0, atol=0)


def test_chunked_result_depends_on_hc_only_by_rounding():
    """hc reaches the statistics as the row chunk: other chunkings change
    the summation order only (float32, within 1e-5 relative)."""
    x, w1, b1, w2, b2 = (torch.from_numpy(a) for a in _mk(2, 16, 8, 8, seed=5))
    x = x * 3 + 2  # a mean far from 0: E[x^2] - E[x]^2 loses the most here
    ys = [RC.residual_block_chunked_fwd(x, w1, b1, w2, b2, hc=hc) for hc in (1, 2, 4, 8, 16)]
    for y, vhat, stats in ys[1:]:
        torch.testing.assert_close(y, ys[0][0], rtol=1e-5, atol=1e-5)
        torch.testing.assert_close(vhat, ys[0][1], rtol=1e-5, atol=1e-5)
        torch.testing.assert_close(stats, ys[0][2], rtol=1e-5, atol=1e-6)


def test_chunked_refuses_h_not_divisible_by_hc():
    x, w1, b1, w2, b2 = (torch.from_numpy(a) for a in _mk(1, 12, 8, 8))
    with pytest.raises(ValueError, match="H % hc"):
        RC.residual_block_chunked(x, w1, b1, w2, b2, 1e-5, 8)
    with pytest.raises(ValueError, match="H % hc"):
        RC.residual_block_chunked_fwd(x, w1, b1, w2, b2, hc=5)


def test_chunked_bf16_types_and_roundings():
    """bf16: y, vhat, s in bf16 (s and u rounded before they are normalised),
    stats float32; the Function returns bf16 gradients."""
    x, w1, b1, w2, b2 = (torch.from_numpy(a).to(torch.bfloat16) for a in _mk(1, 8, 8, 8))
    y, vhat, s, stats = RC.residual_block_chunked_plain(x, w1, b1, w2, b2, hc=4)
    assert (y.dtype, vhat.dtype, s.dtype, stats.dtype) == (torch.bfloat16,) * 3 + (torch.float32,)
    mu2, r2 = stats[:, 2, None, None], stats[:, 3, None, None]
    torch.testing.assert_close(y, ((s.float() - mu2) * r2 + x.float()).to(torch.bfloat16))
    leaves = [t.clone().requires_grad_() for t in (x, w1, b1, w2, b2)]
    grads = torch.autograd.grad(RC.residual_block_chunked(*leaves, 1e-5, 4), leaves,
                                torch.ones_like(x))
    assert [g.dtype for g in grads] == [torch.bfloat16] * 5


def test_chunked_route_is_read_once_when_the_module_is_built(monkeypatch):
    monkeypatch.setenv("CYCLEGAN_TPU_RESBLOCK", "chunked")
    monkeypatch.setenv("CYCLEGAN_TPU_RESBLOCK_HC", "4")
    G = define_Gen(3, 5, 8, "resnet_2blocks", generator=torch.Generator().manual_seed(0))
    monkeypatch.delenv("CYCLEGAN_TPU_RESBLOCK")
    assert [(b.route, b.hc) for b in G.trunk] == [("chunked", 4)] * 2
    assert all(b.route == "fused" for b in define_Gen(3, 5, 8, "resnet_2blocks").trunk)
    G2 = define_Gen(3, 5, 8, "resnet_2blocks", resblock="chunked", resblock_hc=2)
    assert [(b.route, b.hc) for b in G2.trunk] == [("chunked", 2)] * 2
    calls = []
    monkeypatch.setattr(blocks, "residual_block_chunked",
                        lambda *a: calls.append(a[-1]) or RC.residual_block_chunked(*a))
    with torch.no_grad():
        G(torch.zeros((1, 3, 32, 32)).contiguous(memory_format=torch.channels_last))
    assert calls == [4, 4]


# ---------------------------------------------------------------- train step
N_CLASSES, SIZE, NB = 5, 32, 2
CFG_KW = dict(ngf=8, ndf=8, crop_height=SIZE, crop_width=SIZE, bf16=False, epochs=200,
              decay_epoch=100, pool_size=0)


def test_train_step_on_the_chunked_route_matches_jax(monkeypatch):
    """Three steps, CYCLEGAN_TPU_RESBLOCK=chunked with 2 chunks of the 8x8
    trunk plane; bars of tests/test_torch_train.py (g_total rtol 2e-3,
    d_total rtol 1e-2 / atol 1e-3, final logits atol 2e-3)."""
    monkeypatch.setenv("CYCLEGAN_TPU_RESBLOCK", "chunked")
    monkeypatch.setenv("CYCLEGAN_TPU_RESBLOCK_HC", "4")
    jt = JaxTrainer(jconfig.Config(gen_net="resnet_6blocks", **CFG_KW), N_CLASSES, 3,
                    steps_per_epoch=1000)
    jt.G_i2l = jt.G_i2l.clone(n_blocks=NB)
    jt.G_l2i = jt.G_l2i.clone(n_blocks=NB)
    js = jt.init_state(jax.random.PRNGKey(0))
    tt = CycleGANTrainer(tconfig.Config(gen_net=f"resnet_{NB}blocks", **CFG_KW), N_CLASSES,
                         3, steps_per_epoch=1000, device="cpu")
    assert all(b.route == "chunked" for b in tt.G_i2l.trunk)
    ts = tt.init_state(torch.Generator().manual_seed(0))
    weights.load_flax_cyclegan(tt, js)
    r = np.random.default_rng(5)
    lab = r.integers(0, N_CLASSES, (1, SIZE, SIZE)).astype(np.int32)
    lab[:, :3] = 255
    batch = {"lab_image": r.uniform(-1, 1, (1, SIZE, SIZE, 3)).astype(np.float32),
             "unlab_image": r.uniform(-1, 1, (1, SIZE, SIZE, 3)).astype(np.float32),
             "lab_label": lab}
    step_jit = jax.jit(jt.train_step)
    calls = []
    monkeypatch.setattr(blocks, "residual_block_chunked",
                        lambda *a: calls.append(1) or RC.residual_block_chunked(*a))
    for s in range(3):
        js, jm = step_jit(js, {k: jnp.asarray(v) for k, v in batch.items()})
        ts, tm = tt.train_step(ts, {k: torch.from_numpy(v) for k, v in batch.items()})
        np.testing.assert_allclose(float(tm["g_total"]), float(jm["g_total"]), rtol=2e-3,
                                   err_msg=f"g_total, step {s}")
        np.testing.assert_allclose(float(tm["d_total"]), float(jm["d_total"]), rtol=1e-2,
                                   atol=1e-3, err_msg=f"d_total, step {s}")
    assert len(calls) == 3 * 3 * NB  # three generator applies a step
    ref = np.asarray(jt.G_i2l.apply(js.g_i2l, jnp.asarray(batch["lab_image"])))
    got = tt.logits(torch.from_numpy(batch["lab_image"])).numpy()
    np.testing.assert_allclose(got, ref, atol=2e-3)
