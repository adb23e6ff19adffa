"""The port's kernel VJPs against the JAX kernels' custom VJPs.

On the CPU the port's ``autograd.Function``s run their plain forward and
backward; these tests hold them, through the Function, against ``jax.vjp``
/ ``jax.grad`` of the Pallas kernels run in interpret mode (whose backward
is the Pallas backward kernel), on the same seeded numpy inputs. The CUDA
backward kernels run only on the card (``tests/test_torch_cuda.py`` and
``chip_smoke.py``).
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
import torch.nn.functional as F

from cyclegan_tpu.kernels.instance_norm import instance_norm_act as jax_in_act
from cyclegan_tpu.kernels.resblock import residual_block_fused as jax_rb_fused
from cyclegan_tpu_torch.kernels import instance_norm as IN
from cyclegan_tpu_torch.kernels import resblock as RB


def _x(shape, seed, scale=1.0, shift=0.0):
    rng = np.random.default_rng(seed)
    return (scale * rng.standard_normal(shape) + shift).astype(np.float32)


def _in_vjp_both(x, s, dy, act, jdtype, tdtype, dy_t=None):
    """(port dx, dskip), (JAX dx, dskip) for the same inputs and cotangent."""
    jx = jnp.asarray(x, jdtype)
    js = None if s is None else jnp.asarray(s, jdtype)
    if js is None:
        _, vjp = jax.vjp(lambda a: jax_in_act(a, None, 1e-5, act, True), jx)
        ref = (vjp(jnp.asarray(dy, jdtype))[0], None)
    else:
        _, vjp = jax.vjp(lambda a, b: jax_in_act(a, b, 1e-5, act, True), jx, js)
        ref = vjp(jnp.asarray(dy, jdtype))
    tx = torch.from_numpy(x).to(tdtype).requires_grad_()
    ts = None if s is None else torch.from_numpy(s).to(tdtype).requires_grad_()
    y = IN.instance_norm_act(tx, ts, 1e-5, act)
    assert y.grad_fn is not None
    dy_t = torch.from_numpy(dy).to(tdtype) if dy_t is None else dy_t
    got = torch.autograd.grad(y, [tx] + ([ts] if ts is not None else []), dy_t)
    return (got[0], got[1] if ts is not None else None), ref


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("skip", [False, True])
@pytest.mark.parametrize("act", ["none", "relu", "leaky"])
def test_instance_norm_vjp_matches_pallas(act, skip, dtype):
    shape = (2, 8, 6, 16)
    x, dy = _x(shape, 0, 3.0, 1.0), _x(shape, 1)
    s = _x(shape, 2) if skip else None
    jd, td = (jnp.float32, torch.float32) if dtype == "float32" else \
        (jnp.bfloat16, torch.bfloat16)
    (dx, dskip), (jdx, jdskip) = _in_vjp_both(x, s, dy, act, jd, td)
    assert dx.dtype == td
    # float32: two float32 reductions over 48 values in another order.
    # bf16: dx is rounded to bf16 on both sides; one bf16 ulp of |dx| <= ~3.
    tol = dict(atol=1e-5) if dtype == "float32" else dict(atol=2 ** -6, rtol=2 ** -7)
    np.testing.assert_allclose(dx.float().numpy(), np.asarray(jdx, np.float32), **tol)
    if skip:
        np.testing.assert_array_equal(dskip.float().numpy(), np.asarray(jdskip, np.float32))


def test_instance_norm_vjp_non_contiguous_cotangent():
    """A cotangent that arrives as a strided view (the NCHW view of an NHWC
    output): the Function makes it contiguous before the backward."""
    shape = (2, 8, 6, 16)
    x = _x(shape, 3, 2.0)
    dy_nchw = _x((2, 16, 8, 6), 4)
    dy_view = torch.from_numpy(dy_nchw).permute(0, 2, 3, 1)  # NHWC view, not contiguous
    assert not dy_view.is_contiguous()
    dy = np.ascontiguousarray(dy_view.numpy())
    (dx, _), (jdx, _) = _in_vjp_both(x, None, dy, "relu", jnp.float32, torch.float32,
                                     dy_t=dy_view)
    np.testing.assert_allclose(dx.numpy(), np.asarray(jdx), atol=1e-5)


def test_instance_norm_saves_nothing_without_grad():
    x = torch.from_numpy(_x((1, 4, 4, 8), 5)).requires_grad_()
    with torch.no_grad():
        y = IN.instance_norm_act(x, None, 1e-5, "relu")
    assert y.grad_fn is None and not y.requires_grad
    with torch.inference_mode():
        y = IN.instance_norm_act(x.detach(), None, 1e-5, "relu")
    assert y.grad_fn is None


def test_instance_norm_bwd_plain_matches_torch_autograd():
    """The plain VJP against torch autograd of the plain forward (x's own
    statistics; leaky has its kink at 0 taken as the slope-1 side)."""
    x = torch.from_numpy(_x((2, 5, 7, 8), 6, 2.0, 0.5)).requires_grad_()
    dy = torch.from_numpy(_x((2, 5, 7, 8), 7))
    for act in ("none", "relu", "leaky"):
        (ref,) = torch.autograd.grad(IN.instance_norm_act_plain(x, None, 1e-5, act), x, dy)
        mean, rstd = IN.instance_norm_stats_plain(x.detach())
        got = IN.instance_norm_act_bwd_plain(x.detach(), dy, mean, rstd, act)
        torch.testing.assert_close(got, ref, atol=1e-5, rtol=1e-5)


def _rb_params(c, seed):
    return (0.05 * _x((3, 3, c, c), seed), 0.01 * _x((c,), seed + 1),
            0.05 * _x((3, 3, c, c), seed + 2), 0.01 * _x((c,), seed + 3))


@pytest.mark.parametrize("shape", [(2, 8, 8, 16), (1, 6, 5, 8)])
def test_residual_block_vjp_matches_pallas(shape):
    """dx, dw1, dw2 against jax.grad of the Pallas kernel in interpret mode
    (its backward runs _bwd_dx_kernel and _bwd_dw_kernel); bias grads 0."""
    x = _x(shape, 10)
    w1, b1, w2, b2 = _rb_params(shape[-1], 11)
    dy = _x(shape, 15)
    jx = [jnp.asarray(a) for a in (x, w1, b1, w2, b2)]

    def loss(x_, w1_, b1_, w2_, b2_):
        return jnp.sum(jax_rb_fused(x_, w1_, b1_, w2_, b2_, 1e-5, True) * jnp.asarray(dy))

    ref = jax.grad(loss, argnums=(0, 1, 2, 3, 4))(*jx)
    tx = [torch.from_numpy(a).requires_grad_() for a in (x, w1, b1, w2, b2)]
    y = RB.residual_block_fused(*tx)
    assert y.grad_fn is not None
    got = torch.autograd.grad(y, tx, torch.from_numpy(dy))
    for g, r, name in zip(got, ref, ("dx", "dw1", "db1", "dw2", "db2")):
        np.testing.assert_allclose(g.numpy(), np.asarray(r), atol=5e-4, err_msg=name)
    assert torch.count_nonzero(got[2]) == 0 and torch.count_nonzero(got[4]) == 0


def test_residual_block_bwd_plain_bf16_types():
    """bf16 inputs: dx in bf16, dw in float32 from the plain VJP, cast to
    the weights' type by the Function."""
    x = torch.from_numpy(_x((1, 6, 6, 8), 20)).to(torch.bfloat16)
    w1, b1, w2, b2 = [torch.from_numpy(a).to(torch.bfloat16) for a in _rb_params(8, 21)]
    dy = torch.from_numpy(_x((1, 6, 6, 8), 22)).to(torch.bfloat16)
    dx, dw1, dw2 = RB.residual_block_bwd_plain(x, dy, w1, b1, w2, b2)
    assert dx.dtype == torch.bfloat16 and dw1.dtype == dw2.dtype == torch.float32
    tw = [t.clone().requires_grad_() for t in (x, w1, b1, w2, b2)]
    got = torch.autograd.grad(RB.residual_block_fused(*tw), tw, dy)
    assert [g.dtype for g in got] == [torch.bfloat16] * 5
    torch.testing.assert_close(got[0], dx)
    torch.testing.assert_close(got[1], dw1.to(torch.bfloat16))


@pytest.mark.parametrize("hw", [(6, 5), (2, 3), (3, 2)])
def test_dgrad_and_wgrad_plain_match_torch_autograd(hw):
    """The plain input and weight gradients of the reflect-padded 3x3 conv
    (reflect fold included, down to H or W = 2) against torch autograd of
    reflect pad + conv2d."""
    h, w_ = hw
    x = torch.from_numpy(_x((2, h, w_, 8), 30)).requires_grad_()
    w = torch.from_numpy(0.1 * _x((3, 3, 8, 12), 31)).requires_grad_()
    g = torch.from_numpy(_x((2, h, w_, 12), 32))
    y = RB._conv3x3_plain(x, w, torch.zeros(12))
    dx_ref, dw_ref = torch.autograd.grad(y, [x, w], g)
    torch.testing.assert_close(RB.conv3x3_reflect_dgrad_plain(g, w.detach()), dx_ref,
                               atol=1e-5, rtol=1e-5)
    torch.testing.assert_close(RB.conv3x3_reflect_wgrad_plain(x.detach(), g), dw_ref,
                               atol=1e-4, rtol=1e-5)


def test_backward_kernels_reject_shapes_they_do_not_take():
    """The CUDA gradient wrappers raise on what the kernels do not take,
    before any build or launch."""
    g = torch.zeros((1, 4, 4, 16))
    with pytest.raises(ValueError, match="Cout % 32"):
        RB.conv3x3_reflect_dgrad(g, torch.zeros((3, 3, 32, 16)), torch.zeros((1, 4, 4, 32)))
    with pytest.raises(ValueError, match="H, W >= 2"):
        RB.conv3x3_reflect_wgrad(torch.zeros((1, 1, 4, 32)), torch.zeros((1, 1, 4, 32)))


@pytest.mark.parametrize("tiles,k", [(144, 8192), (144, 4096), (1, 100), (4, 1 << 20)])
def test_wgrad_split_covers_every_pixel_once(tiles, k):
    splits, kchunk = RB._wgrad_split(tiles, k)
    assert kchunk % 16 == 0 and splits * kchunk >= k > (splits - 1) * kchunk


def test_cpu_backward_leaves_launch_counters_at_zero():
    IN.bwd_launches = RB.bwd_dx_launches = RB.bwd_dw_launches = 0
    x = torch.from_numpy(_x((1, 4, 4, 32), 40)).requires_grad_()
    w1, b1, w2, b2 = [torch.from_numpy(a).requires_grad_() for a in _rb_params(32, 41)]
    y = IN.instance_norm_act(RB.residual_block_fused(x, w1, b1, w2, b2), None, 1e-5, "relu")
    F.mse_loss(y, torch.zeros_like(y)).backward()
    assert IN.bwd_launches == RB.bwd_dx_launches == RB.bwd_dw_launches == 0
    assert x.grad is not None and torch.count_nonzero(w1.grad) > 0
