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

from cyclegan_tpu.kernels.conv_dw import supported as jax_dw_supported
from cyclegan_tpu.kernels.instance_norm import instance_norm_act as jax_in_act
from cyclegan_tpu.kernels.resblock import residual_block_fused as jax_rb_fused
from cyclegan_tpu_torch.kernels import _build
from cyclegan_tpu_torch.kernels import conv_dw as CD
from cyclegan_tpu_torch.kernels import instance_norm as IN
from cyclegan_tpu_torch.kernels import resblock as RB


def _bf(shape):
    return torch.zeros(shape, dtype=torch.bfloat16)


def _parts(parts, shape):
    """A zero buffer of ``parts`` bf16 parts of a tensor of ``shape``."""
    return _bf((parts, *shape))


def _in_bwd_into(x, dx):
    """The norm VJP of ``x`` (zero cotangent and statistics) into ``dx``."""
    n, c = x.shape[0], x.shape[-1]
    IN.launch_bwd(x, torch.zeros_like(x), torch.zeros((n, c)), torch.zeros((n, c)), dx, "none")


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


@pytest.mark.parametrize("shape", [(2, 8, 8, 16), (1, 6, 5, 8), (1, 2, 6, 8), (1, 6, 2, 8),
                                   (1, 4, 10, 32)])
def test_residual_block_vjp_matches_pallas(shape):
    """dx, dw1, dw2 against jax.grad of the Pallas kernel in interpret mode
    (its backward runs _bwd_dx_kernel, which recomputes u, a and s, and
    _bwd_dw_kernel); bias grads 0. Planes of 2 rows and of 2 columns (the
    reflect pad's edge: its fold lands on the plane's other row or column)
    and a non-square plane of 32 channels, the kernels' channel multiple."""
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
    r = RB.residual_block_fwd_plain(x, w1, b1, w2, b2)[1]
    dx, dw1, dw2 = RB.residual_block_bwd_saved_plain(x, dy, w1, w2, r)
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
    g_parts = torch.zeros((3, 1, 4, 4, 16), dtype=torch.bfloat16)
    with pytest.raises(ValueError, match="Cout % 32"):
        RB.conv3x3_reflect_dgrad(g_parts, torch.zeros((3, 3, 32, 16)),
                                 torch.zeros((1, 4, 4, 32)))
    with pytest.raises(ValueError, match="H, W >= 2"):
        RB.conv3x3_reflect_wgrad(torch.zeros((1, 1, 4, 32)),
                                 torch.zeros((3, 1, 1, 4, 32), dtype=torch.bfloat16))


# (tiles, pixels): the trunk's 2304 x 256 weight gradient at batch 2 and 1
# (18 tiles of 128 x 256), other tile counts, a tiny and a huge K.
@pytest.mark.parametrize("tiles,k", [(18, 8192), (18, 4096), (144, 8192), (144, 4096),
                                     (1, 100), (4, 1 << 20), (300, 8192), (36, 96)])
def test_wgrad_split_covers_every_pixel_once(tiles, k):
    splits, kchunk = CD._wgrad_split(tiles, k)
    assert kchunk % CD.STEP == 0 and splits * kchunk >= k > (splits - 1) * kchunk
    # At most one wave of the resident blocks, and no chunk under 256 pixels
    # unless there is only one.
    assert splits == 1 or (splits * tiles <= CD.RESIDENT_BLOCKS and kchunk >= 256)


@pytest.mark.parametrize("k", [4096, 8192, 32768, 65536, 100])
def test_wgrad_split_caps_a_float32_chunk(k):
    """A float32 weight gradient's chunks sum at most F32_CHUNK pixels,
    past one wave of blocks where the batch needs it (8 and 16 rows of the
    trunk), and cover every pixel once; up to batch 2 (8,192 pixels) the
    split is the one-wave split."""
    tiles = CD._wgrad_tiles(9 * 256, 256)
    splits, kchunk = CD._wgrad_split(tiles, k, CD.F32_CHUNK)
    assert kchunk % CD.STEP == 0 and splits * kchunk >= k > (splits - 1) * kchunk
    assert kchunk <= CD.F32_CHUNK
    if k <= 8192:
        assert (splits, kchunk) == CD._wgrad_split(tiles, k)


@pytest.mark.parametrize("k", [4096, 8192])
def test_wgrad_split_fills_the_card_at_the_trunk_shape(k):
    """The trunk's 2304 x 256 weight gradient at batch 1 and 2: 18 output
    tiles in 7 chunks, 126 blocks for the 132 SMs."""
    tiles = CD._wgrad_tiles(9 * 256, 256)
    assert tiles == 18 and CD._wgrad_split(tiles, k)[0] == 7


@pytest.mark.parametrize("call,match", [
    # conv_dw takes any channel count (zero-filled up to a multiple of 8),
    # but reads rows of contiguous NHWC tensors.
    (lambda: CD._dw_cuda(torch.zeros((1, 6, 6, 36)),
                         torch.zeros((1, 4, 24, 4)).transpose(2, 3), 3), "contiguous"),
    (lambda: CD._dw_cuda(torch.zeros((1, 6, 5, 32)), torch.zeros((1, 4, 4, 20)), 3), "padded"),
    # the split into bf16 parts: contiguous input, two parts of float32 only.
    (lambda: CD.bf16_parts(torch.zeros((1, 4, 12, 4)).transpose(2, 3), 2), "contiguous"),
    (lambda: CD.bf16_parts(torch.zeros((1, 4, 4, 8), dtype=torch.bfloat16), 2), "parts"),
    (lambda: CD.bf16_parts(torch.zeros((1, 1, 4, 8)), 2, pad=1), "reflect pad"),
    # the weight-gradient kernel instantiates (1, 1), (1, 2) and (3, 3) parts.
    (lambda: CD.launch_wgrad(torch.zeros((2, 1, 6, 6, 8), dtype=torch.bfloat16), 2,
                             torch.zeros((1, 4, 4, 8), dtype=torch.bfloat16), 1,
                             (1, 4, 4, 8, 8), 3), "parts"),
    # the input gradient: a 32-deep step inside one tap, parts of g.
    (lambda: RB.conv3x3_reflect_dgrad(_parts(2, (1, 4, 4, 48)), torch.zeros((3, 3, 32, 48)),
                                      torch.zeros((1, 4, 4, 32))), "Cout % 32"),
    (lambda: RB.conv3x3_reflect_dgrad(_parts(1, (1, 4, 4, 32)), torch.zeros((3, 3, 32, 32)),
                                      torch.zeros((1, 4, 4, 32))), "g_parts"),
    # the weight gradient of the blocks: Cin % 32, as their other kernels.
    (lambda: RB.conv3x3_reflect_wgrad(torch.zeros((1, 4, 4, 36)), _parts(3, (1, 4, 4, 32))),
     "Cin % 32"),
    # the cotangent only as its bf16 parts: a float32 cotangent itself, parts
    # of another type, count (two against bf16 operands, three against
    # float32) or shape are refused.
    (lambda: RB.conv3x3_reflect_dgrad(torch.zeros((1, 4, 4, 32)), _bf((3, 3, 32, 32)),
                                      torch.zeros((1, 4, 4, 32))), "g_parts"),
    (lambda: RB.conv3x3_reflect_dgrad(torch.zeros((2, 1, 4, 4, 32)), _bf((3, 3, 32, 32)),
                                      torch.zeros((1, 4, 4, 32))), "g_parts"),
    (lambda: RB.conv3x3_reflect_dgrad(_parts(3, (1, 4, 4, 32)), _bf((3, 3, 32, 32)),
                                      torch.zeros((1, 4, 4, 32))), "g_parts"),
    (lambda: RB.conv3x3_reflect_dgrad(_parts(2, (1, 4, 4, 32)), _bf((3, 3, 32, 32)),
                                      torch.zeros((1, 4, 5, 32))), "do not fit"),
    (lambda: RB.conv3x3_reflect_wgrad(_bf((1, 4, 4, 32)), torch.zeros((1, 4, 4, 32))),
     "g_parts"),
    (lambda: RB.conv3x3_reflect_wgrad(_bf((1, 4, 4, 32)), torch.zeros((2, 1, 4, 4, 32))),
     "g_parts"),
    (lambda: RB.conv3x3_reflect_wgrad(_bf((1, 4, 4, 32)), _parts(3, (1, 4, 4, 32))), "g_parts"),
    (lambda: RB.conv3x3_reflect_wgrad(torch.zeros((1, 4, 4, 32)), _parts(2, (1, 4, 4, 32))),
     "g_parts"),
    (lambda: RB.conv3x3_reflect_wgrad(_bf((2, 4, 4, 32)), _parts(2, (1, 4, 4, 32))), "g_parts"),
    # the weight gradient's input: padded or unpadded by its plane, and the
    # parts each form takes.
    (lambda: CD.launch_wgrad(_parts(1, (1, 5, 5, 8)), 1, _parts(2, (1, 4, 4, 8)), 2,
                             (1, 4, 4, 8, 8), 3), "neither"),
    (lambda: CD.launch_wgrad(_parts(1, (1, 4, 4, 8)), 1, _parts(1, (1, 4, 4, 8)), 1,
                             (1, 4, 4, 8, 8), 3), "reflect input"),
    (lambda: CD.launch_wgrad(_parts(1, (1, 4, 4, 8)), 1, _parts(2, (1, 4, 4, 8)), 2,
                             (1, 4, 4, 8, 8), 5), "neither"),
    # the norm VJP's dx: x's shape and type, or 2 or 3 bf16 parts of a
    # float32 dx of x's shape.
    (lambda: _in_bwd_into(torch.zeros((1, 4, 4, 32)), _parts(1, (1, 4, 4, 32))), "neither"),
    (lambda: _in_bwd_into(torch.zeros((1, 4, 4, 32)), _parts(4, (1, 4, 4, 32))), "neither"),
    (lambda: _in_bwd_into(torch.zeros((1, 4, 4, 32)), torch.zeros((2, 1, 4, 4, 32))), "neither"),
    (lambda: _in_bwd_into(torch.zeros((1, 4, 4, 32)), _parts(2, (1, 4, 5, 32))), "neither"),
    (lambda: _in_bwd_into(_bf((1, 4, 4, 32)), _parts(2, (1, 4, 4, 32))), "neither"),
    (lambda: _in_bwd_into(torch.zeros((1, 4, 4, 6)), _parts(2, (1, 4, 4, 6))), "neither"),
    (lambda: _in_bwd_into(torch.zeros((1, 4, 4, 32)), torch.zeros((1, 4, 4, 32),
                                                                  dtype=torch.bfloat16)),
     "neither"),
])
def test_gradient_wrappers_refuse_shapes_the_tiles_do_not_take(call, match):
    """The CUDA gradient wrappers raise on what the tensor-core kernels do
    not take, before any build or launch: no fallback."""
    with pytest.raises(ValueError, match=match):
        call()


class _Recorder:
    """Stands in for the C entries on the CPU: records each call's entry
    and arguments, launches nothing."""

    def __init__(self, monkeypatch):
        self.calls = []
        monkeypatch.setattr(_build, "call", lambda lib, fn, *args: self.calls.append((fn, args)))
        monkeypatch.setattr(_build, "stream_ptr", lambda t: 0)
        monkeypatch.setattr(_build, "scratch_ptr", lambda nbytes, t, s: 16)

    def entries(self) -> list:
        return [fn for fn, _ in self.calls]


# cg_conv_dw's arguments: (xp, dy, dw, part, N, H, W, Cin, Cout, k, splits,
# kchunk, na, nb, reflect, out_dtype, stream); cg_instance_norm_act_bwd's:
# (x, dy, mean, rstd, dx, part, N, HW, C, rows, vec, lanes, tiles, act,
# x_dtype, dy_dtype, dx_parts, stream).
DW_REFLECT, IN_DX_PARTS = 14, 16


@pytest.mark.parametrize("xp_shape,na,nb,form", [
    ((1, 6, 7, 8), 1, 1, "padded"),             # conv_dw's bf16 input as it is
    ((1, 1, 6, 7, 8), 1, 2, "padded"),          # a padded copy's one part
    ((3, 1, 6, 7, 8), 3, 3, "padded"),
    ((1, 4, 5, 8), 1, 2, "reflect"),            # the blocks' bf16 input
    ((3, 1, 4, 5, 8), 3, 3, "reflect"),         # a float32 input's parts
])
def test_wgrad_tells_a_padded_input_from_an_unpadded_one_by_shape(monkeypatch, xp_shape, na,
                                                                   nb, form):
    """launch_wgrad reads the form of its input from its plane, (H+2, W+2)
    padded or (H, W) unpadded, hands the C entry the matching reflect flag
    with the argument count the entry declares, and counts the call by
    form."""
    rec = _Recorder(monkeypatch)
    before = _build.forms.copy()
    dw = CD.launch_wgrad(_parts(1, xp_shape)[0], na, _parts(nb, (1, 4, 5, 8)), nb,
                         (1, 4, 5, 8, 8), 3)
    assert CD.wgrad_form(xp_shape, (1, 4, 5, 8, 8), 3) == form
    ((fn, args),) = rec.calls
    assert fn == "cg_conv_dw" and dw.shape == (3, 3, 8, 8)
    assert len(args) == len(_build.SIGNATURES["conv_dw"]["cg_conv_dw"])
    assert args[12:15] == (na, nb, int(form == "reflect"))
    assert _build.forms - before == {("wgrad", form): 1}


@pytest.mark.parametrize("x_dtype,dx_dtype,dx_lead,want", [
    (torch.float32, torch.float32, (), 0), (torch.bfloat16, torch.bfloat16, (), 0),
    (torch.float32, torch.bfloat16, (2,), 2), (torch.float32, torch.bfloat16, (3,), 3),
])
def test_norm_vjp_takes_dx_in_x_type_or_as_bf16_parts(monkeypatch, x_dtype, dx_dtype, dx_lead,
                                                       want):
    """The norm VJP writes dx in x's type or as the 2 or 3 bf16 parts of a
    float32 dx: the part count goes to the C entry (0 for x's type), and
    the call is counted by dx's form."""
    rec = _Recorder(monkeypatch)
    x = torch.zeros((2, 4, 6, 32), dtype=x_dtype)
    dx = torch.zeros(dx_lead + x.shape, dtype=dx_dtype)
    before = _build.forms.copy()
    assert IN.dx_parts(x, dx) == want
    _in_bwd_into(x, dx)
    ((fn, args),) = rec.calls
    assert fn == "cg_instance_norm_act_bwd"
    assert len(args) == len(_build.SIGNATURES["instance_norm"]["cg_instance_norm_act_bwd"])
    assert args[IN_DX_PARTS] == want
    form = "parts" if want else str(x_dtype).split(".")[1]
    assert _build.forms - before == {("in_bwd", form): 1}


@pytest.mark.parametrize("dtype", [torch.bfloat16, torch.float32])
def test_fused_block_backward_stages_no_operand(monkeypatch, dtype):
    """The fused block's backward on the C entries (recorded, not run): the
    norm VJPs write ds and du as their bf16 parts (two for bf16 x, three
    for float32), which both gradients of each read, and both weight
    gradients read x and a unpadded, through reflect indexing. A bf16 block
    splits nothing (no cg_bf16_parts); a float32 one splits w1, w2, x and a
    into their three parts, which no tensor core takes as float32."""
    rec = _Recorder(monkeypatch)
    n, h, w, c = 1, 4, 5, 32
    x, dy = torch.zeros((n, h, w, c), dtype=dtype), torch.zeros((n, h, w, c), dtype=dtype)
    w1, w2 = torch.zeros((3, 3, c, c), dtype=dtype), torch.zeros((3, 3, c, c), dtype=dtype)
    f32 = torch.zeros((n, h, w, c))
    r = RB.Residuals(f32, x.clone(), f32.clone(), *(torch.zeros((n, c)) for _ in range(4)))
    before = _build.forms.copy()
    dx, ds, du = RB.bwd_dx_saved_cuda(x, dy, w1, w2, r)
    dw1, dw2 = RB.bwd_dw_cuda(x, r.a, ds, du, dtype)
    parts = 2 if dtype == torch.bfloat16 else 3
    assert ds.shape == du.shape == (parts, n, h, w, c) and ds.dtype == torch.bfloat16
    assert dx.shape == x.shape and dw1.shape == dw2.shape == (3, 3, c, c)
    split = [] if dtype == torch.bfloat16 else ["cg_bf16_parts"]
    assert rec.entries() == (["cg_instance_norm_act_bwd", *split, "cg_conv3x3_reflect_dgrad"]
                             * 2 + [*split, "cg_conv_dw"] * 2)
    calls = dict(rec.calls[:2 + len(split)])  # the first VJP and input gradient
    assert calls["cg_instance_norm_act_bwd"][IN_DX_PARTS] == parts
    assert calls["cg_conv3x3_reflect_dgrad"][0] == ds.data_ptr()
    dws = [args for fn, args in rec.calls if fn == "cg_conv_dw"]
    assert [args[DW_REFLECT] for args in dws] == [1, 1]
    assert [args[1] for args in dws] == [du.data_ptr(), ds.data_ptr()]
    assert _build.forms - before == {("in_bwd", "parts"): 2, ("wgrad", "reflect"): 2}


# bf16 parts of each float32 operand, the products (a, b) with a + b <
# max(na, nb) summed in float32: the kernels' arithmetic, in plain
# PyTorch, against float64.
def passes(na: int, nb: int) -> list:
    return [(a, b) for a in range(na) for b in range(nb) if a + b < max(na, nb)]


@pytest.mark.parametrize("a,b,parts_ab,n_passes", [
    (torch.bfloat16, torch.bfloat16, (1, 1), 1),   # conv_dw on path B
    (torch.bfloat16, torch.float32, (1, 2), 2),    # bf16 values, float32 cotangent
    (torch.float32, torch.float32, (3, 3), 6),     # the float32 train step
])
def test_parts_and_passes_of_each_type_mix(a, b, parts_ab, n_passes):
    """The one rule that the kernels' wrappers and chip_smoke.py's bounds
    read: bf16 parts per operand and the tensor-core products over them."""
    assert (CD.parts(a, b), CD.parts(b, a)) == parts_ab
    assert CD.passes(*parts_ab) == CD.passes(*parts_ab[::-1]) == n_passes
    assert CD.passes(*parts_ab) == len(passes(*parts_ab))


@pytest.mark.parametrize("cin,cout,routed", [(128, 128, True), (132, 132, True),
                                             (256, 130, True), (64, 256, False),
                                             (256, 120, False)])
def test_conv_dw_routes_the_jax_packages_convolutions(cin, cout, routed):
    """The trunk convolutions whose weight gradient takes the kernel are
    the JAX package's (both channel dims >= 128, a plane that fits its
    VMEM budget), multiples of 8 or not: the kernel takes any count."""
    xp, dy = (1, 10, 10, cin), (1, 8, 8, cout)
    assert CD.supported(xp, dy) == jax_dw_supported(xp, dy, 2) == routed


@pytest.mark.parametrize("parts,bound", [(2, 2 ** -16), (3, 2 ** -24)])
def test_bf16_parts_reconstruct_float32(parts, bound):
    t = torch.from_numpy(_x((4, 5, 6, 8), 50, 3.0)) * torch.logspace(-20, 20, 8)
    p = CD.bf16_parts_plain(t, parts).double()
    assert torch.equal(p[0], t.to(torch.bfloat16).double())
    assert bool(((t.double() - p.sum(0)).abs() <= bound * t.double().abs()).all())
    assert CD.bf16_parts_plain(t, 1).shape == (1, *t.shape)
    assert passes(1, 2) == [(0, 0), (0, 1)] and len(passes(3, 3)) == 6


@pytest.mark.parametrize("x_dtype,parts", [(torch.bfloat16, (1, 2)), (torch.float32, (3, 3))])
def test_bf16_parts_hold_the_float32_bar(x_dtype, parts):
    """The weight gradient as the kernel computes it (bf16 input with the
    float32 cotangent's two parts; float32 on both sides in three parts
    each) within chip_smoke.py's float32 bar of the float64 truth; the
    cotangent rounded to one bf16 part misses it."""
    xp = torch.from_numpy(_x((2, 10, 9, 16), 51)).to(x_dtype)
    g = torch.from_numpy(_x((2, 8, 7, 24), 52))
    x64, g64 = xp.double(), g.double().reshape(-1, 24)
    truth = torch.stack([torch.stack([x64[:, s:s + 8, t:t + 7].reshape(-1, 16).T @ g64
                                      for t in range(3)]) for s in range(3)])
    xs = CD.bf16_parts_plain(xp, parts[0]) if x_dtype == torch.float32 else xp[None]
    gs = CD.bf16_parts_plain(g, parts[1])

    def err_over_bar(dw):
        allowed = 1e-5 * truth.abs().max() + 1e-4 * truth.abs()
        return float(((dw.double() - truth).abs() / allowed).max())

    dw = sum(CD.conv_dw_plain(xs[a], gs[b]) for a, b in passes(*parts))
    # 0.15 of the bar for bf16 x here; float32 x in three parts is as exact
    # as a float32 product.
    assert err_over_bar(dw) <= (0.5 if x_dtype == torch.bfloat16 else 0.05)
    assert err_over_bar(CD.conv_dw_plain(xs[0], gs[0])) > 1.0


def test_cpu_backward_leaves_launch_counters_at_zero():
    before = _build.launches.copy()
    x = torch.from_numpy(_x((1, 4, 4, 32), 40)).requires_grad_()
    w1, b1, w2, b2 = [torch.from_numpy(a).requires_grad_() for a in _rb_params(32, 41)]
    y = IN.instance_norm_act(RB.residual_block_fused(x, w1, b1, w2, b2), None, 1e-5, "relu")
    F.mse_loss(y, torch.zeros_like(y)).backward()
    assert [_build.launches[e] - before[e] for e in (
        "cg_instance_norm_act_bwd", "cg_conv3x3_reflect_dgrad", "cg_conv_dw")] == [0, 0, 0]
    assert x.grad is not None and torch.count_nonzero(w1.grad) > 0
