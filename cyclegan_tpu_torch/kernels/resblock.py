"""Whole ResidualBlock, forward and VJP.

The counterpart of ``cyclegan_tpu/kernels/resblock.py::residual_block_fused``::

    y = x + IN(conv3x3(rpad(relu(IN(conv3x3(rpad(x)) + b1)))) + b2)

on NHWC ``x`` with HWIO weights. As in the Pallas kernel, the convolution
outputs u and s stay float32 and ``relu(IN(u))`` is cast to x's type before
the second convolution.

The VJP keeps the JAX design: only ``(x, w1, b1, w2, b2)`` are saved; the
backward recomputes u, a and s and their statistics, then chains::

    ds = IN_bwd(s, dy; none)         da = dgrad(ds, w2)
    du = IN_bwd(u, da; relu)         dx = dy + dgrad(du, w1)
    dw2 = wgrad(a, ds)               dw1 = wgrad(x, du)

with float32 cotangents and accumulation (the Pallas kernels cast the
weights to float32 for the input gradient). ``dw`` is summed over the batch
and cast to the weights' type; the bias gradients are exactly zero (a
per-channel constant before an instance norm cancels).

:func:`residual_block_fused` is a ``torch.autograd.Function``. On a CUDA
tensor it launches the hand-written kernels of ``csrc/resblock.cu`` (the
convolution and its input gradient), ``csrc/conv_dw.cu`` (the weight
gradient, and the split of each float32 cotangent into the bf16 parts that
the tensor cores multiply) and ``csrc/instance_norm.cu``, or raises;
on a CPU tensor it runs the plain versions through the same Function.
"""

from __future__ import annotations

import collections
import functools

import torch
import torch.nn.functional as F

from cyclegan_tpu_torch.kernels import _build
from cyclegan_tpu_torch.kernels import conv_dw as CD
from cyclegan_tpu_torch.kernels import instance_norm as _in


def _conv3x3_plain(x: torch.Tensor, w: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """float32 reflect-pad 3x3 conv + bias: NHWC x, HWIO w -> NHWC f32."""
    xp = F.pad(x.float().permute(0, 3, 1, 2), (1, 1, 1, 1), mode="reflect")
    y = F.conv2d(xp, w.float().permute(3, 2, 0, 1), b.float())
    return y.permute(0, 2, 3, 1)


def residual_block_plain(x: torch.Tensor, w1: torch.Tensor, b1: torch.Tensor,
                         w2: torch.Tensor, b2: torch.Tensor,
                         eps: float = 1e-5) -> torch.Tensor:
    """Plain PyTorch version; u and s are float32 as in the Pallas kernel."""
    u = _conv3x3_plain(x, w1, b1)
    a = _in.instance_norm_act_plain(u, None, eps, "relu", out_dtype=x.dtype)
    s = _conv3x3_plain(a, w2, b2)
    return _in.instance_norm_act_plain(s, x, eps, "none", out_dtype=x.dtype)


def _fold_pad1_plain(gp: torch.Tensor) -> torch.Tensor:
    """VJP of the reflect pad of 1: (N, H+2, W+2, C) -> (N, H, W, C), pad
    columns folded first (they were padded last), then pad rows."""
    w_ = gp.shape[2] - 2
    g = gp[:, :, 1:-1].clone()
    g[:, :, 1] += gp[:, :, 0]
    g[:, :, w_ - 2] += gp[:, :, -1]
    h = gp.shape[1] - 2
    out = g[:, 1:-1].clone()
    out[:, 1] += g[:, 0]
    out[:, h - 2] += g[:, -1]
    return out


def conv3x3_reflect_dgrad_plain(g: torch.Tensor, w: torch.Tensor) -> torch.Tensor:
    """Input gradient of conv3x3(rpad1(x), w) for the output gradient ``g``
    (N, H, W, Cout), as the Pallas kernel computes it: nine float32 dots
    with w[dy, dx]^T placed into the padded gradient, then the fold.
    Returns (N, H, W, Cin) float32."""
    n, h, w_, _ = g.shape
    g32, w32 = g.float(), w.float()
    dpad = g32.new_zeros((n, h + 2, w_ + 2, w.shape[2]))
    for dy in range(3):
        for dx in range(3):
            dpad[:, dy:dy + h, dx:dx + w_] += g32 @ w32[dy, dx].T
    return _fold_pad1_plain(dpad)


def conv3x3_reflect_wgrad_plain(inp: torch.Tensor, g: torch.Tensor) -> torch.Tensor:
    """Weight gradient of conv3x3(rpad1(inp), w) for the output gradient
    ``g``: dw[s, t] = sum over batch and pixels of rpad1(inp)[.., i+s, j+t, :]^T
    g[.., i, j, :]. Returns (3, 3, Cin, Cout) float32."""
    n, h, w_, cin = inp.shape
    xp = F.pad(inp.float().permute(0, 3, 1, 2), (1, 1, 1, 1), mode="reflect")
    xp = xp.permute(0, 2, 3, 1)
    g2 = g.float().reshape(-1, g.shape[-1])
    rows = []
    for dy in range(3):
        rows.append(torch.stack([xp[:, dy:dy + h, dx:dx + w_].reshape(-1, cin).T @ g2
                                 for dx in range(3)]))
    return torch.stack(rows)


def bwd_dx_plain(x, dy, w1, b1, w2, b2, eps=1e-5, relu_mask=None):
    """Plain version of :func:`bwd_dx_cuda`: the recompute, then ds, du and
    dx = dy + dgrad(du, w1) in x's type. Returns ``(dx, a, ds, du)``.

    ``relu_mask`` (bool, x's shape), if given, replaces the mask of relu
    that the recompute's own u gives: du = IN_bwd(u, da * relu_mask; none).
    The on-card checks pass the kernel path's mask (``a > 0`` of its
    recompute), so that an element whose normalised u lies within the
    convolutions' rounding of zero takes the same side in both; without it
    the result is bitwise what the mask of this function's own u gives."""
    u = _conv3x3_plain(x, w1, b1)
    mean1, rstd1 = _in.instance_norm_stats_plain(u, eps)
    a = _in.instance_norm_act_plain(u, None, eps, "relu", out_dtype=x.dtype)
    s = _conv3x3_plain(a, w2, b2)
    mean2, rstd2 = _in.instance_norm_stats_plain(s, eps)
    ds = _in.instance_norm_act_bwd_plain(s, dy, mean2, rstd2, "none")
    da = conv3x3_reflect_dgrad_plain(ds, w2)
    if relu_mask is None:
        du = _in.instance_norm_act_bwd_plain(u, da, mean1, rstd1, "relu")
    else:
        du = _in.instance_norm_act_bwd_plain(u, da * relu_mask, mean1, rstd1, "none")
    dx = (dy.float() + conv3x3_reflect_dgrad_plain(du, w1)).to(x.dtype)
    return dx, a, ds, du


def relu_mask_flips(x: torch.Tensor, w1: torch.Tensor, b1: torch.Tensor,
                    mask: torch.Tensor, eps: float = 1e-5,
                    conv_tol: tuple[float, float] = (1e-4, 1e-4)) -> tuple[int, float]:
    """Where ``mask`` (the kernel path's relu mask of the block's first
    normalisation: ``a > 0`` of its recompute) differs from the plain
    version's own: ``(flips, worst)``, the number of such elements and the
    largest |uhat| / threshold among them (uhat the plain version's
    normalised u; 0.0 without flips). The on-card checks hold the plain VJP
    on ``mask`` (``relu_mask``) and these flips on their own.

    The threshold of sample n, channel c: the kernel's u is within the
    forward convolution's bar ``atol + rtol |u|`` of the plain u, and its
    mean within that bar at the plane's largest |u|, so the two normalised
    values differ by at most ``2 (atol + rtol max_hw |u|) rstd`` (rstd's own
    rounding moves uhat by a relative ~1e-6, second order where |uhat| is
    that small). Two values on other sides of zero are each within their
    difference of zero, so every honest flip has |uhat| under it."""
    u = _conv3x3_plain(x, w1, b1)
    mean, rstd = _in.instance_norm_stats_plain(u, eps)
    uhat = (u - mean[:, None, None]) * rstd[:, None, None]
    atol, rtol = conv_tol
    thr = 2 * (atol + rtol * u.abs().amax(dim=(1, 2), keepdim=True)) * rstd[:, None, None]
    flipped = (uhat > 0) != mask
    flips = int(flipped.sum())
    return flips, float((uhat.abs() / thr)[flipped].max()) if flips else 0.0


def bwd_dw_plain(x, a, ds, du):
    """Plain version of :func:`bwd_dw_cuda`: float32 ``(dw1, dw2)``."""
    return conv3x3_reflect_wgrad_plain(x, du), conv3x3_reflect_wgrad_plain(a, ds)


def residual_block_bwd_plain(x: torch.Tensor, dy: torch.Tensor, w1: torch.Tensor,
                             b1: torch.Tensor, w2: torch.Tensor, b2: torch.Tensor,
                             eps: float = 1e-5, relu_mask: torch.Tensor | None = None
                             ) -> tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """Plain PyTorch VJP: ``(dx (x's type), dw1, dw2 (float32))``, the
    recompute and the chain of the module docstring, step by step;
    ``relu_mask`` as in :func:`bwd_dx_plain`."""
    dx, a, ds, du = bwd_dx_plain(x, dy, w1, b1, w2, b2, eps, relu_mask)
    return (dx, *bwd_dw_plain(x, a, ds, du))


# The convolutions take channel counts in multiples of this (conv_plan's
# Cin, _check_grad_shapes' Cin and Cout); the blocks zero-fill a narrower
# trunk up to it and cut their results back.
CHANNEL_MULTIPLE = 32


def padded_channels(c: int) -> int:
    """The width the blocks run a trunk of ``c`` channels at."""
    return -(-c // CHANNEL_MULTIPLE) * CHANNEL_MULTIPLE


def zero_fill(t: torch.Tensor, c: int, dims: int = 1) -> torch.Tensor:
    """A copy of ``t`` with its last ``dims`` dimensions zero-filled up to
    ``c`` (an NHWC plane, a bias or the (N, 4, C) statistics: 1; a
    (3, 3, C, C) weight: 2). In exact arithmetic the block is unchanged on
    the first channels: a zero channel of x meets zero rows of w1, the
    padded outputs u and s are 0 (zero columns and biases), an instance
    norm of a constant 0 is 0, and a zero cotangent gives zero gradients."""
    return F.pad(t, (0, c - t.shape[-1]) * dims)


# The bf16 forward convolution's tiles (csrc/resblock.cu, conv3x3_wgmma<HALO,
# WM, BN, STAGES>): WM warpgroups of 64 output pixels x BN channels each,
# a ring of STAGES steps; a HALO tile owns a patch of WM image rows x 64
# columns and keeps its input's halos in shared memory, the others own
# 64 WM consecutive pixels. (HALO, WM, BN, STAGES) in the order the plan
# prefers them; the C entry takes exactly these.
CONV_TILES = ((False, 2, 256, 4), (True, 2, 128, 4), (True, 2, 64, 4), (False, 2, 64, 4))
CONV_COLS = 64                                 # columns of a patch
CONV_FILL = 128                                # blocks that fill the card (97% of 132 SMs)
SMEM_BLOCK_MAX, SMEM_SM = 232448, 233472       # bytes a block may have; an SM's


def conv_tile(tile: tuple[bool, int, int, int], cin: int) -> tuple[int, int]:
    """``(shared memory bytes a block, blocks an SM)`` of a tile for ``cin``
    input channels, as ``ConvTile::smem`` in csrc/resblock.cu sizes it: the
    ring (STAGES steps of A's 64 WM pixel rows of 128 B, none for a HALO
    tile, and B's 64 rows x BN channels), 1 KB to align, a HALO tile's
    halos ((WM + 2) x 66 pixels of 128 B, rounded up to 1 KB, one per 64
    input channels), and the 1 KB an SM reserves per block."""
    halo, wm, bn, stages = tile
    smem = stages * ((0 if halo else 64 * wm * 128) + bn * 128) + 1024
    if halo:
        smem += -(-cin // 64) * (-(-(wm + 2) * (CONV_COLS + 2) * 128 // 1024) * 1024)
    return smem, 2 if not halo and 2 * (smem + 1024) <= SMEM_SM else 1


def conv_blocks(tile: tuple[bool, int, int, int], n: int, h: int, w: int, cout: int) -> int:
    """Blocks in the grid of ``tile`` for an (n, h, w) output of cout channels."""
    halo, wm, bn, _ = tile
    rows = n * -(-h // wm) * -(-w // CONV_COLS) if halo else -(-n * h * w // (64 * wm))
    return rows * -(-cout // bn)


@functools.cache
def conv_plan(n: int, h: int, w: int, cin: int, cout: int) -> tuple[bool, int, int, int]:
    """The tile of the bf16 convolution of an (n, h, w, cin) input to cout
    channels, from the shapes alone: the first of :data:`CONV_TILES` whose
    shared memory fits a block and whose grid gives the card
    :data:`CONV_FILL` blocks, else the fitting one with the most blocks.
    Raises ValueError on shapes the kernel does not take."""
    if h < 2 or w < 2:
        raise ValueError(f"reflect padding needs H, W >= 2, got {h}x{w}")
    if cin % 32 or cout % 8:
        raise ValueError(f"conv3x3_reflect needs Cin % 32 == 0 and Cout % 8 == 0, "
                         f"got Cin={cin}, Cout={cout}")
    fits = [t for t in CONV_TILES if conv_tile(t, cin)[0] <= SMEM_BLOCK_MAX]
    blocks = {t: conv_blocks(t, n, h, w, cout) for t in fits}
    full = [t for t in fits if blocks[t] >= CONV_FILL]
    return full[0] if full else max(fits, key=blocks.get)


def conv3x3_reflect(x: torch.Tensor, w: torch.Tensor, b: torch.Tensor,
                    out: torch.Tensor) -> None:
    """CUDA kernel: ``out`` (NHWC f32) = conv3x3(rpad1(x), w) + b."""
    n, h, w_, cin = x.shape
    conv3x3_reflect_planned(x, w, b, out, conv_plan(n, h, w_, cin, w.shape[-1]))


def conv3x3_reflect_planned(x: torch.Tensor, w: torch.Tensor, b: torch.Tensor,
                            out: torch.Tensor, plan: tuple[bool, int, int, int]) -> None:
    """:func:`conv3x3_reflect` on a given tile (the on-card checks time
    every tile of :data:`CONV_TILES`; float32 ignores the tile)."""
    n, h, w_, cin = x.shape
    cout = w.shape[-1]
    conv_plan(n, h, w_, cin, cout)  # the shape checks
    if w.shape != (3, 3, cin, cout) or b.shape != (cout,):
        raise ValueError(f"weight {tuple(w.shape)} / bias {tuple(b.shape)} do not "
                         f"fit Cin={cin}, Cout={cout}")
    if out.shape != (n, h, w_, cout) or out.dtype != torch.float32:
        raise ValueError("conv3x3_reflect: out must be (N, H, W, Cout) float32")
    _build.check_same_device("conv3x3_reflect", x, w, b, out)
    if w.dtype != x.dtype or b.dtype != x.dtype:
        raise TypeError("conv3x3_reflect: x, w and b must share one dtype")
    _build.call("resblock", "cg_conv3x3_reflect",
                x.data_ptr(), w.data_ptr(), b.data_ptr(), out.data_ptr(),
                n, h, w_, cin, cout, _build.DTYPE_CODES[x.dtype], *plan, _build.stream_ptr(x))


def _check_grad_shapes(name: str, h: int, w_: int, cin: int, cout: int) -> None:
    if h < 2 or w_ < 2:
        raise ValueError(f"reflect padding needs H, W >= 2, got {h}x{w_}")
    if cin % 32 or cout % 32:
        raise ValueError(f"{name} needs Cin % 32 == 0 and Cout % 32 == 0, "
                         f"got Cin={cin}, Cout={cout}")


def _check_g_parts(name: str, g: torch.Tensor, g_parts: torch.Tensor | None,
                   parts: int) -> torch.Tensor:
    """The ``parts`` bf16 parts of the float32 cotangent ``g``: ``g_parts``
    when the caller split it already (one split serves a cotangent's input
    and weight gradient), else split now."""
    if g_parts is None:
        return CD.bf16_parts(g, parts)
    if g_parts.shape != (parts, *g.shape) or g_parts.dtype != torch.bfloat16:
        raise ValueError(f"{name}: g_parts {tuple(g_parts.shape)} {g_parts.dtype} are not "
                         f"the {parts} bf16 parts of g {tuple(g.shape)}")
    _build.check_same_device(name, g, g_parts)
    return g_parts


# The input gradient's tiles (csrc/resblock.cu, dgrad_mma<NG, NW, WGMMA, WM,
# BN, STAGES>): (WGMMA, WM, BN, STAGES), 64 WM padded pixels x BN input
# channels a block of 256 threads, a ring of STAGES steps of one tap x 64
# output channels. DGRAD_TILES, the plan's, take the main path's parts (two
# of the float32 cotangent, one of a bf16 weight) on wgmma: two warpgroups
# of 64 pixel rows, each with hi and lo in accumulators of their own.
# Of the wgmma tiles an H100 timed (csrc/resblock.cu's note), this one was
# the fastest at batch 1, 2, 8 and 16 of the trunk. DGRAD_SYNC, the
# mma.sync tile, takes a float32 weight's three parts against three. The
# C entry takes exactly these.
DGRAD_TILES = ((True, 2, 128, 4),)
DGRAD_SYNC = (False, 1, 128, 3)
dgrad_tiles: collections.Counter = collections.Counter()  # calls by tile, on the card


def dgrad_smem(tile: tuple[bool, int, int, int]) -> int:
    """Shared memory bytes a block of a wgmma input-gradient tile takes, as
    ``DgradWgmma::SMEM`` in csrc/resblock.cu sizes it: the ring (both
    parts' 64 WM pixel rows and B's BN rows, 128 B each) and 1 KB to
    align."""
    _, wm, bn, stages = tile
    return stages * (2 * 64 * wm + bn) * 128 + 1024


def dgrad_blocks(tile: tuple[bool, int, int, int], n: int, h: int, w: int, cin: int) -> int:
    """Blocks in the grid of ``tile`` for the (n, h + 2, w + 2) padded
    gradient of cin channels."""
    _, wm, bn, _ = tile
    return -(-n * (h + 2) * (w + 2) // (64 * wm)) * -(-cin // bn)


@functools.cache
def dgrad_plan(n: int, h: int, w: int, cin: int, cout: int) -> tuple[bool, int, int, int]:
    """The tile of the input gradient of an (n, h, w, cout) float32
    cotangent to cin channels on the main path's parts (two of the
    cotangent, one of a bf16 weight), from the shapes alone, by
    :func:`conv_plan`'s rule: the first of :data:`DGRAD_TILES` whose shared
    memory fits a block and whose grid gives the card :data:`CONV_FILL`
    blocks, else the fitting one with the most blocks. Raises ValueError
    on shapes the kernel does not take."""
    _check_grad_shapes("conv3x3_reflect_dgrad", h, w, cin, cout)
    if n < 1 or n * h * w * cin >= 2 ** 31:
        raise ValueError(f"conv3x3_reflect_dgrad needs 1 <= N and N*H*W*Cin < 2^31, "
                         f"got N={n}, {h}x{w}x{cin}")
    fits = [t for t in DGRAD_TILES if dgrad_smem(t) <= SMEM_BLOCK_MAX]
    blocks = {t: dgrad_blocks(t, n, h, w, cin) for t in fits}
    full = [t for t in fits if blocks[t] >= CONV_FILL]
    return full[0] if full else max(fits, key=blocks.get)


def conv3x3_reflect_dgrad(g: torch.Tensor, w: torch.Tensor, out: torch.Tensor,
                          add: torch.Tensor | None = None,
                          g_parts: torch.Tensor | None = None) -> None:
    """CUDA kernel: ``out`` (N, H, W, Cin; float32 or bf16) = the input
    gradient of conv3x3(rpad1(.), w) for the float32 output gradient ``g``
    (N, H, W, Cout), reflect fold included, plus ``add`` (out's type). The
    tensor cores multiply the bf16 parts of ``g`` (``g_parts``, if the
    caller has them: ``CD.parts(g.dtype, w.dtype)`` of them) with those of
    ``w``, on the tile of :func:`dgrad_plan` (a float32 weight's three
    parts on :data:`DGRAD_SYNC`), counted in :data:`dgrad_tiles`."""
    n, h, w_, cout = g.shape
    cin = w.shape[2]
    plan = dgrad_plan(n, h, w_, cin, cout)  # the shape checks
    if g.dtype != torch.float32:
        raise TypeError("conv3x3_reflect_dgrad: g must be float32")
    if w.shape != (3, 3, cin, cout) or out.shape != (n, h, w_, cin):
        raise ValueError(f"conv3x3_reflect_dgrad: w {tuple(w.shape)} / out "
                         f"{tuple(out.shape)} do not fit g {tuple(g.shape)}")
    if add is not None and (add.shape != out.shape or add.dtype != out.dtype):
        raise ValueError("conv3x3_reflect_dgrad: add must match out")
    _build.check_same_device("conv3x3_reflect_dgrad", g, w, out,
                             *([add] if add is not None else []))
    ng, nw = CD.parts(g.dtype, w.dtype), CD.parts(w.dtype, g.dtype)
    if (ng, nw) != (2, 1):
        plan = DGRAD_SYNC
    gp = _check_g_parts("conv3x3_reflect_dgrad", g, g_parts, ng)
    wp = w if nw == 1 else CD.bf16_parts(w.reshape(1, 9, cin, cout), nw)
    stream = _build.stream_ptr(g)
    dpad = _build.scratch_ptr(4 * n * (h + 2) * (w_ + 2) * cin, g, stream)
    _build.call("resblock", "cg_conv3x3_reflect_dgrad",
                gp.data_ptr(), wp.data_ptr(), None if add is None else add.data_ptr(),
                out.data_ptr(), dpad, n, h, w_, cin, cout, ng, nw, *plan,
                _build.DTYPE_CODES[out.dtype], stream)
    dgrad_tiles[plan] += 1


def conv3x3_reflect_wgrad(inp: torch.Tensor, g: torch.Tensor,
                          out_dtype: torch.dtype = torch.float32,
                          g_parts: torch.Tensor | None = None) -> torch.Tensor:
    """CUDA kernel: the weight gradient (3, 3, Cin, Cout) of ``out_dtype``
    of conv3x3(rpad1(inp), w) for the float32 output gradient ``g``, summed
    over the batch: ``inp`` reflect-padded once into its bf16 part(s), then
    the VALID weight gradient of ``kernels.conv_dw`` (split-K partials added
    in a fixed order). ``g_parts``: the ``CD.parts(g.dtype, inp.dtype)``
    bf16 parts of ``g``, if the caller has them."""
    n, h, w_, cin = inp.shape
    cout = g.shape[-1]
    _check_grad_shapes("conv3x3_reflect_wgrad", h, w_, cin, cout)
    if g.dtype != torch.float32 or g.shape != (n, h, w_, cout):
        raise ValueError(f"conv3x3_reflect_wgrad: g must be float32 (N, H, W, Cout), "
                         f"got {g.dtype} {tuple(g.shape)}")
    _build.check_same_device("conv3x3_reflect_wgrad", inp, g)
    ng, na = CD.parts(g.dtype, inp.dtype), CD.parts(inp.dtype, g.dtype)
    gp = _check_g_parts("conv3x3_reflect_wgrad", g, g_parts, ng)
    return CD.launch_wgrad(CD.bf16_parts(inp, na, pad=1), na, gp, ng, (n, h, w_, cin, cout), 3,
                           out_dtype)


def _fwd_cuda(x, w1, b1, w2, b2, eps):
    n, h, w_, c = x.shape
    if w1.shape[-1] != c:
        raise ValueError(f"residual block needs Cout == Cin == {c}, got {w1.shape[-1]}")
    cp = padded_channels(c)
    if cp != c:
        y = _fwd_cuda(zero_fill(x, cp), zero_fill(w1, cp, 2), zero_fill(b1, cp),
                      zero_fill(w2, cp, 2), zero_fill(b2, cp), eps)
        return y[..., :c].contiguous()
    u = torch.empty((n, h, w_, c), dtype=torch.float32, device=x.device)
    conv3x3_reflect(x, w1, b1, u)
    a = torch.empty_like(x, memory_format=torch.contiguous_format)
    _in.launch(u, None, a, eps, "relu")
    conv3x3_reflect(a, w2, b2, u)  # s overwrites u: u is dead once `a` exists
    y = torch.empty_like(a)
    _in.launch(u, x, y, eps, "none")
    return y


def bwd_dx_cuda(x, dy, w1, b1, w2, b2, eps):
    """TPU kernel #4 (``_bwd_dx_kernel``) on the card: recompute u, a, s and
    their statistics, then ds, du and dx = dy + dgrad(du, w1). Returns
    ``(dx, a, ds, du, g_parts)``, ``g_parts`` the bf16 parts of ds and du
    (one split serves a cotangent's input and weight gradient); all but dx
    feed :func:`bwd_dw_cuda`."""
    f32 = dict(dtype=torch.float32, device=x.device)
    u = torch.empty(x.shape, **f32)
    conv3x3_reflect(x, w1, b1, u)
    a = torch.empty_like(x, memory_format=torch.contiguous_format)
    mean1, rstd1 = _in.launch(u, None, a, eps, "relu")
    s = torch.empty(x.shape, **f32)
    conv3x3_reflect(a, w2, b2, s)
    mean2, rstd2 = _in.launch(s, None, None, eps, "none")
    ds = torch.empty(x.shape, **f32)
    _in.launch_bwd(s, dy, mean2, rstd2, ds, "none")
    ng = CD.parts(torch.float32, x.dtype)
    ds_parts = CD.bf16_parts(ds, ng)
    da = s  # s is dead once ds exists
    conv3x3_reflect_dgrad(ds, w2, da, g_parts=ds_parts)
    du = torch.empty(x.shape, **f32)
    _in.launch_bwd(u, da, mean1, rstd1, du, "relu")
    du_parts = CD.bf16_parts(du, ng)
    dx = torch.empty_like(a)
    conv3x3_reflect_dgrad(du, w1, dx, add=dy, g_parts=du_parts)
    return dx, a, ds, du, (ds_parts, du_parts)


def bwd_dw_cuda(x, a, ds, du, w_dtype, g_parts):
    """TPU kernel #5 (``_bwd_dw_kernel``) on the card: dw1 = wgrad(x, du)
    and dw2 = wgrad(a, ds), summed over the batch, in the weights' type;
    ``g_parts`` = (ds, du) in bf16 parts, from :func:`bwd_dx_cuda`."""
    ds_parts, du_parts = g_parts
    dw = (conv3x3_reflect_wgrad(x, du, w_dtype, g_parts=du_parts),
          conv3x3_reflect_wgrad(a, ds, w_dtype, g_parts=ds_parts))
    return dw


def _bwd_cuda(x, dy, w1, b1, w2, b2, eps):
    c = x.shape[-1]
    cp = padded_channels(c)
    if cp != c:
        dx, dw1, dw2 = _bwd_cuda(zero_fill(x, cp), zero_fill(dy, cp), zero_fill(w1, cp, 2),
                                 zero_fill(b1, cp), zero_fill(w2, cp, 2), zero_fill(b2, cp), eps)
        return dx[..., :c].contiguous(), dw1[:, :, :c, :c], dw2[:, :, :c, :c]
    dx, a, ds, du, g_parts = bwd_dx_cuda(x, dy, w1, b1, w2, b2, eps)
    return (dx, *bwd_dw_cuda(x, a, ds, du, w1.dtype, g_parts))


class ResidualBlockFused(torch.autograd.Function):
    """The differentiable seam; ``plain`` picks the plain versions. Saves
    ``(x, w1, b1, w2, b2)`` only when a gradient is wanted."""

    @staticmethod
    def forward(ctx, x, w1, b1, w2, b2, eps, plain):
        y = (residual_block_plain if plain else _fwd_cuda)(x, w1, b1, w2, b2, eps)
        if any(ctx.needs_input_grad[:5]):
            ctx.save_for_backward(x, w1, b1, w2, b2)
            ctx.eps, ctx.plain = eps, plain
        return y

    @staticmethod
    def backward(ctx, dy):
        x, w1, b1, w2, b2 = ctx.saved_tensors
        bwd = residual_block_bwd_plain if ctx.plain else _bwd_cuda
        dx, dw1, dw2 = bwd(x, dy.contiguous(), w1, b1, w2, b2, ctx.eps)
        return (dx, dw1.to(w1.dtype), torch.zeros_like(b1), dw2.to(w2.dtype),
                torch.zeros_like(b2), None, None)


def residual_block_fused(x: torch.Tensor, w1: torch.Tensor, b1: torch.Tensor,
                         w2: torch.Tensor, b2: torch.Tensor,
                         eps: float = 1e-5) -> torch.Tensor:
    """Fused ResidualBlock, differentiable; x (N, H, W, C), w (3, 3, C, C),
    b (C,), all of one dtype. CUDA tensors launch the kernels, forward and
    backward; CPU tensors run the plain versions; any other device raises.

    On the card a C that is no multiple of :data:`CHANNEL_MULTIPLE` costs
    copies: x, the weights and biases (and dy in the backward) zero-filled
    up to :func:`padded_channels`, and y, dx, dw1 and dw2 cut back to C.
    The main path's widths (64, 128, 256) make none."""
    if x.dim() != 4:
        raise ValueError(f"residual_block_fused wants NHWC, got {tuple(x.shape)}")
    if x.device.type not in ("cpu", "cuda"):
        raise ValueError(f"residual_block_fused: no kernel for device {x.device}")
    return ResidualBlockFused.apply(x, w1, b1, w2, b2, eps, x.device.type == "cpu")


def residual_block_reference(x: torch.Tensor, w1: torch.Tensor, b1: torch.Tensor,
                             w2: torch.Tensor, b2: torch.Tensor,
                             eps: float = 1e-5) -> torch.Tensor:
    """The same Function over the plain versions on any device (the on-card
    checks' yardstick; the port's modules never call it)."""
    return ResidualBlockFused.apply(x, w1, b1, w2, b2, eps, True)
