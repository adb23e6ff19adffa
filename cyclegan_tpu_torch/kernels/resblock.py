"""Whole ResidualBlock, forward and VJP.

The counterpart of ``cyclegan_tpu/kernels/resblock.py::residual_block_fused``::

    y = x + IN(conv3x3(rpad(relu(IN(conv3x3(rpad(x)) + b1)))) + b2)

on NHWC ``x`` with HWIO weights. As in the Pallas kernel, the convolution
outputs u and s stay float32 and ``relu(IN(u))`` is cast to x's type before
the second convolution.

When a gradient is wanted, the forward keeps what it computes
(:class:`Residuals`: u, a, s and both norms' statistics, about 10 bytes an
element of x more than the JAX design, which saves only ``(x, w1, b1, w2,
b2)`` and recomputes them), and the backward starts at ``ds``::

    ds = IN_bwd(s, dy; none)         da = dgrad(ds, w2)
    du = IN_bwd(u, da; relu)         dx = dy + dgrad(du, w1)
    dw2 = wgrad(a, ds)               dw1 = wgrad(x, du)

with float32 cotangents and accumulation (the Pallas kernels cast the
weights to float32 for the input gradient; on the card the norm VJPs write
ds and du straight into the bf16 parts that the gradient convolutions
multiply). ``dw`` is summed over the batch and cast to the weights' type;
the bias gradients are exactly zero (a per-channel constant before an
instance norm cancels). Under the trunk's
``remat`` the checkpoint drops the residuals and reruns the forward, which
keeps them again: a block is recomputed once. The plain VJP
(:func:`residual_block_bwd_saved_plain`) starts from residuals too: the
on-card checks feed it the kernel forward's own, so both sides take one
relu mask.

:func:`residual_block_fused` is a ``torch.autograd.Function``. On a CUDA
tensor it launches the hand-written kernels of ``csrc/resblock.cu`` (the
convolution and its input gradient), ``csrc/conv_dw.cu`` (the weight
gradient, which reads x and a through reflect indexing) and
``csrc/instance_norm.cu`` (whose VJP writes ds and du as the bf16 parts
that the tensor cores multiply), or raises; on a CPU tensor it runs the
plain versions through the same Function.
"""

from __future__ import annotations

import collections
import functools
from typing import NamedTuple

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


class Residuals(NamedTuple):
    """What the block's forward keeps for its backward, at the width the
    convolutions ran: the float32 convolution outputs ``u`` and ``s``,
    ``a = relu(IN(u))`` in x's type, and the float32 (N, C) statistics of
    both norms."""
    u: torch.Tensor
    a: torch.Tensor
    s: torch.Tensor
    mean1: torch.Tensor
    rstd1: torch.Tensor
    mean2: torch.Tensor
    rstd2: torch.Tensor


def residual_block_plain(x: torch.Tensor, w1: torch.Tensor, b1: torch.Tensor,
                         w2: torch.Tensor, b2: torch.Tensor,
                         eps: float = 1e-5) -> torch.Tensor:
    """Plain PyTorch version; u and s are float32 as in the Pallas kernel."""
    return residual_block_fwd_plain(x, w1, b1, w2, b2, eps)[0]


def residual_block_fwd_plain(x: torch.Tensor, w1: torch.Tensor, b1: torch.Tensor,
                             w2: torch.Tensor, b2: torch.Tensor,
                             eps: float = 1e-5) -> tuple[torch.Tensor, Residuals]:
    """:func:`residual_block_plain` with the residuals its backward starts
    from: ``(y, Residuals)``."""
    u = _conv3x3_plain(x, w1, b1)
    a = _in.instance_norm_act_plain(u, None, eps, "relu", out_dtype=x.dtype)
    s = _conv3x3_plain(a, w2, b2)
    y = _in.instance_norm_act_plain(s, x, eps, "none", out_dtype=x.dtype)
    return y, Residuals(u, a, s, *_in.instance_norm_stats_plain(u, eps),
                        *_in.instance_norm_stats_plain(s, eps))


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


def bwd_dx_saved_plain(x, dy, w1, w2, r: Residuals):
    """Plain version of :func:`bwd_dx_saved_cuda`: ds, du and dx = dy +
    dgrad(du, w1) in x's type from the residuals ``r``. Returns ``(dx, ds,
    du)``."""
    ds = _in.instance_norm_act_bwd_plain(r.s, dy, r.mean2, r.rstd2, "none")
    da = conv3x3_reflect_dgrad_plain(ds, w2)
    du = _in.instance_norm_act_bwd_plain(r.u, da, r.mean1, r.rstd1, "relu")
    return (dy.float() + conv3x3_reflect_dgrad_plain(du, w1)).to(x.dtype), ds, du


def bwd_dw_plain(x, a, ds, du):
    """Plain version of :func:`bwd_dw_cuda`: float32 ``(dw1, dw2)``."""
    return conv3x3_reflect_wgrad_plain(x, du), conv3x3_reflect_wgrad_plain(a, ds)


def residual_block_bwd_saved_plain(x: torch.Tensor, dy: torch.Tensor, w1: torch.Tensor,
                                   w2: torch.Tensor, r: Residuals
                                   ) -> tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """Plain PyTorch VJP from the forward's residuals ``r``: ``(dx (x's
    type), dw1, dw2 (float32))``, the chain of the module docstring."""
    dx, ds, du = bwd_dx_saved_plain(x, dy, w1, w2, r)
    return (dx, *bwd_dw_plain(x, r.a, ds, du))


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


def _check_g_parts(name: str, g_parts: torch.Tensor, shape: tuple[int, ...],
                   parts: int) -> None:
    """``g_parts`` must be the ``parts`` bf16 parts of a float32 cotangent
    of ``shape`` (N, H, W, Cout): ``(parts, *shape)`` bf16, as the norm VJP
    writes them (``instance_norm.launch_bwd`` into a parts buffer) or
    ``conv_dw.bf16_parts`` splits them."""
    if tuple(g_parts.shape) != (parts, *shape) or g_parts.dtype != torch.bfloat16:
        raise ValueError(f"{name}: g_parts {tuple(g_parts.shape)} {g_parts.dtype} are not "
                         f"the {parts} bf16 parts of a float32 cotangent {tuple(shape)}")


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


def conv3x3_reflect_dgrad(g_parts: torch.Tensor, w: torch.Tensor, out: torch.Tensor,
                          add: torch.Tensor | None = None) -> None:
    """CUDA kernel: ``out`` (N, H, W, Cin; float32 or bf16) = the input
    gradient of conv3x3(rpad1(.), w) for a float32 output gradient (N, H,
    W, Cout) given as its bf16 parts ``g_parts`` (``CD.parts(float32,
    w.dtype)`` of them, :func:`_check_g_parts`), reflect fold included, plus
    ``add`` (out's type). The tensor cores multiply them with the parts of
    ``w`` on the tile of :func:`dgrad_plan` (a float32 weight's three parts
    on :data:`DGRAD_SYNC`), counted in :data:`dgrad_tiles`."""
    if g_parts.dim() != 5:
        raise ValueError(f"conv3x3_reflect_dgrad: g_parts {tuple(g_parts.shape)} are not "
                         f"the bf16 parts of an (N, H, W, Cout) cotangent")
    _, n, h, w_, cout = g_parts.shape
    cin = w.shape[2]
    plan = dgrad_plan(n, h, w_, cin, cout)  # the shape checks
    ng, nw = CD.parts(torch.float32, w.dtype), CD.parts(w.dtype, torch.float32)
    _check_g_parts("conv3x3_reflect_dgrad", g_parts, (n, h, w_, cout), ng)
    if w.shape != (3, 3, cin, cout) or out.shape != (n, h, w_, cin):
        raise ValueError(f"conv3x3_reflect_dgrad: w {tuple(w.shape)} / out "
                         f"{tuple(out.shape)} do not fit g_parts {tuple(g_parts.shape)}")
    if add is not None and (add.shape != out.shape or add.dtype != out.dtype):
        raise ValueError("conv3x3_reflect_dgrad: add must match out")
    _build.check_same_device("conv3x3_reflect_dgrad", g_parts, w, out,
                             *([add] if add is not None else []))
    if (ng, nw) != (2, 1):
        plan = DGRAD_SYNC
    wp = w if nw == 1 else CD.bf16_parts(w.reshape(1, 9, cin, cout), nw)
    stream = _build.stream_ptr(g_parts)
    dpad = _build.scratch_ptr(4 * n * (h + 2) * (w_ + 2) * cin, g_parts, stream)
    _build.call("resblock", "cg_conv3x3_reflect_dgrad",
                g_parts.data_ptr(), wp.data_ptr(), None if add is None else add.data_ptr(),
                out.data_ptr(), dpad, n, h, w_, cin, cout, ng, nw, *plan,
                _build.DTYPE_CODES[out.dtype], stream)
    dgrad_tiles[plan] += 1


def conv3x3_reflect_wgrad(inp: torch.Tensor, g_parts: torch.Tensor,
                          out_dtype: torch.dtype = torch.float32) -> torch.Tensor:
    """CUDA kernel: the weight gradient (3, 3, Cin, Cout) of ``out_dtype``
    of conv3x3(rpad1(inp), w) for a float32 output gradient given as its
    bf16 parts ``g_parts`` (``CD.parts(float32, inp.dtype)`` of them),
    summed over the batch: the VALID weight gradient of ``kernels.conv_dw``
    on the unpadded ``inp``, which the kernel reads through reflect
    indexing (split-K partials added in a fixed order). A bf16 ``inp`` is
    read as it is; a float32 one is split into its three bf16 parts
    first."""
    n, h, w_, cin = inp.shape
    cout = g_parts.shape[-1]
    _check_grad_shapes("conv3x3_reflect_wgrad", h, w_, cin, cout)
    ng, na = CD.parts(torch.float32, inp.dtype), CD.parts(inp.dtype, torch.float32)
    _check_g_parts("conv3x3_reflect_wgrad", g_parts, (n, h, w_, cout), ng)
    _build.check_same_device("conv3x3_reflect_wgrad", inp, g_parts)
    return CD.launch_wgrad(inp if na == 1 else CD.bf16_parts(inp, na), na, g_parts, ng,
                           (n, h, w_, cin, cout), 3, out_dtype)


def forward_residuals_cuda(x, w1, b1, w2, b2, eps, keep=True):
    """TPU kernel #3 (``_forward_pallas``) on the card, at a width the
    convolutions take: two convolutions, each followed by its norm.
    Returns ``(y, Residuals)``, the residuals with ``keep`` (else None, and
    s overwrites u, which is dead once a exists)."""
    u = torch.empty(x.shape, dtype=torch.float32, device=x.device)
    conv3x3_reflect(x, w1, b1, u)
    a = torch.empty_like(x, memory_format=torch.contiguous_format)
    mean1, rstd1 = _in.launch(u, None, a, eps, "relu")
    s = torch.empty_like(u) if keep else u
    conv3x3_reflect(a, w2, b2, s)
    y = torch.empty_like(a)
    mean2, rstd2 = _in.launch(s, x, y, eps, "none")
    return y, Residuals(u, a, s, mean1, rstd1, mean2, rstd2) if keep else None


def _fwd_cuda(x, w1, b1, w2, b2, eps, keep):
    """The block forward on the card: ``(y, saved)``, ``saved`` = ``(x, w1,
    w2, *Residuals)`` at the width the convolutions ran (a narrow trunk's
    zero-filled copies), what :func:`_bwd_cuda` starts from, with ``keep``;
    else None."""
    c = x.shape[-1]
    if w1.shape[-1] != c:
        raise ValueError(f"residual block needs Cout == Cin == {c}, got {w1.shape[-1]}")
    cp = padded_channels(c)
    if cp != c:
        y, saved = _fwd_cuda(zero_fill(x, cp), zero_fill(w1, cp, 2), zero_fill(b1, cp),
                             zero_fill(w2, cp, 2), zero_fill(b2, cp), eps, keep)
        return y[..., :c].contiguous(), saved
    y, r = forward_residuals_cuda(x, w1, b1, w2, b2, eps, keep)
    return y, (x, w1, w2, *r) if keep else None


def bwd_dx_saved_cuda(x, dy, w1, w2, r: Residuals):
    """TPU kernel #4 (``_bwd_dx_kernel``) on the card from the forward's
    residuals ``r``: ds, du and dx = dy + dgrad(du, w1). Returns ``(dx, ds,
    du)``, ds and du as the bf16 parts the norm VJPs write them in (two for
    bf16 x, three for float32), which serve each cotangent's input and
    weight gradient (:func:`bwd_dw_cuda`): no float32 ds or du, and no
    split pass. Writes no residual: a second backward of the same graph
    reads them again."""
    parts = (CD.parts(torch.float32, x.dtype), *x.shape)
    ds = torch.empty(parts, dtype=torch.bfloat16, device=x.device)
    _in.launch_bwd(r.s, dy, r.mean2, r.rstd2, ds, "none")
    da = torch.empty(x.shape, dtype=torch.float32, device=x.device)
    conv3x3_reflect_dgrad(ds, w2, da)
    du = torch.empty_like(ds)
    _in.launch_bwd(r.u, da, r.mean1, r.rstd1, du, "relu")
    dx = torch.empty_like(r.a)
    conv3x3_reflect_dgrad(du, w1, dx, add=dy)
    return dx, ds, du


def bwd_dw_cuda(x, a, ds, du, w_dtype):
    """TPU kernel #5 (``_bwd_dw_kernel``) on the card: dw1 = wgrad(x, du)
    and dw2 = wgrad(a, ds), summed over the batch, in the weights' type;
    ds and du in the bf16 parts of :func:`bwd_dx_saved_cuda`, x and a read
    through reflect indexing."""
    return (conv3x3_reflect_wgrad(x, du, w_dtype), conv3x3_reflect_wgrad(a, ds, w_dtype))


def _bwd_cuda(dy, x, w1, w2, *res):
    """``(dx, dw1, dw2)`` from :func:`_fwd_cuda`'s ``saved``; a narrow
    trunk's dy is zero-filled to the saved width and the results cut back."""
    c, cp = dy.shape[-1], x.shape[-1]
    r = Residuals(*res)
    dx, ds, du = bwd_dx_saved_cuda(x, zero_fill(dy, cp) if cp != c else dy, w1, w2, r)
    dw1, dw2 = bwd_dw_cuda(x, r.a, ds, du, w1.dtype)
    if cp != c:
        return dx[..., :c].contiguous(), dw1[:, :, :c, :c], dw2[:, :, :c, :c]
    return dx, dw1, dw2


def _fwd_plain(x, w1, b1, w2, b2, eps, keep):
    y, r = residual_block_fwd_plain(x, w1, b1, w2, b2, eps)
    return y, (x, w1, w2, *r) if keep else None


def _bwd_plain(dy, x, w1, w2, *res):
    return residual_block_bwd_saved_plain(x, dy, w1, w2, Residuals(*res))


class ResidualBlockFused(torch.autograd.Function):
    """The differentiable seam; ``plain`` picks the plain versions. Only
    when a gradient is wanted, saves ``(x, w1, w2)`` and the
    :class:`Residuals`, which the backward starts from."""

    @staticmethod
    def forward(ctx, x, w1, b1, w2, b2, eps, plain):
        keep = any(ctx.needs_input_grad[:5])
        y, saved = (_fwd_plain if plain else _fwd_cuda)(x, w1, b1, w2, b2, eps, keep)
        if keep:
            ctx.save_for_backward(*saved)
            ctx.plain = plain
        return y

    @staticmethod
    def backward(ctx, dy):
        saved = ctx.saved_tensors
        dx, dw1, dw2 = (_bwd_plain if ctx.plain else _bwd_cuda)(dy.contiguous(), *saved)
        w_dtype = saved[1].dtype
        zeros = torch.zeros(dy.shape[-1], dtype=w_dtype, device=dy.device)
        return dx, dw1.to(w_dtype), zeros, dw2.to(w_dtype), zeros.clone(), None, None


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
