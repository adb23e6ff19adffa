"""Row-chunked ResidualBlock, forward and VJP from saved residuals.

The counterpart of ``cyclegan_tpu/kernels/resblock_chunked.py``: the same
block as :mod:`cyclegan_tpu_torch.kernels.resblock`,
``y = x + IN(conv3x3(rpad(relu(IN(conv3x3(rpad(x)) + b1)))) + b2)`` on NHWC
``x`` with HWIO weights, with the chunked route's numerics:

- the statistics are float32 sum and sum of squares of the convolution
  outputs before any rounding, taken per row chunk of ``hc`` rows and added
  in chunk order; ``var = E[v^2] - E[v]^2``;
- u and s are rounded to x's type before they are normalised, and s is
  stored in x's type; ``vhat = IN(u)`` is stored in x's type and
  ``a = relu(vhat)`` feeds the second convolution;
- the forward returns ``y`` and the residuals ``vhat``, ``s`` and
  ``stats`` (N, 4, C) float32 = ``[mu1, r1, mu2, r2]``.

The VJP reads ``(x, vhat, s, stats, w1, w2)`` and runs no forward
convolution again::

    shat = (s - mu2) r2     ds = r2 (dy - E[dy] - shat E[dy shat])
    da = dgrad(ds, w2)      dv = da (vhat > 0), stored in x's type
    du = r1 (dv - E[dv] - vhat E[dv vhat])       (E[.] from the float32 dv)
    dx = dy + dgrad(du, w1)
    dw2 = wgrad(relu(vhat), ds)                  dw1 = wgrad(x, du)

with float32 cotangents; dw is summed over chunks and batch in float32 and
cast to the weights' type; the bias gradients are exactly zero.

:func:`residual_block_chunked` is a ``torch.autograd.Function``. On a CUDA
tensor it launches the convolutions of ``csrc/resblock.cu`` and the
normalisation kernels of ``csrc/resblock_chunked.cu`` (TPU kernels #6 and
#7) with the tensor-core gradient convolutions of ``csrc/resblock.cu`` and
``csrc/conv_dw.cu`` (each float32 cotangent split into bf16 parts once for
its input and weight gradient), or raises; on a CPU tensor it runs the
plain versions through the same Function. ``H % hc != 0`` raises: the chunk
is the statistics kernels' row tile.

Each normalisation (:func:`in_fwd` twice a forward, :func:`in_vjp` twice a
VJP) is one launch: a thread-block cluster per (sample, 32 channels) whose
CTAs take the sample's row chunks in order (:func:`chunk_plan`), form the
chunks' partial sums, add the cluster's partials in chunk order through
distributed shared memory and apply the normalisation to the tiles they
hold. Nothing but the block's outputs and the planes a convolution reads
is allocated; the statistics depend on the shapes and ``hc`` only, never
on the batch.
"""

from __future__ import annotations

import functools
from typing import NamedTuple

import torch

from cyclegan_tpu_torch.kernels import _build
from cyclegan_tpu_torch.kernels import conv_dw as CD
from cyclegan_tpu_torch.kernels import resblock as RB


def _check_hc(h: int, hc: int) -> None:
    if hc <= 0 or h % hc:
        raise ValueError(f"residual_block_chunked needs H % hc == 0, got H={h}, hc={hc}")


def _chunk_means(v: torch.Tensor, hc: int) -> torch.Tensor:
    """Per-channel float32 mean of NHWC ``v`` over H*W: sums per row chunk
    of ``hc`` rows, added in chunk order. Returns (N, C)."""
    n, h, w, c = v.shape
    part = v.float().reshape(n, h // hc, hc * w, c).sum(2)
    total = part[:, 0].clone()
    for k in range(1, h // hc):
        total += part[:, k]
    return total / (h * w)


def _stats_plain(v: torch.Tensor, hc: int, eps: float) -> tuple[torch.Tensor, torch.Tensor]:
    mean = _chunk_means(v, hc)
    var = _chunk_means(v * v, hc) - mean * mean
    return mean, torch.rsqrt(var + eps)


def _bc(t: torch.Tensor) -> torch.Tensor:
    """(N, C) -> (N, 1, 1, C), to broadcast over NHWC."""
    return t[:, None, None]


def residual_block_chunked_plain(x: torch.Tensor, w1: torch.Tensor, b1: torch.Tensor,
                                 w2: torch.Tensor, b2: torch.Tensor, eps: float = 1e-5,
                                 hc: int = 8):
    """Plain PyTorch forward: ``(y, vhat, s, stats)``, the roundings of the
    module docstring at the places the Pallas kernel makes them."""
    _check_hc(x.shape[1], hc)
    t = x.dtype
    u = RB._conv3x3_plain(x, w1, b1)
    mu1, r1 = _stats_plain(u, hc, eps)
    vh = (u.to(t).float() - _bc(mu1)) * _bc(r1)
    a = vh.clamp_min(0).to(t)
    s32 = RB._conv3x3_plain(a, w2, b2)
    mu2, r2 = _stats_plain(s32, hc, eps)
    s = s32.to(t)
    y = ((s.float() - _bc(mu2)) * _bc(r2) + x.float()).to(t)
    return y, vh.to(t), s, torch.stack([mu1, r1, mu2, r2], 1)


def residual_block_chunked_bwd_plain(x: torch.Tensor, dy: torch.Tensor, vhat: torch.Tensor,
                                     s: torch.Tensor, stats: torch.Tensor, w1: torch.Tensor,
                                     w2: torch.Tensor, hc: int = 8):
    """Plain PyTorch VJP from the saved residuals: ``(dx (x's type), dw1,
    dw2 (float32))``, the chain of the module docstring step by step."""
    mu1, r1, mu2, r2 = (_bc(t) for t in stats.unbind(1))
    dyf = dy.float()
    shat = (s.float() - mu2) * r2
    ds = r2 * (dyf - _bc(_chunk_means(dyf, hc)) - shat * _bc(_chunk_means(dyf * shat, hc)))
    da = RB.conv3x3_reflect_dgrad_plain(ds, w2)
    vh = vhat.float()
    dv = da * (vh > 0)
    m_dv, m_dvv = _chunk_means(dv, hc), _chunk_means(dv * vh, hc)
    du = r1 * (dv.to(x.dtype).float() - _bc(m_dv) - vh * _bc(m_dvv))
    dx = (dyf + RB.conv3x3_reflect_dgrad_plain(du, w1)).to(x.dtype)
    a = vh.clamp_min(0).to(x.dtype)
    return dx, RB.conv3x3_reflect_wgrad_plain(x, du), RB.conv3x3_reflect_wgrad_plain(a, ds)


# The layout of csrc/resblock_chunked.cu: a thread-block cluster per (sample,
# CHUNK_GROUP channels), its CTAs taking the sample's row chunks in order; a
# CTA holds its chunks' input tiles in at most CHUNK_SMEM_MAX bytes of shared
# memory, with the partials. The launch's grid is (cluster, groups, N).
CHUNK_GROUP = 32
CHUNK_CLUSTER_MAX = 8   # the portable cluster size
CHUNK_SMEM_MAX = 200 * 1024


class ChunkPlan(NamedTuple):
    """How csrc/resblock_chunked.cu lays one call out on the card."""
    chunks: int     # K = H / hc row chunks a sample
    cluster: int    # CTAs a cluster, one cluster a (sample, channel group)
    per_cta: int    # chunks a CTA takes, in order (rank r: r * per_cta ..)
    groups: int     # channel groups of CHUNK_GROUP channels
    resident: bool  # the CTA's input tiles held in shared memory
    smem: int       # dynamic shared memory bytes a CTA


def in_bytes(which: int, vjp: bool, elt: int) -> int:
    """Bytes a pixel and channel of the inputs a call reads: u or s32
    (float32) and x for the forward; dy and s, or da (float32) and vhat, for
    the VJP; ``elt`` is x's element size."""
    if vjp:
        return 2 * elt if which == 2 else 4 + elt
    return 4 if which == 1 else 4 + elt


@functools.cache
def chunk_plan(h: int, w: int, c: int, hc: int, in_bytes_: int) -> ChunkPlan:
    """The layout of one call from the sample's shape, ``hc`` and the bytes a
    pixel-channel of its inputs (never the batch: a sample's statistics are
    summed in the same order in any batch). The cluster is the largest count
    up to CHUNK_CLUSTER_MAX that divides the chunks; each CTA keeps two
    float32 partials a channel for every chunk of the sample (its own and
    those the other CTAs write to it), and holds its chunks' tiles where
    they fit in CHUNK_SMEM_MAX."""
    _check_hc(h, hc)
    if c % CHUNK_GROUP:
        raise ValueError(f"chunked instance norm needs C % {CHUNK_GROUP} == 0, got {c}")
    k = h // hc
    cluster = max(d for d in range(1, CHUNK_CLUSTER_MAX + 1) if k % d == 0)
    per_cta = k // cluster
    part = k * 2 * CHUNK_GROUP * 4
    tiles = per_cta * hc * w * CHUNK_GROUP * in_bytes_
    resident = part + tiles <= CHUNK_SMEM_MAX
    return ChunkPlan(k, cluster, per_cta, c // CHUNK_GROUP, resident,
                     part + tiles if resident else part)


def _check(name: str, planes: list, same_type: list, f32: list, hc: int,
           stats: torch.Tensor) -> None:
    """Device, contiguity and alignment of every tensor; ``planes`` share
    one NHWC shape, ``same_type`` the first plane's dtype, ``f32`` are
    float32; the statistics fit the shape and ``hc`` does."""
    _build.check_same_device(name, *planes, stats)
    n, h, w_, c = planes[0].shape
    if any(p.shape != planes[0].shape for p in planes):
        raise ValueError(f"{name}: planes {[tuple(p.shape) for p in planes]} differ")
    if any(t.dtype != planes[0].dtype for t in same_type) or \
            any(t.dtype != torch.float32 for t in f32 + [stats]):
        raise TypeError(f"{name}: wrong dtypes")
    if h < 2 or w_ < 2:
        raise ValueError(f"reflect padding needs H, W >= 2, got {h}x{w_}")
    _check_hc(h, hc)
    if stats.shape != (n, 4, c):
        raise ValueError(f"{name}: statistics do not fit {tuple(planes[0].shape)}")


def in_fwd(v32: torch.Tensor, stats: torch.Tensor, x: torch.Tensor, out0: torch.Tensor,
           out1: torch.Tensor, hc: int, eps: float, which: int) -> None:
    """CUDA kernel, one launch: the forward instance norm after convolution
    ``which`` (1: stats slots 0-1, out0 = vhat, out1 = a; 2: slots 2-3, out0
    = s, out1 = y = IN(s) + x) from its float32 output ``v32``. Allocates
    nothing."""
    n, h, w_, c = x.shape
    _check("chunked_in_fwd", [x, v32, out0, out1], [out0, out1], [v32], hc, stats)
    plan = chunk_plan(h, w_, c, hc, in_bytes(which, False, x.element_size()))
    _build.call("resblock_chunked", "cg_chunked_in_fwd",
                v32.data_ptr(), stats.data_ptr(), x.data_ptr(), out0.data_ptr(),
                out1.data_ptr(), n, h, w_, c, hc, plan.cluster, plan.per_cta,
                int(plan.resident), float(eps), which, _build.DTYPE_CODES[x.dtype],
                _build.stream_ptr(x))


def in_vjp(g: torch.Tensor, src: torch.Tensor, stats: torch.Tensor, out: torch.Tensor,
           hc: int, which: int, dv: torch.Tensor | None = None,
           a: torch.Tensor | None = None) -> None:
    """CUDA kernel, one launch: the VJP of instance norm ``which`` from
    saved values (2: g = dy, src = s, out = ds; 1: g = da (float32), src =
    vhat, writes dv and a = relu(vhat) in src's type, out = du). ``out`` is
    float32. Allocates nothing."""
    n, h, w_, c = src.shape
    side = [dv, a] if which == 1 else []
    if which == 1 and (dv is None or a is None):
        raise ValueError("chunked_in_vjp: which=1 writes dv and a")
    _check("chunked_in_vjp", [src, g, out, *side], side + ([g] if which == 2 else []),
           [out] + ([g] if which == 1 else []), hc, stats)
    plan = chunk_plan(h, w_, c, hc, in_bytes(which, True, src.element_size()))
    _build.call("resblock_chunked", "cg_chunked_in_vjp",
                g.data_ptr(), src.data_ptr(), stats.data_ptr(),
                None if dv is None else dv.data_ptr(), None if a is None else a.data_ptr(),
                out.data_ptr(), n, h, w_, c, hc, plan.cluster, plan.per_cta,
                int(plan.resident), which, _build.DTYPE_CODES[src.dtype],
                _build.stream_ptr(src))


def _fwd_cuda(x, w1, b1, w2, b2, eps, hc):
    """TPU kernel #6 on the card: ``(y, vhat, s, stats)``; allocates the
    outputs and the convolutions' float32 output, nothing else."""
    n, h, w_, c = x.shape
    if w1.shape[-1] != c or w2.shape[-1] != c:
        raise ValueError(f"residual block needs Cout == Cin == {c}")
    cp = RB.padded_channels(c)
    if cp != c:
        outs = _fwd_cuda(RB.zero_fill(x, cp), RB.zero_fill(w1, cp, 2), RB.zero_fill(b1, cp),
                         RB.zero_fill(w2, cp, 2), RB.zero_fill(b2, cp), eps, hc)
        return tuple(t[..., :c].contiguous() for t in outs)
    f32 = dict(dtype=torch.float32, device=x.device)
    v32 = torch.empty(x.shape, **f32)
    stats = torch.empty((n, 4, c), **f32)
    vhat, a, s, y = (torch.empty_like(x, memory_format=torch.contiguous_format)
                     for _ in range(4))
    RB.conv3x3_reflect(x, w1, b1, v32)                 # u, float32
    in_fwd(v32, stats, x, vhat, a, hc, eps, 1)
    RB.conv3x3_reflect(a, w2, b2, v32)                 # s overwrites u
    in_fwd(v32, stats, x, s, y, hc, eps, 2)
    return y, vhat, s, stats


def _bwd_cuda(x, dy, vhat, s, stats, w1, w2, hc):
    """TPU kernel #7 on the card: ``(dx, dw1, dw2)``, dw in the weights'
    type; two normalisation VJPs, two input and two weight gradients. Of
    its own it allocates the outputs and what a convolution reads (ds, da,
    du, dv, a)."""
    n, h, w_, c = x.shape
    cp = RB.padded_channels(c)
    if cp != c:
        # Zero statistics make the padded channels' ds and du exactly 0.
        dx, dw1, dw2 = _bwd_cuda(*(RB.zero_fill(t, cp) for t in (x, dy, vhat, s, stats)),
                                 RB.zero_fill(w1, cp, 2), RB.zero_fill(w2, cp, 2), hc)
        return dx[..., :c].contiguous(), dw1[:, :, :c, :c], dw2[:, :, :c, :c]
    f32 = dict(dtype=torch.float32, device=x.device)
    ds, da, du = (torch.empty(x.shape, **f32) for _ in range(3))
    dv, a, dx = (torch.empty_like(x, memory_format=torch.contiguous_format) for _ in range(3))
    in_vjp(dy, s, stats, ds, hc, 2)
    parts = CD.parts(torch.float32, x.dtype)
    ds_parts = CD.bf16_parts(ds, parts)   # one split feeds both gradients of ds
    RB.conv3x3_reflect_dgrad(ds_parts, w2, da)
    in_vjp(da, vhat, stats, du, hc, 1, dv=dv, a=a)
    du_parts = CD.bf16_parts(du, parts)
    RB.conv3x3_reflect_dgrad(du_parts, w1, dx, add=dy)
    dw1 = RB.conv3x3_reflect_wgrad(x, du_parts, w1.dtype)
    dw2 = RB.conv3x3_reflect_wgrad(a, ds_parts, w2.dtype)
    return dx, dw1, dw2


class ResidualBlockChunked(torch.autograd.Function):
    """The differentiable seam; ``plain`` picks the plain versions. Saves
    ``(x, vhat, s, stats, w1, w2)`` only when a gradient is wanted."""

    @staticmethod
    def forward(ctx, x, w1, b1, w2, b2, eps, hc, plain):
        fwd = residual_block_chunked_plain if plain else _fwd_cuda
        y, vhat, s, stats = fwd(x, w1, b1, w2, b2, eps, hc)
        if any(ctx.needs_input_grad[:5]):
            ctx.save_for_backward(x, vhat, s, stats, w1, w2)
            ctx.hc, ctx.plain = hc, plain
        return y

    @staticmethod
    def backward(ctx, dy):
        x, vhat, s, stats, w1, w2 = ctx.saved_tensors
        bwd = residual_block_chunked_bwd_plain if ctx.plain else _bwd_cuda
        dx, dw1, dw2 = bwd(x, dy.to(x.dtype).contiguous(), vhat, s, stats, w1, w2, ctx.hc)
        zeros = torch.zeros(w1.shape[-1], dtype=w1.dtype, device=w1.device)
        return dx, dw1.to(w1.dtype), zeros, dw2.to(w2.dtype), zeros.clone(), None, None, None


def _check_args(x: torch.Tensor, hc: int, name: str) -> None:
    if x.dim() != 4:
        raise ValueError(f"{name} wants NHWC, got {tuple(x.shape)}")
    if x.device.type not in ("cpu", "cuda"):
        raise ValueError(f"{name}: no kernel for device {x.device}")
    _check_hc(x.shape[1], hc)


def residual_block_chunked(x: torch.Tensor, w1: torch.Tensor, b1: torch.Tensor,
                           w2: torch.Tensor, b2: torch.Tensor, eps: float = 1e-5,
                           hc: int = 8) -> torch.Tensor:
    """Chunked ResidualBlock, differentiable; x (N, H, W, C) with H % hc ==
    0, w (3, 3, C, C), b (C,), all of one dtype. CUDA tensors launch the
    kernels, forward and backward; CPU tensors run the plain versions.

    On the card a C that is no multiple of ``resblock.CHANNEL_MULTIPLE``
    costs copies: the inputs (and in the backward dy and the saved vhat, s
    and statistics) zero-filled up to ``resblock.padded_channels``, the
    outputs and gradients cut back to C. The main path's widths make none."""
    _check_args(x, hc, "residual_block_chunked")
    return ResidualBlockChunked.apply(x, w1, b1, w2, b2, eps, hc, x.device.type == "cpu")


def residual_block_chunked_fwd(x: torch.Tensor, w1: torch.Tensor, b1: torch.Tensor,
                               w2: torch.Tensor, b2: torch.Tensor, eps: float = 1e-5,
                               hc: int = 8):
    """The forward alone, as the JAX function returns it: ``(y, vhat,
    stats)`` (no gradient)."""
    _check_args(x, hc, "residual_block_chunked_fwd")
    fwd = residual_block_chunked_plain if x.device.type == "cpu" else _fwd_cuda
    with torch.no_grad():
        y, vhat, _, stats = fwd(x, w1, b1, w2, b2, eps, hc)
    return y, vhat, stats


def residual_block_chunked_reference(x: torch.Tensor, w1: torch.Tensor, b1: torch.Tensor,
                                     w2: torch.Tensor, b2: torch.Tensor, eps: float = 1e-5,
                                     hc: int = 8) -> torch.Tensor:
    """The same Function over the plain versions on any device (the on-card
    checks' yardstick; the port's modules never call it)."""
    _check_args(x, hc, "residual_block_chunked")
    return ResidualBlockChunked.apply(x, w1, b1, w2, b2, eps, hc, True)
