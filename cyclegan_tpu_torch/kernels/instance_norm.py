"""Fused instance norm + activation (+ residual add), forward and VJP.

The counterpart of ``cyclegan_tpu/kernels/instance_norm.py::instance_norm_act``.
Per (sample, channel) over the spatial axes of an NHWC tensor::

    y = act((x - mean) * rsqrt(var + eps)) [+ skip]

with float32 statistics, the biased variance and the result cast back to the
input type; ``act`` is ``none | relu | leaky`` (slope 0.2). The VJP, from the
forward's own statistics, is::

    dx = rstd * (g - mean_hw(g) - xhat * mean_hw(g * xhat)),  g = act'(xhat) * dy
    dskip = dy

with ``xhat = (x - mean) * rstd`` recomputed from x; dx has x's type.

:func:`instance_norm_act` is a ``torch.autograd.Function``. On a CUDA tensor
its forward and backward launch the hand-written kernels of
``csrc/instance_norm.cu`` or raise; on a CPU tensor they run the plain
PyTorch versions (:func:`instance_norm_act_plain`,
:func:`instance_norm_act_bwd_plain`) through the same Function.

:func:`instance_norm_act_slab` is the same function of a sample whose H
axis is split over the ranks of a spatial group (``parallel.spatial``):
each direction writes this slab's partials (forward: (count, mean, M2) per
(sample, channel); VJP: the sums of g and g * xhat) into its slot of an
(S, N, C, k) exchange buffer and zeros into the others, sums the buffer
over the group (one all-reduce: the gather), and merges the S slots in
rank order as it applies (:class:`InstanceNormActSlab`; the kernels' slab
entries, or :func:`slab_partials_plain`, :func:`slab_apply_plain`,
:func:`slab_bwd_partials_plain`, :func:`slab_bwd_apply_plain`).
"""

from __future__ import annotations

import functools
from typing import Callable, NamedTuple

import torch

from cyclegan_tpu_torch.kernels import _build

ACTS = {"none": 0, "relu": 1, "leaky": 2}
LEAKY_SLOPE = 0.2


def _act(z: torch.Tensor, act: str) -> torch.Tensor:
    if act == "relu":
        return torch.clamp_min(z, 0.0)
    if act == "leaky":
        return torch.where(z >= 0, z, z * LEAKY_SLOPE)
    return z


def _act_grad(z: torch.Tensor, act: str) -> torch.Tensor:
    """d act / dz at z (the JAX package's ``_act_grad_from_z``): relu takes
    z > 0, leaky z >= 0 -> 1 else 0.2."""
    if act == "relu":
        return (z > 0).to(z.dtype)
    if act == "leaky":
        return torch.where(z >= 0, 1.0, LEAKY_SLOPE).to(z.dtype)
    return torch.ones_like(z)


def instance_norm_stats_plain(x: torch.Tensor, eps: float = 1e-5
                              ) -> tuple[torch.Tensor, torch.Tensor]:
    """float32 ``(mean, rstd)``, each (N, C), of NHWC ``x`` over H*W."""
    x32 = x.float()
    mean = x32.mean(dim=(1, 2))
    var = torch.square(x32 - mean[:, None, None]).mean(dim=(1, 2))
    return mean, torch.rsqrt(var + eps)


def instance_norm_act_plain(x: torch.Tensor, skip: torch.Tensor | None = None,
                            eps: float = 1e-5, act: str = "none",
                            out_dtype: torch.dtype | None = None) -> torch.Tensor:
    """Plain PyTorch version: NHWC ``x`` -> NHWC of ``out_dtype`` (default
    ``x.dtype``); ``skip`` is added in float32 after the activation."""
    if act not in ACTS:
        raise ValueError(f"unknown act {act!r} (none|relu|leaky)")
    mean, rstd = instance_norm_stats_plain(x, eps)
    y = _act((x.float() - mean[:, None, None]) * rstd[:, None, None], act)
    if skip is not None:
        y = y + skip.float()
    return y.to(out_dtype or x.dtype)


def instance_norm_act_bwd_plain(x: torch.Tensor, dy: torch.Tensor, mean: torch.Tensor,
                                rstd: torch.Tensor, act: str = "none") -> torch.Tensor:
    """Plain PyTorch VJP: dx (x's type) from NHWC ``x`` and ``dy`` and the
    forward's float32 (N, C) ``mean`` and ``rstd``."""
    m, r = mean[:, None, None], rstd[:, None, None]
    xhat = (x.float() - m) * r
    g = dy.float() * _act_grad(xhat, act)
    g_mean = g.mean(dim=(1, 2), keepdim=True)
    gx_mean = (g * xhat).mean(dim=(1, 2), keepdim=True)
    return (r * (g - g_mean - xhat * gx_mean)).to(x.dtype)


# The tiling of csrc/instance_norm.cu: a block of IN_THREADS threads takes a
# tile of `rows` rows of H*W x (vec * lanes) channels; one sample should give
# the card at least IN_FILL tiles (a block for 97% of an H100's 132 SMs).
IN_THREADS = 256
IN_WARPS = IN_THREADS // 32
IN_FILL = 128
IN_ROWS_A_THREAD = (16, 8, 4, 2, 1)   # rows a thread takes in a tile, largest first


class InPlan(NamedTuple):
    """How csrc/instance_norm.cu tiles one sample's (H*W, C) plane."""
    rows: int       # rows of H*W a tile
    vec: int        # channels a thread reads in one access (16 bytes, or 1)
    lanes: int      # threads a row of a tile (a power of two, at most 32)
    groups: int     # channel groups of vec * lanes channels
    row_tiles: int  # tiles of rows

    @property
    def tiles(self) -> int:
        """Tiles a sample."""
        return self.groups * self.row_tiles


@functools.cache
def in_plan(hw: int, c: int, elt: int) -> InPlan:
    """The tiling of one (hw, c) sample plane of ``elt``-byte elements, from
    those alone (never the batch, never the grid): a sample's statistics are
    summed in the same order whatever batch it is in. A thread reads 16
    bytes of a row (``vec`` channels) where C allows it, else one channel;
    ``lanes`` threads cover a row's channel group (up to 32 accesses wide,
    rounded up to a power of two), IN_THREADS / lanes rows at a time; a tile
    takes the most rows a thread (16, 8, ... 1) that still gives the sample
    IN_FILL tiles, else one row a thread."""
    vec = 16 // elt if c % (16 // elt) == 0 else 1
    lanes = min(32, 1 << (c // vec - 1).bit_length())
    groups = -(-(c // vec) // lanes)
    for per_thread in IN_ROWS_A_THREAD:
        rows = IN_THREADS // lanes * per_thread
        if -(-hw // rows) * groups >= IN_FILL:
            break
    return InPlan(rows, vec, lanes, groups, -(-hw // rows))


def in_grid(n: int, c: int, plan: InPlan, coresident: int) -> int:
    """Blocks of the cooperative launch for a batch of ``n`` (the C side's
    grid_of): every block resident at once (``coresident``: blocks an SM x
    SMs, from the occupancy query), no more than the tiles or the (sample,
    channel) warps of the merge."""
    return min(coresident, max(n * plan.tiles, -(-n * c // IN_WARPS)))


def _check(name: str, vec: int, *tensors: torch.Tensor) -> None:
    """Contiguous, on one device, of a type the kernels take; 16-byte
    aligned where a thread reads ``vec`` > 1 channels in one access."""
    dev = tensors[0].device
    for t in tensors:
        if t.device != dev or not t.is_contiguous():
            raise ValueError(f"{name}: tensors must be contiguous NHWC on one device")
        if t.dtype not in _build.DTYPE_CODES:
            raise TypeError(f"{name}: unsupported dtype {t.dtype}")
        if vec > 1 and t.data_ptr() % 16:
            raise ValueError(f"{name}: tensors must be 16-byte aligned")


def launch(x: torch.Tensor, skip: torch.Tensor | None, out: torch.Tensor | None,
           eps: float, act: str) -> tuple[torch.Tensor, torch.Tensor]:
    """Run the CUDA forward, one launch: NHWC ``x`` (float32 or bf16) ->
    ``out`` (NHWC, float32 or bf16; ``skip`` has ``out``'s type). ``out=None``
    makes the statistics only. Returns the float32 (N, C) ``(mean, rstd)``,
    two views of one (2, N, C) tensor, the only allocation; the partials
    go to the stream's scratch."""
    n, h, w, c = x.shape
    hw = h * w
    plan = in_plan(hw, c, x.element_size())
    _check("instance_norm_act", plan.vec, x, *(t for t in (skip, out) if t is not None))
    if skip is not None and out is None:
        raise ValueError("instance_norm_act: skip needs an output")
    if out is not None and (out.shape != x.shape or (skip is not None and (
            skip.shape != x.shape or skip.dtype != out.dtype))):
        raise ValueError("instance_norm_act: skip/out must match x's shape "
                         "and out's dtype")
    stats = torch.empty((2, n, c), dtype=torch.float32, device=x.device)
    stream = _build.stream_ptr(x)
    part = _build.scratch_ptr(8 * n * c * plan.row_tiles, x, stream)
    out_dtype = (out if out is not None else x).dtype
    _build.call("instance_norm", "cg_instance_norm_act",
                x.data_ptr(), None if skip is None else skip.data_ptr(),
                None if out is None else out.data_ptr(), stats.data_ptr(), part,
                n, hw, c, plan.rows, plan.vec, plan.lanes, plan.tiles, float(eps), ACTS[act],
                _build.DTYPE_CODES[x.dtype], _build.DTYPE_CODES[out_dtype], stream)
    return stats[0], stats[1]


def dx_parts(x: torch.Tensor, dx: torch.Tensor) -> int:
    """How the VJP writes ``dx`` for ``x``: 0 in x's type (``dx`` of x's
    shape and type), or as the 2 or 3 bf16 parts of a float32 dx that the
    gradient convolutions multiply (``dx`` a ``(parts, *x.shape)`` bf16
    buffer; x float32 with C a multiple of 4, read 16 bytes a thread).
    Raises ValueError on any other ``dx``."""
    if dx.shape == x.shape and dx.dtype == x.dtype:
        return 0
    parts = dx.shape[0] if dx.dim() == x.dim() + 1 else 0
    if parts not in (2, 3) or dx.shape[1:] != x.shape or dx.dtype != torch.bfloat16 \
            or x.dtype != torch.float32 or x.shape[-1] % 4:
        raise ValueError(f"instance_norm_act_bwd: dx {tuple(dx.shape)} {dx.dtype} is neither "
                         f"x's shape and type nor the 2 or 3 bf16 parts of a float32 x "
                         f"{tuple(x.shape)} {x.dtype} with C % 4 == 0")
    return parts


def launch_bwd(x: torch.Tensor, dy: torch.Tensor, mean: torch.Tensor, rstd: torch.Tensor,
               dx: torch.Tensor, act: str) -> None:
    """Run the CUDA VJP, one launch: contiguous NHWC ``x`` and ``dy``
    (float32 or bf16 each), the forward's (N, C) float32 ``mean``/``rstd``
    -> ``dx``: x's type, or the bf16 parts of a float32 dx
    (:func:`dx_parts`), counted by form in ``_build.forms``. Allocates
    nothing; the partial sums go to the stream's scratch."""
    n, h, w, c = x.shape
    hw = h * w
    plan = in_plan(hw, c, x.element_size())
    _check("instance_norm_act_bwd", plan.vec, x, dy, dx)
    _check("instance_norm_act_bwd", 1, x, mean, rstd)
    if dy.shape != x.shape:
        raise ValueError("instance_norm_act_bwd: dy must match x's shape")
    parts = dx_parts(x, dx)
    if mean.shape != (n, c) or rstd.shape != (n, c) or mean.dtype != torch.float32 \
            or rstd.dtype != torch.float32:
        raise ValueError("instance_norm_act_bwd: mean/rstd must be (N, C) float32")
    stream = _build.stream_ptr(x)
    part = _build.scratch_ptr(8 * n * c * (plan.row_tiles + 1), x, stream)
    _build.call("instance_norm", "cg_instance_norm_act_bwd",
                x.data_ptr(), dy.data_ptr(), mean.data_ptr(), rstd.data_ptr(),
                dx.data_ptr(), part, n, hw, c, plan.rows, plan.vec, plan.lanes, plan.tiles,
                ACTS[act], _build.DTYPE_CODES[x.dtype], _build.DTYPE_CODES[dy.dtype], parts,
                stream)
    _build.forms["in_bwd", "parts" if parts else str(dx.dtype).split(".")[1]] += 1


def _fwd_cuda(x, skip, eps, act):
    out = torch.empty_like(x, memory_format=torch.contiguous_format)
    mean, rstd = launch(x, skip, out, eps, act)
    return out, mean, rstd


def _fwd_plain(x, skip, eps, act):
    mean, rstd = instance_norm_stats_plain(x, eps)
    return instance_norm_act_plain(x, skip, eps, act), mean, rstd


def _bwd_cuda(x, dy, mean, rstd, act):
    dx = torch.empty_like(x, memory_format=torch.contiguous_format)
    launch_bwd(x, dy, mean, rstd, dx, act)
    return dx


class InstanceNormAct(torch.autograd.Function):
    """The differentiable seam. ``plain`` picks the plain PyTorch versions
    (CPU tensors, and the reference path) over the CUDA kernels. The
    forward saves x and its statistics only when a gradient is wanted, so
    serving under ``inference_mode`` or ``no_grad`` keeps nothing."""

    @staticmethod
    def forward(ctx, x, skip, eps, act, plain):
        y, mean, rstd = (_fwd_plain if plain else _fwd_cuda)(x, skip, eps, act)
        if ctx.needs_input_grad[0] or ctx.needs_input_grad[1]:
            ctx.save_for_backward(x, mean, rstd)
            ctx.act, ctx.plain = act, plain
        return y

    @staticmethod
    def backward(ctx, dy):
        x, mean, rstd = ctx.saved_tensors
        dx = None
        if ctx.needs_input_grad[0]:
            # Cotangents often arrive non-contiguous (through the NCHW view
            # of the output); the kernels take contiguous NHWC only.
            dy_c = dy.contiguous()
            bwd = instance_norm_act_bwd_plain if ctx.plain else _bwd_cuda
            dx = bwd(x, dy_c, mean, rstd, ctx.act)
        dskip = dy if ctx.needs_input_grad[1] else None
        return dx, dskip, None, None, None


def _check_args(x: torch.Tensor, act: str) -> None:
    if act not in ACTS:
        raise ValueError(f"unknown act {act!r} (none|relu|leaky)")
    if x.dim() != 4:
        raise ValueError(f"instance_norm_act wants NHWC, got shape {tuple(x.shape)}")


def instance_norm_act(x: torch.Tensor, skip: torch.Tensor | None = None,
                      eps: float = 1e-5, act: str = "none") -> torch.Tensor:
    """Fused instance norm + activation (+ ``skip``) of an NHWC tensor,
    differentiable in ``x`` and ``skip``.

    CUDA tensors go through the hand-written kernels, forward and backward;
    CPU tensors through the plain versions. Any other device raises.
    """
    _check_args(x, act)
    if x.device.type not in ("cpu", "cuda"):
        raise ValueError(f"instance_norm_act: no kernel for device {x.device}")
    return InstanceNormAct.apply(x, skip, eps, act, x.device.type == "cpu")


def instance_norm_act_reference(x: torch.Tensor, skip: torch.Tensor | None = None,
                                eps: float = 1e-5, act: str = "none") -> torch.Tensor:
    """The same Function over the plain versions on any device: the kernel
    path's wiring with plain arithmetic, the yardstick the on-card checks
    compare the kernels with. The port's modules never call it."""
    _check_args(x, act)
    return InstanceNormAct.apply(x, skip, eps, act, True)


# ------------------------------------------------------- slabs (spatial axis)
def chan_merge_plain(parts: torch.Tensor) -> torch.Tensor:
    """(S, N, C, 3) float32 (count, mean, M2) of S slabs -> (N, C, 3) of the
    whole plane: Chan's pairwise merge in slab order, the kernels' formula
    (the weight nb / max(n, 1))."""
    n, m, m2 = (t.clone() for t in parts[0].unbind(-1))
    for nb, mb, m2b in (p.unbind(-1) for p in parts[1:]):
        tot = n + nb
        r = nb / tot.clamp_min(1.0)
        d = mb - m
        m = m + d * r
        m2 = m2 + m2b + d * d * (n * r)
        n = tot
    return torch.stack([n, m, m2], dim=-1)


def slab_partials_plain(x: torch.Tensor, buf: torch.Tensor, index: int) -> torch.Tensor:
    """The (count, mean, M2) of NHWC ``x`` over its H*W, float32 (N, C, 3),
    into slot ``index`` of the (S, N, C, 3) exchange buffer ``buf``, zeros
    into its other slots; returns ``buf``."""
    n, h, w, c = x.shape
    buf.zero_()
    if h * w:
        x32 = x.float()
        mean = x32.mean(dim=(1, 2))
        m2 = torch.square(x32 - mean[:, None, None]).sum(dim=(1, 2))
        buf[index] = torch.stack([torch.full_like(mean, float(h * w)), mean, m2], dim=-1)
    return buf


def slab_apply_plain(x: torch.Tensor, skip: torch.Tensor | None, slabs: torch.Tensor,
                     eps: float = 1e-5, act: str = "none"
                     ) -> tuple[torch.Tensor, torch.Tensor, torch.Tensor, torch.Tensor]:
    """``act(IN(x)) [+ skip]`` of this slab from the (S, N, C, 3) partials of
    the plane's S slabs: ``(y, mean, rstd, count)``, the statistics float32
    (N, C) and the plane's count a 1-element float32 tensor."""
    n, m, m2 = chan_merge_plain(slabs).unbind(-1)
    rstd = torch.rsqrt(m2 / n + eps)
    y = _act((x.float() - m[:, None, None]) * rstd[:, None, None], act)
    if skip is not None:
        y = y + skip.float()
    return y.to(x.dtype), m, rstd, n[:1, 0].clone()


def slab_bwd_partials_plain(x: torch.Tensor, dy: torch.Tensor, mean: torch.Tensor,
                            rstd: torch.Tensor, buf: torch.Tensor, index: int,
                            act: str = "none") -> torch.Tensor:
    """The (sum g, sum g * xhat) of this slab, g = act'(xhat) dy, float32
    (N, C, 2), into slot ``index`` of the (S, N, C, 2) exchange buffer
    ``buf``, zeros into its other slots; returns ``buf``."""
    xhat = (x.float() - mean[:, None, None]) * rstd[:, None, None]
    g = dy.float() * _act_grad(xhat, act)
    buf.zero_()
    buf[index] = torch.stack([g.sum(dim=(1, 2)), (g * xhat).sum(dim=(1, 2))], dim=-1)
    return buf


def slab_bwd_apply_plain(x: torch.Tensor, dy: torch.Tensor, mean: torch.Tensor,
                         rstd: torch.Tensor, slabs: torch.Tensor, count: torch.Tensor,
                         act: str = "none") -> torch.Tensor:
    """dx of this slab from the (S, N, C, 2) sums of the plane's S slabs,
    added in slab order, over the plane's ``count``."""
    a, b = slabs[0, ..., 0].clone(), slabs[0, ..., 1].clone()
    for p in slabs[1:]:
        a, b = a + p[..., 0], b + p[..., 1]
    m, r = mean[:, None, None], rstd[:, None, None]
    xhat = (x.float() - m) * r
    g = dy.float() * _act_grad(xhat, act)
    gm, gxm = (a / count)[:, None, None], (b / count)[:, None, None]
    return (r * (g - gm - xhat * gxm)).to(x.dtype)


def _slab_plan(x: torch.Tensor, *tensors: torch.Tensor) -> InPlan:
    n, h, w, c = x.shape
    plan = in_plan(h * w, c, x.element_size())
    _check("instance_norm_act_slab", plan.vec, x, *tensors)
    if any(t.dtype != x.dtype or t.shape != x.shape for t in tensors):
        raise ValueError("instance_norm_act_slab: skip/dy/out must be x's shape and type")
    return plan


def _check_slots(x: torch.Tensor, buf: torch.Tensor, k: int, index: int | None = None) -> None:
    """An (S, N, C, k) float32 exchange buffer on x's device (and a slot
    ``index`` of it)."""
    n, _, _, c = x.shape
    _check("instance_norm_act_slab", 1, x, buf)
    if buf.dtype != torch.float32 or buf.dim() != 4 or buf.shape[1:] != (n, c, k) \
            or (index is not None and not 0 <= index < buf.shape[0]):
        raise ValueError(f"instance_norm_act_slab: exchange buffer {tuple(buf.shape)} "
                         f"{buf.dtype}, slot {index}; want (S, {n}, {c}, {k}) float32")


def _slab_partials_cuda(x: torch.Tensor, buf: torch.Tensor, index: int) -> torch.Tensor:
    n, h, w, c = x.shape
    if h * w == 0:  # a rank that owns no row of the plane: its slot is zeros
        return slab_partials_plain(x, buf, index)
    plan = _slab_plan(x)
    _check_slots(x, buf, 3, index)
    stream = _build.stream_ptr(x)
    part = _build.scratch_ptr(8 * n * c * plan.row_tiles, x, stream)
    _build.call("instance_norm", "cg_instance_norm_partials", x.data_ptr(), buf.data_ptr(),
                buf.shape[0], index, part, n, h * w, c, plan.rows, plan.vec, plan.lanes,
                plan.tiles, _build.DTYPE_CODES[x.dtype], stream)
    return buf


def _slab_apply_cuda(x, skip, slabs, eps, act):
    n, h, w, c = x.shape
    if h * w == 0:
        return slab_apply_plain(x, skip, slabs, eps, act)
    plan = _slab_plan(x, *(() if skip is None else (skip,)))
    _check_slots(x, slabs, 3)
    # Two allocations: statistics carved from y's would keep all of y alive
    # for the backward whenever the next layer saves another tensor (the
    # spatial path's halo-padded convolution input).
    y = torch.empty_like(x, memory_format=torch.contiguous_format)
    stats = torch.empty(2 * n * c + 1, dtype=torch.float32, device=x.device)
    _build.call("instance_norm", "cg_instance_norm_slab_apply", x.data_ptr(),
                None if skip is None else skip.data_ptr(), y.data_ptr(), stats.data_ptr(),
                slabs.data_ptr(), slabs.shape[0], n, h * w, c, plan.rows, plan.vec,
                plan.lanes, plan.tiles, float(eps), ACTS[act], _build.DTYPE_CODES[x.dtype],
                _build.stream_ptr(x))
    return y, stats[:n * c].view(n, c), stats[n * c:2 * n * c].view(n, c), stats[2 * n * c:]


def _slab_bwd_partials_cuda(x, dy, mean, rstd, buf, index, act):
    n, h, w, c = x.shape
    if h * w == 0:
        return slab_bwd_partials_plain(x, dy, mean, rstd, buf, index, act)
    plan = _slab_plan(x, dy)
    _check_slots(x, buf, 2, index)
    stream = _build.stream_ptr(x)
    part = _build.scratch_ptr(8 * n * c * plan.row_tiles, x, stream)
    _build.call("instance_norm", "cg_instance_norm_bwd_partials", x.data_ptr(), dy.data_ptr(),
                mean.data_ptr(), rstd.data_ptr(), buf.data_ptr(), buf.shape[0], index, part,
                n, h * w, c, plan.rows, plan.vec, plan.lanes, plan.tiles, ACTS[act],
                _build.DTYPE_CODES[x.dtype], stream)
    return buf


def _slab_bwd_apply_cuda(x, dy, mean, rstd, slabs, count, act):
    n, h, w, c = x.shape
    if h * w == 0:
        return slab_bwd_apply_plain(x, dy, mean, rstd, slabs, count, act)
    plan = _slab_plan(x, dy)
    _check_slots(x, slabs, 2)
    _check("instance_norm_act_slab_bwd", 1, count)
    dx = torch.empty_like(x, memory_format=torch.contiguous_format)
    _build.call("instance_norm", "cg_instance_norm_bwd_slab_apply", x.data_ptr(),
                dy.data_ptr(), mean.data_ptr(), rstd.data_ptr(), dx.data_ptr(),
                slabs.data_ptr(), slabs.shape[0], count.data_ptr(), n, h * w, c,
                plan.rows, plan.vec, plan.lanes, plan.tiles, ACTS[act],
                _build.DTYPE_CODES[x.dtype], _build.stream_ptr(x))
    return dx


class SlabGroup(NamedTuple):
    """This slab's place among the ``size`` slabs of a plane: its slot
    ``index`` of the exchange buffer, and ``reduce``, which sums an (S, N,
    C, k) float32 buffer over the slabs' ranks in place (an all-reduce that
    every rank of the group makes, in the same order)."""
    size: int
    index: int
    reduce: Callable[[torch.Tensor], object]


class InstanceNormActSlab(torch.autograd.Function):
    """The seam of a slab: each direction's partials write their slot of an
    uninitialised (S, N, C, k) buffer (``group``, a :class:`SlabGroup`),
    ``group.reduce`` sums it over the group, and the apply merges the S
    slots; ``plain`` as in :class:`InstanceNormAct`."""

    @staticmethod
    def forward(ctx, x, skip, eps, act, plain, group):
        buf = x.new_empty((group.size, x.shape[0], x.shape[3], 3), dtype=torch.float32)
        (slab_partials_plain if plain else _slab_partials_cuda)(x, buf, group.index)
        group.reduce(buf)
        apply = slab_apply_plain if plain else _slab_apply_cuda
        y, mean, rstd, count = apply(x, skip, buf, eps, act)
        if ctx.needs_input_grad[0] or ctx.needs_input_grad[1]:
            ctx.save_for_backward(x, mean, rstd, count)
            ctx.act, ctx.plain, ctx.group = act, plain, group
        return y

    @staticmethod
    def backward(ctx, dy):
        x, mean, rstd, count = ctx.saved_tensors
        dx = None
        if ctx.needs_input_grad[0]:
            dy_c = dy.contiguous()
            group = ctx.group
            buf = x.new_empty((group.size, x.shape[0], x.shape[3], 2), dtype=torch.float32)
            partials = slab_bwd_partials_plain if ctx.plain else _slab_bwd_partials_cuda
            partials(x, dy_c, mean, rstd, buf, group.index, ctx.act)
            group.reduce(buf)
            apply = slab_bwd_apply_plain if ctx.plain else _slab_bwd_apply_cuda
            dx = apply(x, dy_c, mean, rstd, buf, count, ctx.act)
        dskip = dy if ctx.needs_input_grad[1] else None
        return dx, dskip, None, None, None, None


def instance_norm_act_slab(x: torch.Tensor, skip: torch.Tensor | None, eps: float,
                           act: str, group: SlabGroup) -> torch.Tensor:
    """:func:`instance_norm_act` of this rank's H slab of NHWC ``x`` with the
    statistics of the whole plane, whose S slabs' partials meet in the
    exchange buffer that ``group`` reduces (see :class:`InstanceNormActSlab`).
    CUDA tensors go through the kernels' slab entries, two launches a
    direction; CPU tensors through the plain versions."""
    _check_args(x, act)
    if x.device.type not in ("cpu", "cuda"):
        raise ValueError(f"instance_norm_act_slab: no kernel for device {x.device}")
    return InstanceNormActSlab.apply(x, skip, eps, act, x.device.type == "cpu", group)

