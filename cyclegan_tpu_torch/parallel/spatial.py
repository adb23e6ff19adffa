"""The spatial axis of the mesh: H slabs, their halo rows, and who owns what.

The JAX package has no counterpart of this module: under its ``spatial``
mesh axis XLA's SPMD partitioner inserts the convolutions' halo exchanges
itself. The port makes them explicit. Each of the S ranks of a spatial
group holds a slab of every activation's H axis: rank p owns the global
rows ``slab(H, S, p)`` (``ceil(H / S)`` rows a rank, the last ones fewer
or none), the same rule at every layer, so every rank knows every rank's
rows from a layer's global height alone:

- a convolution (k, stride, pad) computes the output rows its rank owns;
  they need input rows ``[a * stride - pad, (b - 1) * stride - pad + k)``,
  which :func:`conv_source_rows` lists as global rows of the input, -1 for
  a zero row, reflected indices at the global top and bottom edges;
- a transposed convolution likewise (:func:`deconv_source_rows`): the
  output rows a rank owns come from the input rows that reach them, and
  the transposed convolution of those rows is cropped to them;
- :class:`RowGather` moves the rows a rank needs from their owners: its
  own by indexing, the others through an all-reduce over the spatial group
  of a zero-filled buffer with a slot a rank (exact: each element is one
  rank's value plus zeros; gloo takes it for CUDA tensors, where it has no
  ``all_gather`` or send/recv). Its VJP sends the halo rows' cotangents
  back through the same buffer, and each owner adds them to its own.

The columns are padded locally. A rank that owns no row of a layer still
makes every collective of it, forward and backward.

Evaluations that move rows across the slabs (the windows of a tiled
canvas, a rescaled canvas) run on whole tensors on every rank alike:
:func:`on_canvas_slabs` gathers the canvas, :func:`whole_from_slabs` runs
a network on each rank's slab of a whole input of any height (the rows
follow the ceil rule at every layer, so no height needs to divide) and
gathers the output; every rank makes the same calls in the same order.
"""

from __future__ import annotations

import dataclasses
import functools
from typing import Any

import torch
import torch.distributed as dist
import torch.nn.functional as F

from cyclegan_tpu_torch.parallel.mesh import gather_slots


@dataclasses.dataclass(frozen=True)
class Spatial:
    """This rank's place in its spatial group: ``index`` of ``size``, and
    the group the collectives run over."""
    size: int
    index: int
    group: Any = None


def from_mesh(mesh) -> Spatial | None:
    """This rank's :class:`Spatial` of a ``parallel.mesh.Mesh``; None
    without a spatial axis (no mesh, or one spatial rank)."""
    if mesh is None or mesh.spatial == 1:
        return None
    return Spatial(mesh.spatial, mesh.spatial_index, mesh.spatial_group)


def slab(h: int, s: int, p: int) -> tuple[int, int]:
    """``[start, stop)``: the global rows of an H axis of ``h`` rows that
    rank ``p`` of ``s`` owns."""
    c = -(-h // s)
    return min(p * c, h), min((p + 1) * c, h)


def conv_out_rows(h: int, k: int, stride: int, pad: int) -> int:
    return (h + 2 * pad - k) // stride + 1


def deconv_out_rows(h: int, k: int, stride: int, pad: int, out_pad: int) -> int:
    return (h - 1) * stride - 2 * pad + k + out_pad


def _reflect(i: int, h: int) -> int:
    """``nn.ReflectionPad`` of a row index: -1 -> 1, h -> h - 2."""
    if i < 0:
        return -i
    if i >= h:
        return 2 * (h - 1) - i
    return i


@functools.cache
def conv_source_rows(h: int, k: int, stride: int, pad: int, mode: str, s: int,
                     p: int) -> tuple[int, ...]:
    """The rows of the (H-padded) input a convolution over an input of
    ``h`` rows needs for the output rows rank ``p`` owns: global input rows,
    -1 for zero rows (``mode`` ``zero``) or reflected rows (``reflect``)."""
    a, b = slab(conv_out_rows(h, k, stride, pad), s, p)
    if a == b:
        return ()
    out = []
    for i in range(a * stride - pad, (b - 1) * stride - pad + k):
        if 0 <= i < h:
            out.append(i)
        elif mode == "reflect":
            out.append(_reflect(i, h))
        else:
            out.append(-1)
    return tuple(out)


@functools.cache
def deconv_source_rows(h: int, k: int, stride: int, pad: int, out_pad: int, s: int,
                       p: int) -> tuple[tuple[int, ...], int, int]:
    """``(rows, first, count)`` of a transposed convolution over an input of
    ``h`` rows: the global input rows (-1: none, a zero row) that reach the
    output rows rank ``p`` owns, and where those rows start (``first``) in
    the transposed convolution of ``rows`` with no H padding, and how many
    there are."""
    a, b = slab(deconv_out_rows(h, k, stride, pad, out_pad), s, p)
    if a == b:
        return (), 0, 0
    # Output row o = i * stride - pad + kh takes input rows i with
    # 0 <= kh < k.
    i0 = -(-(a + pad - k + 1) // stride)
    i1 = (b - 1 + pad) // stride
    rows = tuple(i if 0 <= i < h else -1 for i in range(i0, i1 + 1))
    return rows, a - i0 * stride + pad, b - a


@dataclasses.dataclass(frozen=True)
class GatherPlan:
    """Where rank ``p``'s needed rows come from. Positions index the
    gathered rows, sources this rank's slab; the exchange buffer has ``s``
    slots of ``lmax`` rows, slot q holding the rows rank q needs from
    others."""
    rows: int                 # rows gathered
    local_pos: tuple          # positions filled from this rank's slab ...
    local_src: tuple          # ... from these of its rows
    remote_pos: tuple         # positions filled from the buffer ...
    recv: tuple               # ... from these buffer rows (this rank's slot)
    send_slot: tuple          # buffer rows this rank fills ...
    send_src: tuple           # ... from these of its rows
    lmax: int                 # rows a slot (0: no exchange)
    s: int

    @functools.cached_property
    def _index(self) -> dict:
        return {}

    def index(self, name: str, device: torch.device) -> torch.Tensor:
        key = (name, device)
        got = self._index.get(key)
        if got is None:
            got = self._index[key] = torch.tensor(getattr(self, name), dtype=torch.long,
                                                  device=device)
        return got


@functools.cache
def gather_plan(h: int, p: int, needs: tuple[tuple[int, ...], ...]) -> GatherPlan:
    """The plan of rank ``p`` of ``len(needs)`` for an axis of ``h`` rows,
    where rank q needs the global rows ``needs[q]`` (-1: a zero row)."""
    s = len(needs)
    owners = [slab(h, s, q) for q in range(s)]

    def remote(q):
        lo, hi = owners[q]
        return [r for r in needs[q] if r >= 0 and not lo <= r < hi]

    lo, hi = owners[p]
    local_pos, local_src, remote_pos = [], [], []
    for j, r in enumerate(needs[p]):
        if r < 0:
            continue
        if lo <= r < hi:
            local_pos.append(j)
            local_src.append(r - lo)
        else:
            remote_pos.append(j)
    slots = [remote(q) for q in range(s)]
    lmax = max(len(x) for x in slots)
    send_slot, send_src = [], []
    for q, rows in enumerate(slots):
        for j, r in enumerate(rows):
            if lo <= r < hi:
                send_slot.append(q * lmax + j)
                send_src.append(r - lo)
    recv = [p * lmax + j for j in range(len(slots[p]))]
    return GatherPlan(len(needs[p]), tuple(local_pos), tuple(local_src), tuple(remote_pos),
                      tuple(recv), tuple(send_slot), tuple(send_src), lmax, s)


def _rows(x: torch.Tensor, plan: GatherPlan, name: str) -> torch.Tensor:
    return x.index_select(1, plan.index(name, x.device))


class RowGather(torch.autograd.Function):
    """NCHW ``x``, this rank's slab -> NCHW of the rows ``plan`` gathers
    (zero where a row is -1); the VJP adds each gathered row's cotangent
    into its owner's row. Works in NHWC (the channels_last memory of the
    activations); collectives over ``group`` only where ``plan.lmax``."""

    @staticmethod
    def forward(ctx, x, plan: GatherPlan, group):
        ctx.plan, ctx.group = plan, group
        xh = x.permute(0, 2, 3, 1)
        n, _, w, c = xh.shape
        out = xh.new_zeros((n, plan.rows, w, c))
        if plan.local_pos:
            out.index_copy_(1, plan.index("local_pos", x.device), _rows(xh, plan, "local_src"))
        if plan.lmax:
            buf = xh.new_zeros((n, plan.s * plan.lmax, w, c))
            if plan.send_slot:
                buf.index_copy_(1, plan.index("send_slot", x.device),
                                _rows(xh, plan, "send_src"))
            dist.all_reduce(buf, group=group)
            if plan.remote_pos:
                out.index_copy_(1, plan.index("remote_pos", x.device), _rows(buf, plan, "recv"))
        ctx.h = xh.shape[1]
        return out.permute(0, 3, 1, 2)

    @staticmethod
    def backward(ctx, dy):
        plan = ctx.plan
        dyh = dy.permute(0, 2, 3, 1)
        n, _, w, c = dyh.shape
        dx = dyh.new_zeros((n, ctx.h, w, c))
        if plan.local_pos:
            dx.index_add_(1, plan.index("local_src", dy.device), _rows(dyh, plan, "local_pos"))
        if plan.lmax:
            buf = dyh.new_zeros((n, plan.s * plan.lmax, w, c))
            if plan.remote_pos:
                buf.index_copy_(1, plan.index("recv", dy.device), _rows(dyh, plan, "remote_pos"))
            dist.all_reduce(buf, group=ctx.group)
            if plan.send_slot:
                dx.index_add_(1, plan.index("send_src", dy.device), _rows(buf, plan, "send_slot"))
        return dx.permute(0, 3, 1, 2), None, None


def fetch_rows(x: torch.Tensor, h: int, needs_of, sp: Spatial) -> torch.Tensor:
    """The rows ``needs_of(q)`` of an H axis of ``h`` rows for this rank
    (every rank's needs are known here, so every rank plans the same
    exchange)."""
    needs = tuple(needs_of(q) for q in range(sp.size))
    plan = gather_plan(h, sp.index, needs)
    return RowGather.apply(x, plan, sp.group)


def conv_input(x: torch.Tensor, h: int, k: int, stride: int, pad: int, mode: str,
               sp: Spatial) -> torch.Tensor:
    """This rank's slab of NCHW ``x`` (of a global H ``h``) -> the padded
    input of the rows of a (k, stride, pad) convolution's output it owns:
    H rows gathered with their halo and edge padding, W padded locally
    (``mode`` ``reflect`` or ``zero``). A VALID convolution of it gives the
    rank's output rows."""
    xp = fetch_rows(x, h, lambda q: conv_source_rows(h, k, stride, pad, mode, sp.size, q),
                     sp)
    if pad:
        xp = F.pad(xp, (pad, pad, 0, 0), mode="reflect" if mode == "reflect" else "constant")
    return xp


def deconv_input(x: torch.Tensor, h: int, k: int, stride: int, pad: int, out_pad: int,
                 sp: Spatial) -> tuple[torch.Tensor, int, int]:
    """``(rows, first, count)``: the input rows a transposed convolution
    needs for this rank's output rows (:func:`deconv_source_rows`), and
    which rows of its unpadded-in-H output to keep."""
    _, first, count = deconv_source_rows(h, k, stride, pad, out_pad, sp.size, sp.index)
    rows = fetch_rows(
        x, h, lambda q: deconv_source_rows(h, k, stride, pad, out_pad, sp.size, q)[0], sp)
    return rows, first, count


def gather_slabs(y: torch.Tensor, h: int, sp: Spatial, axis: int = 1) -> torch.Tensor:
    """The whole axis of ``h`` rows from every rank's slab ``y`` of it
    (:func:`slab` rows: full slots of ``ceil(h / s)`` rows but for the last
    ranks, fewer or none): each slab zero-filled to a slot and the slots
    gathered in rank order (``mesh.gather_slots``), the padding at the end."""
    c = -(-h // sp.size)
    lo, hi = slab(h, sp.size, sp.index)
    if y.shape[axis] != hi - lo:
        raise ValueError(f"a slab of {y.shape[axis]} rows is not rank {sp.index}'s "
                         f"{hi - lo} of {h}")
    pad = [0, 0] * (y.ndim - 1 - axis) + [0, c - (hi - lo)]
    return gather_slots(F.pad(y, pad), sp.group, sp.index, sp.size, axis).narrow(axis, 0, h)


def whole_from_slabs(slab_fn, sp: Spatial):
    """``slab_fn(x_slab, rows)``, a network that maps this rank's slab of a
    global NHWC input of ``rows`` rows to its slab of the output (of the
    same height), as a function of the whole input: each rank runs its
    slab and the output's slabs are gathered, so every rank returns the
    whole output."""

    def fn(x: torch.Tensor) -> torch.Tensor:
        h = x.shape[1]
        lo, hi = slab(h, sp.size, sp.index)
        return gather_slabs(slab_fn(x[:, lo:hi].contiguous(), h), h, sp)

    return fn


def on_canvas_slabs(canvas_fn, sp: Spatial):
    """``canvas_fn`` (whole NHWC canvas -> whole NHWC output of its height)
    on this rank's slab of the canvas: the canvas is gathered over the
    spatial group, every rank runs ``canvas_fn`` on it (the same calls in
    the same order), and each keeps its rows of the output."""

    def fn(x: torch.Tensor) -> torch.Tensor:
        h = x.shape[1] * sp.size  # the loaders' equal slabs
        lo, hi = slab(h, sp.size, sp.index)
        return canvas_fn(gather_slabs(x, h, sp))[:, lo:hi]

    return fn
