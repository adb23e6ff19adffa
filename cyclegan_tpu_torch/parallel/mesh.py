"""The JAX package's (data, spatial) mesh, on ``torch.distributed``.

Counterpart of ``cyclegan_tpu/parallel/mesh.py``. There, one jitted step
runs over a (data, spatial) mesh with the batch sharded on ``data``, the
image's H axis on ``spatial`` and the state replicated, and XLA inserts the
collectives. Here every rank runs the step on its rows of the global batch
and its H slab of them, and the port makes the same program explicit, so
that dp x spatial equals one device on the same global batch. Rank r sits
at (data index r // s, spatial index r % s), data-major as JAX reshapes the
devices ``(n // spatial, spatial)``:

- gradients: each rank's loss terms are its share of the global loss (the
  ranks' sum over a spatial group is its data row's loss, their mean over
  the data axis the global one); :func:`all_reduce_mean` sums the
  gradients over the world and divides by the data ranks (the ``psum``
  XLA inserts), in buckets of flattened gradients;
- batch norm: the statistics are summed across every rank through
  :func:`all_reduce_sum_grad`, whose backward is the same sum
  (``ops.blocks.BatchNorm``);
- the convolutions' halo rows and the instance norm's statistics cross the
  spatial group (``parallel.spatial``, ``kernels.instance_norm``);
- the replay pools: :func:`gather_rows` and :func:`local_rows` around a
  query of the global batch, over the data group (``train/cyclegan.py``);
- evaluation: confusion matrices summed with :func:`all_reduce_sum`.

``jit_step`` has no counterpart (an XLA-only compile step).
"""

from __future__ import annotations

import dataclasses
from typing import Any, Callable, Sequence

import numpy as np
import torch
import torch.distributed as dist

from cyclegan_tpu_torch.parallel import distributed

BUCKET_BYTES = 25 << 20
# Batch keys that hold a decision per row of the GLOBAL batch: every rank
# takes them whole.
WHOLE_KEY_PREFIX = "pool_"


@dataclasses.dataclass(frozen=True)
class Mesh:
    """This rank's device and its place in the (data, spatial) mesh.
    ``group`` spans every rank (None at world 1, where no collective runs);
    ``spatial`` ranks split each image's H axis, and ``data_group`` (the
    ranks of this spatial index) and ``spatial_group`` (the ranks of this
    data index) are None where their axis has one rank."""
    device: torch.device
    rank: int = 0
    world: int = 1
    group: Any = None
    spatial: int = 1
    data_group: Any = None
    spatial_group: Any = None

    @property
    def dp(self) -> int:
        """Ranks of the data axis (the global batch's row shares)."""
        return self.world // self.spatial

    @property
    def data_index(self) -> int:
        return self.rank // self.spatial

    @property
    def spatial_index(self) -> int:
        return self.rank % self.spatial


def _axis_groups(world: int, spatial: int) -> tuple[Any, Any]:
    """(data group, spatial group) of this rank. ``dist.new_group`` is
    collective: every rank builds every group, in the same order."""
    rank = dist.get_rank()
    dp = world // spatial
    if spatial == 1:
        return dist.group.WORLD, None
    if dp == 1:
        return None, dist.group.WORLD
    data = spatial_g = None
    for p in range(spatial):
        g = dist.new_group([d * spatial + p for d in range(dp)])
        if rank % spatial == p:
            data = g
    for d in range(dp):
        g = dist.new_group([d * spatial + p for p in range(spatial)])
        if rank // spatial == d:
            spatial_g = g
    return data, spatial_g


def make_mesh(num_devices: int | None = None, *, spatial: int = 1,
              device: str | torch.device = "cuda") -> Mesh:
    """The (data, spatial) mesh of this rank: ``num_devices`` (None = the
    group's world) must equal the ranks of the group, and ``spatial`` must
    divide them (dp = world / spatial), as the JAX ``make_mesh`` requires.
    ``device`` is this rank's (``"cuda"`` without an index:
    ``cuda:<LOCAL_RANK>``)."""
    rank, world = distributed.process_info()
    if num_devices is not None and num_devices != world:
        raise ValueError(
            f"num_devices={num_devices} but the process group has {world} rank(s): launch "
            f"through `python -m cyclegan_tpu_torch.main --num_devices {num_devices}` or "
            f"torchrun (one rank a device)")
    if spatial < 1 or world % spatial:
        raise ValueError(f"{world} rank(s) not divisible by spatial={spatial}")
    if world == 1:
        return Mesh(distributed.local_device(device))
    data, spatial_g = _axis_groups(world, spatial)
    return Mesh(distributed.local_device(device), rank, world, dist.group.WORLD, spatial,
                data, spatial_g)


def local_rows(x, mesh: Mesh, axis: int = 0):
    """This rank's contiguous rows of a global array along ``axis``: its
    data index's share of the data axis."""
    if mesh.dp == 1:
        return x
    n = x.shape[axis] // mesh.dp
    if n * mesh.dp != x.shape[axis]:
        raise ValueError(f"global batch {x.shape[axis]} does not divide over "
                         f"{mesh.dp} ranks")
    index = [slice(None)] * x.ndim
    index[axis] = slice(mesh.data_index * n, (mesh.data_index + 1) * n)
    return x[tuple(index)]


def local_slab(x, mesh: Mesh, axis: int = 1):
    """This rank's H slab of a global array along ``axis`` (images
    (B, H, W, C) and labels (B, H, W): axis 1), equal slabs in spatial
    index order."""
    if mesh.spatial == 1:
        return x
    h = x.shape[axis]
    if h % mesh.spatial:
        raise ValueError(f"H {h} does not divide over spatial={mesh.spatial}")
    n = h // mesh.spatial
    index = [slice(None)] * x.ndim
    index[axis] = slice(mesh.spatial_index * n, (mesh.spatial_index + 1) * n)
    return x[tuple(index)]


def shard_batch(batch: dict, mesh: Mesh, *, leading_stack: bool = False) -> dict:
    """A global host batch (numpy or tensors) -> this rank's rows (and,
    under a spatial axis, its H slab of arrays of rank 3 or more) as
    tensors on its device: integer arrays as int64. ``leading_stack``: the
    arrays carry a leading steps-per-call axis and rows are axis 1. The
    pool decision keys (``pool_*``) hold one decision per global row and
    are handed over whole."""
    out = {}
    lead = 1 if leading_stack else 0
    for k, v in batch.items():
        t = torch.as_tensor(np.ascontiguousarray(v) if isinstance(v, np.ndarray) else v)
        if not k.startswith(WHOLE_KEY_PREFIX):
            t = local_rows(t, mesh, axis=lead)
            if t.ndim >= 3 + lead:
                t = local_slab(t, mesh, axis=lead + 1)
        if not t.is_floating_point() and t.dtype != torch.bool:
            t = t.long()
        out[k] = t.contiguous().to(mesh.device)
    return out


def _state_tensors(trainer, state) -> list[torch.Tensor]:
    """Every tensor of the run on the rank's device: the nets' parameters
    and buffers, the Adam moments and the pools' buffers."""
    out = [t for net in trainer.nets() for t in (*net.parameters(), *net.buffers())]
    opts = [v for v in vars(state).values() if isinstance(v, torch.optim.Optimizer)]
    for opt in opts:
        for st in opt.state.values():
            out += [v for v in st.values() if isinstance(v, torch.Tensor)]
    for v in vars(state).values():
        if hasattr(v, "buffer") and isinstance(v.buffer, torch.Tensor):
            out.append(v.buffer)
    return [t for t in out if t.device == trainer.device]


@torch.no_grad()
def replicate_state(trainer, state, mesh: Mesh):
    """Broadcast the run's tensors on the device from rank 0 (in place);
    the host scalars (step counts, pool counts, generator states) are equal
    on every rank already, made from the same seed or checkpoint."""
    if mesh.world > 1:
        for t in _state_tensors(trainer, state):
            dist.broadcast(t.data, src=0, group=mesh.group)
    return state


def _buckets(tensors: Sequence[torch.Tensor]) -> list[list[int]]:
    """Consecutive indices of ``tensors`` grouped by dtype and device, at
    most :data:`BUCKET_BYTES` a bucket (one tensor at least)."""
    out: list[list[int]] = []
    size, key = 0, None
    for i, t in enumerate(tensors):
        k = (t.dtype, t.device)
        nbytes = t.numel() * t.element_size()
        if not out or k != key or size + nbytes > BUCKET_BYTES:
            out.append([])
            size, key = 0, k
        out[-1].append(i)
        size += nbytes
    return out


@torch.no_grad()
def all_reduce_mean(tensors: Sequence[torch.Tensor], mesh: Mesh) -> Sequence[torch.Tensor]:
    """Sum ``tensors`` over the ranks and divide by the data ranks, in
    place (a mean over the data axis of sums over each spatial group, whose
    ranks hold partial gradients of one data row), one all-reduce a bucket
    of flattened tensors; returns them. At world 1 nothing runs."""
    if mesh.world == 1:
        return tensors
    for idx in _buckets(tensors):
        flat = torch.cat([tensors[i].reshape(-1) for i in idx])
        dist.all_reduce(flat, group=mesh.group)
        flat.div_(mesh.dp)
        off = 0
        for i in idx:
            n = tensors[i].numel()
            tensors[i].copy_(flat[off:off + n].view_as(tensors[i]))
            off += n
    return tensors


def all_reduce_sum(t: torch.Tensor, mesh: Mesh) -> torch.Tensor:
    """The sum of ``t`` over the ranks (a new tensor; ``t`` at world 1)."""
    if mesh.world == 1:
        return t
    t = t.detach().clone()
    dist.all_reduce(t, group=mesh.group)
    return t


def mean_metrics(metrics: dict, mesh: Mesh) -> dict:
    """Per-rank scalar metrics -> the global batch's, in one all-reduce:
    summed over the world and divided by the data ranks (each rank's value
    is its share of its data row's, whose mean over the data axis is the
    global value)."""
    if mesh.world == 1 or not metrics:
        return metrics
    keys = list(metrics)
    stacked = torch.stack([metrics[k].detach().float().reshape(()) for k in keys])
    stacked = all_reduce_sum(stacked, mesh) / mesh.dp
    return dict(zip(keys, stacked.unbind()))


class _AllReduceSum(torch.autograd.Function):
    """Sum over the ranks whose VJP is the sum of the cotangents (each
    rank's output feeds every rank's loss)."""

    @staticmethod
    def forward(ctx, x, group):
        ctx.group = group
        y = x.clone()
        dist.all_reduce(y, group=group)
        return y

    @staticmethod
    def backward(ctx, dy):
        dx = dy.clone()
        dist.all_reduce(dx, group=ctx.group)
        return dx, None


def all_reduce_sum_grad(x: torch.Tensor, mesh: Mesh) -> torch.Tensor:
    """Differentiable sum of ``x`` over the ranks."""
    if mesh.world == 1:
        return x
    return _AllReduceSum.apply(x, mesh.group)


@torch.no_grad()
def gather_slots(x: torch.Tensor, group: Any, index: int, size: int, axis: int = 0
                 ) -> torch.Tensor:
    """The ``size`` ranks' ``x`` of one shape, concatenated along ``axis``
    in ``index`` order: an all-reduce over ``group`` of a zero-filled
    buffer with a slot a rank, exact, and available on gloo for CUDA
    tensors where ``all_gather`` is not."""
    if size == 1:
        return x
    n = x.shape[axis]
    shape = list(x.shape)
    shape[axis] = n * size
    out = torch.zeros(shape, dtype=x.dtype, device=x.device)
    out.narrow(axis, index * n, n).copy_(x)
    dist.all_reduce(out, group=group)
    return out


def gather_rows(x: torch.Tensor, mesh: Mesh) -> torch.Tensor:
    """The global batch from each data rank's rows (data index d's at rows
    [d*n, (d+1)*n)), over the data group (the ranks of one H slab)."""
    return gather_slots(x, mesh.data_group if mesh.spatial > 1 else mesh.group,
                        mesh.data_index, mesh.dp)


def gather_slab(x: torch.Tensor, mesh: Mesh, axis: int = 1) -> torch.Tensor:
    """The whole H axis from each spatial rank's equal slab of it, over the
    spatial group (sample dumps, checkpoints of the pools)."""
    return gather_slots(x, mesh.spatial_group, mesh.spatial_index, mesh.spatial, axis)


def select_step(trainer, steps_per_call: int = 1, grad_accum: int = 1) -> Callable:
    """The trainer step for a (steps_per_call, grad_accum) setting: the
    plain ``train_step``, ``multi_step`` (K optimizer steps a call) or
    ``accum_step`` (ONE update from K microbatches). The stacked forms take
    leading-K batch stacks and exclude each other."""
    if steps_per_call > 1 and grad_accum > 1:
        raise ValueError(f"steps_per_call={steps_per_call} and grad_accum={grad_accum} are "
                         f"mutually exclusive (both consume the leading batch-stack axis)")
    if grad_accum > 1:
        return trainer.accum_step
    return trainer.train_step if steps_per_call <= 1 else trainer.multi_step
