"""The data axis of the JAX package's mesh, on ``torch.distributed``.

Counterpart of ``cyclegan_tpu/parallel/mesh.py``. There, one jitted step
runs over a (data, spatial) mesh with the batch sharded on ``data`` and the
state replicated, and XLA inserts the collectives. Here every rank runs the
step on its rows of the global batch, and the port makes the same program
explicit, so that dp=k equals one device on the same global batch:

- gradients: each rank's loss terms are means over its rows whose mean over
  the ranks is the global loss; :func:`all_reduce_mean` averages the
  gradients (the ``psum`` XLA inserts), in buckets of flattened gradients;
- batch norm: the statistics are summed across ranks through
  :func:`all_reduce_sum_grad`, whose backward is the same sum
  (``ops.blocks.BatchNorm``);
- the replay pools: :func:`gather_rows` and :func:`local_rows` around a
  query of the global batch (``train/cyclegan.py``);
- evaluation: confusion matrices summed with :func:`all_reduce_sum`.

The spatial axis is not ported: its halo exchanges and cross-rank
instance-norm statistics are ROADMAP Queue 1 item 15, and ``spatial > 1``
raises. ``jit_step`` has no counterpart (an XLA-only compile step).
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
    """This rank's device and its place in the data group (``group`` None
    at world 1, where no collective runs)."""
    device: torch.device
    rank: int = 0
    world: int = 1
    group: Any = None


def make_mesh(num_devices: int | None = None, *, spatial: int = 1,
              device: str | torch.device = "cuda") -> Mesh:
    """The data mesh of this rank: ``num_devices`` (None = the group's
    world) must equal the ranks of the group. ``device`` is this rank's
    (``"cuda"`` without an index: ``cuda:<LOCAL_RANK>``)."""
    if spatial > 1:
        raise NotImplementedError(
            f"spatial_shards={spatial}: the spatial axis needs a halo exchange and "
            f"cross-rank instance-norm statistics around the port's whole-plane kernels "
            f"(ROADMAP Queue 1 item 15)")
    rank, world = distributed.process_info()
    if num_devices is not None and num_devices != world:
        raise ValueError(
            f"num_devices={num_devices} but the process group has {world} rank(s): launch "
            f"through `python -m cyclegan_tpu_torch.main --num_devices {num_devices}` or "
            f"torchrun (one rank a device)")
    return Mesh(distributed.local_device(device), rank, world,
                dist.group.WORLD if world > 1 else None)


def local_rows(x, mesh: Mesh, axis: int = 0):
    """This rank's contiguous rows of a global array along ``axis``."""
    if mesh.world == 1:
        return x
    n = x.shape[axis] // mesh.world
    if n * mesh.world != x.shape[axis]:
        raise ValueError(f"global batch {x.shape[axis]} does not divide over "
                         f"{mesh.world} ranks")
    index = [slice(None)] * x.ndim
    index[axis] = slice(mesh.rank * n, (mesh.rank + 1) * n)
    return x[tuple(index)]


def shard_batch(batch: dict, mesh: Mesh, *, leading_stack: bool = False) -> dict:
    """A global host batch (numpy or tensors) -> this rank's rows as
    tensors on its device: integer arrays as int64. ``leading_stack``: the
    arrays carry a leading steps-per-call axis and rows are axis 1. The
    pool decision keys (``pool_*``) hold one decision per global row and
    are handed over whole."""
    out = {}
    for k, v in batch.items():
        t = torch.as_tensor(np.ascontiguousarray(v) if isinstance(v, np.ndarray) else v)
        if not k.startswith(WHOLE_KEY_PREFIX):
            t = local_rows(t, mesh, axis=1 if leading_stack else 0)
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
    """Average ``tensors`` over the ranks in place, one all-reduce a bucket
    of flattened tensors; returns them. At world 1 nothing runs."""
    if mesh.world == 1:
        return tensors
    for idx in _buckets(tensors):
        flat = torch.cat([tensors[i].reshape(-1) for i in idx])
        dist.all_reduce(flat, group=mesh.group)
        flat.div_(mesh.world)
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
    """Per-rank scalar metrics -> their means over the ranks, in one
    all-reduce (the global batch's values where each rank's is a mean of
    equal share)."""
    if mesh.world == 1 or not metrics:
        return metrics
    keys = list(metrics)
    stacked = torch.stack([metrics[k].detach().float().reshape(()) for k in keys])
    stacked = all_reduce_sum(stacked, mesh) / mesh.world
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
def gather_rows(x: torch.Tensor, mesh: Mesh) -> torch.Tensor:
    """The global batch from each rank's rows (rank r's at rows [r*n,
    (r+1)*n)): an all-reduce of a zero-filled global buffer, exact, and
    available on gloo for CUDA tensors where ``all_gather`` is not."""
    if mesh.world == 1:
        return x
    n = x.shape[0]
    out = torch.zeros((n * mesh.world, *x.shape[1:]), dtype=x.dtype, device=x.device)
    out[mesh.rank * n:(mesh.rank + 1) * n] = x
    dist.all_reduce(out, group=mesh.group)
    return out


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
