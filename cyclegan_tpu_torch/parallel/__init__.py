"""Data and spatial parallelism (counterpart of ``cyclegan_tpu/parallel``).

The JAX package shards the batch (and, on its ``spatial`` axis, each
image's H) over a ``jax.sharding.Mesh`` and lets XLA insert the gradient
``psum``, the halo exchanges and the norms' reductions inside one jitted
step. The port runs one rank a device under ``torch.distributed`` (NCCL on
the card, gloo on the CPU) and makes the same global-batch program
explicit: gradients averaged, batch-norm statistics and pools global,
halo rows and instance-norm partials exchanged (``parallel.spatial``),
evaluation summed.
"""

from cyclegan_tpu_torch.parallel.distributed import (is_primary, launch_local,
                                                     maybe_initialize, phase_barrier,
                                                     process_info)
from cyclegan_tpu_torch.parallel.mesh import (Mesh, all_reduce_mean, make_mesh,
                                              replicate_state, select_step, shard_batch)

__all__ = [
    "Mesh",
    "all_reduce_mean",
    "is_primary",
    "launch_local",
    "make_mesh",
    "maybe_initialize",
    "phase_barrier",
    "process_info",
    "replicate_state",
    "select_step",
    "shard_batch",
]
