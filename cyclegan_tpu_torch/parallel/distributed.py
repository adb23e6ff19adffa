"""Process groups for data parallelism (``torch.distributed``).

Counterpart of ``cyclegan_tpu/parallel/distributed.py``. The JAX package
runs one process per host and one SPMD program over every device of a
global mesh; the port runs one process per device (a *rank*), NCCL between
CUDA ranks and gloo between CPU ranks, and the trainers reduce what XLA's
sharded jit would (``parallel.mesh``).

- :func:`maybe_initialize` brings the group up from the config
  (``coordinator_address`` / ``num_processes`` / ``process_id``), from
  torchrun's ``RANK`` / ``WORLD_SIZE`` / ``MASTER_ADDR``, or from explicit
  arguments (the CLI's local launcher, the tests); a group already up is
  used as it is.
- :func:`launch_local` starts the ranks of one process as ``spawn``
  children and waits for them; a rank that fails takes the others down.
- :func:`process_info`, :func:`is_primary` and :func:`phase_barrier` read
  and align the group (world 1 without one).

Every group gets a timeout (``CYCLEGAN_TPU_DIST_TIMEOUT`` seconds, default
600), so a lost rank fails its peers' collectives instead of hanging them.
"""

from __future__ import annotations

import datetime
import multiprocessing
import multiprocessing.connection
import os
import signal
import threading
from typing import Any, Callable

import torch
import torch.distributed as dist

TIMEOUT_ENV = "CYCLEGAN_TPU_DIST_TIMEOUT"
TORCHRUN_ENV = ("RANK", "WORLD_SIZE", "MASTER_ADDR")


def timeout_s() -> float:
    return float(os.environ.get(TIMEOUT_ENV, "600"))


def distributed_launch_pending(cfg, environ) -> bool:
    """Will :func:`maybe_initialize` bring a group up from ``cfg`` or the
    environment (a coordinator address, or torchrun's variables: the
    counterpart of the JAX package's cluster auto-detection)?"""
    return bool(getattr(cfg, "coordinator_address", None)) \
        or all(k in environ for k in TORCHRUN_ENV)


def default_backend(device: str | torch.device) -> str:
    return "nccl" if torch.device(device).type == "cuda" else "gloo"


def maybe_initialize(cfg=None, device: str | torch.device = "cuda", *,
                     rank: int | None = None, world: int | None = None,
                     init_method: str | None = None, backend: str | None = None) -> bool:
    """Bring up the default process group; returns True when the run has
    more than one rank afterwards.

    Explicit ``rank``/``world``/``init_method`` win; else a coordinator in
    ``cfg`` (one rank a process: ``process_id`` of ``num_processes``, at
    ``tcp://<coordinator_address>``); else torchrun's environment
    (``env://``). With none of them, or a group already up, nothing is
    initialised. ``backend`` defaults to NCCL for a CUDA ``device`` and
    gloo for the CPU. A CUDA rank makes its device current first."""
    if dist.is_initialized():
        return dist.get_world_size() > 1
    env = os.environ
    if rank is None:
        if cfg is not None and getattr(cfg, "coordinator_address", None):
            rank, world = int(cfg.process_id or 0), int(cfg.num_processes or 1)
            init_method = f"tcp://{cfg.coordinator_address}"
        elif distributed_launch_pending(cfg, env):
            rank, world, init_method = int(env["RANK"]), int(env["WORLD_SIZE"]), "env://"
        else:
            return False
    dev = torch.device(device)
    if dev.type == "cuda":
        torch.cuda.set_device(local_device(dev))
    dist.init_process_group(backend or default_backend(dev), init_method=init_method,
                            rank=rank, world_size=world,
                            timeout=datetime.timedelta(seconds=timeout_s()))
    return world > 1


def local_device(device: str | torch.device) -> torch.device:
    """This rank's device: a CUDA device without an index becomes
    ``cuda:<LOCAL_RANK>`` (0 without the variable); others as given."""
    dev = torch.device(device)
    if dev.type == "cuda" and dev.index is None:
        return torch.device("cuda", int(os.environ.get("LOCAL_RANK", "0")))
    return dev


def process_info() -> tuple[int, int]:
    """(rank, world size): (0, 1) without a group."""
    if not dist.is_initialized():
        return 0, 1
    return dist.get_rank(), dist.get_world_size()


def is_primary() -> bool:
    """True on the rank that writes checkpoints, logs and sample dumps."""
    return process_info()[0] == 0


def phase_barrier(name: str = "") -> None:
    """Align every rank (``dist.barrier``; a no-op at world 1). ``name``
    says where, for a reader of a hang's traceback."""
    if process_info()[1] <= 1:
        return
    if dist.get_backend() == "nccl":
        dist.barrier(device_ids=[torch.cuda.current_device()])
    else:
        dist.barrier()


def _rank_main(fn: Callable, args: tuple, local_index: int, nprocs: int, rank: int,
               world: int, init_method: str, device: str, backend: str | None,
               result) -> None:
    os.environ["LOCAL_RANK"] = str(local_index)
    if torch.device(device).type == "cpu":  # the host's cores shared by its ranks
        threads = int(os.environ.get("OMP_NUM_THREADS", "0") or 0)
        torch.set_num_threads(threads or max(1, (os.cpu_count() or 1) // nprocs))
    maybe_initialize(None, device, rank=rank, world=world, init_method=init_method,
                     backend=backend)
    try:
        out = fn(*args)
        if rank == 0:
            result.send(out)
    finally:
        dist.destroy_process_group()


def launch_local(fn: Callable, args: tuple, *, nprocs: int, world: int, init_method: str,
                 first_rank: int = 0, device: str = "cuda", backend: str | None = None) -> Any:
    """Run ``fn(*args)`` in ``nprocs`` spawned ranks ``first_rank ..
    first_rank + nprocs - 1`` of a group of ``world`` at ``init_method``;
    return what rank 0 returned (None when rank 0 is not among them).

    The parent takes part in no collective: it watches the ranks, and when
    one exits with an error it terminates the rest and raises, so no rank
    is left waiting in a collective. A SIGTERM to the parent is passed on
    to the ranks (their preemption signal)."""
    ctx = multiprocessing.get_context("spawn")
    reader, writer = ctx.Pipe(duplex=False)
    procs = [ctx.Process(target=_rank_main,
                         args=(fn, args, i, nprocs, first_rank + i, world, init_method,
                               device, backend, writer), name=f"rank{first_rank + i}")
             for i in range(nprocs)]
    for p in procs:
        p.start()
    prev = None
    if threading.current_thread() is threading.main_thread():
        prev = signal.signal(signal.SIGTERM, lambda *_: [os.kill(p.pid, signal.SIGTERM)
                                                         for p in procs if p.is_alive()])
    out = None
    try:
        writer.close()
        alive, pending = list(procs), [reader]
        while alive:
            # Rank 0's result is read as soon as it is sent: a large one
            # would block its sender until then.
            ready = multiprocessing.connection.wait([*pending, *(p.sentinel for p in alive)])
            if reader in ready:
                try:
                    out = reader.recv()
                except EOFError:  # every writer closed: nothing more comes
                    pending = []
            for p in [p for p in alive if p.exitcode is not None]:
                alive.remove(p)
                if p.exitcode != 0:
                    raise RuntimeError(f"{p.name} of {world} exited with code {p.exitcode}")
    finally:
        reader.close()
        if prev is not None:
            signal.signal(signal.SIGTERM, prev)
        for p in procs:
            if p.is_alive():
                p.terminate()
        for p in procs:
            p.join(timeout=30)
            if p.is_alive():
                p.kill()
                p.join()
    return out
