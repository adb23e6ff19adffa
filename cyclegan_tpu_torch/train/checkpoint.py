"""Checkpoints of a CycleGAN run (reference ``save_checkpoint`` /
``load_checkpoint``).

Counterpart of ``cyclegan_tpu/train/checkpoint.py`` (Orbax there,
``torch.save`` here). A checkpoint directory holds ``<step>.pt`` (the
payload) and ``<step>.json`` (its top-level keys and the optimizer step it
was taken at, read without loading the payload). Each file is written to a
temporary name and renamed, so a reader sees a whole file or none.

A state payload (:func:`state_payload`) holds everything a run carries:
the four nets' state dicts, both Adams and both LambdaLRs, both replay
pools (the filled rows, the count and the capacity), the states of the
pool-decision and dropout ``torch.Generator``s, and the step; every tensor
is a CPU copy. :func:`load_state` puts it back into a trainer and its state
on the trainer's device. Pools are restored at the STORED capacity and
type, so a resume or ``--testing`` works across ``pool_size`` and
precision changes; a stored empty pool (a ``pool_size`` 0 run) refuses a
run that wants one, as the JAX package does.
"""

from __future__ import annotations

import json
import os
import re

import torch

from cyclegan_tpu_torch.train.pool import PoolState

_STEP_FILE = re.compile(r"^(\d+)\.pt$")
NETS = ("G_i2l", "G_l2i", "D_img", "D_lab")


def _cpu(x):
    """CPU copies of every tensor in a nested dict/list (never views: a
    view would carry its whole storage into the file)."""
    if isinstance(x, torch.Tensor):
        return x.detach().to("cpu", copy=True)
    if isinstance(x, dict):
        return {k: _cpu(v) for k, v in x.items()}
    if isinstance(x, (list, tuple)):
        return type(x)(_cpu(v) for v in x)
    return x


def _pool_payload(pool: PoolState) -> dict:
    # Rows at and past `count` are never read before they are written.
    return {"buffer": _cpu(pool.buffer[:pool.count]), "count": pool.count,
            "size": pool.buffer.shape[0]}


def state_payload(trainer, state) -> dict:
    """Everything of ``(trainer, state)`` a resume needs, as CPU copies."""
    return {"nets": {n: _cpu(getattr(trainer, n).state_dict()) for n in NETS},
            "g_opt": _cpu(state.g_opt.state_dict()), "d_opt": _cpu(state.d_opt.state_dict()),
            "g_sched": state.g_sched.state_dict(), "d_sched": state.d_sched.state_dict(),
            "pool_img": _pool_payload(state.pool_img),
            "pool_lab": _pool_payload(state.pool_lab),
            "generator": state.generator.get_state(), "dropout": state.dropout.get_state(),
            "step": int(state.step)}


def _restore_pool(stored: dict, pool: PoolState, name: str, device) -> PoolState:
    if stored["size"] == 0:
        if pool.buffer.shape[0]:
            raise ValueError(f"checkpoint stored an EMPTY {name} (pool_size 0 run) but this "
                             f"run wants pool shape {tuple(pool.buffer.shape)}; resume with "
                             f"--pool_size 0")
        return pool
    rows = stored["buffer"]
    buffer = torch.zeros((stored["size"], *rows.shape[1:]), dtype=rows.dtype, device=device)
    buffer[:stored["count"]] = rows.to(device)
    return PoolState(buffer, int(stored["count"]))


def load_state(trainer, state, payload: dict):
    """Load a :func:`state_payload` into ``trainer`` and ``state`` (in
    place, every tensor on the trainer's device); returns ``state``."""
    for n in NETS:
        getattr(trainer, n).load_state_dict(payload["nets"][n])
    state.g_opt.load_state_dict(payload["g_opt"])
    state.d_opt.load_state_dict(payload["d_opt"])
    state.g_sched.load_state_dict(payload["g_sched"])
    state.d_sched.load_state_dict(payload["d_sched"])
    state.pool_img = _restore_pool(payload["pool_img"], state.pool_img, "pool_img",
                                   trainer.device)
    state.pool_lab = _restore_pool(payload["pool_lab"], state.pool_lab, "pool_lab",
                                   trainer.device)
    state.generator.set_state(payload["generator"])
    state.dropout.set_state(payload["dropout"])
    state.step = int(payload["step"])
    return state


class CheckpointManager:
    """Step-keyed checkpoints in one directory, the newest ``max_to_keep``
    kept. Saves are synchronous: ``async_save`` is accepted for the JAX
    package's signature and changes nothing, so :meth:`wait` and
    :meth:`close` have nothing to do."""

    def __init__(self, directory: str, *, max_to_keep: int = 2, async_save: bool = True):
        self._dir = os.path.abspath(directory)
        self.max_to_keep = max_to_keep

    def _path(self, step: int, ext: str) -> str:
        return os.path.join(self._dir, f"{step}.{ext}")

    def steps(self) -> list[int]:
        if not os.path.isdir(self._dir):
            return []
        return sorted(int(m.group(1)) for m in map(_STEP_FILE.match, os.listdir(self._dir))
                      if m)

    def save(self, step: int, payload: dict) -> None:
        """Write ``payload`` (a state payload, or a dict that holds one
        under ``state``) as checkpoint ``step``."""
        os.makedirs(self._dir, exist_ok=True)
        inner = payload.get("state", payload)
        meta = {"keys": sorted(payload), "step": inner.get("step")}
        for ext, write in (("pt", lambda f: torch.save(payload, f)),
                           ("json", lambda f: f.write(json.dumps(meta).encode()))):
            tmp = self._path(step, ext) + ".tmp"
            with open(tmp, "wb") as f:
                write(f)
            os.replace(tmp, self._path(step, ext))
        for old in self.steps()[:-self.max_to_keep]:
            for ext in ("pt", "json"):
                if os.path.exists(self._path(old, ext)):
                    os.remove(self._path(old, ext))

    def latest_epoch(self) -> int | None:
        steps = self.steps()
        return steps[-1] if steps else None

    def _meta(self, step: int) -> dict | None:
        try:
            with open(self._path(step, "json")) as f:
                return json.load(f)
        except FileNotFoundError:
            return None

    def stored_keys(self, step: int) -> frozenset | None:
        """Top-level keys of checkpoint ``step`` (format detection without
        loading it); None when its metadata does not exist."""
        meta = self._meta(step)
        return None if meta is None else frozenset(meta["keys"])

    def stored_step(self, step: int) -> int | None:
        """The optimizer step checkpoint ``step`` was taken at, if recorded."""
        meta = self._meta(step)
        return None if meta is None else meta.get("step")

    def restore(self, trainer=None, state=None, *, epoch: int | None = None):
        """``(payload, epoch + 1)`` of checkpoint ``epoch`` (default the
        newest), or None if there is none. Given ``trainer`` and ``state``,
        the payload is loaded into them (:func:`load_state`) and the state
        takes its place (under ``state`` for a dict that holds one).
        Errors of reading the file propagate as themselves."""
        step = self.latest_epoch() if epoch is None else epoch
        if step is None:
            return None
        payload = torch.load(self._path(step, "pt"), map_location="cpu", weights_only=True)
        if trainer is not None:
            if "state" in payload:
                payload["state"] = load_state(trainer, state, payload["state"])
            else:
                payload = load_state(trainer, state, payload)
        return payload, step + 1

    def wait(self) -> None:
        """Saves are synchronous: nothing is pending."""

    def close(self) -> None:
        """Nothing is held open."""


def newest_checkpoint(checkpoint_dir: str) -> tuple[CheckpointManager, int] | None:
    """The newer (by optimizer step) of the newest epoch checkpoint and the
    newest mid-epoch one under ``checkpoint_dir``: a run cut by
    ``--max_steps`` or preempted ends in a mid-epoch checkpoint."""
    found = []
    for mngr in (CheckpointManager(checkpoint_dir),
                 CheckpointManager(os.path.join(checkpoint_dir, "mid"))):
        step = mngr.latest_epoch()
        if step is not None:
            at = mngr.stored_step(step)
            found.append((-1 if at is None else at, len(found), mngr, step))
    if not found:
        return None
    # Ties go to the epoch checkpoint (listed first).
    _, _, mngr, step = max(found, key=lambda f: (f[0], -f[1]))
    return mngr, step


def restore_for_inference(cfg, *, semisupervised: bool, num_classes: int | None = None,
                          in_channels: int | None = None, device=None):
    """Build the trainer for ``cfg`` on ``device`` and restore the newest
    checkpoint under ``cfg.checkpoint_dir`` (:func:`newest_checkpoint`):
    the entry of ``--testing``. Returns ``(trainer, state, num_classes,
    in_channels)``; raises FileNotFoundError when there is no checkpoint."""
    from cyclegan_tpu_torch.data.datasets import DATASET_SPECS
    from cyclegan_tpu_torch.train.cyclegan import CycleGANTrainer

    if not semisupervised:
        raise NotImplementedError("--model supervised (train/supervised.py) arrives with a "
                                  "later slice of the port (ROADMAP Queue 1 item 6)")
    spec_nc, spec_ic, _ = DATASET_SPECS[cfg.dataset]
    num_classes = num_classes or spec_nc
    in_ch = in_channels or spec_ic
    trainer = CycleGANTrainer(cfg, num_classes, in_ch, steps_per_epoch=1, device=device)
    state = trainer.init_state(torch.Generator().manual_seed(cfg.seed))
    newest = newest_checkpoint(cfg.checkpoint_dir)
    if newest is None:
        raise FileNotFoundError(f"no checkpoint in {cfg.checkpoint_dir}")
    mngr, step = newest
    payload, _ = mngr.restore(trainer, state, epoch=step)
    state = payload["state"] if isinstance(payload, dict) else payload
    return trainer, state, num_classes, in_ch
