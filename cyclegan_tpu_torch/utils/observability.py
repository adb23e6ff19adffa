"""Metrics logging, step-window profiling and NaN checking.

Counterpart of ``cyclegan_tpu/utils/observability.py``:
- :class:`MetricsLogger` prints the same line and appends the same JSON
  lines (``t``, ``step``, ``epoch``, the scalars, ``steps_per_sec``);
  TensorBoard scalars only with ``CYCLEGAN_TPU_TENSORBOARD`` set and
  ``torch.utils.tensorboard`` importable;
- :class:`StepProfiler` traces steps [start, stop) with ``torch.profiler``
  (CUDA activity included when there is a card), once a run;
- :func:`enable_debug_flags` turns on autograd's anomaly mode with its NaN
  checks when asked (``--debug_nans``).

In a data-parallel run only the primary rank logs and traces.
"""

from __future__ import annotations

import json
import os
import time
from typing import Any

import numpy as np
import torch

from cyclegan_tpu_torch.parallel.distributed import is_primary


class MetricsLogger:
    """Prints human-readable lines and appends JSON lines to
    ``<log_dir>/<prefix>_metrics.jsonl``; off on ranks other than the
    primary."""

    def __init__(self, log_dir: str | None, *, prefix: str = "train"):
        self._file = None
        self._tb = None
        self.enabled = is_primary()
        if log_dir and self.enabled:
            os.makedirs(log_dir, exist_ok=True)
            self._file = open(os.path.join(log_dir, f"{prefix}_metrics.jsonl"), "a",
                              buffering=1)
            if os.environ.get("CYCLEGAN_TPU_TENSORBOARD"):
                try:
                    from torch.utils.tensorboard import SummaryWriter
                except ImportError:
                    pass
                else:
                    self._tb = SummaryWriter(os.path.join(log_dir, "tb"))
        self._t0 = time.perf_counter()

    def log(self, *, step: int, epoch: int, metrics: dict[str, Any],
            steps_per_sec: float | None = None) -> None:
        """``metrics`` may hold device tensors: each is read here (a sync)."""
        if not self.enabled:
            return
        scalars = {k: float(v) for k, v in metrics.items() if np.ndim(v) == 0}
        parts = " ".join(f"{k}={v:.4f}" for k, v in sorted(scalars.items()))
        sps = f" steps/sec={steps_per_sec:.3f}" if steps_per_sec else ""
        print(f"[epoch {epoch} step {step}] {parts}{sps}", flush=True)
        if self._file is not None:
            rec = {"t": round(time.perf_counter() - self._t0, 3), "step": step,
                   "epoch": epoch, **scalars}
            if steps_per_sec is not None:
                rec["steps_per_sec"] = round(steps_per_sec, 4)
            self._file.write(json.dumps(rec) + "\n")
        if self._tb is not None:
            for k, v in scalars.items():
                self._tb.add_scalar(k, v, step)
            if steps_per_sec is not None:
                self._tb.add_scalar("steps_per_sec", steps_per_sec, step)

    def close(self) -> None:
        if self._file is not None:
            self._file.close()
        if self._tb is not None:
            self._tb.close()


class StepProfiler:
    """Traces steps [start, stop) of training with ``torch.profiler`` into
    ``profile_dir`` (a TensorBoard-readable Chrome trace), one window a run,
    on the primary rank."""

    def __init__(self, profile_dir: str | None, start: int = 10, stop: int = 15):
        self.dir = profile_dir if is_primary() else None
        self.start_step = start
        self.stop_step = stop
        self._prof = None
        self._done = False

    def maybe_start(self, step: int) -> None:
        # >= (not ==): with steps_per_call > 1 the counter moves in strides.
        if self.dir and self._prof is None and not self._done and step >= self.start_step:
            acts = [torch.profiler.ProfilerActivity.CPU]
            if torch.cuda.is_available():
                acts.append(torch.profiler.ProfilerActivity.CUDA)
            self._prof = torch.profiler.profile(
                activities=acts,
                on_trace_ready=torch.profiler.tensorboard_trace_handler(self.dir))
            self._prof.start()

    def maybe_stop(self, step: int) -> None:
        if self._prof is not None and step >= self.stop_step:
            self.finish()

    def finish(self) -> None:
        if self._prof is not None:
            self._prof.stop()
            self._prof = None
            self._done = True


def enable_debug_flags(debug_nans: bool = False) -> None:
    """Autograd anomaly detection with NaN checks (slow): only when asked."""
    if debug_nans:
        torch.autograd.set_detect_anomaly(True, check_nan=True)
