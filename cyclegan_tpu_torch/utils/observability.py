"""Metrics logging, step-window profiling, spans and NaN checking.

Counterpart of ``cyclegan_tpu/utils/observability.py``:
- :class:`MetricsLogger` prints the same line and appends the same JSON
  lines (``t``, ``step``, ``epoch``, the scalars, ``steps_per_sec``);
  TensorBoard scalars only with ``CYCLEGAN_TPU_TENSORBOARD`` set and
  ``torch.utils.tensorboard`` importable;
- :class:`StepProfiler` traces steps [start, stop) with ``torch.profiler``
  (CUDA activity included when there is a card), once a run;
- :func:`span` marks a phase of the program (the train step's G, pool and
  D phases, the predictor's scale, flip, tile and forward stages);
- :func:`enable_debug_flags` turns on autograd's anomaly mode with its NaN
  checks when asked (``--debug_nans``).

In a data-parallel run only the primary rank logs and traces.

Spans are off by default: :func:`span` then returns one shared null
context, and costs a global read. :func:`record_spans` turns recording on:
each span then reads ``time.time_ns()`` (the clock of ``torch.profiler``'s
events, so spans and a profile of the same stretch share one time axis) at
entry and at exit and appends one :class:`Span`, which stays in memory
until :func:`take_spans` takes it. A span never synchronizes and adds no
device work. Each thread has its own stack of open spans; a span's unit is
the one given to it, else its parent's (the train step's number, or a
predictor's call count). While :class:`StepProfiler`'s window is open,
each span also enters ``torch.profiler.record_function(name)``, so the
operator's trace shows the phases; outside it that does nothing more.
"""

from __future__ import annotations

import contextlib
import json
import os
import threading
import time
from typing import Any, NamedTuple

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


class Span(NamedTuple):
    """One closed (or, if taken while open, open: ``end`` None) span."""
    name: str
    start: int           # time.time_ns() at entry
    end: int | None      # time.time_ns() at exit
    parent: int          # index of the enclosing span in the same take, -1 if none
    unit: int | None     # train step number or predictor call count
    thread: int          # threading.get_ident() of the thread that opened it


class _Spans:
    """What :func:`span` does while it does anything: record, annotate the
    profiler's trace, or both."""

    def __init__(self):
        self.record = False
        self.annotate = False
        self.entries: list = []       # [name, start, end, parent entry, unit, thread]
        self.local = threading.local()


_SPANS = _Spans()
_active: _Spans | None = None  # _SPANS while it records or annotates, else None
_NULL = contextlib.nullcontext()


def _set_spans(*, record: bool | None = None, annotate: bool | None = None) -> None:
    global _active
    if record is not None:
        _SPANS.record = record
    if annotate is not None:
        _SPANS.annotate = annotate
    _active = _SPANS if _SPANS.record or _SPANS.annotate else None


def record_spans(on: bool) -> None:
    """Turn span recording on or off (off by default). Spans recorded stay
    until :func:`take_spans` takes them."""
    _set_spans(record=on)


def take_spans() -> list[Span]:
    """The spans recorded since the last take, in the order they opened,
    and forget them. Take between units of work: a span open across a take
    is returned open and its end is lost."""
    entries, _SPANS.entries = _SPANS.entries, []
    index = {id(e): i for i, e in enumerate(entries)}
    return [Span(e[0], e[1], e[2], index.get(id(e[3]), -1), e[4], e[5]) for e in entries]


class _OpenSpan:
    __slots__ = ("spans", "name", "unit", "entry", "annotation")

    def __init__(self, spans: _Spans, name: str, unit: int | None):
        self.spans, self.name, self.unit = spans, name, unit
        self.entry = self.annotation = None

    def __enter__(self):
        spans = self.spans
        if spans.annotate:
            self.annotation = torch.profiler.record_function(self.name)
            self.annotation.__enter__()
        if spans.record:
            stack = spans.local.__dict__.setdefault("stack", [])
            parent = stack[-1] if stack else None
            unit = self.unit if self.unit is not None or parent is None else parent[4]
            self.entry = [self.name, time.time_ns(), None, parent, unit, threading.get_ident()]
            spans.entries.append(self.entry)
            stack.append(self.entry)

    def __exit__(self, *exc):
        if self.entry is not None:
            self.entry[2] = time.time_ns()
            self.spans.local.stack.pop()
        if self.annotation is not None:
            self.annotation.__exit__(*exc)


def span(name: str, unit: int | None = None):
    """A context manager marking phase ``name`` of the program; ``unit``
    names the unit of work a root span opens (see the module's docstring)."""
    spans = _active
    if spans is None:
        return _NULL
    return _OpenSpan(spans, name, unit)


class StepProfiler:
    """Traces steps [start, stop) of training with ``torch.profiler`` into
    ``profile_dir`` (a TensorBoard-readable Chrome trace), one window a run,
    on the primary rank; the program's spans show in it as annotations."""

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
            _set_spans(annotate=True)

    def maybe_stop(self, step: int) -> None:
        if self._prof is not None and step >= self.stop_step:
            self.finish()

    def finish(self) -> None:
        if self._prof is not None:
            _set_spans(annotate=False)
            self._prof.stop()
            self._prof = None
            self._done = True


def enable_debug_flags(debug_nans: bool = False) -> None:
    """Autograd anomaly detection with NaN checks (slow): only when asked."""
    if debug_nans:
        torch.autograd.set_detect_anomaly(True, check_nan=True)
