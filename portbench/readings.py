"""What a traced run observed, and the arithmetic the per-layer readers share.

A reader (``portbench/metrics/<metric>.py``) gets one :class:`Observation`
and returns a number, or None where it finds nothing to read; it never
returns 0 for a share of a roofline or of a peak. The readers of the
program's spans are in :mod:`portbench.spans`.
"""

from __future__ import annotations

import dataclasses
import functools
import re
import statistics
from pathlib import Path

from portbench import spans as S
from portbench import trace as T
from portbench.work import calls
from portbench.work.peaks import PEAK_FLOPS


@dataclasses.dataclass
class Observation:
    trace: T.Trace | None      # the traced stretch
    units: int                 # train steps or served batches in the stretch
    launches: dict             # the port's C-entry calls in the stretch
    calls: dict                # {entry: [calls, least s]} one unit needs (work.calls)
    model_flops: float         # model FLOPs of one unit (work.model)
    host_ms: list              # host ms to enqueue one unit, from an idle device
    spans: list = ()           # the stretch's spans (observability.take_spans())
    span_calls: S.Calls | None = None  # the stretch's host calls and device work
    probe_spans: list = ()     # the spans of units each run from an idle device


@functools.cache
def port_kernels() -> frozenset:
    """Names of the port's device functions (``__global__`` in its csrc)."""
    import cyclegan_tpu_torch

    csrc = Path(cyclegan_tpu_torch.__file__).resolve().parent / "csrc"
    pat = re.compile(r"__global__\s+void\s+(?:__launch_bounds__\s*\([^)]*\)\s*)?(\w+)\s*\(")
    return frozenset(m.group(1) for f in sorted(csrc.glob("*.cu"))
                     for m in pat.finditer(f.read_text()))


def device_seconds(obs: Observation, names=None) -> float:
    """Device seconds of the stretch's events, of ``names`` only if given."""
    return sum(e - s for n, s, e in obs.trace.device
               if names is None or T.kernel_id(n) in names)


def idle_share(obs: Observation) -> float | None:
    if obs.trace is None or not obs.trace.device:
        return None
    return 100.0 * (1.0 - T.busy_seconds(obs.trace) / obs.trace.window_s)


def library_share(obs: Observation) -> float | None:
    if obs.trace is None or not obs.trace.device:
        return None
    total = device_seconds(obs)
    port = device_seconds(obs, port_kernels())
    return 100.0 * (total - port) / total


def roofline(obs: Observation, entries, kernels) -> float | None:
    """The least time of the work that the stretch's units need of
    ``entries`` (``work.calls``), over the device time of the ``kernels``
    they launch, in %. An entry is credited at most the calls it launched:
    work that a route gives to the library is not the kernels'."""
    if obs.trace is None:
        return None
    busy = device_seconds(obs, frozenset(kernels))
    least = 0.0
    for entry in entries:
        per_unit_calls, per_unit_s = obs.calls.get(entry, (0, 0.0))
        done = min(obs.launches.get(entry, 0), per_unit_calls * obs.units)
        if done:
            least += per_unit_s / per_unit_calls * done
    if busy <= 0.0 or least <= 0.0:
        return None
    return 100.0 * least / busy


def conv_roofline(obs: Observation) -> float | None:
    return roofline(obs, calls.CONV_ENTRIES, calls.CONV_KERNELS)


def norm_roofline(obs: Observation) -> float | None:
    return roofline(obs, calls.NORM_ENTRIES, calls.NORM_KERNELS)


def mfu(obs: Observation) -> float | None:
    """Model FLOPs completed in the stretch over its seconds at the bf16 peak."""
    if obs.trace is None or not obs.trace.device or not obs.units:
        return None
    return 100.0 * obs.model_flops * obs.units / (obs.trace.window_s * PEAK_FLOPS["bfloat16"])


def host_ms(obs: Observation) -> float | None:
    return statistics.median(obs.host_ms) if obs.host_ms else None
