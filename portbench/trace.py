"""Reading a ``torch.profiler`` trace of the traced stretch.

The stretch runs from a host timestamp taken after a synchronize to one
taken after the synchronize that ends it (``time.time_ns``, the clock the
profiler's events are given in). On the card the profiler records the
device activity alone (kernels, copies, fills, and the CUDA runtime calls
that launched them), not every PyTorch operator: recording operators slows
the host enough to starve the card in a host-heavy step (path B's step
read 29-32% idle with them, its window's rate 28% above the stretch's).
Device events are clipped to the stretch. Idle gaps are the stretch's time
outside the union of device events; each is labelled by the innermost host
event (a runtime call, or on the CPU an operator) running when it began.
"""

from __future__ import annotations

import bisect
import collections
import dataclasses
import re

TOP = 10
LABELLED = 300  # the longest gaps labelled one by one; the rest summed


@dataclasses.dataclass
class Trace:
    t0: float                 # stretch start, s
    t1: float                 # stretch end, s
    device: list              # [(name, start s, end s)] clipped to the stretch
    host: list                # [(name, start s, end s)] of host events

    @property
    def window_s(self) -> float:
        return self.t1 - self.t0


def _events(prof):
    """(name, is_device, start ns, end ns) of every raw event; the device
    side of a host annotation is no device work and is left out."""
    from torch.autograd import DeviceType

    for e in prof.profiler.kineto_results.events():
        device = e.device_type() == DeviceType.CUDA
        if device and getattr(e, "is_user_annotation", bool)():
            continue
        start = e.start_ns() if hasattr(e, "start_ns") else e.start_us() * 1000
        dur = e.duration_ns() if hasattr(e, "duration_ns") else e.duration_us() * 1000
        yield e.name(), device, start, start + dur


def activities(device) -> list:
    """What the profiler records: the card's activity, or on the CPU its
    operators."""
    import torch

    a = torch.profiler.ProfilerActivity
    return [a.CUDA] if device.type == "cuda" else [a.CPU]


def from_profiler(prof, s0: int, s1: int) -> Trace:
    """The events of the stretch [``s0``, ``s1``] (``time.time_ns``)."""
    evs = list(_events(prof))
    device = [(n, max(a, s0) * 1e-9, min(b, s1) * 1e-9) for n, dev, a, b in evs
              if dev and b > s0 and a < s1]
    host = [(n, a * 1e-9, b * 1e-9) for n, dev, a, b in evs if not dev and b > s0 and a < s1]
    return Trace(s0 * 1e-9, s1 * 1e-9, device, host)


def merged(intervals) -> list:
    out = []
    for a, b in sorted(intervals):
        if out and a <= out[-1][1]:
            out[-1][1] = max(out[-1][1], b)
        else:
            out.append([a, b])
    return out


def busy_seconds(tr: Trace) -> float:
    """Seconds of the stretch in which some operation ran on the device."""
    return sum(b - a for a, b in merged((s, e) for _, s, e in tr.device))


def idle_gaps(tr: Trace) -> list:
    """[(start, end)] of the stretch not covered by device events."""
    gaps, at = [], tr.t0
    for a, b in merged((s, e) for _, s, e in tr.device):
        if a > at:
            gaps.append((at, a))
        at = max(at, b)
    if tr.t1 > at:
        gaps.append((at, tr.t1))
    return gaps


def kernel_id(name: str) -> str:
    """The function identifier of a device event's (demangled) name:
    ``void (anonymous namespace)::in_fwd<float, 4>(...)`` -> ``in_fwd``."""
    head = name.replace("(anonymous namespace)", "").strip()
    head = re.sub(r"^(void|static|__global__)\s+", "", head)
    head = head.split("<", 1)[0].split("(", 1)[0]
    return head.rsplit("::", 1)[-1].strip()


def label_gaps(tr: Trace, gaps: list) -> list:
    """Each gap with the innermost CPU event running at its start."""
    host = sorted(tr.host, key=lambda e: e[1])
    starts = [e[1] for e in host]
    out = []
    for a, b in gaps:
        # Host events nest: the latest-starting one still running at ``a``
        # is the innermost.
        name = "(host outside the recorded calls)"
        for j in range(bisect.bisect_right(starts, a) - 1, -1, -1):
            if host[j][2] > a:
                name = host[j][0]
                break
        out.append((name, b - a))
    return out


def breakdown(tr: Trace) -> dict:
    """The device operations that took most time, and the idle time by
    what the host was doing, each at most :data:`TOP` entries."""
    by_kernel = collections.Counter()
    for name, s, e in tr.device:
        by_kernel[name[:160]] += e - s
    gaps = sorted(idle_gaps(tr), key=lambda g: g[0] - g[1])
    idle = collections.Counter()
    for name, secs in label_gaps(tr, gaps[:LABELLED]):
        idle[name[:160]] += secs
    rest = sum(b - a for a, b in gaps[LABELLED:])
    if rest:
        idle[f"(the {len(gaps) - LABELLED} shorter gaps)"] += rest
    return {"device_ops": [[k, v] for k, v in by_kernel.most_common(TOP)],
            "idle_gaps": [[k, v] for k, v in idle.most_common(TOP)]}
