"""The port's spans read against a ``torch.profiler`` trace of one stretch.

Spans come from ``cyclegan_tpu_torch.utils.observability.take_spans()``:
each has ``name``, ``start`` and ``end`` (``time.time_ns``, the clock of
the profiler's events), ``parent`` (an index into the same list, -1 for
none), ``unit`` and ``thread``. :func:`from_profiler` keeps the stretch's
host calls (on the card the CUDA runtime's) and its device operations,
each operation with the correlation id of the call that launched it.

Attribution goes by time, not by thread: a device operation belongs to the
innermost span whose interval holds the start of the call that launched
it (on the card ``torch.autograd.grad`` launches the backward from the
autograd engine's thread while the calling thread waits inside its span),
and an idle gap of the device to the innermost span open when it began.
A reader returns a number, or None where there is nothing to read.

The per-layer metrics that read spans (``metrics/<metric>.py``) import
their ``read(obs)`` from the last section here: it takes a
:class:`portbench.readings.Observation` whose traffic kind recorded spans
(:func:`recorded`) in two places only, around probes that run each unit
from an idle device (``obs.probe_spans``, host-timed) and inside the
profiled stretch (``obs.spans``, ``obs.span_calls``).
"""

from __future__ import annotations

import bisect
import collections
import contextlib
import dataclasses
import statistics

from portbench import trace as T

# Host calls that enqueue device work, and those that block the host on the
# device (a cudaMemcpyAsync to the host blocks too: see host_syncs).
LAUNCHES = frozenset({"cudaLaunchKernel", "cudaLaunchKernelExC", "cudaLaunchCooperativeKernel",
                      "cudaGraphLaunch", "cudaMemcpyAsync", "cudaMemsetAsync"})
SYNCS = frozenset({"cudaDeviceSynchronize", "cudaStreamSynchronize", "cudaEventSynchronize",
                   "cudaMemcpy"})
UPDATES = frozenset({"g_update", "d_update"})
# The train step's phases whose host self time a metric reads.
FORWARD = frozenset({"g_forward", "d_forward"})
BACKWARD = frozenset({"g_backward", "d_backward"})
POOL = frozenset({"pool"})
NO_SPAN = "(no span)"


@contextlib.contextmanager
def recorded():
    """The program's span recording on while the block runs
    (``observability.record_spans``); yields ``take``, which returns the
    spans recorded since the last take. Spans left from before the block
    are dropped, and recording is off again after it."""
    from cyclegan_tpu_torch.utils import observability as O

    O.take_spans()
    O.record_spans(True)
    try:
        yield O.take_spans
    finally:
        O.record_spans(False)
        O.take_spans()


@dataclasses.dataclass(frozen=True)
class Call:
    name: str
    start: int       # ns
    end: int         # ns
    corr: int        # correlation id (a device operation: its launching call's)


@dataclasses.dataclass
class Calls:
    t0: int          # the stretch, ns
    t1: int
    host: list       # [Call] host calls, on the card the CUDA runtime's
    device: list     # [Call] device operations, clipped to the stretch


def from_profiler(prof, s0: int, s1: int) -> Calls:
    """The host calls and device operations of the stretch [``s0``,
    ``s1``] (ns) of a finished ``torch.profiler.profile``."""
    from torch.autograd import DeviceType

    host, device = [], []
    for e in prof.profiler.kineto_results.events():
        a = e.start_ns()
        b = a + e.duration_ns()
        if b <= s0 or a >= s1:
            continue
        if e.device_type() != DeviceType.CUDA:
            host.append(Call(e.name(), a, b, e.correlation_id()))
        elif not e.is_user_annotation():
            device.append((e.name(), max(a, s0), min(b, s1), e.correlation_id(),
                           e.linked_correlation_id()))
    ids = {c.corr for c in host}
    # A device operation carries its launching call's correlation id; where
    # it does not, its linked one.
    device = [Call(n, a, b, c if c in ids else linked) for n, a, b, c, linked in device]
    return Calls(s0, s1, host, device)


class Index:
    """The spans of one take, for asking which one held a time."""

    def __init__(self, spans: list):
        self.spans = spans
        self.order = sorted((s.start, i) for i, s in enumerate(spans) if s.end is not None)
        self.starts = [a for a, _ in self.order]

    def innermost(self, t: int) -> int | None:
        """The span holding ``t`` that opened last (spans nest on a thread,
        so on one thread that is the innermost)."""
        for j in range(bisect.bisect_right(self.starts, t) - 1, -1, -1):
            i = self.order[j][1]
            if self.spans[i].end > t:
                return i
        return None

    def names(self, i: int | None) -> set:
        """The names of span ``i`` and every span enclosing it."""
        out = set()
        while i is not None and i >= 0:
            out.add(self.spans[i].name)
            i = self.spans[i].parent
        return out

    def root(self, i: int) -> int:
        while self.spans[i].parent >= 0:
            i = self.spans[i].parent
        return i


def self_ns(spans: list) -> list:
    """Each span's time outside its children, ns."""
    out = [(s.end - s.start) if s.end is not None else 0 for s in spans]
    for s in spans:
        if s.parent >= 0 and s.end is not None:
            out[s.parent] -= s.end - s.start
    return out


def roots(spans: list, name: str) -> list:
    return [i for i, s in enumerate(spans) if s.name == name and s.parent < 0]


def host_ms(spans: list, names, root: str = "train_step") -> float | None:
    """The median over the ``root`` spans of the self time, in ms, of the
    spans under each that are named ``names``."""
    idx, own = Index(spans), self_ns(spans)
    per_root = dict.fromkeys(roots(spans, root), 0)
    if not per_root:
        return None
    for i, s in enumerate(spans):
        if s.name in names:
            r = idx.root(i)
            if r in per_root:
                per_root[r] += own[i]
    return statistics.median(per_root.values()) * 1e-6


def device_ns(spans: list, calls: Calls) -> dict:
    """Device ns by the span (index, None outside every span) that
    launched each operation."""
    idx = Index(spans)
    launched_at = {c.corr: c.start for c in calls.host}
    out = collections.Counter()
    for d in calls.device:
        t = launched_at.get(d.corr)
        out[None if t is None else idx.innermost(t)] += d.end - d.start
    return out


def _under(spans: list, by_span: dict, inside, outside=frozenset()) -> int:
    """Device ns of the spans that are, or lie in, one named ``inside`` and
    neither are nor lie in one named ``outside``."""
    idx = Index(spans)
    total = 0
    for i, ns in by_span.items():
        names = idx.names(i)
        if names & inside and not names & outside:
            total += ns
    return total


def update_device_ms(spans: list, calls: Calls) -> float | None:
    """Device ms a train step of the operations launched inside
    ``g_update`` / ``d_update``."""
    n = len(roots(spans, "train_step"))
    if not n or not calls.device:
        return None
    return _under(spans, device_ns(spans, calls), UPDATES) / n * 1e-6


def _per_step(spans: list, calls: Calls, chosen: list) -> float | None:
    """The ``chosen`` host calls that start inside a ``train_step`` span,
    a train step."""
    steps = [spans[i] for i in roots(spans, "train_step")]
    if not steps or not calls.device:
        return None
    return sum(1 for c in chosen if any(s.start <= c.start < s.end for s in steps)) / len(steps)


def launches(spans: list, calls: Calls) -> float | None:
    """Calls that enqueue device work, a train step."""
    return _per_step(spans, calls, [c for c in calls.host if c.name in LAUNCHES])


def host_syncs(spans: list, calls: Calls) -> float | None:
    """Calls that block the host on the device, a train step: the
    synchronizes, ``cudaMemcpy``, and each ``cudaMemcpyAsync`` whose device
    copy goes to the host (a ``.item()`` is two: its copy and its stream
    synchronize)."""
    to_host = {d.corr for d in calls.device if "DtoH" in d.name}
    return _per_step(spans, calls, [c for c in calls.host if c.name in SYNCS or (
        c.name == "cudaMemcpyAsync" and c.corr in to_host)])


def tta_device_share(spans: list, calls: Calls) -> float | None:
    """Of the device time launched inside ``serve.predict``, the share
    launched outside every ``serve.forward``, in %."""
    by_span = device_ns(spans, calls)
    served = _under(spans, by_span, {"serve.predict"})
    if not served:
        return None
    return 100.0 * _under(spans, by_span, {"serve.predict"}, {"serve.forward"}) / served


def rooted_share(spans: list, calls: Calls, root: str) -> float | None:
    """The share of the stretch's device time launched inside a ``root``
    span, in %."""
    by_span = device_ns(spans, calls)
    total = sum(by_span.values())
    return 100.0 * _under(spans, by_span, {root}) / total if total else None


def by_span(spans: list, calls: Calls) -> dict:
    """{span name: [device ms, idle ms]}: device time by the innermost span
    that launched it, and each idle gap of the device by the innermost
    span open when it began (:data:`NO_SPAN` outside every span)."""
    idx = Index(spans)

    def name(i):
        return NO_SPAN if i is None else spans[i].name

    out = collections.defaultdict(lambda: [0.0, 0.0])
    for i, ns in device_ns(spans, calls).items():
        out[name(i)][0] += ns * 1e-6
    at = calls.t0
    for a, b in T.merged((d.start, d.end) for d in calls.device):
        if a > at:
            out[name(idx.innermost(at))][1] += (a - at) * 1e-6
        at = max(at, b)
    if calls.t1 > at:
        out[name(idx.innermost(at))][1] += (calls.t1 - at) * 1e-6
    return dict(out)


# Readers of an Observation, one per per-layer metric (metrics/<metric>.py).

def read_fwd_host_ms(obs) -> float | None:
    """Host ms a train step in the forwards (``g_forward`` + ``d_forward``
    self time), the median over the probes."""
    return host_ms(obs.probe_spans, FORWARD)


def read_bwd_host_ms(obs) -> float | None:
    """Host ms a train step in ``g_backward`` + ``d_backward``."""
    return host_ms(obs.probe_spans, BACKWARD)


def read_update_host_ms(obs) -> float | None:
    """Host ms a train step in ``g_update`` + ``d_update``."""
    return host_ms(obs.probe_spans, UPDATES)


def read_pool_host_ms(obs) -> float | None:
    """Host ms a train step in ``pool``."""
    return host_ms(obs.probe_spans, POOL)


def _stretch(fn, obs, *args):
    return None if obs.span_calls is None else fn(obs.spans, obs.span_calls, *args)


def read_update_device_ms(obs) -> float | None:
    return _stretch(update_device_ms, obs)


def read_launches(obs) -> float | None:
    return _stretch(launches, obs)


def read_host_syncs(obs) -> float | None:
    return _stretch(host_syncs, obs)


def read_tta_device_share(obs) -> float | None:
    """None also where no device time lay outside every ``serve.forward``:
    no TTA work was found to read."""
    return _stretch(tta_device_share, obs) or None
