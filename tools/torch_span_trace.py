"""The port's spans on one cell of the benchmark, read against its device trace.

Runs cell ``--workload`` of ``BENCHMARK.json`` as its ``--trace 1`` run
does (``portbench``'s set-up from ``--seed``, then ``host_probes`` units
each from an idle device, host-timed, then a stretch of ``trace_steps``
train steps or ``trace_batches`` served batches from sync to sync under
``torch.profiler``, device activity alone) with span recording on
(``utils/observability.py``), and prints one JSON line:

- ``metrics``: a train cell's ``trainer.fwd_host_ms.train``,
  ``trainer.bwd_host_ms.train``, ``trainer.update_host_ms.train`` and
  ``trainer.pool_host_ms.train`` (the median over the probes of those
  phases' self time), ``trainer.update_device_ms.train``,
  ``trainer.launches.train`` and ``trainer.host_syncs.train`` (a step of
  the stretch); a serve cell's ``serve_front.tta_device_share``; readers
  in ``portbench/spans.py``;
- ``checks``: the share of the stretch's device time launched inside a
  root span, each probe's phases' and root's self time against its root's
  duration, and the probes' median root duration against their median
  host-clock time (the cell's ``host_enqueue_ms.train`` / ``serve_host_ms``);
- ``by_span``: the stretch's device ms and idle ms by innermost span,
  and ``host_calls``, the stretch's host calls by name (also on standard
  error);
- ``device``: the card's name and power limit.

Run from the root of a checkout, on the card: python3
tools/torch_span_trace.py --workload voc_dp8_bf16.train --seed 3000000001
(``run(..., device="cpu", overrides=...)`` runs it on the CPU at a test's
size).
"""

from __future__ import annotations

import argparse
import collections
import json
import statistics
import sys
import time
from pathlib import Path

ROOT = Path(__file__).resolve().parent.parent
sys.path.insert(0, str(ROOT))

import torch  # noqa: E402

from cyclegan_tpu_torch.utils import observability as obs  # noqa: E402
from portbench import harness  # noqa: E402
from portbench import spans as S  # noqa: E402
from portbench import trace as T  # noqa: E402
from portbench.traffic import serve, train  # noqa: E402

PHASES = {"trainer.fwd_host_ms.train": {"g_forward", "d_forward"},
          "trainer.bwd_host_ms.train": {"g_backward", "d_backward"},
          "trainer.update_host_ms.train": {"g_update", "d_update"},
          "trainer.pool_host_ms.train": {"pool"}}


def probes(unit, n: int, dev) -> tuple[list, list]:
    """``n`` calls of ``unit`` each from an idle device: their host ms and
    the spans of all of them (one root each)."""
    host = []
    obs.take_spans()
    for _ in range(n):
        train.sync(dev)
        t = time.perf_counter()
        unit()
        host.append((time.perf_counter() - t) * 1e3)
    return host, obs.take_spans()


def stretch(run, dev) -> tuple[list, S.Calls, T.Trace]:
    """``run`` from sync to sync under the profiler: its spans and calls."""
    train.sync(dev)
    obs.take_spans()
    with torch.profiler.profile(activities=T.activities(dev)) as prof:
        s0 = time.time_ns()
        run()
        train.sync(dev)
        s1 = time.time_ns()
    return obs.take_spans(), S.from_profiler(prof, s0, s1), T.from_profiler(prof, s0, s1)


def probe_checks(host: list, spans: list, root: str) -> dict:
    """Each probe's self times against its root's duration, and the roots'
    median duration against the host clock's median."""
    idx, own = S.Index(spans), S.self_ns(spans)
    total = collections.Counter()
    for i in range(len(spans)):
        total[idx.root(i)] += own[i]
    roots = S.roots(spans, root)
    worst = max(abs(total[r] - (spans[r].end - spans[r].start)) for r in roots)
    ms = statistics.median((spans[r].end - spans[r].start) * 1e-6 for r in roots)
    return {"probe_self_sum_worst_ns": worst, "root_ms_median": ms,
            "host_ms_median": statistics.median(host),
            "root_over_host": ms / statistics.median(host)}


def run(workload: str, seed: int, device: str, overrides: dict | None = None) -> dict:
    cell = harness.load_cell(workload)
    dev = torch.device(device)
    ctx = harness.make_context(cell, seed, 0.0, True, dev, time.perf_counter(), overrides)
    p = ctx.params
    kind = cell.workload["kind"]
    if kind == "train":
        prog, _ = train.setup(ctx)
        root, unit = "train_step", prog.step

        def window():
            for _ in range(p["trace_steps"]):
                prog.step()
    else:
        prog = serve.Program(ctx)
        for _ in range(p["warm_batches"]):
            prog.fetch(prog.submit())
        root = "serve.predict"
        pending = []

        def unit():
            pending.append(prog.submit())

        def window():
            prog.pipelined(batches=p["trace_batches"])

    obs.record_spans(True)
    try:
        host, probe_spans = probes(unit, p["host_probes"], dev)
        if kind != "train":
            for sent in pending:
                prog.fetch(sent)
        spans, calls, tr = stretch(window, dev)
    finally:
        obs.record_spans(False)
    if kind == "train":
        metrics = {name: S.host_ms(probe_spans, names) for name, names in PHASES.items()}
        metrics.update({"trainer.update_device_ms.train": S.update_device_ms(spans, calls),
                        "trainer.launches.train": S.launches(spans, calls),
                        "trainer.host_syncs.train": S.host_syncs(spans, calls)})
    else:
        metrics = {"serve_front.tta_device_share": S.tta_device_share(spans, calls)}
    checks = {"rooted_device_share": S.rooted_share(spans, calls, root),
              "idle_share": 100.0 * (1.0 - T.busy_seconds(tr) / tr.window_s),
              **probe_checks(host, probe_spans, root)}
    by_span = {k: [round(v[0], 3), round(v[1], 3)]
               for k, v in sorted(S.by_span(spans, calls).items(), key=lambda kv: -sum(kv[1]))}
    names = collections.Counter(c.name for c in calls.host)
    return {"workload": workload, "seed": seed, "metrics": metrics, "checks": checks,
            "by_span": by_span, "stretch_ms": (calls.t1 - calls.t0) * 1e-6,
            "units": len(S.roots(spans, root)), "spans": len(spans),
            "host_calls": dict(names.most_common(20)),
            "device": {"kind": torch.cuda.get_device_name(dev) if dev.type == "cuda" else "cpu",
                       "power_limit": harness.power_limit() if dev.type == "cuda" else None}}


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seed", type=int, required=True)
    args = ap.parse_args(argv)
    out = run(args.workload, args.seed, "cuda")
    for name, (dev_ms, idle_ms) in out["by_span"].items():
        print(f"span {name}: device {dev_ms} ms, idle {idle_ms} ms", file=sys.stderr)
    print(json.dumps(out))
    return 0


if __name__ == "__main__":
    sys.exit(main())
