"""Run one cell of ``BENCHMARK.json`` once and build its result line.

Everything is found by name: the cell in ``BENCHMARK.json``; its traffic
and limits in ``workloads/<cell>.json``; its configuration in
``configs/<config>.json``; the driver of its traffic kind in
``traffic/<kind>.py``; each per-layer metric's reader in
``metrics/<metric>.py``. A new cell, configuration or metric is new files
and new entries, never an edit.

A run: set-up (every shape warmed, the check's first steps taken), the
window of ``--seconds`` (``--trace 0``: the cell's end-to-end metrics) or
the traced stretch (``--trace 1``: its per-layer metrics), then the
program freed and the reference run to decide ``correct``.
"""

from __future__ import annotations

import argparse
import dataclasses
import importlib
import importlib.util
import json
import math
import os
import sys
import time
from pathlib import Path

BENCH_DIR = Path(__file__).resolve().parent
ROOT = BENCH_DIR.parent
# Top-level module names that no run may load (compared whole).
FORBIDDEN = ("jax", "jaxlib", "flax", "cyclegan_tpu")


class CellError(RuntimeError):
    """The cell, its files or its run are not as the benchmark needs."""


def load_json(path: Path) -> dict:
    with open(path) as f:
        return json.load(f)


def manifest(root: Path = ROOT) -> dict:
    return load_json(root / "BENCHMARK.json")


def find(entries: list, name: str, what: str) -> dict:
    for e in entries:
        if e["name"] == name:
            return e
    raise CellError(f"no {what} named {name!r} in BENCHMARK.json")


@dataclasses.dataclass
class Cell:
    name: str
    entry: dict          # BENCHMARK.json's workload entry
    workload: dict       # workloads/<name>.json
    config: dict         # configs/<config>.json
    end_to_end: list     # BENCHMARK.json metric entries this cell reports
    per_layer: list


def reports(metric: dict, cell: str) -> bool:
    """Whether ``cell`` reports ``metric``: the cells its ``workloads``
    lists, else every cell."""
    return cell in metric.get("workloads", (cell,))


def load_cell(name: str, bench: dict | None = None) -> Cell:
    bench = manifest() if bench is None else bench
    entry = find(bench["workloads"], name, "workload")
    workload = load_json(BENCH_DIR / "workloads" / f"{name}.json")
    if (workload["config"], workload["traffic"]) != (entry["config"], entry["traffic"]):
        raise CellError(f"workloads/{name}.json names {workload['config']}/"
                        f"{workload['traffic']}, BENCHMARK.json {entry['config']}/"
                        f"{entry['traffic']}")
    conf = find(bench["configs"], entry["config"], "config")
    config = load_json(ROOT / conf["file"])
    e2e = [m for m in bench["end_to_end"] if reports(m, name)]
    per_layer = [m for m in bench["per_layer"] if reports(m, name)]
    return Cell(name, entry, workload, config, e2e, per_layer)


# Keys every configuration file states, held to its preset unless listed.
STATED = ("gen_net", "ngf", "ndf", "n_layers_D", "norm", "crop_height", "crop_width", "bf16",
          "pool_size", "lr", "lamda", "epochs", "decay_epoch")
# Widths, which no configuration may cut.
WIDTHS = ("ngf", "ndf")


def config_problems(name: str, body: dict) -> list:
    """What keeps configuration ``name``'s file ``body`` from its preset, as
    a list of problems (empty: none). The preset is ``body['preset']``,
    else ``name``, in the port's ``PRESETS``. Each key under ``reduced`` (a
    cut of the published deployment) and under ``changed`` (a value from
    another published source, with its ``source``) gives the preset's value
    as ``published`` and the file's as ``here``; every other field of the
    port's ``Config`` that the file sets equals the preset's, and the file
    sets each of :data:`STATED`."""
    import dataclasses

    from cyclegan_tpu_torch.utils.config import PRESETS, Config

    preset = PRESETS.get(body.get("preset", name))
    if preset is None:
        return [f"no preset {body.get('preset', name)!r} in the port's PRESETS"]
    reduced, changed = body.get("reduced", {}), body.get("changed", {})
    out = [f"{k}: both reduced and changed" for k in sorted(set(reduced) & set(changed))]
    out += [f"{k}: a width, never cut" for k in WIDTHS if k in reduced]
    for kind, listed in (("reduced", reduced), ("changed", changed)):
        for key, entry in listed.items():
            if not hasattr(preset, key):
                out.append(f"{kind} {key}: no field of Config")
                continue
            if entry.get("published") != getattr(preset, key):
                out.append(f"{kind} {key}: published {entry.get('published')!r}, the preset "
                           f"has {getattr(preset, key)!r}")
            if body.get(key) != entry.get("here"):
                out.append(f"{kind} {key}: here {entry.get('here')!r}, the file has "
                           f"{body.get(key)!r}")
            if kind == "changed" and not str(entry.get("source", "")).strip():
                out.append(f"changed {key}: no source")
    fields = {f.name for f in dataclasses.fields(Config)}
    out += [f"{k}: not stated" for k in STATED if k not in body]
    for key in sorted(fields & set(body) - set(reduced) - set(changed)):
        if body[key] != getattr(preset, key):
            out.append(f"{key}: {body[key]!r}, the preset has {getattr(preset, key)!r}, and "
                       f"neither reduced nor changed lists it")
    return out


def load_reader(metric: str):
    path = BENCH_DIR / "metrics" / f"{metric}.py"
    spec = importlib.util.spec_from_file_location("portbench_metric_" + metric.replace(".", "_"),
                                                  path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod.read


def forbidden_loaded() -> list:
    return sorted({m.split(".", 1)[0] for m in sys.modules} & set(FORBIDDEN))


def process_age_s() -> float | None:
    """Seconds since this process started, from /proc (None elsewhere)."""
    try:
        with open("/proc/self/stat") as f:
            start_ticks = int(f.read().rsplit(")", 1)[1].split()[19])
        with open("/proc/stat") as f:
            btime = next(int(line.split()[1]) for line in f if line.startswith("btime"))
    except (OSError, ValueError, StopIteration, IndexError):
        return None
    return time.time() - (btime + start_ticks / os.sysconf("SC_CLK_TCK"))


@dataclasses.dataclass
class Context:
    """What a traffic driver gets: the cell, the run's arguments, the
    configuration as run (the config file's fields, then the cell's
    ``config_overrides``), the traffic's parameters and the limits."""
    cell: Cell
    seed: int
    seconds: float
    trace: bool
    device: object
    cfg: dict
    params: dict
    limits: dict
    started: float                    # perf_counter at process start
    setup_s: float | None = None
    phases: list = dataclasses.field(default_factory=list)

    def mark(self, phase: str) -> None:
        """Note that set-up ``phase`` ended now (printed on standard error)."""
        self.phases.append((phase, time.perf_counter() - self.started))

    def window_open(self) -> None:
        """Call once, when set-up is over and the window begins."""
        self.mark("set-up")
        self.setup_s = time.perf_counter() - self.started


def make_context(cell: Cell, seed: int, seconds: float, trace: bool, device,
                 started: float, overrides: dict | None = None) -> Context:
    overrides = overrides or {}
    cfg = {**cell.config, **cell.workload.get("config_overrides", {}),
           **overrides.get("config", {})}
    params = {**cell.workload["params"], **overrides.get("params", {})}
    return Context(cell, seed, seconds, trace, device, cfg, params,
                   dict(cell.workload["limits"]), started)


def device_info(device, count: int, peak: int) -> dict:
    import torch

    if device.type != "cuda":
        return {"platform": "cpu", "kind": "cpu", "count": 1, "memory_peak_bytes": peak}
    return {"platform": "gpu", "kind": torch.cuda.get_device_name(device), "count": count,
            "memory_peak_bytes": peak}


def power_limit() -> str | None:
    import subprocess

    try:
        out = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                              "--format=csv,noheader"], capture_output=True, text=True,
                             timeout=30)
    except (OSError, subprocess.TimeoutExpired):
        return None
    return out.stdout.strip().splitlines()[0] if out.returncode == 0 and out.stdout else None


def run_cell(name: str, seed: int, seconds: float, trace: bool, *, device="cuda",
             started: float | None = None, overrides: dict | None = None,
             bench: dict | None = None) -> dict:
    """One run of cell ``name``; returns its result line as a dict."""
    import torch

    started = time.perf_counter() if started is None else started
    cell = load_cell(name, bench)
    dev = torch.device(device)
    ctx = make_context(cell, seed, seconds, trace, dev, started, overrides)
    driver = importlib.import_module(f"portbench.traffic.{cell.workload['kind']}")
    ctx.mark("imports")
    out = driver.run(ctx)
    ctx.mark("check")
    print("phases (s since start): " + ", ".join(f"{k} {v:.3f}" for k, v in ctx.phases),
          file=sys.stderr)
    correct = bool(out["correct"]) and out["failed"] == 0
    info = device_info(dev, cell.entry["chips"], out["memory_peak_bytes"])
    result = {"correct": correct, "attempted": out["attempted"], "failed": out["failed"]}
    if trace:
        obs = out["obs"]
        metrics = {}
        for m in cell.per_layer:
            v = load_reader(m["name"])(obs)
            if v is not None and math.isfinite(v):
                metrics[m["name"]] = {"value": v, "unit": m["unit"]}
        from portbench import trace as T

        if obs.trace is not None:
            info["busy_s"] = T.busy_seconds(obs.trace)
            info["window_s"] = obs.trace.window_s
            result["breakdown"] = T.breakdown(obs.trace)
    else:
        values = {**out["e2e"], "setup_s": ctx.setup_s}
        metrics = {}
        for m in cell.end_to_end:
            if values.get(m["name"]) is None:
                raise CellError(f"{name}: the run measured no {m['name']}")
            metrics[m["name"]] = {"value": values[m["name"]], "unit": m["unit"]}
    result.update(metrics=metrics, device=info)
    if dev.type == "cuda":
        info["power_limit"] = power_limit()
    result["checks"] = out["checks"]
    return result


def parse(argv):
    ap = argparse.ArgumentParser(description="Run one cell of BENCHMARK.json once.")
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seed", type=int, required=True)
    ap.add_argument("--seconds", type=float, required=True)
    ap.add_argument("--trace", type=int, choices=(0, 1), default=0)
    return ap.parse_args(argv)


def main(argv, started: float, out) -> int:
    """The command: checks the cards, runs the cell, prints the line to
    ``out`` (the process's real standard output) and the checks last on
    standard error."""
    args = parse(argv)
    import torch

    bench = manifest()
    entry = find(bench["workloads"], args.workload, "workload")
    if not torch.cuda.is_available() or torch.cuda.device_count() < entry["chips"]:
        print(f"portbench: {args.workload} needs {entry['chips']} CUDA device(s); "
              f"found {torch.cuda.device_count() if torch.cuda.is_available() else 0}",
              file=sys.stderr)
        return 2
    result = run_cell(args.workload, args.seed, args.seconds, bool(args.trace),
                      started=started, bench=bench)
    bad = forbidden_loaded()
    if bad:
        print(f"portbench: the run loaded {bad}: the benchmark measures the port alone",
              file=sys.stderr)
        return 3
    print(f"device {result['device'].get('kind')} power {result['device'].get('power_limit')}",
          file=sys.stderr)
    for k, c in result["checks"].items():
        print(f"{k} {c['value']!r} limit {c['limit']!r}", file=sys.stderr)
    sys.stderr.flush()
    out.write(json.dumps(result) + "\n")
    out.flush()
    return 0
