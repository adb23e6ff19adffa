"""Readings that set the limits of ``correct``: the program, the control
and the faults over many seeds, in one process.

    python3 portbench/calibrate.py --workload NAME --seeds 11,12,... \
        [--control 11,12,13] [--fault 11,12,13] [--out FILE]

For each seed of ``--seeds`` the program is set up as a run sets it up (a
train cell takes its check steps; a serve cell serves ``calib_batches``
batches and samples its answers as a run does) and compared with the
float32 reference. For each seed of ``--control`` the reference computed
in fp8 (``reference.precision.PRECISIONS["fp8_e4m3"]``) takes the
program's place (a serve cell also serves the port's weight-only int8
artifact); for each of ``--fault`` (train cells) the reference on half of
each batch's rows does, and for each of ``--witness`` (train cells) the
reference in bf16. ``--planted NAME:SEEDS`` (train cells, repeatable) sets
the program up under the fault ``portbench.faults.TRAIN[NAME]`` on those
seeds. Each reading is a JSON line on standard output (and in ``--out``);
the last line sums them up: the largest program reading and the smallest
control and fault readings of each number. Needs the card, as a run does.
Not part of a run.
"""

import argparse
import importlib
import json
import os
import sys
import time

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def _seeds(s):
    return [int(x) for x in s.split(",") if x] if s else []


def main(argv=None) -> int:
    ap = argparse.ArgumentParser()
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seeds", default="")
    ap.add_argument("--control", default="")
    ap.add_argument("--fault", default="")
    ap.add_argument("--witness", default="", help="seeds of the bf16 reference (train)")
    ap.add_argument("--planted", action="append", default=[],
                    help="NAME:SEEDS, a fault of portbench.faults.TRAIN planted in the program")
    ap.add_argument("--out", default=None)
    args = ap.parse_args(argv)
    sys.path.insert(0, ROOT)
    import torch

    from portbench import faults, harness
    from portbench.reference.precision import PRECISIONS

    cell = harness.load_cell(args.workload)
    dev = torch.device("cuda")
    kind = cell.workload["kind"]
    drv = importlib.import_module(f"portbench.traffic.{kind}")
    fp8 = PRECISIONS["fp8_e4m3"]
    lines = []

    def emit(rec):
        lines.append(rec)
        print(json.dumps(rec), flush=True)
        if args.out:
            with open(args.out, "a") as f:
                f.write(json.dumps(rec) + "\n")

    seeds = _seeds(args.seeds)
    control, fault = _seeds(args.control), _seeds(args.fault)
    witness = _seeds(args.witness)
    planted = {name: _seeds(s) for name, s in (p.split(":", 1) for p in args.planted)}
    every = set(seeds) | set(control) | set(fault) | set(witness)
    for seed in sorted(every.union(*planted.values())):
        ctx = harness.make_context(cell, seed, 0.0, False, dev, time.perf_counter())
        t = time.perf_counter()
        rec = {"seed": seed}
        if kind == "train":
            ref = drv.reference_readings(ctx)
            if seed in seeds:
                prog, readings = drv.setup(ctx)
                del prog
                drv.free(dev)
                rec["program"] = drv.numbers(readings, ref)
                rec["program_detail"] = drv.detail(readings, ref)
            if seed in control:
                low = drv.reference_readings(ctx, q=fp8)
                rec["control"], rec["control_detail"] = drv.numbers(low, ref), drv.detail(low, ref)
            if seed in witness:
                w = drv.reference_readings(ctx, q=PRECISIONS["bf16"])
                rec["bf16_reference"], rec["bf16_reference_detail"] = (drv.numbers(w, ref),
                                                                       drv.detail(w, ref))
            if seed in fault:
                half = drv.reference_readings(ctx, rows=ctx.cfg["batch_size"] // 2)
                rec["half_batch"] = drv.numbers(half, ref)
                rec["half_batch_detail"] = drv.detail(half, ref)
            for name, on in planted.items():
                if seed in on:
                    with faults.TRAIN[name]():
                        prog, readings = drv.setup(ctx)
                    del prog
                    drv.free(dev)
                    rec[name] = drv.numbers(readings, ref)
        else:
            def served(quantize=None):
                prog = drv.Program(ctx, quantize)
                for _ in range(ctx.params["warm_batches"]):
                    prog.fetch(prog.submit())
                prog.answers.clear()
                prog.pipelined(batches=ctx.params["calib_batches"])
                answers = drv.sample(prog.answers, ctx)
                del prog
                drv.free(dev)
                return answers

            answers = served()
            canvases = [i for i, _ in answers]
            ref = drv.reference_logits(ctx, canvases)
            if seed in seeds:
                rec["program"] = drv.numbers(answers, ref)
            if seed in control:
                low = drv.reference_logits(ctx, canvases, q=fp8)
                rec["control"] = drv.numbers(
                    [(i, low[i].argmax(-1).to(torch.uint8).cpu().numpy()) for i in canvases], ref)
                # beside it, the port's own weight-only int8 artifact (its
                # compute stays bf16)
                rec["int8_artifact"] = drv.numbers(served("int8"), ref)
        rec["seconds"] = time.perf_counter() - t
        drv.free(dev)
        emit(rec)
    summary = {"workload": args.workload, "summary": True}
    parts = [("program", max), ("control", min), ("half_batch", min), ("int8_artifact", min),
             ("bf16_reference", max)] + [(name, min) for name in planted]
    for part, pick in parts:
        vals = [r[part] for r in lines if part in r]
        if vals:
            summary[part] = {k: pick(v[k] for v in vals) for k in vals[0]}
            summary[part + "_seeds"] = len(vals)
    emit(summary)
    return 0


if __name__ == "__main__":
    sys.exit(main())
