"""``correct`` fails where it must: the control (the reference in fp8 in
the program's place) and each fault the cells can have, planted under a
run that skips the look for a card."""

import json
import os
import subprocess
import sys

import pytest
import torch

from portbench import compare, faults, harness
from portbench.reference.precision import PRECISIONS
from portbench.tests import tiny
from portbench.traffic import serve as S
from portbench.traffic import train as T

torch.set_num_threads(4)
SEED = 2 ** 31 + 77


def ctx_of(cell, device="cpu", overrides=None):
    c = harness.load_cell(cell)
    return harness.make_context(c, SEED, 0.0, False, torch.device(device), 0.0,
                                tiny.overrides(cell) if overrides is None else overrides)


@pytest.mark.parametrize("cell", tiny.TRAIN_CELLS)
def test_control_fails_train(cell):
    ctx = ctx_of(cell)
    ref = T.reference_readings(ctx)
    low = T.reference_readings(ctx, q=PRECISIONS["fp8_e4m3"])
    ok, checks = compare.verdict(T.numbers(low, ref), ctx.limits)
    assert not ok, checks


def test_control_fails_serve():
    ctx = ctx_of("voc_semisup_256.serve_tta", overrides=tiny.SERVE_WIDE)
    canvases = list(range(ctx.params["ring"]))
    ref = S.reference_logits(ctx, canvases)
    low = S.reference_logits(ctx, canvases, q=PRECISIONS["fp8_e4m3"])
    answers = [(i, low[i].argmax(-1).to(torch.uint8).numpy()) for i in canvases]
    ok, checks = compare.verdict(S.numbers(answers, ref), ctx.limits)
    assert not ok, checks


def _run(cell):
    return harness.run_cell(cell, SEED, 0.3, False, device="cpu",
                            overrides=tiny.overrides(cell))


@pytest.mark.parametrize("fault", sorted(faults.TRAIN))
@pytest.mark.parametrize("cell", tiny.TRAIN_CELLS)
def test_fault_train(cell, fault):
    """A step that returns its state unchanged, half of each batch, a pool
    that never swaps, a schedule that never decays."""
    with faults.TRAIN[fault]():
        assert _run(cell)["correct"] is False


def test_fault_answer_altered():
    with faults.answer_altered():
        assert _run("voc_semisup_256.serve_tta")["correct"] is False


@pytest.mark.cuda
@pytest.mark.parametrize("cell", tiny.TRAIN_CELLS + tiny.SERVE_CELLS)
def test_control_fails_at_the_cells_size_on_the_card(cell, tmp_path):
    """The control and (train) the half-batch, never-swap and no-decay
    faults on three seeds at the cell's own size fail the cell's limits
    (portbench/calibrate.py)."""
    if not torch.cuda.is_available():
        pytest.skip("needs the card: the control at the cell's size")
    out = tmp_path / "calib.jsonl"
    seeds = "3,4,5"
    args = [sys.executable, "portbench/calibrate.py", "--workload", cell, "--control", seeds,
            "--out", str(out)]
    if cell in tiny.TRAIN_CELLS:
        args += ["--fault", seeds, "--planted", f"never_swap:{seeds}",
                 "--planted", f"no_decay:{seeds}"]
    subprocess.run(args, cwd=harness.ROOT, check=True, timeout=1800,
                   env={**os.environ, "PYTHONPATH": str(harness.ROOT)})
    limits = harness.load_cell(cell).workload["limits"]
    for line in out.read_text().splitlines():
        rec = json.loads(line)
        for part in ("control", "half_batch", "never_swap", "no_decay"):
            if part in rec and "summary" not in rec:
                assert not compare.verdict(rec[part], limits)[0], (rec["seed"], part, rec[part])
