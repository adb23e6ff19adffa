"""The command's behaviour without a card, and the result line's keys."""

import json
import subprocess
import sys

import pytest
import torch

from portbench import harness
from portbench.tests import tiny


def test_no_card_exits_nonzero_and_prints_nothing(tmp_path):
    out = subprocess.run([sys.executable, "portbench/run.py", "--workload",
                          "voc_dp8_bf16.train", "--seed", str(2 ** 31 + 5), "--seconds", "1",
                          "--trace", "0"], capture_output=True, text=True, cwd=harness.ROOT,
                         env={"CUDA_VISIBLE_DEVICES": "", "PATH": "/usr/bin:/bin",
                              "HOME": str(tmp_path)}, timeout=300)
    assert out.returncode != 0
    assert out.stdout.strip() == ""
    assert "CUDA" in out.stderr


@pytest.mark.parametrize("trace", [0, 1])
@pytest.mark.parametrize("cell", tiny.TRAIN_CELLS + tiny.SERVE_CELLS)
def test_result_line_keys(cell, trace):
    torch.set_num_threads(4)
    r = harness.run_cell(cell, 99, 0.3, bool(trace), device="cpu",
                         overrides=tiny.overrides(cell))
    keys = ["correct", "attempted", "failed"] + (["breakdown"] if trace else []) \
        + ["metrics", "device", "checks"]
    assert list(r) == keys
    assert set(r["device"]) >= {"platform", "kind", "count", "memory_peak_bytes"}
    c = harness.load_cell(cell)
    want = {m["name"] for m in (c.per_layer if trace else c.end_to_end)}
    assert set(r["metrics"]) <= want
    if not trace:
        assert set(r["metrics"]) == want
    else:
        # on the CPU no device metric is written: only host-clock readings
        # and the program's spans, timed on the host
        assert all(m["source"] in ("host_clock", "program_span")
                   for m in c.per_layer if m["name"] in r["metrics"])
        assert set(r["breakdown"]) == {"device_ops", "idle_gaps"}
    json.dumps(r)
