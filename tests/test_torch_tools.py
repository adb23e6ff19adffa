"""The port's measurement tools, cheaply, on the CPU.

- ``tools/torch_quantize_miou_run.py``: trains the port's segmenter a few
  steps, exports float32 / bf16 / int8 through ``run_export`` and serves
  each with GT scoring; the quantised artifacts are smaller (int8 below
  1/2.5, bf16 below 1/1.5 of float32) and serve nearly the same maps.
- ``tools/torch_miou_parity_run.py`` and ``tools/torch_cyclegan_parity_run.py``
  (port against JAX) run a few steps and report what their protocols hold:
  the CycleGAN trajectory's mean G-loss gap under the 1% bar on each leg.
- ``tools/soak_summary.py``, unchanged, summarises the
  ``train_metrics.jsonl`` the port's runner writes; the port's
  ``tools/torch_soak_summary.py`` gives that tool's summary and lists the
  port's ``<n>.pt`` / ``<n>.json`` checkpoints, epoch and mid-epoch.
- ``tools/torch_http_bench.py`` (the counterpart of
  ``tests/test_tools_round5.py::test_http_bench_cli``) drives the port's
  endpoint on a tiny artifact with ``--device cpu`` and prints its JSON
  record.
"""

import json
import math
import subprocess
import sys
from pathlib import Path

import pytest
import torch

from cyclegan_tpu_torch import export
from cyclegan_tpu_torch.main import main as cli
from cyclegan_tpu_torch.models.generators import define_Gen
from tools import (torch_cyclegan_parity_run, torch_miou_parity_run, torch_quantize_miou_run,
                   torch_soak_summary)
from tools.soak_summary import summarize


@pytest.fixture(autouse=True, scope="module")
def _few_torch_threads():
    """Two intra-op threads: the suite runs several workers on one host."""
    n = torch.get_num_threads()
    torch.set_num_threads(2)
    yield
    torch.set_num_threads(n)


def test_quantize_miou_run_on_the_cpu(tmp_path):
    out = torch_quantize_miou_run.train_and_measure(
        4, 32, 8, 2, 21, str(tmp_path), device="cpu", gen_net="resnet_2blocks", val_images=4)
    assert json.loads(json.dumps(out)) == out
    for name in ("f32", "bf16", "int8"):
        assert 0.0 <= out[f"miou_{name}"] <= 1.0
    assert out["bytes_int8"] < out["bytes_f32"] / 2.5
    assert out["bytes_bf16"] < out["bytes_f32"] / 1.5
    assert out["agreement_bf16"] > 0.9 and out["agreement_int8"] > 0.9
    assert out["delta_int8"] == out["miou_int8"] - out["miou_f32"]
    assert 0.0 < out["miou_background_only"] < 1.0
    assert math.isfinite(out["final_ce_loss"])


def test_quantize_miou_run_refuses_without_a_card(monkeypatch, capsys):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    assert torch_quantize_miou_run.main([]) == 1
    assert "no CUDA device" in capsys.readouterr().err


def test_miou_parity_run_reports_its_gate():
    out = torch_miou_parity_run.run(steps=3, size=32, ngf=4, n_blocks=2, batch=2, classes=21,
                                    val_images=4)
    assert out["delta"] == out["jax_miou"] - out["port_miou"]
    assert out["within_gate"] == (abs(out["delta_pt"]) <= 0.5)
    assert 0.0 < out["background_only_miou"] < 1.0 and 0.0 <= out["argmax_agreement"] <= 1.0
    assert abs(out["jax_final_ce"] - out["port_final_ce"]) < 1e-2 * abs(out["jax_final_ce"])


@pytest.mark.parametrize("leg", [{}, {"channels": 1, "classes": 4},
                                 {"gen_net": "unet", "dis_net": "pixel"}, {"norm": "batch"}])
def test_cyclegan_parity_run_legs(leg):
    out = torch_cyclegan_parity_run.run(steps=3, val_images=4, **leg)
    assert out["within_gate"] and out["mean_rel_divergence"] < 0.01, out
    assert out["val_argmax_agreement"] > 0.8, out


def test_soak_summary_reads_the_port_runner_log(tmp_path):
    flags = ["--training", "--device", "cpu", "--no_bf16", "--ngf", "4", "--ndf", "4",
             "--gen_net", "resnet_2blocks", "--crop_height", "32", "--crop_width", "32",
             "--dataset", "synthetic", "--dataset_size", "8", "--labeled_fraction", "0.5",
             "--batch_size", "2", "--pool_size", "2", "--epochs", "2", "--decay_epoch", "1",
             "--log_every", "1", "--checkpoint_dir", str(tmp_path / "ck"),
             "--results_dir", str(tmp_path / "res")]
    cli(flags)
    out = summarize(str(tmp_path / "res"))
    rows = [json.loads(ln) for ln in open(tmp_path / "res" / "train_metrics.jsonl")]
    assert out["rows"] == len(rows) >= 4
    assert out["epochs_seen"] == [0, 1] and out["nonfinite_values"] == 0
    for k in ("g_total", "d_total"):
        assert out[f"{k}_first"] == round(rows[0][k], 3)
        assert out[f"{k}_last"] == round(rows[-1][k], 3)
    assert out["sustained_steps_per_sec"]["n_intervals"] >= 1


def test_torch_soak_summary_lists_the_port_checkpoints(tmp_path):
    """On a tiny CPU run that saved epochs 0 and 1 and a mid-epoch
    checkpoint at step 3: the JSONL summary is the JAX-side tool's; the
    inventory lists the saved pairs with their optimizer steps (the
    JAX-side tool's lists Orbax step directories and finds none), and a
    pair missing its .json."""
    ck, res = tmp_path / "ck", tmp_path / "res"
    cli(["--training", "--device", "cpu", "--no_bf16", "--ngf", "4", "--ndf", "4",
         "--gen_net", "resnet_2blocks", "--crop_height", "32", "--crop_width", "32",
         "--dataset", "synthetic", "--dataset_size", "8", "--labeled_fraction", "0.5",
         "--batch_size", "2", "--pool_size", "2", "--epochs", "2", "--decay_epoch", "1",
         "--log_every", "1", "--save_every_steps", "3", "--checkpoint_dir", str(ck),
         "--results_dir", str(res)])
    ref = summarize(str(res), str(ck))
    out = torch_soak_summary.summarize(str(res), str(ck))
    assert (ref["epoch_ckpts"], ref["mid_ckpts"]) == ([], [])
    assert out["sustained_steps_per_sec"]["n_intervals"] >= 1
    assert (out["epoch_ckpts"], out["epoch_ckpt_steps"]) == ([0, 1], {0: 2, 1: 4})
    assert (out["mid_ckpts"], out["mid_ckpt_steps"]) == ([3], {3: 3})
    assert out["unpaired_ckpt_files"] == []
    (ck / "1.json").unlink()
    again = torch_soak_summary.checkpoint_inventory(str(ck))
    assert again["epoch_ckpts"] == [0] and again["unpaired_ckpt_files"] == ["1.pt"]
    r = subprocess.run([sys.executable, "tools/torch_soak_summary.py", str(res), str(ck)],
                       capture_output=True, text=True, timeout=300,
                       cwd=str(Path(__file__).resolve().parent.parent))
    assert r.returncode == 0 and json.loads(r.stdout)["mid_ckpts"] == [3], r.stderr


def test_http_bench_cli(tmp_path):
    """The load bench drives the port's endpoint end to end and reports a
    complete JSON record (req/s, percentiles, realised batch size)."""
    g = define_Gen(3, 5, 8, "resnet_2blocks", head="none",
                   generator=torch.Generator().manual_seed(0))
    art = export.export_generator(g, str(tmp_path / "m"), gen_net="resnet_2blocks", ngf=8,
                                  num_classes=5, in_channels=3, crop_hw=(32, 32),
                                  dtype="float32")
    root = Path(__file__).resolve().parent.parent
    r = subprocess.run([sys.executable, "tools/torch_http_bench.py", art, "--clients", "3",
                        "--requests", "4", "--max_batch", "4", "--device", "cpu"],
                       capture_output=True, text=True, timeout=600, cwd=str(root))
    assert r.returncode == 0, f"{r.stdout}\n{r.stderr}"
    out = json.loads(r.stdout.strip().splitlines()[-1])
    assert out["clients"] == 3 and out["requests_per_client"] == 4
    assert out["device"] == "cpu" and out["req_per_s"] > 0
    assert out["latency_ms"]["p50"] <= out["latency_ms"]["p99"] <= out["latency_ms"]["max"]
    assert 1.0 <= out["mean_batch"] <= 4.0
