"""The port's CLI with two gloo ranks on the CPU, as ``tests/test_multihost.py``
and ``tests/test_runner_dp8.py`` hold the JAX runner.

``python -m cyclegan_tpu_torch.main --training --device cpu --num_devices 2``
(called as ``main([...])``: the launch spawns two ranks with a ``file://``
store):
- trains, logs each step once and writes one checkpoint set (rank 0
  alone writes), and a second launch resumes from it;
- a run preempted at an injected step and resumed ends bitwise in the
  state of an uninterrupted dp=2 run;
- ``--testing`` on a ragged validation split (40 images, global batch 6:
  the last batch holds 4, rank 1's share one image and two padding rows)
  gives the one-device confusion matrix's scores and the same PNGs;
- the supervised segmenter under ``--norm batch`` trains and tests;
- ``--num_devices 2 --spatial_shards 2`` (one image's H over two ranks)
  trains with validation and sample dumps, checkpoints the pools whole,
  and ``--testing`` of its checkpoint on the two ranks gives the scores and
  PNGs of one process;
- ``--gpu_ids`` maps to ``--num_devices``, and a ``--spatial_shards`` that
  does not divide the devices raises before any rank starts.

No rank outlives its test.
"""

from __future__ import annotations

import json
import multiprocessing
import os

import numpy as np
import pytest
import torch

from cyclegan_tpu_torch import main as cli
from cyclegan_tpu_torch.train import checkpoint as ck

STEPS_PER_EPOCH = 2  # dataset_size 8, labeled_fraction 0.5, global batch 2, zip


@pytest.fixture(autouse=True)
def _no_child_left_behind():
    yield
    assert multiprocessing.active_children() == []


@pytest.fixture(autouse=True)
def _two_threads_a_rank(monkeypatch):
    """CPU ranks take ``OMP_NUM_THREADS`` threads each (else the host's
    cores over the ranks): one keeps the suite's workers from
    oversubscribing the host (the tiny runs take as long as with two). The
    one-process runs take two. A collective that waits two minutes fails
    its rank."""
    monkeypatch.setenv("OMP_NUM_THREADS", "1")
    monkeypatch.setenv("CYCLEGAN_TPU_DIST_TIMEOUT", "120")  # a lost rank fails its test
    monkeypatch.delenv("CYCLEGAN_TPU_PREEMPT_AT_STEP", raising=False)
    n = torch.get_num_threads()
    torch.set_num_threads(2)
    yield
    torch.set_num_threads(n)


def _flags(tmp, name: str, *extra: str) -> list[str]:
    return ["--device", "cpu", "--dataset", "synthetic", "--dataset_size", "8",
            "--labeled_fraction", "0.5", "--gen_net", "resnet_2blocks", "--ngf", "4",
            "--ndf", "4", "--crop_height", "32", "--crop_width", "32", "--batch_size", "2",
            "--pool_size", "4", "--no_bf16", "--epochs", "2", "--decay_epoch", "1",
            "--validation_every", "0", "--log_every", "1", "--seed", "3",
            "--save_every_steps", "2", "--checkpoint_dir", str(tmp / name / "ckpt"),
            "--results_dir", str(tmp / name / "out"), *extra]


def _logged(tmp, name: str) -> list[tuple[int, float]]:
    with open(tmp / name / "out" / "train_metrics.jsonl") as f:
        return [(r["step"], r["g_total"]) for r in map(json.loads, f)]


def _final(tmp, name: str) -> dict:
    payload, _ = ck.CheckpointManager(str(tmp / name / "ckpt")).restore()
    return payload


def _equal(a, b, path=""):
    if isinstance(a, dict):
        assert a.keys() == b.keys(), path
        for k in a:
            _equal(a[k], b[k], f"{path}/{k}")
    elif isinstance(a, torch.Tensor):
        assert a.dtype == b.dtype and torch.equal(a, b), path
    elif isinstance(a, (list, tuple)):
        for i, (x, y) in enumerate(zip(a, b)):
            _equal(x, y, f"{path}[{i}]")
    else:
        assert a == b, (path, a, b)


def test_dp2_cli_trains_checkpoints_once_and_resumes(tmp_path, capfd):
    cli.main(["--training", "--num_devices", "2"] + _flags(tmp_path, "a", "--epochs", "1"))
    assert [s for s, _ in _logged(tmp_path, "a")] == [1, 2]  # one line a step
    ckpt = tmp_path / "a" / "ckpt"
    assert sorted(os.listdir(ckpt)) == ["0.json", "0.pt", "mid"]
    assert sorted(os.listdir(ckpt / "mid")) == ["2.json", "2.pt"]
    assert not [p for p in ckpt.rglob("*") if p.name.endswith(".tmp")]
    assert _final(tmp_path, "a")["step"] == STEPS_PER_EPOCH
    capfd.readouterr()
    cli.main(["--training", "--num_devices", "2"] + _flags(tmp_path, "a"))
    out = capfd.readouterr().out
    assert out.count("resumed from epoch 0") == 1  # rank 0 alone prints
    assert [s for s, _ in _logged(tmp_path, "a")] == [1, 2, 3, 4]
    assert _final(tmp_path, "a")["step"] == 2 * STEPS_PER_EPOCH


def test_dp2_cli_preempted_run_resumes_to_the_uninterrupted_one(tmp_path, monkeypatch):
    cli.main(["--training", "--num_devices", "2"] + _flags(tmp_path, "a"))
    monkeypatch.setenv("CYCLEGAN_TPU_PREEMPT_AT_STEP", "3")
    assert cli.main(["--training", "--num_devices", "2"]
                    + _flags(tmp_path, "b")).get("preempted") is True
    assert ck.CheckpointManager(str(tmp_path / "b" / "ckpt" / "mid")).latest_epoch() == 4
    monkeypatch.delenv("CYCLEGAN_TPU_PREEMPT_AT_STEP")
    assert "preempted" not in cli.main(["--training", "--num_devices", "2"]
                                       + _flags(tmp_path, "b"))
    _equal(_final(tmp_path, "a"), _final(tmp_path, "b"))
    assert _logged(tmp_path, "b") == _logged(tmp_path, "a")


def test_dp2_ragged_validation_equals_one_device(tmp_path):
    cli.main(["--training"] + _flags(tmp_path, "a", "--epochs", "1"))
    scores = {}
    for n in (1, 2):
        res = tmp_path / f"test{n}"
        scores[n] = cli.main(["--testing", "--num_devices", str(n)]
                             + _flags(tmp_path, "a", "--batch_size", "6", "--results_dir",
                                      str(res)))
        assert len(list(res.glob("pred_*.png"))) == 40
    assert scores[1] == scores[2] and scores[1]["miou"] > 0
    for png in (tmp_path / "test1").glob("pred_*.png"):
        assert png.read_bytes() == (tmp_path / "test2" / png.name).read_bytes()


def test_dp2_supervised_batch_norm_cli_trains_and_tests(tmp_path):
    flags = _flags(tmp_path, "s", "--model", "supervised", "--norm", "batch", "--epochs", "1",
                   "--validation_every", "1")
    res = cli.main(["--training", "--gpu_ids", "0,1"] + flags)
    assert np.isfinite(res["miou"])
    stats = _final(tmp_path, "s")["nets"]["model"]
    assert any(k.endswith("running_mean") and float(v.abs().sum()) > 0 for k, v in stats.items())
    assert cli.main(["--testing", "--gpu_ids", "0,1"] + flags)["miou"] == pytest.approx(
        res["miou"], abs=1e-6)


def test_spatial2_cli_trains_and_tests_as_one_process(tmp_path):
    flags = _flags(tmp_path, "p", "--epochs", "1", "--validation_every", "1")
    res = cli.main(["--training", "--num_devices", "2", "--spatial_shards", "2"] + flags)
    assert np.isfinite(res["miou"])
    assert [s for s, _ in _logged(tmp_path, "p")] == [1, 2]
    assert len(list((tmp_path / "p" / "out").glob("epoch0_sample*_pred.png"))) == 2
    pool = _final(tmp_path, "p")["pool_img"]
    assert tuple(pool["buffer"].shape) == (4, 32, 32, 3)  # the slabs gathered
    scores = {}
    for n, extra in ((1, ()), (2, ("--spatial_shards", "2"))):
        out = str(tmp_path / f"test{n}")
        scores[n] = cli.main(["--testing", "--num_devices", str(n), *extra] + flags
                             + ["--results_dir", out])
        assert len(list((tmp_path / f"test{n}").glob("pred_*.png"))) == 40
    assert scores[2] == scores[1] and scores[1]["miou"] > 0
    for png in (tmp_path / "test1").glob("pred_*.png"):
        assert png.read_bytes() == (tmp_path / "test2" / png.name).read_bytes()


def test_gpu_ids_and_the_spatial_refusal(tmp_path):
    args = cli.get_args(["--training", "--gpu_ids", "0,1,2"])
    assert cli.build_config(args).num_devices == 3
    args = cli.get_args(["--training", "--gpu_ids", "0,1", "--num_devices", "4"])
    assert cli.build_config(args).num_devices == 4
    with pytest.raises(ValueError, match="not divisible by spatial_shards=3"):
        cli.main(["--training", "--preset", "voc_dp8_bf16", "--spatial_shards", "3"]
                 + _flags(tmp_path, "x"))
    assert cli._local_ranks(cli.build_config(cli.get_args(["--num_devices", "2"])),
                            "cpu") == (2, 2, 0)
    cfg = cli.build_config(cli.get_args(["--num_devices", "4", "--num_processes", "2",
                                         "--process_id", "1", "--coordinator_address",
                                         "localhost:1"]))
    assert cli._local_ranks(cfg, "cpu") == (2, 4, 2)
