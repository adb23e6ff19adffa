"""``--model supervised`` through the port's runner and CLI, on the CPU.

- ``python -m cyclegan_tpu_torch.main --training --model supervised`` on
  the synthetic dataset (``--device cpu``): two epochs of one step, a
  preemption after the first step and a resume from its mid-epoch
  checkpoint end bitwise in the state of an uninterrupted run, and
  ``--testing`` scores what the last validation scored.
- ``run_supervised`` against the JAX ``run_supervised`` from the JAX
  initial weights (bridged in) on the same loader stream: the logged
  ``ce_loss`` of each step within rtol 2e-3 and the last validation's mIoU
  and pixel accuracy within 1e-4. Instance norm: under batch norm the
  eval-mode logits read the biases before each norm, which Adam moves by
  about +-lr a step on gradients that are rounding noise (zero in exact
  arithmetic), so the two runs' argmax differ at near-tied pixels (2.3e-4
  of mIoU apart after 4 steps on an x86 CPU); the CLI case above
  runs batch norm.
- ``--testing`` with ``--eval_resize tile``, ``--eval_flip`` and
  ``--eval_scales 0.75,1.0,1.25`` on the same weights in both packages'
  checkpoints: mIoU and pixel accuracy within 1e-4 of the JAX runner's.
"""

import json
import os

import jax
import numpy as np
import pytest
import torch

from cyclegan_tpu.train import checkpoint as jck
from cyclegan_tpu.train import runner as jrunner
from cyclegan_tpu.train.supervised import SupervisedTrainer as JaxTrainer
from cyclegan_tpu.utils import config as jconfig
from cyclegan_tpu_torch import weights
from cyclegan_tpu_torch.main import main
from cyclegan_tpu_torch.train import checkpoint as ck
from cyclegan_tpu_torch.train import runner
from cyclegan_tpu_torch.utils.config import Config


@pytest.fixture(autouse=True, scope="module")
def _few_torch_threads():
    """Two intra-op threads: the suite runs several workers on one host."""
    n = torch.get_num_threads()
    torch.set_num_threads(2)
    yield
    torch.set_num_threads(n)


def _flags(tmp_path, name: str) -> list:
    return ["--model", "supervised", "--device", "cpu", "--dataset", "synthetic",
            "--dataset_size", "2", "--batch_size", "2", "--gen_net", "resnet_2blocks",
            "--ngf", "4", "--crop_height", "32", "--crop_width", "32", "--no_bf16",
            "--norm", "batch", "--use_dropout", "true", "--epochs", "2", "--decay_epoch", "1",
            "--log_every", "1", "--seed", "3",
            "--checkpoint_dir", str(tmp_path / name / "ckpt"),
            "--results_dir", str(tmp_path / name / "res")]


def _logged(results_dir, key="ce_loss") -> list:
    with open(os.path.join(results_dir, "train_metrics.jsonl")) as f:
        return [(r["step"], r[key]) for r in map(json.loads, f)]


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


def test_cli_trains_resumes_and_tests(tmp_path, monkeypatch, capsys):
    monkeypatch.delenv("CYCLEGAN_TPU_PREEMPT_AT_STEP", raising=False)
    ref_val = main(["--training"] + _flags(tmp_path, "ref"))
    assert {"miou", "pixel_acc"} <= set(ref_val)
    flags = _flags(tmp_path, "res") + ["--save_every_steps", "1"]
    monkeypatch.setenv("CYCLEGAN_TPU_PREEMPT_AT_STEP", "1")
    assert main(["--training"] + flags).get("preempted") is True
    monkeypatch.delenv("CYCLEGAN_TPU_PREEMPT_AT_STEP")
    last_val = main(["--training"] + flags)
    assert "resumed mid-epoch" in capsys.readouterr().out
    final = {n: ck.CheckpointManager(str(tmp_path / n / "ckpt")).restore()[0]
             for n in ("ref", "res")}
    assert final["ref"]["step"] == 2 and "running_mean" in " ".join(final["ref"]["nets"]["model"])
    _equal(final["res"], final["ref"])
    assert _logged(tmp_path / "res" / "res") == _logged(tmp_path / "ref" / "res")
    assert last_val["miou"] == ref_val["miou"]
    scores = main(["--testing"] + flags)
    for key in ("miou", "pixel_acc"):
        assert scores[key] == pytest.approx(last_val[key], abs=1e-6)
    assert len(list((tmp_path / "res" / "res").glob("pred_*.png"))) == 40


KW = dict(dataset="synthetic", dataset_size=4, resize_height=32, resize_width=32,
          gen_net="resnet_6blocks", ngf=4, crop_height=32, crop_width=32,
          batch_size=2, bf16=False, epochs=2, decay_epoch=1, log_every=1, seed=3,
          num_devices=1)


def _bridged(monkeypatch, variables):
    class Bridged(runner.SupervisedTrainer):
        def init_state(self, generator):
            state = super().init_state(generator)
            weights.load_flax_module(self.model, variables)
            return state

    monkeypatch.setattr(runner, "SupervisedTrainer", Bridged)


def test_run_supervised_matches_jax_runner(tmp_path, monkeypatch):
    jcfg = jconfig.Config(checkpoint_dir=str(tmp_path / "j" / "ckpt"),
                          results_dir=str(tmp_path / "j" / "out"), **KW)
    ref = jrunner.run_supervised(jcfg)
    js = JaxTrainer(jcfg, 21, 3, 2).init_state(jax.random.PRNGKey(jcfg.seed))
    _bridged(monkeypatch, jax.device_get(js.params))
    tcfg = Config(checkpoint_dir=str(tmp_path / "t" / "ckpt"),
                  results_dir=str(tmp_path / "t" / "out"), **KW)
    got = runner.run_supervised(tcfg, device="cpu")
    t_log, j_log = _logged(tcfg.results_dir), _logged(jcfg.results_dir)
    assert [s for s, _ in t_log] == [s for s, _ in j_log] == [1, 2, 3, 4]
    np.testing.assert_allclose([v for _, v in t_log], [v for _, v in j_log], rtol=2e-3)
    for key in ("miou", "pixel_acc"):
        assert got[key] == pytest.approx(ref[key], abs=1e-4), key


def test_testing_with_tile_flip_and_scales_matches_jax(tmp_path):
    kw = dict(KW, eval_resize="tile", resize_height=48, resize_width=40, eval_flip=True,
              eval_scales="0.75,1.0,1.25", crop_height=24, crop_width=24)
    jcfg = jconfig.Config(checkpoint_dir=str(tmp_path / "j" / "ckpt"),
                          results_dir=str(tmp_path / "j" / "out"), **kw)
    jt = JaxTrainer(jcfg, 21, 3, 1)
    js = jt.init_state(jax.random.PRNGKey(1))
    mngr = jck.CheckpointManager(jcfg.checkpoint_dir)
    mngr.save(0, jax.device_get(js))
    mngr.wait()
    mngr.close()
    ref = jrunner.run_test(jcfg, semisupervised=False)
    tcfg = Config(checkpoint_dir=str(tmp_path / "t" / "ckpt"),
                  results_dir=str(tmp_path / "t" / "out"), **kw)
    tt = runner.SupervisedTrainer(tcfg, 21, 3, 1, device="cpu")
    ts = tt.init_state(torch.Generator().manual_seed(0))
    weights.load_flax_module(tt.model, jax.device_get(js.params))
    ck.CheckpointManager(tcfg.checkpoint_dir).save(0, ck.state_payload(tt, ts))
    got = runner.run_test(tcfg, semisupervised=False, device="cpu")
    for key in ("miou", "pixel_acc"):
        assert got[key] == pytest.approx(ref[key], abs=1e-4), key
    assert len(os.listdir(tcfg.results_dir)) == len(os.listdir(jcfg.results_dir)) == 40
