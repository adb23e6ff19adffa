"""The port's epoch runner (``train/runner.py``), on the CPU.

- A run preempted mid-epoch (``CYCLEGAN_TPU_PREEMPT_AT_STEP``) and resumed
  ends bitwise in the state of an uninterrupted run, as
  ``tests/test_preempt_resume.py`` holds the JAX runner: the loader's
  per-(seed, epoch, position) draws, the generators' states, the
  schedulers' ``last_epoch`` and Adam's step counts make it exact.
- A stale mid-epoch checkpoint is ignored; a ``steps_per_call`` change is
  refused.
- ``--max_steps`` inside an epoch saves a mid-epoch checkpoint that holds
  its position, never the epoch checkpoint (a deliberate divergence from
  the JAX runner, which saves the cut epoch as complete).
- ``run_cyclegan`` against the JAX ``run_cyclegan`` at pool 0, the JAX
  initial weights bridged in: the per-step logged ``g_total`` within rtol
  2e-3 (the 3-step bar; 4 steps here).
"""

from __future__ import annotations

import json
import os
import signal
import subprocess
import sys
import time
from pathlib import Path

import jax
import numpy as np
import pytest
import torch

from cyclegan_tpu.train import runner as jrunner
from cyclegan_tpu.train.cyclegan import CycleGANTrainer as JaxTrainer
from cyclegan_tpu.utils import config as jconfig
from cyclegan_tpu_torch import weights
from cyclegan_tpu_torch.train import checkpoint as ck
from cyclegan_tpu_torch.train import runner
from cyclegan_tpu_torch.utils.config import Config

@pytest.fixture(autouse=True, scope="module")
def _few_torch_threads():
    """Two intra-op threads: the suite runs several workers on one host,
    and torch's default (a thread per core in every worker) oversubscribes
    it many times over."""
    n = torch.get_num_threads()
    torch.set_num_threads(2)
    yield
    torch.set_num_threads(n)


STEPS_PER_EPOCH = 2  # dataset_size 8, labeled_fraction 0.5, batch 2, zip
ROOT = Path(__file__).resolve().parent.parent


def _cfg(tmp: Path, name: str, **kw) -> Config:
    base = dict(dataset="synthetic", dataset_size=8, labeled_fraction=0.5,
                gen_net="resnet_2blocks", crop_height=32, crop_width=32, ngf=4, ndf=4,
                batch_size=2, pool_size=4, bf16=False, epochs=3, decay_epoch=2,
                validation_every=0, log_every=1, seed=3, save_every_steps=2,
                checkpoint_dir=str(tmp / name / "ckpt"), results_dir=str(tmp / name / "out"))
    base.update(kw)
    return Config(**base)


def _final(cfg: Config) -> dict:
    mngr = ck.CheckpointManager(cfg.checkpoint_dir)
    payload, nxt = mngr.restore()
    assert nxt == cfg.epochs
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


def _logged(cfg: Config, key: str = "g_total") -> list:
    with open(os.path.join(cfg.results_dir, "train_metrics.jsonl")) as f:
        return [(r["step"], r[key]) for r in map(json.loads, f)]


@pytest.mark.parametrize("spc", [1, 2])
def test_preempt_resume_bit_identical(tmp_path, monkeypatch, spc):
    """Preempted at optimizer step 3 (mid-epoch 1 at spc 1; a call boundary
    at spc 2), resumed, compared with an uninterrupted run."""
    monkeypatch.delenv("CYCLEGAN_TPU_PREEMPT_AT_STEP", raising=False)
    cfg_a = _cfg(tmp_path, "a", steps_per_call=spc)
    assert "preempted" not in runner.run_cyclegan(cfg_a, device="cpu")
    cfg_b = _cfg(tmp_path, "b", steps_per_call=spc)
    monkeypatch.setenv("CYCLEGAN_TPU_PREEMPT_AT_STEP", "3")
    assert runner.run_cyclegan(cfg_b, device="cpu").get("preempted") is True
    assert ck.CheckpointManager(os.path.join(cfg_b.checkpoint_dir, "mid")).latest_epoch()
    monkeypatch.delenv("CYCLEGAN_TPU_PREEMPT_AT_STEP")
    assert "preempted" not in runner.run_cyclegan(cfg_b, device="cpu")
    a, b = _final(cfg_a), _final(cfg_b)
    _equal(a, b)
    assert a["step"] == cfg_a.epochs * STEPS_PER_EPOCH
    # The logged losses of the two launches are the uninterrupted run's.
    assert _logged(cfg_b) == _logged(cfg_a)


def test_completed_run_ignores_stale_mid_checkpoint(tmp_path, monkeypatch):
    cfg = _cfg(tmp_path, "stale")
    monkeypatch.setenv("CYCLEGAN_TPU_PREEMPT_AT_STEP", "3")
    runner.run_cyclegan(cfg, device="cpu")
    monkeypatch.delenv("CYCLEGAN_TPU_PREEMPT_AT_STEP")
    runner.run_cyclegan(cfg, device="cpu")
    done = _final(cfg)
    assert "preempted" not in runner.run_cyclegan(cfg, device="cpu")  # nothing left to run
    _equal(_final(cfg), done)


def test_mid_resume_refuses_a_steps_per_call_change(tmp_path, monkeypatch):
    monkeypatch.setenv("CYCLEGAN_TPU_PREEMPT_AT_STEP", "2")
    assert runner.run_cyclegan(_cfg(tmp_path, "spc", steps_per_call=2, epochs=2,
                                    decay_epoch=1), device="cpu").get("preempted")
    monkeypatch.delenv("CYCLEGAN_TPU_PREEMPT_AT_STEP")
    with pytest.raises(ValueError, match="steps_per_call 2"):
        runner.run_cyclegan(_cfg(tmp_path, "spc", epochs=2, decay_epoch=1), device="cpu")
    assert "preempted" not in runner.run_cyclegan(
        _cfg(tmp_path, "spc", steps_per_call=2, epochs=2, decay_epoch=1), device="cpu")


def test_max_steps_cut_epoch_is_saved_mid_epoch_and_resumed(tmp_path, capsys):
    """The divergence from the JAX runner: --max_steps 3 stops inside epoch
    1; the run holds epoch 0's checkpoint and a mid-epoch one at call 1,
    and a relaunch finishes exactly as an uninterrupted run."""
    kw = dict(save_every_steps=0, epochs=2, decay_epoch=1)
    cfg_a = _cfg(tmp_path, "a", **kw)
    runner.run_cyclegan(cfg_a, device="cpu")
    cfg = _cfg(tmp_path, "cut", **kw)
    runner.run_cyclegan(cfg, max_steps=3, device="cpu")
    assert ck.CheckpointManager(cfg.checkpoint_dir).steps() == [0]
    mid = ck.CheckpointManager(os.path.join(cfg.checkpoint_dir, "mid"))
    assert mid.steps() == [3]
    w, _ = mid.restore()
    assert (w["epoch"], w["pos"], w["state"]["step"]) == (1, 1, 3)
    assert "[max_steps] stopped in epoch 1 at call 1 of 2" in capsys.readouterr().out
    runner.run_cyclegan(cfg, device="cpu")
    assert "resumed mid-epoch 1 at call 1" in capsys.readouterr().out
    _equal(_final(cfg), _final(cfg_a))
    # A cut on an epoch's last call completes the epoch: no mid checkpoint.
    cfg_e = _cfg(tmp_path, "edge", **kw)
    runner.run_cyclegan(cfg_e, max_steps=2, device="cpu")
    assert ck.CheckpointManager(cfg_e.checkpoint_dir).steps() == [0]
    assert not os.path.exists(os.path.join(cfg_e.checkpoint_dir, "mid"))


def test_run_cyclegan_matches_jax_runner(tmp_path, monkeypatch):
    """Both runners at pool 0 from the JAX initial weights, 2 epochs of 2
    steps on the same loader stream; every step logged.

    The train images are resized to the crop (``resize_height/width`` 32),
    so each crop holds the whole synthetic image and several classes. A
    32x32 crop of the 160x160 image can hold only background; its one-hot
    label map is then constant, the first instance norm of G_l2i divides
    float32 rounding noise by sqrt(eps), and any two summation orders (the
    JAX package's and the port's plain versions) give fake images that
    differ at O(1) from the first step on."""
    kw = dict(dataset="synthetic", dataset_size=8, labeled_fraction=0.5, resize_height=32,
              resize_width=32, gen_net="resnet_6blocks", crop_height=32, crop_width=32,
              ngf=4, ndf=4,
              batch_size=2, pool_size=0, bf16=False, epochs=2, decay_epoch=1,
              validation_every=0, log_every=1, seed=3, num_devices=1)
    jcfg = jconfig.Config(checkpoint_dir=str(tmp_path / "j" / "ckpt"),
                          results_dir=str(tmp_path / "j" / "out"), **kw)
    jrunner.run_cyclegan(jcfg)
    js = JaxTrainer(jcfg, 21, 3, STEPS_PER_EPOCH).init_state(jax.random.PRNGKey(jcfg.seed))

    class Bridged(runner.CycleGANTrainer):
        def init_state(self, generator):
            state = super().init_state(generator)
            weights.load_flax_cyclegan(self, js)
            return state

    monkeypatch.setattr(runner, "CycleGANTrainer", Bridged)
    tcfg = Config(checkpoint_dir=str(tmp_path / "t" / "ckpt"),
                  results_dir=str(tmp_path / "t" / "out"), **kw)
    runner.run_cyclegan(tcfg, device="cpu")
    got, ref = _logged(tcfg), _logged(jcfg)
    assert [s for s, _ in got] == [s for s, _ in ref] == [1, 2, 3, 4]
    np.testing.assert_allclose([v for _, v in got], [v for _, v in ref], rtol=2e-3)


@pytest.mark.parametrize("extra", [dict(grad_accum=2), dict(loader="grain", pairing="cycle")])
def test_stacked_and_grain_runs_train_and_log(tmp_path, extra):
    cfg = _cfg(tmp_path, "x", epochs=1, decay_epoch=1, validation_every=1, **extra)
    res = runner.run_cyclegan(cfg, device="cpu")
    assert {"miou", "pixel_acc", "seconds"} <= set(res)
    steps = 1 if "grad_accum" in extra else 2
    assert _logged(cfg)[-1][0] == steps == _final(cfg)["step"]


def test_unported_options_raise_naming_their_queue_item(tmp_path):
    cfg = _cfg(tmp_path, "u")
    for bad, item in ((dict(eval_resize="tile"), "item 8"), (dict(eval_flip=True), "item 8"),
                      (dict(eval_scales="0.5,1.0"), "item 8"), (dict(num_devices=2), "item 11"),
                      (dict(spatial_shards=2), "item 11"), (dict(num_processes=2), "item 11")):
        with pytest.raises(NotImplementedError, match=item):
            runner.run_cyclegan(cfg.replace(**bad), device="cpu")
    with pytest.raises(NotImplementedError, match="item 6"):
        runner.run_supervised(cfg, device="cpu")
    with pytest.raises(ValueError, match="mutually exclusive"):
        runner.run_cyclegan(cfg.replace(steps_per_call=2, grad_accum=2), device="cpu")


@pytest.mark.slow
def test_sigterm_saves_and_exits_cleanly(tmp_path):
    """A CLI training run that receives SIGTERM writes a mid-epoch
    checkpoint and exits 0."""
    ckpt_dir = tmp_path / "ckpt"
    cmd = [sys.executable, "-m", "cyclegan_tpu_torch.main", "--training", "--device", "cpu",
           "--dataset", "synthetic", "--dataset_size", "8", "--labeled_fraction", "0.5",
           "--gen_net", "resnet_2blocks", "--ngf", "4", "--ndf", "4", "--crop_height", "32",
           "--crop_width", "32", "--batch_size", "2", "--pool_size", "4", "--epochs", "10000",
           "--decay_epoch", "5000", "--validation_every", "0", "--save_every_steps", "1",
           "--no_bf16", "--checkpoint_dir", str(ckpt_dir),
           "--results_dir", str(tmp_path / "out")]
    proc = subprocess.Popen(cmd, cwd=str(ROOT), stdout=subprocess.PIPE,
                            stderr=subprocess.STDOUT, text=True)
    try:
        deadline = time.time() + 300
        while time.time() < deadline:
            if ck.CheckpointManager(str(ckpt_dir / "mid")).latest_epoch():
                break
            if proc.poll() is not None:
                pytest.fail(f"training exited early ({proc.returncode}):\n{proc.stdout.read()}")
            time.sleep(0.5)
        else:
            pytest.fail("no mid-epoch checkpoint appeared within the deadline")
        proc.send_signal(signal.SIGTERM)
        out, _ = proc.communicate(timeout=120)
    finally:
        if proc.poll() is None:
            proc.kill()
            proc.communicate()
    assert proc.returncode == 0, out
    assert "[preempt] saved mid-epoch checkpoint" in out


def test_runner_helpers_match_jax():
    for kw in (dict(), dict(steps_per_call=3), dict(grad_accum=2), dict(dataset="acdc")):
        tc, jc = Config(**kw), jconfig.Config(**kw)
        assert runner._stacking(tc) == jrunner._stacking(jc)
        assert runner._dataset_spec(tc) == jrunner._dataset_spec(jc)
        assert runner._eval_shaping(tc) == jrunner._eval_shaping(jc)
        for steps in (4, 7, 183):
            assert runner._effective_steps_per_epoch(tc, steps) == \
                jrunner._effective_steps_per_epoch(jc, steps)
    with pytest.raises(ValueError, match="exceeds the epoch length"):
        runner._effective_steps_per_epoch(Config(grad_accum=4), 3)


def test_metrics_logger_matches_jax(tmp_path, capsys):
    from cyclegan_tpu.utils.observability import MetricsLogger as JaxLogger
    from cyclegan_tpu_torch.utils.observability import MetricsLogger

    metrics = {"g_total": torch.tensor(1.25), "d_total": torch.tensor(0.5),
               "hist": torch.zeros(3)}
    lines = []
    for make, sub in ((MetricsLogger, "t"), (JaxLogger, "j")):
        logger = make(str(tmp_path / sub))
        logger.log(step=3, epoch=1, metrics={k: np.asarray(v) for k, v in metrics.items()}
                   if sub == "j" else metrics, steps_per_sec=2.5)
        logger.close()
        lines.append(capsys.readouterr().out)
    assert lines[0] == lines[1] == \
        "[epoch 1 step 3] d_total=0.5000 g_total=1.2500 steps/sec=2.500\n"
    recs = [json.loads((tmp_path / sub / "train_metrics.jsonl").read_text()) for sub in "tj"]
    assert [set(r) for r in recs] == [{"t", "step", "epoch", "d_total", "g_total",
                                       "steps_per_sec"}] * 2
    assert {k: v for k, v in recs[0].items() if k != "t"} == \
        {k: v for k, v in recs[1].items() if k != "t"}


def test_profiler_traces_one_window_and_debug_flags(tmp_path, monkeypatch):
    from cyclegan_tpu_torch.utils import observability, pipeline

    trace_dir = str(tmp_path / "trace")
    prof = observability.StepProfiler(trace_dir, start=0, stop=1)
    for step in range(3):
        prof.maybe_start(step)
        torch.ones(4).sum()
        prof.maybe_stop(step + 1)
    prof.finish()
    assert len(os.listdir(trace_dir)) == 1  # one window, one trace
    observability.StepProfiler(None).maybe_start(100)  # off: nothing happens
    assert not torch.is_anomaly_enabled()
    observability.enable_debug_flags(False)
    assert not torch.is_anomaly_enabled()
    try:
        observability.enable_debug_flags(True)
        assert torch.is_anomaly_enabled() and torch.is_anomaly_check_nan_enabled()
    finally:
        torch.autograd.set_detect_anomaly(False)
    monkeypatch.setenv("CYCLEGAN_TPU_INFER_DEPTH", "3")
    assert pipeline.infer_depth() == 3 and pipeline.InferencePipeline(print).depth == 3
    monkeypatch.setenv("CYCLEGAN_TPU_INFER_DEPTH", "-2")
    assert pipeline.infer_depth() == 0
