"""The port's checkpoints (``train/checkpoint.py`` and the runner's
mid-epoch format detection), on the CPU.

Exact by construction: a restored state equals the saved one bitwise, and a
step taken after a restore equals the step taken without one. A payload
whose dropout generator another device type wrote (a CUDA generator's
Philox seed and offset, 16 bytes) resumes on the CPU with the generator
seeded by ``checkpoint.dropout_reseed`` of the stored seed (the trainer's
own where the payload predates it) and step. The mid-epoch
formats are the JAX runner's (v1 {state, epoch, pos, gstep}, v2 + spc, v3 +
ga), told apart by the stored keys.
"""

import json
import os
import struct

import numpy as np
import pytest
import torch

from cyclegan_tpu_torch.train import checkpoint as ck
from cyclegan_tpu_torch.train import runner
from cyclegan_tpu_torch.train.cyclegan import CycleGANTrainer
from cyclegan_tpu_torch.train.supervised import SupervisedTrainer
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


SIZE = 24


def _trainer(pool_size=2, seed=0, bf16=False):
    cfg = Config(gen_net="resnet_2blocks", ngf=4, ndf=4, bf16=bf16, crop_height=SIZE,
                 crop_width=SIZE, batch_size=2, pool_size=pool_size, epochs=2,
                 decay_epoch=1, use_dropout=True)
    tt = CycleGANTrainer(cfg, 4, 3, steps_per_epoch=2, device="cpu")
    return tt, tt.init_state(torch.Generator().manual_seed(seed))


def _batch(seed=1):
    r = np.random.default_rng(seed)
    return {"lab_image": torch.from_numpy(r.uniform(-1, 1, (2, SIZE, SIZE, 3)).astype(np.float32)),
            "unlab_image": torch.from_numpy(r.uniform(-1, 1, (2, SIZE, SIZE, 3))
                                            .astype(np.float32)),
            "lab_label": torch.from_numpy(r.integers(0, 4, (2, SIZE, SIZE)))}


def _sup_trainer(seed=0):
    cfg = Config(gen_net="resnet_2blocks", ngf=4, bf16=False, crop_height=SIZE,
                 crop_width=SIZE, batch_size=2, epochs=2, decay_epoch=1, use_dropout=True)
    tt = SupervisedTrainer(cfg, 4, 3, steps_per_epoch=2, device="cpu")
    return tt, tt.init_state(torch.Generator().manual_seed(seed))


def _sup_batch(seed=1):
    b = _batch(seed)
    return {"image": b["lab_image"], "label": b["lab_label"]}


TRAINERS = {"cyclegan": (_trainer, _batch), "supervised": (_sup_trainer, _sup_batch)}


def _equal_payloads(a, b, path=""):
    if isinstance(a, dict):
        assert a.keys() == b.keys(), path
        for k in a:
            _equal_payloads(a[k], b[k], f"{path}/{k}")
    elif isinstance(a, torch.Tensor):
        assert a.dtype == b.dtype and torch.equal(a, b), path
    elif isinstance(a, (list, tuple)):
        assert len(a) == len(b), path
        for i, (x, y) in enumerate(zip(a, b)):
            _equal_payloads(x, y, f"{path}[{i}]")
    else:
        assert a == b, (path, a, b)


def test_round_trip_restores_everything_and_the_next_step(tmp_path):
    ta, sa = _trainer()
    sa, _ = ta.train_step(sa, _batch(1))
    mngr = ck.CheckpointManager(str(tmp_path / "c"))
    mngr.save(0, ck.state_payload(ta, sa))
    assert mngr.latest_epoch() == 0 and mngr.stored_step(0) == 1
    tb, sb = _trainer(seed=5)
    sb, nxt = mngr.restore(tb, sb)
    assert nxt == 1 and sb.step == 1
    _equal_payloads(ck.state_payload(tb, sb), ck.state_payload(ta, sa))
    assert sb.g_sched.last_epoch == sa.g_sched.last_epoch == 1
    sa, ma = ta.train_step(sa, _batch(2))
    sb, mb = tb.train_step(sb, _batch(2))
    assert {k: float(v) for k, v in ma.items()} == {k: float(v) for k, v in mb.items()}
    _equal_payloads(ck.state_payload(tb, sb), ck.state_payload(ta, sa))


def test_keeps_the_newest_and_writes_whole_files(tmp_path):
    tt, st = _trainer()
    mngr = ck.CheckpointManager(str(tmp_path / "c"), max_to_keep=2)
    for step in (3, 1, 7, 9):
        mngr.save(step, ck.state_payload(tt, st))
    assert mngr.steps() == [7, 9]
    assert sorted(os.listdir(tmp_path / "c")) == ["7.json", "7.pt", "9.json", "9.pt"]
    assert ck.CheckpointManager(str(tmp_path / "none")).restore() is None


def test_empty_pools_round_trip_and_refuse_a_run_that_wants_one(tmp_path):
    t0, s0 = _trainer(pool_size=0)
    mngr = ck.CheckpointManager(str(tmp_path / "c"))
    mngr.save(0, ck.state_payload(t0, s0))
    t1, s1 = _trainer(pool_size=0, seed=3)
    s1, _ = mngr.restore(t1, s1)
    assert s1.pool_img.buffer.shape[0] == 0 and s1.pool_img.count == 0
    t2, s2 = _trainer(pool_size=3)
    with pytest.raises(ValueError, match="pool_size 0"):
        mngr.restore(t2, s2)


def test_pools_restore_at_the_stored_size_and_type(tmp_path):
    """A pool_size or precision change between writer and reader: the
    stored pool (capacity, filled rows, type) comes back."""
    ta, sa = _trainer(pool_size=4)
    sa, _ = ta.train_step(sa, _batch(1))
    mngr = ck.CheckpointManager(str(tmp_path / "c"))
    mngr.save(0, {"state": ck.state_payload(ta, sa), "epoch": 0, "pos": 1, "gstep": 1,
                  "spc": 1, "ga": 1})
    tb, sb = _trainer(pool_size=2, bf16=True)
    w, _ = mngr.restore(tb, sb)
    got = w["state"].pool_img
    assert got.buffer.shape == sa.pool_img.buffer.shape and got.count == 2
    assert got.buffer.dtype == torch.float32
    assert torch.equal(got.buffer, sa.pool_img.buffer) and w["pos"] == 1


def _toy(val=1.0, drop=()):
    w = {"state": {"w": torch.full((8, 8), val)}, "epoch": 0, "pos": 1, "gstep": 2, "spc": 1,
         "ga": 1}
    return {k: v for k, v in w.items() if k not in drop}


@pytest.mark.parametrize("drop", [(), ("ga",), ("spc", "ga")])
def test_restore_mid_detects_the_format_from_stored_keys(tmp_path, drop):
    mngr = ck.CheckpointManager(str(tmp_path / "mid"), max_to_keep=1)
    mngr.save(5, _toy(3.0, drop))
    w = runner._restore_mid(mngr, spc=7)
    assert torch.equal(w["state"]["w"], torch.full((8, 8), 3.0))
    assert (w["epoch"], w["pos"], w["gstep"]) == (0, 1, 2)
    # v1 implies this run's steps_per_call; v1 and v2 imply ga 1.
    assert w["spc"] == (7 if "spc" in drop else 1) and w["ga"] == 1
    assert runner._restore_mid(ck.CheckpointManager(str(tmp_path / "x")), spc=1) is None


def test_restore_mid_refuses_a_newer_format(tmp_path):
    mngr = ck.CheckpointManager(str(tmp_path / "mid"), max_to_keep=1)
    mngr.save(3, dict(_toy(), shiny_new_field=9))
    with pytest.raises(ValueError, match="shiny_new_field"):
        runner._restore_mid(mngr, spc=1)


@pytest.mark.parametrize("keep_meta", [True, False])
def test_restore_mid_surfaces_corruption_as_itself(tmp_path, keep_meta):
    mngr = ck.CheckpointManager(str(tmp_path / "mid"), max_to_keep=1)
    mngr.save(4, _toy(2.0))
    with open(tmp_path / "mid" / "4.pt", "r+b") as f:
        f.truncate(100)
    if not keep_meta:
        os.remove(tmp_path / "mid" / "4.json")
    with pytest.raises(Exception) as exc_info:
        runner._restore_mid(mngr, spc=1)
    assert not (isinstance(exc_info.value, ValueError) and "unknown keys" in str(exc_info.value))
    notes = getattr(exc_info.value, "__notes__", [])
    assert bool(notes) == (not keep_meta)


def test_restore_for_inference_takes_the_newer_of_epoch_and_mid(tmp_path):
    cfg = Config(gen_net="resnet_2blocks", ngf=4, ndf=4, bf16=False, crop_height=SIZE,
                 crop_width=SIZE, dataset="synthetic_gray", pool_size=0,
                 checkpoint_dir=str(tmp_path / "ckpt"))
    tt, st = _trainer(pool_size=0)
    with pytest.raises(FileNotFoundError):
        ck.restore_for_inference(cfg, semisupervised=True, device="cpu")
    with pytest.raises(FileNotFoundError):
        ck.restore_for_inference(cfg, semisupervised=False, device="cpu")
    tt = CycleGANTrainer(cfg, 4, 1, steps_per_epoch=2, device="cpu")
    st = tt.init_state(torch.Generator().manual_seed(0))
    b = {k: (v[..., :1] if "image" in k else v) for k, v in _batch().items()}
    st, _ = tt.train_step(st, b)
    ck.CheckpointManager(cfg.checkpoint_dir).save(0, ck.state_payload(tt, st))
    epoch_w = tt.G_i2l.state_dict()["stem.conv.weight"].clone()
    st, _ = tt.train_step(st, b)
    ck.CheckpointManager(os.path.join(cfg.checkpoint_dir, "mid")).save(
        2, {"state": ck.state_payload(tt, st), "epoch": 1, "pos": 0, "gstep": 2, "spc": 1,
            "ga": 1})
    _, got, nc, ic = ck.restore_for_inference(cfg, semisupervised=True, device="cpu")
    assert (got.step, nc, ic) == (2, 4, 1)
    # An older mid checkpoint (stale) loses to the epoch checkpoint.
    os.replace(os.path.join(cfg.checkpoint_dir, "0.pt"), os.path.join(cfg.checkpoint_dir, "5.pt"))
    os.replace(os.path.join(cfg.checkpoint_dir, "0.json"),
               os.path.join(cfg.checkpoint_dir, "5.json"))
    meta = json.load(open(os.path.join(cfg.checkpoint_dir, "mid", "2.json")))
    json.dump(dict(meta, step=0), open(os.path.join(cfg.checkpoint_dir, "mid", "2.json"), "w"))
    t2, got, _, _ = ck.restore_for_inference(cfg, semisupervised=True, device="cpu")
    assert got.step == 1
    assert torch.equal(t2.G_i2l.state_dict()["stem.conv.weight"], epoch_w)


def test_keep_best_tracks_the_best_miou_across_restarts(tmp_path, monkeypatch):
    scripted = iter([0.3, 0.5, 0.4])
    monkeypatch.setattr(runner, "_evaluate", lambda *a, **k: {"miou": next(scripted)})
    cfg = Config(dataset="synthetic", dataset_size=8, labeled_fraction=0.5,
                 gen_net="resnet_2blocks", ngf=4, ndf=4, bf16=False, crop_height=SIZE,
                 crop_width=SIZE, batch_size=2, pool_size=2, epochs=3, decay_epoch=2,
                 validation_every=1, log_every=10, keep_best=True,
                 checkpoint_dir=str(tmp_path / "ckpt"), results_dir=str(tmp_path / "out"))
    runner.run_cyclegan(cfg, device="cpu")
    metric_path = tmp_path / "ckpt" / "best_metric.json"
    assert json.loads(metric_path.read_text()) == {"miou": 0.5, "epoch": 1}
    assert ck.CheckpointManager(str(tmp_path / "ckpt" / "best")).latest_epoch() == 1
    scripted = iter([0.2])
    runner.run_cyclegan(cfg.replace(epochs=4, decay_epoch=3), device="cpu")
    assert json.loads(metric_path.read_text()) == {"miou": 0.5, "epoch": 1}
    assert ck.CheckpointManager(str(tmp_path / "ckpt" / "best")).latest_epoch() == 1


def _as_written_on_the_card(payload: dict) -> dict:
    """``payload`` with the dropout state a CUDA generator gives: Philox's
    seed and offset, 16 bytes, which no CPU generator loads."""
    philox = torch.tensor(list(struct.pack("<QQ", payload["dropout_seed"], 4096)),
                          dtype=torch.uint8)
    return dict(payload, dropout=philox)


@pytest.mark.parametrize("kind", sorted(TRAINERS))
def test_a_checkpoint_from_the_other_device_type_resumes_by_the_reseed_rule(tmp_path, kind):
    make, batch = TRAINERS[kind]
    ta, sa = make()
    sa, _ = ta.train_step(sa, batch(1))
    payload = ck.state_payload(ta, sa)
    assert payload["dropout_seed"] == sa.dropout_seed and payload["dropout"].numel() == 5056
    with pytest.raises(RuntimeError):  # why the rule exists
        torch.Generator().set_state(_as_written_on_the_card(payload)["dropout"])
    mngr = ck.CheckpointManager(str(tmp_path / "c"))
    mngr.save(0, _as_written_on_the_card(payload))
    tb, sb = make(seed=5)
    sb, _ = mngr.restore(tb, sb)
    seed = ck.dropout_reseed(sa.dropout_seed, 1)
    assert (sb.step, sb.dropout_seed, sb.dropout.device.type) == (1, sa.dropout_seed, "cpu")
    assert torch.equal(sb.dropout.get_state(), torch.Generator().manual_seed(seed).get_state())
    # The resumed run is the uninterrupted one with its generator reseeded
    # by the rule, bitwise.
    sa.dropout.manual_seed(seed)
    sa, ma = ta.train_step(sa, batch(2))
    sb, mb = tb.train_step(sb, batch(2))
    assert {k: float(v) for k, v in ma.items()} == {k: float(v) for k, v in mb.items()}
    _equal_payloads(ck.state_payload(tb, sb), ck.state_payload(ta, sa))


@pytest.mark.parametrize("kind", sorted(TRAINERS))
def test_a_same_device_resume_stays_bitwise(tmp_path, kind):
    make, batch = TRAINERS[kind]
    ta, sa = make()
    sa, _ = ta.train_step(sa, batch(1))
    mngr = ck.CheckpointManager(str(tmp_path / "c"))
    mngr.save(0, ck.state_payload(ta, sa))
    tb, sb = make(seed=5)
    sb, _ = mngr.restore(tb, sb)
    assert torch.equal(sb.dropout.get_state(), sa.dropout.get_state())
    sa, ma = ta.train_step(sa, batch(2))
    sb, mb = tb.train_step(sb, batch(2))
    assert {k: float(v) for k, v in ma.items()} == {k: float(v) for k, v in mb.items()}
    _equal_payloads(ck.state_payload(tb, sb), ck.state_payload(ta, sa))


@pytest.mark.parametrize("kind", sorted(TRAINERS))
def test_a_card_payload_without_its_seed_reseeds_from_the_trainers_own(tmp_path, kind):
    """A payload written before the seed was stored (no ``dropout_seed``)
    by a CUDA generator resumes on the CPU: the generator is seeded by the
    rule from the resuming trainer's own seed, which the state keeps."""
    make, batch = TRAINERS[kind]
    ta, sa = make()
    sa, _ = ta.train_step(sa, batch(1))
    payload = _as_written_on_the_card(ck.state_payload(ta, sa))
    del payload["dropout_seed"]
    mngr = ck.CheckpointManager(str(tmp_path / "c"))
    mngr.save(0, payload)
    tb, sb = make(seed=5)
    own = sb.dropout_seed
    assert own != sa.dropout_seed
    sb, _ = mngr.restore(tb, sb)
    want = torch.Generator().manual_seed(ck.dropout_reseed(own, 1)).get_state()
    assert (sb.step, sb.dropout_seed) == (1, own)
    assert torch.equal(sb.dropout.get_state(), want)
    sb, mb = tb.train_step(sb, batch(2))
    assert all(np.isfinite(float(v)) for v in mb.values())


def test_reseed_rule_at_step_0_is_the_seed_itself():
    """A run resumed at step 0 on the other device type draws what a run
    started there from the same seed draws."""
    tt, st = _trainer()
    assert st.dropout.initial_seed() == st.dropout_seed
    assert ck.dropout_reseed(st.dropout_seed, 0) == st.dropout_seed
    assert ck.dropout_reseed(2 ** 63 - 1, 2) == 1
