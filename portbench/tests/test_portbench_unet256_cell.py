"""The cell ``voc_dp8_unet256.train`` (config 5's recipe with the U-Net-256
generators, 32 rows a card): its configuration against the preset, a run at
a CPU size under its own limits, the control and each fault failing them
there, the ``unet.*`` span readers, and its weights, FLOPs and kernel calls
pinned."""

import math
import time

import pytest
import torch

from portbench import compare, faults, harness, inputs
from portbench import spans as S
from portbench.reference.precision import PRECISIONS
from portbench.tests import tiny
from portbench.traffic import train
from portbench.work import calls, model

CELL = "voc_dp8_unet256.train"
READERS = ("unet.down_device_ms.train", "unet.up_device_ms.train", "unet.skip_device_ms.train")
MS = 1_000_000  # ns

torch.set_num_threads(4)


def test_configuration_departs_from_its_preset_as_listed():
    entry = harness.find(harness.manifest()["configs"], "voc_dp8_unet256", "config")
    body = harness.load_json(harness.ROOT / entry["file"])
    assert harness.config_problems("voc_dp8_unet256", body) == []
    assert body["preset"] == "voc_dp8_bf16"
    assert {k: (v["published"], v["here"]) for k, v in body["reduced"].items()} == {
        "batch_size": (64, 32), "num_devices": (8, 1)}
    assert (body["changed"]["gen_net"]["published"], body["gen_net"]) == ("resnet_9blocks",
                                                                          "unet_256")
    # the published widths, no dropout
    assert (body["ngf"], body["ndf"], body["n_layers_D"], body["use_dropout"]) == (64, 64, 3,
                                                                                   False)
    assert entry["reduced"] == ["batch_size", "num_devices", "gen_net"]


def test_the_cell_runs_at_a_cpu_size_under_its_own_limits():
    """unet_128 at ngf 4, 128x128, 2 rows, float32: the port's CPU path
    against the reference, held to the cell's limits."""
    r = harness.run_cell(CELL, 2 ** 31 + 4243, 0.3, False, device="cpu", overrides=tiny.UNET)
    assert r["correct"], r["checks"]
    assert set(r["metrics"]) == {"train_samples_per_s", "setup_s"}
    assert r["checks"].keys() == harness.load_cell(CELL).workload["limits"].keys()


def test_the_control_fails_its_limits():
    """The reference in fp8 in the program's place, at the CPU size."""
    ctx = harness.make_context(harness.load_cell(CELL), 2 ** 31 + 77, 0.0, False,
                               torch.device("cpu"), 0.0, tiny.UNET)
    ref = train.reference_readings(ctx)
    low = train.reference_readings(ctx, q=PRECISIONS["fp8_e4m3"])
    ok, checks = compare.verdict(train.numbers(low, ref), ctx.limits)
    assert not ok, checks


@pytest.mark.parametrize("fault", sorted(faults.TRAIN))
def test_each_fault_fails_its_limits(fault):
    """A step that returns its state unchanged, half of each batch, a pool
    that never swaps, a schedule that never decays."""
    with faults.TRAIN[fault]():
        r = harness.run_cell(CELL, 2 ** 31 + 77, 0.3, False, device="cpu", overrides=tiny.UNET)
    assert r["correct"] is False, r["checks"]


def _traced(cell, overrides):
    """A ``--trace 1`` run's Observation on the CPU (the traffic kind's own
    ``run``)."""
    ctx = harness.make_context(harness.load_cell(cell), 2 ** 31 + 33, 0.3, True,
                               torch.device("cpu"), time.perf_counter(), overrides)
    return train.run(ctx)["obs"], ctx.params


def _place(obs, names_ms: dict) -> None:
    """Device work in the stretch: ``ms`` launched as each span named in
    ``names_ms`` opens (before any span inside it)."""
    stretch = list(obs.spans)
    host, device = [], []
    for i, s in enumerate(stretch):
        if s.name in names_ms:
            t = s.start
            host.append(S.Call("cudaLaunchKernel", t, t + 1000, i))
            device.append(S.Call("k", t, t + int(names_ms[s.name] * MS), i))
    obs.span_calls = S.Calls(stretch[0].start, max(s.end for s in stretch), host, device)


def test_unet_readers_on_a_recorded_run():
    obs, p = _traced(CELL, tiny.UNET)
    read = {name: harness.load_reader(name) for name in READERS}
    # a CPU profile holds no device work: nothing to read
    assert all(r(obs) is None for r in read.values())
    stretch = list(obs.spans)
    per_step = {n: sum(s.name == n for s in stretch) / p["trace_steps"]
                for n in ("unet.down", "unet.up", "unet.skip")}
    # unet_128: 7 levels, 3 generator applies a step
    assert per_step == {"unet.down": 21, "unet.up": 21, "unet.skip": 18}
    _place(obs, {"unet.down": 1, "unet.up": 2, "unet.skip": 0.5, "g_backward": 3})
    got = {name: r(obs) for name, r in read.items()}
    assert got == pytest.approx({"unet.down_device_ms.train": 21 * 1.0,
                                 "unet.up_device_ms.train": 21 * 2.0,
                                 "unet.skip_device_ms.train": 18 * 0.5})
    # work elsewhere in the forward is none of theirs
    _place(obs, {"g_forward": 1, "d_forward": 1})
    assert all(r(obs) is None for r in read.values())


def test_unet_readers_find_nothing_in_a_resnet_run():
    obs, _ = _traced("voc_dp8_bf16.train", tiny.TRAIN)
    assert not any(s.name.startswith("unet.") for s in obs.spans)
    _place(obs, {"g_forward": 1, "g_backward": 2})
    for name in READERS:
        assert harness.load_reader(name)(obs) is None


# The cell at its own size: two U-Net-256 generators (32 leaves each) and
# two PatchGANs (10), 114.4 M parameters Adam carries.
PARAMS = {"G_i2l": 54_446_485, "G_l2i": 54_428_035, "D_img": 2_764_737, "D_lab": 2_783_169}
STEP_FLOPS = 9_566_536_335_360   # 32 rows; 4 x the 8-row 2.39 TFLOP
STEP_CALLS = {"cg_instance_norm_act": [51, 0.0008604192095522389],
              "cg_instance_norm_act_bwd": [51, 0.0012906288143283585]}


def test_weights_flops_and_calls_pinned():
    cfg = harness.load_cell(CELL).config
    specs = inputs.net_specs(cfg)
    assert {k: len(v) for k, v in specs.items()} == {"G_i2l": 32, "G_l2i": 32, "D_img": 10,
                                                      "D_lab": 10}
    assert {k: sum(math.prod(s) for _, s in v) for k, v in specs.items()} == PARAMS
    assert model.train_step_flops(cfg) == STEP_FLOPS
    # 13 norms a U-Net forward: three applies, plus the PatchGANs' 3 x 4
    assert {k: list(v) for k, v in calls.train_step_calls(cfg).items()} == STEP_CALLS
    assert not set(calls.train_step_calls(cfg)) & set(calls.CONV_ENTRIES)
