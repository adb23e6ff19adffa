"""The reference agrees with the port's CPU path at a tiny size; its resize
is the port's; the work counts are pinned at the cells' shapes."""

import pytest
import torch

from portbench import harness
from portbench.tests import tiny
from portbench.work import calls, model

torch.set_num_threads(4)


@pytest.mark.parametrize("cell", tiny.TRAIN_CELLS + tiny.SERVE_CELLS)
def test_reference_agrees_with_the_port_on_the_cpu(cell):
    r = harness.run_cell(cell, 2 ** 31 + 12345, 0.3, False, device="cpu",
                         overrides=tiny.overrides(cell))
    assert r["correct"]
    for name, c in r["checks"].items():
        # float32 on both sides: summation order only
        assert c["value"] <= (0.0 if name == "served_gap" else 2e-5), (name, c)


@pytest.mark.parametrize("hw,out", [((64, 64), (48, 48)), ((64, 64), (80, 80)),
                                    ((512, 512), (384, 384)), ((384, 384), (512, 512)),
                                    ((640, 640), (512, 512)), ((40, 56), (28, 72))])
def test_resize_is_the_ports(hw, out):
    from cyclegan_tpu_torch.tta import resize as port_resize

    from portbench.reference.serve import resize

    x = torch.randn(2, *hw, 5, generator=torch.Generator().manual_seed(0))
    # float64 weights summed by a matrix product against the library's
    # float32 weights: float32 rounding of sums of up to ~4 terms of N(0, 1)
    torch.testing.assert_close(resize(x, out), port_resize(x, out), atol=1e-4, rtol=1e-4)


def cfg_of(name):
    cell = harness.load_cell(name)
    return {**cell.config, **cell.workload.get("config_overrides", {})}, cell.workload["params"]


def test_generator_flops_hand_count():
    from portbench.reference.nets import family

    # stem 1.233 + down 2 x 2.416 + trunk 18 x 4.832 + up 2 x 2.416 + head 8.631 GFLOP
    g = family("resnet_9blocks").macs(3, 21, {"gen_net": "resnet_9blocks", "ngf": 64}, 256, 256)
    assert 2 * sum(g) == 2 * (256 * 256 * 3 * 64 * 49 + 2 * 128 * 128 * 64 * 128 * 9
                              + 2 * 64 * 64 * 128 * 256 * 9 + 18 * 64 * 64 * 256 * 256 * 9
                              + 256 * 256 * 64 * 21 * 49)
    assert abs(2 * sum(g) / 1e9 - 106.5) < 0.1
    d = model.patchgan_macs(3, 64, 3, 256, 256)
    assert abs(2 * sum(d) / 1e9 - 6.29) < 0.01


def test_step_and_batch_flops_pinned():
    cfg, _ = cfg_of("voc_dp8_bf16.train")
    assert abs(model.train_step_flops(cfg) / 1e12 - 13.523) < 0.001
    cfg, p = cfg_of("voc_semisup_256.serve_tta")
    assert model.serve_forwards(cfg, p) == [32, 32, 72, 72, 128, 128]
    assert abs(model.serve_batch_flops(cfg, p) / 1e12 - 49.417) < 0.001


def test_kernel_calls_pinned():
    # what the function needs of each entry: three generator applies of 9
    # blocks (27), 5 + 5 + 5 outside norms and the PatchGANs' 12; the same
    # on either trunk route
    for cell in tiny.TRAIN_CELLS:
        cfg, _ = cfg_of(cell)
        c = {k: v[0] for k, v in calls.train_step_calls(cfg).items()}
        assert c == {"cg_instance_norm_act": 27 + 2 * 27, "cg_instance_norm_act_bwd": 27 + 2 * 27,
                     "cg_conv3x3_reflect": 2 * 27, "cg_conv3x3_reflect_dgrad": 2 * 27,
                     "cg_conv_dw": 2 * 27}
    cfg, p = cfg_of("voc_semisup_256.serve_tta")
    c = {k: v[0] for k, v in calls.serve_batch_calls(cfg, p).items()}
    assert c == {"cg_instance_norm_act": 6 * 23, "cg_conv3x3_reflect": 6 * 18}


def test_least_seconds_pinned():
    cfg, _ = cfg_of("voc_dp8_bf16.train")
    c = calls.train_step_calls(cfg)
    # a trunk conv at 16 rows: 77.3 GFLOP at 989 TFLOP/s = 78.2 us; 2 a block,
    # and as many input and weight gradients
    conv = 2 * 16 * 64 * 64 * 256 * 256 * 9 / 989e12
    for entry in ("cg_conv3x3_reflect", "cg_conv3x3_reflect_dgrad", "cg_conv_dw"):
        assert c[entry][1] == pytest.approx(2 * 9 * conv * 40 / 16, rel=1e-9)


@pytest.mark.parametrize("cell,least_ms", [
    # trunk conv entries: 2 x 9 x 40 rows x 4.83 GFLOP at 989 TFLOP/s (ops-bound);
    # the norms: bf16 bytes at 3.35 TB/s
    ("voc_dp8_bf16.train", {"cg_instance_norm_act": 1.8512, "cg_instance_norm_act_bwd": 2.4387,
                            "cg_conv3x3_reflect": 3.5176, "cg_conv3x3_reflect_dgrad": 3.5176,
                            "cg_conv_dw": 3.5176}),
    ("voc_semisup_256.serve_tta", {"cg_instance_norm_act": 20.6235,
                                   "cg_conv3x3_reflect": 40.8044}),
])
def test_kernel_work_pinned(cell, least_ms):
    cfg, p = cfg_of(cell)
    got = calls.serve_batch_calls(cfg, p) if "serve" in cell else calls.train_step_calls(cfg)
    assert {k: round(v[1] * 1e3, 4) for k, v in got.items()} == least_ms


def _obs(launches, units=2, kernel_s=1e-3):
    from portbench import readings
    from portbench import trace as T

    cfg, _ = cfg_of("voc_dp8_bf16.train")
    events = [(k, 0.0, kernel_s) for k in calls.CONV_KERNELS + calls.NORM_KERNELS]
    return readings.Observation(trace=T.Trace(0.0, 1.0, events, []),
                                units=units, launches=launches,
                                calls=calls.train_step_calls(cfg), model_flops=1.0, host_ms=[])


def test_roofline_credits_needed_work_only():
    """A recomputed or split call adds device time and no credit; an entry
    is credited no more calls than it launched."""
    from portbench import readings

    need = {k: v[0] for k, v in calls.train_step_calls(cfg_of("voc_dp8_bf16.train")[0]).items()}
    exact = {k: 2 * n for k, n in need.items()}
    doubled = {k: 4 * n for k, n in need.items()}
    assert readings.conv_roofline(_obs(exact)) == readings.conv_roofline(_obs(doubled))
    half = {**exact, "cg_conv3x3_reflect": need["cg_conv3x3_reflect"]}
    assert readings.conv_roofline(_obs(half)) < readings.conv_roofline(_obs(exact))
    assert readings.conv_roofline(_obs({})) is None
    assert readings.norm_roofline(_obs({"cg_conv_dw": 108})) is None
