"""The U-Net generator family (``reference/gen_unet.py``) held against the
port's ``UnetGenerator`` on the CPU: its parameters, its forward with and
without dropout, a train cell run on it through config overrides alone, its
FLOPs by hand and its norm calls."""

import pytest
import torch

from portbench import harness
from portbench.reference.nets import family
from portbench.tests import tiny
from portbench.work import calls

torch.set_num_threads(4)
UNET = family("unet_256")


@pytest.mark.parametrize("gen_net", ["unet_128", "unet_256"])
def test_spec_is_the_ports(gen_net):
    from cyclegan_tpu_torch.models.generators import define_Gen

    for in_nc, out_nc in ((3, 21), (21, 3)):
        port = define_Gen(in_nc, out_nc, 64, gen_net, use_dropout=True)
        want = [(k, tuple(v.shape)) for k, v in port.named_parameters()]
        assert UNET.spec(in_nc, out_nc, {"gen_net": gen_net, "ngf": 64}) == want


@pytest.mark.parametrize("drop", [False, True], ids=["no_dropout", "dropout"])
@pytest.mark.parametrize("gen_net,hw", [("unet_128", 128), ("unet_256", 256)])
def test_forward_is_the_ports(gen_net, hw, drop):
    """float32 on both sides, the same masks from the same seed: summation
    order only."""
    from cyclegan_tpu_torch.models.generators import define_Gen

    g = torch.Generator().manual_seed(11)
    port = define_Gen(3, 21, 4, gen_net, head="none", generator=g, use_dropout=drop).train()
    p = {k: v.detach() for k, v in port.named_parameters()}
    x = torch.rand((2, 3, hw, hw), generator=g) * 2 - 1
    masks = [torch.Generator().manual_seed(5) if drop else None for _ in range(2)]
    with torch.no_grad():
        want = port(x, masks[0])
    got = UNET.forward(p, x, {"gen_net": gen_net, "ngf": 4}, False, drop=masks[1])
    torch.testing.assert_close(got, want, atol=2e-6, rtol=1e-5)
    assert not drop or masks[0].get_state().equal(masks[1].get_state())  # as many draws


@pytest.mark.parametrize("cell", tiny.TRAIN_CELLS)
def test_a_train_cell_runs_the_unet_through_overrides(cell):
    """harness.run_cell on unet_128 (ngf 4, 128x128, 2 rows, float32) with
    no file of its own: the port's CPU path against the reference. Step 1's
    losses and the median leaf's gradient differ by summation order only.
    The worst leaf's gradient and change do not: the 1x1 bottleneck holds 32
    values a row, so a ReLU that rounding flips there moves the gradients of
    the outer levels, and Adam's first update moves every weight by the sign
    of its gradient. A float64 copy of the reference reads the float32
    reference as far off (seeds 11-15 and this one, both cells: up to 1.2e-3
    and 9.5e-3; the program against the float32 reference up to 6.1e-3 and
    9.6e-3), so those two are held at 2e-2, about twice that."""
    r = harness.run_cell(cell, 2 ** 31 + 4242, 0.3, False, device="cpu", overrides=tiny.UNET)
    assert r["correct"]
    got = {k: c["value"] for k, c in r["checks"].items()}
    assert got["step1_loss_gap"] <= 2e-5 and got["grad_median_gap"] <= 2e-5, got
    assert got["grad_gap"] <= 2e-2 and got["change_gap"] <= 2e-2, got


def test_flops_hand_count():
    # downs 3->64->128->256->512->512 x 4, each 4x4 stride 2 at its output;
    # ups per input pixel, innermost 512->512, then 1024->512 x 3, 1024->256,
    # 512->128, 256->64, 128->21
    m = UNET.macs(3, 21, {"gen_net": "unet_256", "ngf": 64}, 256, 256)
    px = [(256 >> (i + 1)) ** 2 for i in range(8)]
    down = [3 * 64, 64 * 128, 128 * 256, 256 * 512] + [512 * 512] * 4
    up = [128 * 21, 256 * 64, 512 * 128, 1024 * 256] + [1024 * 512] * 3 + [512 * 512]
    assert m == [px[i] * down[i] * 16 for i in range(8)] + \
        [px[i] * up[i] * 16 for i in range(7, -1, -1)]
    assert round(2 * sum(m) / 1e9, 2) == 13.30


@pytest.mark.parametrize("gen_net,norms", [("unet_256", 13), ("unet_128", 11)])
def test_norm_calls(gen_net, norms):
    cfg = {"gen_net": gen_net, "ngf": 64, "crop_height": 256, "crop_width": 256}
    for backward in (False, True):
        c = calls.Calls()
        UNET.calls(c, cfg, 8, backward)
        got = {k: v[0] for k, v in c.by_entry.items()}
        assert got == {"cg_instance_norm_act": norms,
                       **({"cg_instance_norm_act_bwd": norms} if backward else {})}
    # the innermost up's norm at 2x2x512 is the smallest plane
    c = calls.Calls()
    UNET.calls(c, {**cfg, "gen_net": "unet_256"}, 1, False)
    step = calls.train_step_calls({**cfg, "gen_net": "unet_256", "num_classes": 21,
                                   "in_channels": 3, "ndf": 64, "n_layers_D": 3,
                                   "batch_size": 8})
    assert {k: v[0] for k, v in step.items()} == {"cg_instance_norm_act": 3 * 13 + 12,
                                                  "cg_instance_norm_act_bwd": 3 * 13 + 12}
