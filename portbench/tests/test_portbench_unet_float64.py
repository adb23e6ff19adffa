"""The port's U-Net step on the CPU held against a float64 copy of the
reference: the port's float32 gradient sits within the float32
reference's own gap to float64.

``unet_128`` at ngf 4, 128x128, 2 rows, float32, through both train cells'
overrides. Over seeds 11-45 and 2**31 + 4242 of both cells (72 readings a
side) the float32 reference read, against its float64 copy, ``grad_gap``
up to 1.18e-2, ``change_gap`` up to 1.55e-2, ``grad_median_gap`` up to
3.95e-5 (1.06e-4 with its norm summed in the port's NHWC order) and
``step1_loss_gap`` up to 2.5e-7; the port read up to 6.1e-3, 1.15e-2,
1.5e-4 (one reading; the next largest 4.0e-5) and 2.6e-7, and crossed 1e-3
in ``grad_gap`` on 15 readings where the float32 reference did on 9. Both
fall off float64 in the same rare, large steps, as a ReLU that rounding
flips near the 1x1 bottleneck would make: it moves the outer levels'
gradients, and Adam's first update moves every weight by the sign of its
gradient. Swapping the reference's norm for the port's (NHWC
statistics, the analytic VJP) moves which seeds read large, not how large.
So ``grad_gap`` and ``change_gap`` are held at the float32 reference's own
largest gaps, rounded up (1.2e-2, 1.6e-2); the loss at 2e-5 (summation
order) and the median leaf at 1e-4, on seeds where the port read large
gaps before.
"""

import time

import pytest
import torch

from portbench import harness
from portbench.reference import train as R
from portbench.tests import tiny
from portbench.traffic import train as T

torch.set_num_threads(4)
BARS = {"step1_loss_gap": 2e-5, "grad_gap": 1.2e-2, "grad_median_gap": 1e-4,
        "change_gap": 1.6e-2}


class Float64Reference(R.ReferenceTrainer):
    """The reference trainer with its parameters, Adam's moments and pools
    in float64 (the seed's float32 weights converted exactly)."""

    def __init__(self, cfg, weights, **kw):
        super().__init__(cfg, weights, **kw)
        self.params = {net: {k: v.detach().double().requires_grad_() for k, v in w.items()}
                       for net, w in self.params.items()}
        g = {f"{n}.{k}": v for n in ("G_i2l", "G_l2i") for k, v in self.params[n].items()}
        d = {f"{n}.{k}": v for n in ("D_img", "D_lab") for k, v in self.params[n].items()}
        self.g_opt, self.d_opt = R.Adam(g, cfg["lr"]), R.Adam(d, cfg["lr"])
        for pool in (self.pool_img, self.pool_lab):
            pool.items = [x.double() for x in pool.items]


@pytest.fixture
def float64_reference(monkeypatch):
    """``train.reference_readings`` on the float64 copy: the trainer above,
    and the step's images and label maps taken to float64 as they are laid
    out NCHW."""
    monkeypatch.setattr(T, "ReferenceTrainer", Float64Reference)
    monkeypatch.setattr(R, "nchw", lambda x: x.permute(0, 3, 1, 2).double())


@pytest.mark.parametrize("seed", [2 ** 31 + 4242, 11, 12])
@pytest.mark.parametrize("cell", tiny.TRAIN_CELLS)
def test_port_within_the_float32_references_gap_to_float64(cell, seed, request):
    ctx = harness.make_context(harness.load_cell(cell), seed, 0.3, False, torch.device("cpu"),
                               time.perf_counter(), tiny.UNET)
    prog, readings = T.setup(ctx)
    del prog
    request.getfixturevalue("float64_reference")
    ref = T.reference_readings(ctx)
    got = T.numbers(readings, ref)
    assert all(got[k] <= bar for k, bar in BARS.items()), got
