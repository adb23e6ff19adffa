"""The U-Net levels' spans (``models/generators.py::UnetLevel``) on the CPU.

- On: a forward records ``unet.down`` (outermost level first), then
  ``unet.up`` and ``unet.skip`` (innermost level first, no skip at the
  outermost), all siblings under the span the forward runs in, none
  holding another.
- Off (the default): a forward records nothing, and its output is bitwise
  the output with recording on.
- In a train step the levels' spans lie under ``g_forward`` alone: three
  generator applies a step, none in the D phase.
"""

import collections

import numpy as np
import pytest
import torch

from cyclegan_tpu_torch.models.generators import define_Gen
from cyclegan_tpu_torch.train.cyclegan import CycleGANTrainer
from cyclegan_tpu_torch.utils import observability as obs
from cyclegan_tpu_torch.utils.config import Config

LEVELS = {"unet_128": 7, "unet_256": 8}


@pytest.fixture(autouse=True, scope="module")
def _few_torch_threads():
    """Two intra-op threads: the suite runs several workers on one host."""
    n = torch.get_num_threads()
    torch.set_num_threads(2)
    yield
    torch.set_num_threads(n)


def _recorded(fn):
    obs.take_spans()
    obs.record_spans(True)
    try:
        out = fn()
    finally:
        obs.record_spans(False)
    return out, obs.take_spans()


def _expected(levels):
    """The spans of one forward in the order they open."""
    return (["unet.down"] * levels
            + [n for _ in range(levels - 1) for n in ("unet.up", "unet.skip")] + ["unet.up"])


@pytest.mark.parametrize("gen_net", ["unet_128", "unet_256"])
def test_levels_record_three_sibling_spans(gen_net):
    hw = 2 ** LEVELS[gen_net]
    g = define_Gen(3, 5, 2, gen_net, generator=torch.Generator().manual_seed(0))
    x = torch.rand((1, 3, hw, hw), generator=torch.Generator().manual_seed(1)) * 2 - 1

    def forward():
        with torch.no_grad(), obs.span("outer", unit=7):
            return g(x)

    y_on, spans = _recorded(forward)
    assert spans[0].name == "outer" and spans[0].parent == -1
    inner = spans[1:]
    assert [s.name for s in inner] == _expected(LEVELS[gen_net])
    # siblings: each directly under the enclosing span, closed before the
    # next opens, and every span carries the enclosing unit
    assert all(s.parent == 0 and s.unit == 7 for s in inner)
    assert all(a.end <= b.start for a, b in zip(inner, inner[1:]))
    # off by default: nothing recorded, the output bitwise the same
    with torch.no_grad():
        y_off = g(x)
    assert obs.take_spans() == []
    assert torch.equal(y_on, y_off)


def test_spans_in_a_train_step_lie_under_g_forward():
    cfg = Config(gen_net="unet_128", ngf=2, ndf=4, crop_height=128, crop_width=128,
                 bf16=False, pool_size=2, batch_size=1)
    trainer = CycleGANTrainer(cfg, 5, 3, steps_per_epoch=10, device="cpu")
    state = trainer.init_state(torch.Generator().manual_seed(0))
    rng = np.random.default_rng(0)
    batch = {"lab_image": rng.uniform(-1, 1, (1, 128, 128, 3)).astype(np.float32),
             "unlab_image": rng.uniform(-1, 1, (1, 128, 128, 3)).astype(np.float32),
             "lab_label": rng.integers(0, 5, (1, 128, 128))}
    batch = {k: torch.from_numpy(v) for k, v in batch.items()}
    _, spans = _recorded(lambda: trainer.train_step(state, batch))
    unet = [s for s in spans if s.name.startswith("unet.")]
    assert {spans[s.parent].name for s in unet} == {"g_forward"}
    # three generator applies a step: G_i2l on [unlab; lab], G_l2i on
    # [onehot; fake_lab], G_i2l on fake_img
    per_apply = collections.Counter(_expected(LEVELS["unet_128"]))
    assert collections.Counter(s.name for s in unet) == {k: 3 * v for k, v in per_apply.items()}
