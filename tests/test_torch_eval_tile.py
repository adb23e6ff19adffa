"""The port's tiled evaluation (``eval_tile.py``, ``--eval_resize tile``)
against the JAX package, on the CPU.

The window grid covers the canvas with the last window pinned; for a
pointwise "model" the overlap average equals the direct application (atol
1e-6); at canvas == window it is the plain eval, bitwise; on a
``resnet_6blocks`` segmenter (ngf 4, 24x24 windows) with the JAX weights
bridged in, the tiled logits of a 48x36 canvas are within 5e-5 of the JAX
``tiled_logits`` (the forward bar); ``_eval_shaping`` validates a canvas as
the JAX runner does.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from cyclegan_tpu import eval_tile as jtile
from cyclegan_tpu.train import runner as jrunner
from cyclegan_tpu.train.supervised import SupervisedTrainer as JaxTrainer
from cyclegan_tpu.utils import config as jconfig
from cyclegan_tpu_torch import eval_tile, weights
from cyclegan_tpu_torch.train import runner
from cyclegan_tpu_torch.train.supervised import SupervisedTrainer
from cyclegan_tpu_torch.utils.config import Config

H = W = 24
N_CLASSES = 5


@pytest.fixture(autouse=True, scope="module")
def _few_torch_threads():
    """Two intra-op threads: the suite runs several workers on one host."""
    n = torch.get_num_threads()
    torch.set_num_threads(2)
    yield
    torch.set_num_threads(n)


@pytest.fixture(scope="module")
def pair():
    kw = dict(gen_net="resnet_6blocks", ngf=4, bf16=False, crop_height=H, crop_width=W)
    jt = JaxTrainer(jconfig.Config(**kw), N_CLASSES, 3, steps_per_epoch=1)
    js = jt.init_state(jax.random.PRNGKey(0))
    tt = SupervisedTrainer(Config(**kw), N_CLASSES, 3, 1, device="cpu")
    tt.init_state(torch.Generator().manual_seed(0))
    weights.load_flax_module(tt.model, jax.device_get(js.params))
    return jt, js.params, tt


def _images(n, h, w, seed=3):
    return np.random.default_rng(seed).uniform(-1, 1, (n, h, w, 3)).astype(np.float32)


def test_window_positions_cover_and_pin():
    assert eval_tile.window_positions(64, 32, 16) == [0, 16, 32]
    assert eval_tile.window_positions(70, 32, 16) == [0, 16, 32, 38]
    assert eval_tile.window_positions(32, 32, 16) == [0]
    assert eval_tile.window_positions(20, 32, 16) == [0]
    for size, win, stride in ((192, 128, 64), (100, 24, 12), (37, 24, 12), (5, 8, 4)):
        assert eval_tile.window_positions(size, win, stride) == \
            jtile.window_positions(size, win, stride)


def test_overlap_average_is_exact_for_pointwise_model():
    """Every window gives a pixel the same logits, so the average equals
    the direct application: the gather, scatter and normalise alone."""
    x = _images(2, 70, 52)

    def pointwise(t):
        return torch.cat([2.0 * t, -t], dim=-1)

    got = eval_tile.tiled_logits(pointwise, torch.from_numpy(x), (32, 32))
    assert got.dtype == torch.float32 and got.shape == (2, 70, 52, 6)
    np.testing.assert_allclose(got.numpy(), pointwise(torch.from_numpy(x)).numpy(),
                               rtol=0, atol=1e-6)
    ref = jtile.tiled_logits(lambda p, t: jnp.concatenate([p * t, -t], -1), 2.0,
                             jnp.asarray(x), (32, 32))
    np.testing.assert_allclose(got.numpy(), np.asarray(ref), rtol=0, atol=1e-6)
    with pytest.raises(ValueError, match="smaller than the window"):
        eval_tile.tiled_logits(pointwise, torch.from_numpy(x), (80, 32))


def test_canvas_equals_window_matches_plain_eval(pair):
    _, _, tt = pair
    r = np.random.default_rng(1)
    batch = {"image": torch.from_numpy(_images(2, H, W)),
             "label": torch.from_numpy(r.integers(0, N_CLASSES, (2, H, W)))}
    assert torch.equal(tt.eval_step(batch), eval_tile.tiled_eval_step(tt, batch, (H, W)))


def test_tiled_logits_match_jax(pair):
    jt, params, tt = pair
    x = _images(1, 48, 36, seed=2)
    ref = np.asarray(jtile.tiled_logits(jax.jit(jt.logits), params, jnp.asarray(x), (H, W)))
    got = eval_tile.tiled_logits(tt.logits, torch.from_numpy(x), (H, W)).numpy()
    np.testing.assert_allclose(got, ref, atol=5e-5)
    pred = eval_tile.tiled_predict(tt, torch.from_numpy(x), (H, W))
    assert pred.shape == (1, 48, 36)


def test_eval_shaping_validation_matches_jax():
    base = dict(crop_height=24, crop_width=24, eval_resize="tile")
    for bad, match in ((dict(), "resize_height"),
                       (dict(resize_height=20, resize_width=48), "smaller"),
                       (dict(resize_height=50, resize_width=48), "divisible by 4")):
        for mod, cfg_cls in ((runner, Config), (jrunner, jconfig.Config)):
            with pytest.raises(ValueError, match=match):
                mod._eval_shaping(cfg_cls(**base, **bad))
    for kw in (dict(base, resize_height=48, resize_width=36),
               dict(crop_height=24, crop_width=24, eval_resize="center_crop")):
        assert runner._eval_shaping(Config(**kw)) == jrunner._eval_shaping(jconfig.Config(**kw))
    assert runner._eval_shaping(Config(**base, resize_height=48, resize_width=36)) == \
        ((48, 36), "resize")
