"""The port's test-time augmentation (``tta.py``, ``--eval_flip`` /
``--eval_scales``) against the JAX package, on the CPU.

- ``flip_avg`` is ``0.5 * (f(x) + hflip(f(hflip(x))))`` in float32, and is
  flip-equivariant on a real generator (atol 1e-5).
- The resize is ``jax.image.resize(..., "linear")``'s, antialiased when it
  shrinks: within 1e-5 of it at scales 0.75 and 1.25 (float32 sums in
  another order; 5e-7 measured on an x86 CPU). ``scale_avg`` on
  a ``resnet_6blocks`` segmenter (ngf 4, 24x24) with the JAX weights
  bridged in: within 5e-5 of the JAX ``scale_avg`` at (0.75, 1.0, 1.25)
  (the forward bar).
- ``parse_scales``, ``snapped_dims`` and ``validate_tile_scales`` agree
  with the JAX ones; the runner rejects a window-shrinking scale at set-up
  and composes tile, flip and scales in the JAX order.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from cyclegan_tpu import tta as jtta
from cyclegan_tpu.train.supervised import SupervisedTrainer as JaxTrainer
from cyclegan_tpu.utils import config as jconfig
from cyclegan_tpu_torch import eval_tile, tta, weights
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
    kw = dict(gen_net="resnet_6blocks", ngf=4, bf16=False, crop_height=H, crop_width=W,
              dataset="synthetic")
    jt = JaxTrainer(jconfig.Config(**kw), N_CLASSES, 3, steps_per_epoch=1)
    js = jt.init_state(jax.random.PRNGKey(0))
    tt = SupervisedTrainer(Config(**kw), N_CLASSES, 3, 1, device="cpu")
    tt.init_state(torch.Generator().manual_seed(0))
    weights.load_flax_module(tt.model, jax.device_get(js.params))
    return jt, js.params, tt


def _images(n, h=H, w=W, seed=3):
    return np.random.default_rng(seed).standard_normal((n, h, w, 3)).astype(np.float32)


def test_flip_avg_math_and_equivariance(pair):
    def f(x):  # asymmetric in W, so the flip matters
        return torch.stack([x[..., 0], torch.cumsum(x[..., 0], dim=2)], -1)

    x = torch.from_numpy(_images(2))
    got = tta.flip_avg(f)(x)
    manual = 0.5 * (f(x) + f(x.flip(2)).flip(2))
    torch.testing.assert_close(got, manual, rtol=1e-6, atol=0)
    assert got.dtype == torch.float32
    ref = jtta.flip_avg(lambda p, t: jnp.stack([t[..., 0], jnp.cumsum(t[..., 0], axis=2)],
                                               -1))(None, jnp.asarray(x.numpy()))
    np.testing.assert_allclose(got.numpy(), np.asarray(ref), rtol=1e-6, atol=1e-6)
    _, _, tt = pair
    fn = tta.flip_avg(tt.logits)
    a, b = fn(x[:1]), fn(x[:1].flip(2)).flip(2)
    torch.testing.assert_close(a, b, atol=1e-5, rtol=0)


def test_parse_scales_and_snap_match_jax():
    for spec in (None, "", "0.75,1.0,1.25", "0.5, 2"):
        assert tta.parse_scales(spec) == jtta.parse_scales(spec)
    with pytest.raises(ValueError, match="eval_scales"):
        tta.parse_scales("1.0,-2")
    for h, w, s in [(256, 256, 0.75), (192, 320, 0.5), (24, 24, 1.25), (100, 100, 0.03)]:
        assert tta.snapped_dims(h, w, s) == jtta.snapped_dims(h, w, s)
        assert tta.snapped_dims(h, w, s) == (max(round(h * s / 4) * 4, 4),
                                             max(round(w * s / 4) * 4, 4))
    tta.validate_tile_scales((256, 256), (224, 224), (1.0, 1.25))
    tta.validate_tile_scales((256, 256), (224, 224), None)
    with pytest.raises(ValueError, match="192x192"):
        tta.validate_tile_scales((256, 256), (224, 224), (0.75, 1.0))


@pytest.mark.parametrize("hw", [(18, 18), (30, 30), (12, 20)])
def test_resize_matches_jax_image_resize(hw):
    x = _images(2, 24, 24, seed=4)
    ref = jax.image.resize(jnp.asarray(x), (2, *hw, 3), "linear")
    np.testing.assert_allclose(tta.resize(torch.from_numpy(x), hw).numpy(), np.asarray(ref),
                               atol=1e-5, rtol=0)


def test_scale_avg_matches_jax(pair):
    jt, params, tt = pair
    scales = (0.75, 1.0, 1.25)
    x = _images(2, seed=5)
    ref = np.asarray(jtta.scale_avg(jax.jit(jt.logits), scales)(params, jnp.asarray(x)))
    got = tta.scale_avg(tt.logits, scales)(torch.from_numpy(x)).numpy()
    np.testing.assert_allclose(got, ref, atol=5e-5)
    with pytest.raises(ValueError, match="at least one scale"):
        tta.scale_avg(tt.logits, ())


def test_runner_rejects_bad_tile_scales_at_setup(pair):
    _, _, tt = pair
    cfg = Config(crop_height=H, crop_width=W, eval_resize="tile", resize_height=32,
                 resize_width=32, eval_scales="0.5,1.0")
    with pytest.raises(ValueError, match="sliding window"):
        runner._make_eval_fns(cfg, tt)
    runner._make_eval_fns(cfg.replace(resize_height=48, resize_width=48), tt)


def test_runner_composes_tile_flip_and_scales(pair):
    """predict == argmax of scale_avg(flip_avg(tiled canvas logits)), and
    the eval step's confusion matrix follows the same argmax."""
    _, _, tt = pair
    cfg = Config(crop_height=H, crop_width=W, eval_resize="tile", resize_height=32,
                 resize_width=40, eval_flip=True, eval_scales="0.75,1.0")
    eval_fn, predict = runner._make_eval_fns(cfg, tt)
    x = torch.from_numpy(_images(1, 32, 40, seed=6))

    def canvas(img):
        return eval_tile.tiled_logits(tt.logits, img, (H, W))

    manual = tta.scale_avg(tta.flip_avg(canvas), (0.75, 1.0))(x).argmax(-1)
    got = predict(x)
    assert got.dtype == torch.uint8
    assert torch.equal(got.long(), manual)
    plain = runner._make_eval_fns(cfg.replace(eval_flip=False, eval_scales=None), tt)[1](x)
    assert (plain.long() != manual).any()  # the TTA changed something
    label = torch.from_numpy(np.random.default_rng(0).integers(0, N_CLASSES, (1, 32, 40)))
    hist = eval_fn({"image": x, "label": label})
    assert int(hist.trace()) == int((manual == label).sum())
