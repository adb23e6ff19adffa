"""BASELINE configs 3 and 4's shapes through the port's train step, against
the JAX package, on the CPU.

``tests/test_integration.py::TestShapeConfigs`` holds the JAX step on a
non-square crop with 19 classes (Cityscapes, ``cityscapes_semisup_512x256``
cut to 32x64) and on one channel with 4 classes (ACDC, ``acdc_semisup``).
Here the port's ``CycleGANTrainer.train_step`` is held against the jitted
JAX step on the same bridged weights, batches and injected pool decisions
(ngf 8, ndf 8, 2 trunk blocks, batch 2, pools of 2, float32): ``g_total``
and ``d_total`` within rtol 2e-3 (atol 1e-3 for ``d_total``) at each of 3
steps, the final G_i2l logits within 2e-3, and the fake image of the
1-channel config with 1 channel.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from cyclegan_tpu.train.cyclegan import CycleGANTrainer as JaxTrainer
from cyclegan_tpu.utils import config as jconfig
from cyclegan_tpu_torch import weights
from cyclegan_tpu_torch.train.cyclegan import CycleGANTrainer
from cyclegan_tpu_torch.utils import config as tconfig

NB, B, POOL, STEPS, TOL = 2, 2, 2, 3, 2e-3
CONFIGS = {  # name -> (H, W, classes, channels)
    "cityscapes_32x64_19_classes": (32, 64, 19, 3),
    "acdc_1_channel_4_classes": (32, 32, 4, 1),
}


@pytest.fixture(autouse=True, scope="module")
def _few_torch_threads():
    n = torch.get_num_threads()
    torch.set_num_threads(2)
    yield
    torch.set_num_threads(n)


def _pair(h: int, w: int, n_cls: int, ch: int):
    kw = dict(ngf=8, ndf=8, crop_height=h, crop_width=w, bf16=False, batch_size=B,
              pool_size=POOL, epochs=200, decay_epoch=100)
    jt = JaxTrainer(jconfig.Config(gen_net="resnet_6blocks", **kw), n_cls, ch,
                    steps_per_epoch=1000)
    jt.G_i2l = jt.G_i2l.clone(n_blocks=NB)
    jt.G_l2i = jt.G_l2i.clone(n_blocks=NB)
    js = jt.init_state(jax.random.PRNGKey(0))
    tt = CycleGANTrainer(tconfig.Config(gen_net=f"resnet_{NB}blocks", **kw), n_cls, ch,
                         steps_per_epoch=1000, device="cpu")
    ts = tt.init_state(torch.Generator().manual_seed(0))
    weights.load_flax_cyclegan(tt, js)
    return jt, js, tt, ts


def _batches(h: int, w: int, n_cls: int, ch: int) -> list[dict]:
    r = np.random.default_rng(11)
    out = []
    for _ in range(STEPS):
        lab = r.integers(0, n_cls, (B, h, w)).astype(np.int32)
        lab[:, :2] = 255  # a void border
        out.append({"lab_image": r.uniform(-1, 1, (B, h, w, ch)).astype(np.float32),
                    "unlab_image": r.uniform(-1, 1, (B, h, w, ch)).astype(np.float32),
                    "lab_label": lab,
                    "pool_use_new_img": r.random(B) > 0.5,
                    "pool_idx_img": r.integers(0, POOL, B).astype(np.int32),
                    "pool_use_new_lab": r.random(B) > 0.5,
                    "pool_idx_lab": r.integers(0, POOL, B).astype(np.int32)})
    return out


@pytest.mark.parametrize("name", list(CONFIGS))
def test_config_train_steps_match_jax(name):
    h, w, n_cls, ch = CONFIGS[name]
    jt, js, tt, ts = _pair(h, w, n_cls, ch)
    step = jax.jit(jt.train_step)
    batches = _batches(h, w, n_cls, ch)
    for s, b in enumerate(batches):
        js, jm = step(js, {k: jnp.asarray(v) for k, v in b.items()})
        ts, tm = tt.train_step(ts, {k: torch.from_numpy(np.asarray(v)) for k, v in b.items()})
        assert set(tm) == set(jm)
        np.testing.assert_allclose(float(tm["g_total"]), float(jm["g_total"]), rtol=TOL,
                                   err_msg=f"{name} g_total, step {s + 1}")
        np.testing.assert_allclose(float(tm["d_total"]), float(jm["d_total"]), rtol=TOL,
                                   atol=1e-3, err_msg=f"{name} d_total, step {s + 1}")
    img = batches[0]["lab_image"]
    ref = np.asarray(jt.G_i2l.apply(js.g_i2l, jnp.asarray(img)))
    got = tt.logits(torch.from_numpy(img)).numpy()
    assert got.shape == (B, h, w, n_cls)
    np.testing.assert_allclose(got, ref, atol=TOL)
    fake = tt.generate_image(torch.from_numpy(batches[0]["lab_label"]))
    assert fake.shape == (B, h, w, ch)
    assert tuple(ts.pool_img.buffer.shape) == (POOL, h, w, ch)
