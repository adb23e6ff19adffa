"""The port's train step against the JAX step over 30 steps, on the CPU.

Both start from the JAX init (bridged into the port by
``weights.load_flax_cyclegan``) at the ``make_cyclegan_pair`` size (ngf 8,
ndf 8, 5 classes, 32x32, 2 trunk blocks, float32), pool 0, LR far from its
decay, and take 30 steps on the fixed batch of
``parity_utils.make_fixed_batch`` (the one the JAX test's bars were set
on: unit normal images, so the logits stay near-uniform). The bars are those of
``tests/test_train_parity.py::test_thirty_step_curve_parity``: the
per-step ``g_total`` gap relative to the JAX value, mean < 1% and max < 2%,
and the trained segmenters' argmax agreement on the labeled image > 0.85
(after 30 GAN steps float32 noise has grown past any elementwise bar).
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from parity_utils import make_fixed_batch

from cyclegan_tpu.train.cyclegan import CycleGANTrainer as JaxTrainer
from cyclegan_tpu.utils import config as jconfig
from cyclegan_tpu_torch import weights
from cyclegan_tpu_torch.train.cyclegan import CycleGANTrainer
from cyclegan_tpu_torch.utils import config as tconfig

N_CLASSES, SIZE, NGF, NDF, NB = 5, 32, 8, 8, 2
STEPS = 30


@pytest.fixture(autouse=True, scope="module")
def _few_torch_threads():
    """Two intra-op threads: the suite runs several workers on one host,
    and torch's default (a thread per core in every worker) oversubscribes
    it many times over."""
    n = torch.get_num_threads()
    torch.set_num_threads(2)
    yield
    torch.set_num_threads(n)


def _pair():
    kw = dict(ngf=NGF, ndf=NDF, crop_height=SIZE, crop_width=SIZE, bf16=False,
              epochs=200, decay_epoch=100, pool_size=0)
    jt = JaxTrainer(jconfig.Config(gen_net="resnet_6blocks", **kw), N_CLASSES, 3,
                    steps_per_epoch=1000)
    jt.G_i2l = jt.G_i2l.clone(n_blocks=NB)
    jt.G_l2i = jt.G_l2i.clone(n_blocks=NB)
    js = jt.init_state(jax.random.PRNGKey(0))
    tt = CycleGANTrainer(tconfig.Config(gen_net=f"resnet_{NB}blocks", **kw), N_CLASSES, 3,
                         steps_per_epoch=1000, device="cpu")
    ts = tt.init_state(torch.Generator().manual_seed(0))
    weights.load_flax_cyclegan(tt, js)
    return jt, js, tt, ts


def test_thirty_step_curve_matches_jax():
    jt, js, tt, ts = _pair()
    _, jb = make_fixed_batch(N_CLASSES, SIZE)
    tb = {k: torch.tensor(np.asarray(v)) for k, v in jb.items()}
    step_jit = jax.jit(jt.train_step, donate_argnums=0)
    j_curve, t_curve = [], []
    for _ in range(STEPS):
        js, jm = step_jit(js, jb)
        ts, tm = tt.train_step(ts, tb)
        j_curve.append(float(jm["g_total"]))
        t_curve.append(float(tm["g_total"]))
    j, t = np.array(j_curve), np.array(t_curve)
    rel = np.abs(t - j) / np.maximum(np.abs(j), 1e-6)
    assert rel.mean() < 0.01, (rel.mean(), list(rel))
    assert rel.max() < 0.02, (rel.max(), list(rel))
    ref = np.asarray(jnp.argmax(jt.G_i2l.apply(js.g_i2l, jb["lab_image"]), -1))
    got = tt.predict(tb["lab_image"]).numpy()
    agreement = (got == ref).mean()
    print(f"g_total gap mean {rel.mean():.5f} max {rel.max():.5f}; argmax agreement "
          f"{agreement:.4f} ({torch.get_num_threads()} torch threads)")
    assert agreement > 0.85, f"argmax agreement {agreement:.3f}"
