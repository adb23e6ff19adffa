"""The port's U-Net generators against the JAX ``UnetGenerator``, on the CPU.

- ``unet_128`` and ``unet_256`` (7 and 8 levels) at ngf 4 on bridged
  weights, each norm: the forward within 5e-5 of ``UnetGenerator.apply``.
- Dropout at the middle levels on the Flax masks (recovered with
  ``capture_intermediates``, as ``tests/test_torch_dropout.py`` does, and
  injected through ``blocks.dropout_keep``): forward, input and weight
  gradients within 5e-5 (relative to the largest entry above 1).
- One CycleGAN step with U-Net generators (5 levels at 32x32, ngf 8,
  float32, pool 0) against the jitted JAX step, as
  ``tests/test_config_variants.py`` trains one: 3 steps within the 3-step
  bars (``g_total`` rtol 2e-3, ``d_total`` rtol 1e-2 / atol 1e-3).
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from cyclegan_tpu.models.generators import UnetGenerator as JaxUnet
from cyclegan_tpu.train.cyclegan import CycleGANTrainer as JaxTrainer
from cyclegan_tpu.utils import config as jconfig
from cyclegan_tpu_torch import weights
from cyclegan_tpu_torch.models.generators import UnetGenerator, define_Gen
from cyclegan_tpu_torch.ops import blocks
from cyclegan_tpu_torch.train.cyclegan import CycleGANTrainer
from cyclegan_tpu_torch.utils import config as tconfig

TOL = 5e-5


@pytest.fixture(autouse=True, scope="module")
def _few_torch_threads():
    """Two intra-op threads: the suite runs several workers on one host."""
    n = torch.get_num_threads()
    torch.set_num_threads(2)
    yield
    torch.set_num_threads(n)


def _close_to_max(got, ref, rel=TOL):
    got, ref = np.asarray(got), np.asarray(ref)
    err = float(np.abs(got - ref).max()) / max(float(np.abs(ref).max()), 1.0)
    assert err <= rel, err


@pytest.mark.parametrize("norm", ["instance", "batch", "none"])
@pytest.mark.parametrize("name,downs", [("unet_128", 7), ("unet_256", 8)])
def test_unet_forward_matches_flax(name, downs, norm):
    size = 2 ** downs
    x = np.random.default_rng(downs).uniform(-1, 1, (1, size, size, 3)).astype(np.float32)
    jm = JaxUnet(5, num_downs=downs, ngf=4, norm=norm, head="tanh")
    variables = jax.device_get(jm.init(jax.random.PRNGKey(0), jnp.asarray(x)))
    ref = np.asarray(jm.apply(variables, jnp.asarray(x)))
    G = define_Gen(3, 5, 4, name, norm, head="tanh").eval()
    assert len(G.levels()) == downs
    weights.load_flax_module(G, variables)
    with torch.no_grad():
        got = G(torch.from_numpy(x).permute(0, 3, 1, 2)).permute(0, 2, 3, 1).numpy()
    assert got.shape == ref.shape == (1, size, size, 5)
    np.testing.assert_allclose(got, ref, atol=TOL)


def test_unet_dropout_on_injected_masks_matches_flax(monkeypatch):
    """6 levels at 64x64: one middle level, which drops after its up norm."""
    r = np.random.default_rng(4)
    x = r.uniform(-1, 1, (2, 64, 64, 3)).astype(np.float32)
    r_out = r.standard_normal((2, 64, 64, 5)).astype(np.float32)
    jm = JaxUnet(5, num_downs=6, ngf=4, use_dropout=True, head="none")
    variables = jm.init({"params": jax.random.PRNGKey(0), "dropout": jax.random.PRNGKey(9)},
                        jnp.asarray(x), deterministic=False)
    rngs = {"dropout": jax.random.PRNGKey(11)}
    out, inter = jm.apply(variables, jnp.asarray(x), deterministic=False, rngs=rngs,
                          capture_intermediates=True, mutable=["intermediates"])
    flat = jax.tree_util.tree_flatten_with_path(inter["intermediates"])[0]
    drops = [v for p, v in flat if "Dropout_0" in str(p)]
    assert len(drops) == 1
    masks = iter([torch.from_numpy(np.array(drops[0] != 0))])

    def keep(shape, p, generator):
        m = next(masks)
        assert tuple(m.shape) == tuple(shape) and p == 0.5
        return m

    monkeypatch.setattr(blocks, "dropout_keep", keep)

    def loss(params, xx):
        y = jm.apply({"params": params}, xx, deterministic=False, rngs=rngs)
        return jnp.sum(y * jnp.asarray(r_out))

    gp, gx = jax.jit(jax.grad(loss, argnums=(0, 1)))(variables["params"], jnp.asarray(x))
    G = UnetGenerator(3, 5, 6, 4, head="none", use_dropout=True).train()
    weights.load_flax_module(G, variables["params"])
    xt = torch.from_numpy(x).permute(0, 3, 1, 2).requires_grad_()
    y = G(xt, torch.Generator())
    np.testing.assert_allclose(y.detach().permute(0, 2, 3, 1).numpy(), np.asarray(out),
                               atol=TOL)
    (y * torch.from_numpy(r_out).permute(0, 3, 1, 2)).sum().backward()
    _close_to_max(xt.grad.permute(0, 2, 3, 1).numpy(), gx)
    for k, level in enumerate(G.levels()):
        ref = gp[f"_UnetBlock_{k}"]
        _close_to_max(level.down.weight.grad.numpy(),
                      np.asarray(ref["down_kernel"]).transpose(3, 2, 0, 1))
        _close_to_max(level.up.weight.grad.numpy(),
                      np.asarray(ref["up_kernel"]).transpose(2, 3, 0, 1))
    # Eval mode never drops (the injected mask stream is spent).
    with torch.no_grad():
        G.eval()(xt.detach(), torch.Generator())


def test_cyclegan_step_with_unet_generators_matches_jax():
    n_cls, size, ngf = 5, 32, 8
    kw = dict(gen_net="unet_128", ngf=ngf, ndf=ngf, crop_height=size, crop_width=size,
              bf16=False, pool_size=0, epochs=200, decay_epoch=100)
    jt = JaxTrainer(jconfig.Config(**kw), n_cls, 3, steps_per_epoch=1000)
    jt.G_i2l = jt.G_i2l.clone(num_downs=5)
    jt.G_l2i = jt.G_l2i.clone(num_downs=5)
    js = jt.init_state(jax.random.PRNGKey(0))
    tt = CycleGANTrainer(tconfig.Config(**kw), n_cls, 3, steps_per_epoch=1000, device="cpu")
    tt.G_i2l = UnetGenerator(3, n_cls, 5, ngf, head="none").to(memory_format=torch.channels_last)
    tt.G_l2i = UnetGenerator(n_cls, 3, 5, ngf, head="tanh").to(memory_format=torch.channels_last)
    ts = tt.init_state(torch.Generator().manual_seed(0))
    weights.load_flax_cyclegan(tt, js)
    r = np.random.default_rng(5)
    lab = r.integers(0, n_cls, (1, size, size)).astype(np.int32)
    lab[:, :3] = 255
    batch = {"lab_image": r.uniform(-1, 1, (1, size, size, 3)).astype(np.float32),
             "unlab_image": r.uniform(-1, 1, (1, size, size, 3)).astype(np.float32),
             "lab_label": lab}
    step = jax.jit(jt.train_step)
    for s in range(3):
        js, jm = step(js, {k: jnp.asarray(v) for k, v in batch.items()})
        ts, tm = tt.train_step(ts, {k: torch.from_numpy(v) for k, v in batch.items()})
        np.testing.assert_allclose(float(tm["g_total"]), float(jm["g_total"]), rtol=2e-3,
                                   err_msg=f"g_total, step {s}")
        np.testing.assert_allclose(float(tm["d_total"]), float(jm["d_total"]), rtol=1e-2,
                                   atol=1e-3, err_msg=f"d_total, step {s}")
