"""The port's ``norm='batch'`` against the JAX package, on the CPU.

- ``ops.blocks.BatchNorm`` against Flax ``nn.BatchNorm(momentum=0.9,
  epsilon=1e-5, dtype=float32)`` in train and eval mode, float32 and bf16
  inputs (a float32 result either way): outputs and running averages within
  5e-5 after 3 train-mode forwards.
- The running-variance EMA is fed the BIASED batch variance: a case where
  stock ``nn.BatchNorm2d`` (unbiased) is off by n/(n-1).
- The ``batch_stats`` bridge, both ways, for a ResNet generator, a U-Net
  and a PatchGAN.
- The CycleGAN ``train_step`` with ``norm='batch'`` against the jitted JAX
  step (ngf 8, 32x32, 2 trunk blocks, batch 2, float32, pool 0), 3 steps:
  losses within the 3-step bars (``g_total`` rtol 2e-3, ``d_total`` rtol
  1e-2 / atol 1e-3); every running average of both generators and both
  discriminators after step 1 within 5e-5 (absolute, relative above 1),
  which holds the order of the applies (the discriminators' statistics move
  in the G phase too), and after step 3 within the 3-step bar 2e-3: Adam's
  first updates move every weight by about +-lr whatever its gradient's
  size, and the gradient of a bias before a batch norm is zero in exact
  arithmetic, rounding noise in float, so the two sides' biases land up to
  2 lr a step apart (1.2e-3 after 3 steps, a running mean 2.8e-4 apart on
  an x86 CPU).
"""

import flax.linen as fnn
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from cyclegan_tpu.models.discriminators import define_Dis as jax_define_Dis
from cyclegan_tpu.models.generators import ResnetGenerator as JaxResnet
from cyclegan_tpu.models.generators import UnetGenerator as JaxUnet
from cyclegan_tpu.train.cyclegan import CycleGANTrainer as JaxTrainer
from cyclegan_tpu.utils import config as jconfig
from cyclegan_tpu_torch import weights
from cyclegan_tpu_torch.models import define_Dis
from cyclegan_tpu_torch.models.generators import ResnetGenerator, UnetGenerator
from cyclegan_tpu_torch.ops.blocks import BatchNorm, get_norm
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


def _close(got, ref, tol=TOL, what=""):
    got, ref = np.asarray(got, np.float32), np.asarray(ref, np.float32)
    err = np.abs(got - ref) / np.maximum(np.abs(ref), 1.0)
    assert float(err.max()) <= tol, (what, float(err.max()))


def _leaves(tree: dict) -> dict:
    return {"/".join(str(k.key) for k in p): np.asarray(v)
            for p, v in jax.tree_util.tree_leaves_with_path(tree)}


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_batch_norm_matches_flax_train_and_eval(dtype):
    r = np.random.default_rng(0)
    xs = [(r.standard_normal((4, 6, 5, 7)) * 3 + 1).astype(np.float32) for _ in range(3)]
    jdt, tdt = (jnp.float32, torch.float32) if dtype == "float32" else \
        (jnp.bfloat16, torch.bfloat16)
    fb = fnn.BatchNorm(momentum=0.9, epsilon=1e-5, dtype=jnp.float32)
    v = fb.init(jax.random.PRNGKey(0), jnp.asarray(xs[0], jdt), use_running_average=False)
    scale = r.uniform(0.5, 1.5, 7).astype(np.float32)
    bias = r.standard_normal(7).astype(np.float32)
    v = {"params": {"scale": jnp.asarray(scale), "bias": jnp.asarray(bias)},
         "batch_stats": v["batch_stats"]}
    bn = BatchNorm(7)
    with torch.no_grad():
        bn.weight.copy_(torch.from_numpy(scale))
        bn.bias.copy_(torch.from_numpy(bias))
    bn.train()
    for x in xs:
        jy, upd = fb.apply(v, jnp.asarray(x, jdt), use_running_average=False,
                           mutable=["batch_stats"])
        v = {**v, **upd}
        ty = bn(torch.from_numpy(x).to(tdt).permute(0, 3, 1, 2))
        assert ty.dtype == torch.float32 and jy.dtype == jnp.float32
        _close(ty.detach().permute(0, 2, 3, 1).numpy(), jy, what="train")
    _close(bn.running_mean.numpy(), v["batch_stats"]["mean"], what="mean")
    _close(bn.running_var.numpy(), v["batch_stats"]["var"], what="var")
    bn.eval()
    jy = fb.apply(v, jnp.asarray(xs[0], jdt), use_running_average=True)
    with torch.no_grad():
        ty = bn(torch.from_numpy(xs[0]).to(tdt).permute(0, 3, 1, 2))
    _close(ty.permute(0, 2, 3, 1).numpy(), jy, what="eval")


def test_running_variance_takes_the_biased_batch_variance():
    """Two values a channel: the biased variance is half the unbiased one,
    so stock BatchNorm2d's running variance is off by a factor the port's
    must not show."""
    x = torch.tensor([1.0, 3.0]).view(2, 1, 1, 1)   # mean 2, biased var 1, unbiased 2
    bn = BatchNorm(1).train()
    bn(x)
    assert float(bn.running_mean) == pytest.approx(0.2)
    assert float(bn.running_var) == pytest.approx(0.9 * 1 + 0.1 * 1.0)
    stock = torch.nn.BatchNorm2d(1, momentum=0.1).train()
    stock(x)
    assert float(stock.running_var) == pytest.approx(0.9 + 0.1 * 2.0)
    assert float(stock.running_var) != pytest.approx(float(bn.running_var))
    # Frozen (a recomputed forward under remat): batch statistics, no EMA.
    bn.frozen = True
    y = bn(x)
    assert float(bn.running_mean) == pytest.approx(0.2)
    torch.testing.assert_close(y.flatten(), torch.tensor([-1.0, 1.0]), atol=1e-4, rtol=0)
    assert get_norm("batch")(3).running_var.shape == (3,)


@pytest.mark.parametrize("net", ["resnet", "unet", "patchgan"])
def test_batch_stats_bridge_round_trips(net):
    r = np.random.default_rng(1)
    x = jnp.asarray(r.uniform(-1, 1, (1, 32, 32, 3)).astype(np.float32))
    if net == "resnet":
        jm, tm = JaxResnet(4, ngf=4, n_blocks=1, norm="batch"), \
            ResnetGenerator(3, 4, 4, 1, norm="batch")
    elif net == "unet":
        jm, tm = JaxUnet(4, num_downs=5, ngf=4, norm="batch"), \
            UnetGenerator(3, 4, 5, 4, norm="batch")
    else:
        jm, tm = jax_define_Dis(4, "n_layers", 3, "batch"), define_Dis(3, 4, norm="batch")
    v = jax.device_get(jm.init(jax.random.PRNGKey(0), x))
    v = jax.tree.map(lambda a: a + r.standard_normal(a.shape).astype(np.float32), v)
    weights.load_flax_module(tm, v)
    back = weights.flax_variables(tm)
    assert set(back) == {"params", "batch_stats"}
    ref, got = _leaves(v), _leaves(back)
    assert ref.keys() == got.keys()
    for k in ref:
        np.testing.assert_array_equal(got[k], ref[k], err_msg=k)
    n_bn = sum(isinstance(m, BatchNorm) for m in tm.modules())
    assert n_bn and len(_leaves(v["batch_stats"])) == 2 * n_bn
    with pytest.raises(KeyError, match="batch_stats"):
        weights.load_flax_module(tm, v["params"], batch_stats={})


# ------------------------------------------------------- the CycleGAN step
N_CLASSES, SIZE, NGF, NB, B = 5, 32, 8, 2, 2


def _pair():
    kw = dict(gen_net="resnet_6blocks", ngf=NGF, ndf=NGF, norm="batch", bf16=False,
              crop_height=SIZE, crop_width=SIZE, batch_size=B, pool_size=0, epochs=200,
              decay_epoch=100)
    jt = JaxTrainer(jconfig.Config(**kw), N_CLASSES, 3, steps_per_epoch=1000)
    jt.G_i2l = jt.G_i2l.clone(n_blocks=NB)
    jt.G_l2i = jt.G_l2i.clone(n_blocks=NB)
    js = jt.init_state(jax.random.PRNGKey(0))
    tt = CycleGANTrainer(tconfig.Config(**dict(kw, gen_net=f"resnet_{NB}blocks")), N_CLASSES,
                         3, steps_per_epoch=1000, device="cpu")
    ts = tt.init_state(torch.Generator().manual_seed(0))
    weights.load_flax_cyclegan(tt, js)
    return jt, js, tt, ts


def test_cyclegan_step_with_batch_norm_matches_jax():
    jt, js, tt, ts = _pair()
    r = np.random.default_rng(5)
    lab = r.integers(0, N_CLASSES, (B, SIZE, SIZE)).astype(np.int32)
    lab[:, :3] = 255
    batch = {"lab_image": r.uniform(-1, 1, (B, SIZE, SIZE, 3)).astype(np.float32),
             "unlab_image": r.uniform(-1, 1, (B, SIZE, SIZE, 3)).astype(np.float32),
             "lab_label": lab}
    step = jax.jit(jt.train_step)
    for s, tol in enumerate((TOL, 2e-3, 2e-3)):
        js, jm = step(js, {k: jnp.asarray(v) for k, v in batch.items()})
        ts, tm = tt.train_step(ts, {k: torch.from_numpy(v) for k, v in batch.items()})
        np.testing.assert_allclose(float(tm["g_total"]), float(jm["g_total"]), rtol=2e-3,
                                   err_msg=f"g_total, step {s}")
        np.testing.assert_allclose(float(tm["d_total"]), float(jm["d_total"]), rtol=1e-2,
                                   atol=1e-3, err_msg=f"d_total, step {s}")
        if s == 1:
            continue
        for key, attr in weights.CYCLEGAN_NETS:
            ref = _leaves(jax.device_get(getattr(js, key))["batch_stats"])
            got = _leaves(weights.flax_variables(getattr(tt, attr))["batch_stats"])
            assert ref.keys() == got.keys() and ref, key
            for k in ref:
                _close(got[k], ref[k], tol, what=f"step {s + 1} {key}/{k}")
    # Eval mode reads the running averages: the logits of both agree.
    img = batch["lab_image"]
    ref = np.asarray(jt.G_i2l.apply(js.g_i2l, jnp.asarray(img)))
    _close(tt.logits(torch.from_numpy(img)).numpy(), ref, 2e-3, "eval logits")
    assert tt.G_i2l.training  # logits left the net in train mode
