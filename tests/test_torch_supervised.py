"""The port's supervised segmenter (``train/supervised.py``) against the JAX
``SupervisedTrainer``, on the CPU.

Both trainers start from the same weights (the JAX initial variables
bridged into the port, batch-norm statistics included) and see the same
seeded batches (batch 2, 32x32, 4 classes with a void border, float32, ngf
8). Nets: ``resnet_6blocks`` and ``unet_128`` cut to 5 levels (a 32x32
input), as ``tests/test_unet_pixeld_parity.py`` cuts it; norms instance,
batch and none, as ``tests/test_config_variants.py`` parametrises them.

Bars (ROADMAP "Tolerances"): per-step ``ce_loss`` rtol 2e-3 over 3 steps;
the batch norms' running averages after the first update within 5e-5 (both
sides' forwards ran at the same weights), after 3 within 2e-3 (Adam's first
updates move each weight by about +-lr whatever its gradient's size, so a
gradient of rounding size, as every bias before a norm has, lands 2 lr
apart on the two sides); eval-mode logits at the bridged weights within
5e-5.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from cyclegan_tpu.train.supervised import SupervisedTrainer as JaxTrainer
from cyclegan_tpu.utils import config as jconfig
from cyclegan_tpu_torch import weights
from cyclegan_tpu_torch.models.generators import UnetGenerator
from cyclegan_tpu_torch.train.supervised import SupervisedTrainer
from cyclegan_tpu_torch.utils import config as tconfig

N_CLASSES, SIZE, NGF, B = 4, 32, 8, 2


@pytest.fixture(autouse=True, scope="module")
def _few_torch_threads():
    """Two intra-op threads: the suite runs several workers on one host."""
    n = torch.get_num_threads()
    torch.set_num_threads(2)
    yield
    torch.set_num_threads(n)


def _close(got, ref, tol, what=""):
    got, ref = np.asarray(got, np.float32), np.asarray(ref, np.float32)
    err = np.abs(got - ref) / np.maximum(np.abs(ref), 1.0)
    assert float(err.max()) <= tol, (what, float(err.max()))


def _leaves(tree: dict) -> dict:
    return {"/".join(str(k.key) for k in p): np.asarray(v)
            for p, v in jax.tree_util.tree_leaves_with_path(tree)}


def _pair(net: str, norm: str):
    kw = dict(gen_net="resnet_6blocks" if net == "resnet" else "unet_128", ngf=NGF,
              norm=norm, bf16=False, crop_height=SIZE, crop_width=SIZE, batch_size=B,
              epochs=3, decay_epoch=0)
    jt = JaxTrainer(jconfig.Config(**kw), N_CLASSES, 3, steps_per_epoch=1)
    tt = SupervisedTrainer(tconfig.Config(**kw), N_CLASSES, 3, steps_per_epoch=1,
                           device="cpu")
    if net == "unet":
        jt.model = jt.model.clone(num_downs=5)
        tt.model = UnetGenerator(3, N_CLASSES, 5, NGF, norm=norm, head="none") \
            .to(memory_format=torch.channels_last).train()
    js = jt.init_state(jax.random.PRNGKey(0))
    ts = tt.init_state(torch.Generator().manual_seed(0))
    variables = jax.device_get(js.params)
    if norm == "batch":
        # Running averages away from (0, 1), so eval mode reads them.
        r = np.random.default_rng(7)
        variables["batch_stats"] = jax.tree.map(
            lambda a: (a + r.uniform(0.1, 0.5, a.shape)).astype(np.float32),
            variables["batch_stats"])
        js = js._replace(params={**js.params, "batch_stats": variables["batch_stats"]})
    weights.load_flax_module(tt.model, variables)
    return jt, js, tt, ts


def _batches(n: int, seed: int = 3) -> list:
    r = np.random.default_rng(seed)
    out = []
    for _ in range(n):
        lab = r.integers(0, N_CLASSES, (B, SIZE, SIZE)).astype(np.int32)
        lab[:, :2] = 255
        out.append({"image": r.uniform(-1, 1, (B, SIZE, SIZE, 3)).astype(np.float32),
                    "label": lab})
    return out


def _t(batch: dict) -> dict:
    return {k: torch.from_numpy(np.asarray(v)) for k, v in batch.items()}


def _j(batch: dict) -> dict:
    return {k: jnp.asarray(v) for k, v in batch.items()}


def _check_stats(js, tt, tol, what):
    if "batch_stats" not in js.params:
        return
    ref = _leaves(jax.device_get(js.params["batch_stats"]))
    got = _leaves(weights.flax_variables(tt.model)["batch_stats"])
    assert ref.keys() == got.keys() and ref
    for k in ref:
        _close(got[k], ref[k], tol, f"{what} {k}")


@pytest.mark.parametrize("norm", ["instance", "batch", "none"])
@pytest.mark.parametrize("net", ["resnet", "unet"])
def test_train_steps_match_jax(net, norm):
    jt, js, tt, ts = _pair(net, norm)
    step = jax.jit(jt.train_step)
    for s, (batch, tol) in enumerate(zip(_batches(3), (5e-5, 2e-3, 2e-3))):
        js, jm = step(js, _j(batch))
        ts, tm = tt.train_step(ts, _t(batch))
        assert set(tm) == set(jm) == {"ce_loss"}
        np.testing.assert_allclose(float(tm["ce_loss"]), float(jm["ce_loss"]), rtol=2e-3,
                                   err_msg=f"ce_loss, step {s}")
        _check_stats(js, tt, tol, f"step {s + 1}")
    assert ts.step == int(js.step) == 3
    # The learning rate followed the staircase (steps_per_epoch 1, decay
    # from epoch 0 over 3): Adam's lr after 3 updates is 0.
    assert ts.opt.param_groups[0]["lr"] == 0.0


def test_multi_step_and_accum_step_match_jax():
    """multi_step: 2 chained steps; accum_step: one update from 2
    microbatches, the batch norms' statistics chained through both (exact:
    both forwards run at the pre-update weights)."""
    batches = _batches(2, seed=4)
    stack = {k: np.stack([b[k] for b in batches]) for k in batches[0]}
    jt, js, tt, ts = _pair("resnet", "batch")
    js, jm = jax.jit(jt.accum_step)(js, _j(stack))
    ts, tm = tt.accum_step(ts, _t(stack))
    np.testing.assert_allclose(float(tm["ce_loss"]), float(jm["ce_loss"]), rtol=2e-3)
    _check_stats(js, tt, 5e-5, "accum")
    js, jm = jax.jit(jt.multi_step)(js, _j(stack))
    ts, tm = tt.multi_step(ts, _t(stack))
    np.testing.assert_allclose(float(tm["ce_loss"]), float(jm["ce_loss"]), rtol=2e-3)
    _check_stats(js, tt, 2e-3, "multi")
    assert ts.step == int(js.step) == 3


@pytest.mark.parametrize("net", ["resnet", "unet"])
def test_eval_step_and_predict_match_jax(net):
    jt, js, tt, _ = _pair(net, "batch")
    batch = _batches(1, seed=5)[0]
    ref = np.asarray(jax.jit(jt.logits)(js.params, jnp.asarray(batch["image"])))
    got = tt.logits(torch.from_numpy(batch["image"]))
    assert tt.model.training  # eval mode only inside logits
    _close(got.numpy(), ref, 5e-5, "logits")
    top2 = np.sort(ref, axis=-1)[..., -2:]
    decisive = (top2[..., 1] - top2[..., 0]) > 1e-4
    pred = tt.predict(torch.from_numpy(batch["image"])).numpy()
    jpred = np.asarray(jax.jit(jt.predict)(js.params, jnp.asarray(batch["image"])))
    np.testing.assert_array_equal(pred[decisive], jpred[decisive])
    hist = tt.eval_step(_t(batch)).numpy()
    assert int(hist.sum()) == int((batch["label"] != 255).sum())
    if decisive.all():
        np.testing.assert_array_equal(hist, np.asarray(jt.eval_step(js.params, _j(batch))))
