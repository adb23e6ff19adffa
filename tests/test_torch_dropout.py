"""The port's --use_dropout trunk (path B) against the JAX package, on the CPU.

- ``conv_dw_plain`` (the plain version of TPU kernel #8) against the Pallas
  ``conv_dw`` in interpret mode, and the port's ``conv2d_valid_dw_fused``
  forward and VJP against the JAX one (float32; 1e-5 of the largest entry:
  sums of a few hundred products in another order).
- A dropout ``ResidualBlock`` and a ``resnet_2blocks`` generator with
  ``use_dropout=True`` against the Flax modules, with the Flax dropout masks
  recovered by ``capture_intermediates`` (the method of
  ``tests/test_dropout_parity.py``) and injected into the port through
  ``blocks.dropout_keep``: forward, input and weight gradients within 5e-5
  (absolute, or relative to the largest entry for gradients above 1).
  Masks from a torch generator are not the JAX ones, so parity never uses
  seeds.
- The train step with ``use_dropout``: finite losses, the same seed gives
  the same losses, fresh masks every generator forward, and ``logits``,
  ``predict`` and ``generate_image`` never drop.

The CUDA kernel runs only on the card (``tests/test_torch_cuda.py``).
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from cyclegan_tpu.kernels.conv_dw import conv_dw as jax_conv_dw
from cyclegan_tpu.models.generators import ResnetGenerator as JaxResnetGenerator
from cyclegan_tpu.ops import functional as JF
from cyclegan_tpu.ops.blocks import ResidualBlock as JaxResidualBlock
from cyclegan_tpu_torch import weights
from cyclegan_tpu_torch.kernels import _build
from cyclegan_tpu_torch.kernels import conv_dw as CD
from cyclegan_tpu_torch.models.generators import define_Gen
from cyclegan_tpu_torch.ops import blocks
from cyclegan_tpu_torch.ops import functional as F
from cyclegan_tpu_torch.train.cyclegan import CycleGANTrainer
from cyclegan_tpu_torch.utils.config import Config

TOL = 5e-5


def _rng(seed):
    return np.random.default_rng(seed)


def _close_to_max(got, ref, rel):
    got, ref = np.asarray(got), np.asarray(ref)
    err = float(np.abs(got - ref).max()) / max(float(np.abs(ref).max()), 1.0)
    assert err <= rel, err


# ---------------------------------------------------------------- conv_dw
@pytest.mark.parametrize("k", [3, 1])
def test_conv_dw_plain_matches_pallas(k):
    r = _rng(0)
    xp = r.standard_normal((2, 8 + k - 1, 7 + k - 1, 16)).astype(np.float32)
    dy = r.standard_normal((2, 8, 7, 12)).astype(np.float32)
    ref = jax_conv_dw(jnp.asarray(xp), jnp.asarray(dy), k, interpret=True)
    before = _build.launches["cg_conv_dw"]
    got = CD.conv_dw(torch.from_numpy(xp), torch.from_numpy(dy), k)
    assert got.shape == (k, k, 16, 12) and got.dtype == torch.float32
    assert _build.launches["cg_conv_dw"] == before
    _close_to_max(got.numpy(), ref, 1e-5)


def test_conv_dw_refuses_shapes_that_do_not_fit():
    with pytest.raises(ValueError, match="padded"):
        CD.conv_dw(torch.zeros((1, 9, 9, 8)), torch.zeros((1, 8, 8, 8)))


def test_conv2d_valid_dw_fused_forward_and_vjp_match_jax():
    r = _rng(1)
    xp = r.standard_normal((2, 10, 9, 16)).astype(np.float32)
    w = (0.1 * r.standard_normal((3, 3, 16, 24))).astype(np.float32)   # HWIO
    dy = r.standard_normal((2, 8, 7, 24)).astype(np.float32)
    jy, vjp = jax.vjp(JF.conv2d_valid_dw_fused, jnp.asarray(xp), jnp.asarray(w))
    jdxp, jdw = vjp(jnp.asarray(dy))
    txp = torch.from_numpy(xp).permute(0, 3, 1, 2).requires_grad_()
    tw = torch.from_numpy(w).permute(3, 2, 0, 1).requires_grad_()            # OIHW
    y = F.conv2d_valid_dw_fused(txp, tw)
    _close_to_max(y.detach().permute(0, 2, 3, 1).numpy(), jy, 1e-5)
    dxp, dw = torch.autograd.grad(y, [txp, tw], torch.from_numpy(dy).permute(0, 3, 1, 2))
    _close_to_max(dxp.permute(0, 2, 3, 1).numpy(), jdxp, 1e-5)
    _close_to_max(dw.permute(2, 3, 1, 0).numpy(), jdw, 1e-5)


def test_conv_block_routes_trunk_convolutions_through_the_dw_kernel():
    """Reflect-padded 3x3 stride-1 convolutions with Cin, Cout >= 128 (the
    JAX package's rule), and no other."""
    assert blocks.ConvBlock(128, 256, 3, pad=1).dw_fused
    assert not blocks.ConvBlock(64, 256, 3, pad=1).dw_fused
    assert not blocks.ConvBlock(128, 128, 3, stride=2, pad=1, pad_mode="zero").dw_fused
    assert not blocks.ConvBlock(128, 128, 7, pad=3).dw_fused
    assert not blocks.ConvBlock(256, 256, 3, stride=2, pad=1).dw_fused


# ---------------------------------------------------------------- dropout
def _recover_masks(intermediates, prefixes) -> list:
    """The Flax dropout keep-masks, one per prefix (its output is
    input * mask / (1 - p)). Where the dropout input is exactly 0 (after
    the ReLU) the mask is unknowable and irrelevant: the forward is 0 and
    the ReLU's backward kills the cotangent either way."""
    flat = jax.tree_util.tree_flatten_with_path(intermediates)[0]
    masks = []
    for prefix in prefixes:
        outs = [v for path, v in flat if "Dropout_0" in str(path) and prefix in str(path)]
        assert len(outs) == 1, [str(p) for p, _ in flat]
        masks.append(torch.from_numpy(np.array(outs[0] != 0)))
    return masks


def _inject(monkeypatch, masks):
    it = iter(masks)

    def keep(shape, p, generator):
        m = next(it)
        assert tuple(m.shape) == tuple(shape) and p == 0.5
        return m

    monkeypatch.setattr(blocks, "dropout_keep", keep)


def _flax_run(module, x, r_out, key):
    variables = module.init({"params": jax.random.PRNGKey(0), "dropout": jax.random.PRNGKey(9)},
                            jnp.asarray(x), deterministic=False)
    rngs = {"dropout": key}
    out, inter = module.apply(variables, jnp.asarray(x), deterministic=False, rngs=rngs,
                              capture_intermediates=True, mutable=["intermediates"])

    def loss(params, xx):
        y = module.apply({"params": params}, xx, deterministic=False, rngs=rngs)
        return jnp.sum(y * jnp.asarray(r_out))

    gp, gx = jax.jit(jax.grad(loss, argnums=(0, 1)))(variables["params"], jnp.asarray(x))
    return variables["params"], np.asarray(out), inter["intermediates"], gp, np.asarray(gx)


def _compare_grads(layers, gp, where=""):
    for name, dst in layers.items():
        if isinstance(dst, dict):
            _compare_grads(dst, gp[name], f"{where}{name}/")
            continue
        # HWIO -> OIHW, or (I, O, kH, kW) for a transposed convolution.
        perm = (2, 3, 0, 1) if isinstance(dst, torch.nn.ConvTranspose2d) else (3, 2, 0, 1)
        ref_w = np.asarray(gp[name]["kernel"]).transpose(perm)
        _close_to_max(dst.weight.grad.numpy(), ref_w, TOL)


@pytest.mark.parametrize("features", [8, 128])
def test_dropout_residual_block_matches_flax(monkeypatch, features):
    """At 128 features the port's ConvBlocks take their weight gradient from
    conv2d_valid_dw_fused (plain on the CPU); the JAX block from XLA."""
    r = _rng(3)
    x = r.standard_normal((2, 6, 6, features)).astype(np.float32)
    r_out = r.standard_normal(x.shape).astype(np.float32)
    params, out_f, inter, gp, gx = _flax_run(
        JaxResidualBlock(features=features, use_dropout=True), x, r_out, jax.random.PRNGKey(7))
    masks = _recover_masks(inter, ["Dropout_0"])
    block = blocks.ResidualBlock(features, use_dropout=True).train()
    assert block.route == "unfused" and block.conv0.dw_fused == (features >= 128)
    weights._load_layer(block.conv0.conv, params["ConvBlock_0"], "ConvBlock_0")
    weights._load_layer(block.conv1.conv, params["ConvBlock_1"], "ConvBlock_1")
    _inject(monkeypatch, masks)
    xt = torch.from_numpy(x).permute(0, 3, 1, 2).requires_grad_()
    y = block(xt, torch.Generator())
    np.testing.assert_allclose(y.detach().permute(0, 2, 3, 1).numpy(), out_f, atol=TOL)
    (y * torch.from_numpy(r_out).permute(0, 3, 1, 2)).sum().backward()
    _close_to_max(xt.grad.permute(0, 2, 3, 1).numpy(), gx, TOL)
    _compare_grads({"ConvBlock_0": block.conv0.conv, "ConvBlock_1": block.conv1.conv}, gp)


def test_dropout_generator_matches_flax(monkeypatch):
    r = _rng(4)
    x = r.uniform(-1, 1, (2, 32, 32, 3)).astype(np.float32)
    r_out = r.standard_normal((2, 32, 32, 5)).astype(np.float32)
    jg = JaxResnetGenerator(5, ngf=8, n_blocks=2, use_dropout=True, head="none")
    params, out_f, inter, gp, gx = _flax_run(jg, x, r_out, jax.random.PRNGKey(11))
    masks = _recover_masks(inter, ["ResidualBlock_0", "ResidualBlock_1"])
    G = define_Gen(3, 5, 8, "resnet_2blocks", head="none", use_dropout=True)
    weights.load_flax_module(G, params)
    _inject(monkeypatch, masks)
    xt = torch.from_numpy(x).permute(0, 3, 1, 2).requires_grad_()
    y = G.train()(xt, torch.Generator())
    np.testing.assert_allclose(y.detach().permute(0, 2, 3, 1).numpy(), out_f, atol=TOL)
    (y * torch.from_numpy(r_out).permute(0, 3, 1, 2)).sum().backward()
    _close_to_max(xt.grad.permute(0, 2, 3, 1).numpy(), gx, TOL)
    _compare_grads(weights._flax_layers(G), gp)


def test_dropout_drops_only_in_train_mode_with_a_generator():
    d = blocks.Dropout()
    x = torch.randn((2, 4, 5, 6))
    g = torch.Generator().manual_seed(0)
    y = d.train()(x, g)
    kept = y != 0
    torch.testing.assert_close(y[kept], 2 * x[kept])
    assert 0.3 < float(kept.float().mean()) < 0.7
    assert torch.equal(d.train()(x, None), x) and torch.equal(d.eval()(x, g), x)


# ---------------------------------------------------------------- train step
CFG = Config(gen_net="resnet_2blocks", ngf=8, ndf=8, crop_height=32, crop_width=32,
             bf16=False, pool_size=2, use_dropout=True)


def _batch():
    r = _rng(5)
    lab = r.integers(0, 5, (1, 32, 32))
    lab[:, :3] = 255
    return {"lab_image": torch.from_numpy(r.uniform(-1, 1, (1, 32, 32, 3)).astype(np.float32)),
            "unlab_image": torch.from_numpy(r.uniform(-1, 1, (1, 32, 32, 3)).astype(np.float32)),
            "lab_label": torch.from_numpy(lab)}


def _train(seed, steps=3):
    t = CycleGANTrainer(CFG, 5, 3, steps_per_epoch=100, device="cpu")
    st = t.init_state(torch.Generator().manual_seed(seed))
    out = []
    for _ in range(steps):
        st, m = t.train_step(st, _batch())
        out.append({k: float(v) for k, v in m.items()})
    return t, out


def test_dropout_train_step_is_finite_and_seeded(monkeypatch):
    drawn = []
    keep = blocks.dropout_keep
    monkeypatch.setattr(blocks, "dropout_keep",
                        lambda *a: drawn.append(keep(*a)) or drawn[-1])
    t, a = _train(0)
    assert all(np.isfinite(v) for m in a for v in m.values())
    # Three generator forwards a step, each drawing a fresh mask per block.
    assert len(drawn) == 3 * 3 * 2
    assert not torch.equal(drawn[0], drawn[6]) and not torch.equal(drawn[0][:1], drawn[4])
    assert _train(0)[1] == a
    assert _train(1)[1] != a


def test_eval_entry_points_never_drop(monkeypatch):
    t, _ = _train(0, steps=1)

    def no_drop(*_a):
        raise AssertionError("dropout outside the train step")

    monkeypatch.setattr(blocks, "dropout_keep", no_drop)
    b = _batch()
    logits = t.logits(b["lab_image"])
    assert torch.equal(logits, t.logits(b["lab_image"]))
    assert t.predict(b["lab_image"]).shape == (1, 32, 32)
    assert t.generate_image(b["lab_label"]).shape == (1, 32, 32, 3)
    hist = t.eval_step({"image": b["lab_image"], "label": b["lab_label"]})
    assert int(hist.sum()) == int((b["lab_label"] != 255).sum())
