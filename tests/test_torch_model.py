"""The port's ResnetGenerator against the Flax ResnetGenerator.

Flax init params are carried across with ``weights.load_flax_module``;
both models see the same seeded numpy batch (ngf 8, 2 trunk blocks, 32x32,
batch 2, float32). Bar: 5e-5 on the outputs (ROADMAP's generator bar), and
equal argmax wherever JAX's top-2 logit gap is above 1e-4.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from cyclegan_tpu.models.generators import ResnetGenerator as JaxResnetGenerator
from cyclegan_tpu_torch import weights
from cyclegan_tpu_torch.models.generators import ResnetGenerator, define_Gen
from cyclegan_tpu_torch.ops.blocks import get_norm

N_CLASSES, NGF, N_BLOCKS, SIZE = 5, 8, 2, 32


def make_pair(head="none", norm="instance", seed=0):
    """(flax module, flax params (numpy tree), bridged torch module)."""
    jg = JaxResnetGenerator(output_nc=N_CLASSES, ngf=NGF, n_blocks=N_BLOCKS, norm=norm,
                            head=head)
    params = jax.device_get(jg.init(jax.random.PRNGKey(seed),
                                    jnp.zeros((1, SIZE, SIZE, 3))))["params"]
    tg = ResnetGenerator(3, N_CLASSES, NGF, N_BLOCKS, norm=norm, head=head)
    weights.load_flax_module(tg, params)
    return jg, params, tg


def batch(seed=1, n=2):
    return np.random.default_rng(seed).uniform(-1, 1, (n, SIZE, SIZE, 3)).astype(np.float32)


def torch_forward(tg, x):
    with torch.inference_mode():
        xt = torch.from_numpy(x).permute(0, 3, 1, 2)  # channels_last view
        return tg(xt).permute(0, 2, 3, 1).numpy()


def assert_argmax_equal_off_ties(got, ref, gap=1e-4):
    top2 = np.sort(ref, axis=-1)[..., -2:]
    decisive = (top2[..., 1] - top2[..., 0]) > gap
    assert decisive.mean() > 0.9
    np.testing.assert_array_equal(got.argmax(-1)[decisive], ref.argmax(-1)[decisive])


@pytest.mark.parametrize("head,norm", [("none", "instance"), ("tanh", "instance"),
                                       ("none", "none")])
def test_generator_matches_flax(head, norm):
    jg, params, tg = make_pair(head, norm)
    x = batch()
    ref = np.asarray(jg.apply({"params": params}, jnp.asarray(x)))
    got = torch_forward(tg, x)
    np.testing.assert_allclose(got, ref, atol=5e-5)
    if head == "none" and norm == "instance":  # without norm the logits are ~0
        assert_argmax_equal_off_ties(got, ref)


def test_define_gen_and_unported_options():
    """Every generator and norm of the JAX package builds (the U-Nets and
    batch norm are ported: tests/test_torch_unet.py,
    tests/test_torch_norm_batch.py); unknown names raise."""
    assert len(define_Gen(3, 4, 8, "resnet_9blocks").trunk) == 9
    assert len(define_Gen(3, 4, 8, "resnet_6blocks").trunk) == 6
    assert len(define_Gen(3, 4, 8, "unet_256").levels()) == 8
    assert len(define_Gen(3, 4, 8, "unet_128").levels()) == 7
    assert get_norm("batch")(8) is not None and get_norm("none")(8) is None
    with pytest.raises(ValueError):
        define_Gen(3, 4, 8, "vgg")
    with pytest.raises(ValueError):
        get_norm("group")


def test_init_is_seeded_normal():
    g1 = define_Gen(3, 4, 8, "resnet_2blocks", generator=torch.Generator().manual_seed(3))
    g2 = define_Gen(3, 4, 8, "resnet_2blocks", generator=torch.Generator().manual_seed(3))
    w = torch.cat([p.detach().flatten() for n, p in g1.named_parameters()
                   if n.endswith("weight")])
    assert abs(float(w.std()) - 0.02) < 0.002 and abs(float(w.mean())) < 0.002
    assert all(float(p.detach().abs().max()) == 0 for n, p in g1.named_parameters()
               if n.endswith("bias"))
    for p1, p2 in zip(g1.parameters(), g2.parameters()):
        assert torch.equal(p1, p2)


def test_bridge_rejects_mismatches():
    _, params, tg = make_pair()
    bad = dict(params)
    bad.pop("DeconvBlock_1")
    with pytest.raises(KeyError, match="DeconvBlock_1"):
        weights.load_flax_module(tg, bad)
    bad = dict(params, Extra_0={"kernel": np.zeros((1, 1, 1, 1))})
    with pytest.raises(KeyError, match="Extra_0"):
        weights.load_flax_module(tg, bad)
    bad = dict(params, ConvBlock_3={"kernel": np.zeros((7, 7, 8, 6)),
                                    "bias": np.zeros(6)})
    with pytest.raises(ValueError, match="ConvBlock_3/kernel"):
        weights.load_flax_module(tg, bad)


def test_load_npz_roundtrip(tmp_path):
    jg, params, tg = make_pair(seed=4)
    flat = {"/".join(str(k.key) for k in path): np.asarray(v)
            for path, v in jax.tree_util.tree_leaves_with_path(params)}
    np.savez(tmp_path / "g.npz", **flat)
    tg2 = ResnetGenerator(3, N_CLASSES, NGF, N_BLOCKS, head="none")
    weights.load_flax_module(tg2, weights.load_npz(str(tmp_path / "g.npz")))
    for p1, p2 in zip(tg.parameters(), tg2.parameters()):
        assert torch.equal(p1, p2)
