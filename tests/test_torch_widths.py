"""Trunk widths that are no multiple of the convolution tiles.

On the card the fused and chunked residual blocks zero-fill a trunk of C
channels up to ``resblock.padded_channels(C)`` and cut their results back
(their convolutions take channels in multiples of 32). These tests hold the
rule on the CPU: the plain blocks on zero-filled inputs, cut back, equal the
plain blocks at the true width (forward and VJP, within 1e-6 of each
result's largest magnitude), and a
generator whose trunk is 48 channels wide (ngf 12) matches the JAX one.
``tests/test_torch_cuda.py`` runs the kernels at C = 48 on the card.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from cyclegan_tpu.models.generators import ResnetGenerator as JaxResnetGenerator
from cyclegan_tpu_torch import weights
from cyclegan_tpu_torch.kernels import resblock as RB
from cyclegan_tpu_torch.kernels import resblock_chunked as RC
from cyclegan_tpu_torch.models.generators import ResnetGenerator


def _t(shape, seed, scale=1.0):
    return torch.from_numpy((scale * np.random.default_rng(seed).standard_normal(shape))
                            .astype(np.float32))


def _block(c, seed, shape=(2, 8, 6)):
    x = _t(shape + (c,), seed)
    w1, w2 = _t((3, 3, c, c), seed + 1, 0.05), _t((3, 3, c, c), seed + 2, 0.05)
    b1, b2 = _t((c,), seed + 3, 0.01), _t((c,), seed + 4, 0.01)
    return x, w1, b1, w2, b2, _t(shape + (c,), seed + 5)


def _close(got, want):
    """Within 1e-6 of the largest magnitude of ``want``: the padded sums
    run over more (zero) terms, which BLAS blocks in another order, so a
    weight gradient (a sum over the batch and every pixel) moves in its
    last float32 bits relative to its scale, not to a fixed unit."""
    torch.testing.assert_close(got, want, atol=1e-6 * float(want.abs().max()), rtol=0)


def _fill(cp, x, w1, b1, w2, b2, dy):
    return (RB.zero_fill(x, cp), RB.zero_fill(w1, cp, 2), RB.zero_fill(b1, cp),
            RB.zero_fill(w2, cp, 2), RB.zero_fill(b2, cp), RB.zero_fill(dy, cp))


@pytest.mark.parametrize("c", [1, 8, 31, 32, 33, 40, 48, 64, 96, 256, 257])
def test_padded_channels_is_the_next_multiple_of_the_tiles(c):
    cp = RB.padded_channels(c)
    assert cp % RB.CHANNEL_MULTIPLE == 0 and c <= cp < c + RB.CHANNEL_MULTIPLE
    assert (cp == c) == (c % RB.CHANNEL_MULTIPLE == 0)  # 64, 96, 256: no copy


def test_zero_fill_pads_only_the_trailing_dims_with_zeros():
    w = _t((3, 3, 40, 40), 0)
    wp = RB.zero_fill(w, 64, 2)
    assert wp.shape == (3, 3, 64, 64) and torch.equal(wp[:, :, :40, :40], w)
    assert not wp[:, :, 40:].any() and not wp[:, :, :, 40:].any()
    st = RB.zero_fill(_t((2, 4, 40), 1), 64)
    assert st.shape == (2, 4, 64) and not st[..., 40:].any()


@pytest.mark.parametrize("c", [48, 40])
def test_zero_filled_fused_block_forward_equals_true_width(c):
    x, w1, b1, w2, b2, dy = _block(c, 10)
    padded = _fill(RB.padded_channels(c), x, w1, b1, w2, b2, dy)
    y = RB.residual_block_plain(*padded[:5])
    assert not y[..., c:].any()
    _close(y[..., :c], RB.residual_block_plain(x, w1, b1, w2, b2))


@pytest.mark.parametrize("c", [48, 40])
def test_zero_filled_fused_block_vjp_equals_true_width(c):
    """The plain VJP from the residuals of the plain forward at the
    zero-filled width, as the card's wrapper keeps them."""
    x, w1, b1, w2, b2, dy = _block(c, 20)
    cp = RB.padded_channels(c)
    xp, w1p, b1p, w2p, b2p, dyp = _fill(cp, x, w1, b1, w2, b2, dy)
    rp = RB.residual_block_fwd_plain(xp, w1p, b1p, w2p, b2p)[1]
    dx, dw1, dw2 = RB.residual_block_bwd_saved_plain(xp, dyp, w1p, w2p, rp)
    r = RB.residual_block_fwd_plain(x, w1, b1, w2, b2)[1]
    ref = RB.residual_block_bwd_saved_plain(x, dy, w1, w2, r)
    assert not dx[..., c:].any()
    _close(dx[..., :c], ref[0])
    for got, want in zip((dw1, dw2), ref[1:]):
        _close(got[:, :, :c, :c], want)


@pytest.mark.parametrize("c", [48, 40])
def test_zero_filled_chunked_block_forward_equals_true_width(c):
    x, w1, b1, w2, b2, _ = _block(c, 30)
    cp = RB.padded_channels(c)
    got = RC.residual_block_chunked_plain(*_fill(cp, x, w1, b1, w2, b2, x)[:5], 1e-5, 4)
    ref = RC.residual_block_chunked_plain(x, w1, b1, w2, b2, 1e-5, 4)
    for g, r in zip(got[:3], ref[:3]):  # y, vhat, s
        assert not g[..., c:].any()
        _close(g[..., :c], r)
    _close(got[3][..., :c], ref[3])


@pytest.mark.parametrize("c", [48, 40])
def test_zero_filled_chunked_block_vjp_equals_true_width(c):
    """The saved residuals zero-filled as the card's wrapper fills them
    (zero statistics in the padded channels)."""
    x, w1, b1, w2, b2, dy = _block(c, 40)
    _, vhat, s, stats = RC.residual_block_chunked_plain(x, w1, b1, w2, b2, 1e-5, 4)
    cp = RB.padded_channels(c)
    dx, dw1, dw2 = RC.residual_block_chunked_bwd_plain(
        *(RB.zero_fill(t, cp) for t in (x, dy, vhat, s, stats)),
        RB.zero_fill(w1, cp, 2), RB.zero_fill(w2, cp, 2), 4)
    ref = RC.residual_block_chunked_bwd_plain(x, dy, vhat, s, stats, w1, w2, 4)
    assert not dx[..., c:].any()
    _close(dx[..., :c], ref[0])
    for got, want in zip((dw1, dw2), ref[1:]):
        _close(got[:, :, :c, :c], want)


def test_generator_with_a_48_channel_trunk_matches_flax():
    """ngf 12: trunk width 48, which the card's blocks zero-fill to 64; on
    the CPU the plain versions, against the JAX generator at the generator
    bar."""
    ngf, size = 12, 32
    jg = JaxResnetGenerator(output_nc=5, ngf=ngf, n_blocks=2, norm="instance", head="none")
    params = jax.device_get(jg.init(jax.random.PRNGKey(0),
                                    jnp.zeros((1, size, size, 3))))["params"]
    tg = ResnetGenerator(3, 5, ngf, 2, norm="instance", head="none")
    weights.load_flax_module(tg, params)
    x = np.random.default_rng(1).uniform(-1, 1, (2, size, size, 3)).astype(np.float32)
    ref = np.asarray(jg.apply({"params": params}, jnp.asarray(x)))
    with torch.inference_mode():
        got = tg(torch.from_numpy(x).permute(0, 3, 1, 2)).permute(0, 2, 3, 1).numpy()
    np.testing.assert_allclose(got, ref, atol=5e-5)

