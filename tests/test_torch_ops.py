"""cyclegan_tpu_torch.ops.functional against cyclegan_tpu.ops.functional.

The same seeded numpy inputs go to both: NHWC/HWIO on the JAX side,
NCHW/OIHW (or (I, O, kH, kW) for the transposed conv) on the torch side.
Tolerances: 1e-5 elementwise, 5e-5 for convolutions (float32 sums in
another order).
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from cyclegan_tpu.ops import functional as JF
from cyclegan_tpu_torch.ops import functional as TF


def _nchw(a):
    return torch.from_numpy(np.ascontiguousarray(a.transpose(0, 3, 1, 2)))


def _nhwc(t):
    return t.detach().numpy().transpose(0, 2, 3, 1)


def _x(shape, seed=0):
    return np.random.default_rng(seed).standard_normal(shape).astype(np.float32)


@pytest.mark.parametrize("pad", [1, 3])
def test_reflect_pad(pad):
    x = _x((2, 9, 7, 3))
    np.testing.assert_allclose(_nhwc(TF.reflect_pad(_nchw(x), pad)),
                               np.asarray(JF.reflect_pad(jnp.asarray(x), pad)), atol=1e-5)


@pytest.mark.parametrize("k,stride,padding", [(3, 1, 0), (3, 2, 1), (7, 1, 0), (4, 2, 1)])
def test_conv2d(k, stride, padding):
    x = _x((2, 12, 10, 5), 1)
    w = 0.2 * _x((k, k, 5, 6), 2)          # HWIO
    b = _x((6,), 3)
    got = TF.conv2d(_nchw(x), torch.from_numpy(w.transpose(3, 2, 0, 1).copy()),
                    torch.from_numpy(b), stride=stride, padding=padding)
    ref = JF.conv2d(jnp.asarray(x), jnp.asarray(w), jnp.asarray(b), stride=stride,
                    padding=padding)
    np.testing.assert_allclose(_nhwc(got), np.asarray(ref), atol=5e-5)


def test_conv2d_transpose_doubles():
    x = _x((2, 6, 5, 4), 4)
    w = 0.2 * _x((3, 3, 4, 3), 5)          # HWIO, I = input channels
    b = _x((3,), 6)
    got = TF.conv2d_transpose(_nchw(x), torch.from_numpy(w.transpose(2, 3, 0, 1).copy()),
                              torch.from_numpy(b))
    ref = JF.conv2d_transpose(jnp.asarray(x), jnp.asarray(w), jnp.asarray(b))
    assert got.shape == (2, 3, 12, 10)
    np.testing.assert_allclose(_nhwc(got), np.asarray(ref), atol=5e-5)


@pytest.mark.parametrize("affine", [False, True])
def test_instance_norm(affine):
    x = 3 * _x((2, 8, 6, 5), 7) + 1
    scale = _x((5,), 8) if affine else None
    bias = _x((5,), 9) if affine else None
    got = TF.instance_norm(_nchw(x), None if scale is None else torch.from_numpy(scale),
                           None if bias is None else torch.from_numpy(bias))
    ref = JF.instance_norm(jnp.asarray(x), None if scale is None else jnp.asarray(scale),
                           None if bias is None else jnp.asarray(bias))
    np.testing.assert_allclose(_nhwc(got), np.asarray(ref), atol=1e-5)


def test_instance_norm_bf16_keeps_dtype():
    """Stats in float32, result cast back to the input type, as in JAX."""
    x = 3 * _x((1, 6, 6, 4), 10) + 1
    got = TF.instance_norm(_nchw(x).to(torch.bfloat16))
    ref = JF.instance_norm(jnp.asarray(x, jnp.bfloat16))
    assert got.dtype == torch.bfloat16
    np.testing.assert_allclose(_nhwc(got.float()), np.asarray(ref, np.float32),
                               atol=2 ** -7, rtol=2 ** -7)


def test_leaky_relu():
    x = _x((2, 4, 4, 3), 11)
    np.testing.assert_allclose(_nhwc(TF.leaky_relu(_nchw(x))),
                               np.asarray(JF.leaky_relu(jnp.asarray(x))), atol=1e-6)


def test_conv2d_compute_dtype():
    """bf16 compute: inputs cast, result in bf16 (f32 accumulation)."""
    x, w = _x((1, 6, 6, 4), 12), 0.2 * _x((3, 3, 4, 2), 13)
    got = TF.conv2d(_nchw(x), torch.from_numpy(w.transpose(3, 2, 0, 1).copy()),
                    compute_dtype=torch.bfloat16)
    ref = JF.conv2d(jnp.asarray(x), jnp.asarray(w), compute_dtype=jnp.bfloat16)
    assert got.dtype == torch.bfloat16
    np.testing.assert_allclose(_nhwc(got.float()), np.asarray(ref, np.float32),
                               atol=2 ** -6, rtol=2 ** -7)
