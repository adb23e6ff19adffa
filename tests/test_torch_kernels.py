"""The port's kernel modules against the JAX kernels.

On the CPU each wrapper runs its plain PyTorch version; these tests hold
those against the Pallas kernels run in interpret mode (and the XLA
reference), on the same seeded numpy inputs. The CUDA kernels themselves
run only on the card: ``tests/test_torch_cuda.py`` (marked ``cuda``)
checks them there at small shapes, and ``chip_smoke.py`` at the main
path's shapes.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from cyclegan_tpu.kernels.instance_norm import instance_norm_act as jax_in_act
from cyclegan_tpu.kernels.resblock import (residual_block_fused as jax_rb_fused,
                                           residual_block_reference)
from cyclegan_tpu_torch.kernels import instance_norm as IN
from cyclegan_tpu_torch.kernels import resblock as RB


def _x(shape, seed, scale=1.0, shift=0.0):
    rng = np.random.default_rng(seed)
    return (scale * rng.standard_normal(shape) + shift).astype(np.float32)


@pytest.mark.parametrize("skip", [False, True])
@pytest.mark.parametrize("act", ["none", "relu", "leaky"])
def test_instance_norm_act_matches_pallas(act, skip):
    x = _x((2, 8, 6, 16), 0, 3.0, 1.0)
    s = _x((2, 8, 6, 16), 1) if skip else None
    ref = jax_in_act(jnp.asarray(x), None if s is None else jnp.asarray(s), 1e-5, act, True)
    got = IN.instance_norm_act(torch.from_numpy(x),
                               None if s is None else torch.from_numpy(s), 1e-5, act)
    np.testing.assert_allclose(got.numpy(), np.asarray(ref), atol=1e-5)


def test_instance_norm_act_bf16_matches_pallas():
    """bf16 in and out, float32 statistics: within one bf16 ulp."""
    x = _x((1, 8, 8, 16), 2, 2.0)
    ref = jax_in_act(jnp.asarray(x, jnp.bfloat16), None, 1e-5, "relu", True)
    got = IN.instance_norm_act(torch.from_numpy(x).to(torch.bfloat16), None, 1e-5, "relu")
    assert got.dtype == torch.bfloat16
    np.testing.assert_allclose(got.float().numpy(), np.asarray(ref, np.float32),
                               atol=2 ** -8, rtol=2 ** -7)


def _rb_params(c, seed):
    return (0.05 * _x((3, 3, c, c), seed), 0.01 * _x((c,), seed + 1),
            0.05 * _x((3, 3, c, c), seed + 2), 0.01 * _x((c,), seed + 3))


@pytest.mark.parametrize("shape", [(2, 12, 12, 16), (1, 6, 9, 32)])
def test_residual_block_matches_pallas_and_reference(shape):
    x = _x(shape, 10)
    params = _rb_params(shape[-1], 11)
    jx = [jnp.asarray(a) for a in (x, *params)]
    ref_kernel = jax_rb_fused(*jx, 1e-5, True)
    ref_xla = residual_block_reference(*jx)
    got = RB.residual_block_fused(*[torch.from_numpy(a) for a in (x, *params)])
    np.testing.assert_allclose(got.numpy(), np.asarray(ref_kernel), atol=2e-5)
    np.testing.assert_allclose(got.numpy(), np.asarray(ref_xla), atol=2e-5)


def test_cpu_tensors_leave_launch_counters_at_zero():
    IN.launches = RB.launches = 0
    x = torch.from_numpy(_x((1, 4, 4, 32), 20))
    w1, b1, w2, b2 = [torch.from_numpy(a) for a in _rb_params(32, 21)]
    IN.instance_norm_act(x, None, 1e-5, "relu")
    RB.residual_block_fused(x, w1, b1, w2, b2)
    assert IN.launches == 0 and RB.launches == 0


@pytest.mark.parametrize("shape,c_out,match", [
    ((1, 1, 4, 32), 32, "H, W >= 2"),
    ((1, 4, 4, 16), 16, "Cin % 32"),
    ((1, 4, 4, 32), 12, "Cout % 8"),
])
def test_conv_kernel_rejects_shapes_it_does_not_take(shape, c_out, match):
    """The kernel covers the main path's shapes and raises on others (no
    fallback), before any build or launch."""
    x = torch.zeros(shape)
    w = torch.zeros((3, 3, shape[-1], c_out))
    out = torch.zeros(shape[:3] + (c_out,))
    with pytest.raises(ValueError, match=match):
        RB.conv3x3_reflect(x, w, torch.zeros(c_out), out)


@pytest.mark.parametrize("shape", [(65536, 64), (16384, 128), (4096, 256), (30, 40)])
def test_tile_rows_fills_the_card(shape):
    """Even one sample gives the card a block per SM (or the smallest
    tile); the batch does not enter."""
    rows = IN._tile_rows(*shape)
    assert rows in (64, 128, 256, 512, 1024)
    hw, c = shape
    assert rows == 64 or -(-hw // rows) * -(-c // 32) >= 132
