"""The port's CUDA kernels against their plain PyTorch versions, on the card.

Every test here needs a CUDA device (marker ``cuda``) and skips without one:
the kernels have no CPU mode. The file imports nothing of JAX, so it also
runs on a machine that has only the port's dependencies::

    python -m pytest --noconftest -p no:cacheprovider tests/test_torch_cuda.py

(``--noconftest`` because ``tests/conftest.py`` sets up JAX). Shapes are
small and odd on purpose (ragged tiles, C not a multiple of 32, Cout not a
multiple of 128); ``chip_smoke.py`` covers the main path's shapes.
Tolerances are those of ``chip_smoke.py``, with the same reasons.
"""

import pytest
import torch
import torch.nn.functional as F

from cyclegan_tpu_torch.kernels import instance_norm as IN
from cyclegan_tpu_torch.kernels import resblock as RB
from cyclegan_tpu_torch.models.generators import define_Gen
from cyclegan_tpu_torch.ops import blocks

pytestmark = pytest.mark.cuda

TOL = {torch.float32: dict(atol=2e-5, rtol=1e-5),
       torch.bfloat16: dict(atol=2 ** -7, rtol=2 ** -6)}
RB_TOL = {torch.float32: dict(atol=1e-4, rtol=1e-4),
          torch.bfloat16: dict(atol=2 ** -6, rtol=2 ** -6)}


@pytest.fixture(autouse=True)
def card():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device: the kernels have no CPU mode")
    torch.backends.cudnn.allow_tf32 = False
    torch.backends.cuda.matmul.allow_tf32 = False
    return torch.Generator(device="cuda").manual_seed(0)


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("act,skip", [("none", False), ("relu", False), ("leaky", False),
                                      ("none", True)])
@pytest.mark.parametrize("shape", [(2, 16, 12, 64), (1, 5, 7, 40), (3, 33, 31, 96)])
def test_instance_norm_act_matches_plain(card, shape, act, skip, dtype):
    x = (torch.randn(shape, device="cuda", generator=card) * 3 + 1).to(dtype)
    s = torch.randn(shape, device="cuda", generator=card).to(dtype) if skip else None
    before = IN.launches
    y = IN.instance_norm_act(x, s, 1e-5, act)
    torch.cuda.synchronize()
    assert IN.launches == before + 1 and y.dtype == dtype
    torch.testing.assert_close(y.float(), IN.instance_norm_act_plain(x, s, 1e-5, act).float(),
                               **TOL[dtype])


def test_instance_norm_float32_in_bf16_out(card):
    """The residual block's use: float32 convolution output, bf16 result."""
    x = torch.randn((2, 8, 8, 64), device="cuda", generator=card) * 4
    out = torch.empty(x.shape, device="cuda", dtype=torch.bfloat16)
    IN.launch(x, None, out, 1e-5, "relu")
    torch.cuda.synchronize()
    ref = IN.instance_norm_act_plain(x, None, 1e-5, "relu", out_dtype=torch.bfloat16)
    torch.testing.assert_close(out.float(), ref.float(), **TOL[torch.bfloat16])


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("shape,cout", [((2, 8, 9, 64), 64), ((1, 17, 5, 32), 40),
                                        ((2, 16, 16, 256), 256)])
def test_conv3x3_reflect_matches_conv2d(card, shape, cout, dtype):
    x = torch.randn(shape, device="cuda", generator=card).to(dtype)
    w = (0.05 * torch.randn((3, 3, shape[-1], cout), device="cuda", generator=card)).to(dtype)
    b = (0.1 * torch.randn((cout,), device="cuda", generator=card)).to(dtype)
    out = torch.empty(shape[:3] + (cout,), device="cuda")
    RB.conv3x3_reflect(x, w, b, out)
    torch.cuda.synchronize()
    ref = RB._conv3x3_plain(x, w, b)  # float32 products of the same inputs
    torch.testing.assert_close(out, ref, atol=1e-4, rtol=1e-4)


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("shape", [(2, 16, 16, 64), (1, 9, 13, 32)])
def test_residual_block_matches_plain(card, shape, dtype):
    c = shape[-1]
    x = torch.randn(shape, device="cuda", generator=card).to(dtype)
    w1, w2 = [(0.05 * torch.randn((3, 3, c, c), device="cuda", generator=card)).to(dtype)
              for _ in range(2)]
    b1, b2 = [(0.01 * torch.randn((c,), device="cuda", generator=card)).to(dtype)
              for _ in range(2)]
    before = RB.launches
    y = RB.residual_block_fused(x, w1, b1, w2, b2)
    torch.cuda.synchronize()
    assert RB.launches == before + 1 and y.dtype == dtype
    torch.testing.assert_close(y.float(), RB.residual_block_plain(x, w1, b1, w2, b2).float(),
                               **RB_TOL[dtype])


def test_kernels_refuse_shapes_they_do_not_take(card):
    x = torch.zeros((1, 1, 8, 32), device="cuda")
    w = torch.zeros((3, 3, 32, 32), device="cuda")
    b = torch.zeros((32,), device="cuda")
    with pytest.raises(ValueError, match="H, W >= 2"):
        RB.residual_block_fused(x, w, b, w, b)


def test_generator_kernel_path_matches_plain_path(card, monkeypatch):
    """A small float32 generator: the blocks' seams on the kernels vs on the
    plain versions, same weights and batch."""
    G = define_Gen(3, 5, 8, "resnet_2blocks", head="none",
                   generator=torch.Generator().manual_seed(0))
    G = G.to("cuda", memory_format=torch.channels_last).eval()
    x = torch.rand((2, 3, 32, 32), device="cuda", generator=card) * 2 - 1
    x = x.contiguous(memory_format=torch.channels_last)
    n_in, n_rb = IN.launches, RB.launches
    with torch.inference_mode():
        got = G(x)
    assert IN.launches - n_in == 5 and RB.launches - n_rb == 2
    monkeypatch.setattr(blocks, "instance_norm_act", IN.instance_norm_act_plain)
    monkeypatch.setattr(blocks, "residual_block_fused", RB.residual_block_plain)
    with torch.inference_mode():
        ref = G(x)
    torch.testing.assert_close(got, ref, atol=5e-5, rtol=1e-4)
