"""Weight gradient of a VALID stride-1 k x k convolution (trunk shapes).

The counterpart of ``cyclegan_tpu/kernels/conv_dw.py``::

    dw[s, t] = sum_n xp[n, s:s+H, t:t+W, :]^T @ dy[n]        (k, k, Cin, Cout)

for an input ``xp`` (N, H+k-1, W+k-1, Cin) that is already padded and the
output gradient ``dy`` (N, H, W, Cout), NHWC, accumulated in float32 and
returned as float32. :func:`conv_dw` launches the hand-written kernel of
``csrc/conv_dw.cu`` (TPU kernel #8) on a CUDA tensor, or raises; on a CPU
tensor it runs :func:`conv_dw_plain`. ``ops.functional.conv2d_valid_dw_fused``
routes the weight gradient of the trunk's reflect-padded 3x3 convolutions
through it.
"""

from __future__ import annotations

import torch

from cyclegan_tpu_torch.kernels import _build
from cyclegan_tpu_torch.kernels import resblock as RB

# Calls of conv_dw that launched the CUDA kernel.
launches = 0


def _shapes(xp: torch.Tensor, dy: torch.Tensor, k: int) -> tuple[int, ...]:
    if xp.dim() != 4 or dy.dim() != 4:
        raise ValueError(f"conv_dw wants NHWC xp and dy, got {tuple(xp.shape)}, "
                         f"{tuple(dy.shape)}")
    n, hp, wp, cin = xp.shape
    nd, h, w_, cout = dy.shape
    if nd != n or hp != h + k - 1 or wp != w_ + k - 1:
        raise ValueError(f"conv_dw: xp {tuple(xp.shape)} is not dy {tuple(dy.shape)} "
                         f"padded for a {k}x{k} VALID convolution")
    return n, h, w_, cin, cout


def conv_dw_plain(xp: torch.Tensor, dy: torch.Tensor, k: int = 3) -> torch.Tensor:
    """Plain PyTorch version: k*k float32 products of the shifted input
    with the output gradient, summed over the batch and the pixels."""
    n, h, w_, cin, cout = _shapes(xp, dy, k)
    x32, g = xp.float(), dy.float().reshape(-1, cout)
    return torch.stack([torch.stack([x32[:, s:s + h, t:t + w_].reshape(-1, cin).T @ g
                                     for t in range(k)]) for s in range(k)])


def supported(xp_shape: tuple[int, ...], dy_shape: tuple[int, ...]) -> bool:
    """Which convolutions route their weight gradient through the kernel:
    both channel dims >= 128 (the JAX package's rule; its VMEM budget has no
    counterpart on the card)."""
    return len(xp_shape) == 4 and len(dy_shape) == 4 and \
        xp_shape[-1] >= 128 and dy_shape[-1] >= 128


def _dw_cuda(xp: torch.Tensor, dy: torch.Tensor, k: int) -> torch.Tensor:
    global launches
    n, h, w_, cin, cout = _shapes(xp, dy, k)
    if cin % 4:
        raise ValueError(f"conv_dw needs Cin % 4 == 0, got {cin}")
    if dy.dtype != xp.dtype:
        raise TypeError(f"conv_dw: xp and dy must share one dtype, got {xp.dtype}, {dy.dtype}")
    out = torch.empty((k, k, cin, cout), dtype=torch.float32, device=xp.device)
    RB._check_same_device("conv_dw", xp, dy, out)
    tiles = -(-k * k * cin // 64) * -(-cout // 64)
    splits, kchunk = RB._wgrad_split(tiles, n * h * w_)
    part = torch.empty((splits, k * k * cin, cout), dtype=torch.float32, device=xp.device)
    _build.call("conv_dw", "cg_conv_dw", xp.data_ptr(), dy.data_ptr(), out.data_ptr(),
                part.data_ptr(), n, h, w_, cin, cout, k, splits, kchunk,
                _build.DTYPE_CODES[xp.dtype], _build.stream_ptr(xp))
    launches += 1
    return out


def conv_dw(xp: torch.Tensor, dy: torch.Tensor, k: int = 3) -> torch.Tensor:
    """dw (k, k, Cin, Cout) float32 of a VALID stride-1 convolution: the
    CUDA kernel for CUDA tensors, the plain version for CPU tensors."""
    if xp.device.type == "cpu":
        return conv_dw_plain(xp, dy, k)
    if xp.device.type != "cuda":
        raise ValueError(f"conv_dw: no kernel for device {xp.device}")
    return _dw_cuda(xp, dy, k)
