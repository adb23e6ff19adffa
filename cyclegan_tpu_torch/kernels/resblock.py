"""Whole ResidualBlock forward.

The counterpart of ``cyclegan_tpu/kernels/resblock.py::residual_block_fused``
(forward)::

    y = x + IN(conv3x3(rpad(relu(IN(conv3x3(rpad(x)) + b1)))) + b2)

on NHWC ``x`` with HWIO weights. As in the Pallas kernel, the convolution
outputs u and s stay float32 and ``relu(IN(u))`` is cast to x's type before
the second convolution. On a CUDA tensor :func:`residual_block_fused` runs
the hand-written implicit-GEMM convolution of ``csrc/resblock.cu`` and the
instance-norm kernel of ``csrc/instance_norm.cu``, or raises; on a CPU
tensor it runs :func:`residual_block_plain`.
"""

from __future__ import annotations

import torch
import torch.nn.functional as F

from cyclegan_tpu_torch.kernels import _build
from cyclegan_tpu_torch.kernels import instance_norm as _in

# Calls of residual_block_fused that launched the CUDA kernels.
launches = 0


def _conv3x3_plain(x: torch.Tensor, w: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """float32 reflect-pad 3x3 conv + bias: NHWC x, HWIO w -> NHWC f32."""
    xp = F.pad(x.float().permute(0, 3, 1, 2), (1, 1, 1, 1), mode="reflect")
    y = F.conv2d(xp, w.float().permute(3, 2, 0, 1), b.float())
    return y.permute(0, 2, 3, 1)


def residual_block_plain(x: torch.Tensor, w1: torch.Tensor, b1: torch.Tensor,
                         w2: torch.Tensor, b2: torch.Tensor,
                         eps: float = 1e-5) -> torch.Tensor:
    """Plain PyTorch version; u and s are float32 as in the Pallas kernel."""
    u = _conv3x3_plain(x, w1, b1)
    a = _in.instance_norm_act_plain(u, None, eps, "relu", out_dtype=x.dtype)
    s = _conv3x3_plain(a, w2, b2)
    return _in.instance_norm_act_plain(s, x, eps, "none", out_dtype=x.dtype)


def conv3x3_reflect(x: torch.Tensor, w: torch.Tensor, b: torch.Tensor,
                    out: torch.Tensor) -> None:
    """CUDA kernel: ``out`` (NHWC f32) = conv3x3(rpad1(x), w) + b."""
    n, h, w_, cin = x.shape
    cout = w.shape[-1]
    if h < 2 or w_ < 2:
        raise ValueError(f"reflect padding needs H, W >= 2, got {h}x{w_}")
    if cin % 32 or cout % 8:
        raise ValueError(f"conv3x3_reflect needs Cin % 32 == 0 and Cout % 8 == 0, "
                         f"got Cin={cin}, Cout={cout}")
    if w.shape != (3, 3, cin, cout) or b.shape != (cout,):
        raise ValueError(f"weight {tuple(w.shape)} / bias {tuple(b.shape)} do not "
                         f"fit Cin={cin}, Cout={cout}")
    if out.shape != (n, h, w_, cout) or out.dtype != torch.float32:
        raise ValueError("conv3x3_reflect: out must be (N, H, W, Cout) float32")
    for t in (x, w, b, out):
        if not t.is_contiguous() or t.device != x.device:
            raise ValueError("conv3x3_reflect: tensors must be contiguous on one device")
        if t is not out and t.dtype != x.dtype:
            raise TypeError("conv3x3_reflect: x, w and b must share one dtype")
        if t.data_ptr() % 16:
            raise ValueError("conv3x3_reflect: tensors must be 16-byte aligned")
    if x.dtype not in _build.DTYPE_CODES:
        raise TypeError(f"conv3x3_reflect: unsupported dtype {x.dtype}")
    err = _build.load("resblock").cg_conv3x3_reflect(
        x.data_ptr(), w.data_ptr(), b.data_ptr(), out.data_ptr(),
        n, h, w_, cin, cout, _build.DTYPE_CODES[x.dtype], _build.stream_ptr(x))
    _build.check(err, "cg_conv3x3_reflect")


def residual_block_fused(x: torch.Tensor, w1: torch.Tensor, b1: torch.Tensor,
                         w2: torch.Tensor, b2: torch.Tensor,
                         eps: float = 1e-5) -> torch.Tensor:
    """Fused ResidualBlock forward; x (N, H, W, C), w (3, 3, C, C), b (C,),
    all of one dtype. CUDA tensors launch the kernels; CPU tensors run
    :func:`residual_block_plain`; any other device raises."""
    global launches
    if x.dim() != 4:
        raise ValueError(f"residual_block_fused wants NHWC, got {tuple(x.shape)}")
    if x.device.type == "cpu":
        return residual_block_plain(x, w1, b1, w2, b2, eps)
    if x.device.type != "cuda":
        raise ValueError(f"residual_block_fused: no kernel for device {x.device}")
    n, h, w_, c = x.shape
    if w1.shape[-1] != c:
        raise ValueError(f"residual block needs Cout == Cin == {c}, got {w1.shape[-1]}")
    u = torch.empty((n, h, w_, c), dtype=torch.float32, device=x.device)
    conv3x3_reflect(x, w1, b1, u)
    a = torch.empty_like(x, memory_format=torch.contiguous_format)
    _in.launch(u, None, a, eps, "relu")
    conv3x3_reflect(a, w2, b2, u)  # s overwrites u: u is dead once `a` exists
    y = torch.empty_like(a)
    _in.launch(u, x, y, eps, "none")
    launches += 1
    return y
