"""Functional primitives, NCHW, with torch semantics.

Counterpart of ``cyclegan_tpu/ops/functional.py``. There these are XLA ops
in NHWC/HWIO; here they are plain ``torch.nn.functional`` calls in torch's
own NCHW/OIHW layout (activations may sit in ``channels_last`` memory). The
JAX package's XLA-only routes (``conv2d_reflect_gemm``, ``_conv_gemm_core``,
``conv2d_valid_dw_fused``) have no counterpart yet.
"""

from __future__ import annotations

import torch
import torch.nn.functional as F


def reflect_pad(x: torch.Tensor, pad: int) -> torch.Tensor:
    """Reflection-pad the spatial dims (``nn.ReflectionPad2d`` semantics:
    the edge pixel is not repeated)."""
    if pad == 0:
        return x
    return F.pad(x, (pad, pad, pad, pad), mode="reflect")


def conv2d(x: torch.Tensor, w: torch.Tensor, b: torch.Tensor | None = None, *,
           stride: int = 1, padding: int = 0,
           compute_dtype: torch.dtype | None = None) -> torch.Tensor:
    """2-D convolution, NCHW x OIHW -> NCHW, zero padding ``padding``.

    With ``compute_dtype`` (e.g. bf16) inputs are cast first; the output has
    that type (the accumulation inside is float32).
    """
    if compute_dtype is not None:
        x, w = x.to(compute_dtype), w.to(compute_dtype)
        b = b.to(compute_dtype) if b is not None else None
    return F.conv2d(x, w, b, stride=stride, padding=padding)


def conv2d_transpose(x: torch.Tensor, w: torch.Tensor,
                     b: torch.Tensor | None = None, *, stride: int = 2,
                     padding: int = 1, output_padding: int = 1,
                     compute_dtype: torch.dtype | None = None) -> torch.Tensor:
    """Transposed convolution with ``nn.ConvTranspose2d`` geometry; ``w`` is
    (I, O, kH, kW). The reference's (k3, s2, p1, op1) doubles H and W."""
    if compute_dtype is not None:
        x, w = x.to(compute_dtype), w.to(compute_dtype)
        b = b.to(compute_dtype) if b is not None else None
    return F.conv_transpose2d(x, w, b, stride=stride, padding=padding,
                              output_padding=output_padding)


def instance_norm(x: torch.Tensor, scale: torch.Tensor | None = None,
                  bias: torch.Tensor | None = None, *,
                  eps: float = 1e-5) -> torch.Tensor:
    """Instance norm over the spatial dims of NCHW ``x``
    (``nn.InstanceNorm2d`` defaults: biased variance, eps 1e-5, affine only
    when ``scale``/``bias`` are given). Statistics in float32; the result is
    cast back to ``x``'s type."""
    x32 = x.float()
    mean = x32.mean(dim=(2, 3), keepdim=True)
    var = torch.square(x32 - mean).mean(dim=(2, 3), keepdim=True)
    y = (x32 - mean) * torch.rsqrt(var + eps)
    if scale is not None:
        y = y * scale.float().view(1, -1, 1, 1)
    if bias is not None:
        y = y + bias.float().view(1, -1, 1, 1)
    return y.to(x.dtype)


def leaky_relu(x: torch.Tensor, negative_slope: float = 0.2) -> torch.Tensor:
    """LeakyReLU with the reference's 0.2 slope (``x >= 0`` keeps x)."""
    return torch.where(x >= 0, x, x * negative_slope)
