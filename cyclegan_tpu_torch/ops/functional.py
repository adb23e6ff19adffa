"""Functional primitives, NCHW, with torch semantics.

Counterpart of ``cyclegan_tpu/ops/functional.py``. There these are XLA ops
in NHWC/HWIO; here they are plain ``torch.nn.functional`` calls in torch's
own NCHW/OIHW layout (activations may sit in ``channels_last`` memory). The
JAX package's im2col-GEMM route of the 7x7 convolutions
(``conv2d_reflect_gemm``, ``CYCLEGAN_TPU_CONV7``) has no counterpart: it
computes the same function as the library convolution, lost to it in the
JAX package's own measurements, and the port keeps the library's
(ROADMAP.md, Queue 3).
``conv2d_valid_dw_fused`` takes its weight gradient from the hand-written
kernel of ``kernels.conv_dw``.
"""

from __future__ import annotations

import torch
import torch.nn.functional as F

from cyclegan_tpu_torch.kernels import conv_dw as _dw


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


class _ConvValidDwFused(torch.autograd.Function):
    """Stride-1 VALID convolution whose weight gradient is TPU kernel #8
    (``kernels.conv_dw``); ``plain`` picks its plain version. The forward
    and the input gradient are library calls, as the JAX package leaves
    them to XLA."""

    @staticmethod
    def forward(ctx, xp, w, plain):
        if ctx.needs_input_grad[0] or ctx.needs_input_grad[1]:
            ctx.save_for_backward(xp, w)
            ctx.plain = plain
        return F.conv2d(xp, w)

    @staticmethod
    def backward(ctx, dy):
        xp, w = ctx.saved_tensors
        dxp = dw = None
        if ctx.needs_input_grad[0]:
            dxp = torch.nn.grad.conv2d_input(xp.shape, w, dy)
        if ctx.needs_input_grad[1]:
            # Contiguous NHWC for the kernel (a view of channels_last memory).
            xh = xp.permute(0, 2, 3, 1).contiguous()
            dyh = dy.permute(0, 2, 3, 1).contiguous()
            fn = _dw.conv_dw_plain if ctx.plain else _dw.conv_dw
            # float32 (k, k, Cin, Cout) -> w's type (as the JAX VJP casts) -> OIHW.
            dw = fn(xh, dyh, w.shape[-1]).to(w.dtype).permute(3, 2, 0, 1)
        return dxp, dw, None


def conv2d_valid_dw_fused(xp: torch.Tensor, w: torch.Tensor) -> torch.Tensor:
    """Stride-1 VALID convolution of the padded NCHW ``xp`` with the OIHW
    ``w`` (one dtype), differentiable; the weight gradient comes from the
    CUDA kernel for CUDA tensors and from its plain version for CPU
    tensors. No bias: the caller adds it after, as the JAX ConvBlock does."""
    if xp.device.type not in ("cpu", "cuda"):
        raise ValueError(f"conv2d_valid_dw_fused: no kernel for device {xp.device}")
    return _ConvValidDwFused.apply(xp, w, xp.device.type == "cpu")


def conv2d_valid_dw_fused_reference(xp: torch.Tensor, w: torch.Tensor) -> torch.Tensor:
    """The same Function with the plain weight gradient on any device (the
    on-card checks' yardstick; the port's modules never call it)."""
    return _ConvValidDwFused.apply(xp, w, True)


def use_dw_fused(in_ch: int, out_ch: int, kernel: int, stride: int) -> bool:
    """Routing predicate for :func:`conv2d_valid_dw_fused`: a 3x3 stride-1
    convolution whose channel dims the kernel takes (``conv_dw.supported``).
    The JAX package asks it with the padded input's shape; here the module
    asks once, when it is built."""
    if kernel != 3 or stride != 1:
        return False
    return _dw.supported((1, 1, 1, in_ch), (1, 1, 1, out_ch))


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
