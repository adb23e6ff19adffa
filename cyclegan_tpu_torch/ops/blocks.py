"""The reference's op blocks as ``nn.Module``s.

Counterpart of ``cyclegan_tpu/ops/blocks.py``: ``ConvBlock`` (pad -> conv ->
norm -> activation), ``DeconvBlock`` (transposed conv -> norm -> ReLU),
``ResidualBlock`` and the norm selector. Parameters are float32 in torch
layout (conv OIHW, transposed conv (I, O, kH, kW)); ``dtype`` is the compute
precision (bf16 on the card). Activations are NCHW tensors that live in
``channels_last`` memory, so ``x.permute(0, 2, 3, 1)`` is the NHWC tensor
the kernels take, at no cost.

The kernel seams sit where the JAX package has them: instance norm (+ act,
+ skip) goes to ``kernels.instance_norm_act`` through :class:`InstanceNorm`,
and an instance-norm :class:`ResidualBlock` goes whole to
``kernels.residual_block_fused``. On the card both always run their CUDA
kernels; on the CPU their plain PyTorch versions.
"""

from __future__ import annotations

from typing import Callable

import torch
from torch import nn

from cyclegan_tpu_torch.kernels import instance_norm_act, residual_block_fused
from cyclegan_tpu_torch.ops import functional as F


def to_nhwc(x: torch.Tensor) -> torch.Tensor:
    """NCHW (channels_last memory) -> contiguous NHWC; a view when ``x`` is
    channels_last, a copy otherwise."""
    return x.permute(0, 2, 3, 1).contiguous()


def to_nchw(y: torch.Tensor) -> torch.Tensor:
    """Contiguous NHWC -> NCHW view in channels_last memory."""
    return y.permute(0, 3, 1, 2)


def hwio(w: torch.Tensor, dtype: torch.dtype) -> torch.Tensor:
    """OIHW conv weight -> contiguous HWIO of ``dtype`` (the kernels' layout)."""
    return w.to(dtype).permute(2, 3, 1, 0).contiguous()


class InstanceNorm(nn.Module):
    """``InstanceNorm2d`` without affine or running stats (biased variance,
    eps 1e-5), with the following activation and residual add fused:
    ``act(IN(x)) [+ skip]`` through ``kernels.instance_norm_act``."""

    def __init__(self, eps: float = 1e-5) -> None:
        super().__init__()
        self.eps = eps

    def forward(self, x: torch.Tensor, act: str = "none",
                skip: torch.Tensor | None = None) -> torch.Tensor:
        skip = to_nhwc(skip.to(x.dtype)) if skip is not None else None
        return to_nchw(instance_norm_act(to_nhwc(x), skip, self.eps, act))


def get_norm(norm: str) -> Callable[[], nn.Module | None]:
    """Norm-layer selector (reference ``get_norm_layer``): a zero-argument
    factory; ``none`` yields None (the caller skips the layer)."""
    if norm == "instance":
        return InstanceNorm
    if norm == "none":
        return lambda: None
    if norm == "batch":
        raise NotImplementedError(
            "norm='batch' arrives with the training slice of the port "
            "(BatchNorm with the biased-variance running EMA)")
    raise ValueError(f"unknown norm: {norm!r} (expected instance|batch|none)")


def _act(x: torch.Tensor, act: str) -> torch.Tensor:
    if act == "relu":
        return torch.relu(x)
    if act == "leaky":
        return F.leaky_relu(x, 0.2)
    if act == "none":
        return x
    raise ValueError(f"unknown act {act!r} (relu|leaky|none)")


class ConvBlock(nn.Module):
    """[reflect|zero]-pad -> conv -> norm -> activation (reference
    ``conv_norm_relu``); ``skip`` is added after norm + activation."""

    def __init__(self, in_ch: int, features: int, kernel: int = 3, stride: int = 1,
                 pad: int = 0, pad_mode: str = "reflect", norm: str = "instance",
                 act: str = "relu", use_bias: bool = True,
                 dtype: torch.dtype = torch.float32) -> None:
        super().__init__()
        if pad_mode not in ("reflect", "zero"):
            raise ValueError(f"unknown pad_mode {pad_mode!r} (reflect|zero)")
        self.conv = nn.Conv2d(in_ch, features, kernel, stride=stride, bias=use_bias)
        self.pad, self.pad_mode, self.act, self.dtype = pad, pad_mode, act, dtype
        self.norm = get_norm(norm)()

    def forward(self, x: torch.Tensor, skip: torch.Tensor | None = None) -> torch.Tensor:
        stride = self.conv.stride[0]
        if self.pad_mode == "reflect":
            x = F.conv2d(F.reflect_pad(x, self.pad), self.conv.weight, self.conv.bias,
                         stride=stride, compute_dtype=self.dtype)
        else:
            x = F.conv2d(x, self.conv.weight, self.conv.bias, stride=stride,
                         padding=self.pad, compute_dtype=self.dtype)
        if isinstance(self.norm, InstanceNorm):
            return self.norm(x, self.act, skip)
        x = _act(x, self.act)
        return x if skip is None else x + skip.to(x.dtype)


class DeconvBlock(nn.Module):
    """Transposed conv (torch geometry, k3 s2 p1 op1 doubles H and W) ->
    norm -> activation (reference ``dconv_norm_relu``)."""

    def __init__(self, in_ch: int, features: int, kernel: int = 3, stride: int = 2,
                 padding: int = 1, output_padding: int = 1, norm: str = "instance",
                 act: str = "relu", use_bias: bool = True,
                 dtype: torch.dtype = torch.float32) -> None:
        super().__init__()
        self.conv = nn.ConvTranspose2d(in_ch, features, kernel, stride=stride,
                                       padding=padding, output_padding=output_padding,
                                       bias=use_bias)
        self.act, self.dtype = act, dtype
        self.norm = get_norm(norm)()

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        c = self.conv
        x = F.conv2d_transpose(x, c.weight, c.bias, stride=c.stride[0],
                               padding=c.padding[0], output_padding=c.output_padding[0],
                               compute_dtype=self.dtype)
        if isinstance(self.norm, InstanceNorm):
            return self.norm(x, self.act)
        return _act(x, self.act)


class ResidualBlock(nn.Module):
    """[refpad1, conv3x3, IN, ReLU, refpad1, conv3x3, IN] + x (reference
    ``ResidualBlock``). With instance norm the whole block is one call of
    ``kernels.residual_block_fused``; the two ConvBlocks then only hold the
    weights. Dropout is a training option and arrives with that slice."""

    def __init__(self, features: int, norm: str = "instance",
                 dtype: torch.dtype = torch.float32) -> None:
        super().__init__()
        self.conv0 = ConvBlock(features, features, 3, pad=1, norm=norm, act="relu",
                               dtype=dtype)
        self.conv1 = ConvBlock(features, features, 3, pad=1, norm=norm, act="none",
                               dtype=dtype)
        self.fused = norm == "instance"
        self.dtype = dtype

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        if not self.fused:
            return self.conv1(self.conv0(x), skip=x)
        d = self.dtype
        c0, c1 = self.conv0.conv, self.conv1.conv
        y = residual_block_fused(to_nhwc(x.to(d)), hwio(c0.weight, d), c0.bias.to(d),
                                 hwio(c1.weight, d), c1.bias.to(d), 1e-5)
        return to_nchw(y)
