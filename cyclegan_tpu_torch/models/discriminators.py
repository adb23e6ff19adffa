"""Discriminators (reference ``arch/discriminators.py``).

Counterpart of ``cyclegan_tpu/models/discriminators.py``. The 70x70
PatchGAN: C64 -> C128 -> C256 -> C512 with 4x4 zero-padded convolutions
(stride 2, the penultimate stride 1), instance norm on all but the first
layer, LeakyReLU(0.2), and a final 1-channel convolution with raw scores (no
sigmoid: LSGAN). Plus the 1x1 PixelDiscriminator. Inputs and scores are
NCHW; ``dtype`` is the compute precision over float32 parameters. The
instance norms go through the differentiable ``kernels.instance_norm_act``
seam of :class:`~cyclegan_tpu_torch.ops.blocks.ConvBlock`.
"""

from __future__ import annotations

import torch
from torch import nn

from cyclegan_tpu_torch.ops.blocks import ConvBlock
from cyclegan_tpu_torch.ops.init import init_weights


def _blocks_forward(blocks, x: torch.Tensor, spatial_size: int) -> torch.Tensor:
    """The blocks in turn; under a spatial axis each is told the global H
    of its input (the rows run 256 -> 128 -> 64 -> 32 -> 31 -> 30 in the
    PatchGAN at H = 256: the last two layers split unevenly)."""
    rows = x.shape[2] * spatial_size if spatial_size > 1 else None
    for block in blocks:
        x = block(x, rows=rows)
        rows = block.out_rows(rows)
    return x


class NLayerDiscriminator(nn.Module):
    """PatchGAN; ``n_layers=3`` gives the 70x70 receptive field. ``blocks[k]``
    is the Flax ``ConvBlock_k``. ``spatial_size``: ranks of a spatial axis,
    each with an equal H slab of the input."""

    spatial_size = 1

    def __init__(self, input_nc: int, ndf: int = 64, n_layers: int = 3,
                 norm: str = "instance", dtype: torch.dtype = torch.float32,
                 generator: torch.Generator | None = None) -> None:
        super().__init__()
        zero4 = dict(kernel=4, pad=1, pad_mode="zero", dtype=dtype)
        blocks = [ConvBlock(input_nc, ndf, stride=2, norm="none", act="leaky", **zero4)]
        nf = ndf
        for i in range(1, n_layers):
            prev, nf = nf, min(ndf * 2 ** i, ndf * 8)
            blocks.append(ConvBlock(prev, nf, stride=2, norm=norm, act="leaky", **zero4))
        prev, nf = nf, min(ndf * 2 ** n_layers, ndf * 8)
        blocks.append(ConvBlock(prev, nf, stride=1, norm=norm, act="leaky", **zero4))
        blocks.append(ConvBlock(nf, 1, stride=1, norm="none", act="none", **zero4))
        self.blocks = nn.ModuleList(blocks)
        init_weights(self, generator)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        return _blocks_forward(self.blocks, x, self.spatial_size)

    def out_rows(self, rows: int) -> int:
        """The global H of the score map for an input of global H ``rows``."""
        for block in self.blocks:
            rows = block.out_rows(rows)
        return rows


class PixelDiscriminator(nn.Module):
    """1x1 per-pixel discriminator; ``blocks[k]`` is ``ConvBlock_k``."""

    spatial_size = 1

    def __init__(self, input_nc: int, ndf: int = 64, norm: str = "instance",
                 dtype: torch.dtype = torch.float32,
                 generator: torch.Generator | None = None) -> None:
        super().__init__()
        self.blocks = nn.ModuleList([
            ConvBlock(input_nc, ndf, 1, norm="none", act="leaky", dtype=dtype),
            ConvBlock(ndf, ndf * 2, 1, norm=norm, act="leaky", dtype=dtype),
            ConvBlock(ndf * 2, 1, 1, norm="none", act="none", dtype=dtype),
        ])
        init_weights(self, generator)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        return _blocks_forward(self.blocks, x, self.spatial_size)

    def out_rows(self, rows: int) -> int:
        return rows


def define_Dis(input_nc: int, ndf: int = 64, netD: str = "n_layers", n_layers_D: int = 3,
               norm: str = "instance", dtype: torch.dtype = torch.float32,
               generator: torch.Generator | None = None) -> nn.Module:
    """Discriminator factory (reference ``define_Dis``), initialised
    N(0, 0.02) from ``generator``. Unlike the Flax module, a torch module
    needs ``input_nc`` up front."""
    if netD in ("n_layers", "basic"):
        n = 3 if netD == "basic" else n_layers_D
        return NLayerDiscriminator(input_nc, ndf, n, norm, dtype, generator)
    if netD == "pixel":
        return PixelDiscriminator(input_nc, ndf, norm, dtype, generator)
    raise ValueError(f"unknown netD: {netD!r}")
