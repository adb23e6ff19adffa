"""Generators (reference ``arch/generators.py``).

Counterpart of ``cyclegan_tpu/models/generators.py``. The ResNet generator:
c7s1-ngf -> d2ngf -> d4ngf -> R4ngf x {6|9} -> u2ngf -> ungf -> c7s1-out,
with a tanh head (image generator) or raw logits (label generator). Inputs
and outputs are NCHW; the block's ``dtype`` is the compute precision over
float32 parameters. ``use_dropout`` puts dropout(0.5) in every trunk block;
it drops only in train mode and only when ``forward`` is given the masks'
generator. ``resblock`` / ``resblock_hc`` pick the trunk blocks' route (see
``ops.blocks``; None: the environment's choice when the blocks are built).
The U-Net generators arrive in a later slice.
"""

from __future__ import annotations

import re

import torch
from torch import nn

from cyclegan_tpu_torch.ops.blocks import ConvBlock, DeconvBlock, ResidualBlock
from cyclegan_tpu_torch.ops.init import init_weights


class ResnetGenerator(nn.Module):
    """CycleGAN ResNet generator. Submodules in forward order: ``stem``,
    ``down1``, ``down2``, ``trunk[i]``, ``up1``, ``up2``, ``head`` (the Flax
    names are ConvBlock_0..2, ResidualBlock_i, DeconvBlock_0..1 and
    ConvBlock_3; see ``cyclegan_tpu_torch.weights``)."""

    def __init__(self, input_nc: int, output_nc: int, ngf: int = 64, n_blocks: int = 9,
                 norm: str = "instance", head: str = "tanh",
                 dtype: torch.dtype = torch.float32,
                 generator: torch.Generator | None = None,
                 use_dropout: bool = False, resblock: str | None = None,
                 resblock_hc: int | None = None) -> None:
        super().__init__()
        if head not in ("tanh", "none"):
            raise ValueError(f"unknown head {head!r} (tanh|none)")
        self.head_act = head
        self.stem = ConvBlock(input_nc, ngf, 7, pad=3, norm=norm, act="relu", dtype=dtype)
        self.down1 = ConvBlock(ngf, ngf * 2, 3, stride=2, pad=1, pad_mode="zero",
                               norm=norm, act="relu", dtype=dtype)
        self.down2 = ConvBlock(ngf * 2, ngf * 4, 3, stride=2, pad=1, pad_mode="zero",
                               norm=norm, act="relu", dtype=dtype)
        self.trunk = nn.ModuleList(ResidualBlock(ngf * 4, norm=norm, dtype=dtype,
                                                 use_dropout=use_dropout, route=resblock,
                                                 hc=resblock_hc)
                                   for _ in range(n_blocks))
        self.up1 = DeconvBlock(ngf * 4, ngf * 2, norm=norm, dtype=dtype)
        self.up2 = DeconvBlock(ngf * 2, ngf, norm=norm, dtype=dtype)
        self.head = ConvBlock(ngf, output_nc, 7, pad=3, norm="none", act="none",
                              dtype=dtype)
        init_weights(self, generator)

    def forward(self, x: torch.Tensor,
                dropout: torch.Generator | None = None) -> torch.Tensor:
        """``dropout``: the generator of this forward's dropout masks (a
        fresh mask per block and call), or None for no dropout."""
        h = self.down2(self.down1(self.stem(x)))
        for block in self.trunk:
            h = block(h, dropout)
        h = self.head(self.up2(self.up1(h)))
        return torch.tanh(h) if self.head_act == "tanh" else h


def define_Gen(input_nc: int, output_nc: int, ngf: int = 64,
               netG: str = "resnet_9blocks", norm: str = "instance",
               head: str = "tanh", dtype: torch.dtype = torch.float32,
               generator: torch.Generator | None = None,
               use_dropout: bool = False, resblock: str | None = None,
               resblock_hc: int | None = None) -> nn.Module:
    """Generator factory (reference ``define_Gen``), initialised N(0, 0.02)
    from ``generator``. Unlike the Flax module, a torch module needs
    ``input_nc`` up front. ``resnet_<n>blocks`` takes any trunk depth n (the
    reference's are 6 and 9; small ones serve tests)."""
    m = re.fullmatch(r"resnet_(\d+)blocks", netG)
    if m:
        return ResnetGenerator(input_nc, output_nc, ngf, n_blocks=int(m.group(1)),
                               norm=norm, head=head, dtype=dtype, generator=generator,
                               use_dropout=use_dropout, resblock=resblock,
                               resblock_hc=resblock_hc)
    if netG in ("unet_128", "unet_256"):
        raise NotImplementedError(f"{netG}: the U-Net generators arrive in a later "
                                  f"slice of the port")
    raise ValueError(f"unknown netG: {netG!r}")
