"""Generators (reference ``arch/generators.py``).

Counterpart of ``cyclegan_tpu/models/generators.py``. The ResNet generator:
c7s1-ngf -> d2ngf -> d4ngf -> R4ngf x {6|9} -> u2ngf -> ungf -> c7s1-out,
with a tanh head (image generator) or raw logits (label generator). Inputs
and outputs are NCHW; the block's ``dtype`` is the compute precision over
float32 parameters. ``use_dropout`` puts dropout(0.5) in every trunk block;
it drops only in train mode and only when ``forward`` is given the masks'
generator. ``resblock`` / ``resblock_hc`` pick the trunk blocks' route (see
``ops.blocks``; None: the environment's choice when the blocks are built).
``remat`` recomputes each trunk block in the backward
(``torch.utils.checkpoint``) instead of keeping its activations; under a
spatial axis (``ops.blocks.set_data_mesh``) the recomputed forward makes
its halo exchanges and norm gathers again, inside the backward, on every
rank alike. Both generators take H slabs (``spatial_size`` ranks each
hold one, every layer told the global H of its input): ``forward``'s
``rows`` is the global H of the input (default: ``spatial_size`` equal
slabs), and each layer's rows follow the ceil rule of
``parallel.spatial.slab``, so a plane of any height splits, down to a
U-Net's 1-row innermost plane, where a rank may own no row.

The U-Net generators (``unet_128``: 7 levels, ``unet_256``: 8): nested
skip-connection levels, each a LeakyReLU(0.2) + 4x4 stride-2 convolution
down, the inner levels, a ReLU + 4x4 stride-2 transposed convolution up,
norms at the inner levels (instance norm through the kernel seam with no
activation), dropout at the middle levels, and the level's input
concatenated on the channel axis. As in the JAX package, they take no
remat. On H slabs the level's 4x4 stride-2 convolution and transposed
convolution go through ``ops.blocks.slab_conv`` / ``slab_deconv``; the
concatenation stays local, as the level's input and its transposed
convolution's output have the same global H and so the same rows on
every rank.
"""

from __future__ import annotations

import re

import torch
from torch import nn
from torch.utils.checkpoint import checkpoint

from cyclegan_tpu_torch.ops import functional as F
from cyclegan_tpu_torch.ops.blocks import (ConvBlock, DeconvBlock, Dropout, ResidualBlock,
                                           apply_norm, frozen_running_stats, get_norm,
                                           slab_conv, slab_deconv)
from cyclegan_tpu_torch.ops.init import init_weights
from cyclegan_tpu_torch.parallel import spatial as S
from cyclegan_tpu_torch.utils.observability import span


def _remat_block(block: ResidualBlock, h: torch.Tensor,
                 dropout: torch.Generator | None, rows: int | None = None) -> torch.Tensor:
    """``block(h, dropout)`` under ``torch.utils.checkpoint``: the dropout
    mask is drawn here, once, and handed to both passes (the checkpoint's
    RNG preservation covers the global generators only, and the block draws
    from none of them), and the recomputed pass leaves the batch norms'
    running averages as the first pass left them."""
    keep = block.keep_mask(h, dropout, rows)
    passes = [0]

    def run(x: torch.Tensor, keep: torch.Tensor | None) -> torch.Tensor:
        passes[0] += 1
        with frozen_running_stats(block, passes[0] > 1):
            return block(x, keep, rows)

    return checkpoint(run, h, keep, use_reentrant=False, preserve_rng_state=False)


def _global_rows(x: torch.Tensor, spatial_size: int, rows: int | None) -> int | None:
    """The global H of NCHW ``x`` under a spatial axis of ``spatial_size``
    ranks: ``rows``, or ``spatial_size`` equal slabs; None without one."""
    if spatial_size == 1:
        return None
    return x.shape[2] * spatial_size if rows is None else rows


class ResnetGenerator(nn.Module):
    """CycleGAN ResNet generator. Submodules in forward order: ``stem``,
    ``down1``, ``down2``, ``trunk[i]``, ``up1``, ``up2``, ``head`` (the Flax
    names are ConvBlock_0..2, ResidualBlock_i, DeconvBlock_0..1 and
    ConvBlock_3; see ``cyclegan_tpu_torch.weights``)."""

    # Ranks of the spatial axis that each hold an equal H slab of the input
    # (ops.blocks.set_data_mesh).
    spatial_size = 1

    def __init__(self, input_nc: int, output_nc: int, ngf: int = 64, n_blocks: int = 9,
                 norm: str = "instance", head: str = "tanh",
                 dtype: torch.dtype = torch.float32,
                 generator: torch.Generator | None = None,
                 use_dropout: bool = False, resblock: str | None = None,
                 resblock_hc: int | None = None, remat: bool = False) -> None:
        super().__init__()
        if head not in ("tanh", "none"):
            raise ValueError(f"unknown head {head!r} (tanh|none)")
        self.head_act, self.remat = head, remat
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

    def forward(self, x: torch.Tensor, dropout: torch.Generator | None = None,
                rows: int | None = None) -> torch.Tensor:
        """``dropout``: the generator of this forward's dropout masks (a
        fresh mask per block and call), or None for no dropout; ``rows``:
        the global H of ``x`` under a spatial axis."""
        rows = _global_rows(x, self.spatial_size, rows)
        h = self.stem(x, rows=rows)
        h = self.down1(h, rows=rows)
        rows = self.down1.out_rows(rows)
        h = self.down2(h, rows=rows)
        rows = self.down2.out_rows(rows)
        remat = self.remat and torch.is_grad_enabled()
        for block in self.trunk:
            h = _remat_block(block, h, dropout, rows) if remat else block(h, dropout, rows)
        h = self.up1(h, rows=rows)
        rows = self.up1.out_rows(rows)
        h = self.up2(h, rows=rows)
        h = self.head(h, rows=self.up2.out_rows(rows))
        return torch.tanh(h) if self.head_act == "tanh" else h


class UnetLevel(nn.Module):
    """One U-Net skip-connection level (the JAX ``_UnetBlock``): ``down``
    (4x4 stride-2 convolution, after a LeakyReLU 0.2 below the outermost
    level), the nested level ``sub``, ``up`` (ReLU, 4x4 stride-2 transposed
    convolution). The inner levels norm both convolutions' outputs (the
    innermost only ``up``'s), the middle ones drop after ``up``'s norm, and
    every level but the outermost returns ``cat([x, up], channels)``.
    Under a spatial axis (``spatial``, set by ``ops.blocks.set_data_mesh``)
    ``x`` is this rank's slab of a plane of ``rows`` global rows.

    Spans (``utils.observability``), three siblings a level that never nest
    in one another: ``unet.down`` (the LeakyReLU, the strided convolution
    and its norm; closed before ``sub`` runs), ``unet.up`` (the ReLU, the
    transposed convolution, its norm and dropout) and ``unet.skip`` (the
    casts and the concatenation; not at the outermost level)."""

    def __init__(self, outer_nc: int, inner_nc: int, input_nc: int | None = None,
                 sub: "UnetLevel | None" = None, outermost: bool = False,
                 innermost: bool = False, norm: str = "instance", use_dropout: bool = False,
                 dtype: torch.dtype = torch.float32) -> None:
        super().__init__()
        self.outermost, self.innermost, self.dtype = outermost, innermost, dtype
        self.down = nn.Conv2d(outer_nc if input_nc is None else input_nc, inner_nc, 4,
                              stride=2, padding=1)
        inner = not outermost and not innermost
        self.down_norm = get_norm(norm)(inner_nc) if inner else None
        self.sub = sub
        self.up = nn.ConvTranspose2d(inner_nc if innermost else 2 * inner_nc, outer_nc, 4,
                                     stride=2, padding=1)
        self.up_norm = None if outermost else get_norm(norm)(outer_nc)
        self.dropout = Dropout() if use_dropout else None
        self.spatial: S.Spatial | None = None

    def forward(self, x: torch.Tensor, dropout: torch.Generator | None = None,
                rows: int | None = None) -> torch.Tensor:
        d, sp = self.dtype, self.spatial
        with span("unet.down"):
            h = x if self.outermost else F.leaky_relu(x, 0.2)
            c = self.down
            if sp is None:
                h = F.conv2d(h, c.weight, c.bias, stride=2, padding=1, compute_dtype=d)
            else:
                h = slab_conv(h, rows, c, 1, "zero", d, sp)
            h = apply_norm(self.down_norm, h)
        if self.sub is not None:
            h = self.sub(h, dropout, None if sp is None else S.conv_out_rows(rows, 4, 2, 1))
        with span("unet.up"):
            h = torch.relu(h)
            c = self.up
            if sp is None:
                h = F.conv2d_transpose(h, c.weight, c.bias, stride=2, padding=1,
                                       output_padding=0, compute_dtype=d)
            else:
                h = slab_deconv(h, S.conv_out_rows(rows, 4, 2, 1), c, d, sp)
            if self.outermost:
                return h
            h = apply_norm(self.up_norm, h)
            if self.dropout is not None:
                h = self.dropout(h, dropout, rows)
        with span("unet.skip"):
            t = torch.result_type(x, h)
            return torch.cat([x.to(t), h.to(t)], dim=1)


class UnetGenerator(nn.Module):
    """U-Net generator (``unet_128``: ``num_downs`` 7, ``unet_256``: 8); the
    levels nest from ``root`` (outermost) down; :meth:`levels` lists them
    innermost first, the order of the Flax names ``_UnetBlock_0..``."""

    # Ranks of the spatial axis that each hold an equal H slab of the input
    # (ops.blocks.set_data_mesh).
    spatial_size = 1

    def __init__(self, input_nc: int, output_nc: int, num_downs: int = 7, ngf: int = 64,
                 norm: str = "instance", head: str = "tanh",
                 dtype: torch.dtype = torch.float32,
                 generator: torch.Generator | None = None, use_dropout: bool = False) -> None:
        super().__init__()
        if head not in ("tanh", "none"):
            raise ValueError(f"unknown head {head!r} (tanh|none)")
        if num_downs < 5:
            raise ValueError(f"num_downs {num_downs}: a U-Net has at least 5 levels")
        self.head_act = head
        kw = dict(norm=norm, dtype=dtype)
        level = UnetLevel(ngf * 8, ngf * 8, innermost=True, **kw)
        for _ in range(num_downs - 5):
            level = UnetLevel(ngf * 8, ngf * 8, sub=level, use_dropout=use_dropout, **kw)
        for outer, inner in ((ngf * 4, ngf * 8), (ngf * 2, ngf * 4), (ngf, ngf * 2)):
            level = UnetLevel(outer, inner, sub=level, **kw)
        self.root = UnetLevel(output_nc, ngf, input_nc, sub=level, outermost=True, **kw)
        init_weights(self, generator)

    def levels(self) -> list[UnetLevel]:
        out, level = [], self.root
        while level is not None:
            out.append(level)
            level = level.sub
        return out[::-1]

    def forward(self, x: torch.Tensor, dropout: torch.Generator | None = None,
                rows: int | None = None) -> torch.Tensor:
        """``dropout``: the generator of this forward's dropout masks;
        ``rows``: the global H of ``x`` under a spatial axis."""
        h = self.root(x, dropout, _global_rows(x, self.spatial_size, rows))
        return torch.tanh(h) if self.head_act == "tanh" else h


UNET_DOWNS = {"unet_128": 7, "unet_256": 8}


def define_Gen(input_nc: int, output_nc: int, ngf: int = 64,
               netG: str = "resnet_9blocks", norm: str = "instance",
               head: str = "tanh", dtype: torch.dtype = torch.float32,
               generator: torch.Generator | None = None,
               use_dropout: bool = False, resblock: str | None = None,
               resblock_hc: int | None = None, remat: bool = False) -> nn.Module:
    """Generator factory (reference ``define_Gen``), initialised N(0, 0.02)
    from ``generator``. Unlike the Flax module, a torch module needs
    ``input_nc`` up front. ``resnet_<n>blocks`` takes any trunk depth n (the
    reference's are 6 and 9; small ones serve tests); ``unet_128`` and
    ``unet_256`` ignore ``remat``, ``resblock`` and ``resblock_hc``."""
    m = re.fullmatch(r"resnet_(\d+)blocks", netG)
    if m:
        return ResnetGenerator(input_nc, output_nc, ngf, n_blocks=int(m.group(1)),
                               norm=norm, head=head, dtype=dtype, generator=generator,
                               use_dropout=use_dropout, resblock=resblock,
                               resblock_hc=resblock_hc, remat=remat)
    if netG in UNET_DOWNS:
        return UnetGenerator(input_nc, output_nc, UNET_DOWNS[netG], ngf, norm=norm, head=head,
                             dtype=dtype, generator=generator, use_dropout=use_dropout)
    raise ValueError(f"unknown netG: {netG!r}")
