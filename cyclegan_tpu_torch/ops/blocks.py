"""The reference's op blocks as ``nn.Module``s.

Counterpart of ``cyclegan_tpu/ops/blocks.py``: ``ConvBlock`` (pad -> conv ->
norm -> activation), ``DeconvBlock`` (transposed conv -> norm -> ReLU),
``ResidualBlock`` and the norm selector (instance, batch or none; batch
norm is :class:`BatchNorm`, the JAX package's Flax convention, switched
between batch and running statistics by the module's train/eval mode).
Parameters are float32 in torch layout (conv OIHW, transposed conv (I, O,
kH, kW)); ``dtype`` is the compute
precision (bf16 on the card). Activations are NCHW tensors that live in
``channels_last`` memory, so ``x.permute(0, 2, 3, 1)`` is the NHWC tensor
the kernels take, at no cost.

The kernel seams sit where the JAX package has them: instance norm (+ act,
+ skip) goes to ``kernels.instance_norm_act`` through :class:`InstanceNorm`;
an instance-norm :class:`ResidualBlock` without dropout goes whole to
``kernels.residual_block_fused`` or, on the chunked route, to
``kernels.residual_block_chunked``; a reflect-padded 3x3 stride-1
:class:`ConvBlock` of at least 128 channels in and out takes its weight
gradient from ``F.conv2d_valid_dw_fused``. All are ``autograd.Function``s:
on the card they run their CUDA kernels forward and backward; on the CPU
their plain PyTorch versions. Gradients reach the float32 parameters through
the casts and the differentiable OIHW -> HWIO permute of :func:`hwio`.

The residual block's route follows the JAX package's variables, read once
when the module is built: ``CYCLEGAN_TPU_RESBLOCK=chunked`` selects the
chunked block with ``CYCLEGAN_TPU_RESBLOCK_HC`` rows a chunk (default 8);
any other value keeps the port's default, the fused block.

Under the spatial axis of a mesh (:func:`set_data_mesh` with ``spatial >
1``) each rank holds an H slab of every activation, and the modules take
``rows``, the global H of their input: ``ConvBlock`` and ``DeconvBlock``
gather their halo rows and pad through ``parallel.spatial`` (the trunk's
3x3 convolutions keep kernel #8 on the halo-padded slab, whose weight
gradient is then this rank's part of the sum the trainers all-reduce),
``InstanceNorm`` goes through ``kernels.instance_norm_act_slab``,
``BatchNorm`` sums its statistics over every rank, and ``Dropout`` keeps
this slab of the global plane's mask. The residual blocks take their
``unfused`` route there (the fused and chunked kernels take whole planes,
as the JAX package runs its spatial axis with Pallas off); an explicit
fused or chunked route raises. :func:`slab_conv` and :func:`slab_deconv`
are those slab convolutions, shared with the U-Net's levels.
"""

from __future__ import annotations

import contextlib
import os
from typing import Callable

import torch
import torch.distributed as dist
from torch import nn

from cyclegan_tpu_torch.kernels import (instance_norm_act, residual_block_chunked,
                                        residual_block_fused)
from cyclegan_tpu_torch.kernels.instance_norm import SlabGroup, instance_norm_act_slab
from cyclegan_tpu_torch.ops import functional as F
from cyclegan_tpu_torch.parallel import spatial as S
from cyclegan_tpu_torch.parallel.mesh import Mesh, all_reduce_sum_grad


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
    ``act(IN(x)) [+ skip]`` through ``kernels.instance_norm_act``, or on an
    H slab (``spatial``) through ``kernels.instance_norm_act_slab`` with the
    whole plane's statistics."""

    def __init__(self, eps: float = 1e-5) -> None:
        super().__init__()
        self.eps = eps
        self.spatial: S.Spatial | None = None

    def _gather(self, buf: torch.Tensor) -> None:
        """The spatial group's partials (S, N, C, k), in place: each rank's
        slab wrote its slot of ``buf`` and zeros into the others, so the sum
        over the group is the gather (exact: one rank's value plus zeros)."""
        dist.all_reduce(buf, group=self.spatial.group)

    def slab_group(self) -> SlabGroup:
        """This rank's slot of the exchange buffer and the group's sum."""
        return SlabGroup(self.spatial.size, self.spatial.index, self._gather)

    def forward(self, x: torch.Tensor, act: str = "none",
                skip: torch.Tensor | None = None) -> torch.Tensor:
        skip = to_nhwc(skip.to(x.dtype)) if skip is not None else None
        if self.spatial is not None:
            return to_nchw(instance_norm_act_slab(to_nhwc(x), skip, self.eps, act,
                                                  self.slab_group()))
        return to_nchw(instance_norm_act(to_nhwc(x), skip, self.eps, act))


class BatchNorm(nn.Module):
    """The JAX package's ``nn.BatchNorm(momentum=0.9, epsilon=1e-5,
    dtype=float32)`` over the channels of an NCHW tensor: affine (``weight``
    ones, ``bias`` zeros), float32 statistics and a float32 result whatever
    the input type. In train mode it normalises with the batch statistics
    (mean, and variance as E[x^2] - E[x]^2 clamped at 0, as Flax's fast
    variance) and moves the running averages: ``new = 0.9 old + 0.1
    batch``, the variance's fed with the BIASED batch variance (Flax's
    convention; ``nn.BatchNorm2d`` feeds the unbiased one, N/(N-1) larger).
    In eval mode it normalises with the running averages. ``frozen`` keeps
    the running averages as they are in train mode (a recomputed forward
    under remat must not move them twice). With a data ``mesh`` of more
    than one rank (:func:`set_data_mesh`) the statistics are those of the
    global batch, as under the JAX package's sharded jit: the sums and
    sums of squares are added across the ranks by a differentiable
    all-reduce, so the backward is global too."""

    def __init__(self, features: int, momentum: float = 0.9, eps: float = 1e-5) -> None:
        super().__init__()
        self.momentum, self.eps, self.frozen = momentum, eps, False
        self.mesh: Mesh | None = None
        self.weight = nn.Parameter(torch.ones(features))
        self.bias = nn.Parameter(torch.zeros(features))
        self.register_buffer("running_mean", torch.zeros(features))
        self.register_buffer("running_var", torch.ones(features))

    @torch.no_grad()
    def reset(self) -> None:
        """The initial values: scale 1, bias 0, running mean 0, variance 1."""
        self.weight.fill_(1.0)
        self.bias.zero_()
        self.running_mean.zero_()
        self.running_var.fill_(1.0)

    def _batch_moments(self, x32: torch.Tensor) -> tuple[torch.Tensor, torch.Tensor]:
        """(E[x], E[x^2]) per channel over the batch: this rank's, or the
        global batch's across the mesh."""
        if self.mesh is None or self.mesh.world == 1:
            return x32.mean(dim=(0, 2, 3)), torch.square(x32).mean(dim=(0, 2, 3))
        sums = [x32.sum(dim=(0, 2, 3)), torch.square(x32).sum(dim=(0, 2, 3))]
        if self.mesh.spatial == 1:
            sums = all_reduce_sum_grad(torch.stack(sums), self.mesh)
            count = x32.numel() // x32.shape[1] * self.mesh.world
            return sums[0] / count, sums[1] / count
        # H slabs may differ in height: the counts are summed too.
        sums.append(torch.full_like(sums[0], float(x32.numel() // x32.shape[1])))
        sums = all_reduce_sum_grad(torch.stack(sums), self.mesh)
        return sums[0] / sums[2], sums[1] / sums[2]

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        x32 = x.float()
        if self.training:
            mean, mean_sq = self._batch_moments(x32)
            var = torch.clamp_min(mean_sq - torch.square(mean), 0.0)
            if not self.frozen:
                with torch.no_grad():
                    m = self.momentum
                    self.running_mean.mul_(m).add_((1 - m) * mean.detach())
                    self.running_var.mul_(m).add_((1 - m) * var.detach())
        else:
            mean, var = self.running_mean, self.running_var
        mul = torch.rsqrt(var + self.eps) * self.weight.float()
        return (x32 - mean.view(1, -1, 1, 1)) * mul.view(1, -1, 1, 1) \
            + self.bias.float().view(1, -1, 1, 1)


@contextlib.contextmanager
def frozen_running_stats(module: nn.Module, frozen: bool = True):
    """Hold the running averages of every :class:`BatchNorm` in ``module``
    (when ``frozen``) for the duration of the block."""
    norms = [m for m in module.modules() if isinstance(m, BatchNorm)]
    saved = [m.frozen for m in norms]
    for m in norms:
        m.frozen = m.frozen or frozen
    try:
        yield
    finally:
        for m, f in zip(norms, saved):
            m.frozen = f


def set_data_mesh(module: nn.Module, mesh: Mesh | None, rows: int | None = None) -> None:
    """Give every :class:`BatchNorm` and :class:`Dropout` of ``module`` the
    mesh its train-mode forward spans (None: this rank alone), and the
    dropouts the rows of one batch on this rank (the global batch size over
    the data ranks). Under a spatial axis (``mesh.spatial > 1``) every
    module that sees H takes its slab: the instance norms, convolutions,
    transposed convolutions and U-Net levels (every module with a
    ``spatial`` attribute) get the spatial group, and the residual blocks
    their unfused route (an explicit fused or chunked route raises)."""
    sp = S.from_mesh(mesh)
    for m in module.modules():
        if isinstance(m, BatchNorm):
            m.mesh = mesh
        elif isinstance(m, Dropout):
            m.mesh, m.rows = mesh, rows
        elif isinstance(m, ResidualBlock):
            m.set_spatial(sp is not None)
        elif hasattr(m, "spatial"):
            m.spatial = sp
        if hasattr(m, "spatial_size"):
            m.spatial_size = sp.size if sp is not None else 1


def get_norm(norm: str) -> Callable[[int], nn.Module | None]:
    """Norm-layer selector (reference ``get_norm_layer``): a factory of the
    channel count; ``none`` yields None (the caller skips the layer)."""
    if norm == "instance":
        return lambda features: InstanceNorm()
    if norm == "batch":
        return BatchNorm
    if norm == "none":
        return lambda features: None
    raise ValueError(f"unknown norm: {norm!r} (expected instance|batch|none)")


def apply_norm(norm: nn.Module | None, x: torch.Tensor, act: str = "none",
               skip: torch.Tensor | None = None) -> torch.Tensor:
    """``act(norm(x)) [+ skip]``: instance norm fuses the activation and the
    skip into its kernel; batch norm returns float32, and the skip is added
    after a cast to ``x``'s type, with float32 promotion (the JAX block's
    casts)."""
    if skip is not None:
        skip = skip.to(x.dtype)
    if isinstance(norm, InstanceNorm):
        return norm(x, act, skip)
    if norm is not None:
        x = norm(x)
    x = _act(x, act)
    return x if skip is None else x + skip


def _act(x: torch.Tensor, act: str) -> torch.Tensor:
    if act == "relu":
        return torch.relu(x)
    if act == "leaky":
        return F.leaky_relu(x, 0.2)
    if act == "none":
        return x
    raise ValueError(f"unknown act {act!r} (relu|leaky|none)")


def _empty_rows(xp: torch.Tensor, conv: nn.Module, w_out: int,
                dtype: torch.dtype) -> torch.Tensor:
    """The output of a rank that owns no row of a layer: (N, out channels,
    0, w_out), still wired to the gathered input and the layer's weight and
    bias (whose gradients are then dense zeros, which the trainers'
    in-place all-reduce can take), so that the rank's backward makes the
    layer's collectives too."""
    tie = sum((t.float() * 0).sum() for t in (xp, *conv.parameters()))
    return tie.to(dtype) + xp.new_zeros((xp.shape[0], conv.out_channels, 0, w_out),
                                        dtype=dtype)


def slab_conv(x: torch.Tensor, rows: int, conv: nn.Conv2d, pad: int, pad_mode: str,
              dtype: torch.dtype, sp: S.Spatial, dw_fused: bool = False) -> torch.Tensor:
    """The rows this rank owns of ``conv`` (``pad`` rows and columns of
    ``pad_mode`` padding) over the global plane of ``rows`` rows, of which
    ``x`` is this rank's slab: the halo-padded slab, then a VALID
    convolution (kernel #8's weight gradient where ``dw_fused``)."""
    k, stride = conv.kernel_size[0], conv.stride[0]
    xp = S.conv_input(x, rows, k, stride, pad, pad_mode, sp)
    if xp.shape[2] == 0:
        w_out = (xp.shape[3] - k) // stride + 1
        return _empty_rows(xp, conv, w_out, dtype)
    if dw_fused:
        y = F.conv2d_valid_dw_fused(xp.to(dtype), conv.weight.to(dtype))
        return y if conv.bias is None else y + conv.bias.to(dtype).view(1, -1, 1, 1)
    return F.conv2d(xp, conv.weight, conv.bias, stride=stride, compute_dtype=dtype)


def slab_deconv(x: torch.Tensor, rows: int, conv: nn.ConvTranspose2d, dtype: torch.dtype,
                sp: S.Spatial) -> torch.Tensor:
    """The rows this rank owns of the transposed convolution ``conv`` over
    the global plane of ``rows`` rows, of which ``x`` is this rank's slab:
    the input rows that reach them gathered, transposed with no H padding,
    and cropped to them."""
    k, st, pad, op = (conv.kernel_size[0], conv.stride[0], conv.padding[0],
                      conv.output_padding[0])
    xg, first, count = S.deconv_input(x, rows, k, st, pad, op, sp)
    if count == 0:
        w_out = S.deconv_out_rows(x.shape[3], k, st, pad, op)
        return _empty_rows(xg, conv, w_out, dtype)
    y = F.conv2d_transpose(xg, conv.weight, conv.bias, stride=st, padding=(0, pad),
                           output_padding=(0, op), compute_dtype=dtype)
    return y[:, :, first:first + count]


class ConvBlock(nn.Module):
    """[reflect|zero]-pad -> conv -> norm -> activation (reference
    ``conv_norm_relu``); ``skip`` is added after norm + activation. Under a
    spatial axis (``spatial``) ``rows`` is the global H of ``x``, of which
    ``x`` is this rank's slab."""

    def __init__(self, in_ch: int, features: int, kernel: int = 3, stride: int = 1,
                 pad: int = 0, pad_mode: str = "reflect", norm: str = "instance",
                 act: str = "relu", use_bias: bool = True,
                 dtype: torch.dtype = torch.float32) -> None:
        super().__init__()
        if pad_mode not in ("reflect", "zero"):
            raise ValueError(f"unknown pad_mode {pad_mode!r} (reflect|zero)")
        self.conv = nn.Conv2d(in_ch, features, kernel, stride=stride, bias=use_bias)
        self.pad, self.pad_mode, self.act, self.dtype = pad, pad_mode, act, dtype
        self.norm = get_norm(norm)(features)
        # The trunk's 3x3 convolutions: weight gradient from TPU kernel #8.
        self.dw_fused = pad_mode == "reflect" and F.use_dw_fused(in_ch, features, kernel,
                                                                 stride)
        self.spatial: S.Spatial | None = None

    def out_rows(self, rows: int | None) -> int | None:
        """The global H of the output for an input of global H ``rows``."""
        if rows is None:
            return None
        return S.conv_out_rows(rows, self.conv.kernel_size[0], self.conv.stride[0], self.pad)

    def forward(self, x: torch.Tensor, skip: torch.Tensor | None = None,
                rows: int | None = None) -> torch.Tensor:
        stride = self.conv.stride[0]
        if self.spatial is not None:
            if rows is None:
                raise ValueError("ConvBlock on an H slab needs rows, the global H of its input")
            y = slab_conv(x, rows, self.conv, self.pad, self.pad_mode, self.dtype,
                          self.spatial, self.dw_fused)
            return apply_norm(self.norm, y, self.act, skip)
        if self.dw_fused:
            d, b = self.dtype, self.conv.bias
            x = F.conv2d_valid_dw_fused(F.reflect_pad(x, self.pad).to(d),
                                        self.conv.weight.to(d))
            x = x if b is None else x + b.to(d).view(1, -1, 1, 1)
        elif self.pad_mode == "reflect":
            x = F.conv2d(F.reflect_pad(x, self.pad), self.conv.weight, self.conv.bias,
                         stride=stride, compute_dtype=self.dtype)
        else:
            x = F.conv2d(x, self.conv.weight, self.conv.bias, stride=stride,
                         padding=self.pad, compute_dtype=self.dtype)
        return apply_norm(self.norm, x, self.act, skip)


class DeconvBlock(nn.Module):
    """Transposed conv (torch geometry, k3 s2 p1 op1 doubles H and W) ->
    norm -> activation (reference ``dconv_norm_relu``). Under a spatial
    axis ``rows`` is the global H of ``x``: the rank gathers the input rows
    that reach its output rows (one halo row from below at k3 s2 p1) and
    crops the transposed convolution of them to its rows."""

    def __init__(self, in_ch: int, features: int, kernel: int = 3, stride: int = 2,
                 padding: int = 1, output_padding: int = 1, norm: str = "instance",
                 act: str = "relu", use_bias: bool = True,
                 dtype: torch.dtype = torch.float32) -> None:
        super().__init__()
        self.conv = nn.ConvTranspose2d(in_ch, features, kernel, stride=stride,
                                       padding=padding, output_padding=output_padding,
                                       bias=use_bias)
        self.act, self.dtype = act, dtype
        self.norm = get_norm(norm)(features)
        self.spatial: S.Spatial | None = None

    def out_rows(self, rows: int | None) -> int | None:
        if rows is None:
            return None
        c = self.conv
        return S.deconv_out_rows(rows, c.kernel_size[0], c.stride[0], c.padding[0],
                                 c.output_padding[0])

    def forward(self, x: torch.Tensor, rows: int | None = None) -> torch.Tensor:
        c = self.conv
        if self.spatial is not None:
            if rows is None:
                raise ValueError("DeconvBlock on an H slab needs rows, the global H of its "
                                 "input")
            return apply_norm(self.norm, slab_deconv(x, rows, c, self.dtype, self.spatial),
                              self.act)
        x = F.conv2d_transpose(x, c.weight, c.bias, stride=c.stride[0],
                               padding=c.padding[0], output_padding=c.output_padding[0],
                               compute_dtype=self.dtype)
        return apply_norm(self.norm, x, self.act)


def dropout_keep(shape: tuple[int, ...], p: float, generator: torch.Generator) -> torch.Tensor:
    """Keep-mask of inverted dropout: True with probability 1 - p, of NHWC
    ``shape`` (the JAX package's layout), drawn from ``generator`` on its
    device."""
    return torch.rand(shape, generator=generator, device=generator.device) >= p


def dropout_keep_rows(shape: tuple[int, ...], p: float, generator: torch.Generator,
                      mesh: Mesh, rows: int, plane: int | None = None) -> torch.Tensor:
    """A data-parallel rank's keep-mask of NHWC ``shape``: ``shape[0] /
    rows`` segments of ``rows`` rows (a concatenation of batches of
    ``rows``). The mask of the global batch is drawn (every segment
    ``mesh.dp`` times longer, and under a spatial axis the whole H:
    ``plane`` rows, or ``mesh.spatial`` equal slabs when None; the
    generator is seeded alike on every rank) and this rank's rows of each
    segment, and its slab, are taken, so the ranks drop what one device
    drops on the global batch."""
    segs = shape[0] // rows
    if segs * rows != shape[0]:
        raise ValueError(f"{shape[0]} rows are no whole number of batches of {rows}")
    n, h, *rest = shape
    plane = h * mesh.spatial if plane is None else plane
    full = dropout_keep((segs * mesh.dp * rows, plane, *rest), p, generator)
    full = full.view(segs, mesh.dp, rows, plane, *rest)[:, mesh.data_index]
    lo, hi = S.slab(plane, mesh.spatial, mesh.spatial_index)
    if hi - lo != h:
        raise ValueError(f"a slab of {h} rows is not rank {mesh.spatial_index}'s of {plane}")
    return full[:, :, lo:hi].reshape(shape)


class Dropout(nn.Module):
    """Inverted dropout (``nn.Dropout`` semantics: kept values scaled by
    1 / (1 - p)). It drops only in train mode and only when the caller
    passes a generator (or a keep-mask drawn from one), as a Flax apply
    drops only when it is given a dropout key and ``deterministic=False``."""

    def __init__(self, p: float = 0.5) -> None:
        super().__init__()
        self.p = p
        # The data mesh and the rows of one batch on this rank
        # (set_data_mesh): the masks are then the global batch's.
        self.mesh: Mesh | None = None
        self.rows: int | None = None

    def keep_mask(self, shape: tuple[int, ...], generator: torch.Generator | None,
                  plane: int | None = None) -> torch.Tensor | None:
        """The NCHW keep-mask of a forward on an input of NCHW ``shape``
        (drawn through :func:`dropout_keep` in NHWC), or None where this
        forward would not drop. ``plane``: the global H of which the input
        is this rank's slab under a spatial axis (None: equal slabs)."""
        if not self.training or generator is None:
            return None
        n, c, h, w = shape
        if self.mesh is None or self.mesh.world == 1:
            keep = dropout_keep((n, h, w, c), self.p, generator)
        else:
            keep = dropout_keep_rows((n, h, w, c), self.p, generator, self.mesh, self.rows,
                                     plane)
        return keep.permute(0, 3, 1, 2)

    def forward(self, x: torch.Tensor, drop: torch.Generator | torch.Tensor | None = None,
                plane: int | None = None) -> torch.Tensor:
        """``drop``: the masks' generator, or a keep-mask of
        :meth:`keep_mask` drawn before (a recomputed forward replays it);
        ``plane``: :meth:`keep_mask`'s."""
        keep = drop if isinstance(drop, torch.Tensor) or drop is None \
            else self.keep_mask(tuple(x.shape), drop, plane)
        if keep is None or not self.training:
            return x
        return torch.where(keep, x / (1 - self.p), torch.zeros((), dtype=x.dtype,
                                                               device=x.device))


def resblock_route_from_env() -> tuple[str, int]:
    """``(route, hc)`` of the JAX package's ``CYCLEGAN_TPU_RESBLOCK`` and
    ``CYCLEGAN_TPU_RESBLOCK_HC``: ``("chunked", hc)`` or ``("fused", hc)``."""
    route = "chunked" if os.environ.get("CYCLEGAN_TPU_RESBLOCK") == "chunked" else "fused"
    return route, int(os.environ.get("CYCLEGAN_TPU_RESBLOCK_HC", "8"))


class ResidualBlock(nn.Module):
    """[refpad1, conv3x3, IN, ReLU, (dropout), refpad1, conv3x3, IN] + x
    (reference ``ResidualBlock``). ``route``: ``fused`` (the whole block is
    one call of ``kernels.residual_block_fused``, forward and backward),
    ``chunked`` (``kernels.residual_block_chunked`` with ``hc`` rows a
    chunk), or None for the environment's choice at build time. The two
    ConvBlocks then only hold the weights. Without instance norm, or with
    dropout, the block runs its ConvBlocks (route ``unfused``), as the JAX
    block does."""

    def __init__(self, features: int, norm: str = "instance",
                 dtype: torch.dtype = torch.float32, use_dropout: bool = False,
                 route: str | None = None, hc: int | None = None) -> None:
        super().__init__()
        self.conv0 = ConvBlock(features, features, 3, pad=1, norm=norm, act="relu",
                               dtype=dtype)
        self.conv1 = ConvBlock(features, features, 3, pad=1, norm=norm, act="none",
                               dtype=dtype)
        self.dropout = Dropout() if use_dropout else None
        env_route, env_hc = resblock_route_from_env()
        chosen = route is not None or env_route == "chunked"
        route = env_route if route is None else route
        if route not in ("fused", "chunked"):
            raise ValueError(f"unknown residual-block route {route!r} (fused|chunked)")
        # The route a whole block takes, and whether the caller (or the
        # environment) chose it: under a spatial axis a chosen whole route
        # raises, the default gives way to the unfused one.
        self.whole_route = "unfused" if norm != "instance" or use_dropout else route
        self.route_chosen = chosen
        self.route = self.whole_route
        self.hc = env_hc if hc is None else hc
        self.dtype = dtype

    def set_spatial(self, on: bool) -> None:
        """Take the unfused route under a spatial axis (``on``): kernels #3-#7
        take whole planes."""
        if on and self.whole_route != "unfused" and self.route_chosen:
            raise ValueError(
                f"residual-block route {self.whole_route!r} takes whole planes; under "
                f"spatial_shards > 1 the block runs unfused (leave the route and "
                f"CYCLEGAN_TPU_RESBLOCK unset)")
        self.route = "unfused" if on else self.whole_route

    def keep_mask(self, x: torch.Tensor, generator: torch.Generator | None,
                  rows: int | None = None) -> torch.Tensor | None:
        """The dropout keep-mask a forward on ``x`` (of global H ``rows``
        under a spatial axis) would draw from ``generator`` (None where it
        would not drop): drawn ahead of a recomputed forward, so both passes
        drop the same elements."""
        if self.dropout is None:
            return None
        return self.dropout.keep_mask(tuple(x.shape), generator, rows)

    def forward(self, x: torch.Tensor,
                dropout: torch.Generator | torch.Tensor | None = None,
                rows: int | None = None) -> torch.Tensor:
        """``dropout``: the generator of the dropout masks, or the keep-mask
        of :meth:`keep_mask` (train mode only; None or eval mode never
        drops); ``rows``: the global H under a spatial axis."""
        if self.route == "unfused":
            h = self.conv0(x, rows=rows)
            if self.dropout is not None:
                h = self.dropout(h, dropout, rows)
            return self.conv1(h, skip=x, rows=rows)
        d = self.dtype
        c0, c1 = self.conv0.conv, self.conv1.conv
        args = (to_nhwc(x.to(d)), hwio(c0.weight, d), c0.bias.to(d),
                hwio(c1.weight, d), c1.bias.to(d), 1e-5)
        if self.route == "chunked":
            return to_nchw(residual_block_chunked(*args, self.hc))
        return to_nchw(residual_block_fused(*args))
