"""Fused instance norm + activation (+ residual add), forward and VJP.

The counterpart of ``cyclegan_tpu/kernels/instance_norm.py::instance_norm_act``.
Per (sample, channel) over the spatial axes of an NHWC tensor::

    y = act((x - mean) * rsqrt(var + eps)) [+ skip]

with float32 statistics, the biased variance and the result cast back to the
input type; ``act`` is ``none | relu | leaky`` (slope 0.2). The VJP, from the
forward's own statistics, is::

    dx = rstd * (g - mean_hw(g) - xhat * mean_hw(g * xhat)),  g = act'(xhat) * dy
    dskip = dy

with ``xhat = (x - mean) * rstd`` recomputed from x; dx has x's type.

:func:`instance_norm_act` is a ``torch.autograd.Function``. On a CUDA tensor
its forward and backward launch the hand-written kernels of
``csrc/instance_norm.cu`` or raise; on a CPU tensor they run the plain
PyTorch versions (:func:`instance_norm_act_plain`,
:func:`instance_norm_act_bwd_plain`) through the same Function.
"""

from __future__ import annotations

import torch

from cyclegan_tpu_torch.kernels import _build

ACTS = {"none": 0, "relu": 1, "leaky": 2}
LEAKY_SLOPE = 0.2

# Calls of instance_norm_act that launched the CUDA forward, and backward
# passes of it that launched the CUDA VJP (the residual block's own
# instance-norm launches are counted by its wrapper, not here).
launches = 0
bwd_launches = 0


def _act(z: torch.Tensor, act: str) -> torch.Tensor:
    if act == "relu":
        return torch.clamp_min(z, 0.0)
    if act == "leaky":
        return torch.where(z >= 0, z, z * LEAKY_SLOPE)
    return z


def _act_grad(z: torch.Tensor, act: str) -> torch.Tensor:
    """d act / dz at z (the JAX package's ``_act_grad_from_z``): relu takes
    z > 0, leaky z >= 0 -> 1 else 0.2."""
    if act == "relu":
        return (z > 0).to(z.dtype)
    if act == "leaky":
        return torch.where(z >= 0, 1.0, LEAKY_SLOPE).to(z.dtype)
    return torch.ones_like(z)


def instance_norm_stats_plain(x: torch.Tensor, eps: float = 1e-5
                              ) -> tuple[torch.Tensor, torch.Tensor]:
    """float32 ``(mean, rstd)``, each (N, C), of NHWC ``x`` over H*W."""
    x32 = x.float()
    mean = x32.mean(dim=(1, 2))
    var = torch.square(x32 - mean[:, None, None]).mean(dim=(1, 2))
    return mean, torch.rsqrt(var + eps)


def instance_norm_act_plain(x: torch.Tensor, skip: torch.Tensor | None = None,
                            eps: float = 1e-5, act: str = "none",
                            out_dtype: torch.dtype | None = None) -> torch.Tensor:
    """Plain PyTorch version: NHWC ``x`` -> NHWC of ``out_dtype`` (default
    ``x.dtype``); ``skip`` is added in float32 after the activation."""
    if act not in ACTS:
        raise ValueError(f"unknown act {act!r} (none|relu|leaky)")
    mean, rstd = instance_norm_stats_plain(x, eps)
    y = _act((x.float() - mean[:, None, None]) * rstd[:, None, None], act)
    if skip is not None:
        y = y + skip.float()
    return y.to(out_dtype or x.dtype)


def instance_norm_act_bwd_plain(x: torch.Tensor, dy: torch.Tensor, mean: torch.Tensor,
                                rstd: torch.Tensor, act: str = "none") -> torch.Tensor:
    """Plain PyTorch VJP: dx (x's type) from NHWC ``x`` and ``dy`` and the
    forward's float32 (N, C) ``mean`` and ``rstd``."""
    m, r = mean[:, None, None], rstd[:, None, None]
    xhat = (x.float() - m) * r
    g = dy.float() * _act_grad(xhat, act)
    g_mean = g.mean(dim=(1, 2), keepdim=True)
    gx_mean = (g * xhat).mean(dim=(1, 2), keepdim=True)
    return (r * (g - g_mean - xhat * gx_mean)).to(x.dtype)


def _tile_rows(hw: int, c: int) -> int:
    """Rows of H*W per block: the largest of 1024, 512, ... 64 that gives
    one sample at least one block per SM of an H100 (132 SMs). It depends
    on the sample's shape only, so a sample's statistics are summed in the
    same order whatever batch it is in."""
    rows = 1024
    while rows > 64 and -(-hw // rows) * -(-c // 32) < 132:
        rows //= 2
    return rows


def _check(name: str, *tensors: torch.Tensor) -> None:
    dev = tensors[0].device
    for t in tensors:
        if t.device != dev or not t.is_contiguous():
            raise ValueError(f"{name}: tensors must be contiguous NHWC on one device")
        if t.dtype not in _build.DTYPE_CODES:
            raise TypeError(f"{name}: unsupported dtype {t.dtype}")


def launch(x: torch.Tensor, skip: torch.Tensor | None, out: torch.Tensor | None,
           eps: float, act: str) -> tuple[torch.Tensor, torch.Tensor]:
    """Run the CUDA forward: NHWC ``x`` (float32 or bf16) -> ``out`` (NHWC,
    float32 or bf16; ``skip`` has ``out``'s type). ``out=None`` makes the
    statistics only. Returns the float32 (N, C) ``(mean, rstd)``."""
    n, h, w, c = x.shape
    _check("instance_norm_act", x, *(t for t in (skip, out) if t is not None))
    if skip is not None and out is None:
        raise ValueError("instance_norm_act: skip needs an output")
    if out is not None and (out.shape != x.shape or (skip is not None and (
            skip.shape != x.shape or skip.dtype != out.dtype))):
        raise ValueError("instance_norm_act: skip/out must match x's shape "
                         "and out's dtype")
    hw = h * w
    rows = _tile_rows(hw, c)
    tiles = -(-hw // rows)
    f32 = dict(dtype=torch.float32, device=x.device)
    pmean = torch.empty((n, tiles, c), **f32)
    pm2 = torch.empty((n, tiles, c), **f32)
    mean = torch.empty((n, c), **f32)
    rstd = torch.empty((n, c), **f32)
    out_dtype = (out if out is not None else x).dtype
    _build.call("instance_norm", "cg_instance_norm_act",
                x.data_ptr(), None if skip is None else skip.data_ptr(),
                None if out is None else out.data_ptr(), pmean.data_ptr(),
                pm2.data_ptr(), mean.data_ptr(), rstd.data_ptr(), n, hw, c, rows,
                float(eps), ACTS[act], _build.DTYPE_CODES[x.dtype],
                _build.DTYPE_CODES[out_dtype], _build.stream_ptr(x))
    return mean, rstd


def launch_bwd(x: torch.Tensor, dy: torch.Tensor, mean: torch.Tensor, rstd: torch.Tensor,
               dx: torch.Tensor, act: str) -> None:
    """Run the CUDA VJP: contiguous NHWC ``x`` and ``dy`` (float32 or bf16
    each), the forward's (N, C) float32 ``mean``/``rstd`` -> ``dx`` (x's
    type). Allocates only scratch."""
    n, h, w, c = x.shape
    _check("instance_norm_act_bwd", x, dy, dx, mean, rstd)
    if dy.shape != x.shape or dx.shape != x.shape or dx.dtype != x.dtype:
        raise ValueError("instance_norm_act_bwd: dy/dx must match x's shape, dx x's dtype")
    if mean.shape != (n, c) or rstd.shape != (n, c) or mean.dtype != torch.float32 \
            or rstd.dtype != torch.float32:
        raise ValueError("instance_norm_act_bwd: mean/rstd must be (N, C) float32")
    hw = h * w
    rows = _tile_rows(hw, c)
    tiles = -(-hw // rows)
    f32 = dict(dtype=torch.float32, device=x.device)
    psg = torch.empty((n, tiles, c), **f32)
    psgx = torch.empty((n, tiles, c), **f32)
    gmean = torch.empty((n, c), **f32)
    gxmean = torch.empty((n, c), **f32)
    _build.call("instance_norm", "cg_instance_norm_act_bwd",
                x.data_ptr(), dy.data_ptr(), mean.data_ptr(), rstd.data_ptr(),
                dx.data_ptr(), psg.data_ptr(), psgx.data_ptr(), gmean.data_ptr(),
                gxmean.data_ptr(), n, hw, c, rows, ACTS[act],
                _build.DTYPE_CODES[x.dtype], _build.DTYPE_CODES[dy.dtype],
                _build.stream_ptr(x))


def _fwd_cuda(x, skip, eps, act):
    global launches
    out = torch.empty_like(x, memory_format=torch.contiguous_format)
    mean, rstd = launch(x, skip, out, eps, act)
    launches += 1
    return out, mean, rstd


def _fwd_plain(x, skip, eps, act):
    mean, rstd = instance_norm_stats_plain(x, eps)
    return instance_norm_act_plain(x, skip, eps, act), mean, rstd


def _bwd_cuda(x, dy, mean, rstd, act):
    global bwd_launches
    dx = torch.empty_like(x, memory_format=torch.contiguous_format)
    launch_bwd(x, dy, mean, rstd, dx, act)
    bwd_launches += 1
    return dx


class InstanceNormAct(torch.autograd.Function):
    """The differentiable seam. ``plain`` picks the plain PyTorch versions
    (CPU tensors, and the reference path) over the CUDA kernels. The
    forward saves x and its statistics only when a gradient is wanted, so
    serving under ``inference_mode`` or ``no_grad`` keeps nothing."""

    @staticmethod
    def forward(ctx, x, skip, eps, act, plain):
        y, mean, rstd = (_fwd_plain if plain else _fwd_cuda)(x, skip, eps, act)
        if ctx.needs_input_grad[0] or ctx.needs_input_grad[1]:
            ctx.save_for_backward(x, mean, rstd)
            ctx.act, ctx.plain = act, plain
        return y

    @staticmethod
    def backward(ctx, dy):
        x, mean, rstd = ctx.saved_tensors
        dx = None
        if ctx.needs_input_grad[0]:
            # Cotangents often arrive non-contiguous (through the NCHW view
            # of the output); the kernels take contiguous NHWC only.
            dy_c = dy.contiguous()
            bwd = instance_norm_act_bwd_plain if ctx.plain else _bwd_cuda
            dx = bwd(x, dy_c, mean, rstd, ctx.act)
        dskip = dy if ctx.needs_input_grad[1] else None
        return dx, dskip, None, None, None


def _check_args(x: torch.Tensor, act: str) -> None:
    if act not in ACTS:
        raise ValueError(f"unknown act {act!r} (none|relu|leaky)")
    if x.dim() != 4:
        raise ValueError(f"instance_norm_act wants NHWC, got shape {tuple(x.shape)}")


def instance_norm_act(x: torch.Tensor, skip: torch.Tensor | None = None,
                      eps: float = 1e-5, act: str = "none") -> torch.Tensor:
    """Fused instance norm + activation (+ ``skip``) of an NHWC tensor,
    differentiable in ``x`` and ``skip``.

    CUDA tensors go through the hand-written kernels, forward and backward;
    CPU tensors through the plain versions. Any other device raises.
    """
    _check_args(x, act)
    if x.device.type not in ("cpu", "cuda"):
        raise ValueError(f"instance_norm_act: no kernel for device {x.device}")
    return InstanceNormAct.apply(x, skip, eps, act, x.device.type == "cpu")


def instance_norm_act_reference(x: torch.Tensor, skip: torch.Tensor | None = None,
                                eps: float = 1e-5, act: str = "none") -> torch.Tensor:
    """The same Function over the plain versions on any device: the kernel
    path's wiring with plain arithmetic, the yardstick the on-card checks
    compare the kernels with. The port's modules never call it."""
    _check_args(x, act)
    return InstanceNormAct.apply(x, skip, eps, act, True)
