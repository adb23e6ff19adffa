"""Fused instance norm + activation (+ residual add), forward.

The counterpart of ``cyclegan_tpu/kernels/instance_norm.py::instance_norm_act``
(forward). Per (sample, channel) over the spatial axes of an NHWC tensor::

    y = act((x - mean) * rsqrt(var + eps)) [+ skip]

with float32 statistics, the biased variance and the result cast back to the
input type; ``act`` is ``none | relu | leaky`` (slope 0.2). On a CUDA tensor
:func:`instance_norm_act` launches the hand-written kernel of
``csrc/instance_norm.cu`` or raises; on a CPU tensor it runs
:func:`instance_norm_act_plain`, the same function in plain PyTorch.
"""

from __future__ import annotations

import torch

from cyclegan_tpu_torch.kernels import _build

ACTS = {"none": 0, "relu": 1, "leaky": 2}
LEAKY_SLOPE = 0.2

# Launches of the CUDA kernel through instance_norm_act (the residual block's
# own instance-norm launches are counted by its wrapper, not here).
launches = 0


def _act(z: torch.Tensor, act: str) -> torch.Tensor:
    if act == "relu":
        return torch.clamp_min(z, 0.0)
    if act == "leaky":
        return torch.where(z >= 0, z, z * LEAKY_SLOPE)
    return z


def instance_norm_act_plain(x: torch.Tensor, skip: torch.Tensor | None = None,
                            eps: float = 1e-5, act: str = "none",
                            out_dtype: torch.dtype | None = None) -> torch.Tensor:
    """Plain PyTorch version: NHWC ``x`` -> NHWC of ``out_dtype`` (default
    ``x.dtype``); ``skip`` is added in float32 after the activation."""
    if act not in ACTS:
        raise ValueError(f"unknown act {act!r} (none|relu|leaky)")
    x32 = x.float()
    mean = x32.mean(dim=(1, 2), keepdim=True)
    var = torch.square(x32 - mean).mean(dim=(1, 2), keepdim=True)
    y = _act((x32 - mean) * torch.rsqrt(var + eps), act)
    if skip is not None:
        y = y + skip.float()
    return y.to(out_dtype or x.dtype)


def _tile_rows(hw: int, c: int) -> int:
    """Rows of H*W per block: the largest of 1024, 512, ... 64 that gives
    one sample at least one block per SM of an H100 (132 SMs). It depends
    on the sample's shape only, so a sample's statistics are summed in the
    same order whatever batch it is in."""
    rows = 1024
    while rows > 64 and -(-hw // rows) * -(-c // 32) < 132:
        rows //= 2
    return rows


def launch(x: torch.Tensor, skip: torch.Tensor | None, out: torch.Tensor,
           eps: float, act: str) -> None:
    """Run the CUDA kernel: NHWC ``x`` (float32 or bf16) -> ``out`` (NHWC,
    float32 or bf16; ``skip`` has ``out``'s type). Allocates only scratch."""
    n, h, w, c = x.shape
    for t in (x, out) + ((skip,) if skip is not None else ()):
        if t.device != x.device or not t.is_contiguous():
            raise ValueError("instance_norm_act: tensors must be contiguous "
                             "NHWC on one device")
        if t.dtype not in _build.DTYPE_CODES:
            raise TypeError(f"instance_norm_act: unsupported dtype {t.dtype}")
    if out.shape != x.shape or (skip is not None and (
            skip.shape != x.shape or skip.dtype != out.dtype)):
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
    err = _build.load("instance_norm").cg_instance_norm_act(
        x.data_ptr(), None if skip is None else skip.data_ptr(), out.data_ptr(),
        pmean.data_ptr(), pm2.data_ptr(), mean.data_ptr(), rstd.data_ptr(),
        n, hw, c, rows, float(eps), ACTS[act], _build.DTYPE_CODES[x.dtype],
        _build.DTYPE_CODES[out.dtype], _build.stream_ptr(x))
    _build.check(err, "cg_instance_norm_act")


def instance_norm_act(x: torch.Tensor, skip: torch.Tensor | None = None,
                      eps: float = 1e-5, act: str = "none") -> torch.Tensor:
    """Fused instance norm + activation (+ ``skip``) of an NHWC tensor.

    CUDA tensors go through the hand-written kernel; CPU tensors through
    :func:`instance_norm_act_plain`. Any other device raises.
    """
    global launches
    if act not in ACTS:
        raise ValueError(f"unknown act {act!r} (none|relu|leaky)")
    if x.dim() != 4:
        raise ValueError(f"instance_norm_act wants NHWC, got shape {tuple(x.shape)}")
    if x.device.type == "cpu":
        return instance_norm_act_plain(x, skip, eps, act)
    if x.device.type != "cuda":
        raise ValueError(f"instance_norm_act: no kernel for device {x.device}")
    out = torch.empty_like(x, memory_format=torch.contiguous_format)
    launch(x, skip, out, eps, act)
    launches += 1
    return out
