"""Weight gradient of a VALID stride-1 k x k convolution (trunk shapes).

The counterpart of ``cyclegan_tpu/kernels/conv_dw.py``::

    dw[s, t] = sum_n xp[n, s:s+H, t:t+W, :]^T @ dy[n]        (k, k, Cin, Cout)

for an input ``xp`` (N, H+k-1, W+k-1, Cin) that is already padded and the
output gradient ``dy`` (N, H, W, Cout), NHWC, accumulated in float32 and
returned as float32. :func:`conv_dw` launches the hand-written kernel of
``csrc/conv_dw.cu`` (TPU kernel #8) on a CUDA tensor, or raises; on a CPU
tensor it runs :func:`conv_dw_plain`. ``ops.functional.conv2d_valid_dw_fused``
routes the weight gradient of the trunk's reflect-padded 3x3 convolutions
through it.

The kernel multiplies bf16 "parts" on the tensor cores: a bf16 tensor is
one part; a float32 tensor ``t`` is ``hi = bf16(t)``, ``mid = bf16(t -
hi)`` and ``lo = bf16(t - hi - mid)``, cut to the first two or all three
(:func:`bf16_parts`, :func:`bf16_parts_plain`), and the products (a, b) of
the parts with ``a + b < max(na, nb)`` are summed in float32
(:func:`passes`). A float32 cotangent against bf16 values takes two parts,
float32 against float32 three each, which keeps the products exact to
float32 rounding (:func:`parts`). The residual blocks' weight gradients
(``kernels.resblock.conv3x3_reflect_wgrad``) run the same kernel through
:func:`launch_wgrad` on their unpadded input, which it reads through
reflect indexing, and on the cotangent's bf16 parts as the norm VJP wrote
them.
"""

from __future__ import annotations

import functools

import torch

from cyclegan_tpu_torch.kernels import _build

# The kernel's output tile (rows of k*k*Cin, columns of Cout) and its
# pipeline step in pixels (csrc/conv_dw.cu BM, BN, BK).
TILE_M, TILE_N = 128, 256
STEP = 32
# Blocks of the weight gradient resident at once on an H100: 132 SMs, one
# block each (up to 222 KB of shared memory a block).
RESIDENT_BLOCKS = 132
# Pixels a chunk of a float32 weight gradient (three parts against three,
# six passes into one accumulator) sums at most: the tensor cores'
# truncating float32 accumulation errs in proportion to the steps a chunk
# adds. On an H100 the trunk's one-wave chunks read 0.33 of chip_smoke.py's
# float32 bar at 1,184 pixels (batch 2), 1.22 at 4,704 (batch 8) and 2.45
# at 9,376 (batch 16); capped here, 0.32 and 0.33 at batch 8 and 16.
F32_CHUNK = 37 * STEP


def _shapes(xp: torch.Tensor, dy: torch.Tensor, k: int) -> tuple[int, ...]:
    if xp.dim() != 4 or dy.dim() != 4:
        raise ValueError(f"conv_dw wants NHWC xp and dy, got {tuple(xp.shape)}, "
                         f"{tuple(dy.shape)}")
    n, hp, wp, cin = xp.shape
    nd, h, w_, cout = dy.shape
    if nd != n or hp != h + k - 1 or wp != w_ + k - 1:
        raise ValueError(f"conv_dw: xp {tuple(xp.shape)} is not dy {tuple(dy.shape)} "
                         f"padded for a {k}x{k} VALID convolution")
    return n, h, w_, cin, cout


def conv_dw_plain(xp: torch.Tensor, dy: torch.Tensor, k: int = 3) -> torch.Tensor:
    """Plain PyTorch version: k*k float32 products of the shifted input
    with the output gradient, summed over the batch and the pixels."""
    n, h, w_, cin, cout = _shapes(xp, dy, k)
    x32, g = xp.float(), dy.float().reshape(-1, cout)
    return torch.stack([torch.stack([x32[:, s:s + h, t:t + w_].reshape(-1, cin).T @ g
                                     for t in range(k)]) for s in range(k)])


def bf16_parts_plain(t: torch.Tensor, parts: int) -> torch.Tensor:
    """Plain version of :func:`bf16_parts` without padding: ``(parts,
    *t.shape)`` bf16, each part the bf16 rounding of what the parts before
    it left of ``t``; their sum is ``t`` to within 2^-16 of ``|t|`` for two
    parts and 2^-24 for three."""
    out, rest = [], t.float()
    for _ in range(parts):
        out.append(rest.to(torch.bfloat16))
        rest = rest - out[-1].float()
    return torch.stack(out)


def parts(dtype: torch.dtype, partner: torch.dtype) -> int:
    """bf16 parts of an operand of ``dtype`` whose product partner has
    dtype ``partner``: one for bf16; float32 takes two against bf16, three
    against float32."""
    if dtype == torch.bfloat16:
        return 1
    return 2 if partner == torch.bfloat16 else 3


def passes(na: int, nb: int) -> int:
    """Tensor-core products of ``na`` by ``nb`` parts: the (a, b) with
    ``a + b < max(na, nb)``, as the kernels issue them."""
    return sum(a + b < max(na, nb) for a in range(na) for b in range(nb))


def supported(xp_shape: tuple[int, ...], dy_shape: tuple[int, ...]) -> bool:
    """Which convolutions route their weight gradient through the kernel:
    both channel dims >= 128 (the JAX package's rule; its VMEM budget has no
    counterpart on the card). The kernel takes any channel count."""
    return len(xp_shape) == 4 and len(dy_shape) == 4 and \
        xp_shape[-1] >= 128 and dy_shape[-1] >= 128


def _wgrad_tiles(m: int, n: int) -> int:
    """Output tiles of the weight gradient (m = k*k*Cin rows, n = Cout)."""
    return -(-m // TILE_M) * -(-n // TILE_N)


@functools.cache
def _wgrad_split(tiles: int, k: int, max_chunk: int | None = None) -> tuple[int, int]:
    """K (pixel) chunks of the weight gradient: enough blocks to keep the
    resident blocks of an H100 busy (at most one wave of them), at least
    256 pixels a chunk, a chunk a multiple of the kernel's 32-pixel step;
    more chunks where one would sum over ``max_chunk`` pixels (a multiple
    of the step). From the shapes only, so dw's summation order is fixed."""
    splits = max(1, min(RESIDENT_BLOCKS // tiles, k // 256))
    if max_chunk is not None:
        splits = max(splits, -(-k // max_chunk))
    kchunk = -(-k // splits)
    kchunk = -(-kchunk // STEP) * STEP
    return -(-k // kchunk), kchunk


def _round8(c: int) -> int:
    return -(-c // 8) * 8


def bf16_parts(t: torch.Tensor, parts: int, pad: int = 0) -> torch.Tensor:
    """CUDA kernel: the bf16 parts of contiguous NHWC ``t`` (one for bf16,
    one to three for float32), reflect-padded by ``pad`` (0 or 1): ``(parts,
    N, H + 2 pad, W + 2 pad, C8)`` bf16, C rounded up to a multiple of 8
    (the tensor-core tiles' 16-byte rows) with zeros past C."""
    n, h, w_, c = t.shape
    if parts not in (1, 2, 3) or (parts > 1 and t.dtype != torch.float32):
        raise ValueError(f"bf16_parts: {parts} parts of a {t.dtype} tensor")
    if pad not in (0, 1) or (pad and (h < 2 or w_ < 2)):
        raise ValueError(f"bf16_parts: reflect pad {pad} of {h}x{w_}")
    if not t.is_contiguous():
        raise ValueError("bf16_parts needs a contiguous tensor")
    _build.check_same_device("bf16_parts", t)
    out = torch.empty((parts, n, h + 2 * pad, w_ + 2 * pad, _round8(c)), dtype=torch.bfloat16,
                      device=t.device)
    _build.call("conv_dw", "cg_bf16_parts", t.data_ptr(), out.data_ptr(), n, h, w_, c, pad,
                parts, _build.DTYPE_CODES[t.dtype], _build.stream_ptr(t))
    return out


# The (input, output gradient) parts the kernel takes, by the input's form:
# padded (conv_dw's, and the bf16 parts of a padded copy), or unpadded and
# read through reflect padding (the residual blocks').
WGRAD_PARTS = {"padded": ((1, 1), (1, 2), (3, 3)), "reflect": ((1, 2), (3, 3))}


def wgrad_form(xp_shape: tuple[int, ...], dims: tuple[int, ...], k: int) -> str:
    """The form of the weight gradient's input, from its plane: ``"padded"``
    ((H+k-1, W+k-1)) or ``"reflect"`` ((H, W), k = 3: the kernel reads it
    through reflect padding of 1). Raises ValueError on any other plane."""
    _, h, w_, _, _ = dims
    plane = tuple(xp_shape[-3:-1])
    if plane == (h + k - 1, w_ + k - 1):
        return "padded"
    if plane == (h, w_) and k == 3 and h >= 2 and w_ >= 2:
        return "reflect"
    raise ValueError(f"conv_dw: input plane {plane} is neither ({h}, {w_}) padded for a "
                     f"{k}x{k} VALID convolution nor an unpadded one to reflect-pad by 1")


def launch_wgrad(xp: torch.Tensor, na: int, dy: torch.Tensor, nb: int,
                 dims: tuple[int, ...], k: int,
                 out_dtype: torch.dtype = torch.float32) -> torch.Tensor:
    """CUDA kernel: dw (k, k, Cin, Cout) of ``out_dtype`` from ``na`` bf16
    parts of the input ``xp`` and ``nb`` of the output gradient ``dy``
    ((N, H, W, Cout) each), stored part after part; ``dims`` = (N, H, W,
    Cin, Cout). ``xp`` is padded ((N, H+k-1, W+k-1, Cin) each) or, with k =
    3, unpadded ((N, H, W, Cin) each; the kernel reads it through reflect
    padding of 1): :func:`wgrad_form` tells them apart by shape, and
    :data:`WGRAD_PARTS` gives the (na, nb) of each; counted by form in
    ``_build.forms``. Split-K partials in scratch, added in a fixed order.
    The caller has checked the tensors and that Cin and Cout are multiples
    of 8 (:func:`bf16_parts` pads them to that)."""
    n, h, w_, cin, cout = dims
    form = wgrad_form(xp.shape, dims, k)
    if (na, nb) not in WGRAD_PARTS[form] or \
            xp.dtype != torch.bfloat16 or dy.dtype != torch.bfloat16:
        raise ValueError(f"conv_dw: ({na}, {nb}) parts of {xp.dtype}, {dy.dtype}, "
                         f"{form} input")
    out = torch.empty((k, k, cin, cout), dtype=out_dtype, device=xp.device)
    splits, kchunk = _wgrad_split(_wgrad_tiles(k * k * cin, cout), n * h * w_,
                                  F32_CHUNK if na == 3 else None)
    stream = _build.stream_ptr(xp)
    part = _build.scratch_ptr(4 * splits * k * k * cin * cout, xp, stream)
    _build.call("conv_dw", "cg_conv_dw", xp.data_ptr(), dy.data_ptr(), out.data_ptr(), part,
                n, h, w_, cin, cout, k, splits, kchunk, na, nb, int(form == "reflect"),
                _build.DTYPE_CODES[out_dtype], stream)
    _build.forms["wgrad", form] += 1
    return out


def _dw_cuda(xp: torch.Tensor, dy: torch.Tensor, k: int) -> torch.Tensor:
    n, h, w_, cin, cout = _shapes(xp, dy, k)
    if dy.dtype != xp.dtype:
        raise TypeError(f"conv_dw: xp and dy must share one dtype, got {xp.dtype}, {dy.dtype}")
    if not (xp.is_contiguous() and dy.is_contiguous()):
        raise ValueError("conv_dw needs contiguous xp and dy")
    _build.check_same_device("conv_dw", xp, dy)
    nparts = parts(xp.dtype, dy.dtype)
    cin8, cout8 = _round8(cin), _round8(cout)
    if nparts == 1 and (cin8, cout8) == (cin, cout):
        out = launch_wgrad(xp, 1, dy, 1, (n, h, w_, cin, cout), k)
    else:
        # float32 operands in their bf16 parts; channels zero-filled up to
        # a multiple of 8, and dw cut back to the real ones.
        out = launch_wgrad(bf16_parts(xp, nparts), nparts, bf16_parts(dy, nparts), nparts,
                           (n, h, w_, cin8, cout8), k)
        if (cin8, cout8) != (cin, cout):
            out = out[:, :, :cin, :cout].contiguous()
    return out


def conv_dw(xp: torch.Tensor, dy: torch.Tensor, k: int = 3) -> torch.Tensor:
    """dw (k, k, Cin, Cout) float32 of a VALID stride-1 convolution: the
    CUDA kernel for CUDA tensors, the plain version for CPU tensors."""
    if xp.is_cuda:
        return _dw_cuda(xp, dy, k)
    if xp.device.type != "cpu":
        raise ValueError(f"conv_dw: no kernel for device {xp.device}")
    return conv_dw_plain(xp, dy, k)
