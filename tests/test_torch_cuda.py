"""The port's CUDA kernels against their plain PyTorch versions, on the card.

Every test here needs a CUDA device (marker ``cuda``) and skips without one:
the kernels have no CPU mode. The file imports nothing of JAX, so it also
runs on a machine that has only the port's dependencies::

    python -m pytest --noconftest -p no:cacheprovider tests/test_torch_cuda.py

(``--noconftest`` because ``tests/conftest.py`` sets up JAX). Shapes are
small and odd on purpose (ragged tiles, C not a multiple of 32, Cout not a
multiple of 128); ``chip_smoke.py`` covers the main path's shapes.
Tolerances are those of ``chip_smoke.py``, with the same reasons.
"""

import copy

import numpy as np
import pytest
import torch
import torch.nn.functional as F

from cyclegan_tpu_torch.kernels import _build
from cyclegan_tpu_torch.kernels import conv_dw as CD
from cyclegan_tpu_torch.kernels import instance_norm as IN
from cyclegan_tpu_torch.kernels import resblock as RB
from cyclegan_tpu_torch.kernels import resblock_chunked as RC
from cyclegan_tpu_torch.models.generators import define_Gen
from cyclegan_tpu_torch.ops import blocks
from cyclegan_tpu_torch.ops import functional as OF
from cyclegan_tpu_torch.train.cyclegan import CycleGANTrainer
from cyclegan_tpu_torch.utils.config import Config

pytestmark = pytest.mark.cuda

TOL = {torch.float32: dict(atol=2e-5, rtol=1e-5),
       torch.bfloat16: dict(atol=2 ** -7, rtol=2 ** -6)}
RB_TOL = {torch.float32: dict(atol=1e-4, rtol=1e-4),
          torch.bfloat16: dict(atol=2 ** -6, rtol=2 ** -6)}


def _delta(before, *entries) -> tuple:
    """Calls of each C entry since ``before``, a copy of ``_build.launches``."""
    return tuple(_build.launches[e] - before[e] for e in entries)


@pytest.fixture(autouse=True)
def card():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device: the kernels have no CPU mode")
    torch.backends.cudnn.allow_tf32 = False
    torch.backends.cuda.matmul.allow_tf32 = False
    return torch.Generator(device="cuda").manual_seed(0)


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("act,skip", [("none", False), ("relu", False), ("leaky", False),
                                      ("none", True)])
@pytest.mark.parametrize("shape", [(2, 16, 12, 64), (1, 5, 7, 40), (3, 33, 31, 96),
                                   (1, 3, 5, 64)])
def test_instance_norm_act_matches_plain(card, shape, act, skip, dtype):
    x = (torch.randn(shape, device="cuda", generator=card) * 3 + 1).to(dtype)
    s = torch.randn(shape, device="cuda", generator=card).to(dtype) if skip else None
    before = _build.launches.copy()
    y = IN.instance_norm_act(x, s, 1e-5, act)
    torch.cuda.synchronize()
    assert _delta(before, "cg_instance_norm_act") == (1,) and y.dtype == dtype
    torch.testing.assert_close(y.float(), IN.instance_norm_act_plain(x, s, 1e-5, act).float(),
                               **TOL[dtype])


def _slots(x: torch.Tensor, s: int, k: int) -> torch.Tensor:
    """An uninitialised (S, N, C, k) float32 exchange buffer for x's slabs."""
    return torch.empty((s, x.shape[0], x.shape[3], k), device=x.device)


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("act,skip", [("relu", False), ("none", True), ("leaky", False)])
@pytest.mark.parametrize("shape,cuts", [((2, 16, 12, 64), (8,)), ((1, 31, 7, 40), (16,)),
                                        ((1, 12, 10, 96), (3, 7, 9))])
def test_instance_norm_slab_entries_match_plain_and_the_whole_plane(card, shape, cuts, act,
                                                                    skip, dtype):
    """The slab entries (spatial axis): each slab's partials, written into
    its slot of the exchange buffer and summed over the slabs as the
    all-reduce sums them, give through each apply its rows of the one-launch
    kernel on the whole plane and of the plain slab versions, forward and
    VJP; every slab holds bitwise the same statistics; uneven slabs weigh by
    their counts; one launch a call of each entry."""
    x = (torch.randn(shape, device="cuda", generator=card) * 3 + 1).to(dtype)
    s = torch.randn(shape, device="cuda", generator=card).to(dtype) if skip else None
    dy = torch.randn(shape, device="cuda", generator=card).to(dtype)
    edges = [0, *cuts, shape[1]]
    rows = [slice(a, b) for a, b in zip(edges, edges[1:])]
    n = len(rows)
    xs = [x[:, r].contiguous() for r in rows]
    dys = [dy[:, r].contiguous() for r in rows]
    before = dict(_build.launches)
    parts = sum(IN._slab_partials_cuda(t, _slots(x, n, 3), i) for i, t in enumerate(xs))
    whole = IN.instance_norm_act_plain(x, s, 1e-5, act)
    mean, rstd = IN.instance_norm_stats_plain(x)
    dx_whole = IN.instance_norm_act_bwd_plain(x, dy, mean, rstd, act)
    outs = []
    for r, t in zip(rows, xs):
        y, m, rs, count = IN._slab_apply_cuda(t, None if s is None else s[:, r].contiguous(),
                                              parts, 1e-5, act)
        outs.append((y, m, rs, count))
    torch.testing.assert_close(outs[0][1], mean, atol=1e-5, rtol=1e-5)
    torch.testing.assert_close(outs[0][2], rstd, atol=1e-5, rtol=1e-5)
    assert float(outs[0][3]) == shape[1] * shape[2]
    sums = sum(IN._slab_bwd_partials_cuda(t, g, outs[0][1], outs[0][2], _slots(x, n, 2), i, act)
               for i, (t, g) in enumerate(zip(xs, dys)))
    for r, t, g, (y, m, rs, count) in zip(rows, xs, dys, outs):
        assert torch.equal(m, outs[0][1]) and torch.equal(rs, outs[0][2])  # every slab alike
        torch.testing.assert_close(y.float(), whole[:, r].float(), **TOL[dtype])
        plain = IN.slab_apply_plain(t, None if s is None else s[:, r].contiguous(),
                                    parts, 1e-5, act)[0]
        torch.testing.assert_close(y.float(), plain.float(), **TOL[dtype])
        dx = IN._slab_bwd_apply_cuda(t, g, m, rs, sums, count, act)
        tol = dict(atol=1e-4, rtol=1e-4) if dtype == torch.float32 else TOL[dtype]
        torch.testing.assert_close(dx.float(), dx_whole[:, r].float(), **tol)
    torch.cuda.synchronize()
    assert {k: _build.launches[k] - before.get(k, 0) for k in (
        "cg_instance_norm_partials", "cg_instance_norm_slab_apply",
        "cg_instance_norm_bwd_partials", "cg_instance_norm_bwd_slab_apply")} == \
        {"cg_instance_norm_partials": n, "cg_instance_norm_slab_apply": n,
         "cg_instance_norm_bwd_partials": n, "cg_instance_norm_bwd_slab_apply": n}


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("shape", [(2, 37, 29, 64), (1, 300, 40, 256), (3, 5, 7, 40)])
def test_instance_norm_slab_partials_fill_their_slot_and_zero_the_others(card, shape, dtype):
    """Into slot 1 of a NaN-filled buffer of 3: the slab's partials (against
    the plain version's) and exact zeros in slots 0 and 2, forward and VJP,
    over many tiles (300 x 40 rows at C = 256: 94 tiles of 2 channel groups
    in float32, 188 in bf16) as well as few."""
    x = (torch.randn(shape, device="cuda", generator=card) * 2 + 1).to(dtype)
    dy = torch.randn(shape, device="cuda", generator=card).to(dtype)
    mean, rstd = IN.instance_norm_stats_plain(x)
    for k, run, plain in (
            (3, lambda b: IN._slab_partials_cuda(x, b, 1),
             lambda b: IN.slab_partials_plain(x, b, 1)),
            (2, lambda b: IN._slab_bwd_partials_cuda(x, dy, mean, rstd, b, 1, "relu"),
             lambda b: IN.slab_bwd_partials_plain(x, dy, mean, rstd, b, 1, "relu"))):
        got = run(torch.full((3, shape[0], shape[3], k), float("nan"), device="cuda"))
        want = plain(_slots(x, 3, k))
        torch.cuda.synchronize()
        assert torch.equal(got[0], torch.zeros_like(got[0]))
        assert torch.equal(got[2], torch.zeros_like(got[2]))
        torch.testing.assert_close(got[1], want[1], atol=1e-3, rtol=1e-4)


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_instance_norm_slab_entries_second_call_is_bitwise(card, dtype):
    """Every entry, called twice on the same inputs, gives bitwise the same
    exchange buffer, output and statistics (every merge runs in a fixed
    order; no float atomics)."""
    x = (torch.randn((2, 96, 40, 64), device="cuda", generator=card) * 2 + 1).to(dtype)
    dy = torch.randn(x.shape, device="cuda", generator=card).to(dtype)

    def run():
        parts = IN._slab_partials_cuda(x, _slots(x, 2, 3), 0)
        y, mean, rstd, count = IN._slab_apply_cuda(x, None, parts, 1e-5, "leaky")
        sums = IN._slab_bwd_partials_cuda(x, dy, mean, rstd, _slots(x, 2, 2), 0, "leaky")
        dx = IN._slab_bwd_apply_cuda(x, dy, mean, rstd, sums, count, "leaky")
        return parts, y, mean, rstd, count, sums, dx

    first, again = run(), run()
    torch.cuda.synchronize()
    assert all(torch.equal(a, b) for a, b in zip(first, again))


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_instance_norm_slab_layer_is_two_kernels_a_direction(card, dtype, built_and_launched):
    """A slab norm layer (forward and its VJP through autograd) launches the
    two slab kernels a direction and nothing else: no fill, no copy around
    its all-reduce (stood in for here by a call that does no device work)."""
    x = torch.randn((1, 64, 64, 64), device="cuda", generator=card).to(dtype)
    dy = torch.randn(x.shape, device="cuda", generator=card).to(dtype)
    group = IN.SlabGroup(2, 1, lambda buf: None)
    xg = x.requires_grad_(True)

    def layer():
        y = IN.instance_norm_act_slab(xg, None, 1e-5, "relu", group)
        torch.autograd.grad(y, xg, dy)

    layer()
    torch.cuda.synchronize()
    names = _device_kernels(layer)
    assert len(names) == 4, names
    assert [sum(pat in k for k in names) for pat in (
        "in_fwd_partials<", "in_fwd_slab_apply<", "in_bwd_partials<", "in_bwd_slab_apply<")] \
        == [1, 1, 1, 1], names


def test_instance_norm_float32_in_bf16_out(card):
    """The residual block's use: float32 convolution output, bf16 result."""
    x = torch.randn((2, 8, 8, 64), device="cuda", generator=card) * 4
    out = torch.empty(x.shape, device="cuda", dtype=torch.bfloat16)
    IN.launch(x, None, out, 1e-5, "relu")
    torch.cuda.synchronize()
    ref = IN.instance_norm_act_plain(x, None, 1e-5, "relu", out_dtype=torch.bfloat16)
    torch.testing.assert_close(out.float(), ref.float(), **TOL[torch.bfloat16])


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("shape,cout", [((2, 8, 9, 64), 64), ((1, 17, 5, 32), 40),
                                        ((2, 16, 16, 256), 256), ((3, 11, 13, 96), 40),
                                        ((2, 9, 7, 96), 256), ((1, 64, 64, 256), 256),
                                        ((1, 6, 5, 512), 64)])
def test_conv3x3_reflect_matches_conv2d(card, shape, cout, dtype):
    """Tile edges: Cin 32 and 96 (a partial 64-channel K step), Cout 40 (a
    partial N tile), M not a multiple of the tile and W != 64, the trunk's
    batch-1 shape and a Cin whose halos do not fit a block; a second call
    is bitwise equal."""
    x = torch.randn(shape, device="cuda", generator=card).to(dtype)
    w = (0.05 * torch.randn((3, 3, shape[-1], cout), device="cuda", generator=card)).to(dtype)
    b = (0.1 * torch.randn((cout,), device="cuda", generator=card)).to(dtype)
    out, again = [torch.empty(shape[:3] + (cout,), device="cuda") for _ in range(2)]
    RB.conv3x3_reflect(x, w, b, out)
    RB.conv3x3_reflect(x, w, b, again)
    torch.cuda.synchronize()
    ref = RB._conv3x3_plain(x, w, b)  # float32 products of the same inputs
    torch.testing.assert_close(out, ref, atol=1e-4, rtol=1e-4)
    assert torch.equal(out, again)


@pytest.mark.parametrize("shape", [(2, 13, 11, 96), (1, 3, 70, 64)])
@pytest.mark.parametrize("tile", RB.CONV_TILES)
def test_conv3x3_reflect_every_plan_matches(card, tile, shape):
    """Every tile of the bf16 kernel on ragged patches and pixel ranges (H
    not a multiple of the patch rows, W not of its 64 columns, N*H*W not of
    the block's pixels), a partial chunk of input channels and a partial N
    tile; a second call is bitwise equal."""
    cout = 200
    x = torch.randn(shape, device="cuda", generator=card).to(torch.bfloat16)
    w = (0.05 * torch.randn((3, 3, shape[-1], cout), device="cuda", generator=card)).to(
        torch.bfloat16)
    b = (0.1 * torch.randn((cout,), device="cuda", generator=card)).to(torch.bfloat16)
    out, again = [torch.empty(shape[:3] + (cout,), device="cuda") for _ in range(2)]
    RB.conv3x3_reflect_planned(x, w, b, out, tile)
    RB.conv3x3_reflect_planned(x, w, b, again, tile)
    torch.cuda.synchronize()
    torch.testing.assert_close(out, RB._conv3x3_plain(x, w, b), atol=1e-4, rtol=1e-4)
    assert torch.equal(out, again)


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("shape", [(2, 16, 16, 64), (1, 9, 13, 32), (2, 16, 16, 48)])
def test_residual_block_matches_plain(card, shape, dtype):
    c = shape[-1]
    x = torch.randn(shape, device="cuda", generator=card).to(dtype)
    w1, w2 = [(0.05 * torch.randn((3, 3, c, c), device="cuda", generator=card)).to(dtype)
              for _ in range(2)]
    b1, b2 = [(0.01 * torch.randn((c,), device="cuda", generator=card)).to(dtype)
              for _ in range(2)]
    before = _build.launches.copy()
    y = RB.residual_block_fused(x, w1, b1, w2, b2)
    torch.cuda.synchronize()
    # One fused forward: two convolutions, each followed by its norm.
    assert _delta(before, "cg_conv3x3_reflect", "cg_instance_norm_act") == (2, 2)
    assert y.dtype == dtype
    torch.testing.assert_close(y.float(), RB.residual_block_plain(x, w1, b1, w2, b2).float(),
                               **RB_TOL[dtype])


def test_kernels_refuse_shapes_they_do_not_take(card):
    x = torch.zeros((1, 1, 8, 32), device="cuda")
    w = torch.zeros((3, 3, 32, 32), device="cuda")
    b = torch.zeros((32,), device="cuda")
    with pytest.raises(ValueError, match="H, W >= 2"):
        RB.residual_block_fused(x, w, b, w, b)


def test_generator_kernel_path_matches_plain_path(card, monkeypatch):
    """A small float32 generator: the blocks' seams on the kernels vs on the
    plain versions, same weights and batch."""
    G = define_Gen(3, 5, 8, "resnet_2blocks", head="none",
                   generator=torch.Generator().manual_seed(0))
    G = G.to("cuda", memory_format=torch.channels_last).eval()
    x = torch.rand((2, 3, 32, 32), device="cuda", generator=card) * 2 - 1
    x = x.contiguous(memory_format=torch.channels_last)
    before = _build.launches.copy()
    with torch.inference_mode():
        got = G(x)
    # 5 norms outside the trunk, 2 fused blocks of 2 convolutions and 2 norms.
    assert _delta(before, "cg_instance_norm_act", "cg_conv3x3_reflect") == (5 + 2 * 2, 2 * 2)
    monkeypatch.setattr(blocks, "instance_norm_act", IN.instance_norm_act_plain)
    monkeypatch.setattr(blocks, "residual_block_fused", RB.residual_block_plain)
    with torch.inference_mode():
        ref = G(x)
    torch.testing.assert_close(got, ref, atol=5e-5, rtol=1e-4)


# Backward tolerances, |kernel - plain| <= atol * max|plain| + rtol * |plain|:
# float32 sums of up to a few thousand products in another order; bf16
# outputs (dx of a bf16 input, dw cast to bf16) within about one bf16 ulp.
BWD_TOL = {torch.float32: dict(atol=1e-5, rtol=1e-4),
           torch.bfloat16: dict(atol=2 ** -8, rtol=2 ** -6)}


def _close(got, ref, tol):
    ref, got = ref.float(), got.float()
    allowed = tol["atol"] * ref.abs().max() + tol["rtol"] * ref.abs()
    assert torch.isfinite(got).all()
    assert bool(((got - ref).abs() <= allowed).all()), float((got - ref).abs().max())


@pytest.mark.parametrize("x_dtype,dy_dtype", [(torch.float32, torch.float32),
                                              (torch.bfloat16, torch.bfloat16),
                                              (torch.float32, torch.bfloat16)])
@pytest.mark.parametrize("act", ["none", "relu", "leaky"])
@pytest.mark.parametrize("shape", [(2, 16, 12, 64), (1, 5, 7, 40), (3, 33, 31, 96),
                                   (1, 3, 5, 64)])
def test_instance_norm_bwd_matches_plain(card, shape, act, x_dtype, dy_dtype):
    x = (torch.randn(shape, device="cuda", generator=card) * 3 + 1).to(x_dtype)
    dy = torch.randn(shape, device="cuda", generator=card).to(dy_dtype)
    mean, rstd = IN.instance_norm_stats_plain(x)
    dx = torch.empty_like(x)
    IN.launch_bwd(x, dy, mean, rstd, dx, act)
    torch.cuda.synchronize()
    _close(dx, IN.instance_norm_act_bwd_plain(x, dy, mean, rstd, act), BWD_TOL[x_dtype])


def test_instance_norm_forward_returns_its_statistics(card):
    x = torch.randn((2, 9, 7, 64), device="cuda", generator=card) * 2 + 3
    mean, rstd = IN.launch(x, None, None, 1e-5, "none")
    ref_mean, ref_rstd = IN.instance_norm_stats_plain(x)
    torch.testing.assert_close(mean, ref_mean, atol=1e-5, rtol=1e-5)
    torch.testing.assert_close(rstd, ref_rstd, atol=1e-5, rtol=1e-5)


@pytest.fixture(scope="module")
def built_and_launched():
    """Every kernel built and launched once outside the profiler, before the
    file's first profiler session: in a process that had just built the
    kernels itself (nvcc at first use), the profiler sessions of the
    one-launch tests came back with no device kernel at all. A bf16 fused
    and a chunked block, forward and backward, launch every kernel: the
    instance norm's forward and VJP (the fused block's writing its dx in
    bf16 parts), the forward convolution, the input and weight gradients
    (the fused block's reading its input through reflect indexing), the
    chunked block's bf16 split and the chunked norms."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device: the kernels have no CPU mode")
    _build.build_all()
    g = torch.Generator(device="cuda").manual_seed(1)
    c = 64
    x = torch.randn((2, 16, 16, c), device="cuda", generator=g).bfloat16().requires_grad_()
    w1, w2 = [(0.05 * torch.randn((3, 3, c, c), device="cuda", generator=g)).bfloat16()
              .requires_grad_() for _ in range(2)]
    b = torch.zeros((c,), device="cuda", dtype=torch.bfloat16, requires_grad=True)
    for y in (RB.residual_block_fused(x, w1, b, w2, b),
              RC.residual_block_chunked(x, w1, b, w2, b, 1e-5, 4)):
        y.float().sum().backward()
    torch.cuda.synchronize()


def _device_kernels(fn) -> list:
    """Names of the device kernels that ``fn`` launches (torch.profiler).
    The first session of a process can come back without device events
    (CUPTI starts lazily), so a first one runs unread; a later one did too
    on an H100, so sessions repeat, at most four more, until one reports
    the device's kernels."""
    names = []
    for i in range(5):
        with torch.profiler.profile(activities=[torch.profiler.ProfilerActivity.CUDA]) as prof:
            fn()
            torch.cuda.synchronize()
        names = [e.name for e in prof.events()
                 if e.device_type == torch.autograd.DeviceType.CUDA]
        if i and names:
            break
    return names


def _allocations(fn) -> int:
    """torch allocations that ``fn`` makes on the card."""
    before = torch.cuda.memory_stats()["allocation.all.allocated"]
    fn()
    return torch.cuda.memory_stats()["allocation.all.allocated"] - before


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_instance_norm_is_one_launch_and_allocates_only_its_outputs(card, dtype,
                                                                   built_and_launched):
    """Forward and VJP: one kernel each; the forward allocates its (2, N, C)
    statistics (and y through the Function), the VJP nothing but dx."""
    x = torch.randn((2, 64, 64, 64), device="cuda", generator=card).to(dtype)
    dy = torch.randn(x.shape, device="cuda", generator=card).to(dtype)
    y, dx = torch.empty_like(x), torch.empty_like(x)
    mean, rstd = IN.launch(x, None, y, 1e-5, "relu")  # builds; grows the scratch
    IN.launch_bwd(x, dy, mean, rstd, dx, "relu")
    torch.cuda.synchronize()
    fwd = _device_kernels(lambda: IN.launch(x, None, y, 1e-5, "relu"))
    bwd = _device_kernels(lambda: IN.launch_bwd(x, dy, mean, rstd, dx, "relu"))
    assert len(fwd) == 1 and "in_fwd" in fwd[0], fwd
    assert len(bwd) == 1 and "in_bwd" in bwd[0], bwd
    assert _allocations(lambda: IN.launch(x, None, y, 1e-5, "relu")) == 1
    assert _allocations(lambda: IN.launch_bwd(x, dy, mean, rstd, dx, "relu")) == 0
    with torch.no_grad():
        assert _allocations(lambda: IN.instance_norm_act(x, None, 1e-5, "relu")) == 2


@pytest.mark.parametrize("x_dtype,dy_dtype", [(torch.float32, torch.float32),
                                              (torch.bfloat16, torch.bfloat16),
                                              (torch.float32, torch.bfloat16),
                                              (torch.bfloat16, torch.float32)])
def test_instance_norm_second_call_and_batching_are_bitwise(card, x_dtype, dy_dtype):
    """A second call is bitwise equal, and sample 3 of a batch of 8 equals
    the same sample alone, bitwise (the tiling never sees the batch), for
    the forward (y and statistics) and the VJP."""
    x = (torch.randn((8, 40, 24, 96), device="cuda", generator=card) * 2 + 1).to(x_dtype)
    dy = torch.randn(x.shape, device="cuda", generator=card).to(dy_dtype)
    skip = torch.randn(x.shape, device="cuda", generator=card).to(dy_dtype)

    def run(x_, dy_, skip_):
        y = torch.empty_like(skip_)
        mean, rstd = IN.launch(x_, skip_, y, 1e-5, "leaky")
        dx = torch.empty_like(x_)
        IN.launch_bwd(x_, dy_, mean, rstd, dx, "leaky")
        return y, mean, rstd, dx

    first, again = run(x, dy, skip), run(x, dy, skip)
    alone = run(*(t[3:4].clone() for t in (x, dy, skip)))
    torch.cuda.synchronize()
    assert all(torch.equal(a, b) for a, b in zip(first, again))
    assert all(torch.equal(a[3:4], b) for a, b in zip(first, alone))


@pytest.mark.parametrize("shape,dtype", [((2, 256, 256, 64), torch.bfloat16),
                                         ((2, 256, 256, 64), torch.float32),
                                         ((8, 256, 256, 64), torch.bfloat16)])
def test_instance_norm_full_size_planes_match_plain(card, shape, dtype):
    """The stem planes: 16.8 MB in bf16 and 33.5 MB in float32 at the
    train batch (both fit the 50 MB L2), and serving's 67 MB at batch 8
    (it does not)."""
    x = (torch.randn(shape, device="cuda", generator=card) * 2 + 0.5).to(dtype)
    dy = torch.randn(shape, device="cuda", generator=card).to(dtype)
    y = torch.empty_like(x)
    mean, rstd = IN.launch(x, None, y, 1e-5, "relu")
    dx = torch.empty_like(x)
    IN.launch_bwd(x, dy, mean, rstd, dx, "relu")
    torch.cuda.synchronize()
    torch.testing.assert_close(y.float(), IN.instance_norm_act_plain(x, None, 1e-5, "relu")
                               .float(), **TOL[dtype])
    pm, pr = IN.instance_norm_stats_plain(x)
    torch.testing.assert_close(mean, pm, atol=1e-5, rtol=1e-5)
    torch.testing.assert_close(rstd, pr, atol=1e-5, rtol=1e-5)
    _close(dx, IN.instance_norm_act_bwd_plain(x, dy, mean, rstd, "relu"), BWD_TOL[dtype])


# (operand type, output type): float32 throughout (three bf16 passes), bf16
# throughout, and the main path's mix, bf16 activations and weights with a
# float32 result, held at the float32 bar (two passes over the float32
# cotangent's bf16 parts).
GRAD_TYPES = [(torch.float32, torch.float32), (torch.bfloat16, torch.bfloat16),
              (torch.bfloat16, torch.float32)]


@pytest.mark.parametrize("dtype,out_dtype", GRAD_TYPES)
@pytest.mark.parametrize("shape,cout", [((2, 8, 9, 64), 64), ((1, 17, 5, 32), 96),
                                        ((2, 2, 3, 32), 32), ((2, 7, 9, 32), 96),
                                        ((3, 5, 70, 96), 64),
                                        ((1, 64, 64, 256), 256), ((2, 64, 64, 256), 256),
                                        ((8, 64, 64, 256), 256), ((16, 64, 64, 256), 256)])
def test_conv3x3_grads_match_plain(card, shape, cout, dtype, out_dtype):
    """Ragged tile edges (Cin 32, Cout 96, odd H and W, a padded row longer
    than a tile), the trunk shape at batch 1 and 2 and at the train cells'
    8 and 16 rows; dx and dw twice, bitwise equal (one writer an output, no
    atomics); dx on the plan's tile (a float32 weight's on the mma.sync
    tile), counted under it."""
    cin = shape[-1]
    x = torch.randn(shape, device="cuda", generator=card).to(dtype)
    w = (0.05 * torch.randn((3, 3, cin, cout), device="cuda", generator=card)).to(dtype)
    g = torch.randn(shape[:3] + (cout,), device="cuda", generator=card)
    add = torch.randn(shape, device="cuda", generator=card).to(out_dtype)
    gp = CD.bf16_parts(g, CD.parts(torch.float32, dtype))
    dx, again = (torch.empty(shape, device="cuda", dtype=out_dtype) for _ in range(2))
    before = RB.dgrad_tiles.copy()
    RB.conv3x3_reflect_dgrad(gp, w, dx, add=add)
    RB.conv3x3_reflect_dgrad(gp, w, again, add=add)
    dw = RB.conv3x3_reflect_wgrad(x, gp, out_dtype)
    torch.cuda.synchronize()
    _close(dx, add.float() + RB.conv3x3_reflect_dgrad_plain(g, w), BWD_TOL[out_dtype])
    _close(dw, RB.conv3x3_reflect_wgrad_plain(x, g), BWD_TOL[out_dtype])
    assert torch.equal(dx, again)
    assert torch.equal(dw, RB.conv3x3_reflect_wgrad(x, gp, out_dtype))  # fixed order
    tile = RB.dgrad_plan(*shape, cout) if dtype == torch.bfloat16 else RB.DGRAD_SYNC
    assert RB.dgrad_tiles - before == {tile: 2}


def test_gradient_wrappers_raise_on_shapes_the_tiles_refuse(card):
    """Shapes the tensor-core tiles do not take raise before any launch, on
    the card too: no fallback to another route."""
    before = dict(_build.launches)
    with pytest.raises(ValueError, match="contiguous"):
        CD.conv_dw(torch.zeros((1, 6, 6, 36), device="cuda"),
                   torch.zeros((1, 4, 24, 4), device="cuda").transpose(2, 3))
    with pytest.raises(ValueError, match="Cin % 32"):
        RB.conv3x3_reflect_wgrad(torch.zeros((1, 4, 4, 36), device="cuda"),
                                 torch.zeros((3, 1, 4, 4, 32), device="cuda",
                                             dtype=torch.bfloat16))
    with pytest.raises(ValueError, match="Cout % 32"):
        RB.conv3x3_reflect_dgrad(torch.zeros((3, 1, 4, 4, 48), device="cuda",
                                             dtype=torch.bfloat16),
                                 torch.zeros((3, 3, 32, 48), device="cuda"),
                                 torch.zeros((1, 4, 4, 32), device="cuda"))
    with pytest.raises(ValueError, match="g_parts"):
        RB.conv3x3_reflect_dgrad(torch.zeros((1, 4, 4, 32), device="cuda"),
                                 torch.zeros((3, 3, 32, 32), device="cuda"),
                                 torch.zeros((1, 4, 4, 32), device="cuda"))
    assert dict(_build.launches) == before


def _hold_fused_block(x, w1, b1, w2, b2, dy, y, got, dtype):
    """The fused block (#3-#5) held as the chunked block is: the kernel
    forward's y and residuals against the plain forward's (y, u, a, s at
    RB_TOL, the four statistics at 1e-4), and the Function's y; the
    Function's gradients ``got`` against the plain VJP from the kernel
    forward's own residuals (one relu mask on both sides) at BWD_TOL, bias
    gradients exactly zero; a second backward from those residuals bitwise
    the first (fixed summation orders)."""
    c = x.shape[-1]
    yk, saved = RB._fwd_cuda(x, w1, b1, w2, b2, 1e-5, True)
    r = RB.Residuals(*(t[..., :c] for t in saved[3:]))  # a narrow trunk's, cut back
    again = RB._bwd_cuda(dy, *saved)
    ry, rr = RB.residual_block_fwd_plain(x, w1, b1, w2, b2)
    torch.cuda.synchronize()
    for g_, r_ in ((yk, ry), (y.detach(), ry), (r.u, rr.u), (r.a, rr.a), (r.s, rr.s)):
        torch.testing.assert_close(g_.float(), r_.float(), **RB_TOL[dtype])
    torch.testing.assert_close(torch.stack(r[3:]), torch.stack(rr[3:]), atol=1e-4, rtol=1e-4)
    ref = RB.residual_block_bwd_saved_plain(x, dy, w1, w2, r)
    for g_, r_ in zip((got[0], got[1], got[3]), ref):
        _close(g_, r_, BWD_TOL[dtype])
    assert torch.count_nonzero(got[2]) == 0 and torch.count_nonzero(got[4]) == 0
    assert all(torch.equal(a_, g_) for a_, g_ in zip(again, (got[0], got[1], got[3])))


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("shape", [(2, 16, 16, 64), (1, 9, 13, 32), (2, 16, 16, 48)])
def test_residual_block_bwd_matches_plain(card, shape, dtype):
    c = shape[-1]
    x = torch.randn(shape, device="cuda", generator=card).to(dtype)
    w1, w2 = [(0.05 * torch.randn((3, 3, c, c), device="cuda", generator=card)).to(dtype)
              for _ in range(2)]
    b1, b2 = [(0.01 * torch.randn((c,), device="cuda", generator=card)).to(dtype)
              for _ in range(2)]
    dy = torch.randn(shape, device="cuda", generator=card).to(dtype)
    leaves = [t.clone().requires_grad_() for t in (x, w1, b1, w2, b2)]
    before = _build.launches.copy()
    y = RB.residual_block_fused(*leaves)
    assert y.grad_fn is not None
    got = torch.autograd.grad(y, leaves, dy)
    torch.cuda.synchronize()
    # One VJP: the dx chain's 2 input gradients (#4), 2 weight gradients (#5);
    # no operand split into bf16 parts but a float32 block's w1, w2, x, a.
    assert _delta(before, "cg_conv3x3_reflect_dgrad", "cg_conv_dw") == (2, 2)
    assert _delta(before, "cg_bf16_parts") == (0 if dtype == torch.bfloat16 else 4,)
    # The forward's 2 convolutions and 2 norms, and none in the backward: it
    # starts from the residuals the forward kept.
    assert _delta(before, "cg_conv3x3_reflect", "cg_instance_norm_act") == (2, 2)
    _hold_fused_block(x, w1, b1, w2, b2, dy, y, got, dtype)


def _bits(t: torch.Tensor) -> torch.Tensor:
    return t.view(torch.int16 if t.element_size() == 2 else torch.int32)


@pytest.mark.parametrize("parts", [2, 3])
@pytest.mark.parametrize("dy_dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("act", ["none", "relu"])
@pytest.mark.parametrize("shape", [(8, 64, 64, 256), (16, 64, 64, 256), (3, 13, 7, 64)])
def test_norm_vjp_parts_are_the_split_of_its_float32_dx(card, shape, act, dy_dtype, parts):
    """The norm VJP of a float32 x written as bf16 parts (the fused block's
    ds and du: two parts for a bf16 block, three for a float32 one) is
    bitwise cg_bf16_parts's split of the same VJP written in float32, at
    the trunk's 8 and 16 rows and on a small non-square plane: the same
    d values, rounded as the split rounds them. One kernel, in_bwd."""
    x = torch.randn(shape, device="cuda", generator=card) * 3 + 1
    dy = torch.randn(shape, device="cuda", generator=card).to(dy_dtype)
    mean, rstd = IN.instance_norm_stats_plain(x)
    dx = torch.empty_like(x)
    IN.launch_bwd(x, dy, mean, rstd, dx, act)
    dxp = torch.empty((parts, *shape), device="cuda", dtype=torch.bfloat16)
    launches, forms = _build.launches.copy(), _build.forms.copy()
    IN.launch_bwd(x, dy, mean, rstd, dxp, act)
    torch.cuda.synchronize()
    assert _delta(launches, "cg_instance_norm_act_bwd", "cg_bf16_parts") == (1, 0)
    assert _build.forms - forms == {("in_bwd", "parts"): 1}
    assert torch.equal(_bits(dxp), _bits(CD.bf16_parts(dx, parts)))


@pytest.mark.parametrize("dtype", [torch.bfloat16, torch.float32])
@pytest.mark.parametrize("shape,cout", [((1, 64, 64, 256), 256), ((2, 64, 64, 256), 256),
                                        ((8, 64, 64, 256), 256), ((16, 64, 64, 256), 256),
                                        ((3, 13, 7, 64), 96)])
def test_wgrad_reflect_read_is_the_padded_copy_bitwise(card, shape, cout, dtype):
    """The weight gradient reading its unpadded input through reflect
    indexing (wgrad_wgmma<1, 2> on bf16 x, <3, 3> on a float32 x's parts)
    is bitwise the same kernel on the reflect-padded copy that
    cg_bf16_parts makes: at 1, 2, 8 and 16 rows of the trunk shape, and on
    an H != W plane of 273 pixels, no multiple of the 32-pixel step."""
    x = torch.randn(shape, device="cuda", generator=card).to(dtype)
    g = torch.randn(shape[:3] + (cout,), device="cuda", generator=card)
    na, ng = CD.parts(dtype, torch.float32), CD.parts(torch.float32, dtype)
    gp, dims = CD.bf16_parts(g, ng), (*shape, cout)
    forms = _build.forms.copy()
    reflect = CD.launch_wgrad(x if na == 1 else CD.bf16_parts(x, na), na, gp, ng, dims, 3)
    padded = CD.launch_wgrad(CD.bf16_parts(x, na, pad=1), na, gp, ng, dims, 3)
    torch.cuda.synchronize()
    assert _build.forms - forms == {("wgrad", "reflect"): 1, ("wgrad", "padded"): 1}
    assert torch.equal(_bits(reflect), _bits(padded))


def _staged_block_bwd(x, dy, w1, w2, r):
    """The fused block's backward with its operands staged through
    cg_bf16_parts: the norm VJPs write float32 ds and du, each split into
    its bf16 parts, and x and a reflect-padded into copies for the weight
    gradients; the same kernels otherwise."""
    f32 = dict(dtype=torch.float32, device=x.device)
    ng, na = CD.parts(torch.float32, x.dtype), CD.parts(x.dtype, torch.float32)
    ds, da, du = (torch.empty(x.shape, **f32) for _ in range(3))
    IN.launch_bwd(r.s, dy, r.mean2, r.rstd2, ds, "none")
    ds_p = CD.bf16_parts(ds, ng)
    RB.conv3x3_reflect_dgrad(ds_p, w2, da)
    IN.launch_bwd(r.u, da, r.mean1, r.rstd1, du, "relu")
    du_p = CD.bf16_parts(du, ng)
    dx = torch.empty_like(r.a)
    RB.conv3x3_reflect_dgrad(du_p, w1, dx, add=dy)
    dims = (*x.shape, w1.shape[-1])
    return (dx, *(CD.launch_wgrad(CD.bf16_parts(t, na, pad=1), na, g, ng, dims, 3, w1.dtype)
                  for t, g in ((x, du_p), (r.a, ds_p))))


@pytest.mark.parametrize("shape,dtype", [((2, 64, 64, 256), torch.bfloat16),
                                         ((8, 64, 64, 256), torch.bfloat16),
                                         ((1, 9, 13, 32), torch.bfloat16),
                                         ((1, 9, 13, 32), torch.float32)])
def test_fused_block_backward_stages_no_operand_and_matches_the_staged_route(card, shape,
                                                                            dtype):
    """The fused block's backward (dx, dw1, dw2) is bitwise the staged
    route's from the same residuals; it makes 2 parts-writing norm VJPs and
    2 reflect reads, and splits nothing into bf16 parts but a float32
    block's w1, w2, x and a, which no tensor core takes as float32."""
    c = shape[-1]
    x, dy = (torch.randn(shape, device="cuda", generator=card).to(dtype) for _ in range(2))
    w1, w2 = [(0.05 * torch.randn((3, 3, c, c), device="cuda", generator=card)).to(dtype)
              for _ in range(2)]
    b1, b2 = [(0.01 * torch.randn((c,), device="cuda", generator=card)).to(dtype)
              for _ in range(2)]
    _, saved = RB._fwd_cuda(x, w1, b1, w2, b2, 1e-5, True)
    launches, forms = _build.launches.copy(), _build.forms.copy()
    got = RB._bwd_cuda(dy, *saved)
    torch.cuda.synchronize()
    assert _delta(launches, "cg_bf16_parts") == (0 if dtype == torch.bfloat16 else 4,)
    assert _build.forms - forms == {("in_bwd", "parts"): 2, ("wgrad", "reflect"): 2}
    ref = _staged_block_bwd(x, dy, w1, w2, RB.Residuals(*saved[3:]))
    torch.cuda.synchronize()
    for name, g_, r_ in zip(("dx", "dw1", "dw2"), got, ref):
        assert torch.equal(_bits(g_), _bits(r_)), name


def test_fused_block_backward_kernels_are_in_bwd_and_wgrad_wgmma(card, built_and_launched):
    """On the device: the fused block's parts-writing norm VJP is one
    kernel, in_bwd, and its reflect-reading weight gradient is wgrad_wgmma
    and its fixed-order reduction, dw_reduce: no bf16_parts."""
    shape = (2, 16, 16, 64)
    x = torch.randn(shape, device="cuda", generator=card) * 3 + 1
    a = torch.randn(shape, device="cuda", generator=card).bfloat16()
    mean, rstd = IN.instance_norm_stats_plain(x)
    dxp = torch.empty((2, *shape), device="cuda", dtype=torch.bfloat16)
    IN.launch_bwd(x, a, mean, rstd, dxp, "relu")
    RB.conv3x3_reflect_wgrad(a, dxp)
    torch.cuda.synchronize()
    vjp = _device_kernels(lambda: IN.launch_bwd(x, a, mean, rstd, dxp, "relu"))
    wgrad = _device_kernels(lambda: RB.conv3x3_reflect_wgrad(a, dxp))
    assert len(vjp) == 1 and "in_bwd" in vjp[0], vjp
    assert len(wgrad) == 2 and "wgrad_wgmma" in wgrad[0] and "dw_reduce" in wgrad[1], wgrad


@pytest.mark.parametrize("rows", [8, 16])
def test_residual_block_vjp_at_the_trunk_shapes_is_repeatable(card, rows):
    """At the train cells' trunk shapes (8 and 16 rows of 64x64x256, bf16)
    a second backward of the Function's graph, and the backward from a
    second kernel forward's residuals, are bitwise the first: the same
    kernels on the same inputs, with no split-K and fixed summation orders,
    and the backward writes no residual."""
    shape, c = (rows, 64, 64, 256), 256
    x, dy = (torch.randn(shape, device="cuda", generator=card).bfloat16() for _ in range(2))
    w1, w2 = [(0.02 * torch.randn((3, 3, c, c), device="cuda", generator=card)).bfloat16()
              for _ in range(2)]
    b1, b2 = [(0.01 * torch.randn((c,), device="cuda", generator=card)).bfloat16()
              for _ in range(2)]
    leaves = [t.clone().requires_grad_() for t in (x, w1, b1, w2, b2)]
    y = RB.residual_block_fused(*leaves)
    got = torch.autograd.grad(y, leaves, dy, retain_graph=True)
    again = torch.autograd.grad(y, leaves, dy)
    fresh = RB._bwd_cuda(dy, *RB._fwd_cuda(x, w1, b1, w2, b2, 1e-5, True)[1])
    torch.cuda.synchronize()
    assert all(torch.equal(a_, g_) for a_, g_ in zip(again, got))
    assert all(torch.equal(f_, g_) for f_, g_ in zip(fresh, (got[0], got[1], got[3])))


@pytest.mark.parametrize("grad,allocations", [(False, 5), (True, 6)])
def test_residual_block_forward_allocates_s_only_when_it_keeps_it(card, grad, allocations):
    """A forward under ``torch.inference_mode`` allocates u, a, y and the
    two norms' statistics, as before residuals were kept (s overwrites u);
    a forward that keeps its residuals allocates s too."""
    shape, c = (2, 16, 16, 64), 64
    x = torch.randn(shape, device="cuda", generator=card).bfloat16()
    w, b = (0.05 * torch.randn((3, 3, c, c), device="cuda", generator=card)).bfloat16(), \
        torch.zeros((c,), device="cuda", dtype=torch.bfloat16)
    args = [t.clone().requires_grad_(grad) for t in (x, w, b, w, b)]
    with torch.inference_mode(not grad):
        RB.residual_block_fused(*args)  # builds; grows the scratch
        torch.cuda.synchronize()
        assert _allocations(lambda: RB.residual_block_fused(*args)) == allocations


def test_kernel_outputs_carry_grad_fn(card):
    """The slice-1 fault: kernel outputs were detached. Now every seam's
    output has a grad_fn when an input requires grad, and the gradient
    reaches the float32 parameters of a small generator."""
    x = torch.randn((1, 8, 8, 32), device="cuda", generator=card, requires_grad=True)
    assert IN.instance_norm_act(x, None, 1e-5, "relu").grad_fn is not None
    G = define_Gen(3, 5, 8, "resnet_2blocks", head="none",
                   generator=torch.Generator().manual_seed(0))
    G = G.to("cuda", memory_format=torch.channels_last)
    img = torch.rand((1, 3, 32, 32), device="cuda", generator=card)
    G(img.contiguous(memory_format=torch.channels_last)).square().mean().backward()
    for name, p in G.named_parameters():
        assert p.grad is not None and torch.isfinite(p.grad).all(), name
        if name.endswith("weight"):
            assert torch.count_nonzero(p.grad) > 0, name


def test_small_train_step_kernel_path_matches_plain_path(card, monkeypatch):
    """Two float32 steps of a small trainer, the seams on the kernels and
    on the Function over the plain versions, from the same weights."""
    cfg = Config(gen_net="resnet_2blocks", ngf=8, ndf=8, crop_height=32, crop_width=32,
                 bf16=False, pool_size=0)
    r = np.random.default_rng(0)
    batch = {"lab_image": r.uniform(-1, 1, (1, 32, 32, 3)).astype(np.float32),
             "unlab_image": r.uniform(-1, 1, (1, 32, 32, 3)).astype(np.float32),
             "lab_label": r.integers(0, 5, (1, 32, 32))}
    batch = {k: torch.from_numpy(v).cuda() for k, v in batch.items()}

    def run():
        t = CycleGANTrainer(cfg, 5, 3, 1000, device="cuda")
        st = t.init_state(torch.Generator().manual_seed(0))
        return [{k: float(v) for k, v in t.train_step(st, batch)[1].items()}
                for _ in range(2)]

    before = _build.launches.copy()
    got = run()
    # A step: 27 norm VJPs outside the trunk and 6 fused block VJPs (3
    # generator applies x 2 blocks), each with 2 norm VJPs and 2 weight
    # gradients.
    assert _delta(before, "cg_instance_norm_act_bwd", "cg_conv_dw") == \
        (2 * (27 + 2 * 6), 2 * 2 * 6)
    monkeypatch.setattr(blocks, "instance_norm_act", IN.instance_norm_act_reference)
    monkeypatch.setattr(blocks, "residual_block_fused", RB.residual_block_reference)
    ref = run()
    for g_, r_ in zip(got, ref):
        for k in g_:
            np.testing.assert_allclose(g_[k], r_[k], rtol=1e-4, atol=1e-5, err_msg=k)


# The chunked block (TPU kernels #6, #7) and the dropout trunk's weight
# gradient (#8). Chunked forward tolerances are those of the fused block
# (the same convolutions; statistics by sum and sum of squares); the VJP
# runs the slice-2 gradient kernels on float32 cotangents.
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("shape,hc", [((2, 16, 16, 64), 4), ((1, 12, 9, 32), 12),
                                      ((1, 8, 8, 32), 1), ((2, 16, 16, 48), 4),
                                      ((1, 8, 320, 32), 8)])
def test_chunked_block_matches_plain(card, shape, hc, dtype):
    """hc 4 (a cluster of 4 CTAs), hc 1 (eight one-row chunks, a cluster of
    8), 12 (one chunk), C = 48 (zero-filled to 64), and a chunk whose tile
    does not fit a CTA's shared memory (read again from L2)."""
    c = shape[-1]
    x = (torch.randn(shape, device="cuda", generator=card) + 0.5).to(dtype)
    w1, w2 = [(0.05 * torch.randn((3, 3, c, c), device="cuda", generator=card)).to(dtype)
              for _ in range(2)]
    b1, b2 = [(0.01 * torch.randn((c,), device="cuda", generator=card)).to(dtype)
              for _ in range(2)]
    dy = torch.randn(shape, device="cuda", generator=card).to(dtype)
    leaves = [t.clone().requires_grad_() for t in (x, w1, b1, w2, b2)]
    before = _build.launches.copy()
    y, vhat, s, stats = RC._fwd_cuda(x, w1, b1, w2, b2, 1e-5, hc)
    out = RC.residual_block_chunked(*leaves, 1e-5, hc)
    got = torch.autograd.grad(out, leaves, dy)
    torch.cuda.synchronize()
    # Two chunked forwards (2 norms each), one VJP (2 norm VJPs), and no
    # fused block (whose norms are cg_instance_norm_act).
    assert _delta(before, "cg_chunked_in_fwd", "cg_chunked_in_vjp",
                  "cg_instance_norm_act") == (4, 2, 0)
    ry, rvhat, rs, rstats = RC.residual_block_chunked_plain(x, w1, b1, w2, b2, 1e-5, hc)
    for g_, r_ in ((y, ry), (out, ry), (vhat, rvhat), (s, rs)):
        torch.testing.assert_close(g_.float(), r_.float(), **RB_TOL[dtype])
    torch.testing.assert_close(stats, rstats, atol=1e-4, rtol=1e-4)
    ref = RC.residual_block_chunked_bwd_plain(x, dy, vhat, s, stats, w1, w2, hc)
    for g_, r_ in zip((got[0], got[1], got[3]), ref):
        _close(g_, r_, BWD_TOL[dtype] if dtype == torch.float32 else
               dict(atol=2 ** -7, rtol=2 ** -5))
    assert torch.count_nonzero(got[2]) == 0 and torch.count_nonzero(got[4]) == 0
    # Fixed summation orders: a second backward is bitwise equal.
    again = RC._bwd_cuda(x, dy, vhat, s, stats, w1, w2, hc)
    assert all(torch.equal(a, b) for a, b in zip(again, (got[0], got[1], got[3])))


@pytest.mark.parametrize("c,padded", [(256, False), (48, True)])
def test_blocks_zero_fill_only_narrow_trunks(card, monkeypatch, c, padded):
    """Both blocks, forward and backward: a trunk of 48 channels runs
    zero-filled to 64; the full width (256) makes no padding copy."""
    calls = []

    def fill(t, cp, dims=1):
        calls.append(t.shape)
        return F.pad(t, (0, cp - t.shape[-1]) * dims)

    monkeypatch.setattr(RB, "zero_fill", fill)
    shape = (1, 8, 8, c)
    x = torch.randn(shape, device="cuda", generator=card).to(torch.bfloat16)
    w = (0.05 * torch.randn((3, 3, c, c), device="cuda", generator=card)).to(torch.bfloat16)
    b = torch.zeros((c,), device="cuda", dtype=torch.bfloat16)
    leaves = [t.clone().requires_grad_() for t in (x, w, b, w, b)]
    for block in (RB.residual_block_fused, lambda *a: RC.residual_block_chunked(*a, 1e-5, 4)):
        y = block(*leaves)
        got = torch.autograd.grad(y, leaves, torch.ones_like(y))
        assert y.shape == shape and got[0].shape == shape and got[1].shape == w.shape
    torch.cuda.synchronize()
    assert bool(calls) == padded


def test_chunked_refuses_h_not_divisible_by_hc(card):
    x = torch.zeros((1, 12, 8, 32), device="cuda")
    w = torch.zeros((3, 3, 32, 32), device="cuda")
    b = torch.zeros((32,), device="cuda")
    with pytest.raises(ValueError, match="H % hc"):
        RC.residual_block_chunked(x, w, b, w, b, 1e-5, 8)


def _chunked_norm_calls(card, shape, hc, dtype):
    """The four normalisation calls of the chunked block on seeded inputs
    (float32 u, s32, da; x, dy in ``dtype``), each a function that writes
    its outputs, in the order the block makes them; and the outputs."""
    f32 = dict(device="cuda", dtype=torch.float32)
    u, s32, da = (torch.randn(shape, device="cuda", generator=card) * 2 + 0.5 for _ in range(3))
    x, dy = (torch.randn(shape, device="cuda", generator=card).to(dtype) for _ in range(2))
    stats = torch.empty((shape[0], 4, shape[-1]), **f32)
    vhat, a, s, y, dv, a2 = (torch.empty_like(x) for _ in range(6))
    ds, du = torch.empty(shape, **f32), torch.empty(shape, **f32)
    calls = [lambda: RC.in_fwd(u, stats, x, vhat, a, hc, 1e-5, 1),
             lambda: RC.in_fwd(s32, stats, x, s, y, hc, 1e-5, 2),
             lambda: RC.in_vjp(dy, s, stats, ds, hc, 2),
             lambda: RC.in_vjp(da, vhat, stats, du, hc, 1, dv=dv, a=a2)]
    return calls, (stats, vhat, a, s, y, ds, dv, a2, du), (u, s32, da, x, dy)


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_chunked_norms_are_one_launch_and_allocate_only_outputs(card, dtype,
                                                                built_and_launched):
    """Each normalisation call is one kernel and allocates nothing; the
    block's forward allocates its outputs and the convolutions' float32
    output, its VJP its outputs and what a convolution reads (ds, da, du,
    dv, a, the cotangents' bf16 parts; float32 weights also split into
    parts for the input gradients, a float32 x and a into parts for the
    weight gradients, which read them unpadded): no partials, no means."""
    shape, hc = (2, 16, 16, 64), 4
    calls, _, _ = _chunked_norm_calls(card, shape, hc, dtype)
    for f in calls:  # builds
        f()
    torch.cuda.synchronize()
    for f, name in zip(calls, ("chunked_in_fwd", "chunked_in_fwd", "chunked_in_vjp",
                               "chunked_in_vjp")):
        kernels = _device_kernels(f)
        assert len(kernels) == 1 and name in kernels[0], kernels
        assert _allocations(f) == 0
    c = shape[-1]
    x, dy = (torch.randn(shape, device="cuda", generator=card).to(dtype) for _ in range(2))
    w1, w2 = [(0.05 * torch.randn((3, 3, c, c), device="cuda", generator=card)).to(dtype)
              for _ in range(2)]
    b = torch.zeros((c,), device="cuda", dtype=dtype)
    _, vhat, s, stats = RC._fwd_cuda(x, w1, b, w2, b, 1e-5, hc)
    RC._bwd_cuda(x, dy, vhat, s, stats, w1, w2, hc)
    torch.cuda.synchronize()
    assert _allocations(lambda: RC._fwd_cuda(x, w1, b, w2, b, 1e-5, hc)) == 6
    assert _allocations(lambda: RC._bwd_cuda(x, dy, vhat, s, stats, w1, w2, hc)) == \
        (10 if dtype == torch.bfloat16 else 14)


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("shape,hc", [((4, 16, 12, 64), 4), ((4, 16, 12, 64), 1),
                                      ((3, 8, 320, 32), 8)])
def test_chunked_norms_second_call_and_batching_are_bitwise(card, shape, hc, dtype):
    """A second call is bitwise equal, and sample 2 of the batch equals the
    same sample alone, bitwise, for all four calls (one cluster a sample
    and channel group: the layout never sees the batch); clusters of 4 and
    of 8 with two chunks a CTA, and tiles read again from L2."""
    calls, outs, ins = _chunked_norm_calls(card, shape, hc, dtype)
    for f in calls:
        f()
    first = [t.clone() for t in outs]
    for f in calls:
        f()
    torch.cuda.synchronize()
    assert all(torch.equal(a_, b_) for a_, b_ in zip(first, outs))
    u, s32, da, x, dy = (t[2:3].clone() for t in ins)
    stats, vhat, a, s, y, ds, dv, a2, du = (torch.empty_like(t[2:3]) for t in outs)
    RC.in_fwd(u, stats, x, vhat, a, hc, 1e-5, 1)
    RC.in_fwd(s32, stats, x, s, y, hc, 1e-5, 2)
    RC.in_vjp(dy, s, stats, ds, hc, 2)
    RC.in_vjp(da, vhat, stats, du, hc, 1, dv=dv, a=a2)
    torch.cuda.synchronize()
    alone = (stats, vhat, a, s, y, ds, dv, a2, du)
    assert all(torch.equal(a_[2:3], b_) for a_, b_ in zip(first, alone))


def test_chunked_norms_refuse_a_plan_they_did_not_make(card):
    """The C entry checks the layout it is given against the shapes."""
    calls, outs, ins = _chunked_norm_calls(card, (1, 16, 8, 32), 4, torch.bfloat16)
    stats, vhat, a = outs[:3]
    u, x = ins[0], ins[3]
    for cluster, per_cta, resident in ((3, 1, 1), (4, 2, 1), (4, 1, 0)):
        with pytest.raises(_build.KernelLaunchError):
            _build.call("resblock_chunked", "cg_chunked_in_fwd", u.data_ptr(),
                        stats.data_ptr(), x.data_ptr(), vhat.data_ptr(), a.data_ptr(),
                        1, 16, 8, 32, 4, cluster, per_cta, resident, 1e-5, 1, 1,
                        _build.stream_ptr(x))


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("xshape,cout,k", [((2, 10, 9, 128), 128, 3), ((3, 7, 6, 40), 24, 3),
                                           ((1, 5, 5, 8), 16, 1), ((1, 66, 66, 256), 256, 3),
                                           ((2, 66, 66, 256), 256, 3), ((1, 6, 7, 36), 20, 3),
                                           ((2, 10, 9, 132), 132, 3)])
def test_conv_dw_matches_plain_and_repeats_bitwise(card, xshape, cout, k, dtype):
    """Ragged tiles (Cin 40, Cout 24; a 1x1), channels zero-filled up to a
    multiple of 8 (36 and 20; 132, a trunk width the JAX rule routes here),
    the trunk shape at batch 1 and 2; one bf16 pass, or three over the bf16
    parts of float32 operands."""
    n, hp, wp, _ = xshape
    xp = torch.randn(xshape, device="cuda", generator=card).to(dtype)
    dy = torch.randn((n, hp - k + 1, wp - k + 1, cout), device="cuda", generator=card).to(dtype)
    before = _build.launches.copy()
    dw = CD.conv_dw(xp, dy, k)
    torch.cuda.synchronize()
    assert _delta(before, "cg_conv_dw") == (1,) and dw.dtype == torch.float32
    _close(dw, CD.conv_dw_plain(xp, dy, k), BWD_TOL[torch.float32])
    assert torch.equal(dw, CD.conv_dw(xp, dy, k))


def test_conv2d_valid_dw_fused_matches_reference(card):
    xp = torch.randn((2, 128, 10, 10), device="cuda", generator=card).to(torch.bfloat16)
    xp = xp.contiguous(memory_format=torch.channels_last).requires_grad_()
    w = (0.05 * torch.randn((128, 128, 3, 3), device="cuda", generator=card)).to(torch.bfloat16)
    w.requires_grad_()
    dy = torch.randn((2, 128, 8, 8), device="cuda", generator=card).to(torch.bfloat16)
    got = torch.autograd.grad(OF.conv2d_valid_dw_fused(xp, w), [xp, w], dy)
    ref = torch.autograd.grad(OF.conv2d_valid_dw_fused_reference(xp, w), [xp, w], dy)
    assert torch.equal(got[0], ref[0])
    _close(got[1], ref[1], BWD_TOL[torch.bfloat16])


# chip_smoke.py's bar for the float32 step-1 gradients, kernel path vs plain
# path: |g_kernel - g_plain| / |g_plain| per tensor (the step's gradient is
# ill-conditioned; plain vs plain differs by up to ~1e-3 of a tensor's norm
# on an H100, and a wrong gradient gives O(1)).
GRAD_TOL_F32 = 1e-2


def _step1_grads(t) -> dict:
    """The step-1 gradients the updates used, by ``net.parameter`` name."""
    return {f"{net_name}.{name}": p.grad.detach().clone()
            for net_name, net in zip(("G_i2l", "G_l2i", "D_img", "D_lab"), t.nets())
            for name, p in net.named_parameters()}


def _copy_state(dst, dst_st, src, src_st) -> None:
    """``src``'s parameters, Adam moments, schedules, generators and step
    count into ``dst`` (deep copies: Adam's own load would share the
    moments' tensors between the two trainers)."""
    for d, s_ in zip(dst.nets(), src.nets()):
        d.load_state_dict(s_.state_dict())
    for name in ("g_opt", "d_opt", "g_sched", "d_sched"):
        getattr(dst_st, name).load_state_dict(copy.deepcopy(getattr(src_st, name).state_dict()))
    dst_st.generator.set_state(src_st.generator.get_state())
    dst_st.dropout.set_state(src_st.dropout.get_state())
    dst_st.step = src_st.step


# The kernel path and the plain path may take another branch of an
# activation (relu's or leaky relu's) at an element whose normalised value
# lies within the convolutions' rounding of zero; such elements may be at
# most this share of them. float32 reorderings of 2,304-term sums differ
# by ~1e-6 relative, so an honest kernel flips ~1e-6 of a plane; a branch
# that is wrong by design flips far more.
RELU_FLIP_SHARE = 1e-4


def _act_branch(y, act):
    """Which branch of the norm's activation each element took, from its
    output (relu: y > 0; leaky: y >= 0; none: no branch)."""
    return None if act == "none" else (y.detach() > 0 if act == "relu" else y.detach() >= 0)


class _PlainINOnBranches(torch.autograd.Function):
    """The plain instance norm + activation, forward and VJP, with the
    activation's branch of every element given (``branch``, as
    _act_branch records it) instead of taken from its own normalised
    value."""

    @staticmethod
    def forward(ctx, x, skip, eps, act, branch):
        mean, rstd = IN.instance_norm_stats_plain(x, eps)
        xhat = (x.float() - mean[:, None, None]) * rstd[:, None, None]
        slope = torch.ones_like(xhat) if branch is None else \
            torch.where(branch, 1.0, 0.0 if act == "relu" else IN.LEAKY_SLOPE)
        ctx.save_for_backward(xhat, rstd, slope)
        y = xhat * slope
        return (y if skip is None else y + skip.float()).to(x.dtype)

    @staticmethod
    def backward(ctx, dy):
        xhat, rstd, slope = ctx.saved_tensors
        g = dy.float() * slope
        dx = rstd[:, None, None] * (g - g.mean((1, 2), keepdim=True)
                                    - xhat * (g * xhat).mean((1, 2), keepdim=True))
        return dx.to(dy.dtype), dy if ctx.needs_input_grad[1] else None, None, None, None


@pytest.mark.parametrize("path", ["chunked", "dropout"])
def test_small_train_step_paths_a_and_b_match_plain(card, monkeypatch, path):
    """Two float32 steps of a small trainer (ngf 32, so the trunk has 128
    channels and its convolutions route through conv_dw on the dropout
    path), the seams on the kernels and on the plain versions, each step
    from one state: step 1 from the same init, step 2 on both paths from
    the plain path's state after step 1 (parameters, Adam, schedules,
    generators). Adam's first update is about lr * sign(g), so a gradient
    element within rounding of zero whose sign differs between the paths
    moves its weight 2 lr apart, and a step 2 from each path's own state
    compares two different models. The losses of both steps at rtol 1e-3,
    atol 1e-4.

    The step-1 gradient of every weight and of every bias no instance norm
    follows is held at GRAD_TOL_F32 of its norm against the plain versions
    run on the kernel path's activation branches (every norm's relu or
    leaky branch of every element, as the kernel path took it). The step's
    gradient is discontinuous there: an element whose normalised value is
    within rounding of zero takes the other branch on the other path, and
    on the dropout path that moves G_l2i's gradient by 0.5-1.8% of its
    norm (the plain path with one norm's output moved by 1e-8 of its size
    moves it by 0.5%, and by 1e-6 not at all; tools/torch_step_probe.py
    --sensitivity). The branches that differ from the plain path's own are
    held apart, at most RELU_FLIP_SHARE of the elements. A bias an
    instance norm follows has a gradient that is zero in exact arithmetic:
    rounding noise, held finite."""
    if path == "chunked":
        monkeypatch.setenv("CYCLEGAN_TPU_RESBLOCK", "chunked")
        monkeypatch.setenv("CYCLEGAN_TPU_RESBLOCK_HC", "4")
    cfg = Config(gen_net="resnet_2blocks", ngf=32, ndf=8, crop_height=32, crop_width=32,
                 bf16=False, pool_size=0, use_dropout=path == "dropout")
    r = np.random.default_rng(0)
    batch = {"lab_image": r.uniform(-1, 1, (1, 32, 32, 3)).astype(np.float32),
             "unlab_image": r.uniform(-1, 1, (1, 32, 32, 3)).astype(np.float32),
             "lab_label": r.integers(0, 5, (1, 32, 32))}
    batch = {k: torch.from_numpy(v).cuda() for k, v in batch.items()}

    def losses(t, st):
        return {k: float(v) for k, v in t.train_step(st, batch)[1].items()}

    def trainer():
        t = CycleGANTrainer(cfg, 5, 3, 1000, device="cuda")
        return t, t.init_state(torch.Generator().manual_seed(0))

    def recording(norm, into):
        def seam(x, skip=None, eps=1e-5, act="none"):
            y = norm(x, skip, eps, act)
            into.append(_act_branch(y, act))
            return y
        return seam

    def plain_seams(m, norm):
        m.setattr(blocks, "instance_norm_act", norm)
        m.setattr(blocks, "residual_block_chunked", RC.residual_block_chunked_reference)
        m.setattr(OF, "conv2d_valid_dw_fused", OF.conv2d_valid_dw_fused_reference)

    (kt, ks), (pt, ps), (bt, bs) = trainer(), trainer(), trainer()
    k_branch, p_branch = [], []
    before = _build.launches.copy()
    with monkeypatch.context() as m:
        m.setattr(blocks, "instance_norm_act", recording(IN.instance_norm_act, k_branch))
        got = [losses(kt, ks)]
    g_kernel = _step1_grads(kt)
    with monkeypatch.context() as m:
        branches = iter(k_branch)
        plain_seams(m, lambda x, skip=None, eps=1e-5, act="none": _PlainINOnBranches.apply(
            x, skip, eps, act, next(branches)))
        losses(bt, bs)
        g_plain = _step1_grads(bt)
    with monkeypatch.context() as m:
        plain_seams(m, recording(IN.instance_norm_act_reference, p_branch))
        ref = [losses(pt, ps)]
        _copy_state(kt, ks, pt, ps)
        ref.append(losses(pt, ps))
    got.append(losses(kt, ks))
    # Two kernel steps of 3 G applies x 2 blocks: path A's chunked blocks
    # (2 norms, 2 norm VJPs, 2 weight gradients and 2 forward convolutions
    # each, as many as a fused block's), path B's 2 conv_dw a block and no
    # block kernel.
    want = (24, 24, 24, 24) if path == "chunked" else (0, 0, 24, 0)
    assert _delta(before, "cg_chunked_in_fwd", "cg_chunked_in_vjp", "cg_conv_dw",
                  "cg_conv3x3_reflect") == want
    for step, (g_, r_) in enumerate(zip(got, ref), 1):
        for k in g_:
            np.testing.assert_allclose(g_[k], r_[k], rtol=1e-3, atol=1e-4,
                                       err_msg=f"step {step} {k}")
    pairs = [(a, b) for a, b in zip(k_branch, p_branch[:len(k_branch)]) if a is not None]
    flips = sum(int((a != b).sum()) for a, b in pairs)
    assert flips <= RELU_FLIP_SHARE * sum(a.numel() for a, _ in pairs), flips
    pre_norm = {f"{net_name}.{name}.conv.bias"
                for net_name, net in zip(("G_i2l", "G_l2i", "D_img", "D_lab"), kt.nets())
                for name, m_ in net.named_modules()
                if isinstance(getattr(m_, "norm", None), blocks.InstanceNorm)}
    for name, gp in g_plain.items():
        gk = g_kernel[name]
        assert torch.isfinite(gk).all(), name
        if name in pre_norm:
            continue
        rel = float((gk - gp).norm() / gp.norm())
        assert rel <= GRAD_TOL_F32, f"{name}: step-1 gradient {rel} of its norm off"


def test_cli_trains_on_the_card_and_restores_there(card, tmp_path):
    """``python -m cyclegan_tpu_torch.main --training`` for 2 steps at ngf 8
    on the card (its default device) through the IN and fused-block
    kernels, then a checkpoint restore that lands every tensor on the card:
    the nets, Adam's moments (its step counts stay on the host, as torch
    keeps them), the pools and the dropout generator."""
    from cyclegan_tpu_torch.main import main
    from cyclegan_tpu_torch.train import checkpoint as ck

    cfg = Config(dataset="synthetic", dataset_size=4, labeled_fraction=0.5,
                 gen_net="resnet_2blocks", ngf=8, ndf=8, crop_height=32, crop_width=32,
                 batch_size=1, pool_size=2, epochs=1, decay_epoch=1, use_dropout=False,
                 checkpoint_dir=str(tmp_path / "ckpt"), results_dir=str(tmp_path / "res"))
    flags = ["--dataset", "synthetic", "--dataset_size", "4", "--labeled_fraction", "0.5",
             "--gen_net", "resnet_2blocks", "--ngf", "8", "--ndf", "8", "--crop_height", "32",
             "--crop_width", "32", "--batch_size", "1", "--pool_size", "2", "--epochs", "1",
             "--decay_epoch", "1", "--log_every", "1", "--validation_every", "1",
             "--checkpoint_dir", cfg.checkpoint_dir, "--results_dir", cfg.results_dir]
    before = _build.launches.copy()
    res = main(["--training"] + flags)
    torch.cuda.synchronize()
    assert all(_delta(before, "cg_instance_norm_act", "cg_instance_norm_act_bwd",
                      "cg_conv3x3_reflect", "cg_conv3x3_reflect_dgrad")), _build.launches
    assert np.isfinite(res["miou"])
    trainer, state, _, _ = ck.restore_for_inference(cfg, semisupervised=True)
    assert state.step == 2 and state.pool_img.count == 2
    for net in trainer.nets():
        assert all(t.is_cuda for t in net.state_dict().values())
    for opt in (state.g_opt, state.d_opt):
        for st in opt.state.values():
            assert all(v.is_cuda for k, v in st.items() if k != "step")
    assert state.pool_img.buffer.is_cuda and state.pool_lab.buffer.is_cuda
    assert state.dropout.device.type == "cuda"
    scores = main(["--testing"] + flags)
    assert scores["miou"] == pytest.approx(res["miou"], abs=1e-6)



@pytest.mark.parametrize("seeded", [True, False])
def test_a_cpu_checkpoint_resumes_on_the_card(card, tmp_path, seeded):
    """A run saved on the CPU (its dropout state the Mersenne Twister's 5056
    bytes, with the stream's seed, or without it as checkpoints written
    before the seed was stored) resumes on the card: the nets bitwise, the
    card's Philox generator seeded by ``dropout_reseed`` of the stored seed
    (else the card trainer's own) and the step, and the next step finite."""
    from cyclegan_tpu_torch.train import checkpoint as ck

    cfg = Config(gen_net="resnet_2blocks", ngf=8, ndf=8, crop_height=32, crop_width=32,
                 bf16=False, batch_size=2, pool_size=2, epochs=2, decay_epoch=1,
                 use_dropout=True)
    r = np.random.default_rng(1)
    host = {"lab_image": torch.from_numpy(r.uniform(-1, 1, (2, 32, 32, 3)).astype(np.float32)),
            "unlab_image": torch.from_numpy(r.uniform(-1, 1, (2, 32, 32, 3))
                                            .astype(np.float32)),
            "lab_label": torch.from_numpy(r.integers(0, 5, (2, 32, 32)))}
    ta = CycleGANTrainer(cfg, 5, 3, 2, device="cpu")
    sa = ta.init_state(torch.Generator().manual_seed(0))
    sa, _ = ta.train_step(sa, host)
    payload = ck.state_payload(ta, sa)
    assert payload["dropout"].numel() == 5056
    if not seeded:
        del payload["dropout_seed"]
    mngr = ck.CheckpointManager(str(tmp_path / "c"))
    mngr.save(0, payload)
    tb = CycleGANTrainer(cfg, 5, 3, 2, device="cuda")
    sb = tb.init_state(torch.Generator().manual_seed(5))
    seed = sa.dropout_seed if seeded else sb.dropout_seed
    sb, _ = mngr.restore(tb, sb)
    want = torch.Generator(device="cuda").manual_seed(ck.dropout_reseed(seed, 1))
    assert sb.step == 1 and sb.dropout_seed == seed
    assert torch.equal(sb.dropout.get_state(), want.get_state())
    for na, nb in zip(ta.nets(), tb.nets()):
        for x, y in zip(na.state_dict().values(), nb.state_dict().values()):
            assert torch.equal(x, y.cpu())
    sb, m = tb.train_step(sb, {k: v.cuda() for k, v in host.items()})
    assert all(np.isfinite(float(v)) for v in m.values())

# The supervised paths (BASELINE config 1): kernels #1/#2 at every U-Net
# plane (the 2x2 and 4x4 planes are smaller than a tile of in_plan), #3-#5
# at config 1's trunk (2, 32, 32, 256), and the supervised CLI on the card.
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("shape", [(2, 2, 2, 512), (2, 4, 4, 512), (2, 8, 8, 512),
                                   (2, 16, 16, 256), (2, 32, 32, 128), (2, 64, 64, 64)])
def test_instance_norm_at_unet_planes_matches_plain(card, shape, dtype):
    x = (torch.randn(shape, device="cuda", generator=card) * 3 + 1).to(dtype)
    dy = torch.randn(shape, device="cuda", generator=card).to(dtype)
    y = torch.empty_like(x)
    mean, rstd = IN.launch(x, None, y, 1e-5, "none")
    dx = torch.empty_like(x)
    IN.launch_bwd(x, dy, mean, rstd, dx, "none")
    torch.cuda.synchronize()
    torch.testing.assert_close(y.float(), IN.instance_norm_act_plain(x, None, 1e-5).float(),
                               **TOL[dtype])
    pm, pr = IN.instance_norm_stats_plain(x)
    _close(dx, IN.instance_norm_act_bwd_plain(x, dy, pm, pr, "none"), BWD_TOL[dtype])


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_residual_block_at_config1_trunk_matches_plain(card, dtype):
    shape, c = (2, 32, 32, 256), 256
    x = torch.randn(shape, device="cuda", generator=card).to(dtype)
    w1, w2 = [(0.02 * torch.randn((3, 3, c, c), device="cuda", generator=card)).to(dtype)
              for _ in range(2)]
    b1, b2 = [(0.01 * torch.randn((c,), device="cuda", generator=card)).to(dtype)
              for _ in range(2)]
    dy = torch.randn(shape, device="cuda", generator=card).to(dtype)
    leaves = [t.clone().requires_grad_() for t in (x, w1, b1, w2, b2)]
    y = RB.residual_block_fused(*leaves)
    got = torch.autograd.grad(y, leaves, dy)
    _hold_fused_block(x, w1, b1, w2, b2, dy, y, got, dtype)


@pytest.mark.parametrize("extra", [[], ["--gen_net", "unet_128", "--crop_height", "128",
                                        "--crop_width", "128"],
                                   ["--norm", "batch", "--remat", "true"]])
def test_supervised_cli_trains_and_tests_on_the_card(card, tmp_path, extra):
    """``--training --model supervised`` for 2 steps at ngf 8 on the card,
    then ``--testing`` (plain, and tiled with flip and two scales) of its
    checkpoint: the kernels launched, the scores equal the last
    validation's."""
    from cyclegan_tpu_torch.main import main

    flags = ["--model", "supervised", "--dataset", "synthetic", "--dataset_size", "4",
             "--gen_net", "resnet_2blocks", "--ngf", "8", "--crop_height", "32",
             "--crop_width", "32", "--batch_size", "2", "--epochs", "1", "--decay_epoch", "1",
             "--log_every", "1", "--checkpoint_dir", str(tmp_path / "ckpt"),
             "--results_dir", str(tmp_path / "res"), *extra]
    before = _build.launches.copy()
    res = main(["--training"] + flags)
    torch.cuda.synchronize()
    forward = sum(_delta(before, "cg_instance_norm_act", "cg_conv3x3_reflect", "cg_conv_dw"))
    assert forward > 0 or "batch" in extra, _build.launches
    assert np.isfinite(res["miou"])
    scores = main(["--testing"] + flags)
    assert scores["miou"] == pytest.approx(res["miou"], abs=1e-6)
    crop = int(extra[extra.index("--crop_height") + 1]) if "--crop_height" in extra else 32
    h = 2 * crop   # the tiled canvas: twice the window
    tta = main(["--testing", "--eval_resize", "tile", "--resize_height", str(h),
                "--resize_width", str(h), "--eval_flip", "true", "--eval_scales", "1.0,1.25"]
               + flags)
    assert np.isfinite(tta["miou"])
