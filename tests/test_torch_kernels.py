"""The port's kernel modules against the JAX kernels.

On the CPU each wrapper runs its plain PyTorch version; these tests hold
those against the Pallas kernels run in interpret mode (and the XLA
reference), on the same seeded numpy inputs. The CUDA kernels themselves
run only on the card: ``tests/test_torch_cuda.py`` (marked ``cuda``)
checks them there at small shapes, and ``chip_smoke.py`` at the main
path's shapes.
"""

import ctypes
import re

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from cyclegan_tpu.kernels.instance_norm import instance_norm_act as jax_in_act
from cyclegan_tpu.kernels.resblock import (residual_block_fused as jax_rb_fused,
                                           residual_block_reference)
from cyclegan_tpu_torch.kernels import _build
from cyclegan_tpu_torch.kernels import instance_norm as IN
from cyclegan_tpu_torch.kernels import resblock as RB


def _x(shape, seed, scale=1.0, shift=0.0):
    rng = np.random.default_rng(seed)
    return (scale * rng.standard_normal(shape) + shift).astype(np.float32)


@pytest.mark.parametrize("skip", [False, True])
@pytest.mark.parametrize("act", ["none", "relu", "leaky"])
def test_instance_norm_act_matches_pallas(act, skip):
    x = _x((2, 8, 6, 16), 0, 3.0, 1.0)
    s = _x((2, 8, 6, 16), 1) if skip else None
    ref = jax_in_act(jnp.asarray(x), None if s is None else jnp.asarray(s), 1e-5, act, True)
    got = IN.instance_norm_act(torch.from_numpy(x),
                               None if s is None else torch.from_numpy(s), 1e-5, act)
    np.testing.assert_allclose(got.numpy(), np.asarray(ref), atol=1e-5)


def test_instance_norm_act_bf16_matches_pallas():
    """bf16 in and out, float32 statistics: within one bf16 ulp."""
    x = _x((1, 8, 8, 16), 2, 2.0)
    ref = jax_in_act(jnp.asarray(x, jnp.bfloat16), None, 1e-5, "relu", True)
    got = IN.instance_norm_act(torch.from_numpy(x).to(torch.bfloat16), None, 1e-5, "relu")
    assert got.dtype == torch.bfloat16
    np.testing.assert_allclose(got.float().numpy(), np.asarray(ref, np.float32),
                               atol=2 ** -8, rtol=2 ** -7)


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_slab_wrappers_hand_the_c_entries_their_slot(monkeypatch, dtype):
    """What the slab entries' wrappers hand their C entries, in the order of
    their signatures: the partials, the exchange buffer, S and this slab's
    slot, the scratch of the tiles' partials, then the plan; the applies
    take no scratch, and the statistics the backward saves do not share
    the forward output's memory. A slot or buffer that does not fit
    raises."""
    calls, asked = [], []
    monkeypatch.setattr(_build, "call", lambda lib, fn, *args: calls.append((fn, args)))
    monkeypatch.setattr(_build, "stream_ptr", lambda t: 0)
    monkeypatch.setattr(_build, "scratch_ptr", lambda nbytes, t, s: asked.append(nbytes) or 16)
    n, h, w, c = 2, 40, 30, 64
    x = torch.zeros((n, h, w, c), dtype=dtype)
    plan = IN.in_plan(h * w, c, x.element_size())
    buf, bbuf = torch.zeros((3, n, c, 3)), torch.zeros((3, n, c, 2))
    IN._slab_partials_cuda(x, buf, 2)
    y, mean, rstd, count = IN._slab_apply_cuda(x, x.clone(), buf, 1e-5, "relu")
    IN._slab_bwd_partials_cuda(x, x.clone(), mean, rstd, bbuf, 2, "relu")
    IN._slab_bwd_apply_cuda(x, x.clone(), mean, rstd, bbuf, count, "relu")
    assert [fn for fn, _ in calls] == ["cg_instance_norm_partials", "cg_instance_norm_slab_apply",
                                       "cg_instance_norm_bwd_partials",
                                       "cg_instance_norm_bwd_slab_apply"]
    for fn, args in calls:
        assert len(args) == len(_build.SIGNATURES["instance_norm"][fn]), fn
    shape = (n, h * w, c, plan.rows, plan.vec, plan.lanes, plan.tiles)
    assert calls[0][1][1:12] == (buf.data_ptr(), 3, 2, 16, *shape)
    assert calls[2][1][4:15] == (bbuf.data_ptr(), 3, 2, 16, *shape)
    assert calls[1][1][4:13] == (buf.data_ptr(), 3, *shape)
    assert calls[3][1][5:15] == (bbuf.data_ptr(), 3, count.data_ptr(), *shape)
    assert asked == [8 * n * c * plan.row_tiles] * 2
    assert y.shape == x.shape and y.dtype == dtype and mean.shape == rstd.shape == (n, c)
    assert y.untyped_storage().data_ptr() != mean.untyped_storage().data_ptr()
    for bad, slot in ((buf, 3), (bbuf, 0), (torch.zeros((3, n, c + 1, 3)), 0)):
        with pytest.raises(ValueError, match="exchange buffer"):
            IN._slab_partials_cuda(x, bad, slot)


def _rb_params(c, seed):
    return (0.05 * _x((3, 3, c, c), seed), 0.01 * _x((c,), seed + 1),
            0.05 * _x((3, 3, c, c), seed + 2), 0.01 * _x((c,), seed + 3))


@pytest.mark.parametrize("shape", [(2, 12, 12, 16), (1, 6, 9, 32)])
def test_residual_block_matches_pallas_and_reference(shape):
    x = _x(shape, 10)
    params = _rb_params(shape[-1], 11)
    jx = [jnp.asarray(a) for a in (x, *params)]
    ref_kernel = jax_rb_fused(*jx, 1e-5, True)
    ref_xla = residual_block_reference(*jx)
    got = RB.residual_block_fused(*[torch.from_numpy(a) for a in (x, *params)])
    np.testing.assert_allclose(got.numpy(), np.asarray(ref_kernel), atol=2e-5)
    np.testing.assert_allclose(got.numpy(), np.asarray(ref_xla), atol=2e-5)


def test_cpu_tensors_leave_launch_counters_at_zero():
    before = _build.launches.copy()
    x = torch.from_numpy(_x((1, 4, 4, 32), 20))
    w1, b1, w2, b2 = [torch.from_numpy(a) for a in _rb_params(32, 21)]
    IN.instance_norm_act(x, None, 1e-5, "relu")
    RB.residual_block_fused(x, w1, b1, w2, b2)
    assert [_build.launches[e] - before[e]
            for e in ("cg_instance_norm_act", "cg_conv3x3_reflect")] == [0, 0]


@pytest.mark.parametrize("shape,c_out,match", [
    ((1, 1, 4, 32), 32, "H, W >= 2"),
    ((1, 4, 4, 16), 16, "Cin % 32"),
    ((1, 4, 4, 32), 12, "Cout % 8"),
])
def test_conv_kernel_rejects_shapes_it_does_not_take(shape, c_out, match):
    """The kernel covers the main path's shapes and raises on others (no
    fallback), before any build or launch."""
    x = torch.zeros(shape)
    w = torch.zeros((3, 3, shape[-1], c_out))
    out = torch.zeros(shape[:3] + (c_out,))
    with pytest.raises(ValueError, match=match):
        RB.conv3x3_reflect(x, w, torch.zeros(c_out), out)


@pytest.mark.parametrize("shape", [(65536, 64), (16384, 128), (4096, 256), (30, 40)])
def test_tile_rows_fills_the_card(shape):
    """The instance norm's tiling (``in_plan``): even one sample gives the
    card a tile per SM, or tiles of one row a thread; the batch does not
    enter. Bf16 planes read 8 channels a thread (16 bytes)."""
    hw, c = shape
    plan = IN.in_plan(hw, c, 2)
    assert plan.vec == 8 and plan.rows % (IN.IN_THREADS // plan.lanes) == 0
    per_thread = plan.rows // (IN.IN_THREADS // plan.lanes)
    assert per_thread in IN.IN_ROWS_A_THREAD
    assert per_thread == 1 or plan.tiles >= IN.IN_FILL


def _covered(hw, c, plan):
    """How often each (row, channel) of a sample falls in a tile of the
    plan, walking the tiles as csrc/instance_norm.cu decodes them."""
    seen = np.zeros((hw, c), np.int32)
    for t in range(plan.tiles):
        g, rt = divmod(t, plan.row_tiles)
        for lane in range(plan.lanes):
            c0 = (g * plan.lanes + lane) * plan.vec
            if c0 < c:
                seen[rt * plan.rows:(rt + 1) * plan.rows, c0:c0 + plan.vec] += 1
    return seen


@pytest.mark.parametrize("elt", [2, 4])
@pytest.mark.parametrize("hw,c", [(4096, 64), (1024, 256), (961, 512), (35, 40), (35, 96),
                                  (35, 12), (7, 3), (1, 1), (16384, 128)])
def test_in_plan_covers_each_row_and_channel_once(hw, c, elt):
    """Ragged C (40, 96; 12 and 3 take one channel a thread), H*W below one
    tile, two channel groups (512); the plan is what the C entry checks."""
    plan = IN.in_plan(hw, c, elt)
    assert (_covered(hw, c, plan) == 1).all()
    assert c % plan.vec == 0 and plan.vec in (1, 16 // elt)
    assert plan.lanes & (plan.lanes - 1) == 0 and 1 <= plan.lanes <= 32
    assert plan.rows % (IN.IN_THREADS // plan.lanes) == 0
    assert plan.groups == -(-(c // plan.vec) // plan.lanes)
    assert plan.row_tiles == -(-hw // plan.rows) and plan.tiles == plan.groups * plan.row_tiles


@pytest.mark.parametrize("hw,c,elt", [(65536, 64, 2), (4096, 256, 4), (35, 40, 2)])
def test_in_grid_never_exceeds_what_the_card_holds(hw, c, elt):
    """The plan has no batch in it; the cooperative grid takes no more
    blocks than the occupancy query allows (any count, 1 block an SM and
    up) and at least one, whatever the batch."""
    plan = IN.in_plan(hw, c, elt)
    for n in (1, 2, 3, 8, 64):
        for coresident in (1, 132, 264, 528, 1056):
            grid = IN.in_grid(n, c, plan, coresident)
            assert 1 <= grid <= coresident
            assert grid == coresident or grid >= n * plan.tiles


@pytest.mark.parametrize("batch", [1, 2, 8])
def test_conv_plan_fills_the_card(batch):
    """The bf16 forward convolution's tile at the trunk shape (64x64x256 ->
    256): a block for at least 128 of the 132 SMs at every batch (the
    mma.sync kernel it replaced had 64 at batch 1, 128 at batch 2), in
    shared memory an H100 block can hold."""
    plan = RB.conv_plan(batch, 64, 64, 256, 256)
    assert plan in RB.CONV_TILES
    assert RB.conv_blocks(plan, batch, 64, 64, 256) >= 128
    smem, per_sm = RB.conv_tile(plan, 256)
    assert smem <= 227 * 1024 and per_sm * (smem + 1024) <= 228 * 1024


@pytest.mark.parametrize("batch", [1, 2, 8, 16])
def test_dgrad_plan_fills_the_card(batch):
    """The input gradient's tile at the trunk shape (64x64x256 -> 256): the
    wgmma tile at every batch, with a block for at least 128 of the 132 SMs
    from batch 2 on (546 and 1,090 blocks of 128 x 128 at the train
    cells' 8 and 16 rows), in shared memory an H100 block can hold. At
    batch 1 its 70 blocks measured faster on an H100 than tiles that give
    the card 138 (the mma.sync tile, a 64 x 128 wgmma tile: two waves)."""
    plan = RB.dgrad_plan(batch, 64, 64, 256, 256)
    assert plan == RB.DGRAD_TILES[0] and plan[0]
    assert RB.dgrad_blocks(plan, batch, 64, 64, 256) >= (RB.CONV_FILL if batch > 1 else 70)
    assert RB.dgrad_smem(plan) <= RB.SMEM_BLOCK_MAX


def _dgrad_written(tile, n, h, w, cin):
    """How often each (padded pixel, input channel) of the padded gradient
    is written, walking the grid as csrc/resblock.cu's dgrad_mma decodes it:
    a wgmma tile's two warpgroups own 64 rows each (WM 2) or half the
    columns each (WM 1, after their exchange); the mma.sync tile's 8 warps
    own 32 x 32 each."""
    wgmma, wm, bn, _ = tile
    m = n * (h + 2) * (w + 2)
    seen = np.zeros((m, cin), np.int32)
    # (first row, rows, first column, columns) of each writer in a block
    if not wgmma:
        parts = [(warp // 4 * 32, 32, warp % 4 * 32, 32) for warp in range(8)]
    elif wm == 2:
        parts = [(wg * 64, 64, 0, bn) for wg in range(2)]
    else:
        parts = [(0, 64, wg * bn // 2, bn // 2) for wg in range(2)]
    for bx in range(-(-m // (64 * wm))):
        for by in range(-(-cin // bn)):
            for r0, rows, c0, cols in parts:
                r, c = bx * 64 * wm + r0, by * bn + c0
                seen[r:min(r + rows, m), c:min(c + cols, cin)] += 1
    assert RB.dgrad_blocks(tile, n, h, w, cin) == -(-m // (64 * wm)) * -(-cin // bn)
    return seen


@pytest.mark.parametrize("tile", RB.DGRAD_TILES + (RB.DGRAD_SYNC,))
@pytest.mark.parametrize("n,h,w,cin,cout", [(1, 17, 5, 32, 96), (2, 7, 9, 32, 96),
                                            (3, 5, 70, 96, 64), (2, 2, 3, 32, 32),
                                            (1, 64, 64, 256, 256), (2, 64, 64, 256, 256)])
def test_dgrad_tiles_cover_each_padded_pixel_and_channel_once(tile, n, h, w, cin, cout):
    """Every tile covers the (N, H+2, W+2, Cin) padded gradient once: ragged
    Cin 32 in a 128- or 256-wide tile, Cout 96 (a K chunk half zero-filled),
    odd H and W, a padded row longer than a tile; the plan picks one of
    them and its shared memory fits a block."""
    assert (_dgrad_written(tile, n, h, w, cin) == 1).all()
    plan = RB.dgrad_plan(n, h, w, cin, cout)
    assert plan in RB.DGRAD_TILES and RB.dgrad_smem(plan) <= RB.SMEM_BLOCK_MAX


@pytest.mark.parametrize("n,h,w,cin,cout,match", [
    (1, 1, 4, 32, 32, "H, W >= 2"), (1, 4, 4, 48, 32, "Cin % 32"),
    (1, 4, 4, 32, 48, "Cout % 32"), (0, 4, 4, 32, 32, "1 <= N"),
    (2048, 64, 64, 256, 256, "2\\^31"),
])
def test_dgrad_plan_raises_on_shapes_the_kernel_refuses(monkeypatch, n, h, w, cin, cout, match):
    """The plan raises on a shape the C entry refuses, and the wrapper
    before any launch (zero-size planes stand in: nothing is read)."""
    calls = []
    monkeypatch.setattr(_build, "call", lambda *args: calls.append(args))
    with pytest.raises(ValueError, match=match):
        RB.dgrad_plan(n, h, w, cin, cout)
    if n * h * w < 2 ** 20:
        with pytest.raises(ValueError, match=match):
            RB.conv3x3_reflect_dgrad(torch.zeros((3, n, h, w, cout), dtype=torch.bfloat16),
                                     torch.zeros((3, 3, cin, cout)), torch.zeros((n, h, w, cin)))
    assert calls == []


@pytest.mark.parametrize("w_dtype", [torch.bfloat16, torch.float32])
def test_dgrad_wrapper_launches_the_planned_tile(monkeypatch, w_dtype):
    """The wrapper hands the C entry the plan's tile (a float32 weight's
    three parts the mma.sync tile), with the argument count the entry
    declares, and counts the call under that tile."""
    calls = []
    monkeypatch.setattr(_build, "call", lambda lib, fn, *args: calls.append((fn, args)))
    monkeypatch.setattr(_build, "stream_ptr", lambda t: 0)
    monkeypatch.setattr(_build, "scratch_ptr", lambda nbytes, t, s: 16)
    n, h, w, c = 2, 8, 9, 64
    bf16 = w_dtype == torch.bfloat16
    g_parts = torch.zeros((2 if bf16 else 3, n, h, w, c), dtype=torch.bfloat16)
    out = torch.zeros((n, h, w, c))
    wt = torch.zeros((3, 3, c, c), dtype=w_dtype)
    before = RB.dgrad_tiles.copy()
    RB.conv3x3_reflect_dgrad(g_parts, wt, out)
    (args,) = [args for fn, args in calls if fn == "cg_conv3x3_reflect_dgrad"]
    tile = RB.dgrad_plan(n, h, w, c, c) if bf16 else RB.DGRAD_SYNC
    assert len(args) == len(_build.SIGNATURES["resblock"]["cg_conv3x3_reflect_dgrad"])
    assert args[5:16] == (n, h, w, c, c, 2 if bf16 else 3, 1 if bf16 else 3, *tile)
    assert RB.dgrad_tiles - before == {tile: 1}


@pytest.mark.parametrize("cout", [8, 40, 256])
@pytest.mark.parametrize("cin", [32, 96, 256, 2048])
def test_conv_plan_takes_every_channel_count(cin, cout):
    """Any Cin % 32 == 0 and Cout % 8 == 0 has a tile that fits a block (a
    partial chunk of input channels and a partial N tile are zero-filled in
    the kernel; a Cin whose halos do not fit takes a tile without them), on
    a ragged patch (H odd, W not a multiple of 64)."""
    plan = RB.conv_plan(1, 5, 7, cin, cout)
    assert plan in RB.CONV_TILES and RB.conv_blocks(plan, 1, 5, 7, cout) >= 1
    assert RB.conv_tile(plan, cin)[0] <= 227 * 1024


def _c_entries(name: str) -> dict:
    """{entry: [ctypes type of each parameter]} of the ``extern "C"``
    entries of ``csrc/<name>.cu``, read from the source: pointers as
    c_void_p, ``int`` as c_int, ``float`` as c_float."""
    src = (_build.SRC_DIR / f"{name}.cu").read_text()
    kinds = {"int": ctypes.c_int, "float": ctypes.c_float}
    out = {}
    for fn, params in re.findall(r'extern "C" int (\w+)\(([^)]*)\)', src):
        out[fn] = [ctypes.c_void_p if "*" in p else kinds[p.split()[-2]]
                   for p in params.split(",")]
    return out


@pytest.mark.parametrize("name", _build.SOURCES)
def test_declared_signatures_match_the_c_entries(name):
    """The argtypes ``_build`` gives each C entry are the parameters the
    source declares, one for one: a count or type that differs would pass
    an argument in the wrong place without any error."""
    assert _c_entries(name) == _build.SIGNATURES[name]
