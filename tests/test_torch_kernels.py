"""The port's kernel modules against the JAX kernels.

On the CPU each wrapper runs its plain PyTorch version; these tests hold
those against the Pallas kernels run in interpret mode (and the XLA
reference), on the same seeded numpy inputs. The CUDA kernels themselves
run only on the card: ``tests/test_torch_cuda.py`` (marked ``cuda``)
checks them there at small shapes, and ``chip_smoke.py`` at the main
path's shapes.
"""

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
