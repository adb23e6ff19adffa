"""The spatial axis of the port (``parallel/spatial.py``, the slab entries of
``kernels/instance_norm.py``, the slab paths of ``ops/blocks.py``, the
trainers on a (data, spatial) mesh), on the CPU.

Four gloo ranks, spawned once through ``parallel.distributed.launch_local``,
make a dp 2 x spatial 2 mesh (``make_mesh(spatial=2)``): each data row's
images have their H axis in two slabs. Every module case builds its inputs
from a seed on every rank, runs the module on the whole plane on its own
(no mesh) and on this rank's slab (the mesh set), and
compares the slab's rows of the output, of the input's gradient, and the
parameters' gradients summed over the ranks (the trainers' all-reduce;
not the conv biases an instance norm cancels, whose gradient is rounding
noise) with the whole plane's, at the generator bar of 5e-5 (of the
largest magnitude, at least 1):
- the halo exchange (``RowGather``) forward and backward against slicing a
  whole tensor, for reflect and zero padding;
- ``ConvBlock`` (reflect 7x7, the trunk 3x3 on kernel #8's route, zero
  3x3 stride 2, 4x4 stride 2 and stride 1 on an uneven slab split),
  ``DeconvBlock``, and the whole ResNet generator and PatchGAN (whose last
  two layers split 3 and 2 rows unevenly at 32x32);
- the slab instance norm's plain versions (forward and VJP) through the
  slot-writing gather (each rank's partials in its slot of the exchange
  buffer, zeros in the others, one all-reduce) against
  ``instance_norm_act_plain`` on the plane: relu with a skip, none without,
  leaky on an uneven split (4 and 3 rows), and a plane of one row, of
  which one rank owns none (a slot of zeros, every collective made); in
  each, mean and rstd bitwise equal on every rank; and relu with a skip
  against the JAX package's ``instance_norm_act`` on the whole plane (its
  Pallas kernels in interpret mode), at the same float32 bar of 5e-5;
- the U-Net generator (num_downs 5, ngf 8, 32x32, whose innermost plane
  is one row) with instance norm and with batch norm, and with dropout
  (num_downs 6, 64x64) on injected masks;
- the tiled logits with flip and scales inside, and the scaled logits
  with flip inside at a snapped height (20 rows at scale 0.6 of 32) that
  fails the runner's ``crop_height % (4 s)`` rule and splits 3 and 2
  rows at the trunk, on slabs (``parallel.spatial.on_canvas_slabs``)
  against the whole canvas.
The worst error over the ranks of each case comes back from rank 0.

The trainers on the same mesh:
- the counterpart of ``tests/test_integration.py::TestSpatialSharding``:
  the port's ``SupervisedTrainer`` (``resnet_6blocks``, ngf 8, 32x32, batch
  4, float32, 4 classes) gives JAX's unsharded ``value_and_grad`` of the
  cross-entropy, on the same weights carried across from Flax, within the
  generator bar of 5e-5 (the loss relative, each gradient of its largest
  magnitude, at least 1);
- the CycleGAN step (ngf 8, 2 trunk blocks, 32x32, 5 classes, global batch
  2, pools of 2 with injected decisions) for 3 steps, against the port's
  one process on the same global batch (every step-1 metric within rtol
  1e-5, then ``g_total`` / ``d_total`` within 2e-3, every parameter and
  both pools within 2e-3 after 3 steps) and against the JAX step jitted on
  one device (``g_total`` within rtol 2e-3, ``d_total`` within rtol 2e-3 /
  atol 1e-3);
- the same with ``unet_128`` generators (128x128) against the port's one
  process, at 2e-3;
- the supervised ``unet_128`` (ngf 8, 128x128, batch 4) against JAX's
  unsharded ``value_and_grad`` on the same weights, at 5e-5;
- the two evaluations' canvases against JAX's ``eval_tile.tiled_logits``
  and ``tta.scale_avg`` / ``flip_avg`` on the same weights, at 5e-5;
- ``runner.run_test`` at ``--num_devices 4 --spatial_shards 2`` with
  ``--eval_resize tile``, ``--eval_flip`` and ``--eval_scales`` on one
  checkpoint: its confusion matrix equals one process's.
The ranks import this module without JAX (its fixture imports it in the
parent), and no rank outlives its test.
"""

from __future__ import annotations

import copy
import multiprocessing

import numpy as np
import pytest
import torch
import torch.distributed as dist

from cyclegan_tpu_torch import eval_tile, tta, weights
from cyclegan_tpu_torch.kernels import instance_norm as IN
from cyclegan_tpu_torch.models import define_Dis, define_Gen
from cyclegan_tpu_torch.models.generators import UnetGenerator
from cyclegan_tpu_torch.ops import blocks
from cyclegan_tpu_torch.parallel import distributed
from cyclegan_tpu_torch.parallel import mesh as tmesh
from cyclegan_tpu_torch.parallel import spatial as S
from cyclegan_tpu_torch.train import checkpoint as ck
from cyclegan_tpu_torch.train import runner
from cyclegan_tpu_torch.train.cyclegan import CycleGANTrainer
from cyclegan_tpu_torch.train.supervised import SupervisedTrainer
from cyclegan_tpu_torch.utils.config import Config

TOL = 5e-5
WORLD, S_RANKS, SIZE = 4, 2, 32
SUP_KW = dict(gen_net="resnet_6blocks", ngf=8, bf16=False, crop_height=SIZE, crop_width=SIZE,
              batch_size=4, epochs=2, decay_epoch=1)
SUP_CLASSES = 4
CG_KW = dict(gen_net="resnet_2blocks", ngf=8, ndf=8, crop_height=SIZE, crop_width=SIZE,
             bf16=False, epochs=200, decay_epoch=100, batch_size=2, pool_size=2)
CG_CLASSES, STEPS = 5, 3
UNET = 128  # unet_128's plane: its innermost is one row
SUP_UNET_KW = dict(SUP_KW, gen_net="unet_128", crop_height=UNET, crop_width=UNET)
CG_UNET_KW = dict(CG_KW, gen_net="unet_128", crop_height=UNET, crop_width=UNET)
# The evaluations: a 32x48 canvas, 16x16 windows, scales whose 0.6 snaps
# to 20 rows (20 % (4 * 2) = 4).
EVAL_CANVAS, EVAL_WINDOW, EVAL_SCALES = (32, 48), (16, 16), (0.6, 1.0)
EVAL_CASES = ("tile_flip_scales", "flip_scales")
RUN_KW = dict(dataset="synthetic", gen_net="resnet_2blocks", ngf=4, ndf=4, crop_height=32,
              crop_width=32, bf16=False, batch_size=2, pool_size=2, eval_resize="tile",
              resize_height=64, resize_width=64, eval_flip=True, eval_scales="0.7,1.0")


@pytest.fixture(autouse=True)
def _no_child_left_behind():
    yield
    assert multiprocessing.active_children() == []


def _randn(seed: int, *shape) -> torch.Tensor:
    return torch.from_numpy(np.random.default_rng(seed).standard_normal(shape).astype(
        np.float32))


def _nchw(x: torch.Tensor) -> torch.Tensor:
    return x.contiguous(memory_format=torch.channels_last)


def _slab_rows(t: torch.Tensor, mesh: tmesh.Mesh) -> torch.Tensor:
    lo, hi = S.slab(t.shape[2], mesh.spatial, mesh.spatial_index)
    return t[:, :, lo:hi]


def _err(a: torch.Tensor, b: torch.Tensor) -> float:
    """max |a - b| over max(1, max |b|)."""
    a, b = a.detach(), b.detach()
    return float((a - b).abs().max() / b.abs().max().clamp_min(1.0)) if b.numel() else 0.0


def _pre_norm_biases(module) -> set:
    """ids of the conv biases an instance norm (or a train-mode batch norm)
    follows: their gradient is zero in exact arithmetic and rounding noise
    in float."""
    norms = (blocks.InstanceNorm, blocks.BatchNorm)
    out = {id(m.conv.bias) for m in module.modules()
           if isinstance(getattr(m, "norm", None), blocks.InstanceNorm)}
    for m in module.modules():  # the U-Net's levels
        for conv, norm in (("down", "down_norm"), ("up", "up_norm")):
            if isinstance(getattr(m, norm, None), norms):
                out.add(id(getattr(m, conv).bias))
    return out


def _compare(module, x: torch.Tensor, mesh: tmesh.Mesh, seed: int, **kw) -> float:
    """Worst error of ``module`` on this rank's slab of ``x`` against the
    whole plane: output rows, input-gradient rows, and parameter gradients
    summed over the ranks."""
    whole = module
    sl = copy.deepcopy(module)
    blocks.set_data_mesh(sl, mesh, x.shape[0])
    xw = x.clone().requires_grad_(True)
    yw = whole(xw, **kw)
    ct = _randn(seed, *yw.shape)
    (yw * ct).sum().backward()
    h = x.shape[2]
    lo, hi = S.slab(h, mesh.spatial, mesh.spatial_index)
    xs = _nchw(x[:, :, lo:hi].detach()).requires_grad_(True)
    ys = sl(xs, **kw)
    (ys * _slab_rows(ct, mesh)).sum().backward()
    errs = [_err(ys, _slab_rows(yw, mesh)), _err(xs.grad, _slab_rows(xw.grad, mesh))]
    skip = _pre_norm_biases(whole)
    for pw, ps in zip(whole.parameters(), sl.parameters()):
        if id(pw) in skip:
            continue
        g = ps.grad.clone()
        dist.all_reduce(g, group=mesh.spatial_group)
        errs.append(_err(g, pw.grad))
    return max(errs)


def _halo_case(mesh: tmesh.Mesh) -> float:
    """RowGather against slicing: forward rows, and the VJP of a weighted
    sum (each rank's cotangent of its gathered rows) against autograd on
    the whole tensor."""
    sp = blocks.S.Spatial(mesh.spatial, mesh.spatial_index, mesh.spatial_group)
    errs = []
    for h, k, stride, pad, mode in ((16, 7, 1, 3, "reflect"), (16, 3, 2, 1, "zero"),
                                    (7, 4, 1, 1, "zero"), (16, 3, 1, 1, "reflect")):
        x = _randn(h, 2, 3, h, 5)
        xw = x.clone().requires_grad_(True)
        lo, hi = S.slab(h, mesh.spatial, mesh.spatial_index)
        xs = x[:, :, lo:hi].clone().requires_grad_(True)
        got = S.conv_input(xs, h, k, stride, pad, mode, sp)
        rows = S.conv_source_rows(h, k, stride, pad, mode, mesh.spatial, mesh.spatial_index)
        idx = torch.tensor([max(r, 0) for r in rows], dtype=torch.long)
        keep = torch.tensor([r >= 0 for r in rows]).view(1, 1, -1, 1)
        want = torch.where(keep, xw.index_select(2, idx), 0.0)
        if pad:
            want = torch.nn.functional.pad(want, (pad, pad, 0, 0),
                                           mode="reflect" if mode == "reflect" else "constant")
        ct = _randn(100 + h + mesh.spatial_index, *want.shape)
        (got * ct).sum().backward()
        # Each rank's cotangent reaches every owner: the sum of the ranks'
        # whole-tensor VJPs, this rank's rows of it.
        (want * ct).sum().backward()
        gsum = xw.grad.clone()
        dist.all_reduce(gsum, group=mesh.spatial_group)
        errs += [_err(got, want.detach()), _err(xs.grad, gsum[:, :, lo:hi])]
    return max(errs)


def _slab_norm(mesh: tmesh.Mesh, x: torch.Tensor, skip, act: str, ct: torch.Tensor):
    """This rank's slab of ``x`` through ``instance_norm_act_slab`` with a
    module's slot-writing gather (``InstanceNorm.slab_group``): the output,
    the input's gradient under ``ct``, the plane's mean and rstd the seam
    saved, and the slab's rows."""
    lo, hi = S.slab(x.shape[1], mesh.spatial, mesh.spatial_index)
    xs = x[:, lo:hi].clone().requires_grad_(True)
    norm = blocks.InstanceNorm()
    norm.spatial = S.from_mesh(mesh)
    ys = IN.instance_norm_act_slab(xs, None if skip is None else skip[:, lo:hi], 1e-5, act,
                                   norm.slab_group())
    _, mean, rstd, _ = ys.grad_fn.saved_tensors
    (ys * ct[:, lo:hi]).sum().backward()
    assert ys.shape[1] == hi - lo and xs.grad.shape == xs.shape
    return ys, xs.grad, mean, rstd, slice(lo, hi)


def _alike_on_every_rank(mesh: tmesh.Mesh, *stats: torch.Tensor) -> bool:
    """Each tensor bitwise equal on every rank of this rank's spatial group."""
    for t in stats:
        got = tmesh.gather_slots(t[None], mesh.spatial_group, mesh.spatial_index, mesh.spatial)
        if not all(torch.equal(got[0], r) for r in got[1:]):
            return False
    return True


def _in_case(mesh: tmesh.Mesh, h: int = 12, act: str = "relu", skip: bool = True,
             seed: int = 1) -> float:
    """The slab instance norm's plain versions through the slot-writing
    gather against instance_norm_act_plain on the plane of ``h`` rows,
    forward and VJP; inf unless every rank holds bitwise the same mean and
    rstd."""
    x = _randn(seed, 2, h, 10, 16)
    sk = _randn(seed + 1, *x.shape) if skip else None
    ct = _randn(seed + 1 + skip, *x.shape)
    xw = x.clone().requires_grad_(True)
    yw = IN.instance_norm_act_plain(xw, sk, 1e-5, act)
    (yw * ct).sum().backward()
    ys, dx, mean, rstd, rows = _slab_norm(mesh, x, sk, act, ct)
    if not _alike_on_every_rank(mesh, mean, rstd):
        return float("inf")
    return max(_err(ys, yw[:, rows]), _err(dx, xw.grad[:, rows]))


def _in_zero_row_case(mesh: tmesh.Mesh) -> float:
    """The slab instance norm on a plane of one row: the second rank owns
    none, writes a slot of zeros, still makes the gathers and holds the
    same statistics."""
    return _in_case(mesh, h=1, act="none", skip=False, seed=4)


def _in_jax_case(mesh: tmesh.Mesh, in_jax: dict) -> float:
    """The slab norm (relu, with a skip) against the JAX package's
    instance_norm_act on the whole plane, forward and VJP."""
    x, sk, ct = (torch.from_numpy(in_jax[k]) for k in ("x", "skip", "ct"))
    ys, dx, mean, rstd, rows = _slab_norm(mesh, x, sk, "relu", ct)
    if not _alike_on_every_rank(mesh, mean, rstd):
        return float("inf")
    return max(_err(ys, torch.from_numpy(in_jax["y"])[:, rows]),
               _err(dx, torch.from_numpy(in_jax["dx"])[:, rows]))


def _injected_keep(n: int):
    """A stand-in for ``blocks.dropout_keep``: the same mask for every
    batch of ``n`` rows, drawn from the shape, so the whole plane's forward
    and each data rank's draw of the global batch drop alike."""

    def keep(shape, p, generator):
        r = np.random.default_rng(sum(shape[1:]) * 7 + shape[-1])
        base = torch.from_numpy(r.random((n, *shape[1:])) >= p)
        return base.repeat(shape[0] // n, *([1] * (len(shape) - 1)))

    return keep


def _unet_dropout_case(mesh: tmesh.Mesh, g: torch.Generator) -> float:
    """The U-Net with dropout at its middle level (num_downs 6, 64x64)."""
    x = _nchw(_randn(18, 2, 3, 64, 64))
    net = UnetGenerator(3, 5, 6, 8, head="none", generator=g, use_dropout=True)
    real = blocks.dropout_keep
    blocks.dropout_keep = _injected_keep(x.shape[0])
    try:
        return _compare(net, x, mesh, 11, dropout=torch.Generator())
    finally:
        blocks.dropout_keep = real


def _nhwc_net(net):
    """NHWC ``(x, rows) -> logits`` of an NCHW generator in eval mode."""
    net.eval()

    def fn(x, rows=None):
        with torch.no_grad():
            return net(_nchw(x.permute(0, 3, 1, 2)), rows=rows).permute(0, 2, 3, 1)

    return fn


def eval_canvas_fn(logits_fn, which: str):
    """The runner's composition: tiles innermost, the flip inside the scales."""
    if which == "tile_flip_scales":
        def tiled(x):
            return eval_tile.tiled_logits(logits_fn, x, EVAL_WINDOW)

        return tta.scale_avg(tta.flip_avg(tiled), EVAL_SCALES)
    return tta.scale_avg(tta.flip_avg(logits_fn), EVAL_SCALES)


def _eval_canvas() -> torch.Tensor:
    return _randn(21, 2, *EVAL_CANVAS, 3)


def _eval_cases(mesh: tmesh.Mesh, eval_params) -> tuple[dict, dict]:
    """Each evaluation on this rank's slab of the canvas against the whole
    canvas (its errors), and the gathered canvas logits (for JAX)."""
    net = define_Gen(3, 5, 8, "resnet_2blocks", head="none")
    weights.load_flax_module(net, eval_params)
    whole = _nhwc_net(net)
    sl = copy.deepcopy(net)
    blocks.set_data_mesh(sl, mesh)
    sp = S.from_mesh(mesh)
    x = _eval_canvas()
    lo, hi = S.slab(x.shape[1], mesh.spatial, mesh.spatial_index)
    errs, outs = {}, {}
    for which in EVAL_CASES:
        want = eval_canvas_fn(whole, which)(x)
        fn = S.on_canvas_slabs(eval_canvas_fn(S.whole_from_slabs(_nhwc_net(sl), sp), which), sp)
        got = fn(x[:, lo:hi].contiguous())
        errs[which] = _err(got, want[:, lo:hi])
        outs[which] = S.gather_slabs(got, x.shape[1], sp).numpy()
    return errs, outs


def spatial_cases(mesh: tmesh.Mesh, eval_params, in_jax: dict) -> tuple[dict, dict]:
    """Each rank: every module case; the worst error of each over the ranks."""
    torch.manual_seed(0)  # the modules' default initialisation, alike on every rank
    g = torch.Generator().manual_seed(0)
    conv = dict(dtype=torch.float32)
    x16 = _nchw(_randn(10, 2, 8, 16, 12))
    cases = {
        "halo_exchange": lambda: _halo_case(mesh),
        "instance_norm_slab": lambda: _in_case(mesh),
        "instance_norm_slab_none": lambda: _in_case(mesh, act="none", skip=False, seed=31),
        "instance_norm_slab_uneven": lambda: _in_case(mesh, h=7, act="leaky", seed=34),
        "instance_norm_slab_vs_jax": lambda: _in_jax_case(mesh, in_jax),
        "conv_reflect_7x7": lambda: _compare(
            blocks.ConvBlock(8, 8, 7, pad=3, **conv), x16, mesh, 1, rows=16),
        "conv_trunk_3x3_kernel8": lambda: _compare(
            blocks.ConvBlock(128, 128, 3, pad=1, act="none", **conv),
            _nchw(_randn(11, 1, 128, 8, 6)), mesh, 2, rows=8),
        "conv_zero_3x3_stride2": lambda: _compare(
            blocks.ConvBlock(8, 16, 3, stride=2, pad=1, pad_mode="zero", **conv), x16, mesh,
            3, rows=16),
        "conv_zero_4x4_stride2": lambda: _compare(
            blocks.ConvBlock(8, 16, 4, stride=2, pad=1, pad_mode="zero", act="leaky", **conv),
            x16, mesh, 4, rows=16),
        "conv_zero_4x4_uneven": lambda: _compare(
            blocks.ConvBlock(8, 4, 4, stride=1, pad=1, pad_mode="zero", act="leaky", **conv),
            _nchw(_randn(12, 2, 8, 7, 6)), mesh, 5, rows=7),
        "deconv_3x3_stride2": lambda: _compare(
            blocks.DeconvBlock(8, 4, **conv), _nchw(_randn(13, 2, 8, 8, 6)), mesh, 6, rows=8),
        "generator_resnet": lambda: _compare(
            define_Gen(3, 5, 8, "resnet_2blocks", head="none", generator=g),
            _nchw(_randn(14, 2, 3, 32, 16)), mesh, 7),
        "generator_resnet_tanh": lambda: _compare(
            define_Gen(5, 3, 8, "resnet_2blocks", head="tanh", generator=g),
            _nchw(_randn(15, 1, 5, 16, 24)), mesh, 8),
        "patchgan_uneven_tail": lambda: _compare(
            define_Dis(3, 8, generator=g), _nchw(_randn(16, 2, 3, 32, 32)), mesh, 9),
        "instance_norm_zero_row_slab": lambda: _in_zero_row_case(mesh),
        "generator_unet_instance_norm": lambda: _compare(
            UnetGenerator(3, 5, 5, 8, head="none", generator=g),
            _nchw(_randn(17, 2, 3, 32, 32)), mesh, 10),
        "generator_unet_batch_norm": lambda: _compare(
            UnetGenerator(5, 3, 5, 8, norm="batch", head="tanh", generator=g),
            _nchw(_randn(19, 2, 5, 32, 32)), mesh, 12),
        "generator_unet_dropout": lambda: _unet_dropout_case(mesh, g),
    }
    out = {}
    for name, run in cases.items():
        err = torch.tensor([run()], dtype=torch.float64)
        dist.all_reduce(err, op=dist.ReduceOp.MAX)
        out[name] = float(err)
    errs, canvases = _eval_cases(mesh, eval_params)
    for name, e in errs.items():
        err = torch.tensor([e], dtype=torch.float64)
        dist.all_reduce(err, op=dist.ReduceOp.MAX)
        out[f"eval_{name}"] = float(err)
    return out, canvases


CASE_NAMES = ["halo_exchange", "instance_norm_slab", "instance_norm_slab_none",
              "instance_norm_slab_uneven", "instance_norm_slab_vs_jax", "conv_reflect_7x7",
              "conv_trunk_3x3_kernel8", "conv_zero_3x3_stride2", "conv_zero_4x4_stride2",
              "conv_zero_4x4_uneven", "deconv_3x3_stride2", "generator_resnet",
              "generator_resnet_tanh", "patchgan_uneven_tail", "instance_norm_zero_row_slab",
              "generator_unet_instance_norm", "generator_unet_batch_norm",
              "generator_unet_dropout", *(f"eval_{w}" for w in EVAL_CASES)]


def _sup_batch(size: int = SIZE) -> dict:
    r = np.random.default_rng(1)
    return {"image": r.uniform(0, 1, (4, size, size, 3)).astype(np.float32),
            "label": r.integers(0, SUP_CLASSES, (4, size, size)).astype(np.int32)}


def _cg_batches(size: int = SIZE) -> list[dict]:
    r = np.random.default_rng(5)
    out = []
    for _ in range(STEPS):
        lab = r.integers(0, CG_CLASSES, (2, size, size)).astype(np.int32)
        lab[:, :3] = 255
        lab[1, :, :5] = 255  # the ranks' valid pixels differ
        out.append({"lab_image": r.uniform(-1, 1, (2, size, size, 3)).astype(np.float32),
                    "unlab_image": r.uniform(-1, 1, (2, size, size, 3)).astype(np.float32),
                    "lab_label": lab, "pool_use_new_img": r.random(2) > 0.5,
                    "pool_idx_img": r.integers(0, 2, 2).astype(np.int32),
                    "pool_use_new_lab": r.random(2) > 0.5,
                    "pool_idx_lab": r.integers(0, 2, 2).astype(np.int32)})
    return out


def supervised_grads(mesh, sup_vars, kw=SUP_KW) -> dict:
    """The supervised loss and gradients of the global batch on ``mesh``,
    the gradients as a Flax tree (``weights.flax_variables`` of a net that
    holds them)."""
    st = SupervisedTrainer(Config(**kw), SUP_CLASSES, 3, steps_per_epoch=4, mesh=mesh)
    state = st.init_state(torch.Generator().manual_seed(0))
    weights.load_flax_module(st.model, sup_vars)
    loss = st._loss(state, tmesh.shard_batch(_sup_batch(kw["crop_height"]), mesh))
    grads = tmesh.all_reduce_mean(list(torch.autograd.grad(loss, st.params())), mesh)
    with torch.no_grad():
        for p, g in zip(st.params(), grads):
            p.copy_(g)
    return {"loss": float(tmesh.mean_metrics({"l": loss.detach()}, mesh)["l"]),
            "grads": weights.flax_variables(st.model)["params"]}


def cyclegan_run(mesh, flax_params, kw=CG_KW) -> dict:
    """3 CycleGAN steps on ``mesh`` from the bridged weights (None: the
    port's own, drawn from seed 0): per-step metrics, the parameters, the
    pools (their slabs gathered)."""
    tt = CycleGANTrainer(Config(**kw), CG_CLASSES, 3, steps_per_epoch=1000, mesh=mesh)
    state = tt.init_state(torch.Generator().manual_seed(0))
    if flax_params is not None:
        weights.load_flax_cyclegan(tt, flax_params)
    state = tmesh.replicate_state(tt, state, mesh)
    out = []
    for b in _cg_batches(kw["crop_height"]):
        state, m = tt.train_step(state, tmesh.shard_batch(b, mesh))
        out.append({k: float(v) for k, v in m.items()})
    pools = [tmesh.gather_slab(p.buffer[:p.count].contiguous(), mesh).float().numpy()
             for p in (state.pool_img, state.pool_lab)]
    return {"metrics": out, "pools": pools,
            "params": {f"{i}.{k}": v.detach().float().numpy()
                       for i, net in enumerate(tt.nets()) for k, v in net.state_dict().items()}}


def run_cfg(root: str, **kw) -> Config:
    """The runner's --testing configuration on the checkpoint under ``root``."""
    return Config(**{**RUN_KW, "checkpoint_dir": f"{root}/ckpt", "results_dir": f"{root}/res",
                     **kw})


def on_the_mesh(refs: dict, run_root: str) -> dict:
    torch.set_num_threads(1)
    mesh = tmesh.make_mesh(spatial=S_RANKS, device="cpu")
    assert (mesh.dp, mesh.spatial) == (WORLD // S_RANKS, S_RANKS)
    modules, canvases = spatial_cases(mesh, refs["eval_params"], refs["in_jax"])
    test = runner.run_test(run_cfg(run_root, num_devices=WORLD, spatial_shards=S_RANKS),
                           device="cpu")
    return {"modules": modules, "canvases": canvases,
            "supervised": supervised_grads(mesh, refs["sup_vars"]),
            "supervised_unet": supervised_grads(mesh, refs["sup_unet_vars"], SUP_UNET_KW),
            "cyclegan": cyclegan_run(mesh, refs["cg_params"]),
            "cyclegan_unet": cyclegan_run(mesh, None, CG_UNET_KW), "run_test": test}


@pytest.fixture(scope="module")
def references():
    """JAX: the supervised value_and_grad and the CycleGAN step's metrics,
    unsharded, each from its own initial weights."""
    import jax
    import jax.numpy as jnp

    from cyclegan_tpu.train import losses
    from cyclegan_tpu.train.cyclegan import CycleGANTrainer as JaxCG
    from cyclegan_tpu.train.supervised import SupervisedTrainer as JaxSup
    from cyclegan_tpu.utils import config as jconfig

    from cyclegan_tpu import eval_tile as jtile
    from cyclegan_tpu import tta as jtta
    from cyclegan_tpu.kernels.instance_norm import instance_norm_act as jax_in_act
    from cyclegan_tpu.models.generators import ResnetGenerator as JaxResnet

    def supervised(kw):
        js = JaxSup(jconfig.Config(**kw), num_classes=SUP_CLASSES, in_channels=3,
                    steps_per_epoch=4)
        params = jax.device_get(js.init_state(jax.random.PRNGKey(0)).params)

        def loss_fn(p, b):
            return losses.cross_entropy_loss(js.model.apply(p, b["image"]), b["label"])

        b = {k: jnp.asarray(v) for k, v in _sup_batch(kw["crop_height"]).items()}
        loss, grads = jax.jit(jax.value_and_grad(loss_fn))(params, b)
        return params, float(loss), jax.device_get(grads)

    params, loss, grads = supervised(SUP_KW)
    unet_params, unet_loss, unet_grads = supervised(SUP_UNET_KW)

    gen = JaxResnet(5, 8, n_blocks=2, head="none")
    canvas = jnp.asarray(_eval_canvas().numpy())
    eval_params = jax.device_get(gen.init(jax.random.PRNGKey(3), canvas[:1, :16, :16]))

    def net(p, x):
        return gen.apply(p, x)

    def tiled(p, x):
        return jtile.tiled_logits(net, p, x, EVAL_WINDOW)

    eval_jax = {"tile_flip_scales": jtta.scale_avg(jtta.flip_avg(tiled), EVAL_SCALES),
                "flip_scales": jtta.scale_avg(jtta.flip_avg(net), EVAL_SCALES)}
    eval_jax = {k: np.asarray(f(eval_params, canvas)) for k, f in eval_jax.items()}

    # The instance norm of a whole plane, its Pallas kernels in interpret
    # mode, as the JAX package's own CPU tests run them.
    in_jax = {k: _randn(40 + i, 2, 12, 10, 16).numpy()
              for i, k in enumerate(("x", "skip", "ct"))}
    y, vjp = jax.vjp(lambda a, b: jax_in_act(a, b, 1e-5, "relu", True),
                     jnp.asarray(in_jax["x"]), jnp.asarray(in_jax["skip"]))
    in_jax.update(y=np.asarray(y), dx=np.asarray(vjp(jnp.asarray(in_jax["ct"]))[0]))

    jt = JaxCG(jconfig.Config(**dict(CG_KW, gen_net="resnet_6blocks")), CG_CLASSES, 3,
               steps_per_epoch=1000)
    jt.G_i2l = jt.G_i2l.clone(n_blocks=2)
    jt.G_l2i = jt.G_l2i.clone(n_blocks=2)
    state = jt.init_state(jax.random.PRNGKey(0))
    cg_params = jax.device_get({k: getattr(state, k) for k in ("g_i2l", "g_l2i", "d_img",
                                                               "d_lab")})
    step = jax.jit(jt.train_step)
    metrics = []
    for batch in _cg_batches():
        state, m = step(state, {k: jnp.asarray(v) for k, v in batch.items()})
        metrics.append({k: float(v) for k, v in m.items()})
    return {"sup_vars": params, "sup_loss": loss, "sup_grads": grads,
            "sup_unet_vars": unet_params, "sup_unet_loss": unet_loss,
            "sup_unet_grads": unet_grads, "eval_params": eval_params, "eval_jax": eval_jax,
            "in_jax": in_jax,
            "cg_params": cg_params, "cg_metrics": metrics}


@pytest.fixture(scope="module")
def run_root(tmp_path_factory) -> str:
    """A CycleGAN checkpoint (the port's initial state) for --testing."""
    root = str(tmp_path_factory.mktemp("run"))
    cfg = run_cfg(root)
    t = CycleGANTrainer(cfg, 21, 3, steps_per_epoch=1, device="cpu")
    state = t.init_state(torch.Generator().manual_seed(cfg.seed))
    ck.CheckpointManager(cfg.checkpoint_dir).save(0, ck.state_payload(t, state))
    return root


@pytest.fixture(scope="module")
def mesh4(references, run_root, tmp_path_factory):
    """Every case on dp 2 x spatial 2, in one spawn of four gloo ranks."""
    refs = {k: references[k] for k in ("sup_vars", "sup_unet_vars", "eval_params",
                                       "cg_params", "in_jax")}
    with pytest.MonkeyPatch.context() as mp:
        mp.setenv(distributed.TIMEOUT_ENV, "120")
        mp.setenv("OMP_NUM_THREADS", "1")
        out = distributed.launch_local(
            on_the_mesh, (refs, run_root), nprocs=WORLD, world=WORLD, device="cpu",
            init_method=f"file://{tmp_path_factory.mktemp('mesh4')}/store")
    assert multiprocessing.active_children() == []
    return out


@pytest.mark.parametrize("case", CASE_NAMES)
def test_slab_matches_the_whole_plane(mesh4, case):
    got = mesh4["modules"]
    assert got[case] <= TOL, " ".join(f"{k}={v:.3g}" for k, v in got.items())


def _flat(tree, prefix=""):
    if isinstance(tree, dict):
        out = {}
        for k, v in tree.items():
            out.update(_flat(v, f"{prefix}/{k}"))
        return out
    return {prefix: np.asarray(tree)}


def _assert_jax_loss_and_grads(got: dict, ref_loss: float, ref_grads) -> None:
    assert abs(got["loss"] - ref_loss) <= 5e-5 * abs(ref_loss)
    g, r = _flat(got["grads"]), _flat(ref_grads["params"])
    assert g.keys() == r.keys() and r
    for k in r:
        err = np.abs(g[k] - r[k]).max() / max(1.0, float(np.abs(r[k]).max()))
        assert err <= 5e-5, (k, err)


def test_supervised_dp2_spatial2_gives_jax_unsharded_loss_and_gradients(mesh4, references):
    _assert_jax_loss_and_grads(mesh4["supervised"], references["sup_loss"],
                               references["sup_grads"])


def test_supervised_unet_dp2_spatial2_gives_jax_unsharded_loss_and_gradients(mesh4, references):
    _assert_jax_loss_and_grads(mesh4["supervised_unet"], references["sup_unet_loss"],
                               references["sup_unet_grads"])


def _one_process(cg_params, kw=CG_KW) -> dict:
    torch.set_num_threads(2)
    return cyclegan_run(tmesh.Mesh(torch.device("cpu")), cg_params, kw)


def test_cyclegan_unet_spatial2_matches_one_process(mesh4):
    got, ref = mesh4["cyclegan_unet"], _one_process(None, CG_UNET_KW)
    for s in range(STEPS):
        for k in ("g_total", "d_total"):
            np.testing.assert_allclose(got["metrics"][s][k], ref["metrics"][s][k], rtol=2e-3,
                                       err_msg=f"step {s + 1}")
    for k in ref["params"]:
        np.testing.assert_allclose(got["params"][k], ref["params"][k], atol=2e-3, err_msg=k)
    for a, b in zip(got["pools"], ref["pools"]):
        assert a.shape == b.shape
        np.testing.assert_allclose(a, b, atol=2e-3)


@pytest.mark.parametrize("which", EVAL_CASES)
def test_slab_evaluations_match_jax(mesh4, references, which):
    """The canvas logits gathered from the slabs against JAX's tiled and
    scaled logits of the whole canvas on the same weights."""
    got, ref = mesh4["canvases"][which], references["eval_jax"][which]
    assert got.shape == ref.shape == (2, *EVAL_CANVAS, 5)
    assert np.abs(got - ref).max() / max(1.0, np.abs(ref).max()) <= TOL


def test_runner_testing_spatial2_gives_one_process_confusion(mesh4, run_root):
    one = runner.run_test(run_cfg(run_root, results_dir=f"{run_root}/res1"), device="cpu")
    two = mesh4["run_test"]
    assert np.asarray(one["confusion"]).sum() > 0
    assert two["confusion"] == one["confusion"]
    assert two["miou"] == one["miou"]


def test_cyclegan_spatial2_matches_one_process(mesh4, references):
    got, ref = mesh4["cyclegan"], _one_process(references["cg_params"])
    gm, rm = got["metrics"], ref["metrics"]
    for k in rm[0]:
        np.testing.assert_allclose(gm[0][k], rm[0][k], rtol=1e-5, err_msg=f"step 1 {k}")
    for s in range(1, STEPS):
        for k in ("g_total", "d_total"):
            np.testing.assert_allclose(gm[s][k], rm[s][k], rtol=2e-3, err_msg=f"step {s + 1}")
    for k in ref["params"]:
        np.testing.assert_allclose(got["params"][k], ref["params"][k], atol=2e-3, err_msg=k)
    for a, b in zip(got["pools"], ref["pools"]):
        assert a.shape == b.shape
        np.testing.assert_allclose(a, b, atol=2e-3)


def test_cyclegan_spatial2_matches_jax(mesh4, references):
    got, ref = mesh4["cyclegan"]["metrics"], references["cg_metrics"]
    assert len(got) == len(ref) == STEPS
    for s, (g, r) in enumerate(zip(got, ref)):
        np.testing.assert_allclose(g["g_total"], r["g_total"], rtol=2e-3, err_msg=f"step {s}")
        np.testing.assert_allclose(g["d_total"], r["d_total"], rtol=2e-3, atol=1e-3,
                                   err_msg=f"step {s}")



# ---------------------------------------------------------------- geometry
def test_slab_rows_cover_every_row_once_and_uneven_tails_shrink():
    for h, s in ((32, 2), (31, 2), (30, 4), (3, 4), (256, 2)):
        parts = [S.slab(h, s, p) for p in range(s)]
        assert parts[0][0] == 0 and parts[-1][1] == h
        assert all(a[1] == b[0] for a, b in zip(parts, parts[1:]))
    assert [S.slab(3, 4, p) for p in range(4)] == [(0, 1), (1, 2), (2, 3), (3, 3)]
    # The PatchGAN's rows at H = 256: 128, 64, 32, then 31 and 30.
    d = define_Dis(3, 8)
    rows = [256]
    for b in d.blocks:
        rows.append(b.out_rows(rows[-1]))
    assert rows == [256, 128, 64, 32, 31, 30]
    assert [S.slab(31, 2, p) for p in range(2)] == [(0, 16), (16, 31)]


@pytest.mark.parametrize("downs,s", [(7, 2), (8, 2), (8, 3), (8, 4)])
def test_unet_skip_halves_own_the_same_rows(downs, s):
    """Each U-Net level's transposed convolution gives every rank the rows
    of the level's input that it owns (so ``cat([x, up])`` stays local),
    down to the innermost 1-row plane, where a rank may own none."""
    h = 2 ** downs
    planes = []
    while h > 1:
        inner = S.conv_out_rows(h, 4, 2, 1)
        assert S.deconv_out_rows(inner, 4, 2, 1, 0) == h
        for p in range(s):
            lo, hi = S.slab(h, s, p)
            _, _, count = S.deconv_source_rows(inner, 4, 2, 1, 0, s, p)
            assert count == hi - lo
        planes.append(inner)
        h = inner
    assert planes[-1] == 1 and S.slab(1, s, s - 1) == (1, 1)


def test_source_rows_reflect_pad_and_take_the_halo():
    # Reflect 3x3 on 8 rows over 2 ranks: rank 0 needs row 1 above (the
    # reflection of row -1) and row 4 below; rank 1 row 3 above and row 6.
    assert S.conv_source_rows(8, 3, 1, 1, "reflect", 2, 0) == (1, 0, 1, 2, 3, 4)
    assert S.conv_source_rows(8, 3, 1, 1, "reflect", 2, 1) == (3, 4, 5, 6, 7, 6)
    assert S.conv_source_rows(8, 3, 2, 1, "zero", 2, 1) == (3, 4, 5, 6, 7)
    assert S.conv_source_rows(8, 3, 2, 1, "zero", 2, 0) == (-1, 0, 1, 2, 3)
    # The transposed k3 s2 p1 op1: one halo row from below, zero at the end.
    assert S.deconv_source_rows(4, 3, 2, 1, 1, 2, 0) == ((0, 1, 2), 1, 4)
    assert S.deconv_source_rows(4, 3, 2, 1, 1, 2, 1) == ((2, 3, -1), 1, 4)
    plan = S.gather_plan(8, 0, tuple(S.conv_source_rows(8, 3, 1, 1, "reflect", 2, q)
                                     for q in range(2)))
    assert plan.remote_pos == (5,) and plan.lmax == 1 and plan.send_src == (3,)


def test_mesh_layout_is_data_major():
    m = tmesh.Mesh(torch.device("cpu"), 5, 8, spatial=2)
    assert (m.dp, m.data_index, m.spatial_index) == (4, 2, 1)
    b = {"image": np.arange(4 * 8 * 2 * 1, dtype=np.float32).reshape(4, 8, 2, 1),
         "pool_idx_img": np.arange(4)}
    got = tmesh.shard_batch(b, m)
    np.testing.assert_array_equal(got["image"].numpy(), b["image"][2:3, 4:8])
    np.testing.assert_array_equal(got["pool_idx_img"].numpy(), b["pool_idx_img"])
