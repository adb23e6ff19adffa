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
- the slab instance norm's plain versions (forward and VJP) against
  ``instance_norm_act_plain`` on the plane.
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
  atol 1e-3).
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

from cyclegan_tpu_torch import weights
from cyclegan_tpu_torch.kernels import instance_norm as IN
from cyclegan_tpu_torch.models import define_Dis, define_Gen
from cyclegan_tpu_torch.ops import blocks
from cyclegan_tpu_torch.parallel import distributed
from cyclegan_tpu_torch.parallel import mesh as tmesh
from cyclegan_tpu_torch.parallel import spatial as S
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
    """ids of the conv biases an instance norm follows: their gradient is
    zero in exact arithmetic and rounding noise in float."""
    return {id(m.conv.bias) for m in module.modules()
            if isinstance(getattr(m, "norm", None), blocks.InstanceNorm)}


def _compare(module, x: torch.Tensor, mesh: tmesh.Mesh, seed: int, **kw) -> float:
    """Worst error of ``module`` on this rank's slab of ``x`` against the
    whole plane: output rows, input-gradient rows, and parameter gradients
    summed over the ranks."""
    whole = module
    sl = copy.deepcopy(module)
    blocks.set_data_mesh(sl, mesh)
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


def _in_case(mesh: tmesh.Mesh) -> float:
    """The slab instance norm's plain versions (relu, with a skip) against
    instance_norm_act_plain on the plane, forward and VJP."""
    x = _randn(1, 2, 12, 10, 16)
    skip = _randn(2, *x.shape)
    ct = _randn(3, *x.shape)
    xw = x.clone().requires_grad_(True)
    yw = IN.instance_norm_act_plain(xw, skip, 1e-5, "relu")
    (yw * ct).sum().backward()
    lo, hi = S.slab(12, mesh.spatial, mesh.spatial_index)
    xs = x[:, lo:hi].clone().requires_grad_(True)
    norm = blocks.InstanceNorm()
    norm.spatial = S.Spatial(mesh.spatial, mesh.spatial_index, mesh.spatial_group)
    ys = IN.instance_norm_act_slab(xs, skip[:, lo:hi], 1e-5, "relu", norm._gather)
    (ys * ct[:, lo:hi]).sum().backward()
    return max(_err(ys, yw[:, lo:hi]), _err(xs.grad, xw.grad[:, lo:hi]))


def spatial_cases(mesh: tmesh.Mesh) -> dict:
    """Each rank: every module case; the worst error of each over the ranks."""
    torch.manual_seed(0)  # the modules' default initialisation, alike on every rank
    g = torch.Generator().manual_seed(0)
    conv = dict(dtype=torch.float32)
    x16 = _nchw(_randn(10, 2, 8, 16, 12))
    cases = {
        "halo_exchange": lambda: _halo_case(mesh),
        "instance_norm_slab": lambda: _in_case(mesh),
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
    }
    out = {}
    for name, run in cases.items():
        err = torch.tensor([run()], dtype=torch.float64)
        dist.all_reduce(err, op=dist.ReduceOp.MAX)
        out[name] = float(err)
    return out


CASE_NAMES = ["halo_exchange", "instance_norm_slab", "conv_reflect_7x7",
              "conv_trunk_3x3_kernel8", "conv_zero_3x3_stride2", "conv_zero_4x4_stride2",
              "conv_zero_4x4_uneven", "deconv_3x3_stride2", "generator_resnet",
              "generator_resnet_tanh", "patchgan_uneven_tail"]


def _sup_batch() -> dict:
    r = np.random.default_rng(1)
    return {"image": r.uniform(0, 1, (4, SIZE, SIZE, 3)).astype(np.float32),
            "label": r.integers(0, SUP_CLASSES, (4, SIZE, SIZE)).astype(np.int32)}


def _cg_batches() -> list[dict]:
    r = np.random.default_rng(5)
    out = []
    for _ in range(STEPS):
        lab = r.integers(0, CG_CLASSES, (2, SIZE, SIZE)).astype(np.int32)
        lab[:, :3] = 255
        lab[1, :, :5] = 255  # the ranks' valid pixels differ
        out.append({"lab_image": r.uniform(-1, 1, (2, SIZE, SIZE, 3)).astype(np.float32),
                    "unlab_image": r.uniform(-1, 1, (2, SIZE, SIZE, 3)).astype(np.float32),
                    "lab_label": lab, "pool_use_new_img": r.random(2) > 0.5,
                    "pool_idx_img": r.integers(0, 2, 2).astype(np.int32),
                    "pool_use_new_lab": r.random(2) > 0.5,
                    "pool_idx_lab": r.integers(0, 2, 2).astype(np.int32)})
    return out


def supervised_grads(mesh, sup_vars) -> dict:
    """The supervised loss and gradients of the global batch on ``mesh``,
    the gradients as a Flax tree (``weights.flax_variables`` of a net that
    holds them)."""
    st = SupervisedTrainer(Config(**SUP_KW), SUP_CLASSES, 3, steps_per_epoch=4, mesh=mesh)
    state = st.init_state(torch.Generator().manual_seed(0))
    weights.load_flax_module(st.model, sup_vars)
    loss = st._loss(state, tmesh.shard_batch(_sup_batch(), mesh))
    grads = tmesh.all_reduce_mean(list(torch.autograd.grad(loss, st.params())), mesh)
    with torch.no_grad():
        for p, g in zip(st.params(), grads):
            p.copy_(g)
    return {"loss": float(tmesh.mean_metrics({"l": loss.detach()}, mesh)["l"]),
            "grads": weights.flax_variables(st.model)["params"]}


def cyclegan_run(mesh, flax_params) -> dict:
    """3 CycleGAN steps on ``mesh`` from the bridged weights: per-step
    metrics, the parameters, the pools (their slabs gathered)."""
    tt = CycleGANTrainer(Config(**CG_KW), CG_CLASSES, 3, steps_per_epoch=1000, mesh=mesh)
    state = tt.init_state(torch.Generator().manual_seed(0))
    weights.load_flax_cyclegan(tt, flax_params)
    state = tmesh.replicate_state(tt, state, mesh)
    out = []
    for b in _cg_batches():
        state, m = tt.train_step(state, tmesh.shard_batch(b, mesh))
        out.append({k: float(v) for k, v in m.items()})
    pools = [tmesh.gather_slab(p.buffer[:p.count].contiguous(), mesh).float().numpy()
             for p in (state.pool_img, state.pool_lab)]
    return {"metrics": out, "pools": pools,
            "params": {f"{i}.{k}": v.detach().float().numpy()
                       for i, net in enumerate(tt.nets()) for k, v in net.state_dict().items()}}


def on_the_mesh(sup_vars, cg_params) -> dict:
    torch.set_num_threads(1)
    mesh = tmesh.make_mesh(spatial=S_RANKS, device="cpu")
    assert (mesh.dp, mesh.spatial) == (WORLD // S_RANKS, S_RANKS)
    return {"modules": spatial_cases(mesh), "supervised": supervised_grads(mesh, sup_vars),
            "cyclegan": cyclegan_run(mesh, cg_params)}


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

    js = JaxSup(jconfig.Config(**SUP_KW), num_classes=SUP_CLASSES, in_channels=3,
                steps_per_epoch=4)
    params = jax.device_get(js.init_state(jax.random.PRNGKey(0)).params)

    def loss_fn(p, b):
        return losses.cross_entropy_loss(js.model.apply(p, b["image"]), b["label"])

    b = {k: jnp.asarray(v) for k, v in _sup_batch().items()}
    loss, grads = jax.jit(jax.value_and_grad(loss_fn))(params, b)

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
    return {"sup_vars": params, "sup_loss": float(loss), "sup_grads": jax.device_get(grads),
            "cg_params": cg_params, "cg_metrics": metrics}


@pytest.fixture(scope="module")
def mesh4(references, tmp_path_factory):
    """Every case on dp 2 x spatial 2, in one spawn of four gloo ranks."""
    with pytest.MonkeyPatch.context() as mp:
        mp.setenv(distributed.TIMEOUT_ENV, "120")
        mp.setenv("OMP_NUM_THREADS", "1")
        out = distributed.launch_local(
            on_the_mesh, (references["sup_vars"], references["cg_params"]), nprocs=WORLD,
            world=WORLD, device="cpu",
            init_method=f"file://{tmp_path_factory.mktemp('mesh4')}/store")
    assert multiprocessing.active_children() == []
    return out


@pytest.mark.parametrize("case", CASE_NAMES)
def test_slab_matches_the_whole_plane(mesh4, case):
    got = mesh4["modules"]
    assert got[case] <= TOL, {k: f"{v:.3g}" for k, v in got.items()}


def _flat(tree, prefix=""):
    if isinstance(tree, dict):
        out = {}
        for k, v in tree.items():
            out.update(_flat(v, f"{prefix}/{k}"))
        return out
    return {prefix: np.asarray(tree)}


def test_supervised_dp2_spatial2_gives_jax_unsharded_loss_and_gradients(mesh4, references):
    got = mesh4["supervised"]
    assert abs(got["loss"] - references["sup_loss"]) <= 5e-5 * abs(references["sup_loss"])
    g, r = _flat(got["grads"]), _flat(references["sup_grads"]["params"])
    assert g.keys() == r.keys() and r
    for k in r:
        err = np.abs(g[k] - r[k]).max() / max(1.0, float(np.abs(r[k]).max()))
        assert err <= 5e-5, (k, err)


def _one_process(cg_params) -> dict:
    torch.set_num_threads(2)
    return cyclegan_run(tmesh.Mesh(torch.device("cpu")), cg_params)


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
