"""Data parallelism of the port (``cyclegan_tpu_torch/parallel``), on the CPU.

Two gloo ranks, spawned through the port's own launcher
(``parallel.distributed.launch_local``) with a ``file://`` store in the
test's directory, hold the port's dp=2 step (ngf 8, ndf 8, 5 classes,
32x32, 2 trunk blocks, float32, global batch 2, pools of 2 with injected
decisions):
- against the JAX step jitted over ``make_mesh(2)`` of the suite's CPU
  devices, on the same bridged weights and global batch: ``g_total`` within
  rtol 2e-3 and ``d_total`` within rtol 1e-2 / atol 1e-3 over 3 steps (the
  bars of ``tests/test_train_parity.py``);
- against the port's own one-process run at the same global batch: every
  step-1 metric within rtol 1e-5 (``dryrun_multichip``'s bar), then
  ``g_total``/``d_total`` within rtol 2e-3, every parameter and both pools
  within 2e-3 after 3 steps; also under ``steps_per_call 2``,
  ``grad_accum 2`` and dropout (path B, masks of the global batch);
- the supervised step under ``--norm batch``: loss and running statistics
  within 5e-5 after step 1 and 2e-3 after 3 (global batch statistics).

The loaders' shards (0, 2) and (1, 2), put together, are bitwise the
(0, 1) batch. One spawn of two ranks runs every case (a module fixture);
the ranks import this module without JAX (JAX is imported by the fixture
in the parent), and no rank outlives its test.
"""

from __future__ import annotations

import multiprocessing

import numpy as np
import pytest
import torch

from cyclegan_tpu_torch import weights
from cyclegan_tpu_torch.data import datasets as tds
from cyclegan_tpu_torch.data import loader as tloader
from cyclegan_tpu_torch.data.grain_loader import GrainLoader
from cyclegan_tpu_torch.ops import blocks
from cyclegan_tpu_torch.parallel import distributed
from cyclegan_tpu_torch.parallel import mesh as tmesh
from cyclegan_tpu_torch.train.cyclegan import CycleGANTrainer
from cyclegan_tpu_torch.train.supervised import SupervisedTrainer
from cyclegan_tpu_torch.utils.config import Config

N_CLASSES, SIZE, NGF, NB, GLOBAL_B, POOL, STEPS = 5, 32, 8, 2, 2, 2, 3
CFG_KW = dict(gen_net=f"resnet_{NB}blocks", ngf=NGF, ndf=NGF, crop_height=SIZE,
              crop_width=SIZE, bf16=False, epochs=200, decay_epoch=100, batch_size=GLOBAL_B,
              pool_size=POOL)


@pytest.fixture(autouse=True, scope="module")
def _few_torch_threads():
    n = torch.get_num_threads()
    torch.set_num_threads(2)
    yield
    torch.set_num_threads(n)


@pytest.fixture(autouse=True)
def _no_child_left_behind():
    yield
    assert multiprocessing.active_children() == []


def _spawn(fn, args, tmp_path, world=2):
    """``fn(*args)`` on ``world`` gloo ranks; a collective that waits two
    minutes fails its rank (and the launch)."""
    with pytest.MonkeyPatch.context() as mp:
        mp.setenv(distributed.TIMEOUT_ENV, "120")
        return distributed.launch_local(fn, args, nprocs=world, world=world, device="cpu",
                                        init_method=f"file://{tmp_path}/store")


def _batches(steps: int, stack: int = 1, seed: int = 5) -> list[dict]:
    """Global host batches with injected pool decisions ((B,) vectors of
    the global batch; a leading stack axis when ``stack`` > 1)."""
    r = np.random.default_rng(seed)
    lead = (stack,) if stack > 1 else ()
    out = []
    for _ in range(steps):
        lab = r.integers(0, N_CLASSES, (*lead, GLOBAL_B, SIZE, SIZE)).astype(np.int32)
        lab[..., :3 + int(r.integers(0, 5)), :] = 255  # void borders, unequal per row
        lab[..., 1, :2 + int(r.integers(0, 9)), :] = 255
        out.append({
            "lab_image": r.uniform(-1, 1, (*lead, GLOBAL_B, SIZE, SIZE, 3)).astype(np.float32),
            "unlab_image": r.uniform(-1, 1, (*lead, GLOBAL_B, SIZE, SIZE, 3)).astype(np.float32),
            "lab_label": lab,
            "pool_use_new_img": r.random((*lead, GLOBAL_B)) > 0.5,
            "pool_idx_img": r.integers(0, POOL, (*lead, GLOBAL_B)).astype(np.int32),
            "pool_use_new_lab": r.random((*lead, GLOBAL_B)) > 0.5,
            "pool_idx_lab": r.integers(0, POOL, (*lead, GLOBAL_B)).astype(np.int32)})
    return out


def _numpy_params(trainer) -> dict:
    return {f"{i}.{k}": v.detach().float().numpy()
            for i, net in enumerate(trainer.nets()) for k, v in net.state_dict().items()}


def cyclegan_run(cfg_kw: dict, batches: list[dict], flax_params=None) -> dict:
    """A CycleGAN trainer on this rank (seed 0, or the bridged Flax
    weights), its step on each global batch's rows; the metrics of every
    step, the parameters and the pools (from rank 0)."""
    torch.set_num_threads(2)
    cfg = Config(**cfg_kw)
    mesh = tmesh.make_mesh(device="cpu")
    tt = CycleGANTrainer(cfg, N_CLASSES, 3, steps_per_epoch=1000, mesh=mesh)
    state = tt.init_state(torch.Generator().manual_seed(0))
    if flax_params is not None:
        weights.load_flax_cyclegan(tt, flax_params)
    state = tmesh.replicate_state(tt, state, mesh)
    step = tmesh.select_step(tt, cfg.steps_per_call, cfg.grad_accum)
    stacked = cfg.steps_per_call > 1 or cfg.grad_accum > 1
    out = []
    for b in batches:
        state, m = step(state, tmesh.shard_batch(b, mesh, leading_stack=stacked))
        out.append({k: float(v) for k, v in m.items()})
    return {"metrics": out, "params": _numpy_params(tt),
            "pools": [p.buffer[:p.count].float().numpy()
                      for p in (state.pool_img, state.pool_lab)]}


def supervised_run(cfg_kw: dict, batches: list[dict]) -> dict:
    """A supervised trainer on this rank; per-step loss and the batch
    norms' running averages."""
    torch.set_num_threads(2)
    cfg = Config(**cfg_kw)
    mesh = tmesh.make_mesh(device="cpu")
    st = SupervisedTrainer(cfg, N_CLASSES, 3, steps_per_epoch=1000, mesh=mesh)
    state = tmesh.replicate_state(st, st.init_state(torch.Generator().manual_seed(0)), mesh)
    losses, stats = [], []
    for b in batches:
        state, m = st.train_step(state, tmesh.shard_batch(b, mesh))
        losses.append(float(m["ce_loss"]))
        stats.append({k: v.clone().numpy() for k, v in st.model.state_dict().items()
                      if "running" in k})
    return {"losses": losses, "stats": stats}


CASES = {  # name -> (run, config overrides, batches' stack)
    "train_step": ("cyclegan", {}, 1), "steps_per_call": ("cyclegan", {"steps_per_call": 2}, 2),
    "grad_accum": ("cyclegan", {"grad_accum": 2}, 2),
    "dropout": ("cyclegan", {"use_dropout": True}, 1),
    "batch_norm": ("supervised", {"norm": "batch", "pool_size": 0}, 1)}


def _case_args(name: str) -> tuple[dict, list[dict]]:
    run, extra, stack = CASES[name]
    batches = _batches(STEPS if stack == 1 else 2, stack)
    if run == "supervised":
        batches = [{"image": b["lab_image"], "label": b["lab_label"]} for b in batches]
    return dict(CFG_KW, **extra), batches


def every_case(flax_params) -> dict:
    """Each rank: the JAX-weights run, then every case of :data:`CASES`."""
    out = {"jax": cyclegan_run(CFG_KW, _batches(STEPS), flax_params)}
    for name, (run, _, _) in CASES.items():
        out[name] = (cyclegan_run if run == "cyclegan" else supervised_run)(*_case_args(name))
    return out


@pytest.fixture(scope="module")
def jax_reference():
    """The JAX step jitted over a 2-device mesh of the suite's CPU devices
    on its own initial weights: (Flax param trees, per-step metrics)."""
    import jax
    import jax.numpy as jnp

    from cyclegan_tpu.parallel import mesh as jmesh
    from cyclegan_tpu.train.cyclegan import CycleGANTrainer as JaxTrainer
    from cyclegan_tpu.utils import config as jconfig

    jcfg = jconfig.Config(**dict(CFG_KW, gen_net="resnet_6blocks"))
    jt = JaxTrainer(jcfg, N_CLASSES, 3, steps_per_epoch=1000)
    jt.G_i2l = jt.G_i2l.clone(n_blocks=NB)
    jt.G_l2i = jt.G_l2i.clone(n_blocks=NB)
    js = jt.init_state(jax.random.PRNGKey(0))
    flax_params = jax.device_get({k: getattr(js, k) for k in ("g_i2l", "g_l2i", "d_img",
                                                              "d_lab")})
    m = jmesh.make_mesh(2)
    js = jmesh.replicate_state(js, m)
    step = jax.jit(jt.train_step)
    ref = []
    for b in _batches(STEPS):
        js, jm = step(js, jmesh.shard_batch({k: jnp.asarray(v) for k, v in b.items()}, m))
        ref.append({k: float(v) for k, v in jm.items()})
    return flax_params, ref


@pytest.fixture(scope="module")
def dp2(jax_reference, tmp_path_factory):
    """Every case on two gloo ranks, in one spawn."""
    out = _spawn(every_case, (jax_reference[0],), tmp_path_factory.mktemp("dp2"))
    assert multiprocessing.active_children() == []
    return out


def _close(got: dict, ref: dict, *, first_rtol: float = 1e-5, tol: float = 2e-3):
    gm, rm = got["metrics"], ref["metrics"]
    assert len(gm) == len(rm) and set(gm[0]) == set(rm[0])
    for k in rm[0]:
        np.testing.assert_allclose(gm[0][k], rm[0][k], rtol=first_rtol, err_msg=f"step 1 {k}")
    for s in range(1, len(rm)):
        for k in ("g_total", "d_total"):
            np.testing.assert_allclose(gm[s][k], rm[s][k], rtol=tol, err_msg=f"step {s + 1} {k}")
    assert got["params"].keys() == ref["params"].keys()
    for k in ref["params"]:
        np.testing.assert_allclose(got["params"][k], ref["params"][k], atol=tol, err_msg=k)
    for a, b in zip(got["pools"], ref["pools"]):
        assert a.shape == b.shape
        np.testing.assert_allclose(a, b, atol=tol)


def test_dp2_cyclegan_step_matches_jax_dp2(dp2, jax_reference):
    """Two gloo ranks of the port against the JAX step over a 2-device
    mesh, both on the JAX initial weights."""
    got, ref = dp2["jax"]["metrics"], jax_reference[1]
    assert len(got) == len(ref) == STEPS
    for s, (g, r) in enumerate(zip(got, ref)):
        assert set(g) == set(r)
        np.testing.assert_allclose(g["g_total"], r["g_total"], rtol=2e-3, err_msg=f"step {s}")
        np.testing.assert_allclose(g["d_total"], r["d_total"], rtol=1e-2, atol=1e-3,
                                   err_msg=f"step {s}")


@pytest.mark.parametrize("case", ["train_step", "steps_per_call", "grad_accum", "dropout"])
def test_dp2_cyclegan_matches_one_device(dp2, case):
    _close(dp2[case], cyclegan_run(*_case_args(case)))


def test_dp2_supervised_batch_norm_is_global(dp2):
    got, ref = dp2["batch_norm"], supervised_run(*_case_args("batch_norm"))
    for s, tol in ((0, 5e-5), (STEPS - 1, 2e-3)):
        np.testing.assert_allclose(got["losses"][s], ref["losses"][s], rtol=tol)
        for k, v in ref["stats"][s].items():
            np.testing.assert_allclose(got["stats"][s][k], v, rtol=tol, atol=tol, err_msg=k)


# ---------------------------------------------------------------- loaders
LOADER_CASES = {"train": dict(batch_size=4, crop_hw=(24, 24), train=True, seed=3),
                "eval_ragged": dict(batch_size=4, crop_hw=(24, 24), train=False,
                                    drop_last=False)}


@pytest.mark.parametrize("make", [tloader.Loader, GrainLoader], ids=["native", "grain"])
@pytest.mark.parametrize("case", list(LOADER_CASES))
def test_loader_shards_put_together_are_the_one_process_batch(make, case):
    kw = LOADER_CASES[case]
    ds = tds.make_dataset("synthetic", split="train" if kw["train"] else "val", size=11)
    whole = list(make(ds, **kw).epoch(2))
    shards = [list(make(ds, process_shard=(r, 2), **kw).epoch(2)) for r in range(2)]
    assert len(whole) == len(shards[0]) == len(shards[1]) == (2 if kw["train"] else 3)
    for b, (s0, s1) in zip(whole, zip(*shards)):
        assert b.keys() == s0.keys() == s1.keys()
        for k in b:
            assert s0[k].shape[0] == s1[k].shape[0] == kw["batch_size"] // 2
            np.testing.assert_array_equal(np.concatenate([s0[k], s1[k]]), b[k])


def test_loader_refuses_a_shard_the_batch_does_not_divide():
    ds = tds.make_dataset("synthetic", size=4)
    for make in (tloader.Loader, GrainLoader):
        with pytest.raises(ValueError, match="not divisible"):
            make(ds, batch_size=3, crop_hw=(8, 8), process_shard=(0, 2))
        with pytest.raises(ValueError, match="rank outside"):
            make(ds, batch_size=2, crop_hw=(8, 8), process_shard=(2, 2))


# ---------------------------------------------------------------- mesh pieces
def test_mesh_at_world_one_and_its_refusals():
    m = tmesh.make_mesh(device="cpu")
    assert (m.rank, m.world, m.group) == (0, 1, None)
    assert tmesh.make_mesh(1, device="cpu") == m
    with pytest.raises(ValueError, match="num_devices=2"):
        tmesh.make_mesh(2, device="cpu")
    # The spatial axis must divide the ranks, as the JAX make_mesh's.
    with pytest.raises(ValueError, match="not divisible by spatial=2"):
        tmesh.make_mesh(spatial=2, device="cpu")
    x = torch.arange(6.0)
    assert tmesh.gather_rows(x, m) is x and tmesh.local_rows(x, m) is x
    assert tmesh.all_reduce_sum_grad(x, m) is x and tmesh.all_reduce_sum(x, m) is x
    grads = [torch.ones(3)]
    assert tmesh.all_reduce_mean(grads, m) is grads
    metrics = {"a": torch.tensor(1.0)}
    assert tmesh.mean_metrics(metrics, m) is metrics


def test_shard_batch_takes_rows_and_keeps_pool_decisions_whole():
    b = _batches(1, stack=2)[0]
    for rank in range(2):
        m = tmesh.Mesh(torch.device("cpu"), rank, 2)
        got = tmesh.shard_batch(b, m, leading_stack=True)
        np.testing.assert_array_equal(got["lab_image"].numpy(), b["lab_image"][:, rank:rank + 1])
        assert got["lab_label"].dtype == torch.int64
        for k in ("pool_use_new_img", "pool_idx_lab"):
            np.testing.assert_array_equal(got[k].numpy(), b[k])


def test_buckets_split_by_type_and_size(monkeypatch):
    monkeypatch.setattr(tmesh, "BUCKET_BYTES", 16)
    ts = [torch.zeros(2), torch.zeros(2), torch.zeros(2), torch.zeros(1, dtype=torch.float64),
          torch.zeros(8)]
    assert tmesh._buckets(ts) == [[0, 1], [2], [3], [4]]


def test_dropout_masks_are_the_global_batch_rows():
    """A rank's mask of a concatenation of two batches is its rows of each
    batch in the global mask (the generator seeded alike on every rank)."""
    rows, shape = 2, (4, 3, 3, 5)  # two segments of this rank's 2 rows
    ref = blocks.dropout_keep((2 * 2 * rows, 3, 3, 5), 0.5,
                              torch.Generator().manual_seed(1))
    for rank in range(2):
        m = tmesh.Mesh(torch.device("cpu"), rank, 2)
        got = blocks.dropout_keep_rows(shape, 0.5, torch.Generator().manual_seed(1), m, rows)
        want = torch.cat([ref[s * 2 * rows + rank * rows:s * 2 * rows + (rank + 1) * rows]
                          for s in range(2)])
        assert torch.equal(got, want)
    with pytest.raises(ValueError, match="no whole number"):
        blocks.dropout_keep_rows((3, 3, 3, 5), 0.5, torch.Generator(),
                                 tmesh.Mesh(torch.device("cpu"), 0, 2), 2)


def test_trainers_refuse_a_batch_that_is_not_the_ranks_share():
    with pytest.raises(ValueError, match="does not divide"):
        CycleGANTrainer(Config(**dict(CFG_KW, batch_size=3)), N_CLASSES, 3, 1,
                        mesh=tmesh.Mesh(torch.device("cpu"), 0, 2))
