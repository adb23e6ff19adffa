"""Training traffic: ``CycleGANTrainer.train_step`` back to back, one job.

The configuration's ``batch_size`` rows a step, fed from a ring of
``params['ring']`` distinct batches made from the seed on the device, with
their pool decisions drawn per row (``portbench.inputs``). Set-up builds
the trainer and its state, loads the seeded weights, fills both replay
pools with the seed's contents (so the first step already swaps), steps
both LambdaLRs to update ``first_update`` (past the decay edge, so the
check's updates run at a factor under 1), seeds the dropout generator,
and takes the first ``check_steps`` steps through the window's
own call and feed, reading what the check compares: each step's losses,
the first gradient of every leaf (from Adam's first moment after step 1),
and every leaf's change after the last of them. The window then goes on
with the same trainer and state.

Window (``--trace 0``): steps back to back for ``--seconds``, then a
synchronize; ``train_samples_per_s`` is rows over the window's whole time.
Traced run (``--trace 1``): ``host_probes`` steps each from an idle
device, host-timed, then as many again with the program's spans recorded
(the span probes), then ``trace_steps`` steps under the profiler, spans
recorded. The window records none.
"""

from __future__ import annotations

import dataclasses
import gc
import time
import warnings

import numpy as np
import torch

from portbench import compare, inputs, readings
from portbench import spans as S
from portbench import trace as T
from portbench.reference import precise
from portbench.reference.precision import EXACT
from portbench.reference.train import BETAS, LOSS_KEYS, ReferenceTrainer
from portbench.work import calls, model

NETS = ("G_i2l", "G_l2i", "D_img", "D_lab")


def port_config(cfg: dict):
    from cyclegan_tpu_torch.utils.config import Config

    names = {f.name for f in dataclasses.fields(Config)}
    return Config(**{k: v for k, v in cfg.items() if k in names})


@dataclasses.dataclass
class Inputs:
    """What the seed gives both sides: weights, the ring of batches, the
    pools' contents before the first step, each slot's pool decisions, and
    the seed of the dropout masks."""
    weights: dict
    ring: list
    pools: tuple
    decisions: list
    drop_seed: int


def make_inputs(ctx) -> Inputs:
    gen = torch.Generator(device=ctx.device).manual_seed(ctx.seed)
    weights = inputs.make_weights(ctx.cfg, gen)
    ring = inputs.make_batches(ctx.cfg, ctx.params, gen)
    pools = inputs.make_pools(ctx.cfg, ctx.params, gen)
    rng = np.random.default_rng(ctx.seed)
    decisions = inputs.pool_decisions(ctx.cfg, ctx.params["ring"], rng)
    return Inputs(weights, ring, pools, decisions, int(rng.integers(0, 2 ** 62)))


@dataclasses.dataclass
class Program:
    trainer: object
    state: object
    ring: list
    decisions: list
    steps: int = 0

    def step(self):
        i = self.steps % len(self.ring)
        self.state, metrics = self.trainer.train_step(
            self.state, {**self.ring[i], **self.decisions[i]})
        self.steps += 1
        return metrics


def _leaves(trainer):
    for net, module in zip(NETS, trainer.nets()):
        for name, p in module.named_parameters():
            yield net, name, p


def setup(ctx) -> tuple[Program, dict]:
    """The program on the seed's inputs, after its first ``check_steps``
    steps, and what those steps read."""
    from cyclegan_tpu_torch.kernels import _build
    from cyclegan_tpu_torch.train.cyclegan import CycleGANTrainer

    cfg, dev = ctx.cfg, ctx.device
    if dev.type == "cuda":
        _build.build_all()
    ctx.mark("kernels built")
    ins = make_inputs(ctx)
    weights = ins.weights
    ctx.mark("inputs")
    trainer = CycleGANTrainer(port_config(cfg), cfg["num_classes"], cfg["in_channels"],
                              cfg["steps_per_epoch"], device=dev)
    state = trainer.init_state(torch.Generator().manual_seed(ctx.seed))
    for net, module in zip(NETS, trainer.nets()):
        inputs.load_into(module, weights[net], net)
    state.dropout.manual_seed(ins.drop_seed)
    start_at(state, ins.pools, ctx.params["first_update"])
    prog = Program(trainer, state, ins.ring, ins.decisions)
    ctx.mark("trainer")
    losses, grads = [], None
    for t in range(ctx.params["check_steps"]):
        m = prog.step()
        losses.append(dict(zip(LOSS_KEYS, torch.stack([m[k].float() for k in LOSS_KEYS])
                               .tolist())))
        if t == 0:
            grads = _adam_first_grads(trainer, prog.state)
    change = {f"{net}.{name}": v for (net, name, _), v in zip(
        _leaves(trainer), torch.stack([(p.detach() - weights[net][name]).norm()
                                       for net, name, p in _leaves(trainer)]).tolist())}
    return prog, {"losses": losses, "grads": grads, "change": change}


def start_at(state, pools: tuple, update: int) -> None:
    """The state a run has ``update`` updates in: both pools full with the
    seed's contents, and both LambdaLRs stepped ``update`` times by their
    own rule (Adam's moments stay fresh, as on both sides)."""
    for name, fill in zip(("pool_img", "pool_lab"), pools):
        pool = getattr(state, name)
        pool.buffer.copy_(fill)
        setattr(state, name, pool._replace(count=pool.buffer.shape[0]))
    with warnings.catch_warnings():
        warnings.simplefilter("ignore")  # stepped before any optimizer step
        for _ in range(update):
            state.g_sched.step()
            state.d_sched.step()


def _adam_first_grads(trainer, state) -> dict:
    """Each leaf's first gradient as its Adam got it: m_1 / (1 - beta1);
    a leaf Adam holds no state for reads 0."""
    opts = {"G_i2l": state.g_opt, "G_l2i": state.g_opt, "D_img": state.d_opt,
            "D_lab": state.d_opt}
    names, norms = [], []
    for net, name, p in _leaves(trainer):
        m = opts[net].state.get(p, {}).get("exp_avg")
        names.append(f"{net}.{name}")
        norms.append(m.norm() / (1 - BETAS[0]) if m is not None else p.new_zeros(()))
    return dict(zip(names, torch.stack(norms).tolist()))


def sync(dev) -> None:
    if dev.type == "cuda":
        torch.cuda.synchronize(dev)


def window(prog: Program, ctx) -> dict:
    rows = ctx.cfg["batch_size"]
    t0 = time.perf_counter()
    deadline, n = t0 + ctx.seconds, 0
    while time.perf_counter() < deadline:
        prog.step()
        n += 1
    sync(ctx.device)
    return {"steps": n, "train_samples_per_s": n * rows / (time.perf_counter() - t0)}


def probes(prog: Program, n: int, dev) -> list:
    """``n`` steps each from an idle device: the host ms until each returns."""
    host = []
    for _ in range(n):
        sync(dev)
        t = time.perf_counter()
        prog.step()
        host.append((time.perf_counter() - t) * 1e3)
    return host


def traced(prog: Program, ctx) -> tuple[readings.Observation, int]:
    from cyclegan_tpu_torch.kernels import _build

    dev, p = ctx.device, ctx.params
    host = probes(prog, p["host_probes"], dev)
    with S.recorded() as take:
        probes(prog, p["host_probes"], dev)
        sync(dev)
        probe_spans = take()
        before = dict(_build.launches)
        with torch.profiler.profile(activities=T.activities(dev)) as prof:
            s0 = time.time_ns()
            for _ in range(p["trace_steps"]):
                prog.step()
            sync(dev)
            s1 = time.time_ns()
        spans = take()
    launched = {k: v - before.get(k, 0) for k, v in _build.launches.items()}
    obs = readings.Observation(
        trace=T.from_profiler(prof, s0, s1), units=p["trace_steps"], launches=launched,
        calls=calls.train_step_calls(ctx.cfg), model_flops=model.train_step_flops(ctx.cfg),
        host_ms=host, spans=spans, span_calls=S.from_profiler(prof, s0, s1),
        probe_spans=probe_spans)
    return obs, 2 * p["host_probes"] + p["trace_steps"]


def reference_readings(ctx, q=EXACT, rows: int | None = None) -> dict:
    """The reference's readings of the seed's first ``check_steps`` steps,
    in precision ``q``, on the first ``rows`` rows of each batch (all by
    default; fewer is the half-batch fault)."""
    ins = make_inputs(ctx)
    weights = ins.weights
    with precise():
        ref = ReferenceTrainer(ctx.cfg, weights, q=q, drop_seed=ins.drop_seed,
                               pools=ins.pools, first_update=ctx.params["first_update"],
                               device=ctx.device)
        losses, grads = [], None
        for t in range(ctx.params["check_steps"]):
            b, d = ins.ring[t % len(ins.ring)], ins.decisions[t % len(ins.ring)]
            if rows is not None:
                b = {k: v[:rows] for k, v in b.items()}
                d = {k: v[:rows] for k, v in d.items()}
            step_losses, g_grads, d_grads = ref.step(b, d)
            losses.append(step_losses)
            if t == 0:
                grads = {k: float(v.norm()) for k, v in {**g_grads, **d_grads}.items()}
            del g_grads, d_grads
        change = {}
        for leaf, p in ref.leaves().items():
            net, name = leaf.split(".", 1)
            change[leaf] = float((p.detach() - weights[net][name]).norm())
    return {"losses": losses, "grads": grads, "change": change}


def numbers(prog: dict, ref: dict) -> dict:
    return compare.train_numbers(prog, ref, LOSS_KEYS)


def detail(prog: dict, ref: dict) -> dict:
    return compare.train_detail(prog, ref, LOSS_KEYS)


def free(dev) -> None:
    gc.collect()
    if dev.type == "cuda":
        torch.cuda.empty_cache()


def run(ctx) -> dict:
    prog, prog_readings = setup(ctx)
    ctx.mark("check steps")
    ctx.window_open()
    out = {"failed": 0}
    if ctx.trace:
        out["obs"], out["attempted"] = traced(prog, ctx)
    else:
        w = window(prog, ctx)
        out["e2e"], out["attempted"] = w, w["steps"]
    dev = ctx.device
    out["memory_peak_bytes"] = torch.cuda.max_memory_allocated(dev) if dev.type == "cuda" else 0
    del prog
    free(dev)
    ctx.mark("window")
    nums = numbers(prog_readings, reference_readings(ctx))
    out["correct"], out["checks"] = compare.verdict(nums, ctx.limits)
    return out
