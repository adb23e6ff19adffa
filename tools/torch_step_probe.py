#!/usr/bin/env python3
"""Why two float32 train steps of a small trainer, kernel path against plain
path, can disagree at step 2 on one CUDA card.

    python3 tools/torch_step_probe.py [--trials 24] [--paths chunked dropout]

The trainer, batch and seed are those of
``tests/test_torch_cuda.py::test_small_train_step_paths_a_and_b_match_plain``
(``resnet_2blocks``, ngf 32, ndf 8, 32x32, float32, no pool; path A with
``CYCLEGAN_TPU_RESBLOCK=chunked`` and hc 4, path B with ``use_dropout``).
Each trial, for each path:

1. ``kernel``: two steps on the kernels from the seeded init; the step-1
   gradient of every parameter and both steps' losses;
2. ``plain``: the same with the seams on the plain versions;
3. the verdict of the test as it was written before it compared each step
   from one state (both steps' losses at rtol 1e-3, atol 1e-4, each path
   from its own step 1);
4. ``flips``: the step-1 gradient elements whose sign differs between the
   two paths (``g_kernel * g_plain < 0``), by parameter;
5. ``plain_flipped``: the plain path again, its step-1 update made from
   run 2's recorded gradients with only those elements' signs flipped, and
   ``plain_replayed``, the same with no flip (the control): the step-2 loss
   gap of each against run 2 says how much of the kernel path's step-2 gap
   the sign flips alone make; and ``plain_vs_plain``, the plain path once
   more from the init, against run 2 (the floor: its order of float32 sums
   changes from run to run). Adam's first update is ``lr * g / (|g| +
   eps)``, about ``lr * sign(g)``, so one flipped sign moves a weight by
   2 lr however small its gradient.

Prints one JSON line per trial and path, then a summary line per path.
With ``--sensitivity NORM`` it prints instead, per path, how far the plain
path's step-1 gradients move when that instance norm's output moves by
1e-8, 1e-7 and 1e-6 of its size (a discontinuous step moves by a lot at
some size and not at all below it).
Imports nothing of JAX or the JAX package.
"""

from __future__ import annotations

import argparse
import contextlib
import json
import os
import sys

HERE = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
LOSS_RTOL, LOSS_ATOL = 1e-3, 1e-4


def _setup(path: str):
    import numpy as np
    import torch

    from cyclegan_tpu_torch.utils.config import Config

    cfg = Config(gen_net="resnet_2blocks", ngf=32, ndf=8, crop_height=32, crop_width=32,
                 bf16=False, pool_size=0, use_dropout=path == "dropout")
    r = np.random.default_rng(0)
    batch = {"lab_image": r.uniform(-1, 1, (1, 32, 32, 3)).astype(np.float32),
             "unlab_image": r.uniform(-1, 1, (1, 32, 32, 3)).astype(np.float32),
             "lab_label": r.integers(0, 5, (1, 32, 32))}
    return cfg, {k: torch.from_numpy(v).cuda() for k, v in batch.items()}


@contextlib.contextmanager
def _route(path: str):
    keys = ("CYCLEGAN_TPU_RESBLOCK", "CYCLEGAN_TPU_RESBLOCK_HC")
    saved = {k: os.environ.pop(k, None) for k in keys}
    if path == "chunked":
        os.environ.update(CYCLEGAN_TPU_RESBLOCK="chunked", CYCLEGAN_TPU_RESBLOCK_HC="4")
    try:
        yield
    finally:
        for k, v in saved.items():
            os.environ.pop(k, None)
            if v is not None:
                os.environ[k] = v


@contextlib.contextmanager
def _plain_seams(plain: bool):
    from cyclegan_tpu_torch.kernels import instance_norm as IN
    from cyclegan_tpu_torch.kernels import resblock_chunked as RC
    from cyclegan_tpu_torch.ops import blocks
    from cyclegan_tpu_torch.ops import functional as OF

    seams = (blocks.instance_norm_act, blocks.residual_block_chunked, OF.conv2d_valid_dw_fused)
    if plain:
        blocks.instance_norm_act = IN.instance_norm_act_reference
        blocks.residual_block_chunked = RC.residual_block_chunked_reference
        OF.conv2d_valid_dw_fused = OF.conv2d_valid_dw_fused_reference
    try:
        yield
    finally:
        blocks.instance_norm_act, blocks.residual_block_chunked, OF.conv2d_valid_dw_fused = seams


def _two_steps(path: str, plain: bool, step1_grads=None):
    """Two steps from the seeded init: (losses of each step, the step-1
    gradients as recorded, one list per update in the order the step makes
    them). ``step1_grads`` replaces the step-1 updates' gradients."""
    import torch

    from cyclegan_tpu_torch.ops import blocks
    from cyclegan_tpu_torch.train.cyclegan import CycleGANTrainer

    cfg, batch = _setup(path)
    with _route(path):
        t = CycleGANTrainer(cfg, 5, 3, 1000, device="cuda")
    for net_name, net in zip(("G_i2l", "G_l2i", "D_img", "D_lab"), t.nets()):
        for name, m in net.named_modules():
            if isinstance(m, blocks.InstanceNorm):
                m.probe_name = f"{net_name}.{name}"
    st = t.init_state(torch.Generator().manual_seed(0))
    recorded = []

    def update(params, grads, opt, sched):
        grads = [g.detach().clone() for g in grads]
        if step1_grads is not None and st.step == 0:
            grads = step1_grads[len(recorded)]
        recorded.append(grads)
        CycleGANTrainer._update(params, grads, opt, sched)

    t._update = update
    losses = []
    with _plain_seams(plain):
        for _ in range(2):
            losses.append({k: float(v) for k, v in t.train_step(st, batch)[1].items()})
    return losses, recorded[:2], t


def _names(t) -> list:
    """Parameter names in the order of the two updates' gradient lists."""
    g = [f"G_i2l.{n}" for n, _ in t.G_i2l.named_parameters()] + \
        [f"G_l2i.{n}" for n, _ in t.G_l2i.named_parameters()]
    d = [f"D_img.{n}" for n, _ in t.D_img.named_parameters()] + \
        [f"D_lab.{n}" for n, _ in t.D_lab.named_parameters()]
    return [g, d]


def _loss_gap(a: list, b: list, step: int) -> float:
    """Worst |a - b| / (atol + rtol |b|) over the losses of ``step``."""
    return max(abs(a[step][k] - b[step][k]) / (LOSS_ATOL + LOSS_RTOL * abs(b[step][k]))
               for k in b[step])


def _pre_norm_biases(t) -> set:
    """Names of the conv biases an instance norm follows: their gradient is
    zero in exact arithmetic, rounding noise in float."""
    return {f"{net_name}.{name}.conv.bias"
            for net_name, net in zip(("G_i2l", "G_l2i", "D_img", "D_lab"), t.nets())
            for name, m in net.named_modules()
            if type(getattr(m, "norm", None)).__name__ == "InstanceNorm"}


def _compare(names, a_grads, b_grads, pre_norm):
    """Sign flips by parameter, the flip masks, and each tensor's
    |a - b| / |b| (the worst over the weights and the biases no instance
    norm follows)."""
    import torch

    flips, masks, rel = {}, [], {}
    for upd in range(2):
        out = []
        for name, ga, gb in zip(names[upd], a_grads[upd], b_grads[upd]):
            mask = (ga * gb) < 0
            if int(mask.sum()):
                flips[name] = int(mask.sum())
            out.append(mask)
            if name not in pre_norm:
                rel[name] = float((ga - gb).norm() / gb.norm())
        masks.append(out)
    worst = max(rel, key=rel.get)
    return flips, masks, [worst, rel[worst]]


def trial(path: str, first: dict) -> dict:
    """One trial of ``path``; ``first`` keeps the first trial's step-1
    gradients of each side, which later trials are held against (does a
    side's gradient change from run to run, and by how much)."""
    import torch

    k_losses, k_grads, t = _two_steps(path, plain=False)
    p_losses, p_grads, _ = _two_steps(path, plain=True)
    p2_losses, p2_grads, _ = _two_steps(path, plain=True)
    names, pre_norm = _names(t), _pre_norm_biases(t)
    flips, masks, worst_rel = _compare(names, k_grads, p_grads, pre_norm)
    flips_pp, _, worst_rel_pp = _compare(names, p2_grads, p_grads, pre_norm)
    first.setdefault("kernel", k_grads)
    first.setdefault("plain", p_grads)
    drift = {side: _compare(names, g, first[side], pre_norm)[2]
             for side, g in (("kernel", k_grads), ("plain", p_grads))}
    flipped = [[torch.where(m, -g, g) for m, g in zip(ms, gs)]
               for ms, gs in zip(masks, p_grads)]
    f_losses = _two_steps(path, plain=True, step1_grads=flipped)[0]
    r_losses = _two_steps(path, plain=True, step1_grads=p_grads)[0]
    return {
        "path": path,
        "old_test_passes": max(_loss_gap(k_losses, p_losses, s) for s in (0, 1)) <= 1.0,
        "kernel_vs_plain_gap_over_bar": [_loss_gap(k_losses, p_losses, s) for s in (0, 1)],
        "sign_flips_total": sum(flips.values()),
        "sign_flips_by_param": flips,
        "plain_flipped_vs_plain_step2_gap_over_bar": _loss_gap(f_losses, p_losses, 1),
        "plain_replayed_vs_plain_step2_gap_over_bar": _loss_gap(r_losses, p_losses, 1),
        "step1_grad_rel_err_worst": worst_rel,
        "plain_vs_plain_sign_flips_total": sum(flips_pp.values()),
        "plain_vs_plain_step2_gap_over_bar": _loss_gap(p2_losses, p_losses, 1),
        "plain_vs_plain_step1_grad_rel_err_worst": worst_rel_pp,
        "kernel_vs_first_trial_step1_grad_rel_err_worst": drift["kernel"],
        "plain_vs_first_trial_step1_grad_rel_err_worst": drift["plain"],
        "losses_kernel": k_losses, "losses_plain": p_losses,
        "losses_plain_flipped": f_losses}


@contextlib.contextmanager
def _perturbed(target: str, eps: float):
    """The output of instance norm ``target`` (``net.module`` name) moved
    by ``eps`` of its mean magnitude, seeded Gaussian noise."""
    import torch

    from cyclegan_tpu_torch.ops import blocks

    forward = blocks.InstanceNorm.forward

    def moved(self, x, act="none", skip=None):
        y = forward(self, x, act, skip)
        if getattr(self, "probe_name", None) != target:
            return y
        g = torch.Generator(device=y.device).manual_seed(1)
        return y + eps * y.detach().abs().mean() * torch.randn(y.shape, device=y.device,
                                                              generator=g)

    blocks.InstanceNorm.forward = moved
    try:
        yield
    finally:
        blocks.InstanceNorm.forward = forward


def sensitivity(path: str, target: str, eps_list) -> dict:
    """How far the plain path's step-1 gradients move when one norm's
    output moves by a relative ``eps``: the worst |g_eps - g| / |g| over
    the weights and the biases no instance norm follows."""
    _, ref, t = _two_steps(path, plain=True)
    names, pre_norm = _names(t), _pre_norm_biases(t)
    out = {"path": path, "norm": target,
           "plain_again": _compare(names, _two_steps(path, plain=True)[1], ref, pre_norm)[2]}
    for eps in eps_list:
        with _perturbed(target, eps):
            out[f"moved_{eps:g}"] = _compare(names, _two_steps(path, plain=True)[1], ref,
                                             pre_norm)[2]
    return out


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--trials", type=int, default=24)
    ap.add_argument("--paths", nargs="+", default=["chunked", "dropout"])
    ap.add_argument("--sensitivity", metavar="NORM",
                    help="instead: move this norm's output (e.g. G_l2i.down1.norm) by "
                         "1e-8, 1e-7 and 1e-6 of its size on the plain path and print how "
                         "far the step-1 gradients move")
    args = ap.parse_args()
    import torch

    if not torch.cuda.is_available():
        print("torch_step_probe: no CUDA device", file=sys.stderr)
        return 1
    sys.path.insert(0, HERE)
    torch.backends.cudnn.allow_tf32 = False
    torch.backends.cuda.matmul.allow_tf32 = False
    if args.sensitivity:
        for path in args.paths:
            print(json.dumps({"result": "sensitivity", **sensitivity(
                path, args.sensitivity, (1e-8, 1e-7, 1e-6))}), flush=True)
        return 0
    for path in args.paths:
        recs, first = [], {}
        for i in range(args.trials):
            rec = {"result": "trial", "trial": i, **trial(path, first)}
            print(json.dumps(rec), flush=True)
            recs.append(rec)
        failing = [r for r in recs if not r["old_test_passes"]]
        print(json.dumps({
            "result": "summary", "path": path, "trials": len(recs),
            "old_test_failures": len(failing),
            "sign_flips_in_failing": [r["sign_flips_total"] for r in failing],
            "sign_flips_in_passing": [r["sign_flips_total"] for r in recs
                                      if r["old_test_passes"]],
            "flipped_step2_gap_in_failing": [
                r["plain_flipped_vs_plain_step2_gap_over_bar"] for r in failing],
            "kernel_step2_gap_in_failing": [r["kernel_vs_plain_gap_over_bar"][1]
                                            for r in failing],
            "replayed_step2_gap_max": max(r["plain_replayed_vs_plain_step2_gap_over_bar"]
                                          for r in recs),
            "plain_vs_plain_step2_gap_max": max(r["plain_vs_plain_step2_gap_over_bar"]
                                                for r in recs),
            "step1_grad_rel_err_worst": max((r["step1_grad_rel_err_worst"] for r in recs),
                                            key=lambda x: x[1]),
            "plain_vs_plain_step1_grad_rel_err_worst": max(
                (r["plain_vs_plain_step1_grad_rel_err_worst"] for r in recs),
                key=lambda x: x[1]),
            "device": torch.cuda.get_device_name(0)}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
