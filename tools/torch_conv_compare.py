#!/usr/bin/env python3
"""Hold the forward 3x3 convolution of two checkouts of cyclegan_tpu_torch
against each other on one CUDA card.

    python3 tools/torch_conv_compare.py --base OLD_CHECKOUT --head NEW_CHECKOUT

Each checkout runs in its own process (each builds its own kernels under
its ``cyclegan_tpu_torch/build``). Prints one JSON line per result:

- ``conv``: ``kernels.resblock.conv3x3_reflect`` on the same seeded bf16
  inputs at the trunk shapes (64x64x256 -> 256 at batch 1, 2 and 8) and two
  ragged ones, and whether the two checkouts' float32 outputs are bitwise
  equal;
- ``vjp``: for each checkout and seed, the bf16 residual block's VJP through
  ``residual_block_fused`` against ``residual_block_bwd_saved_plain`` from
  the kernel forward's own residuals (``forward_residuals_cuda``): the
  worst error over chip_smoke.py's bf16 ``residual_block_bwd`` bar for dx,
  dw1, dw2;
- ``in_profile``: one profiled default train step of ``voc_semisup_256``
  (bf16, 256x256, batch 1) in each checkout: the instance-norm kernels'
  device ms and launches, forward and VJP, by kernel;
- ``kernel_outputs``: the default path's and path B's kernels (instance norm
  forward and VJP, the input and weight gradients, ``conv_dw``, the fused
  block forward and VJP; the input gradient also at 8 and 16 rows and the
  block VJP at 8) on the same seeded inputs, whether the two checkouts'
  outputs are bitwise equal, and for the gradients the worst difference
  over chip_smoke.py's bar (``worst_diff_over_bar``, the base as the
  reference);
- ``chunked_profile``: one profiled path-A step
  (``CYCLEGAN_TPU_RESBLOCK=chunked``, hc 8) in each checkout: the chunked
  block's normalisation kernels' device ms and launches, by kernel;
- ``chunked_norms``: those kernels alone at the trunk's (2, 64, 64, 256)
  bf16, hc 8, in each checkout: the forward's two calls and the VJP's two,
  device us a pair as a CUDA-graph replay and eagerly, and the block's
  forward and VJP (rows #6 and #7) eagerly, at batch 2 and 1.

Imports nothing of JAX or the JAX package.
"""

from __future__ import annotations

import argparse
import inspect
import json
import os
import re
import subprocess
import sys
import tempfile

# The gradient outputs whose two checkouts are held against each other at
# chip_smoke.py's bf16 BWD_TOL bar of the same name (the output's name
# prefix): the input gradient alone (a float32 cotangent, the float32 bar)
# and the bf16 block VJP.
BARS = ("conv3x3_reflect_dgrad", "residual_block_bwd")
CONV_CASES = (((1, 64, 64, 256), 256), ((2, 64, 64, 256), 256), ((8, 64, 64, 256), 256),
              ((2, 13, 11, 96), 200), ((1, 64, 64, 512), 256))


def _inputs(shape, cout, seed, dtype):
    import torch

    g = torch.Generator(device="cuda").manual_seed(seed)

    def randn(s, scale=1.0):
        return (torch.randn(s, device="cuda", generator=g) * scale).to(dtype)

    return randn(shape), randn((3, 3, shape[-1], cout), 0.02), randn((cout,), 0.01), randn


def child(checkout: str, out_path: str, seeds: int) -> None:
    """Run in ``checkout``: the convolution outputs (saved to ``out_path``)
    and the VJP sweep (printed)."""
    sys.path.insert(0, checkout)
    import torch

    import chip_smoke as cs
    from cyclegan_tpu_torch.kernels import resblock as RB

    outs = {}
    for shape, cout in CONV_CASES:
        x, w, b, _ = _inputs(shape, cout, 7, torch.bfloat16)
        o = torch.empty(shape[:3] + (cout,), device="cuda")
        RB.conv3x3_reflect(x, w, b, o)
        outs[str((shape, cout))] = o.cpu()
    outs.update(kernel_outputs())
    torch.save(outs, out_path)
    for seed in range(seeds):
        for batch in (2, 1):
            shape = (batch, 64, 64, 256)
            x, w1, b1, randn = _inputs(shape, 256, 100 + seed, torch.bfloat16)
            w2, b2, dy = randn((3, 3, 256, 256), 0.02), randn((256,), 0.01), randn(shape)
            leaves = [t.clone().requires_grad_() for t in (x, w1, b1, w2, b2)]
            got = torch.autograd.grad(RB.residual_block_fused(*leaves), leaves, dy)
            res = RB.forward_residuals_cuda(x, w1, b1, w2, b2, 1e-5)[1]
            ref = RB.residual_block_bwd_saved_plain(x, dy, w1, w2, res)
            worst = {n: cs.compare_bwd("residual_block_bwd", o, r, "bfloat16")["worst_err_over_tol"]
                     for n, o, r in zip(("dx", "dw1", "dw2"), (got[0], got[1], got[3]), ref)}
            print(json.dumps({"result": "vjp", "checkout": checkout, "seed": seed,
                              "batch": batch, "worst_err_over_tol": worst}), flush=True)
    print(json.dumps({"result": "in_profile", "checkout": checkout, **in_profile(cs)}),
          flush=True)
    print(json.dumps({"result": "chunked_profile", "checkout": checkout,
                      **chunked_profile(cs)}), flush=True)
    print(json.dumps({"result": "chunked_norms", "checkout": checkout, **chunked_norms(cs)}),
          flush=True)


def _cotangent(RB, CD, g):
    """The float32 cotangent ``g`` as a checkout's gradient convolutions
    take it: ``g`` itself where their first parameter is ``g`` (the older
    wrappers, which split it), else its two bf16 parts."""
    first = next(iter(inspect.signature(RB.conv3x3_reflect_dgrad).parameters))
    return g if first == "g" else CD.bf16_parts(g, 2)


def kernel_outputs() -> dict:
    """The default path's and path B's kernels on seeded bf16 inputs at
    train shapes, by name: instance norm forward (and its statistics) and
    VJP, the block's input gradient (float32 cotangent) and weight gradient,
    conv_dw, and the fused block's forward and VJP."""
    import torch

    from cyclegan_tpu_torch.kernels import conv_dw as CD
    from cyclegan_tpu_torch.kernels import instance_norm as IN
    from cyclegan_tpu_torch.kernels import resblock as RB

    out = {}
    shape = (2, 64, 64, 256)
    x, w1, b1, randn = _inputs(shape, 256, 11, torch.bfloat16)
    w2, b2, dy = randn((3, 3, 256, 256), 0.02), randn((256,), 0.01), randn(shape)
    for ishape, act in (((2, 256, 256, 64), "relu"), ((1, 31, 31, 512), "leaky")):
        xi, di = randn(ishape), randn(ishape)
        y, dx = torch.empty_like(xi), torch.empty_like(xi)
        mean, rstd = IN.launch(xi, None, y, 1e-5, act)
        IN.launch_bwd(xi, di, mean, rstd, dx, act)
        out.update({f"in_fwd{ishape}": y, f"in_stats{ishape}": torch.stack([mean, rstd]),
                    f"in_bwd{ishape}": dx})
    g = torch.randn(shape, device="cuda", generator=torch.Generator(device="cuda")
                    .manual_seed(12))
    da = torch.empty(shape, device="cuda")
    RB.conv3x3_reflect_dgrad(_cotangent(RB, CD, g), w2, da)
    out["conv3x3_reflect_dgrad"] = da
    for b in (8, 16):  # the train cells' rows
        gb = torch.randn((b,) + shape[1:], device="cuda",
                         generator=torch.Generator(device="cuda").manual_seed(12 + b))
        db = torch.empty_like(gb)
        RB.conv3x3_reflect_dgrad(_cotangent(RB, CD, gb), w2, db)
        out[f"conv3x3_reflect_dgrad{tuple(gb.shape)}"] = db
    out["conv3x3_reflect_wgrad"] = RB.conv3x3_reflect_wgrad(x, _cotangent(RB, CD, g))
    xp = torch.nn.functional.pad(x.permute(0, 3, 1, 2), (1, 1, 1, 1), mode="reflect")
    out["conv_dw"] = CD.conv_dw(xp.permute(0, 2, 3, 1).contiguous(), dy)
    leaves = [t.clone().requires_grad_() for t in (x, w1, b1, w2, b2)]
    y = RB.residual_block_fused(*leaves)
    out["residual_block_fused"] = y.detach()
    for name, t in zip(("dx", "dw1", "db1", "dw2", "db2"),
                       torch.autograd.grad(y, leaves, dy)):
        out[f"residual_block_bwd_{name}"] = t
    x8, dy8 = randn((8,) + shape[1:]), randn((8,) + shape[1:])
    leaves = [t.clone().requires_grad_() for t in (x8, w1, b1, w2, b2)]
    for name, t in zip(("dx", "dw1", "dw2"), torch.autograd.grad(
            RB.residual_block_fused(*leaves), [leaves[i] for i in (0, 1, 3)], dy8)):
        out[f"residual_block_bwd_{name}{tuple(x8.shape)}"] = t
    return {k: v.detach().cpu() for k, v in out.items()}


def _train_batch(cfg):
    """The synthetic batch of chip_smoke's train phase (samples 0 and 1),
    with pool decisions that keep every new image."""
    import numpy as np
    import torch

    from cyclegan_tpu_torch.data.datasets import DATASET_SPECS, _synthetic_sample
    from cyclegan_tpu_torch.data.transforms import normalize

    n_cls, in_ch, _ = DATASET_SPECS[cfg.dataset]
    lab_img, lab = _synthetic_sample(0, cfg.crop_hw, n_cls, in_ch)
    unlab_img, _ = _synthetic_sample(1, cfg.crop_hw, n_cls, in_ch)
    return n_cls, in_ch, {
        "lab_image": torch.from_numpy(normalize(lab_img)[None]).cuda(),
        "unlab_image": torch.from_numpy(normalize(unlab_img)[None]).cuda(),
        "lab_label": torch.from_numpy(lab.astype(np.int64)[None]).cuda(),
        **{f"pool_use_new_{k}": np.ones(cfg.batch_size, bool) for k in ("img", "lab")},
        **{f"pool_idx_{k}": np.zeros(cfg.batch_size, np.int64) for k in ("img", "lab")}}


def _profiled_step(cs, route: str) -> list:
    """One train step of chip_smoke's preset (bf16, batch 1, after two
    unprofiled steps) on the trunk ``route`` (chip_smoke's resblock_env:
    "chunked" or the default) under torch.profiler: ``(kernel, device ms,
    launches)`` of every device kernel."""
    import torch

    from cyclegan_tpu_torch.train.cyclegan import CycleGANTrainer
    from cyclegan_tpu_torch.utils.config import preset

    cfg = preset(cs.TRAIN_PRESET)
    n_cls, in_ch, batch = _train_batch(cfg)
    with cs.resblock_env(route):
        t = CycleGANTrainer(cfg, n_cls, in_ch, cs.VOC_STEPS_PER_EPOCH, device="cuda")
    st = t.init_state(torch.Generator().manual_seed(0))
    for _ in range(2):
        st, _ = t.train_step(st, batch)
    torch.cuda.synchronize()
    with torch.profiler.profile(activities=[torch.profiler.ProfilerActivity.CUDA]) as prof:
        t.train_step(st, batch)
        torch.cuda.synchronize()
    return [(e.key, e.self_device_time_total / 1e3, e.count) for e in prof.key_averages()
            if e.self_device_time_total > 0]


# The instance-norm kernels of either design: three launches a call
# (in_partial, in_merge, in_apply and their in_bwd_ counterparts) or one
# (in_fwd, in_bwd).
IN_KERNEL = re.compile(r"::in_(partial|merge|apply|fwd|bwd\w*)[<(]")


def in_profile(cs) -> dict:
    """The instance-norm kernels' device ms and launches, forward and VJP,
    in one profiled default train step."""
    rows = [r for r in _profiled_step(cs, "fused") if IN_KERNEL.search(r[0])]
    out = {}
    for side, vjp in (("fwd", False), ("bwd", True)):
        by_kernel = {}
        for key, ms, n in rows:
            if ("::in_bwd" in key) == vjp:
                name = IN_KERNEL.search(key).group(0)[2:-1]
                was = by_kernel.get(name, (0.0, 0))
                by_kernel[name] = (was[0] + ms, was[1] + n)
        out[side] = {"ms": sum(v[0] for v in by_kernel.values()),
                     "launches": sum(v[1] for v in by_kernel.values()), "by_kernel": by_kernel}
    return out


# The chunked block's normalisation kernels of either design: one launch a
# call (chunked_in_fwd, chunked_in_vjp) or three (partials, merge, apply).
RC_KERNEL = re.compile(r"::(chunked_in_fwd|chunked_in_vjp|fwd_partials|vjp_partials_[sv]|"
                       r"merge_partials|fwd_apply_in[12]|vjp_apply_[sv])[<(]")


def chunked_profile(cs) -> dict:
    """The chunked block's normalisation kernels' device ms and launches,
    by kernel, in one profiled path-A train step (hc of chip_smoke)."""
    by_kernel = {}
    for key, ms, n in _profiled_step(cs, "chunked"):
        m = RC_KERNEL.search(key)
        if m:
            was = by_kernel.get(m.group(1), (0.0, 0))
            by_kernel[m.group(1)] = (was[0] + ms, was[1] + n)
    return {"ms": sum(v[0] for v in by_kernel.values()),
            "launches": sum(v[1] for v in by_kernel.values()), "by_kernel": by_kernel}


def chunked_norms(cs) -> dict:
    """The chunked block's normalisation calls alone at (2, 64, 64, 256)
    bf16, hc 8 (either checkout's wrappers: the three-kernel design takes
    its scratch as arguments), and the whole block forward and VJP at batch
    2 and 1."""
    import inspect

    import torch

    from cyclegan_tpu_torch.kernels import resblock_chunked as RC

    hc, out = 8, {}
    shape = (2, 64, 64, 256)
    x, w1, b1, randn = _inputs(shape, 256, 13, torch.bfloat16)
    f32 = dict(device="cuda", dtype=torch.float32)
    u, s32, da = (torch.randn(shape, **f32) for _ in range(3))
    dy = randn(shape)
    stats = torch.empty((2, 4, 256), **f32)
    vh, a, s, y, dv, a2 = (torch.empty_like(x) for _ in range(6))
    ds, du = torch.empty(shape, **f32), torch.empty(shape, **f32)
    scratch = "part" in inspect.signature(RC.in_fwd).parameters
    part = [torch.empty((2, 2, 64 // hc, 256), **f32)] if scratch else []
    means = [torch.empty((2, 2, 256), **f32)] if scratch else []

    def fwd():
        RC.in_fwd(u, stats, x, vh, a, *part, hc, 1e-5, 1)
        RC.in_fwd(s32, stats, x, s, y, *part, hc, 1e-5, 2)

    def vjp():
        RC.in_vjp(dy, s, stats, ds, *part, *means, hc, 2)
        RC.in_vjp(da, vh, stats, du, *part, *means, hc, 1, dv=dv, a=a2)

    for side, fn in (("fwd", fwd), ("vjp", vjp)):
        out[side] = {"graph_us_per_pair": cs.graph_us(fn),
                     "eager_us_per_pair": cs.time_ms(fn, 20) * 1e3}
    w2, b2 = randn((3, 3, 256, 256), 0.02), randn((256,), 0.01)
    for b in (2, 1):
        xb, dyb = x[:b].contiguous(), dy[:b].contiguous()
        yb, vhat, sb, st = RC._fwd_cuda(xb, w1, b1, w2, b2, 1e-5, hc)
        out[f"block_b{b}"] = {
            "fwd_ms": cs.time_ms(lambda: RC._fwd_cuda(xb, w1, b1, w2, b2, 1e-5, hc), 10),
            "bwd_ms": cs.time_ms(lambda: RC._bwd_cuda(xb, dyb, vhat, sb, st, w1, w2, hc), 10)}
    return out


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--base", required=True, help="checkout of the older commit")
    ap.add_argument("--head", required=True, help="checkout of the newer commit")
    ap.add_argument("--seeds", type=int, default=6, help="seeds of the VJP sweep")
    ap.add_argument("--child", nargs=2, help=argparse.SUPPRESS)
    args = ap.parse_args()
    if args.child:
        child(args.child[0], args.child[1], args.seeds)
        return 0
    import torch

    if not torch.cuda.is_available():
        print("torch_conv_compare: no CUDA device", file=sys.stderr)
        return 1
    with tempfile.TemporaryDirectory() as tmp:
        paths = {}
        for name in ("base", "head"):
            checkout = os.path.abspath(getattr(args, name))
            paths[name] = os.path.join(tmp, f"{name}.pt")
            subprocess.run([sys.executable, os.path.abspath(__file__), "--base", "-", "--head",
                            "-", "--seeds", str(args.seeds), "--child", checkout,
                            paths[name]], check=True, cwd=checkout)
        base, head = (torch.load(paths[n]) for n in ("base", "head"))
    sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))
    import chip_smoke as cs

    for key in base:
        rec = {"result": "conv" if key.startswith("((") else "kernel_outputs", "case": key,
               "bitwise_equal": bool(torch.equal(base[key], head[key])),
               "max_abs_diff": float((base[key] - head[key]).abs().max())}
        bar = next((b for b in BARS if key.startswith(b)), None)
        if bar is not None and bool(base[key].abs().max() > 0):  # not the zero bias grads
            rec["worst_diff_over_bar"] = cs.compare_bwd(
                bar, head[key].float(), base[key].float(), "bfloat16")["worst_err_over_tol"]
        print(json.dumps(rec))
    return 0


if __name__ == "__main__":
    sys.exit(main())
