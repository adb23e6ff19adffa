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
  ``residual_block_fused`` against ``residual_block_bwd_plain`` on the
  plain version's own relu mask (worst error over chip_smoke.py's bf16
  ``residual_block_bwd`` bar for dx, dw1, dw2), the number of elements where
  the kernel's and the plain version's first convolution put relu's mask on
  other sides of the normalised zero, and, where the checkout's
  chip_smoke.py has it, its check (``block_vjp_check``: the plain VJP on
  the kernel path's mask at the same bar, and the flips on their own);
- ``in_profile``: one profiled default train step of ``voc_semisup_256``
  (bf16, 256x256, batch 1) in each checkout: the instance-norm kernels'
  device ms and launches, forward and VJP, by kernel.

Imports nothing of JAX or the JAX package.
"""

from __future__ import annotations

import argparse
import json
import os
import re
import subprocess
import sys
import tempfile

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
    from cyclegan_tpu_torch.kernels import instance_norm as IN
    from cyclegan_tpu_torch.kernels import resblock as RB

    outs = {}
    for shape, cout in CONV_CASES:
        x, w, b, _ = _inputs(shape, cout, 7, torch.bfloat16)
        o = torch.empty(shape[:3] + (cout,), device="cuda")
        RB.conv3x3_reflect(x, w, b, o)
        outs[str((shape, cout))] = o.cpu()
    torch.save(outs, out_path)
    for seed in range(seeds):
        for batch in (2, 1):
            shape = (batch, 64, 64, 256)
            x, w1, b1, randn = _inputs(shape, 256, 100 + seed, torch.bfloat16)
            w2, b2, dy = randn((3, 3, 256, 256), 0.02), randn((256,), 0.01), randn(shape)
            leaves = [t.clone().requires_grad_() for t in (x, w1, b1, w2, b2)]
            got = torch.autograd.grad(RB.residual_block_fused(*leaves), leaves, dy)
            ref = RB.residual_block_bwd_plain(x, dy, w1, b1, w2, b2)
            worst = {n: cs.compare_bwd("residual_block_bwd", o, r, "bfloat16")["worst_err_over_tol"]
                     for n, o, r in zip(("dx", "dw1", "dw2"), (got[0], got[1], got[3]), ref)}
            u = torch.empty(shape, device="cuda")
            RB.conv3x3_reflect(x, w1, b1, u)
            up = RB._conv3x3_plain(x, w1, b1)
            (mk, _), (mp, _) = IN.instance_norm_stats_plain(u), IN.instance_norm_stats_plain(up)
            flips = int(((u - mk[:, None, None]) > 0).ne((up - mp[:, None, None]) > 0).sum())
            rec = {"result": "vjp", "checkout": checkout, "seed": seed, "batch": batch,
                   "worst_err_over_tol": worst, "relu_mask_flips": flips}
            if hasattr(cs, "block_vjp_check"):
                checks, flip = cs.block_vjp_check(x, dy, w1, b1, w2, b2,
                                                  (got[0], got[1], got[3]), "bfloat16")
                rec["kernel_mask_check"] = {
                    "worst_err_over_tol": {n: r["worst_err_over_tol"] for n, r in checks.items()},
                    **flip, "ok": flip["ok"] and all(r["ok"] for r in checks.values())}
            print(json.dumps(rec), flush=True)
    print(json.dumps({"result": "in_profile", "checkout": checkout, **in_profile(cs)}),
          flush=True)


# The instance-norm kernels of either design: three launches a call
# (in_partial, in_merge, in_apply and their in_bwd_ counterparts) or one
# (in_fwd, in_bwd).
IN_KERNEL = re.compile(r"::in_(partial|merge|apply|fwd|bwd\w*)[<(]")


def in_profile(cs) -> dict:
    """One default train step of chip_smoke's preset (bf16, batch 1, after
    two unprofiled steps) under torch.profiler: the instance-norm kernels'
    device ms and launches, forward and VJP."""
    import numpy as np
    import torch

    from cyclegan_tpu_torch.data.datasets import DATASET_SPECS, _synthetic_sample
    from cyclegan_tpu_torch.data.transforms import normalize
    from cyclegan_tpu_torch.train.cyclegan import CycleGANTrainer
    from cyclegan_tpu_torch.utils.config import preset

    cfg = preset(cs.TRAIN_PRESET)
    n_cls, in_ch, _ = DATASET_SPECS[cfg.dataset]
    lab_img, lab = _synthetic_sample(0, cfg.crop_hw, n_cls, in_ch)
    unlab_img, _ = _synthetic_sample(1, cfg.crop_hw, n_cls, in_ch)
    batch = {"lab_image": torch.from_numpy(normalize(lab_img)[None]).cuda(),
             "unlab_image": torch.from_numpy(normalize(unlab_img)[None]).cuda(),
             "lab_label": torch.from_numpy(lab.astype(np.int64)[None]).cuda(),
             **{f"pool_use_new_{k}": np.ones(cfg.batch_size, bool) for k in ("img", "lab")},
             **{f"pool_idx_{k}": np.zeros(cfg.batch_size, np.int64) for k in ("img", "lab")}}
    t = CycleGANTrainer(cfg, n_cls, in_ch, cs.VOC_STEPS_PER_EPOCH, device="cuda")
    st = t.init_state(torch.Generator().manual_seed(0))
    for _ in range(2):
        st, _ = t.train_step(st, batch)
    torch.cuda.synchronize()
    with torch.profiler.profile(activities=[torch.profiler.ProfilerActivity.CUDA]) as prof:
        t.train_step(st, batch)
        torch.cuda.synchronize()
    rows = [(e.key, e.self_device_time_total / 1e3, e.count) for e in prof.key_averages()
            if e.self_device_time_total > 0 and IN_KERNEL.search(e.key)]
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
    for key in base:
        print(json.dumps({"result": "conv", "case": key,
                          "bitwise_equal": bool(torch.equal(base[key], head[key])),
                          "max_abs_diff": float((base[key] - head[key]).abs().max())}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
