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
  ``residual_block_fused`` against ``residual_block_bwd_plain``, as
  chip_smoke.py's bf16 ``residual_block_bwd`` check measures it (worst
  error over its bar for dx, dw1, dw2), and the number of elements where
  the kernel's and the plain version's first convolution put relu's mask on
  other sides of the normalised zero.

Imports nothing of JAX or the JAX package.
"""

from __future__ import annotations

import argparse
import json
import os
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
            print(json.dumps({"result": "vjp", "checkout": checkout, "seed": seed, "batch": batch,
                              "worst_err_over_tol": worst, "relu_mask_flips": flips}), flush=True)


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
