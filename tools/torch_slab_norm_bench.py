#!/usr/bin/env python3
"""Time the slab entries of the instance-norm kernels (#1/#2 on an H slab,
``kernels/instance_norm.py``'s ``_slab_*_cuda``) of one or more checkouts of
cyclegan_tpu_torch on one CUDA card.

    python3 tools/torch_slab_norm_bench.py [--checkouts DIR [DIR ...]]

With no ``--checkouts`` the script's own checkout is measured. Give an older
checkout (unpacked with ``git archive`` into a gitignored directory) and
this one in turns, ``--checkouts OLD . . OLD``, to compare two commits on
one card. Each checkout builds ``csrc/instance_norm.cu`` in a process of
its own (a process that just ran nvcc shows no kernels to the profiler),
then runs in another and prints one JSON line. At config 3's stem and trunk
slabs (bf16, batch 1, slab 0 of 2 of a 256x512 and a 64x128 plane), for
each slab entry and direction:

- ``us``: device µs a call as a CUDA-graph replay of 10 calls (``graph``)
  and eager µs a call over 20 back-to-back calls (``eager``, host
  included) of each entry alone, of the gather's own work around the
  all-reduce (the zero-filled slot buffer and the copy into this rank's
  slot, where the checkout's seam has them), of the pair (partials, that
  work, apply; no collective), and of the one-launch whole-plane kernel on
  as many elements;
- ``profile_us``: each device kernel's mean µs and calls over 10 profiled
  pairs;
- ``apply_l2_us``: the apply kernel's mean device µs (profiler) right after
  the partials read the slab (x, and dy, still in the 50 MB L2) and after a
  256 MB fill evicted it.

With ``--spatial`` each checkout then also runs its own ``chip_smoke.py``'s
``configs`` and ``spatial`` phases (config 3 at ``spatial_shards`` 2 on two
gloo ranks of the card, ``spatial_unet``, ``spatial_eval``; a few minutes
a checkout) and adds ``spatial``: their step times, peak memory a rank
and the probe step's collectives by kind, the host-bound numbers the slab
entries sit in.

Reads ``chip_smoke.py``'s ``time_ms`` and ``graph_us`` from each checkout.
Imports nothing of JAX or the JAX package.
"""

from __future__ import annotations

import argparse
import inspect
import json
import os
import subprocess
import sys
import tempfile

SHAPES = (((1, 256, 512, 64), "relu"), ((1, 64, 128, 256), "relu"),
          ((1, 64, 128, 256), "none"))
SLABS = 2


def _entries(IN, act: str):
    """The checkout's four slab entries behind one interface: partials of
    slab 0 into an (S, N, C, k) buffer as the seam hands it to the
    all-reduce, and the applies from that buffer. ``prep`` is the seam's
    own work between the partials and the all-reduce (None where the
    partials write the buffer themselves)."""
    import torch

    slot_writing = "buf" in inspect.signature(IN._slab_partials_cuda).parameters

    def buffer(x, k):
        n, _, _, c = x.shape
        return torch.empty((SLABS, n, c, k), dtype=torch.float32, device=x.device)

    if slot_writing:
        def fwd_partials(x):
            return IN._slab_partials_cuda(x, buffer(x, 3), 0)

        def bwd_partials(x, dy, mean, rstd):
            return IN._slab_bwd_partials_cuda(x, dy, mean, rstd, buffer(x, 2), 0, act)

        prep = None
    else:
        def fwd_partials(x):
            return IN._slab_partials_cuda(x)

        def bwd_partials(x, dy, mean, rstd):
            return IN._slab_bwd_partials_cuda(x, dy, mean, rstd, act)

        def prep(p):  # parallel/mesh.py::gather_slots before its all-reduce
            out = torch.zeros((SLABS, *p.shape), dtype=p.dtype, device=p.device)
            out[0].copy_(p)
            return out

    def fwd_apply(x, buf):
        return IN._slab_apply_cuda(x, None, buf, 1e-5, act)

    def bwd_apply(x, dy, mean, rstd, buf, count):
        return IN._slab_bwd_apply_cuda(x, dy, mean, rstd, buf, count, act)

    return slot_writing, fwd_partials, bwd_partials, prep, fwd_apply, bwd_apply


def _profile_us(fn, reps: int, keep=None) -> dict:
    """Mean device µs and calls of each kernel over ``reps`` calls of
    ``fn`` (``keep``: the kernels whose names contain one of these)."""
    import torch

    fn()
    torch.cuda.synchronize()
    with torch.profiler.profile(activities=[torch.profiler.ProfilerActivity.CUDA]) as prof:
        for _ in range(reps):
            fn()
        torch.cuda.synchronize()
    out = {}
    for e in prof.key_averages():
        if e.self_device_time_total <= 0 or (keep and not any(k in e.key for k in keep)):
            continue
        out[e.key[:80]] = {"calls": e.count, "us": e.self_device_time_total / e.count}
    return out


def child(checkout: str, spatial: bool) -> dict:
    sys.path.insert(0, checkout)
    import torch

    import chip_smoke as cs
    from cyclegan_tpu_torch.kernels import instance_norm as IN

    g = torch.Generator(device="cuda").manual_seed(12)
    flush = torch.empty(256 << 20, dtype=torch.uint8, device="cuda")
    rows = []
    for shape, act in SHAPES:
        slot_writing, fp, bp, prep, fa, ba = _entries(IN, act)
        x = torch.randn(shape, generator=g, device="cuda").to(torch.bfloat16)
        dy = torch.randn(shape, generator=g, device="cuda").to(torch.bfloat16)
        hs = shape[1] // SLABS
        xs, gs = x[:, :hs].contiguous(), dy[:, :hs].contiguous()
        p = fp(xs)
        buf = p if prep is None else prep(p)
        _, mean, rstd, count = fa(xs, buf)
        q = bp(xs, gs, mean, rstd)
        bbuf = q if prep is None else prep(q)
        whole, dx_whole = torch.empty_like(xs), torch.empty_like(xs)
        wm, wr = IN.launch(xs, None, whole, 1e-5, act)

        def pair_fwd():
            r = fp(xs)
            return fa(xs, r if prep is None else prep(r))

        def pair_vjp():
            r = bp(xs, gs, mean, rstd)
            return ba(xs, gs, mean, rstd, r if prep is None else prep(r), count)

        calls = {
            "fwd_partials": lambda: fp(xs),
            "fwd_apply": lambda: fa(xs, buf),
            "vjp_partials": lambda: bp(xs, gs, mean, rstd),
            "vjp_apply": lambda: ba(xs, gs, mean, rstd, bbuf, count),
            "fwd_pair": pair_fwd, "vjp_pair": pair_vjp,
            "whole_fwd": lambda: IN.launch(xs, None, whole, 1e-5, act),
            "whole_vjp": lambda: IN.launch_bwd(xs, gs, wm, wr, dx_whole, act)}
        if prep is not None:
            calls["fwd_gather_prep"] = lambda: prep(p)
            calls["vjp_gather_prep"] = lambda: prep(q)
        us = {k: {"graph": cs.graph_us(f), "eager": cs.time_ms(f, 20) * 1e3}
              for k, f in calls.items()}

        def both_pairs():
            pair_fwd()
            pair_vjp()

        def warm(apply_fn, partials_fn):
            def run():
                partials_fn()
                apply_fn()
            return run

        def cold(apply_fn, partials_fn):
            def run():
                partials_fn()
                flush.fill_(1)
                apply_fn()
            return run

        apply_names = ("slab_apply",)
        l2 = {}
        for d, (af, pf) in {"fwd": (calls["fwd_apply"], calls["fwd_partials"]),
                            "vjp": (calls["vjp_apply"], calls["vjp_partials"])}.items():
            for mode, wrap in (("warm", warm), ("cold", cold)):
                prof = _profile_us(wrap(af, pf), 10, apply_names)
                l2[f"{d}_{mode}"] = prof
        rows.append({"plane": list(shape), "slab": list(xs.shape), "act": act,
                     "us": us, "profile_us": _profile_us(both_pairs, 10),
                     "apply_l2_us": l2})
        del x, dy
    out = {"checkout": os.path.abspath(checkout), "slot_writing": slot_writing,
           "nvidia_smi": cs.smi_line(), "device": torch.cuda.get_device_name(0),
           "torch": torch.__version__, "shapes": rows}
    if spatial:
        del flush
        torch.cuda.empty_cache()
        smi = cs.phase_device()
        got = cs.phase_spatial(smi, cs.phase_configs(smi))
        a = got["record"]["a_config3_spatial2"]
        out["spatial"] = {k: a[k] for k in (
            "median_step_ms", "unsharded_median_step_ms", "peak_mem_gb_per_rank",
            "unsharded_peak_mem_gb", "probe_step_ms", "collectives_ms", "collectives_calls",
            "halo_and_norm_share_of_probe_step")}
        out["spatial"].update(
            unet_median_step_ms=got["unet"]["record"]["median_step_ms"],
            eval_seconds=got["eval"]["record"]["seconds_spatial2"])
    return out


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--checkouts", nargs="+",
                    default=[os.path.dirname(os.path.dirname(os.path.abspath(__file__)))],
                    help="checkouts to measure, in this order")
    ap.add_argument("--spatial", action="store_true",
                    help="also run each checkout's chip_smoke.py configs and spatial phases")
    ap.add_argument("--child", nargs=2, help=argparse.SUPPRESS)
    args = ap.parse_args()
    if args.child:
        rec = child(args.child[0], args.spatial)
        with open(args.child[1], "w") as f:
            json.dump(rec, f)
        return 0
    import torch

    if not torch.cuda.is_available():
        print("torch_slab_norm_bench: no CUDA device", file=sys.stderr)
        return 1
    for co in args.checkouts:
        co = os.path.abspath(co)
        subprocess.run([sys.executable, "-c", "import sys; sys.path.insert(0, sys.argv[1]); "
                        "from cyclegan_tpu_torch.kernels import _build; "
                        "_build.build_all(('instance_norm',))", co], check=True)
        with tempfile.TemporaryDirectory() as tmp:
            out = os.path.join(tmp, "record.json")
            subprocess.run([sys.executable, os.path.abspath(__file__), "--child", co, out,
                            *(["--spatial"] if args.spatial else [])], check=True,
                           stdout=sys.stderr)
            with open(out) as f:
                print(f.read(), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
