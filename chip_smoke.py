#!/usr/bin/env python3
"""On-card smoke test of cyclegan_tpu_torch: one H100, under a minute.

    python3 chip_smoke.py

Drives the port's serving path at full width (ResNet-9 image->label
generator, ngf 64, 21 classes, 256x256, bf16 compute over float32 weights
drawn from a seed) and prints one JSON line per phase:

1. device: the card, its power limit, and the parallel nvcc build of every
   kernel under cyclegan_tpu_torch/csrc (build seconds, ptxas registers and
   spills);
2. kernels: each CUDA kernel against its plain PyTorch version at the main
   path's shapes (batch 8), float32 and bf16, with the stated tolerance and
   its time beside the plain version, one library call and the bound;
3. serve: export the artifact and run ``serve.run_serve`` over 16 seeded
   PNGs with ground truth on the card; the launch counters of both kernels
   must show the path went through them, and the kernel path's argmax must
   agree with the plain path's on one batch;
4. http: ``http_serve.make_server`` in a thread, /healthz and 8 POST
   /predict from 4 threads in the three formats, checked against step 3.

Then the card's name and power limit, a ``{"kernels": [...]}`` line and,
last, ``{"ok": true, "device": {...}}``.
Any failure raises: the script exits non-zero and prints no ok line. It
imports nothing of JAX or the JAX package.
"""

from __future__ import annotations

import io
import json
import math
import os
import statistics
import subprocess
import sys
import tempfile
import threading
import time
import urllib.request
from concurrent.futures import ThreadPoolExecutor

HERE = os.path.dirname(os.path.abspath(__file__))

# Published H100 SXM peaks (NVIDIA data sheet, dense): HBM bytes/s,
# bf16 tensor-core and float32 non-tensor flop/s.
HBM_BPS = 3.35e12
PEAK_FLOPS = {"bfloat16": 989e12, "float32": 67e12}

BATCH = 8
CROP = 256
NGF = 64
NUM_CLASSES = 21
N_BLOCKS = 9
N_IMAGES = 16

# Tolerances |kernel - plain| <= atol + rtol * |plain|, per kernel and dtype.
TOL = {
    # float32 statistics over up to 65,536 values, summed in another order
    # (per-thread Welford + Chan merges vs torch's reduction).
    ("instance_norm_act", "float32"): (2e-5, 1e-5),
    # bf16 output: a last-bit difference of the f32 value before the cast
    # can flip the rounding; one bf16 ulp is at most 2^-7 relative.
    ("instance_norm_act", "bfloat16"): (2 ** -7, 2 ** -6),
    # Two 2,304-term float32 convolutions summed in another order, each
    # followed by a normalisation that divides by the channel's std.
    ("residual_block_fused", "float32"): (1e-4, 1e-4),
    # The bf16 activation between the convolutions may round the other way
    # on a last-bit f32 difference, which moves the output by an ulp or two.
    ("residual_block_fused", "bfloat16"): (2 ** -6, 2 ** -6),
}
ARGMAX_AGREEMENT_MIN = 0.99   # kernel path vs plain path, same batch
# A top-2 logit gap under this share of the top logit is a tie that another
# summation order may break either way: 4 ulps of a bf16 logit (8
# significant bits); for float32 any nonzero gap counts.
TIE_REL = {"bfloat16": 2 ** -5, "float32": 0.0}
# HTTP micro-batches (1, 2 or 4 images) vs run_serve's batches of 8, on
# the pixels that are no tie: the library convolutions around the kernels
# may pick other algorithms for other batch sizes.
HTTP_AGREEMENT_MIN = 0.999


def emit(obj) -> None:
    print(json.dumps(obj), flush=True)


def smi_line() -> str:
    return subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, check=True).stdout.strip()


def time_ms(fn, reps: int) -> float:
    """Mean device time of ``fn`` over ``reps`` back-to-back calls (CUDA
    events, after 3 warm-up calls)."""
    import torch

    for _ in range(3):
        fn()
    torch.cuda.synchronize()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(reps):
        fn()
    end.record()
    end.synchronize()
    return start.elapsed_time(end) / reps


def bound(nbytes: float, flops: float, dtype: str) -> tuple[float, str]:
    """Least time in ms for moving ``nbytes`` and doing ``flops`` of
    ``dtype`` work on an H100, and which of the two bounds it."""
    t_bytes, t_ops = nbytes / HBM_BPS * 1e3, flops / PEAK_FLOPS[dtype] * 1e3
    return (t_bytes, "bytes") if t_bytes >= t_ops else (t_ops, "operations")


def compare(kernel, out, ref, dtype: str) -> dict:
    import torch

    atol, rtol = TOL[(kernel, dtype)]
    d = (out.float() - ref.float()).abs()
    allowed = atol + rtol * ref.float().abs()
    worst = float((d / allowed).max())
    res = {"max_abs_err": float(d.max()), "atol": atol, "rtol": rtol,
           "worst_err_over_tol": worst, "ok": bool(worst <= 1.0)}
    if not torch.isfinite(out).all():
        res["ok"] = False
    return res


# --------------------------------------------------------------------------
def phase_device():
    import torch

    from cyclegan_tpu_torch.kernels import _build

    smi = smi_line()
    print(smi, flush=True)
    t0 = time.perf_counter()
    logs = _build.build_all()
    build_s = time.perf_counter() - t0
    ptxas = {n: [ln.strip() for ln in log.splitlines()
                 if "registers" in ln or "spill" in ln] for n, log in logs.items()}
    emit({"phase": "device", "kind": torch.cuda.get_device_name(0),
          "count": torch.cuda.device_count(), "nvidia_smi": smi,
          "torch": torch.__version__, "cuda": torch.version.cuda,
          "build_s": build_s, "ptxas": ptxas})
    return smi


def phase_kernels() -> dict:
    """Every kernel against its plain version at the main path's shapes."""
    import torch
    import torch.nn.functional as F

    from cyclegan_tpu_torch.kernels import instance_norm as IN
    from cyclegan_tpu_torch.kernels import resblock as RB

    torch.backends.cudnn.allow_tf32 = False
    torch.backends.cuda.matmul.allow_tf32 = False
    g = torch.Generator(device="cuda").manual_seed(0)
    dev = "cuda"
    summary = {"instance_norm_act": {}, "residual_block_fused": {}}

    def lib_in(x, skip, act):
        y = F.instance_norm(x.permute(0, 3, 1, 2), eps=1e-5)
        y = torch.relu(y) if act == "relu" else y
        return y if skip is None else y + skip.permute(0, 3, 1, 2)

    # (shape, act, skip, calls per forward of the main path)
    in_cases = [((BATCH, CROP, CROP, NGF), "relu", False, 2),
                ((BATCH, CROP // 2, CROP // 2, NGF * 2), "relu", False, 2),
                ((BATCH, CROP // 4, CROP // 4, NGF * 4), "relu", False, 1),
                ((BATCH, CROP // 4, CROP // 4, NGF * 4), "none", True, 0)]
    for dtype in (torch.float32, torch.bfloat16):
        dname = str(dtype).split(".")[1]
        for shape, act, has_skip, per_fwd in in_cases:
            x = (torch.randn(shape, device=dev, generator=g) * 2 + 0.5).to(dtype)
            skip = torch.randn(shape, device=dev, generator=g).to(dtype) if has_skip else None
            out = IN.instance_norm_act(x, skip, 1e-5, act)
            ref = IN.instance_norm_act_plain(x, skip, 1e-5, act)
            torch.cuda.synchronize()
            res = compare("instance_norm_act", out, ref, dtype=dname)
            nbytes = x.numel() * x.element_size() * (3 if has_skip else 2)
            b_ms, b_by = bound(nbytes, 8.0 * x.numel(), "float32")
            rec = {"phase": "kernels", "kernel": "instance_norm_act", "shape": list(shape),
                   "dtype": dname, "act": act, "skip": has_skip, **res,
                   "ms": time_ms(lambda: IN.instance_norm_act(x, skip, 1e-5, act), 20),
                   "plain_ms": time_ms(lambda: IN.instance_norm_act_plain(x, skip, 1e-5, act), 5),
                   "library_ms": time_ms(lambda: lib_in(x, skip, act), 20),
                   "bound_ms": b_ms, "bound_by": b_by, "calls_per_forward": per_fwd}
            emit(rec)
            if not res["ok"]:
                raise AssertionError(f"instance_norm_act disagrees with its plain version: {rec}")
            summary["instance_norm_act"].setdefault(dname, []).append(rec)
            del x, skip, out, ref

    c = NGF * 4
    shape = (BATCH, CROP // 4, CROP // 4, c)
    for dtype in (torch.float32, torch.bfloat16):
        dname = str(dtype).split(".")[1]
        x = torch.randn(shape, device=dev, generator=g).to(dtype)
        w1, w2 = [(0.02 * torch.randn((3, 3, c, c), device=dev, generator=g)).to(dtype)
                  for _ in range(2)]
        b1, b2 = [(0.01 * torch.randn((c,), device=dev, generator=g)).to(dtype)
                  for _ in range(2)]
        out = RB.residual_block_fused(x, w1, b1, w2, b2)
        ref = RB.residual_block_plain(x, w1, b1, w2, b2)
        torch.cuda.synchronize()
        res = compare("residual_block_fused", out, ref, dtype=dname)
        # OIHW channels_last weights for the library (cuDNN) composition.
        W1, W2 = [w.permute(3, 2, 0, 1).contiguous(memory_format=torch.channels_last)
                  for w in (w1, w2)]

        def lib_rb():
            xn = x.permute(0, 3, 1, 2)
            h = F.conv2d(F.pad(xn, (1, 1, 1, 1), mode="reflect"), W1, b1)
            h = torch.relu(F.instance_norm(h, eps=1e-5))
            h = F.conv2d(F.pad(h, (1, 1, 1, 1), mode="reflect"), W2, b2)
            return xn + F.instance_norm(h, eps=1e-5)

        m = BATCH * shape[1] * shape[2]
        flops = 2 * (2.0 * m * c * 9 * c)
        nbytes = (2 * x.numel() + 2 * w1.numel() + 2 * c) * x.element_size()
        b_ms, b_by = bound(nbytes, flops, dname)
        rec = {"phase": "kernels", "kernel": "residual_block_fused", "shape": list(shape),
               "dtype": dname, **res,
               "ms": time_ms(lambda: RB.residual_block_fused(x, w1, b1, w2, b2), 10),
               "plain_ms": time_ms(lambda: RB.residual_block_plain(x, w1, b1, w2, b2), 5),
               "library_ms": time_ms(lib_rb, 10), "bound_ms": b_ms, "bound_by": b_by,
               "gflop": flops / 1e9, "calls_per_forward": N_BLOCKS}
        emit(rec)
        if not res["ok"]:
            raise AssertionError(f"residual_block_fused disagrees with its plain version: {rec}")
        summary["residual_block_fused"].setdefault(dname, []).append(rec)
        del x, out, ref
    torch.cuda.empty_cache()
    return summary


def _write_inputs(root: str) -> tuple[str, str]:
    import numpy as np
    from PIL import Image

    rng = np.random.default_rng(0)
    img_dir, gt_dir = os.path.join(root, "imgs"), os.path.join(root, "gt")
    os.makedirs(img_dir)
    os.makedirs(gt_dir)
    yy, xx = np.mgrid[0:CROP, 0:CROP]
    for i in range(N_IMAGES):
        # Smooth colour fields plus noise, and blocky masks with a void border.
        base = np.stack([np.sin((xx * (c + 1) + yy * (i + 1)) / 40.0) for c in range(3)], -1)
        img = np.clip(127.5 * (base + 1) + rng.normal(0, 20, base.shape), 0, 255)
        Image.fromarray(img.astype(np.uint8)).save(os.path.join(img_dir, f"img{i:02d}.png"))
        mask = rng.integers(0, NUM_CLASSES, (CROP // 32, CROP // 32)).repeat(32, 0).repeat(32, 1)
        mask[:4] = 255
        Image.fromarray(mask.astype(np.uint8)).save(os.path.join(gt_dir, f"img{i:02d}.png"))
    return img_dir, gt_dir


def _decisive(logits, dtype: str):
    """Pixels whose top-2 logit gap is no tie (see TIE_REL)."""
    top2 = logits.topk(2, dim=-1).values
    return (top2[..., 0] - top2[..., 1]) > TIE_REL[dtype] * top2[..., 0].abs()


def _paths_agree(G, tmp: str, x, dtype: str):
    """Logits of the served function with the kernels and with the blocks'
    seams pointed at the plain versions, on one batch: argmax agreement over
    all pixels and over the pixels whose plain top-2 logit gap is no tie.
    Also returns the kernel path's no-tie mask."""
    import torch

    from cyclegan_tpu_torch import export
    from cyclegan_tpu_torch.kernels import instance_norm as IN
    from cyclegan_tpu_torch.kernels import resblock as RB
    from cyclegan_tpu_torch.ops import blocks

    art = export.export_generator(
        G, os.path.join(tmp, f"logits_{dtype}"), gen_net="resnet_9blocks", ngf=NGF,
        num_classes=NUM_CLASSES, in_channels=3, crop_hw=(CROP, CROP), dtype=dtype,
        head="logits")
    fn, _, _ = export.load_head(art, "cuda")
    lk = fn(x).float()
    seams = (blocks.instance_norm_act, blocks.residual_block_fused)
    blocks.instance_norm_act, blocks.residual_block_fused = (
        IN.instance_norm_act_plain, RB.residual_block_plain)
    try:
        lp = fn(x).float()
    finally:
        blocks.instance_norm_act, blocks.residual_block_fused = seams
    decisive = _decisive(lp, dtype)
    agree = lk.argmax(-1) == lp.argmax(-1)
    return {"all": float(agree.float().mean()),
            "decisive": float(agree[decisive].float().mean()),
            "decisive_share": float(decisive.float().mean()),
            "max_abs_logit_diff": float((lk - lp).abs().max()),
            "max_abs_logit": float(lp.abs().max())}, _decisive(lk, dtype)


def phase_serve(tmp: str) -> dict:
    import numpy as np
    import torch
    from PIL import Image

    from cyclegan_tpu_torch import export, serve
    from cyclegan_tpu_torch.kernels import instance_norm as IN
    from cyclegan_tpu_torch.kernels import resblock as RB
    from cyclegan_tpu_torch.models.generators import define_Gen

    G = define_Gen(3, NUM_CLASSES, NGF, "resnet_9blocks", head="none",
                   generator=torch.Generator().manual_seed(0))
    artifact = export.export_generator(
        G, os.path.join(tmp, "model"), gen_net="resnet_9blocks", ngf=NGF,
        num_classes=NUM_CLASSES, in_channels=3, crop_hw=(CROP, CROP), dtype="bfloat16")
    img_dir, gt_dir = _write_inputs(tmp)
    out_dir = os.path.join(tmp, "preds")

    # The main path: counts set to 0 just before, read just after.
    IN.launches = RB.launches = 0
    summary = serve.run_serve(artifact, img_dir, out_dir, batch_size=BATCH,
                              gt_dir=gt_dir, device="cuda")
    launches = {"instance_norm_act": IN.launches, "residual_block_fused": RB.launches}
    forwards = math.ceil(N_IMAGES / BATCH)
    if launches["instance_norm_act"] < 5 * forwards or \
            launches["residual_block_fused"] < N_BLOCKS * forwards:
        raise AssertionError(f"serving path bypassed the kernels: {launches} over "
                             f"{forwards} forwards")

    preds = {}
    for name in sorted(os.listdir(img_dir)):
        stem = os.path.splitext(name)[0]
        p = np.asarray(Image.open(os.path.join(out_dir, f"{stem}_pred.png")))
        if p.shape != (CROP, CROP) or p.max() >= NUM_CLASSES:
            raise AssertionError(f"{stem}_pred.png: shape {p.shape}, max class {p.max()}")
        preds[name] = p
    with open(os.path.join(out_dir, "scores.json")) as f:
        scores = json.load(f)
    for k in ("pixel_acc", "mean_acc", "miou", "fwiou"):
        if not 0.0 <= scores[k] <= 1.0:
            raise AssertionError(f"scores.json {k}={scores[k]}")
    if scores["scored"] != N_IMAGES or len(scores["per_class_iou"]) != NUM_CLASSES:
        raise AssertionError(f"scores.json: {scores}")

    # Kernel path vs plain path on one batch, in both compute types.
    names = sorted(preds)[:BATCH]
    batch = np.stack([serve.load_image(os.path.join(img_dir, n), (CROP, CROP), 3, "resize")
                      for n in names])
    x = torch.from_numpy(batch).cuda()
    paths, masks = {}, {}
    for d in ("float32", "bfloat16"):
        paths[d], masks[d] = _paths_agree(G, tmp, x, d)
    if paths["float32"]["all"] < ARGMAX_AGREEMENT_MIN or \
            paths["bfloat16"]["decisive"] < ARGMAX_AGREEMENT_MIN:
        raise AssertionError(f"argmax agreement kernel vs plain below "
                             f"{ARGMAX_AGREEMENT_MIN}: {paths}")
    fn, _, _ = export.load_head(artifact, "cuda")
    served_equal = float(np.mean(np.stack([preds[n] for n in names]) == fn(x).cpu().numpy()))

    # Steady-state device rate of the served function at batch 8, and where
    # its device time goes (one profiled forward, kernels by name).
    fwd_ms = time_ms(lambda: fn(x), 10)
    with torch.profiler.profile(activities=[torch.profiler.ProfilerActivity.CPU,
                                            torch.profiler.ProfilerActivity.CUDA]) as prof:
        fn(x)
        torch.cuda.synchronize()
    # Self device time: the kernels themselves, not the aten ops that hold them.
    device_ms = [(e.key, e.self_device_time_total / 1e3, e.count)
                 for e in prof.key_averages() if e.self_device_time_total > 0]
    device_ms.sort(key=lambda r: -r[1])
    rec = {"phase": "serve", "images": summary["images"], "scored": summary["scored"],
           "run_serve_img_per_s": summary["img_per_s"],
           "run_serve_elapsed_s": summary["elapsed_s"], "miou": scores["miou"],
           "launches": launches, "forwards": forwards,
           "argmax_kernel_vs_plain": paths,
           "agreement_with_served_pngs": served_equal,
           "forward_ms_batch8": fwd_ms, "device_img_per_s": BATCH / fwd_ms * 1e3,
           "profiled_forward_device_ms_by_kernel": [
               {"kernel": k[:90], "ms": ms, "calls": n} for k, ms, n in device_ms[:14]],
           "peak_mem_gb": torch.cuda.max_memory_allocated() / 1e9}
    emit(rec)
    decisive = dict(zip(names, masks["bfloat16"].cpu().numpy()))
    return {"artifact": artifact, "img_dir": img_dir, "preds": preds, "decisive": decisive,
            "launches": launches, "record": rec}


def phase_http(served: dict) -> dict:
    import numpy as np
    from PIL import Image

    from cyclegan_tpu_torch.http_serve import make_server
    from cyclegan_tpu_torch.kernels import instance_norm as IN
    from cyclegan_tpu_torch.kernels import resblock as RB

    server = make_server(served["artifact"], port=0, device="cuda", max_batch=BATCH)
    thread = threading.Thread(target=server.serve_forever, daemon=True)
    thread.start()
    base = f"http://127.0.0.1:{server.server_address[1]}"
    try:
        with urllib.request.urlopen(base + "/healthz", timeout=60) as r:
            if r.status != 200 or json.load(r)["status"] != "ok":
                raise AssertionError("/healthz failed")
        names = sorted(served["preds"])[:8]
        fmts = ["png", "mask", "json"]

        def post(i: int):
            name = names[i]
            with open(os.path.join(served["img_dir"], name), "rb") as f:
                body = f.read()
            req = urllib.request.Request(f"{base}/predict?format={fmts[i % 3]}", data=body,
                                         headers={"Content-Type": "image/png"})
            t0 = time.perf_counter()
            with urllib.request.urlopen(req, timeout=120) as r:
                data, status = r.read(), r.status
            return name, fmts[i % 3], status, data, time.perf_counter() - t0

        IN.launches = RB.launches = 0
        with ThreadPoolExecutor(max_workers=4) as ex:
            results = list(ex.map(post, range(8)))
        launches = {"instance_norm_act": IN.launches, "residual_block_fused": RB.launches}
    finally:
        server.shutdown()
        server.server_close()
        thread.join(timeout=30)
    agreements, decisive_agreements = [], []
    for name, fmt, status, data, _ in results:
        if status != 200:
            raise AssertionError(f"POST /predict {name} {fmt}: HTTP {status}")
        ref = served["preds"][name]
        if fmt in ("png", "mask"):
            got = np.asarray(Image.open(io.BytesIO(data)))
            agreements.append(float(np.mean(got == ref)))
            keep = served["decisive"][name]
            decisive_agreements.append(float(np.mean(got[keep] == ref[keep])))
        else:
            hist = json.loads(data)["class_pixels"]
            if sum(hist.values()) != CROP * CROP:
                raise AssertionError(f"json histogram of {name} sums to {sum(hist.values())}")
    worst = min(decisive_agreements)
    if worst < HTTP_AGREEMENT_MIN:
        raise AssertionError(f"HTTP mask/png vs run_serve agreement off ties {worst} < "
                             f"{HTTP_AGREEMENT_MIN}")
    if launches["instance_norm_act"] == 0 or launches["residual_block_fused"] == 0:
        raise AssertionError(f"HTTP path bypassed the kernels: {launches}")
    lat = sorted(r[4] for r in results)
    rec = {"phase": "http", "requests": len(results), "all_200": True,
           "min_agreement_with_run_serve": min(agreements),
           "min_agreement_with_run_serve_off_ties": worst,
           "exact_matches": sum(a == 1.0 for a in agreements), "compared": len(agreements),
           "p50_latency_s": statistics.median(lat),
           "max_latency_s": lat[-1], "launches": launches}
    emit(rec)
    return rec


def kernels_line(summary: dict, launches: dict) -> dict:
    """One entry per kernel: bf16 (the path's type) totals over one forward
    of the main path at batch 8."""
    entries = []
    meta = {
        "instance_norm_act": ("cyclegan_tpu_torch/csrc/instance_norm.cu",
                              "cyclegan_tpu/kernels/instance_norm.py:126"),
        "residual_block_fused": ("cyclegan_tpu_torch/csrc/resblock.cu",
                                 "cyclegan_tpu/kernels/resblock.py:79"),
    }
    for name, (source, replaces) in meta.items():
        recs = summary[name]["bfloat16"]
        fwd = [r for r in recs if r["calls_per_forward"]]

        def total(key):
            return sum(r[key] * r["calls_per_forward"] for r in fwd)

        entries.append({
            "name": name, "route": "cuda", "source": source, "replaces": replaces,
            "launches": launches[name],
            "max_abs_err": max(r["max_abs_err"] for r in recs),
            "ms": total("ms"), "plain_ms": total("plain_ms"), "bound_ms": total("bound_ms"),
            "bound_by": fwd[0]["bound_by"], "library_ms": total("library_ms"),
            "per": f"one forward at batch {BATCH}, {CROP}x{CROP}, bf16: "
                   f"{sum(r['calls_per_forward'] for r in fwd)} calls"})
    return {"kernels": entries}


def main() -> int:
    import torch

    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device", file=sys.stderr)
        return 1
    if not os.path.isdir(os.path.join(HERE, "cyclegan_tpu_torch", "csrc")):
        print("chip_smoke: run from a checkout of the repository "
              "(cyclegan_tpu_torch/ not found beside this script)", file=sys.stderr)
        return 1
    sys.path.insert(0, HERE)
    t0 = time.perf_counter()
    smi = phase_device()
    summary = phase_kernels()
    with tempfile.TemporaryDirectory() as tmp:
        served = phase_serve(tmp)
        phase_http(served)
    emit({"phase": "done", "seconds": time.perf_counter() - t0})
    print(smi, flush=True)
    emit(kernels_line(summary, served["launches"]))
    emit({"ok": True, "device": {"platform": "gpu", "kind": torch.cuda.get_device_name(0),
                                 "count": torch.cuda.device_count()}})
    return 0


if __name__ == "__main__":
    sys.exit(main())
