#!/usr/bin/env python3
"""On-card smoke test of cyclegan_tpu_torch: one H100, a few minutes.

    python3 chip_smoke.py

Drives the port's main paths at full width, the serving path (ResNet-9
image->label generator, ngf 64, 21 classes, 256x256, bf16 compute over
float32 weights drawn from a seed) and the semi-supervised CycleGAN train
step of the ``voc_semisup_256`` preset on three routes through the trunk
(the default fused residual block; path A, ``CYCLEGAN_TPU_RESBLOCK=chunked``;
path B, ``use_dropout``), and prints one JSON line per phase:

1. device: the card, its power limit, and the parallel nvcc build of every
   kernel under cyclegan_tpu_torch/csrc (build seconds, ptxas registers,
   spills and warnings); the forward convolution's wgmma kernel must build
   with no spill and no wgmma serialisation (ptxas C7515);
2. kernels: each CUDA kernel against its plain PyTorch version at the main
   path's shapes (batch 8), float32 and bf16, with the stated tolerance and
   its time beside the plain version, one library call and the bound;
3. serve: export the artifact and run ``serve.run_serve`` over 16 seeded
   PNGs with ground truth on the card; the launch counters of both kernels
   must show the path went through them, and the kernel path's argmax must
   agree with the plain path's on one batch;
4. http: ``http_serve.make_server`` in a thread, /healthz and 8 POST
   /predict from 4 threads in the three formats, checked against step 3;
5. kernels_train: every kernel of the train step, forward and backward
   (the chunked block and the dropout trunk's weight gradient included),
   against its plain version at the train step's shapes, with its time, the
   plain version's, one library call's and the bound, per call and summed
   over one train step; two calls of each weight gradient and of each
   instance-norm kernel are bitwise equal; the fused block's VJP is held
   against the plain VJP on the kernel path's relu mask, and the mask's
   flips on their own (RELU_FLIP_SHARE); the chunked block's normalisation
   kernels alone (forward pair, VJP pair) with their device us a call
   beside the byte bound, a second call and a sample run alone bitwise
   equal to the first and to its place in the batch;
   then the tensor-core gradient convolutions alone (input gradient, weight
   gradient, conv_dw) at the trunk shapes on bf16 operands with a float32
   cotangent, at the float32 bars, and the forward convolution alone at the
   trunk shapes of training (batch 1 and 2) and serving (batch 8), on its
   tile and on every other tile it has, each call bitwise equal to a
   second one;
6. train: ``CycleGANTrainer.train_step`` of ``voc_semisup_256`` (two
   ResNet-9 generators, two 70x70 PatchGANs, pools of 50, Adam + LambdaLR,
   bf16 over float32) on one synthetic 256x256 batch with injected pool
   decisions: 3 steps on the kernels and 3 with the seams on the plain
   versions from the same weights; every parameter's step-1 gradient, the
   per-step losses of the two paths, every launch counter against the
   per-step count derived from the modules; then the median step time of
   each path, in turns, and one profiled step (the forward convolution's, the
   instance norm's and the chunked norm kernels' device ms and launches:
   one launch a C entry of either norm, or the phase fails);
7. train_chunked, train_dropout: the same for paths A and B; path A
   launches the chunked block 27 times a step forward and backward (its
   norm kernels 108 times) and no fused block, path B launches conv_dw 54
   times a step and no residual-block kernel;
8. graph_capture: whether torch.cuda.graph captures the instance norm's
   cooperative launches and a chunked block's forward and VJP, and whether
   a replay is bitwise equal (recorded, not required);
9. cli: ``python -m cyclegan_tpu_torch.main`` in process on the same
   preset over the synthetic dataset: --training for 2 epochs of 3 steps
   with a checkpoint every step, preempted at step 4 and relaunched,
   against an uninterrupted run from the same seed (per-step losses within
   the bf16 train-step bars; the largest weight difference and whether the
   two are bitwise equal recorded); --testing of the final checkpoint (one
   PNG per val image, mIoU and pixel accuracy within 1e-4 of the last
   validation); one epoch each of --steps_per_call 2 and --grad_accum 2.
   Every launch runs with the counters at 0 and must show kernels #1-#5
   launched as often as the modules derive for its train steps and eval
   forwards; steps/s from the logger, the loop's input wait and the
   validation seconds are recorded with the card's name and power limit.

Then the card's name and power limit, a ``{"kernels": [...]}`` line and,
last, ``{"ok": true, "device": {...}}``.
Any failure raises: the script exits non-zero and prints no ok line. It
imports nothing of JAX or the JAX package.
"""

from __future__ import annotations

import contextlib
import io
import json
import math
import os
import re
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
    # The chunked block (y, vhat, s): the same convolutions, statistics by
    # sum and sum of squares (var = E[v^2] - E[v]^2: the trunk's conv
    # outputs have |mean| well under their std, so the cancellation is
    # mild; the card test holds it at 1e-4 too). In bf16 the stored s (and
    # u) is itself rounded: a last-bit f32 difference flips it by one bf16
    # ulp (2^-6 at |s| < 4), which the normalisation multiplies by r2 (~1.5
    # at these weights) before y is rounded again, so y moves by up to
    # ~2^-5 + one ulp of y wherever |y| is small. On an H100 this script
    # measured 2^-5 against the fused block's bar of 2^-6 + 2^-6 |y|.
    ("residual_block_chunked", "float32"): (1e-4, 1e-4),
    ("residual_block_chunked", "bfloat16"): (2 ** -4, 2 ** -6),
    # Its float32 statistics [mu1, r1, mu2, r2] in either type.
    ("residual_block_chunked_stats", "float32"): (1e-4, 1e-4),
    ("residual_block_chunked_stats", "bfloat16"): (1e-4, 1e-4),
    # The forward convolution alone, bf16 operands: the products are exact
    # in float32, and the 2,304-term float32 sums run in another order (the
    # tensor cores' accumulation truncates); the card test's bar.
    ("conv3x3_reflect", "bfloat16"): (1e-4, 1e-4),
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

# The train step: the voc_semisup_256 preset at its published widths (ndf 64,
# 3 PatchGAN layers), batch 1. VOC2012 has 1,464 train segmentation images;
# 1/8 labeled gives 183 steps per epoch at batch 1 (the LambdaLR staircase).
TRAIN_PRESET = "voc_semisup_256"
NDF = 64
VOC_STEPS_PER_EPOCH = 183
TRAIN_STEPS = 3      # per path, for the loss comparison and the counters
TIMED_STEPS = 5      # per turn; turns plain, kernel, kernel, plain
# Backward tolerances, |kernel - plain| <= atol * max|plain| + rtol * |plain|
# (atol relative to the largest magnitude: a gradient's scale follows the
# cotangent's, not a fixed unit).
BWD_TOL = {
    # float32 sums over up to 8,192 pixels (dw) or 2,304 products (dgrad),
    # split and merged in another order than the plain version's.
    ("instance_norm_act_bwd", "float32"): (1e-5, 1e-4),
    ("residual_block_bwd", "float32"): (1e-5, 1e-4),
    # A bf16 dx rounds a float32 value that differs in its last bits: one
    # bf16 ulp is 2^-8 of the value.
    ("instance_norm_act_bwd", "bfloat16"): (2 ** -8, 2 ** -6),
    # The residual block recomputes its bf16 activation a = relu(IN(u)); the
    # kernel's tensor-core convolution and the plain float32 one round it at
    # other elements (one bf16 ulp, 2^-8, each), and each such flip passes
    # through the second convolution, two normalisation VJPs and an input
    # gradient into dx and dw before the final bf16 rounding.
    ("residual_block_bwd", "bfloat16"): (2 ** -7, 2 ** -5),
    # The chunked VJP from the same saved residuals: float32 sums in another
    # order; in bf16 the stored dv and the final dx round a float32 value
    # that differs in its last bits, as in the fused block's VJP.
    ("residual_block_chunked_bwd", "float32"): (1e-5, 1e-4),
    ("residual_block_chunked_bwd", "bfloat16"): (2 ** -7, 2 ** -5),
    # conv_dw: float32 products of the same inputs (bf16 operands are exact
    # in float32), summed in another order; float32 output in both types.
    # The tensor cores see float32 operands as three bf16 parts each (their
    # sum is the value to within 2^-24 of it), products (a, b) with a + b < 3.
    ("conv_dw", "float32"): (1e-5, 1e-4),
    ("conv_dw", "bfloat16"): (1e-5, 1e-4),
    # The gradient convolutions alone on the main path's mix: bf16
    # activations and weights, a float32 cotangent split into two bf16
    # parts, a float32 result. The float32 bar, as above.
    ("conv3x3_reflect_dgrad", "bfloat16"): (1e-5, 1e-4),
    ("conv3x3_reflect_wgrad", "bfloat16"): (1e-5, 1e-4),
}
# The bf16 and float32 block VJPs are held against the plain VJP evaluated
# on the kernel path's relu mask (relu_mask), at the bars above. The
# elements where the two paths' masks differ are held on their own: each
# within the forward convolution's rounding of zero (the threshold
# resblock.relu_mask_flips derives from the convolution's bar and rstd),
# and together at most this share of the plane. float32 reorderings of
# 2,304-term sums differ by ~1e-6 relative, so an honest kernel flips ~1e-6
# of a plane (an H100 showed 0 to 3 elements of a 1M- or 2M-element plane
# in the seeded cases); a mask that is wrong by design flips far more.
RELU_FLIP_SHARE = 1e-4
# The chunked route's rows a chunk (the JAX package's default).
HC = 8
# Per-step losses, kernel path vs plain path from the same weights, batch
# and pool decisions: {compute type: {loss: [(rtol, atol) of step 1, 2, 3]}}.
# Step 1 sees the same parameters: float32 sums in another order (~1e-6
# relative per op); bf16 activations rounded at other elements. Steps 2-3:
# Adam's first updates move every weight by about +-lr whatever its
# gradient's size, so gradients whose sign differs between the two paths
# move weights 2 lr = 4e-4 apart (2% of an N(0, 0.02) weight), and the
# early GAN dynamics amplify what differs (d_total goes 5 -> 14 -> 12 over
# these steps). On an H100 this script measured float32 agreeing to 1e-5 at
# step 2 and to 1.0e-3 / 3.2e-3 (g / d) at step 3, and bf16 d_total at step
# 3 differing by 2.7% and 4.2% in two runs (the plain path's own
# summation order changes from run to run). The float32 step-1 gradients
# below are the check of the kernels' gradients.
TRAIN_TOL = {
    "float32": {"g_total": [(1e-4, 0.0), (1e-2, 0.0), (1e-2, 0.0)],
                "d_total": [(1e-4, 1e-5), (1e-2, 1e-4), (1e-2, 1e-4)]},
    "bfloat16": {"g_total": [(1e-3, 0.0), (1e-1, 0.0), (1e-1, 0.0)],
                 "d_total": [(2e-3, 1e-3), (1e-1, 1e-3), (1e-1, 1e-3)]},
}
# float32 step-1 gradient of every weight (and of every bias no instance
# norm follows), kernel path vs plain path: |g_kernel - g_plain| /
# |g_plain| (norms per tensor) within this. The step's gradient is
# ill-conditioned: on an H100 the plain path run twice on the same inputs
# differed by up to 1e-3 of a tensor's norm (cuDNN's and the label
# gather's backward sum in an order that changes from run to run), and
# the kernel path, which rounds differently at every op, by up to 2.7e-3.
# The script measures that floor again in every run
# (float32_step1_grad_plain_vs_plain_*). A wrong gradient gives O(1).
GRAD_TOL_F32 = 1e-2


def grad_passes(a_dtype, b_dtype) -> int:
    """bf16 tensor-core passes of a gradient convolution on operands of
    these types: the products over their bf16 parts, as the kernels issue
    them (kernels/conv_dw.py::parts and ::passes)."""
    from cyclegan_tpu_torch.kernels import conv_dw as CD

    return CD.passes(CD.parts(a_dtype, b_dtype), CD.parts(b_dtype, a_dtype))


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


def graph_us(fn, reps: int = 10) -> float | None:
    """Device µs a call of ``fn``, timed as one CUDA graph of ``reps`` calls
    replayed (CUDA events around the replays: no host time); None where the
    graph does not capture."""
    import torch

    try:
        graph = torch.cuda.CUDAGraph()
        with torch.cuda.graph(graph):
            for _ in range(reps):
                fn()
    except Exception:  # a launch the graph cannot hold: no number
        return None
    return time_ms(graph.replay, 5) * 1e3 / reps


def bound(nbytes: float, flops: float | dict, dtype: str | None = None) -> tuple[float, str]:
    """Least time in ms for moving ``nbytes`` and doing ``flops`` of
    ``dtype`` work (or ``{dtype: flops}`` for work of several types, each at
    its own peak) on an H100, and which of the two bounds it."""
    work = flops if isinstance(flops, dict) else {dtype: flops}
    t_bytes = nbytes / HBM_BPS * 1e3
    t_ops = sum(f / PEAK_FLOPS[d] for d, f in work.items()) * 1e3
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
                 if "registers" in ln or "spill" in ln or "warning" in ln
                 or re.search(r"\(C\d{4}\)", ln)]
             for n, log in logs.items()}
    faults = ptxas_faults(logs["resblock"], "conv3x3_wgmma")
    emit({"phase": "device", "kind": torch.cuda.get_device_name(0),
          "count": torch.cuda.device_count(), "nvidia_smi": smi,
          "torch": torch.__version__, "cuda": torch.version.cuda,
          "build_s": build_s, "ptxas": ptxas, "conv3x3_wgmma_ptxas_faults": faults})
    if faults:
        raise AssertionError(f"conv3x3_wgmma: ptxas reports {faults}")
    return smi


def ptxas_faults(log: str, kernel: str) -> list:
    """What ptxas -v says against ``kernel`` (a substring of its mangled
    name) in one source's build log: a wgmma serialisation warning (C7515:
    every wgmma of that source is this kernel's) or spill stores or loads
    in the properties of one of its instances."""
    faults, fn = [], ""
    for ln in log.splitlines():
        m = re.search(r"(?:Compiling entry function|Function properties for) '?([\w$.]+)", ln)
        if m:
            fn = m.group(1)
        if "C7515" in ln:
            faults.append(ln.strip())
        spill = re.search(r"(\d+) bytes spill stores, (\d+) bytes spill loads", ln)
        if spill and kernel in fn and (int(spill.group(1)) or int(spill.group(2))):
            faults.append(f"{fn}: {ln.strip()}")
    return faults


def phase_kernels() -> None:
    """The forwards against their plain versions at the serving path's
    shapes (batch 8)."""
    import torch
    import torch.nn.functional as F

    from cyclegan_tpu_torch.kernels import instance_norm as IN
    from cyclegan_tpu_torch.kernels import resblock as RB

    torch.backends.cudnn.allow_tf32 = False
    torch.backends.cuda.matmul.allow_tf32 = False
    g = torch.Generator(device="cuda").manual_seed(0)
    dev = "cuda"

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
        del x, out, ref
    torch.cuda.empty_cache()


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
           "profiled_forward_conv3x3_fwd": conv_fwd_device_ms(device_ms),
           "profiled_forward_instance_norm": in_device_ms(device_ms),
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


def compare_bwd(kernel: str, out, ref, dtype: str) -> dict:
    import torch

    atol, rtol = BWD_TOL[(kernel, dtype)]
    d = (out.float() - ref.float()).abs()
    allowed = atol * ref.float().abs().max() + rtol * ref.float().abs()
    worst = float((d / allowed).max())
    return {"max_abs_err": float(d.max()), "max_abs_ref": float(ref.float().abs().max()),
            "atol_of_max": atol, "rtol": rtol, "worst_err_over_tol": worst,
            "ok": bool(worst <= 1.0 and torch.isfinite(out).all())}


def block_vjp_check(x, dy, w1, b1, w2, b2, grads, dname: str) -> tuple[dict, dict]:
    """The fused residual block's VJP on the card (``grads``: its dx, dw1,
    dw2) against the plain VJP on the kernel path's relu mask (``a > 0`` of
    ``bwd_dx_cuda``'s recompute, bitwise the Function's) at BWD_TOL; and the
    mask's flips against the plain version's own, at RELU_FLIP_SHARE."""
    from cyclegan_tpu_torch.kernels import resblock as RB

    mask = RB.bwd_dx_cuda(x, dy, w1, b1, w2, b2, 1e-5)[1] > 0
    ref = RB.residual_block_bwd_plain(x, dy, w1, b1, w2, b2, relu_mask=mask)
    checks = {n: compare_bwd("residual_block_bwd", o, r, dname)
              for n, o, r in zip(("dx", "dw1", "dw2"), grads, ref)}
    flips, worst = RB.relu_mask_flips(x, w1, b1, mask,
                                      conv_tol=TOL[("conv3x3_reflect", "bfloat16")])
    return checks, {"relu_mask_flips": flips, "flip_share": flips / mask.numel(),
                    "flip_share_max": RELU_FLIP_SHARE, "flip_worst_over_threshold": worst,
                    "ok": worst <= 1.0 and flips <= RELU_FLIP_SHARE * mask.numel()}


def train_in_cases() -> list:
    """(shape, act, calls per train step) of the standalone instance norm,
    by reading train/cyclegan.py: per generator apply two norms at 256^2x64,
    two at 128^2x128 and one at 64^2x256 (relu); G_i2l and G_l2i run at
    batch 2 (the fused concatenations), G_i2l again at batch 1 (rec_lab).
    Per PatchGAN apply one norm at 64^2x128, 32^2x256 and 31^2x512 (leaky);
    D_lab and D_img run at batch 1 in the G phase and batch 2 in the D phase."""
    cases = []
    for b, applies in ((2, 2), (1, 1)):
        cases += [((b, CROP, CROP, NGF), "relu", 2 * applies),
                  ((b, CROP // 2, CROP // 2, NGF * 2), "relu", 2 * applies),
                  ((b, CROP // 4, CROP // 4, NGF * 4), "relu", applies)]
    for b in (1, 2):
        cases += [((b, CROP // 4, CROP // 4, NDF * 2), "leaky", 2),
                  ((b, CROP // 8, CROP // 8, NDF * 4), "leaky", 2),
                  ((b, CROP // 8 - 1, CROP // 8 - 1, NDF * 8), "leaky", 2)]
    return cases


def _lib_act(y, act: str):
    import torch
    import torch.nn.functional as F

    return torch.relu(y) if act == "relu" else F.leaky_relu(y, 0.2) if act == "leaky" else y


def phase_kernels_train() -> dict:
    """The train step's kernels against their plain versions: the VJPs
    through the autograd Functions (dtypes x acts x skip), then every shape
    of one train step in bf16, timed, for the kernels line."""
    import torch
    import torch.nn.functional as F

    from cyclegan_tpu_torch.kernels import instance_norm as IN
    from cyclegan_tpu_torch.kernels import resblock as RB

    g = torch.Generator(device="cuda").manual_seed(1)
    dev = "cuda"

    def randn(shape, dtype=torch.float32, scale=1.0, shift=0.0):
        return (torch.randn(shape, device=dev, generator=g) * scale + shift).to(dtype)

    def fail_if(bad: bool, what: str, rec: dict):
        emit(rec)
        if bad:
            raise AssertionError(f"{what} disagrees with its plain version: {rec}")

    # The instance-norm VJP through the Function, every act, skip on/off.
    shape = (2, CROP // 4, CROP // 4, NGF * 4)
    for dtype in (torch.float32, torch.bfloat16):
        dname = str(dtype).split(".")[1]
        for act in ("none", "relu", "leaky"):
            for has_skip in (False, True):
                x = randn(shape, dtype, 2.0, 0.5).requires_grad_()
                skip = randn(shape, dtype).requires_grad_() if has_skip else None
                dy = randn(shape, dtype)
                y = IN.instance_norm_act(x, skip, 1e-5, act)
                grads = torch.autograd.grad(y, [x] + ([skip] if has_skip else []), dy)
                mean, rstd = IN.instance_norm_stats_plain(x.detach())
                ref = IN.instance_norm_act_bwd_plain(x.detach(), dy, mean, rstd, act)
                res = compare_bwd("instance_norm_act_bwd", grads[0], ref, dname)
                dskip_exact = (not has_skip) or torch.equal(grads[1], dy)
                fail_if(not (res["ok"] and dskip_exact and y.grad_fn is not None),
                        "instance_norm_act VJP",
                        {"phase": "kernels_train", "kernel": "instance_norm_act_bwd",
                         "via": "autograd.Function", "shape": list(shape), "dtype": dname,
                         "act": act, "skip": has_skip, "dskip_equals_dy": dskip_exact, **res})

    recs = {k: [] for k in ("instance_norm_act", "instance_norm_act_bwd",
                            "residual_block_fused", "residual_block_bwd_dx",
                            "residual_block_bwd_dw")}
    for shape, act, calls in train_in_cases():
        x, dy = randn(shape, torch.bfloat16, 2.0, 0.5), randn(shape, torch.bfloat16)
        y, y2 = torch.empty_like(x), torch.empty_like(x)
        mean, rstd = IN.launch(x, None, y, 1e-5, act)
        mean2, rstd2 = IN.launch(x, None, y2, 1e-5, act)
        dx, dx2 = torch.empty_like(x), torch.empty_like(x)
        IN.launch_bwd(x, dy, mean, rstd, dx, act)
        IN.launch_bwd(x, dy, mean, rstd, dx2, act)
        torch.cuda.synchronize()
        bitwise = {"instance_norm_act": torch.equal(y, y2) and torch.equal(mean, mean2)
                   and torch.equal(rstd, rstd2),
                   "instance_norm_act_bwd": torch.equal(dx, dx2)}
        pm, pr = IN.instance_norm_stats_plain(x)
        res_f = compare("instance_norm_act", y, IN.instance_norm_act_plain(x, None, 1e-5, act),
                        "bfloat16")
        res_b = compare_bwd("instance_norm_act_bwd", dx,
                            IN.instance_norm_act_bwd_plain(x, dy, pm, pr, act), "bfloat16")
        xl = x.permute(0, 3, 1, 2).detach().requires_grad_()
        yl = _lib_act(F.instance_norm(xl, eps=1e-5), act)
        dyl = dy.permute(0, 3, 1, 2)
        nbytes = x.numel() * x.element_size()
        with torch.no_grad():
            fwd = {"ms": time_ms(lambda: IN.instance_norm_act(x, None, 1e-5, act), 20),
                   "plain_ms": time_ms(lambda: IN.instance_norm_act_plain(x, None, 1e-5, act), 5),
                   "library_ms": time_ms(lambda: _lib_act(F.instance_norm(
                       x.permute(0, 3, 1, 2), eps=1e-5), act), 20)}
        fwd["graph_us_per_call"] = graph_us(lambda: IN.launch(x, None, y, 1e-5, act))
        bwd = {"ms": time_ms(lambda: IN.launch_bwd(x, dy, mean, rstd, dx, act), 20),
               "graph_us_per_call": graph_us(lambda: IN.launch_bwd(x, dy, mean, rstd, dx, act)),
               "plain_ms": time_ms(lambda: IN.instance_norm_act_bwd_plain(x, dy, pm, pr, act), 5),
               "library_ms": time_ms(lambda: torch.autograd.grad(yl, xl, dyl, retain_graph=True),
                                     20)}
        for name, res, t, nb, fl in (
                ("instance_norm_act", res_f, fwd, 2 * nbytes, 8.0 * x.numel()),
                ("instance_norm_act_bwd", res_b, bwd, 3 * nbytes, 12.0 * x.numel())):
            b_ms, b_by = bound(nb, fl, "float32")
            rec = {"phase": "kernels_train", "kernel": name, "shape": list(shape),
                   "dtype": "bfloat16", "act": act, **res, **t, "bound_ms": b_ms,
                   "bound_by": b_by, "us_per_call": t["ms"] * 1e3, "bound_us": b_ms * 1e3,
                   "second_call_bitwise_equal": bitwise[name], "calls_per_step": calls}
            fail_if(not (res["ok"] and bitwise[name]), name, rec)
            recs[name].append(rec)
        del x, dy, y, y2, dx, dx2, xl, yl

    c = NGF * 4
    for dtype, b, calls in ((torch.float32, 2, 0), (torch.bfloat16, 2, 18),
                            (torch.bfloat16, 1, 9)):
        dname = str(dtype).split(".")[1]
        shape = (b, CROP // 4, CROP // 4, c)
        x, dy = randn(shape, dtype), randn(shape, dtype)
        w1, w2 = randn((3, 3, c, c), dtype, 0.02), randn((3, 3, c, c), dtype, 0.02)
        b1, b2 = randn((c,), dtype, 0.01), randn((c,), dtype, 0.01)
        leaves = [t.clone().requires_grad_() for t in (x, w1, b1, w2, b2)]
        y = RB.residual_block_fused(*leaves)
        got = torch.autograd.grad(y, leaves, dy)
        checks, flip = block_vjp_check(x, dy, w1, b1, w2, b2, (got[0], got[1], got[3]), dname)
        bias_zero = all(torch.count_nonzero(got[i]) == 0 for i in (2, 4))
        dw_check = {"max_abs_err": max(checks["dw1"]["max_abs_err"], checks["dw2"]["max_abs_err"]),
                    "worst_err_over_tol": max(checks["dw1"]["worst_err_over_tol"],
                                              checks["dw2"]["worst_err_over_tol"]),
                    "ok": checks["dw1"]["ok"] and checks["dw2"]["ok"]}
        ok = all(v["ok"] for v in checks.values()) and flip["ok"] and bias_zero and \
            y.grad_fn is not None
        fail_if(not ok, "residual_block_fused VJP",
                {"phase": "kernels_train", "kernel": "residual_block_bwd", "via":
                 "autograd.Function", "shape": list(shape), "dtype": dname,
                 "bias_grads_exactly_zero": bias_zero, "reference": "plain VJP on the "
                 "kernel path's relu mask", **{f"mask_{k}": v for k, v in flip.items()},
                 **{f"{n}_{k}": r[k] for n, r in checks.items()
                    for k in ("max_abs_err", "worst_err_over_tol")}})
        if not calls:
            continue
        res_f = compare("residual_block_fused", RB.residual_block_fused(x, w1, b1, w2, b2),
                        RB.residual_block_plain(x, w1, b1, w2, b2), dname)
        dxk, a, ds, du, g_parts = RB.bwd_dx_cuda(x, dy, w1, b1, w2, b2, 1e-5)
        # Library yardstick: reflect pad + cuDNN conv + F.instance_norm, NCHW
        # over channels_last, autograd for dx alone and for (dw1, dw2) alone.
        xl = x.permute(0, 3, 1, 2).detach().requires_grad_()
        W1, W2 = [w.permute(3, 2, 0, 1).contiguous(memory_format=torch.channels_last)
                  .requires_grad_() for w in (w1, w2)]

        def lib_rb(xn=xl):
            h = F.conv2d(F.pad(xn, (1, 1, 1, 1), mode="reflect"), W1, b1)
            h = torch.relu(F.instance_norm(h, eps=1e-5))
            h = F.conv2d(F.pad(h, (1, 1, 1, 1), mode="reflect"), W2, b2)
            return xn + F.instance_norm(h, eps=1e-5)

        yl, dyl = lib_rb(), dy.permute(0, 3, 1, 2)
        m = b * shape[1] * shape[2]
        conv = 2.0 * m * 9 * c * c   # flops of one 3x3 convolution
        elt = x.element_size()
        act_b, w_b = x.numel() * elt, 2 * (w1.numel() + c) * elt
        with torch.no_grad():
            t_fwd = {"ms": time_ms(lambda: RB.residual_block_fused(x, w1, b1, w2, b2), 10),
                     "plain_ms": time_ms(lambda: RB.residual_block_plain(x, w1, b1, w2, b2), 5),
                     "library_ms": time_ms(lambda: lib_rb(xl.detach()), 10)}
        t_dx = {"ms": time_ms(lambda: RB.bwd_dx_cuda(x, dy, w1, b1, w2, b2, 1e-5), 10),
                "plain_ms": time_ms(lambda: RB.bwd_dx_plain(x, dy, w1, b1, w2, b2), 3),
                "library_ms": time_ms(lambda: torch.autograd.grad(yl, xl, dyl,
                                                                  retain_graph=True), 10)}
        t_dw = {"ms": time_ms(lambda: RB.bwd_dw_cuda(x, a, ds, du, dtype, g_parts), 10),
                "plain_ms": time_ms(lambda: RB.bwd_dw_plain(x, a, ds, du), 3),
                "library_ms": time_ms(lambda: torch.autograd.grad(yl, [W1, W2], dyl,
                                                                  retain_graph=True), 10)}
        f32_b = ds.numel() * 4
        # Work at the rate of the products the kernels issue: the bf16
        # recompute convolutions, and the gradient convolutions' passes over
        # the bf16 parts (old_work: the same gradients at the float32 rate,
        # the bound of their float32 FFMA predecessors).
        passes = grad_passes(dtype, torch.float32)
        for name, res, t, nb, work, old_work in (
                ("residual_block_fused", res_f, t_fwd, 2 * act_b + w_b,
                 {"bfloat16": 2 * conv}, None),
                ("residual_block_bwd_dx", checks["dx"], t_dx, 3 * act_b + w_b,
                 {"bfloat16": 2 * conv + passes * 2 * conv},
                 {"bfloat16": 2 * conv, "float32": 2 * conv}),
                ("residual_block_bwd_dw", dw_check, t_dw,
                 2 * act_b + 2 * f32_b + 2 * w1.numel() * elt, {"bfloat16": passes * 2 * conv},
                 {"float32": 2 * conv})):
            b_ms, b_by = bound(nb, work)
            rec = {"phase": "kernels_train", "kernel": name, "shape": list(shape),
                   "dtype": dname, **res, **t, "bound_ms": b_ms, "bound_by": b_by,
                   "gflop": sum(work.values()) / 1e9, "calls_per_step": calls}
            if old_work is not None:
                rec.update(bf16_passes=passes, bound_ms_f32_rate=bound(nb, old_work)[0])
            fail_if(not res["ok"], name, rec)
            recs[name].append(rec)
        del x, dy, leaves, y, got, dxk, a, ds, du, g_parts, xl, yl
    torch.cuda.empty_cache()
    recs.update(kernels_train_chunked_dw(randn, fail_if))
    recs["grad_convs"] = kernels_grad_convs(randn, fail_if)
    recs["conv3x3_reflect"] = kernels_conv_fwd(randn, fail_if)
    return recs


def _max_check(checks: dict) -> dict:
    return {"max_abs_err": max(r["max_abs_err"] for r in checks.values()),
            "worst_err_over_tol": max(r["worst_err_over_tol"] for r in checks.values()),
            "ok": all(r["ok"] for r in checks.values())}


def chunked_norm_halves(randn, x, dy) -> dict:
    """The chunked block's normalisation kernels alone (csrc/resblock_chunked.cu,
    one launch a call) on seeded float32 convolution outputs and x's type:
    the forward's two calls (IN1 of u, IN2 of s32 with the skip x) and the
    VJP's two (IN2 of dy, s; IN1 of da, vhat), each pair's device us a call
    as a CUDA-graph replay and eagerly (CUDA events around back-to-back
    calls, host included), beside its byte bound (each input read once,
    each output written once); a second call bitwise equal, and sample 1 of
    a batch of 2 equal to the same sample alone."""
    import torch

    from cyclegan_tpu_torch.kernels import resblock_chunked as RC

    shape, eps = x.shape, 1e-5
    u, s32, da = (randn(shape, torch.float32, 2.0, 0.5) for _ in range(3))

    def run(u, s32, da, x, dy):
        f32 = dict(dtype=torch.float32, device=x.device)
        stats = torch.empty((x.shape[0], 4, x.shape[-1]), **f32)
        vh, a, s, y, dv, a2 = (torch.empty_like(x) for _ in range(6))
        ds, du = torch.empty(x.shape, **f32), torch.empty(x.shape, **f32)

        def fwd():
            RC.in_fwd(u, stats, x, vh, a, HC, eps, 1)
            RC.in_fwd(s32, stats, x, s, y, HC, eps, 2)

        def vjp():
            RC.in_vjp(dy, s, stats, ds, HC, 2)
            RC.in_vjp(da, vh, stats, du, HC, 1, dv=dv, a=a2)

        return fwd, vjp, {"fwd": (stats, vh, a, s, y), "vjp": (ds, dv, a2, du)}

    fwd, vjp, outs = run(u, s32, da, x, dy)
    fwd()
    vjp()
    first = {k: [t.clone() for t in v] for k, v in outs.items()}
    fwd()
    vjp()
    alone = None
    if shape[0] > 1:
        f1, v1, alone = run(*(t[1:2].clone() for t in (u, s32, da, x, dy)))
        f1()
        v1()
    torch.cuda.synchronize()
    p = x.numel() * x.element_size()          # one plane of x's type
    f = x.numel() * 4                          # one float32 plane
    nbytes = {"fwd": (f + 2 * p) + (f + p + 2 * p), "vjp": (2 * p + f) + (f + p + 2 * p + f)}
    rec = {}
    for side, fn in (("fwd", fwd), ("vjp", vjp)):
        b_ms, _ = bound(nbytes[side], 0.0, "float32")
        rec[side] = {
            "calls": 2, "shape": list(shape), "dtype": str(x.dtype).split(".")[1], "hc": HC,
            "graph_us_per_pair": graph_us(fn), "eager_us_per_pair": time_ms(fn, 20) * 1e3,
            "bound_us": b_ms * 1e3, "bound_by": "bytes", "bytes": nbytes[side],
            "second_call_bitwise_equal": all(torch.equal(a, b)
                                             for a, b in zip(first[side], outs[side])),
            "sample_alone_bitwise_equal": None if alone is None else all(
                torch.equal(a[1:2], b) for a, b in zip(first[side], alone[side]))}
    return rec


def kernels_train_chunked_dw(randn, fail_if) -> dict:
    """TPU kernels #6 and #7 (the chunked block, path A) and #8 (conv_dw,
    path B) against their plain versions at the train step's trunk shapes,
    float32 and bf16, timed, with bitwise repeatability of their dw."""
    import torch
    import torch.nn.functional as F

    from cyclegan_tpu_torch.kernels import conv_dw as CD
    from cyclegan_tpu_torch.kernels import resblock_chunked as RC

    recs = {"residual_block_chunked": [], "residual_block_chunked_bwd": [], "conv_dw": []}
    c = NGF * 4
    # (dtype, batch, chunked calls per step, conv_dw calls per step): the
    # generator applies at batch 2 and 1 (see train_in_cases).
    for dtype, b, rc_calls, dw_calls in ((torch.float32, 2, 0, 0), (torch.bfloat16, 2, 18, 36),
                                         (torch.bfloat16, 1, 9, 18)):
        dname = str(dtype).split(".")[1]
        shape = (b, CROP // 4, CROP // 4, c)
        x, dy = randn(shape, dtype), randn(shape, dtype)
        w1, w2 = randn((3, 3, c, c), dtype, 0.02), randn((3, 3, c, c), dtype, 0.02)
        b1, b2 = randn((c,), dtype, 0.01), randn((c,), dtype, 0.01)

        # #6: y, vhat, s and the statistics against the plain forward.
        y, vhat, s, stats = RC._fwd_cuda(x, w1, b1, w2, b2, 1e-5, HC)
        ref = RC.residual_block_chunked_plain(x, w1, b1, w2, b2, 1e-5, HC)
        norms = chunked_norm_halves(randn, x, dy)
        torch.cuda.synchronize()
        fwd = {n: compare("residual_block_chunked", o, r, dname)
               for n, o, r in zip(("y", "vhat", "s"), (y, vhat, s), ref)}
        fwd["stats"] = compare("residual_block_chunked_stats", stats, ref[3], dname)
        # #7 through the Function (its own saved residuals), against the plain
        # VJP from the same residuals; exactly zero bias gradients; a second
        # backward bitwise equal.
        leaves = [t.clone().requires_grad_() for t in (x, w1, b1, w2, b2)]
        out = RC.residual_block_chunked(*leaves, 1e-5, HC)
        got = torch.autograd.grad(out, leaves, dy)
        ref_b = RC.residual_block_chunked_bwd_plain(x, dy, vhat, s, stats, w1, w2, HC)
        again = RC._bwd_cuda(x, dy, vhat, s, stats, w1, w2, HC)
        torch.cuda.synchronize()
        bwd = {n: compare_bwd("residual_block_chunked_bwd", o, r, dname)
               for n, o, r in zip(("dx", "dw1", "dw2"), (got[0], got[1], got[3]), ref_b)}
        bias_zero = all(torch.count_nonzero(got[i]) == 0 for i in (2, 4))
        bitwise = all(torch.equal(a_, g_) for a_, g_ in zip(again, (got[0], got[1], got[3])))
        # #8 on the padded input of the trunk convolution and its gradient.
        xp = F.pad(x.permute(0, 3, 1, 2), (1, 1, 1, 1), mode="reflect").permute(0, 2, 3, 1)
        xp = xp.contiguous()
        dw = CD.conv_dw(xp, dy)
        dw_ref = CD.conv_dw_plain(xp, dy)
        dw_bitwise = torch.equal(dw, CD.conv_dw(xp, dy))
        torch.cuda.synchronize()
        dwc = compare_bwd("conv_dw", dw, dw_ref, dname)

        # Library yardsticks: reflect pad + cuDNN conv + F.instance_norm,
        # forward, and autograd for (dx, dw1, dw2); conv2d_weight for #8.
        xl = x.permute(0, 3, 1, 2).detach().requires_grad_()
        W1, W2 = [w.permute(3, 2, 0, 1).contiguous(memory_format=torch.channels_last)
                  .requires_grad_() for w in (w1, w2)]

        def lib_rb(xn=xl):
            h = F.conv2d(F.pad(xn, (1, 1, 1, 1), mode="reflect"), W1, b1)
            h = torch.relu(F.instance_norm(h, eps=1e-5))
            h = F.conv2d(F.pad(h, (1, 1, 1, 1), mode="reflect"), W2, b2)
            return xn + F.instance_norm(h, eps=1e-5)

        yl, dyl = lib_rb(), dy.permute(0, 3, 1, 2)
        xpl, dyn = xp.permute(0, 3, 1, 2), dy.permute(0, 3, 1, 2)
        with torch.no_grad():
            t_fwd = {"ms": time_ms(lambda: RC._fwd_cuda(x, w1, b1, w2, b2, 1e-5, HC), 10),
                     "plain_ms": time_ms(lambda: RC.residual_block_chunked_plain(
                         x, w1, b1, w2, b2, 1e-5, HC), 5),
                     "library_ms": time_ms(lambda: lib_rb(xl.detach()), 10)}
            t_dw = {"ms": time_ms(lambda: CD.conv_dw(xp, dy), 10),
                    "plain_ms": time_ms(lambda: CD.conv_dw_plain(xp, dy), 5),
                    "library_ms": time_ms(lambda: torch.nn.grad.conv2d_weight(
                        xpl, (c, c, 3, 3), dyn), 10)}
        t_bwd = {"ms": time_ms(lambda: RC._bwd_cuda(x, dy, vhat, s, stats, w1, w2, HC), 10),
                 "plain_ms": time_ms(lambda: RC.residual_block_chunked_bwd_plain(
                     x, dy, vhat, s, stats, w1, w2, HC), 3),
                 "library_ms": time_ms(lambda: torch.autograd.grad(
                     yl, [xl, W1, W2], dyl, retain_graph=True), 10)}
        m = b * shape[1] * shape[2]
        conv = 2.0 * m * 9 * c * c
        elt = x.element_size()
        act_b, w_b = x.numel() * elt, 2 * (w1.numel() + c) * elt
        stats_b = stats.numel() * 4
        # Passes over the bf16 parts: the chunked VJP's gradients on float32
        # cotangents; conv_dw's operands share x's type (one pass in bf16).
        passes, dw_passes = grad_passes(dtype, torch.float32), grad_passes(dtype, dtype)
        for name, res, t, nb, work, old_work, calls in (
                # reads x and the weights; writes y, vhat, s and the stats.
                ("residual_block_chunked", _max_check(fwd), t_fwd,
                 4 * act_b + w_b + stats_b, {dname: 2 * conv}, None, rc_calls),
                # reads x, dy, vhat, s, the stats, w1, w2; writes dx, dw1, dw2;
                # two input and two weight gradients on float32 cotangents.
                ("residual_block_chunked_bwd", _max_check(bwd), t_bwd,
                 5 * act_b + stats_b + 4 * w1.numel() * elt, {"bfloat16": passes * 4 * conv},
                 {"float32": 4 * conv}, rc_calls),
                # reads xp and dy; writes the float32 dw.
                ("conv_dw", dwc, t_dw, xp.numel() * elt + act_b + w1.numel() * 4,
                 {"bfloat16": dw_passes * conv}, {dname: conv}, dw_calls)):
            b_ms, b_by = bound(nb, work)
            rec = {"phase": "kernels_train", "kernel": name, "shape": list(shape),
                   "dtype": dname, **res, **t, "bound_ms": b_ms, "bound_by": b_by,
                   "gflop": sum(work.values()) / 1e9, "calls_per_step": calls, "hc": HC}
            if old_work is not None:
                rec.update(bf16_passes=passes if name.endswith("bwd") else dw_passes,
                           bound_ms_f32_rate=bound(nb, old_work)[0])
            if name == "residual_block_chunked":
                rec.update(checks=fwd, norm_halves=norms["fwd"])
            elif name == "residual_block_chunked_bwd":
                rec.update(checks=bwd, bias_grads_exactly_zero=bias_zero,
                           second_call_bitwise_equal=bitwise, norm_halves=norms["vjp"])
            else:
                rec["second_call_bitwise_equal"] = dw_bitwise
            ok = res["ok"] and (name == "residual_block_chunked" or
                                (bias_zero and bitwise if name.endswith("bwd") else dw_bitwise))
            if name.startswith("residual_block_chunked"):
                side = norms["fwd" if name == "residual_block_chunked" else "vjp"]
                ok = ok and side["second_call_bitwise_equal"] and \
                    side["sample_alone_bitwise_equal"] is not False
            fail_if(not ok, name, rec)
            if calls:
                recs[name].append(rec)
        del x, dy, leaves, out, got, ref, ref_b, again, y, vhat, s, xp, xl, yl
    torch.cuda.empty_cache()
    return recs


def kernels_grad_convs(randn, fail_if) -> list:
    """The gradient convolutions alone at the trunk shapes (batch 2 and 1,
    64x64x256) on the main path's mix: bf16 activations and weights with a
    float32 cotangent (conv_dw: bf16 input and output gradient, as path B
    calls it), against their plain versions on the same values at the
    float32 bars of BWD_TOL; each weight gradient twice, bitwise equal. The
    whole-block VJPs above are held at the looser bf16 bars, which absorb
    the recompute's rounding flips; these are not."""
    import torch
    import torch.nn.functional as F

    from cyclegan_tpu_torch.kernels import conv_dw as CD
    from cyclegan_tpu_torch.kernels import resblock as RB

    c, recs = NGF * 4, []
    for b in (2, 1):
        shape = (b, CROP // 4, CROP // 4, c)
        x, w = randn(shape, torch.bfloat16), randn((3, 3, c, c), torch.bfloat16, 0.02)
        g, dy = randn(shape), randn(shape, torch.bfloat16)
        xp = F.pad(x.permute(0, 3, 1, 2), (1, 1, 1, 1), mode="reflect")
        xpl, wl = xp, w.permute(3, 2, 0, 1).contiguous(memory_format=torch.channels_last)
        xp = xp.permute(0, 2, 3, 1).contiguous()
        gl, dyl = g.to(torch.bfloat16).permute(0, 3, 1, 2), dy.permute(0, 3, 1, 2)
        da = torch.empty(shape, device="cuda")
        RB.conv3x3_reflect_dgrad(g, w, da)
        dw, dw_again = RB.conv3x3_reflect_wgrad(x, g), RB.conv3x3_reflect_wgrad(x, g)
        cd, cd_again = CD.conv_dw(xp, dy), CD.conv_dw(xp, dy)
        torch.cuda.synchronize()
        conv = 2.0 * b * shape[1] * shape[2] * 9 * c * c
        act_b = x.numel() * 2
        # (name, result, bitwise, kernel, plain, library, bytes, bf16 passes)
        cases = (
            ("conv3x3_reflect_dgrad", compare_bwd(
                "conv3x3_reflect_dgrad", da, RB.conv3x3_reflect_dgrad_plain(g, w), "bfloat16"),
             True, lambda: RB.conv3x3_reflect_dgrad(g, w, da),
             lambda: RB.conv3x3_reflect_dgrad_plain(g, w),
             lambda: torch.nn.grad.conv2d_input(xpl.shape, wl, gl),
             2 * g.numel() * 4 + w.numel() * 2, grad_passes(w.dtype, g.dtype)),
            ("conv3x3_reflect_wgrad", compare_bwd(
                "conv3x3_reflect_wgrad", dw, RB.conv3x3_reflect_wgrad_plain(x, g), "bfloat16"),
             torch.equal(dw, dw_again), lambda: RB.conv3x3_reflect_wgrad(x, g),
             lambda: RB.conv3x3_reflect_wgrad_plain(x, g),
             lambda: torch.nn.grad.conv2d_weight(xpl, (c, c, 3, 3), gl),
             act_b + g.numel() * 4 + w.numel() * 4, grad_passes(x.dtype, g.dtype)),
            ("conv_dw", compare_bwd("conv_dw", cd, CD.conv_dw_plain(xp, dy), "bfloat16"),
             torch.equal(cd, cd_again), lambda: CD.conv_dw(xp, dy),
             lambda: CD.conv_dw_plain(xp, dy),
             lambda: torch.nn.grad.conv2d_weight(xpl, (c, c, 3, 3), dyl),
             xp.numel() * 2 + act_b + w.numel() * 4, grad_passes(xp.dtype, dy.dtype)))
        for name, res, bitwise, fn, plain, lib, nb, passes in cases:
            b_ms, b_by = bound(nb, {"bfloat16": passes * conv})
            ms = time_ms(fn, 20)
            rec = {"phase": "kernels_train", "kernel": name, "via": "isolated",
                   "shape": list(shape), "dtype": "bfloat16",
                   "cotangent": "bfloat16" if name == "conv_dw" else "float32", **res,
                   "second_call_bitwise_equal": bitwise, "bf16_passes": passes, "ms": ms,
                   "plain_ms": time_ms(plain, 5), "library_ms": time_ms(lib, 20),
                   "bound_ms": b_ms, "bound_by": b_by,
                   "tflops_issued": passes * conv / 1e9 / ms}
            fail_if(not (res["ok"] and bitwise), name, rec)
            recs.append(rec)
        del x, w, g, dy, xp, xpl, da, dw, dw_again, cd, cd_again
    torch.cuda.empty_cache()
    return recs


def kernels_conv_fwd(randn, fail_if) -> list:
    """The bf16 forward convolution alone at the trunk shape (64x64x256 ->
    256): batch 1 and 2 (training: per step 36 and 72 calls, the fused
    blocks' forwards and their backwards' recomputes) and batch 8 (serving:
    18 calls a forward). Against its plain version at the card test's bar,
    a second call bitwise equal; its time beside the plain version's, the
    bound, TFLOP/s issued, its grid and cuDNN's conv2d on the reflect-padded
    channels_last input (a yardstick only). Then every tile of CONV_TILES,
    checked the same way and timed, for the plan's choice."""
    import torch
    import torch.nn.functional as F

    from cyclegan_tpu_torch.kernels import resblock as RB

    c, recs = NGF * 4, []
    for b, calls, serve_calls in ((1, 36, 0), (2, 72, 0), (BATCH, 0, 2 * N_BLOCKS)):
        shape = (b, CROP // 4, CROP // 4, c)
        x, w = randn(shape, torch.bfloat16), randn((3, 3, c, c), torch.bfloat16, 0.02)
        bias = randn((c,), torch.bfloat16, 0.01)
        ref = RB._conv3x3_plain(x, w, bias)
        out, again = torch.empty(ref.shape, device="cuda"), torch.empty(ref.shape, device="cuda")
        m = b * shape[1] * shape[2]
        flops = 2.0 * m * 9 * c * c
        # reads x, w and the bias once; writes the float32 output.
        b_ms, b_by = bound(x.numel() * 2 + w.numel() * 2 + c * 2 + m * c * 4, flops, "bfloat16")

        def check(fn) -> dict:
            fn(out)
            fn(again)
            torch.cuda.synchronize()
            res = compare("conv3x3_reflect", out, ref, "bfloat16")
            bitwise = torch.equal(out, again)
            ms = time_ms(lambda: fn(out), 20)
            return {**res, "ok": res["ok"] and bitwise, "second_call_bitwise_equal": bitwise,
                    "ms": ms, "tflops_issued": flops / 1e9 / ms}

        candidates = {}
        for tile in RB.CONV_TILES:
            r = check(lambda o, t=tile: RB.conv3x3_reflect_planned(x, w, bias, o, t))
            candidates["{}{}x{}x{}".format("halo/" if tile[0] else "", *tile[1:])] = {
                "blocks": RB.conv_blocks(tile, *shape[:3], c), **{k: r[k] for k in (
                    "ms", "tflops_issued", "max_abs_err", "worst_err_over_tol",
                    "second_call_bitwise_equal", "ok")}}
            fail_if(not r["ok"], "conv3x3_reflect (candidate tile)",
                    {"phase": "kernels_train", "kernel": "conv3x3_reflect",
                     "via": "candidate", "shape": list(shape), "plan": list(tile), **r})
        plan = RB.conv_plan(*shape, c)
        r = check(lambda o: RB.conv3x3_reflect(x, w, bias, o))
        xpl = F.pad(x.permute(0, 3, 1, 2), (1, 1, 1, 1), mode="reflect").contiguous(
            memory_format=torch.channels_last)
        wl = w.permute(3, 2, 0, 1).contiguous(memory_format=torch.channels_last)
        rec = {"phase": "kernels_train", "kernel": "conv3x3_reflect", "via": "isolated",
               "shape": list(shape), "cout": c, "dtype": "bfloat16", **r, "plan": list(plan),
               "blocks": RB.conv_blocks(plan, *shape[:3], c),
               "plain_ms": time_ms(lambda: RB._conv3x3_plain(x, w, bias), 5),
               "library_ms": time_ms(lambda: F.conv2d(xpl, wl, bias), 20),
               "bound_ms": b_ms, "bound_by": b_by, "gflop": flops / 1e9,
               "calls_per_step": calls, "calls_per_serving_forward": serve_calls,
               "candidates": candidates}
        fail_if(not r["ok"], "conv3x3_reflect", rec)
        recs.append(rec)
        del x, w, bias, ref, out, again, xpl, wl
    torch.cuda.empty_cache()
    return recs


def conv_fwd_device_ms(device_ms: list) -> dict:
    """Device time and launches of the forward convolution's kernels in a
    profile's ``(name, ms, calls)`` rows."""
    rows = [r for r in device_ms if "conv3x3_wgmma" in r[0]]
    return {"ms": sum(r[1] for r in rows), "launches": sum(r[2] for r in rows)}


def in_device_ms(device_ms: list, names=(("fwd", "::in_fwd<"), ("bwd", "::in_bwd<"))) -> dict:
    """Device time and launches of the instance-norm kernels (forward
    ``in_fwd``, VJP ``in_bwd``; or other ``names``) in a profile's ``(name,
    ms, calls)`` rows."""
    out = {}
    for key, name in names:
        rows = [r for r in device_ms if name in r[0]]
        out[key] = {"ms": sum(r[1] for r in rows), "launches": sum(r[2] for r in rows)}
    return out


# The chunked block's normalisation kernels (csrc/resblock_chunked.cu).
CHUNKED_NORMS = (("fwd", "chunked_in_fwd<"), ("vjp", "chunked_in_vjp<"))


def in_graph_capture() -> dict:
    """Whether ``torch.cuda.graph`` captures the instance norm's
    cooperative launches (forward, then VJP, at the stem's train shape), and
    whether a replay equals the eager result bitwise. Recorded, not
    required: a failure is reported, not raised."""
    import torch

    from cyclegan_tpu_torch.kernels import instance_norm as IN

    g = torch.Generator(device="cuda").manual_seed(2)
    x = torch.randn((2, CROP, CROP, NGF), device="cuda", generator=g).to(torch.bfloat16)
    dy = torch.randn(x.shape, device="cuda", generator=g).to(torch.bfloat16)
    y, dx = torch.empty_like(x), torch.empty_like(x)

    def step():
        mean, rstd = IN.launch(x, None, y, 1e-5, "relu")
        IN.launch_bwd(x, dy, mean, rstd, dx, "relu")

    step()
    torch.cuda.synchronize()
    want = (y.clone(), dx.clone())
    y.zero_()
    dx.zero_()
    try:
        graph = torch.cuda.CUDAGraph()
        with torch.cuda.graph(graph):
            step()
        y.zero_()
        dx.zero_()
        graph.replay()
        torch.cuda.synchronize()
        return {"captured": True, "replay_bitwise_equal":
                bool(torch.equal(y, want[0]) and torch.equal(dx, want[1]))}
    except Exception as e:  # recorded, not raised: capture is not required
        with contextlib.suppress(Exception):
            torch.cuda.synchronize()
        return {"captured": False, "error": f"{type(e).__name__}: {e}"[:400]}


def chunked_graph_capture() -> dict:
    """Whether ``torch.cuda.graph`` captures a chunked block's forward and
    VJP (its cluster launches, convolutions and allocations) at the trunk's
    train shape, and whether a replay equals the eager result bitwise.
    Recorded, not required."""
    import torch

    from cyclegan_tpu_torch.kernels import resblock_chunked as RC

    g = torch.Generator(device="cuda").manual_seed(3)
    c = NGF * 4
    shape = (2, CROP // 4, CROP // 4, c)

    def randn(s_, scale=1.0):
        return (torch.randn(s_, device="cuda", generator=g) * scale).to(torch.bfloat16)

    x, dy = randn(shape), randn(shape)
    w1, w2 = randn((3, 3, c, c), 0.02), randn((3, 3, c, c), 0.02)
    b1, b2 = randn((c,), 0.01), randn((c,), 0.01)

    def step():
        y, vhat, s, stats = RC._fwd_cuda(x, w1, b1, w2, b2, 1e-5, HC)
        return (y, vhat, s, stats, *RC._bwd_cuda(x, dy, vhat, s, stats, w1, w2, HC))

    want = step()
    torch.cuda.synchronize()
    try:
        graph = torch.cuda.CUDAGraph()
        with torch.cuda.graph(graph):
            outs = step()
        for t in outs:
            t.zero_()
        graph.replay()
        torch.cuda.synchronize()
        return {"captured": True, "replay_bitwise_equal":
                all(bool(torch.equal(a, b)) for a, b in zip(outs, want))}
    except Exception as e:  # recorded, not raised: capture is not required
        with contextlib.suppress(Exception):
            torch.cuda.synchronize()
        return {"captured": False, "error": f"{type(e).__name__}: {e}"[:400]}


@contextlib.contextmanager
def plain_seams():
    """Point the blocks' kernel seams at the autograd Functions over the
    plain versions (forward and backward), as _paths_agree does for the
    forward: instance norm, both residual blocks and the trunk
    convolution's weight gradient."""
    from cyclegan_tpu_torch.kernels import instance_norm as IN
    from cyclegan_tpu_torch.kernels import resblock as RB
    from cyclegan_tpu_torch.kernels import resblock_chunked as RC
    from cyclegan_tpu_torch.ops import blocks
    from cyclegan_tpu_torch.ops import functional as OF

    seams = (blocks.instance_norm_act, blocks.residual_block_fused,
             blocks.residual_block_chunked, OF.conv2d_valid_dw_fused)
    blocks.instance_norm_act = IN.instance_norm_act_reference
    blocks.residual_block_fused = RB.residual_block_reference
    blocks.residual_block_chunked = RC.residual_block_chunked_reference
    OF.conv2d_valid_dw_fused = OF.conv2d_valid_dw_fused_reference
    try:
        yield
    finally:
        (blocks.instance_norm_act, blocks.residual_block_fused,
         blocks.residual_block_chunked, OF.conv2d_valid_dw_fused) = seams


@contextlib.contextmanager
def resblock_env(route: str):
    """The JAX package's route variables while a trainer is built (the
    blocks read them once, then): chunked with HC rows a chunk, or unset."""
    keys = ("CYCLEGAN_TPU_RESBLOCK", "CYCLEGAN_TPU_RESBLOCK_HC")
    saved = {k: os.environ.pop(k, None) for k in keys}
    if route == "chunked":
        os.environ.update(dict(zip(keys, ("chunked", str(HC)))))
    try:
        yield
    finally:
        for k, v in saved.items():
            os.environ.pop(k, None)
            if v is not None:
                os.environ[k] = v


def _pre_norm_biases(trainer) -> tuple[set, set]:
    """ids of the biases of the trunk blocks that run whole (fused or
    chunked), and of every conv bias that an instance norm follows (those
    included)."""
    from cyclegan_tpu_torch.ops.blocks import InstanceNorm, ResidualBlock

    trunk, pre_norm = set(), set()
    for net in trainer.nets():
        for m in net.modules():
            if isinstance(m, ResidualBlock) and m.route != "unfused":
                trunk |= {id(m.conv0.conv.bias), id(m.conv1.conv.bias)}
            if isinstance(getattr(m, "norm", None), InstanceNorm) and m.conv.bias is not None:
                pre_norm.add(id(m.conv.bias))
    return trunk, pre_norm


def _grads(trainer) -> dict:
    """Clones of the gradients of every weight and of every bias that no
    instance norm follows, by ``net.parameter`` name."""
    _, pre_norm = _pre_norm_biases(trainer)
    return {f"{net_name}.{name}": p.grad.detach().clone()
            for net_name, net in zip(("G_i2l", "G_l2i", "D_img", "D_lab"), trainer.nets())
            for name, p in net.named_parameters() if id(p) not in pre_norm}


def _check_grads(trainer) -> dict:
    """Every parameter's gradient after step 1: finite everywhere; non-zero
    for every weight and for every bias that no instance norm follows; the
    biases of whole trunk blocks exactly zero (their VJPs return zeros: a
    bias before an instance norm cancels). Other biases before an instance
    norm have a gradient that is zero in exact arithmetic and rounding noise
    in float: only finiteness is checked there."""
    import torch

    trunk, pre_norm = _pre_norm_biases(trainer)
    bad, n = [], {"params": 0, "nonzero_checked": 0, "trunk_bias_zero": 0}
    for net_name, net in zip(("G_i2l", "G_l2i", "D_img", "D_lab"), trainer.nets()):
        for name, p in net.named_parameters():
            n["params"] += 1
            grad = p.grad
            if grad is None or not torch.isfinite(grad).all():
                bad.append(f"{net_name}.{name}: missing or not finite")
            elif id(p) in trunk:
                n["trunk_bias_zero"] += 1
                if torch.count_nonzero(grad):
                    bad.append(f"{net_name}.{name}: trunk bias gradient not exactly zero")
            elif id(p) not in pre_norm:
                n["nonzero_checked"] += 1
                if not torch.count_nonzero(grad):
                    bad.append(f"{net_name}.{name}: zero gradient")
    if bad:
        raise AssertionError(f"step-1 gradients: {bad[:20]}")
    return n


def expected_launches(trainer, steps: int) -> dict:
    """Launch counts of ``steps`` train steps, from the modules and
    train/cyclegan.py: three generator applies (G_i2l on [unlab; lab], G_l2i
    on [onehot; fake_lab], G_i2l on fake_img) and four discriminator applies
    (D_lab, D_img in the G phase; D_img, D_lab in the D phase), each with
    its backward (the G-phase gradient flows through D into the fakes)."""
    from cyclegan_tpu_torch.ops.blocks import ConvBlock, InstanceNorm, ResidualBlock

    def per_net(net):
        whole = [m for m in net.modules()
                 if isinstance(m, ResidualBlock) and m.route != "unfused"]
        routes = [m.route for m in whole]
        fused, chunked = routes.count("fused"), routes.count("chunked")
        norms = sum(isinstance(m, InstanceNorm) for m in net.modules())
        # The ConvBlocks of whole blocks only hold their weights.
        idle = {id(c) for m in whole for c in (m.conv0, m.conv1)}
        dw = sum(isinstance(m, ConvBlock) and m.dw_fused and id(m) not in idle
                 for m in net.modules())
        # The norms of whole trunk blocks are inside their kernels.
        return norms - 2 * (fused + chunked), fused, chunked, dw

    g_in, g_rb, g_rc, g_dw = per_net(trainer.G_i2l)
    d_in = per_net(trainer.D_img)[0]
    in_calls, rb, rc, dw = 3 * g_in + 4 * d_in, 3 * g_rb, 3 * g_rc, 3 * g_dw
    per = {"instance_norm_act": in_calls, "instance_norm_act_bwd": in_calls,
           "residual_block_fused": rb, "residual_block_bwd_dx": rb,
           "residual_block_bwd_dw": rb,
           "residual_block_chunked": rc, "residual_block_chunked_bwd": rc, "conv_dw": dw,
           # C entries: the fused block's forward makes 2 convolutions and 2
           # norms, its backward recomputes both and their statistics and
           # makes 2 norm VJPs, 2 input and 2 weight gradients. The chunked
           # forward makes 2 convolutions and 2 norms; its backward reads the
           # saved residuals: 2 norm VJPs, 2 input and 2 weight gradients,
           # and no convolution. The weight gradients are cg_conv_dw, as
           # path B's conv_dw is. cg_bf16_parts: both backwards split ds and
           # du once each, for an input and a weight gradient, and
           # reflect-pad the input of each weight gradient (4); bf16 conv_dw
           # on channels that are multiples of 8 needs none.
           "cg_instance_norm_act": in_calls + 4 * rb,
           "cg_instance_norm_act_bwd": in_calls + 2 * rb,
           "cg_conv3x3_reflect": 4 * rb + 2 * rc,
           "cg_conv3x3_reflect_dgrad": 2 * rb + 2 * rc,
           "cg_conv_dw": dw + 2 * rb + 2 * rc, "cg_bf16_parts": 4 * rb + 4 * rc,
           "cg_chunked_in_fwd": 2 * rc, "cg_chunked_in_vjp": 2 * rc}
    return {k: v * steps for k, v in per.items()}


def _zero_counters() -> None:
    from cyclegan_tpu_torch.kernels import _build
    from cyclegan_tpu_torch.kernels import conv_dw as CD
    from cyclegan_tpu_torch.kernels import instance_norm as IN
    from cyclegan_tpu_torch.kernels import resblock as RB
    from cyclegan_tpu_torch.kernels import resblock_chunked as RC

    IN.launches = IN.bwd_launches = RB.launches = RB.bwd_dx_launches = RB.bwd_dw_launches = 0
    RC.launches = RC.bwd_launches = CD.launches = 0
    _build.launches.clear()


def _read_counters() -> dict:
    from cyclegan_tpu_torch.kernels import _build
    from cyclegan_tpu_torch.kernels import conv_dw as CD
    from cyclegan_tpu_torch.kernels import instance_norm as IN
    from cyclegan_tpu_torch.kernels import resblock as RB
    from cyclegan_tpu_torch.kernels import resblock_chunked as RC

    return {"instance_norm_act": IN.launches, "instance_norm_act_bwd": IN.bwd_launches,
            "residual_block_fused": RB.launches, "residual_block_bwd_dx": RB.bwd_dx_launches,
            "residual_block_bwd_dw": RB.bwd_dw_launches, "residual_block_chunked": RC.launches,
            "residual_block_chunked_bwd": RC.bwd_launches, "conv_dw": CD.launches,
            **dict(_build.launches)}


# The paths of the train step: (route of the residual blocks, use_dropout).
TRAIN_PATHS = {"default": ("fused", False), "chunked": ("chunked", False),
               "dropout": ("fused", True)}
# What each path must show in its launch counters per step, beside the
# derived counts: path A runs the chunked block in every trunk block and no
# fused one; path B runs conv_dw for both trunk convolutions and no
# residual-block kernel.
PATH_COUNTS = {"chunked": {"residual_block_chunked": 27, "residual_block_chunked_bwd": 27,
                           "residual_block_fused": 0, "residual_block_bwd_dx": 0},
               "dropout": {"conv_dw": 54, "residual_block_fused": 0,
                           "residual_block_chunked": 0}}


def phase_train(smi: str, path: str = "default") -> dict:
    import numpy as np
    import torch

    from cyclegan_tpu_torch.data.datasets import DATASET_SPECS, _synthetic_sample
    from cyclegan_tpu_torch.data.transforms import normalize
    from cyclegan_tpu_torch.kernels import _build
    from cyclegan_tpu_torch.train.cyclegan import CycleGANTrainer
    from cyclegan_tpu_torch.utils.config import preset

    route, use_dropout = TRAIN_PATHS[path]
    cfg = preset(TRAIN_PRESET).replace(use_dropout=use_dropout)
    n_cls, in_ch, _ = DATASET_SPECS[cfg.dataset]
    hw = cfg.crop_hw
    lab_img, lab = _synthetic_sample(0, hw, n_cls, in_ch)
    unlab_img, _ = _synthetic_sample(1, hw, n_cls, in_ch)
    lab = lab.astype(np.int64)
    lab[:2], lab[:, :2] = 255, 255  # a void border, as VOC's masks have
    base = {"lab_image": torch.from_numpy(normalize(lab_img)[None]).cuda(),
            "unlab_image": torch.from_numpy(normalize(unlab_img)[None]).cuda(),
            "lab_label": torch.from_numpy(lab[None]).cuda()}
    n_steps = TRAIN_STEPS + 4 * TIMED_STEPS + 1
    rng = np.random.default_rng(0)
    use_new = rng.random((n_steps, 2, cfg.batch_size)) > 0.5
    swap = rng.integers(0, cfg.pool_size, (n_steps, 2, cfg.batch_size))

    def batch(s: int) -> dict:
        return {**base, "pool_use_new_img": use_new[s, 0], "pool_idx_img": swap[s, 0],
                "pool_use_new_lab": use_new[s, 1], "pool_idx_lab": swap[s, 1]}

    def trainer(c=cfg):
        # Same weights, pool decisions and dropout seed on every trainer.
        with resblock_env(route):
            t = CycleGANTrainer(c, n_cls, in_ch, VOC_STEPS_PER_EPOCH, device="cuda")
        if {b.route for b in t.G_i2l.trunk} != {"unfused" if use_dropout else route}:
            raise AssertionError(f"{path}: trunk routes {[b.route for b in t.G_i2l.trunk]}")
        return t, t.init_state(torch.Generator().manual_seed(0))

    def losses(m):
        return {k: float(v) for k, v in m.items()}

    def run(t, st, plain=False, after_step1=None) -> list:
        out = []
        with plain_seams() if plain else contextlib.nullcontext():
            for s in range(TRAIN_STEPS):
                st, m = t.train_step(st, batch(s))
                if s == 0 and after_step1 is not None:
                    after_step1(t)
                out.append(losses(m))
        return out

    def agree(dtype: str, k_losses: list, p_losses: list) -> dict:
        worst = {}
        for key, tols in TRAIN_TOL[dtype].items():
            errs = [abs(k[key] - p[key]) / (atol + rtol * abs(p[key]))
                    for k, p, (rtol, atol) in zip(k_losses, p_losses, tols)]
            worst[key] = errs
            if not all(np.isfinite([k[key] for k in k_losses])) or max(errs) > 1.0:
                raise AssertionError(f"{path} {dtype} {key}: kernel path {k_losses} vs "
                                     f"plain path {p_losses}")
        return worst

    # float32 first: the kernels' gradients through three full updates,
    # where rounding cannot hide a wrong gradient.
    f32 = cfg.replace(bf16=False)
    g_kernel, g_plain, g_plain2 = {}, {}, {}
    k32 = run(*trainer(f32), after_step1=lambda t: g_kernel.update(_grads(t)))
    p32 = run(*trainer(f32), plain=True, after_step1=lambda t: g_plain.update(_grads(t)))
    run(*trainer(f32), plain=True, after_step1=lambda t: g_plain2.update(_grads(t)))
    worst32 = agree("float32", k32, p32)

    def rel_err(g):
        return {k: float((g[k] - g_plain[k]).norm() / g_plain[k].norm()) for k in g_plain}

    grad_err, grad_floor = rel_err(g_kernel), rel_err(g_plain2)
    worst_grad = max(grad_err, key=grad_err.get)
    if not max(grad_err.values()) <= GRAD_TOL_F32:
        raise AssertionError(f"{path} float32 step-1 gradients, kernel vs plain path: worst "
                             f"{worst_grad} {grad_err[worst_grad]} > {GRAD_TOL_F32}")
    del g_kernel, g_plain, g_plain2
    torch.cuda.empty_cache()

    kt, ks = trainer()
    n_params = sum(p.numel() for net in kt.nets() for p in net.parameters())
    # The main path: counts set to 0 just before, read just after.
    _zero_counters()
    grads = {}
    k_losses = run(kt, ks, after_step1=lambda t: grads.update(_check_grads(t)))
    torch.cuda.synchronize()
    launches = _read_counters()
    want = expected_launches(kt, TRAIN_STEPS)
    if {k: launches.get(k, 0) for k in want} != want:
        raise AssertionError(f"{path}: launch counters {launches} != derived {want}")
    for k, per_step in PATH_COUNTS.get(path, {}).items():
        if launches.get(k, 0) != per_step * TRAIN_STEPS:
            raise AssertionError(f"{path}: {k} launched {launches.get(k, 0)} times in "
                                 f"{TRAIN_STEPS} steps, not {per_step} a step")

    pt, ps = trainer()
    p_losses = run(pt, ps, plain=True)
    worst = agree("bfloat16", k_losses, p_losses)

    # Step times in turns (plain, kernel, kernel, plain), host clock around
    # steps that end in a synchronize.
    def timed(t, st, first: int) -> list:
        out = []
        for i in range(TIMED_STEPS):
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            t.train_step(st, batch(first + i))
            torch.cuda.synchronize()
            out.append((time.perf_counter() - t0) * 1e3)
        return out

    s0 = TRAIN_STEPS
    with plain_seams():
        plain_ms = timed(pt, ps, s0)
    kernel_ms = timed(kt, ks, s0) + timed(kt, ks, s0 + TIMED_STEPS)
    with plain_seams():
        plain_ms += timed(pt, ps, s0 + TIMED_STEPS)
    del pt, ps
    torch.cuda.empty_cache()
    med_k, med_p = statistics.median(kernel_ms), statistics.median(plain_ms)
    rec = {"phase": "train" if path == "default" else f"train_{path}", "path": path,
           "preset": TRAIN_PRESET, "resblock_route": route, "use_dropout": use_dropout,
           "hc": HC if route == "chunked" else None, "crop": list(hw),
           "batch": cfg.batch_size, "pool_size": cfg.pool_size, "n_params": n_params,
           "nvidia_smi": smi, "losses_kernel_path": k_losses, "losses_plain_path": p_losses,
           "loss_err_over_tol": worst, "float32_losses_kernel_path": k32,
           "float32_losses_plain_path": p32, "float32_loss_err_over_tol": worst32,
           "float32_step1_grad_rel_err_worst": [worst_grad, grad_err[worst_grad]],
           "float32_step1_grad_rel_err_median": statistics.median(grad_err.values()),
           "float32_step1_grad_plain_vs_plain_worst": max(grad_floor.values()),
           "float32_step1_grad_plain_vs_plain_median": statistics.median(grad_floor.values()),
           "float32_step1_grads_compared": len(grad_err),
           "tol": TRAIN_TOL, "step1_grads": grads,
           "launches_over_3_steps": launches, "expected_launches": want,
           "step_ms_kernel": kernel_ms, "step_ms_plain": plain_ms,
           "median_step_ms_kernel": med_k, "steps_per_s_kernel": 1e3 / med_k,
           "median_step_ms_plain": med_p, "steps_per_s_plain": 1e3 / med_p}
    torch.cuda.reset_peak_memory_stats()
    entries = dict(_build.launches)
    with torch.profiler.profile(activities=[torch.profiler.ProfilerActivity.CPU,
                                            torch.profiler.ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        kt.train_step(ks, batch(s0 + 2 * TIMED_STEPS))
        torch.cuda.synchronize()
        prof_step_ms = (time.perf_counter() - t0) * 1e3
    entries = {k: _build.launches[k] - entries.get(k, 0)
               for k in ("cg_instance_norm_act", "cg_instance_norm_act_bwd",
                         "cg_chunked_in_fwd", "cg_chunked_in_vjp")}
    # Device kernels only (CPU ops that launched them carry the same time).
    device_ms = [(e.key, e.self_device_time_total / 1e3, e.count)
                 for e in prof.key_averages() if e.self_device_time_total > 0
                 and getattr(e, "device_type", None) == torch.autograd.DeviceType.CUDA]
    device_ms.sort(key=lambda r: -r[1])
    rec.update({
        "profiled_step_ms": prof_step_ms,
        "profiled_step_device_ms_total": sum(r[1] for r in device_ms),
        "profiled_step_device_busy_share": sum(r[1] for r in device_ms) / prof_step_ms,
        "profiled_step_device_ms_by_kernel": [
            {"kernel": k[:90], "ms": ms, "calls": n} for k, ms, n in device_ms[:20]],
        "profiled_step_conv3x3_fwd": conv_fwd_device_ms(device_ms),
        "profiled_step_instance_norm": in_device_ms(device_ms),
        "profiled_step_chunked_norms": in_device_ms(device_ms, CHUNKED_NORMS),
        "profiled_step_norm_c_entries": entries,
        "peak_mem_gb_profiled_step": torch.cuda.max_memory_allocated() / 1e9})
    emit(rec)
    # One launch a C entry: the instance norm's kernels, forward and VJP.
    in_prof = rec["profiled_step_instance_norm"]
    if (in_prof["fwd"]["launches"], in_prof["bwd"]["launches"]) != \
            (entries["cg_instance_norm_act"], entries["cg_instance_norm_act_bwd"]):
        raise AssertionError(f"{path}: instance-norm kernels {in_prof} in the profiled step, "
                             f"not one a C entry {entries}")
    # And the chunked block's: one launch a cg_chunked_in_fwd / _vjp call
    # (path A: 4 a block, 108 a step).
    rc_prof = rec["profiled_step_chunked_norms"]
    if (rc_prof["fwd"]["launches"], rc_prof["vjp"]["launches"]) != \
            (entries["cg_chunked_in_fwd"], entries["cg_chunked_in_vjp"]):
        raise AssertionError(f"{path}: chunked norm kernels {rc_prof} in the profiled step, "
                             f"not one a C entry {entries}")
    print(f"train step ({path}), {TRAIN_PRESET} 256x256 b1 bf16: median {med_k:.2f} ms "
          f"({1e3 / med_k:.2f} steps/s) on the kernels, {med_p:.2f} ms on the plain "
          f"versions; {smi}", flush=True)
    del kt, ks
    torch.cuda.empty_cache()
    return {"launches": launches, "record": rec}

# The CLI phase: `python -m cyclegan_tpu_torch.main` driven in-process on
# the voc_semisup_256 preset at full width over the synthetic dataset.
# dataset_size 24 at 1/8 labeled gives 3 steps an epoch at batch 1 (32 gives
# 4, for the stacked runs); the val split is the synthetic 40 images.
CLI_SIZE, CLI_STACK_SIZE, CLI_VAL = 24, 32, 40
CLI_PREEMPT_AT = 4  # optimizer step: epoch 1, call 1
CLI_IN_KERNELS = ("instance_norm_act", "instance_norm_act_bwd", "residual_block_fused",
                  "residual_block_bwd_dx", "residual_block_bwd_dw")
SCORE_TOL = 1e-4  # --testing against the last validation, mIoU and pixel accuracy


def forward_launches(trainer, n_i2l: int, n_l2i: int) -> dict:
    """Launches of ``n_i2l`` G_i2l and ``n_l2i`` G_l2i forwards (eval,
    sample dumps, --testing): each norm outside a whole trunk block is one
    instance_norm_act launch, each fused trunk block one
    residual_block_fused launch; no backward kernel."""
    from cyclegan_tpu_torch.ops.blocks import InstanceNorm, ResidualBlock

    out = dict.fromkeys(CLI_IN_KERNELS, 0)
    for net, n in ((trainer.G_i2l, n_i2l), (trainer.G_l2i, n_l2i)):
        fused = sum(isinstance(m, ResidualBlock) and m.route == "fused" for m in net.modules())
        norms = sum(isinstance(m, InstanceNorm) for m in net.modules())
        out["instance_norm_act"] += n * (norms - 2 * fused)
        out["residual_block_fused"] += n * fused
    return out


def phase_cli(smi: str) -> dict:
    """(a) --training for 2 epochs with mid-epoch checkpoints every step,
    preempted at step CLI_PREEMPT_AT and resumed, against an uninterrupted
    run from the same seed; (b) --testing of the final checkpoint; (c) one
    epoch each of --steps_per_call 2 and --grad_accum 2. Every launch runs
    with the counters at 0 and is held to the counts derived from the
    modules."""
    import torch

    from cyclegan_tpu_torch.data import native
    from cyclegan_tpu_torch.main import main as cli
    from cyclegan_tpu_torch.train.cyclegan import CycleGANTrainer
    from cyclegan_tpu_torch.utils.config import preset

    cfg = preset(TRAIN_PRESET)
    with resblock_env("fused"):
        counter = CycleGANTrainer(cfg, NUM_CLASSES, 3, 1, device="cuda")
    per_step = {k: v for k, v in expected_launches(counter, 1).items() if k in CLI_IN_KERNELS}

    def derived(steps: int, n_i2l: int = 0, n_l2i: int = 0) -> dict:
        fwd = forward_launches(counter, n_i2l, n_l2i)
        return {k: steps * per_step[k] + fwd[k] for k in CLI_IN_KERNELS}

    base = ["--preset", TRAIN_PRESET, "--dataset", "synthetic", "--log_every", "1"]
    tmp = tempfile.mkdtemp(prefix="chip_smoke_cli_")

    def dirs(name: str) -> list:
        return ["--checkpoint_dir", os.path.join(tmp, name, "ckpt"),
                "--results_dir", os.path.join(tmp, name, "res")]

    def logged(name: str) -> list:
        with open(os.path.join(tmp, name, "res", "train_metrics.jsonl")) as f:
            return [json.loads(line) for line in f]

    def launch(what: str, argv: list, want: dict, env: dict | None = None):
        saved = {k: os.environ.get(k) for k in (env or {})}
        os.environ.update(env or {})
        try:
            with resblock_env("fused"):
                _zero_counters()
                t0 = time.perf_counter()
                res = cli(argv)
                torch.cuda.synchronize()
                wall = time.perf_counter() - t0
                got = {k: _read_counters()[k] for k in CLI_IN_KERNELS}
        finally:
            for k, v in saved.items():
                os.environ.pop(k, None)
                if v is not None:
                    os.environ[k] = v
        if got != want or not any(got.values()):
            raise AssertionError(f"cli {what}: launch counters {got} != derived {want}")
        runs[what] = {"seconds": wall, "launches": got, "derived": want,
                      "runner_seconds": (res or {}).get("seconds")}
        return res

    runs: dict = {}
    train = ["--training", "--dataset_size", str(CLI_SIZE), "--epochs", "2"]
    steps_per_epoch = 3
    val = CLI_VAL
    try:
        # (a) the reference, uninterrupted; then preempted and resumed.
        ref_val = launch("a_reference", train + base + dirs("ref"),
                         derived(2 * steps_per_epoch, 2 * val + 2, 2))
        first = launch("a_preempted", train + base + dirs("res") + ["--save_every_steps", "1"],
                       derived(CLI_PREEMPT_AT, val + 1, 1),
                       env={"CYCLEGAN_TPU_PREEMPT_AT_STEP": str(CLI_PREEMPT_AT)})
        if not first.get("preempted"):
            raise AssertionError(f"cli: the first launch was not preempted: {first}")
        last_val = launch("a_resumed", train + base + dirs("res") + ["--save_every_steps", "1"],
                          derived(2 * steps_per_epoch - CLI_PREEMPT_AT, val + 1, 1))
        ref_log, res_log = logged("ref"), logged("res")
        if not [r["step"] for r in ref_log] == [r["step"] for r in res_log] == \
                list(range(1, 2 * steps_per_epoch + 1)):
            raise AssertionError(f"cli: logged steps {[r['step'] for r in ref_log]} and "
                                 f"{[r['step'] for r in res_log]}")
        loss_err = {}
        for key, tols in TRAIN_TOL["bfloat16"].items():
            errs = [abs(r[key] - q[key]) / (tols[min(i, 2)][1] + tols[min(i, 2)][0] * abs(q[key]))
                    for i, (r, q) in enumerate(zip(res_log, ref_log))]
            loss_err[key] = errs
            if not all(math.isfinite(r[key]) for r in res_log) or max(errs) > 1.0:
                raise AssertionError(f"cli: resumed {key} {[r[key] for r in res_log]} vs "
                                     f"uninterrupted {[q[key] for q in ref_log]}")
        ref_ck = torch.load(os.path.join(tmp, "ref", "ckpt", "1.pt"), weights_only=True)
        res_ck = torch.load(os.path.join(tmp, "res", "ckpt", "1.pt"), weights_only=True)
        pairs = [(a, res_ck["nets"][n][k]) for n, sd in ref_ck["nets"].items()
                 for k, a in sd.items()]
        max_w = max(float((a - b).abs().max()) for a, b in pairs)
        bitwise = all(torch.equal(a, b) for a, b in pairs)
        del ref_ck, res_ck, pairs
        if not (ref_val and last_val and math.isfinite(max_w)):
            raise AssertionError(f"cli: validations {ref_val} {last_val}, weights {max_w}")
        # (b) --testing of the resumed run's final checkpoint.
        scores = launch("b_testing", ["--testing"] + base + dirs("res"), derived(0, val, 0))
        pngs = [f for f in os.listdir(os.path.join(tmp, "res", "res")) if f.startswith("pred_")]
        score_err = {k: abs(scores[k] - last_val[k]) for k in ("miou", "pixel_acc")}
        if len(pngs) != val or max(score_err.values()) > SCORE_TOL:
            raise AssertionError(f"cli --testing: {len(pngs)} PNGs, scores {scores} vs the "
                                 f"last validation {last_val}")
        # (c) one epoch of each batch stack, 4 batches an epoch.
        stacked = ["--training", "--dataset_size", str(CLI_STACK_SIZE), "--epochs", "1",
                   "--validation_every", "0"]
        for flag in ("--steps_per_call", "--grad_accum"):
            launch(f"c{flag[1:]}", stacked + base + dirs(flag) + [flag, "2"], derived(4))
        c_logs = {flag: logged(flag) for flag in ("--steps_per_call", "--grad_accum")}
        if [r["step"] for r in c_logs["--steps_per_call"]] != [2, 4] or \
                [r["step"] for r in c_logs["--grad_accum"]] != [1, 2]:
            raise AssertionError(f"cli (c): logged steps {c_logs}")
    finally:
        import shutil

        shutil.rmtree(tmp, ignore_errors=True)
        del counter
        torch.cuda.empty_cache()

    def sps(log: list) -> list:
        return [r["steps_per_sec"] for r in log]

    secs = runs["a_reference"]["runner_seconds"]
    rec = {"phase": "cli", "preset": TRAIN_PRESET, "dataset": "synthetic",
           "steps_per_epoch": steps_per_epoch, "val_images": val, "nvidia_smi": smi,
           "native_available": native.available(), "runs": runs,
           "steps_per_sec_logged": {"a_reference": sps(ref_log), "a_resumed": sps(res_log),
                                    **{k: sps(v) for k, v in c_logs.items()}},
           "prefetch_share_of_train_loop": secs["input_wait"] / secs["train"],
           "validation_pass_s": secs["validation"] / 2,
           "losses_resumed": [{k: r[k] for k in ("g_total", "d_total")} for r in res_log],
           "losses_uninterrupted": [{k: r[k] for k in ("g_total", "d_total")} for r in ref_log],
           "loss_err_over_tol": loss_err, "tol": TRAIN_TOL["bfloat16"],
           "resumed_max_weight_diff": max_w, "resumed_bitwise_equal": bitwise,
           "last_validation": last_val, "testing_scores": {k: scores[k] for k in score_err},
           "testing_err": score_err, "testing_pngs": len(pngs)}
    emit(rec)
    print(f"cli ({TRAIN_PRESET}, synthetic, 256x256 b1 bf16): "
          f"{statistics.median(sps(ref_log)):.2f} steps/s logged, validation "
          f"{rec['validation_pass_s']:.3f} s a pass of {val}, prefetch "
          f"{rec['prefetch_share_of_train_loop']:.4f} of the loop; resumed "
          f"{'bitwise equal' if bitwise else f'max weight diff {max_w:.3g}'}; {smi}",
          flush=True)
    return rec


def kernels_line(recs: dict, runs: dict) -> dict:
    """One entry per kernel of the train step: bf16 (the path's type), per
    call times summed over the calls of one train step at 256x256, batch 1;
    ``launches`` from the run (3 steps) of the path that runs the kernel
    (``runs``: path -> phase_train's result)."""
    meta = {
        "instance_norm_act": ("cyclegan_tpu_torch/csrc/instance_norm.cu",
                              "cyclegan_tpu/kernels/instance_norm.py:126"),
        "instance_norm_act_bwd": ("cyclegan_tpu_torch/csrc/instance_norm.cu",
                                  "cyclegan_tpu/kernels/instance_norm.py:146"),
        "residual_block_fused": ("cyclegan_tpu_torch/csrc/resblock.cu",
                                 "cyclegan_tpu/kernels/resblock.py:79"),
        "residual_block_bwd_dx": ("cyclegan_tpu_torch/csrc/resblock.cu",
                                  "cyclegan_tpu/kernels/resblock.py:219"),
        "residual_block_bwd_dw": ("cyclegan_tpu_torch/csrc/conv_dw.cu",
                                  "cyclegan_tpu/kernels/resblock.py:227"),
        "residual_block_chunked": ("cyclegan_tpu_torch/csrc/resblock_chunked.cu",
                                   "cyclegan_tpu/kernels/resblock_chunked.py:156"),
        "residual_block_chunked_bwd": ("cyclegan_tpu_torch/csrc/resblock_chunked.cu",
                                       "cyclegan_tpu/kernels/resblock_chunked.py:406"),
        "conv_dw": ("cyclegan_tpu_torch/csrc/conv_dw.cu", "cyclegan_tpu/kernels/conv_dw.py:58"),
        # The forward convolution alone: the heart of #3 (and of #6 and #4's
        # recompute); its launches are the C entry's on the default path.
        "conv3x3_reflect": ("cyclegan_tpu_torch/csrc/resblock.cu",
                            "cyclegan_tpu/kernels/resblock.py:79"),
    }
    path_of = {"residual_block_chunked": "chunked", "residual_block_chunked_bwd": "chunked",
               "conv_dw": "dropout"}
    counter_of = {"conv3x3_reflect": "cg_conv3x3_reflect"}
    entries = []
    for name, (source, replaces) in meta.items():
        path = path_of.get(name, "default")
        rs = recs[name]

        def total(key):
            return sum(r[key] * r["calls_per_step"] for r in rs)

        entries.append({
            "name": name, "route": "cuda", "source": source, "replaces": replaces,
            "launches": runs[path]["launches"][counter_of.get(name, name)],
            "max_abs_err": max(r["max_abs_err"] for r in rs),
            "ms": total("ms"), "plain_ms": total("plain_ms"), "bound_ms": total("bound_ms"),
            "bound_by": max(rs, key=lambda r: r["bound_ms"] * r["calls_per_step"])["bound_by"],
            "library_ms": total("library_ms"),
            "per": f"one train step ({TRAIN_PRESET}, {CROP}x{CROP}, batch 1, bf16): "
                   f"{sum(r['calls_per_step'] for r in rs)} calls",
            "launches_over": f"{TRAIN_STEPS} train steps, path {path}"})
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
    phase_kernels()
    with tempfile.TemporaryDirectory() as tmp:
        served = phase_serve(tmp)
        phase_http(served)
    recs = phase_kernels_train()
    runs = {path: phase_train(smi, path) for path in TRAIN_PATHS}
    emit({"phase": "graph_capture", "instance_norm": in_graph_capture(),
          "chunked_block": chunked_graph_capture()})
    phase_cli(smi)
    emit({"phase": "done", "seconds": time.perf_counter() - t0})
    print(smi, flush=True)
    emit(kernels_line(recs, runs))
    emit({"ok": True, "device": {"platform": "gpu", "kind": torch.cuda.get_device_name(0),
                                 "count": torch.cuda.device_count()}})
    return 0


if __name__ == "__main__":
    sys.exit(main())
