#!/usr/bin/env python3
"""On-card smoke test of cyclegan_tpu_torch: one H100, a few minutes.

    python3 chip_smoke.py

Drives the port's main paths at full width, the serving path (ResNet-9
image->label generator, ngf 64, 21 classes, 256x256, bf16 compute over
float32 weights drawn from a seed) and the semi-supervised CycleGAN train
step of the ``voc_semisup_256`` preset on three routes through the trunk
(the default fused residual block; path A, ``CYCLEGAN_TPU_RESBLOCK=chunked``;
path B, ``use_dropout``), the supervised segmenter of ``voc_supervised_128``
(its ResNet-6, ``unet_128`` and ``--norm batch`` routes, ``remat``, and its
CLI with tiled and TTA testing), and prints one JSON line per phase:

1. device: the card, its power limit, and the parallel nvcc build of every
   kernel under cyclegan_tpu_torch/csrc (build seconds, ptxas registers,
   spills and warnings); the forward convolution's and the input
   gradient's wgmma kernels must build with no spill and no wgmma
   serialisation (ptxas C7515);
2. kernels: each CUDA kernel against its plain PyTorch version at the main
   path's shapes (batch 8), float32 and bf16, with the stated tolerance and
   its time beside the plain version, one library call and the bound;
3. serve: export the artifact and run ``serve.run_serve`` over 16 seeded
   PNGs with ground truth on the card; the launch counters of both kernels
   must show the path went through them, and the kernel path's argmax must
   agree with the plain path's on one batch;
4. http: ``http_serve.make_server`` in a thread, /healthz and 8 POST
   /predict from 4 threads in the three formats, checked against step 3;
   http_bench: ``tools/torch_http_bench.py`` on the same artifact, 8
   clients x 24 requests at max_batch 8: req/s and p50/p90/p99 latency,
   kernels #1 and #3 launched as the server's forwards derive;
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
   gradient, conv_dw) at the trunk shapes (batch 16, 8, 2, 1) on bf16
   operands with a float32 cotangent, at the float32 bars, and the forward
   convolution alone at the
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
   one launch a C entry of either norm, or the phase fails); on the default
   path also the median step under deterministic_algorithms() against the
   default mode's (in turns), and whether each mode's step-1 gradients
   repeat bitwise across two trainers from one seed;
7. train_chunked, train_dropout: the same for paths A and B; path A
   launches the chunked block 27 times a step forward and backward (its
   norm kernels 108 times) and no fused block, path B launches conv_dw 54
   times a step and no residual-block kernel;
8. graph_capture: whether torch.cuda.graph captures the instance norm's
   cooperative launches and a chunked block's forward and VJP, and whether
   a replay is bitwise equal (recorded, not required);
9. cli: ``python -m cyclegan_tpu_torch.main`` in process on the same
   preset over the synthetic dataset: --training for 2 epochs of 3 steps
   in the default mode a user trains in (steps/s, input wait and
   validation seconds are this run's); then, under deterministic algorithms
   (deterministic_algorithms, as in phase 13), the same uninterrupted
   against a run with a checkpoint every step, preempted at step 4 and
   relaunched (per-step losses within the bf16 train-step bars; the largest
   weight difference and whether the two are bitwise equal recorded; the
   default run's loss gap to the deterministic one recorded); --testing of
   the final checkpoint (one PNG per val image, mIoU and pixel accuracy
   within 1e-4 of the last validation); one epoch each of --steps_per_call 2 and --grad_accum 2.
   ckpt_bridge: ``tools/torch_export_checkpoint.py`` writes the resumed
   run's checkpoint as the reference's latest.ckpt and
   ``tools/torch_import_checkpoint.py`` reads it into a fresh directory
   (every tensor, Adam moment and the step bitwise); --training resumes
   from it for one step; ``tools/torch_reference.py``'s nets on the
   exported state dicts within GEN_TOL of the port's float32 forward.
   Every launch runs with the counters at 0 and must show kernels #1-#5
   launched as often as the modules derive for its train steps and eval
   forwards; steps/s from the logger, the loop's input wait and the
   validation seconds are recorded with the card's name and power limit;
   ckpt_devices: a small run of each trainer (ngf 8, 32x32, dropout on)
   saved on the CPU resumes on the card (also without its dropout seed,
   as older checkpoints are), one saved on the card resumes on the CPU and
   on the card, one step each: the nets and step bitwise, the dropout
   generator as train/checkpoint.py's rule makes it;
10. kernels_supervised: the kernels of the supervised paths alone at their
   shapes (bf16, batch 2) against their plain versions, timed: #1/#2 at
   config 1's norm planes and at every U-Net plane (2x2x512 up to
   64x64x64, no activation; float32 too at 2x2 and 4x4), #3-#5 at config
   1's trunk (2, 32, 32, 256), #8 on batch norm's padded trunk input;
11. train_supervised, train_supervised_unet, train_supervised_bn:
   ``SupervisedTrainer.train_step`` of ``voc_supervised_128`` (BASELINE
   config 1: resnet_6blocks, ngf 64, 128x128, batch 2, bf16), of its
   unet_128 route and of its --norm batch route, as phase 6 does: float32
   and bf16 runs of 3 steps on the kernels and on the plain seams, ce_loss
   and float32 step-1 gradients against the plain-vs-plain floor, launch
   counters against the modules, medians in turns and one profiled step;
   under batch norm the running averages of both paths (BN_STATS_TOL) and
   eval-mode logits from them;
12. remat: one step each of the default CycleGAN path and of config 1 with
   remat=True against remat=False from one state, within the step-1 bars;
   the counters must show every trunk block's second forward;
13. cli_supervised: ``python -m cyclegan_tpu_torch.main --training --model
   supervised --preset voc_supervised_128 --dataset synthetic`` in process:
   two epochs of 3 steps in the default mode (timed), then under
   deterministic algorithms the same against a run preempted at step 4
   and resumed, --testing equal to the last validation, and one
   --testing on a 192x192 tiled canvas with flip and scales 0.75, 1.0,
   1.25 (its seconds and mIoU), every launch held to the derived counts;
14. serve_full: serving at the full width of ``voc_semisup_256`` from a
   checkpoint the port writes: ``--export`` through the CLI (heads segment,
   logits and generate, ``--export_input uint8``, ``--export_quantize int8``
   and ``bf16``: the .pt sizes against float32, the loaded weights bitwise
   the host's dequantisation), ``run_serve`` of the logits artifact on a
   512x512 canvas with flip and scales 0.75 / 1.0 / 1.25 (window stacks of
   N = 32, 72 and 128 at batch 8) with GT scoring: kernels #1 and #3 launched
   as often as the calls, windows and blocks derive, the kernel path against
   the plain seams on one batch (argmax on decisive pixels), the end-to-end
   rate (run_serve over 64 images after the counted run, twice); #1,
   #3 and the forward convolution alone at N = 128 against their plain
   versions, timed; the int8 and bf16 artifacts on the same canvas (their
   agreement with float32 and their mIoU); the uint8-input artifact's PNGs
   bitwise the float32 one's; the generate head (shape, range, float32
   kernel path within GEN_TOL of the plain one); HTTP with the same options
   (/info's ``tta``, p50 latency of 8 concurrent requests); ``--serve_dp``
   bitwise the single-device path; config 1's ``unet_128`` and ``--norm
   batch`` artifacts kernel against plain; ``tools/torch_quantize_miou_run.py``
   at its defaults, its line printed;
15. dp: data parallelism (``parallel/``): (a) ``runner.run_cyclegan`` of
   ``voc_semisup_256`` for 3 steps on an NCCL group of one rank, bitwise
   equal to the same run with no group, both under deterministic
   algorithms; (b) two gloo ranks sharing the card (NCCL refuses two ranks
   on one device), one row each of a global batch of 2, 3 steps on the
   kernels against one process at batch 2 within the train phase's bf16
   bars, each rank's launch counters equal to the counts derived at batch
   1; (c) BASELINE config 5 (``voc_dp8_bf16``) cut from 8 devices to 2
   gloo ranks on the card and from a global batch of 64 to 16 (its 8 rows
   a device kept), bf16: steps/s over 5 timed steps, each rank's peak
   memory and the all-reduces' share of a step, with the card's name and
   power limit;
16. configs: BASELINE configs 3 (``cityscapes_semisup_512x256``: 256x512,
   19 classes) on the default path and path A and 4 (``acdc_semisup``:
   256x256, 1 channel, 4 classes) on the default path, at their published
   widths, unsharded: the kernels alone at config 3's non-square planes
   against their plain versions; 3 float32 and 3 bf16 steps on the kernels
   against the plain seams (TRAIN_TOL), launch counters against the
   derived counts, the median step and peak memory;
17. spatial: (a) config 3 at ``spatial_shards`` 2 as two gloo ranks on the
   card, a 128x512 slab a rank: 3 steps against the unsharded run of phase
   16 at the bf16 bars, every rank's losses equal, each rank's counters as
   derived (#1/#2 through their slab entries, #8 on every trunk
   convolution, no #3-#7), the step time, peak memory a rank and the halo
   and norm-partial collectives' share of a step; (b) ``runner.
   run_cyclegan`` and ``run_test`` at --num_devices 2 --spatial_shards 2
   (float32), the class maps equal to one process's --testing of the same
   checkpoint on every pixel that is no tie; (c) the slab entries alone at
   config 3's stem and trunk slabs against their plain versions and the
   one-launch kernel on the whole plane, every slab's statistics bitwise
   alike, each slot-writing partials leaving zeros in the other slot, a
   second call bitwise, timed eagerly and as CUDA-graph replays beside the
   library graph of the same function and the gather work they removed,
   and one slab norm layer profiled: two kernels a direction, no fill or
   copy;
18. spatial_unet: config 3 with ``unet_256`` generators (ngf 64, bf16) at
   spatial 2 on the same two ranks, 3 steps against the same model
   unsharded in one process at the bf16 bars, both ranks' losses equal,
   each rank's counters as derived (13 slab norms a generator forward),
   the rows each rank owns at every plane (the innermost: 1 and 0), the
   step time and peak memory a rank against the unsharded run's;
19. spatial_eval: the runner's --testing of (b)'s checkpoint at
   --num_devices 2 --spatial_shards 2 with --eval_resize tile (a 512x1024
   canvas, 256x512 windows), --eval_flip and --eval_scales 0.75,1.0,1.25,
   the class maps equal to one process's --testing with the same flags on
   every pixel that is no tie there, each rank's slab counters as
   derived.

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
# serve_full's end-to-end rate: run_serve over this many images (8
# batches), warm (after the counted run built and ran every shape), twice.
SERVE_RATE_IMAGES = 64
SERVE_RATE_REPEATS = 2

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
    faults = {k: ptxas_faults(logs["resblock"], k) for k in ("conv3x3_wgmma", "dgrad_mma")}
    emit({"phase": "device", "kind": torch.cuda.get_device_name(0),
          "count": torch.cuda.device_count(), "nvidia_smi": smi,
          "torch": torch.__version__, "cuda": torch.version.cuda,
          "build_s": build_s, "ptxas": ptxas, "resblock_ptxas_faults": faults})
    if any(faults.values()):
        raise AssertionError(f"resblock.cu: ptxas reports {faults}")
    return smi


def ptxas_faults(log: str, kernel: str) -> list:
    """What ptxas -v says against ``kernel`` (a substring of its mangled
    name) in one source's build log: a wgmma serialisation warning (C7515,
    anywhere in the source: the warning may name no function) or spill
    stores or loads in the properties of one of its instances."""
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


def _write_inputs(root: str, n: int = N_IMAGES) -> tuple[str, str]:
    import numpy as np
    from PIL import Image

    rng = np.random.default_rng(0)
    img_dir, gt_dir = os.path.join(root, "imgs"), os.path.join(root, "gt")
    os.makedirs(img_dir)
    os.makedirs(gt_dir)
    yy, xx = np.mgrid[0:CROP, 0:CROP]
    for i in range(n):
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


@contextlib.contextmanager
def plain_forward_seams():
    """Point the blocks' forward kernel seams (instance norm, the fused
    residual block) at their plain versions."""
    from cyclegan_tpu_torch.kernels import instance_norm as IN
    from cyclegan_tpu_torch.kernels import resblock as RB
    from cyclegan_tpu_torch.ops import blocks

    seams = (blocks.instance_norm_act, blocks.residual_block_fused)
    blocks.instance_norm_act, blocks.residual_block_fused = (
        IN.instance_norm_act_plain, RB.residual_block_plain)
    try:
        yield
    finally:
        blocks.instance_norm_act, blocks.residual_block_fused = seams


def _paths_agree(G, tmp: str, x, dtype: str):
    """Logits of the served function with the kernels and with the blocks'
    seams pointed at the plain versions, on one batch: argmax agreement over
    all pixels and over the pixels whose plain top-2 logit gap is no tie.
    Also returns the kernel path's no-tie mask."""
    import torch

    from cyclegan_tpu_torch import export

    art = export.export_generator(
        G, os.path.join(tmp, f"logits_{dtype}"), gen_net="resnet_9blocks", ngf=NGF,
        num_classes=NUM_CLASSES, in_channels=3, crop_hw=(CROP, CROP), dtype=dtype,
        head="logits")
    fn, _, _ = export.load_head(art, "cuda")
    lk = fn(x).float()
    with plain_forward_seams():
        lp = fn(x).float()
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

    # The main path: counts set to 0 just before, read just after. A forward
    # makes 5 norms outside the trunk and N_BLOCKS fused blocks, each of 2
    # forward convolutions and 2 norms.
    _zero_counters()
    summary = serve.run_serve(artifact, img_dir, out_dir, batch_size=BATCH,
                              gt_dir=gt_dir, device="cuda")
    launches = {k: _read_counters().get(k, 0) for k in SERVE_ENTRIES}
    forwards = math.ceil(N_IMAGES / BATCH)
    if launches["cg_instance_norm_act"] < (5 + 2 * N_BLOCKS) * forwards or \
            launches["cg_conv3x3_reflect"] < 2 * N_BLOCKS * forwards:
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
            "launches": launches, "record": rec, "G": G}


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

        _zero_counters()
        with ThreadPoolExecutor(max_workers=4) as ex:
            results = list(ex.map(post, range(8)))
        launches = {k: _read_counters().get(k, 0) for k in SERVE_ENTRIES}
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
    if not all(launches.values()):
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

    from cyclegan_tpu_torch.kernels import instance_norm as IN

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
        for rec in in_case(shape, act, calls, randn, fail_if):
            recs[rec["kernel"]].append(rec)

    for dtype, b, calls in ((torch.float32, 2, 0), (torch.bfloat16, 2, 18),
                            (torch.bfloat16, 1, 9)):
        for rec in rb_case(dtype, (b, CROP // 4, CROP // 4, NGF * 4), calls, randn, fail_if):
            recs[rec["kernel"]].append(rec)
    torch.cuda.empty_cache()
    recs.update(kernels_train_chunked_dw(randn, fail_if))
    recs["grad_convs"] = kernels_grad_convs(randn, fail_if)
    recs["conv3x3_reflect"] = kernels_conv_fwd(randn, fail_if)
    return recs


def in_case(shape, act: str, calls: int, randn, fail_if, phase: str = "kernels_train",
            dtype=None) -> list:
    """TPU kernels #1 and #2 alone at one shape of ``dtype`` (default bf16;
    a seeded x and dy):
    each against its plain version (BWD_TOL for the VJP), a second call
    bitwise equal, its time eagerly and as a CUDA-graph replay, the plain
    version's, one library call's (F.instance_norm + act, and its autograd
    graph) and the byte bound. Returns the forward's and the VJP's records."""
    import torch
    import torch.nn.functional as F

    from cyclegan_tpu_torch.kernels import instance_norm as IN

    out = []
    dtype = dtype or torch.bfloat16
    dname = str(dtype).split(".")[1]
    x, dy = randn(shape, dtype, 2.0, 0.5), randn(shape, dtype)
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
                    dname)
    res_b = compare_bwd("instance_norm_act_bwd", dx,
                        IN.instance_norm_act_bwd_plain(x, dy, pm, pr, act), dname)
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
        rec = {"phase": phase, "kernel": name, "shape": list(shape),
               "dtype": dname, "act": act, **res, **t, "bound_ms": b_ms,
               "bound_by": b_by, "us_per_call": t["ms"] * 1e3, "bound_us": b_ms * 1e3,
               "second_call_bitwise_equal": bitwise[name], "calls_per_step": calls}
        fail_if(not (res["ok"] and bitwise[name]), name, rec)
        out.append(rec)
    del x, dy, y, y2, dx, dx2, xl, yl
    return out


def rb_case(dtype, shape, calls: int, randn, fail_if, phase: str = "kernels_train") -> list:
    """TPU kernels #3-#5 (the fused residual block) at one NHWC trunk
    ``shape``: the block's VJP through the Function against the plain VJP on
    the kernel path's relu mask (block_vjp_check), bias gradients exactly
    zero; then, where the path makes ``calls`` of it a step, the forward,
    dx and dw each against its plain version, timed beside the plain
    version, one library graph (reflect pad + cuDNN + F.instance_norm) and
    the bound. Returns the three records (none when ``calls`` is 0)."""
    import torch
    import torch.nn.functional as F

    from cyclegan_tpu_torch.kernels import resblock as RB

    out = []
    b, c = shape[0], shape[-1]
    dname = str(dtype).split(".")[1]
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
            {"phase": phase, "kernel": "residual_block_bwd", "via":
             "autograd.Function", "shape": list(shape), "dtype": dname,
             "bias_grads_exactly_zero": bias_zero, "reference": "plain VJP on the "
             "kernel path's relu mask", **{f"mask_{k}": v for k, v in flip.items()},
             **{f"{n}_{k}": r[k] for n, r in checks.items()
                for k in ("max_abs_err", "worst_err_over_tol")}})
    if not calls:
        return out
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
        rec = {"phase": phase, "kernel": name, "shape": list(shape),
               "dtype": dname, **res, **t, "bound_ms": b_ms, "bound_by": b_by,
               "gflop": sum(work.values()) / 1e9, "calls_per_step": calls}
        if old_work is not None:
            rec.update(bf16_passes=passes, bound_ms_f32_rate=bound(nb, old_work)[0])
        fail_if(not res["ok"], name, rec)
        out.append(rec)
    del x, dy, leaves, y, got, dxk, a, ds, du, g_parts, xl, yl
    return out


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
    a batch of 2 equal to the same sample alone; beside them one autograd
    graph of F.instance_norm + act [+ skip] for each pair (eager, CUDA
    events: the library yardstick)."""
    import torch
    import torch.nn.functional as F

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
    # Library yardstick: one autograd graph of F.instance_norm + relu and
    # F.instance_norm + the skip (NCHW views of the same inputs), forward,
    # and its backward to u and s32 from the cotangents da and dy.
    un, sn = (t.permute(0, 3, 1, 2).detach().requires_grad_() for t in (u, s32))
    xn, dan, dyn = (t.permute(0, 3, 1, 2) for t in (x, da, dy))

    def lib_fwd():
        return (torch.relu(F.instance_norm(un, eps=eps)).to(x.dtype),
                (F.instance_norm(sn, eps=eps) + xn).to(x.dtype))

    lib_out = lib_fwd()

    def lib_vjp():
        return torch.autograd.grad(lib_out, (un, sn), (dan.to(x.dtype), dyn),
                                   retain_graph=True)

    rec = {}
    for side, fn, lib in (("fwd", fwd, lib_fwd), ("vjp", vjp, lib_vjp)):
        b_ms, _ = bound(nbytes[side], 0.0, "float32")
        lib_graph = None
        with torch.no_grad() if side == "fwd" else contextlib.nullcontext():
            lib_eager = time_ms(lib, 20) * 1e3
            if side == "fwd":
                lib_graph = graph_us(lib)
        rec[side] = {
            "calls": 2, "shape": list(shape), "dtype": str(x.dtype).split(".")[1], "hc": HC,
            "graph_us_per_pair": graph_us(fn), "eager_us_per_pair": time_ms(fn, 20) * 1e3,
            "library_eager_us_per_pair": lib_eager, "library_graph_us_per_pair": lib_graph,
            "bound_us": b_ms * 1e3, "bound_by": "bytes", "bytes": nbytes[side],
            "second_call_bitwise_equal": all(torch.equal(a, b)
                                             for a, b in zip(first[side], outs[side])),
            "sample_alone_bitwise_equal": None if alone is None else all(
                torch.equal(a[1:2], b) for a, b in zip(first[side], alone[side]))}
    return rec


def kernels_train_chunked_dw(randn, fail_if, cases=None, phase: str = "kernels_train") -> dict:
    """TPU kernels #6 and #7 (the chunked block, path A) and #8 (conv_dw,
    path B) against their plain versions at the train step's trunk shapes,
    float32 and bf16, timed, with bitwise repeatability of their dw.
    ``cases``: (dtype, trunk shape, chunked calls a step, conv_dw calls a
    step) to hold instead of the voc_semisup_256 step's."""
    import torch
    import torch.nn.functional as F

    from cyclegan_tpu_torch.kernels import conv_dw as CD
    from cyclegan_tpu_torch.kernels import resblock_chunked as RC

    recs = {"residual_block_chunked": [], "residual_block_chunked_bwd": [], "conv_dw": []}
    c = NGF * 4
    # (dtype, shape, chunked calls per step, conv_dw calls per step): the
    # generator applies at batch 2 and 1 (see train_in_cases).
    trunk = (CROP // 4, CROP // 4, c)
    for dtype, shape, rc_calls, dw_calls in cases or (
            (torch.float32, (2, *trunk), 0, 0), (torch.bfloat16, (2, *trunk), 18, 36),
            (torch.bfloat16, (1, *trunk), 9, 18)):
        dname = str(dtype).split(".")[1]
        b = shape[0]
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
            rec = {"phase": phase, "kernel": name, "shape": list(shape),
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
    """The gradient convolutions alone at the trunk shapes (batch 16 and 8,
    the train cells' rows, then 2 and 1; 64x64x256) on the main path's mix:
    bf16 activations and weights with a float32 cotangent (conv_dw: bf16
    input and output gradient, as path B calls it), against their plain
    versions on the same values at the float32 bars of BWD_TOL; each twice,
    bitwise equal; the input gradient's tile and grid. The whole-block VJPs
    above are held at the looser bf16 bars, which absorb the recompute's
    rounding flips; these are not."""
    import torch
    import torch.nn.functional as F

    from cyclegan_tpu_torch.kernels import conv_dw as CD
    from cyclegan_tpu_torch.kernels import resblock as RB

    c, recs = NGF * 4, []
    for b in (16, 8, 2, 1):
        shape = (b, CROP // 4, CROP // 4, c)
        x, w = randn(shape, torch.bfloat16), randn((3, 3, c, c), torch.bfloat16, 0.02)
        g, dy = randn(shape), randn(shape, torch.bfloat16)
        xp = F.pad(x.permute(0, 3, 1, 2), (1, 1, 1, 1), mode="reflect")
        xpl, wl = xp, w.permute(3, 2, 0, 1).contiguous(memory_format=torch.channels_last)
        xp = xp.permute(0, 2, 3, 1).contiguous()
        gl, dyl = g.to(torch.bfloat16).permute(0, 3, 1, 2), dy.permute(0, 3, 1, 2)
        da, da_again = torch.empty(shape, device="cuda"), torch.empty(shape, device="cuda")
        RB.conv3x3_reflect_dgrad(g, w, da)
        RB.conv3x3_reflect_dgrad(g, w, da_again)
        dw, dw_again = RB.conv3x3_reflect_wgrad(x, g), RB.conv3x3_reflect_wgrad(x, g)
        cd, cd_again = CD.conv_dw(xp, dy), CD.conv_dw(xp, dy)
        torch.cuda.synchronize()
        conv = 2.0 * b * shape[1] * shape[2] * 9 * c * c
        act_b = x.numel() * 2
        # (name, result, bitwise, kernel, plain, library, bytes, bf16 passes)
        cases = (
            ("conv3x3_reflect_dgrad", compare_bwd(
                "conv3x3_reflect_dgrad", da, RB.conv3x3_reflect_dgrad_plain(g, w), "bfloat16"),
             torch.equal(da, da_again), lambda: RB.conv3x3_reflect_dgrad(g, w, da),
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
            if name == "conv3x3_reflect_dgrad":
                plan = RB.dgrad_plan(*shape, c)
                rec.update(plan=list(plan), blocks=RB.dgrad_blocks(plan, *shape[:3], c))
            fail_if(not (res["ok"] and bitwise), name, rec)
            recs.append(rec)
        del x, w, g, dy, xp, xpl, da, da_again, dw, dw_again, cd, cd_again
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
def deterministic_algorithms():
    """cuDNN's and PyTorch's deterministic algorithms (``warn_only``: an op
    without one warns) around the runs a resume check compares. Without
    them two runs from one seed differ from the first update on (the
    library's backward sums in another order each run), and the GAN steps
    grow that to the bf16 bars by step 5, so the resumed-against-
    uninterrupted check could fail on rounding alone; with them a step's
    gradients are bitwise repeatable on an H100. The runner never sets
    them: the timed CLI runs are in the default mode."""
    import torch

    saved = (torch.backends.cudnn.deterministic, torch.are_deterministic_algorithms_enabled(),
             torch.is_deterministic_algorithms_warn_only_enabled())
    torch.backends.cudnn.deterministic = True
    torch.use_deterministic_algorithms(True, warn_only=True)
    try:
        yield
    finally:
        torch.backends.cudnn.deterministic = saved[0]
        torch.use_deterministic_algorithms(saved[1], warn_only=saved[2])


def deterministic_cost(trainer, batch, first: int, t, st) -> dict:
    """What deterministic_algorithms() costs the default path's step: the
    median of TIMED_STEPS steps of the trainer ``t`` (state ``st``) in each
    mode, in turns (default, deterministic, deterministic, default), host
    clock around synchronized steps, after a first step under the mode
    kept apart (its time recorded); and each mode's repeatability: two
    trainers from one seed (``trainer()``) take step 1 on ``batch(0)`` in
    that mode, and their step-1 gradients are compared (tensors not bitwise
    equal, and the worst norm of a difference over its tensor's)."""
    import torch

    def mode(det: bool):
        return deterministic_algorithms() if det else contextlib.nullcontext()

    def timed(det: bool, at: int) -> list:
        out = []
        with mode(det):
            for i in range(TIMED_STEPS):
                torch.cuda.synchronize()
                t0 = time.perf_counter()
                t.train_step(st, batch(at + i))
                torch.cuda.synchronize()
                out.append((time.perf_counter() - t0) * 1e3)
        return out

    # The first step under the mode (cuDNN picks its algorithms anew).
    with mode(True):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        t.train_step(st, batch(first))
        torch.cuda.synchronize()
        first_det_ms = (time.perf_counter() - t0) * 1e3
    default_ms = timed(False, first)
    det_ms = timed(True, first + TIMED_STEPS) + timed(True, first)
    default_ms += timed(False, first + TIMED_STEPS)
    repeatable = {}
    for name, det in (("default", False), ("deterministic", True)):
        grads = []
        with mode(det):
            for _ in range(2):
                a, sa = trainer()
                a.train_step(sa, batch(0))
                grads.append(_grads(a))
                del a, sa
        g0, g1 = grads
        unequal = sum(not torch.equal(g0[k], g1[k]) for k in g0)
        worst = max(float((g0[k] - g1[k]).norm() / g1[k].norm()) for k in g0)
        repeatable[name] = {"bitwise": unequal == 0, "step1_grads_not_bitwise": unequal,
                            "step1_grads": len(g0), "worst_rel_diff": worst}
        del grads, g0, g1
        torch.cuda.empty_cache()
    return {"first_step_ms_deterministic": first_det_ms,
            "step_ms_default": default_ms, "step_ms_deterministic": det_ms,
            "median_step_ms_default": statistics.median(default_ms),
            "median_step_ms_deterministic": statistics.median(det_ms),
            "deterministic_over_default": statistics.median(det_ms)
            / statistics.median(default_ms),
            "repeatable": repeatable}


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


def _named_nets(trainer):
    """(name, net) of every net a trainer trains."""
    names = ("model",) if hasattr(trainer, "model") else ("G_i2l", "G_l2i", "D_img", "D_lab")
    return zip(names, trainer.nets())


def _pre_norm_biases(trainer) -> tuple[set, set]:
    """ids of the biases of the trunk blocks that run whole (fused or
    chunked), and of every conv bias that a norm follows, instance or batch
    (those included): the norm cancels it, so its gradient is zero in exact
    arithmetic and rounding noise in float."""
    from cyclegan_tpu_torch.models.generators import UnetLevel
    from cyclegan_tpu_torch.ops.blocks import BatchNorm, InstanceNorm, ResidualBlock

    norms = (InstanceNorm, BatchNorm)
    trunk, pre_norm = set(), set()
    for net in trainer.nets():
        for m in net.modules():
            if isinstance(m, ResidualBlock) and m.route != "unfused":
                trunk |= {id(m.conv0.conv.bias), id(m.conv1.conv.bias)}
            if isinstance(getattr(m, "norm", None), norms) and m.conv.bias is not None:
                pre_norm.add(id(m.conv.bias))
            if isinstance(m, UnetLevel):
                pre_norm |= {id(c.bias) for c, n in ((m.down, m.down_norm), (m.up, m.up_norm))
                             if isinstance(n, norms)}
    return trunk, pre_norm


def _grads(trainer) -> dict:
    """Clones of the gradients of every weight and of every bias that no
    norm follows, by ``net.parameter`` name."""
    _, pre_norm = _pre_norm_biases(trainer)
    return {f"{net_name}.{name}": p.grad.detach().clone()
            for net_name, net in _named_nets(trainer)
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
    for net_name, net in _named_nets(trainer):
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


def net_counts(net) -> dict:
    """Kernel calls of one train-mode forward of ``net`` and its backward,
    from its modules: ``norms`` instance norms outside whole trunk blocks,
    ``fused`` / ``chunked`` whole trunk blocks, ``dw`` ConvBlocks whose
    weight gradient is conv_dw. Under remat the backward recomputes every
    trunk block's forward: ``re_norms`` more instance norms (those of
    unfused trunk blocks), ``re_fused`` and ``re_chunked`` more block
    forwards."""
    from cyclegan_tpu_torch.ops.blocks import ConvBlock, InstanceNorm, ResidualBlock

    blocks = [m for m in net.modules() if isinstance(m, ResidualBlock)]
    whole = [m for m in blocks if m.route != "unfused"]
    routes = [m.route for m in whole]
    fused, chunked = routes.count("fused"), routes.count("chunked")
    norms = sum(isinstance(m, InstanceNorm) for m in net.modules())
    # The ConvBlocks of whole blocks only hold their weights.
    idle = {id(c) for m in whole for c in (m.conv0, m.conv1)}
    dw = sum(isinstance(m, ConvBlock) and m.dw_fused and id(m) not in idle
             for m in net.modules())
    remat = bool(getattr(net, "remat", False))
    trunk_norms = sum(isinstance(n, InstanceNorm) for m in blocks if m.route == "unfused"
                      for n in m.modules())
    # The norms of whole trunk blocks are inside their kernels.
    return {"norms": norms - 2 * (fused + chunked), "fused": fused, "chunked": chunked,
            "dw": dw, "re_norms": trunk_norms if remat else 0,
            "re_fused": fused if remat else 0, "re_chunked": chunked if remat else 0}


def launches_per_step(in_calls: int, rb: int, rc: int, dw: int, re_in: int = 0,
                      re_rb: int = 0, re_rc: int = 0) -> dict:
    """C-entry launches (``_build.launches``) of a step that makes ``in_calls``
    instance norms (and their VJPs), ``rb`` fused and ``rc`` chunked blocks
    (forward and backward), ``dw`` conv_dw weight gradients, and under remat
    ``re_in`` / ``re_rb`` / ``re_rc`` recomputed norm and block forwards.
    C entries: the fused block's forward makes 2 convolutions and 2 norms,
    its backward recomputes both and their statistics and makes 2 norm
    VJPs, 2 input and 2 weight gradients. The chunked forward makes 2
    convolutions and 2 norms; its backward reads the saved residuals: 2 norm
    VJPs, 2 input and 2 weight gradients, and no convolution. The weight
    gradients are cg_conv_dw, as path B's conv_dw is. cg_bf16_parts: both
    backwards split ds and du once each, for an input and a weight gradient,
    and reflect-pad the input of each weight gradient (4); bf16 conv_dw on
    channels that are multiples of 8 needs none."""
    return {"cg_instance_norm_act": in_calls + re_in + 4 * rb + 2 * re_rb + 2 * re_rc,
            "cg_instance_norm_act_bwd": in_calls + 2 * rb,
            "cg_conv3x3_reflect": 4 * rb + 2 * rc + 2 * re_rb + 2 * re_rc,
            "cg_conv3x3_reflect_dgrad": 2 * rb + 2 * rc,
            "cg_conv_dw": dw + 2 * rb + 2 * rc, "cg_bf16_parts": 4 * rb + 4 * rc,
            "cg_chunked_in_fwd": 2 * rc + 2 * re_rc, "cg_chunked_in_vjp": 2 * rc}


def expected_launches(trainer, steps: int) -> dict:
    """Launch counts of ``steps`` train steps, from the modules and
    train/cyclegan.py: three generator applies (G_i2l on [unlab; lab], G_l2i
    on [onehot; fake_lab], G_i2l on fake_img) and four discriminator applies
    (D_lab, D_img in the G phase; D_img, D_lab in the D phase), each with
    its backward (the G-phase gradient flows through D into the fakes)."""
    g, d = net_counts(trainer.G_i2l), net_counts(trainer.D_img)
    per = launches_per_step(3 * g["norms"] + 4 * d["norms"], 3 * g["fused"],
                            3 * g["chunked"], 3 * g["dw"], 3 * g["re_norms"],
                            3 * g["re_fused"], 3 * g["re_chunked"])
    return {k: v * steps for k, v in per.items()}


def supervised_launches(trainer, steps: int) -> dict:
    """Launch counts of ``steps`` supervised train steps: one forward of the
    segmentation net and its backward a step (train/supervised.py)."""
    g = net_counts(trainer.model)
    per = launches_per_step(g["norms"], g["fused"], g["chunked"], g["dw"], g["re_norms"],
                            g["re_fused"], g["re_chunked"])
    return {k: v * steps for k, v in per.items()}


def _zero_counters() -> None:
    from cyclegan_tpu_torch.kernels import _build

    _build.launches.clear()


def _read_counters() -> dict:
    """Calls of each C entry since :func:`_zero_counters`."""
    from cyclegan_tpu_torch.kernels import _build

    return dict(_build.launches)


# The paths of the train step: (route of the residual blocks, use_dropout).
TRAIN_PATHS = {"default": ("fused", False), "chunked": ("chunked", False),
               "dropout": ("fused", True)}
# What each path must show in its launch counters per step, beside the
# derived counts: path A runs the chunked block in every trunk block (2
# norms, 2 norm VJPs, 2 forward and 2 input-gradient convolutions a block)
# and no fused one (whose recompute would add forward convolutions); path B
# runs conv_dw for both trunk convolutions and no residual-block kernel.
PATH_COUNTS = {"chunked": {"cg_chunked_in_fwd": 54, "cg_chunked_in_vjp": 54,
                           "cg_conv3x3_reflect": 54, "cg_conv3x3_reflect_dgrad": 54},
               "dropout": {"cg_conv_dw": 54, "cg_conv3x3_reflect": 0,
                           "cg_chunked_in_fwd": 0}}


def profile_step(step) -> dict:
    """One profiled call of ``step``: its host ms, the device kernels' sum
    and busy share, the largest kernels, the forward convolution's, the
    weight gradient's, the instance norm's and the chunked norms' device ms
    and launches, and the norm C entries called."""
    import torch

    from cyclegan_tpu_torch.kernels import _build

    entries = dict(_build.launches)
    with torch.profiler.profile(activities=[torch.profiler.ProfilerActivity.CPU,
                                            torch.profiler.ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        step()
        torch.cuda.synchronize()
        step_ms = (time.perf_counter() - t0) * 1e3
    entries = {k: _build.launches[k] - entries.get(k, 0)
               for k in ("cg_instance_norm_act", "cg_instance_norm_act_bwd",
                         "cg_chunked_in_fwd", "cg_chunked_in_vjp")}
    # Device kernels only (CPU ops that launched them carry the same time).
    device_ms = [(e.key, e.self_device_time_total / 1e3, e.count)
                 for e in prof.key_averages() if e.self_device_time_total > 0
                 and getattr(e, "device_type", None) == torch.autograd.DeviceType.CUDA]
    device_ms.sort(key=lambda r: -r[1])
    total = sum(r[1] for r in device_ms)
    return {"profiled_step_ms": step_ms, "profiled_step_device_ms_total": total,
            "profiled_step_device_busy_share": total / step_ms,
            "profiled_step_device_ms_by_kernel": [
                {"kernel": k[:90], "ms": ms, "calls": n} for k, ms, n in device_ms[:20]],
            "profiled_step_conv3x3_fwd": conv_fwd_device_ms(device_ms),
            "profiled_step_wgrad_wgmma": in_device_ms(device_ms,
                                                      (("k1", "wgrad_wgmma<"),))["k1"],
            "profiled_step_instance_norm": in_device_ms(device_ms),
            "profiled_step_chunked_norms": in_device_ms(device_ms, CHUNKED_NORMS),
            "profiled_step_norm_c_entries": entries}


def check_one_launch_a_entry(rec: dict, path: str) -> None:
    """The instance norm's kernels, forward and VJP, and the chunked block's
    norms (path A: 4 a block, 108 a step) launch once a C entry call in
    ``profile_step``'s record, or this raises."""
    entries = rec["profiled_step_norm_c_entries"]
    in_prof = rec["profiled_step_instance_norm"]
    if (in_prof["fwd"]["launches"], in_prof["bwd"]["launches"]) != \
            (entries["cg_instance_norm_act"], entries["cg_instance_norm_act_bwd"]):
        raise AssertionError(f"{path}: instance-norm kernels {in_prof} in the profiled step, "
                             f"not one a C entry {entries}")
    rc_prof = rec["profiled_step_chunked_norms"]
    if (rc_prof["fwd"]["launches"], rc_prof["vjp"]["launches"]) != \
            (entries["cg_chunked_in_fwd"], entries["cg_chunked_in_vjp"]):
        raise AssertionError(f"{path}: chunked norm kernels {rc_prof} in the profiled step, "
                             f"not one a C entry {entries}")


def phase_train(smi: str, path: str = "default") -> dict:
    import numpy as np
    import torch

    from cyclegan_tpu_torch.data.datasets import DATASET_SPECS, _synthetic_sample
    from cyclegan_tpu_torch.data.transforms import normalize
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
    rec.update(profile_step(lambda: kt.train_step(ks, batch(s0 + 2 * TIMED_STEPS))))
    rec["peak_mem_gb_profiled_step"] = torch.cuda.max_memory_allocated() / 1e9
    if path == "default":
        rec["deterministic_mode"] = deterministic_cost(trainer, batch, s0, kt, ks)
    emit(rec)
    check_one_launch_a_entry(rec, path)
    print(f"train step ({path}), {TRAIN_PRESET} 256x256 b1 bf16: median {med_k:.2f} ms "
          f"({1e3 / med_k:.2f} steps/s) on the kernels, {med_p:.2f} ms on the plain "
          f"versions; {smi}", flush=True)
    if path == "default":
        det = rec["deterministic_mode"]
        print(f"train step (default) under deterministic_algorithms(): median "
              f"{det['median_step_ms_deterministic']:.2f} ms against "
              f"{det['median_step_ms_default']:.2f} ms in the default mode; step-1 gradients "
              f"bitwise repeatable: default {det['repeatable']['default']['bitwise']}, "
              f"deterministic {det['repeatable']['deterministic']['bitwise']}; {smi}",
              flush=True)
    del kt, ks
    torch.cuda.empty_cache()
    return {"launches": launches, "record": rec}

# The CLI phase: `python -m cyclegan_tpu_torch.main` driven in-process on
# the voc_semisup_256 preset at full width over the synthetic dataset.
# dataset_size 24 at 1/8 labeled gives 3 steps an epoch at batch 1 (32 gives
# 4, for the stacked runs); the val split is the synthetic 40 images.
CLI_SIZE, CLI_STACK_SIZE, CLI_VAL = 24, 32, 40
CLI_PREEMPT_AT = 4  # optimizer step: epoch 1, call 1
CLI_IN_KERNELS = ("cg_instance_norm_act", "cg_instance_norm_act_bwd", "cg_conv3x3_reflect",
                  "cg_conv3x3_reflect_dgrad", "cg_conv_dw")
# What a served forward launches: its norms and forward convolutions.
SERVE_ENTRIES = ("cg_instance_norm_act", "cg_conv3x3_reflect")
SCORE_TOL = 1e-4  # --testing against the last validation, mIoU and pixel accuracy


def net_forward_launches(net, n: int) -> dict:
    """C-entry launches of ``n`` forwards of ``net`` without gradients
    (eval, sample dumps, --testing): every norm, a fused trunk block's two
    included, is one cg_instance_norm_act launch, and each fused block makes
    two forward convolutions; no backward kernel."""
    from cyclegan_tpu_torch.ops.blocks import InstanceNorm, ResidualBlock

    out = dict.fromkeys(CLI_IN_KERNELS, 0)
    fused = sum(isinstance(m, ResidualBlock) and m.route == "fused" for m in net.modules())
    norms = sum(isinstance(m, InstanceNorm) for m in net.modules())
    out["cg_instance_norm_act"] += n * norms
    out["cg_conv3x3_reflect"] += n * 2 * fused
    return out


def forward_launches(trainer, n_i2l: int, n_l2i: int) -> dict:
    """Launches of ``n_i2l`` G_i2l and ``n_l2i`` G_l2i forwards."""
    a, b = net_forward_launches(trainer.G_i2l, n_i2l), net_forward_launches(trainer.G_l2i, n_l2i)
    return {k: a[k] + b[k] for k in CLI_IN_KERNELS}


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

    def launch(what: str, argv: list, want: dict, env: dict | None = None,
               deterministic: bool = False):
        saved = {k: os.environ.get(k) for k in (env or {})}
        os.environ.update(env or {})
        mode = deterministic_algorithms() if deterministic else contextlib.nullcontext()
        try:
            with resblock_env("fused"), mode:
                _zero_counters()
                t0 = time.perf_counter()
                res = cli(argv)
                torch.cuda.synchronize()
                wall = time.perf_counter() - t0
                got = {k: _read_counters().get(k, 0) for k in CLI_IN_KERNELS}
        finally:
            for k, v in saved.items():
                os.environ.pop(k, None)
                if v is not None:
                    os.environ[k] = v
        if got != want or not any(got.values()):
            raise AssertionError(f"cli {what}: launch counters {got} != derived {want}")
        runs[what] = {"seconds": wall, "launches": got, "derived": want,
                      "deterministic": deterministic,
                      "runner_seconds": (res or {}).get("seconds")}
        return res

    runs: dict = {}
    train = ["--training", "--dataset_size", str(CLI_SIZE), "--epochs", "2"]
    steps_per_epoch = 3
    val = CLI_VAL
    try:
        # (a) the uninterrupted run in the default mode (timed); then, under
        # deterministic algorithms (two launches are otherwise not bitwise
        # repeatable on the card), the same against one preempted and
        # resumed.
        ref_val = launch("a_reference", train + base + dirs("ref"),
                         derived(2 * steps_per_epoch, 2 * val + 2, 2))
        launch("a_deterministic", train + base + dirs("det"),
               derived(2 * steps_per_epoch, 2 * val + 2, 2), deterministic=True)
        first = launch("a_preempted", train + base + dirs("res") + ["--save_every_steps", "1"],
                       derived(CLI_PREEMPT_AT, val + 1, 1),
                       env={"CYCLEGAN_TPU_PREEMPT_AT_STEP": str(CLI_PREEMPT_AT)},
                       deterministic=True)
        if not first.get("preempted"):
            raise AssertionError(f"cli: the first launch was not preempted: {first}")
        last_val = launch("a_resumed", train + base + dirs("res") + ["--save_every_steps", "1"],
                          derived(2 * steps_per_epoch - CLI_PREEMPT_AT, val + 1, 1),
                          deterministic=True)
        ref_log, det_log, res_log = logged("ref"), logged("det"), logged("res")
        if not [r["step"] for r in ref_log] == [r["step"] for r in det_log] == \
                [r["step"] for r in res_log] == list(range(1, 2 * steps_per_epoch + 1)):
            raise AssertionError(f"cli: logged steps {[r['step'] for r in ref_log]}, "
                                 f"{[r['step'] for r in det_log]} and "
                                 f"{[r['step'] for r in res_log]}")

        def over_tol(log: list, against: list) -> dict:
            return {key: [abs(r[key] - q[key]) / (tols[min(i, 2)][1]
                                                  + tols[min(i, 2)][0] * abs(q[key]))
                          for i, (r, q) in enumerate(zip(log, against))]
                    for key, tols in TRAIN_TOL["bfloat16"].items()}

        loss_err = over_tol(res_log, det_log)
        for key, errs in loss_err.items():
            if not all(math.isfinite(r[key]) for r in res_log) or max(errs) > 1.0:
                raise AssertionError(f"cli: resumed {key} {[r[key] for r in res_log]} vs "
                                     f"uninterrupted {[q[key] for q in det_log]}")
        default_err = over_tol(ref_log, det_log)
        ref_ck = torch.load(os.path.join(tmp, "det", "ckpt", "1.pt"), weights_only=True)
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
        phase_ckpt_bridge(tmp, base, launch, derived, smi)
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
           "losses_uninterrupted": [{k: r[k] for k in ("g_total", "d_total")} for r in det_log],
           "losses_default_mode": [{k: r[k] for k in ("g_total", "d_total")} for r in ref_log],
           "loss_err_over_tol": loss_err, "default_mode_err_over_tol": default_err,
           "tol": TRAIN_TOL["bfloat16"],
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


def phase_ckpt_bridge(tmp: str, base: list, launch, derived, smi: str) -> dict:
    """The reference-checkpoint bridge on the cli phase's resumed run
    (``voc_semisup_256``, epoch 1, step 6): tools/torch_export_checkpoint.py
    writes its latest.ckpt, tools/torch_import_checkpoint.py reads it into a
    fresh directory: every net tensor, Adam moment and step bitwise the
    original; --training resumes there for one step (launches as derived,
    logged step 7 of epoch 2); tools/torch_reference.py's nets load the
    exported state dicts, and their float32 forward on the card is within
    GEN_TOL (of the largest magnitude) of the port's, on the kernels."""
    import torch

    from cyclegan_tpu_torch.train.cyclegan import CycleGANTrainer
    from cyclegan_tpu_torch.utils.config import preset
    from tools import torch_export_checkpoint as exp_tool
    from tools import torch_import_checkpoint as imp_tool

    t_phase = time.perf_counter()
    src = os.path.join(tmp, "res", "ckpt")
    out = os.path.join(tmp, "bridge", "latest.ckpt")
    back = os.path.join(tmp, "bridge", "ckpt")
    os.makedirs(os.path.dirname(out))
    flags = ["--preset", TRAIN_PRESET, "--dataset", "synthetic", "--epochs", "3"]
    with contextlib.redirect_stdout(io.StringIO()) as said:
        exp_tool.main([src, out] + flags)
        imp_tool.main([out, back] + flags)
    t_tools = time.perf_counter() - t_phase
    a = torch.load(os.path.join(src, "1.pt"), weights_only=True)
    b = torch.load(os.path.join(back, "1.pt"), weights_only=True)
    tensors = [(f"nets/{n}/{k}", v, b["nets"][n][k]) for n, sd in a["nets"].items()
               for k, v in sd.items()]
    for opt in ("g_opt", "d_opt"):
        if a[opt]["state"].keys() != b[opt]["state"].keys():
            raise AssertionError(f"ckpt_bridge: {opt} states {sorted(b[opt]['state'])}")
        tensors += [(f"{opt}/{i}/{f}", v, b[opt]["state"][i][f])
                    for i, st in a[opt]["state"].items() for f, v in st.items()]
    unequal = [name for name, x, y in tensors if not torch.equal(x, y)]
    if unequal or a["step"] != b["step"]:
        raise AssertionError(f"ckpt_bridge: not bitwise after export + import: {unequal[:5]}, "
                             f"step {a['step']} -> {b['step']}")
    # The imported run resumes from the CLI: one step of epoch 2.
    res = os.path.join(tmp, "bridge", "res")
    launch("ckpt_bridge_resume", ["--training", "--dataset_size", str(CLI_SIZE), "--epochs",
                                  "3", "--max_steps", "1", "--validation_every", "0",
                                  "--checkpoint_dir", back, "--results_dir", res] + base,
           derived(1))
    with open(os.path.join(res, "train_metrics.jsonl")) as f:
        resumed = [json.loads(line) for line in f]
    if [(r["step"], r["epoch"]) for r in resumed] != [(a["step"] + 1, 2)] or \
            not math.isfinite(resumed[0]["g_total"]):
        raise AssertionError(f"ckpt_bridge: the imported run logged {resumed}")
    # The reference nets on the exported state dicts against the port's.
    ckpt = torch.load(out, map_location="cuda", weights_only=False)
    cfg = preset(TRAIN_PRESET).replace(bf16=False)
    with resblock_env("fused"):
        t = CycleGANTrainer(cfg, NUM_CLASSES, 3, 1, device="cuda")
    refs = {"Gsi": exp_tool.reference_generator(cfg, 3, NUM_CLASSES, tanh=False),
            "Gis": exp_tool.reference_generator(cfg, NUM_CLASSES, 3, tanh=True),
            "Di": exp_tool.reference_discriminator(cfg, 3),
            "Ds": exp_tool.reference_discriminator(cfg, NUM_CLASSES)}
    batch = _dp_batch(cfg, 1, 1)[0]
    x = torch.from_numpy(batch["lab_image"]).cuda().permute(0, 3, 1, 2).contiguous()
    lab = torch.from_numpy(batch["lab_label"]).cuda().clamp(max=NUM_CLASSES - 1)
    oh = torch.nn.functional.one_hot(lab, NUM_CLASSES).permute(0, 3, 1, 2).float()
    forward = {}
    for (name, ref), port, inp in zip(refs.items(), ("G_i2l", "G_l2i", "D_img", "D_lab"),
                                      (x, oh, x, oh)):
        net = getattr(t, port)
        net.load_state_dict(b["nets"][port])
        ref.load_state_dict(ckpt[name])
        ref.cuda().eval()
        with torch.no_grad():
            want = ref(inp)
            got = net(inp.contiguous(memory_format=torch.channels_last))
        err = float((got.float() - want).abs().max())
        bar = GEN_TOL * float(want.abs().max())
        forward[name] = {"max_abs_err": err, "bar": bar, "shape": list(want.shape)}
        if not err <= bar:
            raise AssertionError(f"ckpt_bridge: {name} of the reference nets vs the port: "
                                 f"{forward[name]}")
    del t, refs, ckpt, a, b
    torch.cuda.empty_cache()
    rec = {"phase": "ckpt_bridge", "preset": TRAIN_PRESET, "epoch": 1,
           "step": resumed[0]["step"] - 1, "tensors_bitwise": len(tensors),
           "tools_seconds": t_tools, "tools_said": said.getvalue().splitlines(),
           "resumed_log": resumed, "reference_forward_float32": forward, "tol": GEN_TOL,
           "seconds": time.perf_counter() - t_phase, "nvidia_smi": smi}
    emit(rec)
    return rec


# The supervised segmenter (BASELINE.json config 1): the voc_supervised_128
# preset at its published widths (resnet_6blocks, ngf 64, 21 classes,
# 128x128, batch 2, bf16 over float32), on three routes: its default
# generator, unet_128 (7 levels), and --norm batch. VOC2012's 100-image
# subset at batch 2 gives 50 steps an epoch (the LambdaLR staircase).
SUP_PRESET = "voc_supervised_128"
SUP_STEPS_PER_EPOCH = 50
SUP_PATHS = {"train_supervised": {}, "train_supervised_unet": {"gen_net": "unet_128"},
             "train_supervised_bn": {"norm": "batch"}}
# The per-step ce_loss, kernel path vs plain path: the g_total bars of
# TRAIN_TOL, with the same reasons (step 1 at the same weights; from step 2
# Adam's first updates move weights by +-lr whatever their gradient's size).
SUP_TOL = {dtype: tols["g_total"] for dtype, tols in TRAIN_TOL.items()}
# Batch-norm running averages after 3 steps, kernel path vs plain path:
# |k - p| <= tol * max(1, |p|). Step 1's forwards run no kernel (the trunk's
# weight gradient is #8's, a backward), so they agree bitwise; from step 2
# the weights differ as above, and every bias before a batch norm has a
# gradient of rounding size that Adam moves by +-lr (1.2e-3 apart after 3
# steps, a running mean 2.8e-4, on the CPU against the JAX package); in
# bf16 a weight moved by 2e-4 also rounds to another bf16 value.
BN_STATS_TOL = {"float32": 2e-3, "bfloat16": 1e-2}


def _sup_batch(cfg, n_cls: int, in_ch: int, index: int = 0) -> dict:
    """Two synthetic samples at the preset's crop, a void border on the
    labels (as VOC's masks have), on the card."""
    import numpy as np
    import torch

    from cyclegan_tpu_torch.data.datasets import _synthetic_sample
    from cyclegan_tpu_torch.data.transforms import normalize

    imgs, labs = [], []
    for i in range(cfg.batch_size):
        img, lab = _synthetic_sample(index + i, cfg.crop_hw, n_cls, in_ch)
        lab = lab.astype(np.int64)
        lab[:2], lab[:, :2] = 255, 255
        imgs.append(normalize(img))
        labs.append(lab)
    return {"image": torch.from_numpy(np.stack(imgs)).cuda(),
            "label": torch.from_numpy(np.stack(labs)).cuda()}


def _running_stats(trainer) -> dict:
    from cyclegan_tpu_torch.ops.blocks import BatchNorm

    return {f"{n}.{k}": getattr(m, k).detach().clone() for n, m in trainer.model.named_modules()
            if isinstance(m, BatchNorm) for k in ("running_mean", "running_var")}


def _stats_err(a: dict, b: dict) -> float:
    return max(float(((a[k] - b[k]).abs() / b[k].abs().clamp_min(1.0)).max()) for k in b)


def phase_train_supervised(smi: str, path: str) -> dict:
    """SupervisedTrainer.train_step of voc_supervised_128 (or its unet_128 /
    --norm batch route) on one synthetic batch of 2: float32 then bf16, 3
    steps on the kernels and 3 on the plain seams from one state each; the
    per-step ce_loss, the float32 step-1 gradients against the measured
    plain-vs-plain floor, every launch counter against the count derived
    from the modules, the median step of each path in turns, one profiled
    step; under batch norm the running averages of both paths and the
    eval-mode logits from them."""
    import numpy as np
    import torch

    from cyclegan_tpu_torch.data.datasets import DATASET_SPECS
    from cyclegan_tpu_torch.ops.blocks import frozen_running_stats
    from cyclegan_tpu_torch.train.supervised import SupervisedTrainer
    from cyclegan_tpu_torch.utils.config import preset

    cfg = preset(SUP_PRESET).replace(**SUP_PATHS[path])
    n_cls, in_ch, _ = DATASET_SPECS[cfg.dataset]
    batch = _sup_batch(cfg, n_cls, in_ch)

    def trainer(c=cfg):
        with resblock_env("fused"):
            t = SupervisedTrainer(c, n_cls, in_ch, SUP_STEPS_PER_EPOCH, device="cuda")
        return t, t.init_state(torch.Generator().manual_seed(0))

    def run(t, st, plain=False, after_step1=None) -> list:
        out = []
        with plain_seams() if plain else contextlib.nullcontext():
            for s in range(TRAIN_STEPS):
                st, m = t.train_step(st, batch)
                if s == 0 and after_step1 is not None:
                    after_step1(t)
                out.append(float(m["ce_loss"]))
        return out

    def agree(dtype: str, k: list, p: list) -> list:
        errs = [abs(a - b) / (atol + rtol * abs(b)) for a, b, (rtol, atol)
                in zip(k, p, SUP_TOL[dtype])]
        if not all(np.isfinite(k)) or max(errs) > 1.0:
            raise AssertionError(f"{path} {dtype} ce_loss: kernel path {k} vs plain path {p}")
        return errs

    f32 = cfg.replace(bf16=False)
    g_kernel, g_plain, g_plain2 = {}, {}, {}
    kt32, ks32 = trainer(f32)
    k32 = run(kt32, ks32, after_step1=lambda t: g_kernel.update(_grads(t)))
    pt32, ps32 = trainer(f32)
    p32 = run(pt32, ps32, plain=True, after_step1=lambda t: g_plain.update(_grads(t)))
    run(*trainer(f32), plain=True, after_step1=lambda t: g_plain2.update(_grads(t)))
    worst32 = agree("float32", k32, p32)

    def rel_err(g):
        return {k: float((g[k] - g_plain[k]).norm() / g_plain[k].norm()) for k in g_plain}

    grad_err, grad_floor = rel_err(g_kernel), rel_err(g_plain2)
    worst_grad = max(grad_err, key=grad_err.get)
    if not max(grad_err.values()) <= GRAD_TOL_F32:
        raise AssertionError(f"{path} float32 step-1 gradients, kernel vs plain path: worst "
                             f"{worst_grad} {grad_err[worst_grad]} > {GRAD_TOL_F32}")
    bn = {}
    if cfg.norm == "batch":
        bn["float32_stats_err"] = _stats_err(_running_stats(kt32), _running_stats(pt32))
    del g_kernel, g_plain, g_plain2, kt32, ks32, pt32, ps32
    torch.cuda.empty_cache()

    kt, ks = trainer()
    n_params = sum(p.numel() for p in kt.model.parameters())
    # The path's run: counts set to 0 just before, read just after.
    _zero_counters()
    grads = {}
    k_losses = run(kt, ks, after_step1=lambda t: grads.update(_check_grads(t)))
    torch.cuda.synchronize()
    launches = _read_counters()
    want = supervised_launches(kt, TRAIN_STEPS)
    if {k: launches.get(k, 0) for k in want} != want or not any(want.values()):
        raise AssertionError(f"{path}: launch counters {launches} != derived {want}")
    pt, ps = trainer()
    p_losses = run(pt, ps, plain=True)
    worst = agree("bfloat16", k_losses, p_losses)
    if cfg.norm == "batch":
        bn["bfloat16_stats_err"] = _stats_err(_running_stats(kt), _running_stats(pt))
        x = batch["image"].permute(0, 3, 1, 2)
        with torch.no_grad(), frozen_running_stats(kt.model):
            train_logits = kt.model(x).permute(0, 2, 3, 1)
        eval_logits = kt.logits(batch["image"])
        bn.update(eval_logits_shape=list(eval_logits.shape),
                  eval_logits_finite=bool(torch.isfinite(eval_logits).all()),
                  eval_differs_from_train_mode=not torch.equal(eval_logits.float(),
                                                               train_logits.float()),
                  eval_argmax_agreement_kernel_vs_plain=float(
                      (eval_logits.argmax(-1) == pt.logits(batch["image"]).argmax(-1))
                      .float().mean()),
                  tol=BN_STATS_TOL)
        if not (bn["float32_stats_err"] <= BN_STATS_TOL["float32"]
                and bn["bfloat16_stats_err"] <= BN_STATS_TOL["bfloat16"]
                and bn["eval_logits_finite"] and bn["eval_differs_from_train_mode"]
                and bn["eval_logits_shape"] == [cfg.batch_size, *cfg.crop_hw, n_cls]):
            raise AssertionError(f"{path}: batch norm {bn}")

    def timed(t, st) -> list:
        out = []
        for _ in range(TIMED_STEPS):
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            t.train_step(st, batch)
            torch.cuda.synchronize()
            out.append((time.perf_counter() - t0) * 1e3)
        return out

    with plain_seams():
        plain_ms = timed(pt, ps)
    kernel_ms = timed(kt, ks) + timed(kt, ks)
    with plain_seams():
        plain_ms += timed(pt, ps)
    del pt, ps
    torch.cuda.empty_cache()
    med_k, med_p = statistics.median(kernel_ms), statistics.median(plain_ms)
    torch.cuda.reset_peak_memory_stats()
    prof = profile_step(lambda: kt.train_step(ks, batch))
    rec = {"phase": path, "preset": SUP_PRESET, "gen_net": cfg.gen_net, "norm": cfg.norm,
           "crop": list(cfg.crop_hw), "batch": cfg.batch_size, "n_params": n_params,
           "nvidia_smi": smi, "losses_kernel_path": k_losses, "losses_plain_path": p_losses,
           "loss_err_over_tol": worst, "float32_losses_kernel_path": k32,
           "float32_losses_plain_path": p32, "float32_loss_err_over_tol": worst32,
           "float32_step1_grad_rel_err_worst": [worst_grad, grad_err[worst_grad]],
           "float32_step1_grad_rel_err_median": statistics.median(grad_err.values()),
           "float32_step1_grad_plain_vs_plain_worst": max(grad_floor.values()),
           "float32_step1_grad_plain_vs_plain_median": statistics.median(grad_floor.values()),
           "float32_step1_grads_compared": len(grad_err), "tol": SUP_TOL,
           "step1_grads": grads, "batch_norm": bn or None,
           "launches_over_3_steps": launches, "expected_launches": want,
           "step_ms_kernel": kernel_ms, "step_ms_plain": plain_ms,
           "median_step_ms_kernel": med_k, "steps_per_s_kernel": 1e3 / med_k,
           "median_step_ms_plain": med_p, "steps_per_s_plain": 1e3 / med_p, **prof,
           "peak_mem_gb_profiled_step": torch.cuda.max_memory_allocated() / 1e9}
    emit(rec)
    check_one_launch_a_entry(rec, path)
    print(f"{path} ({SUP_PRESET}, {cfg.gen_net}, norm {cfg.norm}, 128x128 b2 bf16): median "
          f"{med_k:.2f} ms on the kernels, {med_p:.2f} ms on the plain versions; profiled "
          f"step device {prof['profiled_step_device_ms_total']:.2f} ms, busy "
          f"{prof['profiled_step_device_busy_share']:.2f}; {smi}", flush=True)
    del kt, ks
    torch.cuda.empty_cache()
    return {"launches": launches, "record": rec}


def phase_kernels_supervised() -> dict:
    """kernels_supervised with its own seeded generator."""
    import torch

    g = torch.Generator(device="cuda").manual_seed(2)

    def randn(shape, dtype=torch.float32, scale=1.0, shift=0.0):
        return (torch.randn(shape, device="cuda", generator=g) * scale + shift).to(dtype)

    def fail_if(bad: bool, what: str, rec: dict):
        emit(rec)
        if bad:
            raise AssertionError(f"{what} disagrees with its plain version: {rec}")

    return kernels_supervised(randn, fail_if)


def kernels_supervised(randn, fail_if) -> dict:
    """The kernels of the supervised paths alone at their shapes (bf16,
    batch 2), against their plain versions, timed: #1/#2 at config 1's norm
    planes (relu) and at every U-Net plane (no activation; also float32 at
    the 2x2 and 4x4 planes, where a tile of in_plan has more rows than the
    plane), #3-#5 at config 1's trunk (2, 32, 32, 256), and #8 on its
    reflect-padded trunk input (batch norm's trunk). Returns {path:
    {kernel: [records]}}."""
    import torch
    import torch.nn.functional as F

    from cyclegan_tpu_torch.kernels import conv_dw as CD

    out = {path: {} for path in SUP_PATHS}

    def add(path, recs):
        for r in recs:
            out[path].setdefault(r["kernel"], []).append(r)

    b = 2
    for s, c, act, calls in ((128, 64, "relu", 2), (64, 128, "relu", 2), (32, 256, "relu", 1)):
        add("train_supervised", in_case((b, s, s, c), act, calls, randn, fail_if,
                                        "kernels_supervised"))
    add("train_supervised", rb_case(torch.bfloat16, (b, 32, 32, 256), 6, randn, fail_if,
                                    "kernels_supervised"))
    # U-Net planes: each carries a down norm and the up norm of the level
    # below it, but the outermost 64x64x64 (its up norm only).
    for s, c, calls in ((2, 512, 2), (4, 512, 2), (8, 512, 2), (16, 256, 2), (32, 128, 2),
                        (64, 64, 1)):
        add("train_supervised_unet", in_case((b, s, s, c), "none", calls, randn, fail_if,
                                             "kernels_supervised"))
    for s in (2, 4):
        in_case((b, s, s, 512), "none", 0, randn, fail_if, "kernels_supervised", torch.float32)
    # #8 at batch norm's trunk: 12 calls a step (6 blocks x 2 convolutions).
    shape, c = (b, 32, 32, 256), 256
    x, dy = randn(shape, torch.bfloat16), randn(shape, torch.bfloat16)
    xp = F.pad(x.permute(0, 3, 1, 2), (1, 1, 1, 1), mode="reflect").permute(0, 2, 3, 1)
    xp = xp.contiguous()
    dw, again = CD.conv_dw(xp, dy), CD.conv_dw(xp, dy)
    torch.cuda.synchronize()
    res = compare_bwd("conv_dw", dw, CD.conv_dw_plain(xp, dy), "bfloat16")
    conv = 2.0 * b * 32 * 32 * 9 * c * c
    passes = grad_passes(xp.dtype, dy.dtype)
    b_ms, b_by = bound(xp.numel() * 2 + dy.numel() * 2 + dw.numel() * 4,
                       {"bfloat16": passes * conv})
    xpl, dyl = xp.permute(0, 3, 1, 2), dy.permute(0, 3, 1, 2)
    rec = {"phase": "kernels_supervised", "kernel": "conv_dw", "shape": list(xp.shape),
           "dtype": "bfloat16", **res, "second_call_bitwise_equal": torch.equal(dw, again),
           "ms": time_ms(lambda: CD.conv_dw(xp, dy), 20),
           "plain_ms": time_ms(lambda: CD.conv_dw_plain(xp, dy), 5),
           "library_ms": time_ms(lambda: torch.nn.grad.conv2d_weight(xpl, (c, c, 3, 3), dyl),
                                 20),
           "bound_ms": b_ms, "bound_by": b_by, "bf16_passes": passes, "calls_per_step": 12}
    fail_if(not (res["ok"] and rec["second_call_bitwise_equal"]), "conv_dw", rec)
    add("train_supervised_bn", [rec])
    torch.cuda.empty_cache()
    return out


def phase_remat(smi: str) -> dict:
    """One step each of the CycleGAN default path (voc_semisup_256) and of
    config 1 (voc_supervised_128) with remat=True against remat=False from
    one state, float32 and bf16: losses within the step-1 bars of TRAIN_TOL
    / SUP_TOL; in float32 the step-1 gradients within GRAD_TOL_F32 of each
    other, beside the floor of two remat=False steps; in bf16 (the path's
    type) every launch counter equal to the derived count, which holds the
    trunk blocks' second forward, the peak memory of a step and the median
    step time of each setting, in turns."""
    import numpy as np
    import torch

    from cyclegan_tpu_torch.data.datasets import DATASET_SPECS, _synthetic_sample
    from cyclegan_tpu_torch.data.transforms import normalize
    from cyclegan_tpu_torch.train.cyclegan import CycleGANTrainer
    from cyclegan_tpu_torch.train.supervised import SupervisedTrainer
    from cyclegan_tpu_torch.utils.config import preset

    out = {"phase": "remat", "nvidia_smi": smi}
    for name, preset_name in (("cyclegan", TRAIN_PRESET), ("supervised", SUP_PRESET)):
        cfg = preset(preset_name)
        n_cls, in_ch, _ = DATASET_SPECS[cfg.dataset]
        if name == "cyclegan":
            lab_img, lab = _synthetic_sample(0, cfg.crop_hw, n_cls, in_ch)
            unlab_img, _ = _synthetic_sample(1, cfg.crop_hw, n_cls, in_ch)
            lab = lab.astype(np.int64)
            lab[:2], lab[:, :2] = 255, 255
            batch = {"lab_image": torch.from_numpy(normalize(lab_img)[None]).cuda(),
                     "unlab_image": torch.from_numpy(normalize(unlab_img)[None]).cuda(),
                     "lab_label": torch.from_numpy(lab[None]).cuda(),
                     "pool_use_new_img": np.array([True]), "pool_idx_img": np.array([0]),
                     "pool_use_new_lab": np.array([True]), "pool_idx_lab": np.array([0])}
            make, steps_per_epoch, derive = CycleGANTrainer, VOC_STEPS_PER_EPOCH, \
                expected_launches
            tols = {d: {k: v[0] for k, v in t.items()} for d, t in TRAIN_TOL.items()}
        else:
            batch = _sup_batch(cfg, n_cls, in_ch)
            make, steps_per_epoch, derive = SupervisedTrainer, SUP_STEPS_PER_EPOCH, \
                supervised_launches
            tols = {d: {"ce_loss": t[0]} for d, t in SUP_TOL.items()}

        def trainer(remat: bool, bf16: bool):
            with resblock_env("fused"):
                t = make(cfg.replace(remat=remat, bf16=bf16), n_cls, in_ch, steps_per_epoch,
                         device="cuda")
            return t, t.init_state(torch.Generator().manual_seed(0))

        def step(remat: bool, bf16: bool) -> dict:
            t, st = trainer(remat, bf16)
            torch.cuda.synchronize()
            torch.cuda.reset_peak_memory_stats()
            base = torch.cuda.memory_allocated()
            _zero_counters()
            st, m = t.train_step(st, batch)
            torch.cuda.synchronize()
            r = {"losses": {k: float(v) for k, v in m.items()}, "grads": _grads(t),
                 "launches": _read_counters(), "derived": derive(t, 1),
                 "peak_mem_gb_above_state": (torch.cuda.max_memory_allocated() - base) / 1e9,
                 "trainer": (t, st)}
            return r

        def loss_err(on: dict, off: dict, dtype: str) -> dict:
            return {k: abs(on["losses"][k] - off["losses"][k])
                    / (atol + rtol * abs(off["losses"][k]))
                    for k, (rtol, atol) in tols[dtype].items()}

        def grad_err(a: dict, b: dict) -> dict:
            return {k: float((a["grads"][k] - b["grads"][k]).norm()
                             / b["grads"][k].norm().clamp_min(1e-30)) for k in b["grads"]}

        # float32: gradients of remat on against off, beside off against off.
        off32, on32 = step(False, False), step(True, False)
        floor = grad_err(step(False, False), off32)
        g32 = grad_err(on32, off32)
        worst = max(g32, key=g32.get)
        err32 = loss_err(on32, off32, "float32")
        del off32, on32
        torch.cuda.empty_cache()
        # bf16: counters, memory and time.
        off, on = step(False, True), step(True, True)
        for r in (off, on):
            if {k: r["launches"].get(k, 0) for k in r["derived"]} != r["derived"]:
                raise AssertionError(f"remat {name}: launch counters {r['launches']} != "
                                     f"derived {r['derived']}")
        # The trunk's second forward: 2 more forward convolutions a whole
        # block, as many as its VJP's input gradients.
        conv = "cg_conv3x3_reflect"
        if on["launches"].get(conv, 0) - off["launches"].get(conv, 0) != \
                off["launches"].get("cg_conv3x3_reflect_dgrad", 0):
            raise AssertionError(f"remat {name}: no recompute in the counters {on['launches']}")
        err16 = loss_err(on, off, "bfloat16")
        times = {False: [], True: []}
        for remat in (False, True, True, False):
            t, st = (on if remat else off)["trainer"]
            for _ in range(TIMED_STEPS):
                torch.cuda.synchronize()
                t0 = time.perf_counter()
                t.train_step(st, batch)
                torch.cuda.synchronize()
                times[remat].append((time.perf_counter() - t0) * 1e3)
        out[name] = {"preset": preset_name, "losses_remat": on["losses"],
                     "losses_no_remat": off["losses"], "loss_err_over_tol": err16,
                     "losses_bitwise_equal": on["losses"] == off["losses"],
                     "float32_loss_err_over_tol": err32,
                     "float32_step1_grad_rel_err_worst": [worst, g32[worst]],
                     "float32_step1_grad_no_remat_twice_worst": max(floor.values()),
                     "launches_remat": on["launches"], "launches_no_remat": off["launches"],
                     "peak_mem_gb_remat": on["peak_mem_gb_above_state"],
                     "peak_mem_gb_no_remat": off["peak_mem_gb_above_state"],
                     "step_ms_remat": times[True], "step_ms_no_remat": times[False],
                     "median_step_ms_remat": statistics.median(times[True]),
                     "median_step_ms_no_remat": statistics.median(times[False])}
        del off, on
        torch.cuda.empty_cache()
        if max(err16.values()) > 1.0 or max(err32.values()) > 1.0 or g32[worst] > GRAD_TOL_F32:
            raise AssertionError(f"remat {name}: {out[name]}")
    emit(out)
    for name in ("cyclegan", "supervised"):
        r = out[name]
        print(f"remat ({r['preset']}, bf16): median {r['median_step_ms_remat']:.2f} ms against "
              f"{r['median_step_ms_no_remat']:.2f} ms without, peak "
              f"{r['peak_mem_gb_remat']:.3f} against {r['peak_mem_gb_no_remat']:.3f} GB "
              f"above the state; {smi}", flush=True)
    return out


CLI_SUP_SIZE, CLI_SUP_PREEMPT_AT = 6, 4   # 3 steps an epoch at batch 2; epoch 1, call 1
CLI_SUP_TTA = ["--eval_resize", "tile", "--resize_height", "192", "--resize_width", "192",
               "--eval_flip", "true", "--eval_scales", "0.75,1.0,1.25"]


def phase_cli_supervised(smi: str) -> dict:
    """``python -m cyclegan_tpu_torch.main --training --model supervised
    --preset voc_supervised_128 --dataset synthetic`` in process: two epochs
    of 3 steps with a checkpoint every step, preempted at step 4 and
    resumed, against an uninterrupted run (per-step ce_loss within the bf16
    train-step bars); --testing equal to the last validation; --testing
    with a 192x192 tiled canvas, flip and three scales (seconds, mIoU).
    Every launch is held to the counts derived from the modules: train
    steps, one eval forward a val batch (six a batch under flip x 3 scales,
    each one batched call over all the canvas's windows)."""
    import torch

    from cyclegan_tpu_torch.main import main as cli
    from cyclegan_tpu_torch.train.supervised import SupervisedTrainer
    from cyclegan_tpu_torch.utils.config import preset

    cfg = preset(SUP_PRESET)
    with resblock_env("fused"):
        counter = SupervisedTrainer(cfg, NUM_CLASSES, 3, 1, device="cuda")
    per_step = {k: v for k, v in supervised_launches(counter, 1).items() if k in CLI_IN_KERNELS}
    per_fwd = net_forward_launches(counter.model, 1)
    val_batches = -(-CLI_VAL // cfg.batch_size)

    def derived(steps: int, forwards: int) -> dict:
        return {k: steps * per_step[k] + forwards * per_fwd[k] for k in CLI_IN_KERNELS}

    base = ["--model", "supervised", "--preset", SUP_PRESET, "--dataset", "synthetic",
            "--log_every", "1"]
    tmp = tempfile.mkdtemp(prefix="chip_smoke_cli_sup_")
    runs: dict = {}

    def dirs(name: str) -> list:
        return ["--checkpoint_dir", os.path.join(tmp, name, "ckpt"),
                "--results_dir", os.path.join(tmp, name, "res")]

    def logged(name: str) -> list:
        with open(os.path.join(tmp, name, "res", "train_metrics.jsonl")) as f:
            return [json.loads(line) for line in f]

    def launch(what: str, argv: list, want: dict, env: dict | None = None,
               deterministic: bool = False):
        saved = {k: os.environ.get(k) for k in (env or {})}
        os.environ.update(env or {})
        mode = deterministic_algorithms() if deterministic else contextlib.nullcontext()
        try:
            with resblock_env("fused"), mode:
                _zero_counters()
                t0 = time.perf_counter()
                res = cli(argv)
                torch.cuda.synchronize()
                wall = time.perf_counter() - t0
                got = {k: _read_counters().get(k, 0) for k in CLI_IN_KERNELS}
        finally:
            for k, v in saved.items():
                os.environ.pop(k, None)
                if v is not None:
                    os.environ[k] = v
        if got != want or not any(got.values()):
            raise AssertionError(f"cli_supervised {what}: launch counters {got} != "
                                 f"derived {want}")
        runs[what] = {"seconds": wall, "launches": got, "derived": want,
                      "deterministic": deterministic,
                      "runner_seconds": (res or {}).get("seconds")}
        return res

    train = ["--training", "--dataset_size", str(CLI_SUP_SIZE), "--epochs", "2"]
    steps = 3
    try:
        # The uninterrupted run in the default mode (timed); then, under
        # deterministic algorithms, the same against one preempted and resumed.
        ref_val = launch("reference", train + base + dirs("ref"),
                         derived(2 * steps, 2 * val_batches))
        launch("deterministic", train + base + dirs("det"), derived(2 * steps, 2 * val_batches),
               deterministic=True)
        first = launch("preempted", train + base + dirs("res") + ["--save_every_steps", "1"],
                       derived(CLI_SUP_PREEMPT_AT, val_batches),
                       env={"CYCLEGAN_TPU_PREEMPT_AT_STEP": str(CLI_SUP_PREEMPT_AT)},
                       deterministic=True)
        if not first.get("preempted"):
            raise AssertionError(f"cli_supervised: not preempted: {first}")
        last_val = launch("resumed", train + base + dirs("res") + ["--save_every_steps", "1"],
                          derived(2 * steps - CLI_SUP_PREEMPT_AT, val_batches),
                          deterministic=True)
        ref_log, det_log, res_log = logged("ref"), logged("det"), logged("res")
        if not [r["step"] for r in ref_log] == [r["step"] for r in det_log] == \
                [r["step"] for r in res_log] == list(range(1, 2 * steps + 1)):
            raise AssertionError(f"cli_supervised: logged steps {ref_log} / {det_log} / "
                                 f"{res_log}")
        tols = SUP_TOL["bfloat16"]

        def over_tol(log: list, against: list) -> list:
            return [abs(r["ce_loss"] - q["ce_loss"]) / (tols[min(i, 2)][1]
                                                        + tols[min(i, 2)][0] * abs(q["ce_loss"]))
                    for i, (r, q) in enumerate(zip(log, against))]

        loss_err = over_tol(res_log, det_log)
        if not all(math.isfinite(r["ce_loss"]) for r in res_log) or max(loss_err) > 1.0:
            raise AssertionError(f"cli_supervised: resumed {res_log} vs {det_log}")
        default_err = over_tol(ref_log, det_log)
        scores = launch("testing", ["--testing"] + base + dirs("res"), derived(0, val_batches))
        score_err = {k: abs(scores[k] - last_val[k]) for k in ("miou", "pixel_acc")}
        pngs = [f for f in os.listdir(os.path.join(tmp, "res", "res")) if f.startswith("pred_")]
        if len(pngs) != CLI_VAL or max(score_err.values()) > SCORE_TOL:
            raise AssertionError(f"cli_supervised --testing: {len(pngs)} PNGs, {scores} vs "
                                 f"the last validation {last_val}")
        tta = launch("testing_tile_flip_scales", ["--testing"] + base + dirs("res")
                     + CLI_SUP_TTA, derived(0, 6 * val_batches))
        if not all(math.isfinite(tta[k]) for k in ("miou", "pixel_acc")):
            raise AssertionError(f"cli_supervised tile/TTA: {tta}")
    finally:
        import shutil

        shutil.rmtree(tmp, ignore_errors=True)
        del counter
        torch.cuda.empty_cache()
    secs = runs["reference"]["runner_seconds"]
    rec = {"phase": "cli_supervised", "preset": SUP_PRESET, "dataset": "synthetic",
           "steps_per_epoch": steps, "val_images": CLI_VAL, "nvidia_smi": smi, "runs": runs,
           "steps_per_sec_logged": {"reference": [r["steps_per_sec"] for r in ref_log],
                                    "resumed": [r["steps_per_sec"] for r in res_log]},
           "prefetch_share_of_train_loop": secs["input_wait"] / secs["train"],
           "validation_pass_s": secs["validation"] / 2,
           "losses_resumed": [r["ce_loss"] for r in res_log],
           "losses_uninterrupted": [r["ce_loss"] for r in det_log], "loss_err_over_tol": loss_err,
           "losses_default_mode": [r["ce_loss"] for r in ref_log],
           "default_mode_err_over_tol": default_err,
           "last_validation": last_val, "testing_scores": {k: scores[k] for k in score_err},
           "testing_err": score_err, "testing_pngs": len(pngs),
           "tile_flip_scales": {"flags": " ".join(CLI_SUP_TTA),
                                "seconds": runs["testing_tile_flip_scales"]["seconds"],
                                "miou": tta["miou"], "pixel_acc": tta["pixel_acc"]}}
    emit(rec)
    print(f"cli_supervised ({SUP_PRESET}, synthetic, 128x128 b2 bf16): "
          f"{statistics.median(rec['steps_per_sec_logged']['reference']):.2f} steps/s logged, "
          f"validation {rec['validation_pass_s']:.3f} s a pass of {CLI_VAL}; --testing mIoU "
          f"{scores['miou']:.5f}; tiled 192x192 + flip + 3 scales "
          f"{rec['tile_flip_scales']['seconds']:.2f} s, mIoU {tta['miou']:.5f}; {smi}",
          flush=True)
    return rec


# --------------------------------------------------------------------------
# serve_full: export from a checkpoint through the CLI, every serving option.
SERVE_CANVAS = 512
SERVE_SCALES = (0.75, 1.0, 1.25)
# The generators' bar (docs/PARITY.md), of the largest |value|: the generate
# head's float32 kernel path against its plain seams.
GEN_TOL = 5e-5
# .pt size over the float32 artifact's: int8 and bf16 weights are 1/4 and
# 1/2 of float32 and nearly every ResNet-9 tensor is one they quantise.
QUANT_SIZE_MAX = {"int8": 0.3, "bf16": 0.55}
CFG1_SERVE = {"unet_128": ("unet_128", "instance"),
              "resnet_6blocks_bn": ("resnet_6blocks", "batch")}
CFG1_CROP = 128


HTTP_BENCH = dict(clients=8, requests=24, max_batch=BATCH, fmt="mask")


def phase_http_bench(served: dict, smi: str) -> dict:
    """tools/torch_http_bench.py on the serve phase's artifact (ResNet-9,
    256x256, bf16): HTTP_BENCH's clients and requests, req/s and latency
    percentiles; its launch counters (the server's warm-up forwards and its
    device calls) as derived: #1 and #3 (forward convolution and norms)."""
    from tools import torch_http_bench

    _zero_counters()
    rec = torch_http_bench.bench(served["artifact"], device="cuda", **HTTP_BENCH)
    got = _read_counters()
    want = net_forward_launches(served["G"], rec["device_calls"] + rec["warmup_calls"])
    _held_counts(got, want, "http_bench")
    n = HTTP_BENCH["clients"] * HTTP_BENCH["requests"]
    if rec["req_per_s"] <= 0 or not rec["mean_batch"] >= 1.0 or \
            rec["device_calls"] > n or rec["device"] != "cuda":
        raise AssertionError(f"http_bench: {rec}")
    out = {"phase": "http_bench", **rec, "launches": got, "derived": want, "nvidia_smi": smi}
    emit(out)
    lat = rec["latency_ms"]
    print(f"http_bench ({TRAIN_PRESET}'s G_i2l, {CROP}x{CROP} bf16, {HTTP_BENCH['clients']} "
          f"clients x {HTTP_BENCH['requests']} requests, max_batch {BATCH}): "
          f"{rec['req_per_s']:.2f} req/s, p50 {lat['p50']:.1f} / p90 {lat['p90']:.1f} / p99 "
          f"{lat['p99']:.1f} ms, mean batch {rec['mean_batch']:.2f}; {smi}", flush=True)
    return out


def serve_windows(canvas: int, window: int, scales) -> list:
    """Windows a tiled canvas gives an image at each scale: the arithmetic
    of tta.snapped_dims and eval_tile.tiled_logits (50% overlap, the last
    window pinned to the edge)."""
    from cyclegan_tpu_torch.eval_tile import window_positions
    from cyclegan_tpu_torch.tta import snapped_dims

    out = []
    for s in scales:
        hs, ws = snapped_dims(canvas, canvas, s)
        out.append(len(window_positions(hs, window, window // 2))
                   * len(window_positions(ws, window, window // 2)))
    return out


def _held_counts(counters: dict, want: dict, what: str) -> None:
    got = {k: v for k, v in counters.items() if v}
    if got != {k: v for k, v in want.items() if v}:
        raise AssertionError(f"{what}: launches {got} != derived {want}")


def serve_kernel_records(n: int, forwards: int, randn, fail_if) -> dict:
    """Kernels #1 and #3 (and the forward convolution alone) at the serving
    path's shapes for a stack of ``n`` windows (bf16): each against its plain
    version, timed beside it, one library call and the bound; per call, and
    ``calls_per_forward`` of each in one generator forward."""
    import torch
    import torch.nn.functional as F

    from cyclegan_tpu_torch.kernels import instance_norm as IN
    from cyclegan_tpu_torch.kernels import resblock as RB

    recs = {"instance_norm_act": [], "residual_block_fused": [], "conv3x3_reflect": []}
    for shape, per in (((n, CROP, CROP, NGF), 2), ((n, CROP // 2, CROP // 2, NGF * 2), 2),
                       ((n, CROP // 4, CROP // 4, NGF * 4), 1)):
        x = randn(shape, torch.bfloat16, 2.0, 0.5)
        res = compare("instance_norm_act", IN.instance_norm_act(x, None, 1e-5, "relu"),
                      IN.instance_norm_act_plain(x, None, 1e-5, "relu"), "bfloat16")
        b_ms, b_by = bound(2 * x.numel() * 2, 8.0 * x.numel(), "float32")
        rec = {"phase": "serve_full", "kernel": "instance_norm_act", "shape": list(shape),
               "dtype": "bfloat16", "act": "relu", **res,
               "ms": time_ms(lambda: IN.instance_norm_act(x, None, 1e-5, "relu"), 5),
               "plain_ms": time_ms(lambda: IN.instance_norm_act_plain(x, None, 1e-5, "relu"), 2),
               "library_ms": time_ms(lambda: torch.relu(F.instance_norm(
                   x.permute(0, 3, 1, 2), eps=1e-5)), 5),
               "bound_ms": b_ms, "bound_by": b_by, "calls_per_forward": per,
               "calls_in_run": per * forwards}
        fail_if(not res["ok"], "instance_norm_act", rec)
        recs["instance_norm_act"].append(rec)
        del x
        torch.cuda.empty_cache()
    c = NGF * 4
    shape = (n, CROP // 4, CROP // 4, c)
    x = randn(shape, torch.bfloat16)
    w1, w2 = randn((3, 3, c, c), torch.bfloat16, 0.02), randn((3, 3, c, c), torch.bfloat16, 0.02)
    b1, b2 = randn((c,), torch.bfloat16, 0.01), randn((c,), torch.bfloat16, 0.01)
    W1, W2 = [w.permute(3, 2, 0, 1).contiguous(memory_format=torch.channels_last)
              for w in (w1, w2)]

    def lib_rb():
        xn = x.permute(0, 3, 1, 2)
        h = F.conv2d(F.pad(xn, (1, 1, 1, 1), mode="reflect"), W1, b1)
        h = torch.relu(F.instance_norm(h, eps=1e-5))
        h = F.conv2d(F.pad(h, (1, 1, 1, 1), mode="reflect"), W2, b2)
        return xn + F.instance_norm(h, eps=1e-5)

    m = n * shape[1] * shape[2]
    conv = 2.0 * m * 9 * c * c
    res = compare("residual_block_fused", RB.residual_block_fused(x, w1, b1, w2, b2),
                  RB.residual_block_plain(x, w1, b1, w2, b2), "bfloat16")
    b_ms, b_by = bound((2 * x.numel() + 2 * w1.numel() + 2 * c) * 2, 2 * conv, "bfloat16")
    rec = {"phase": "serve_full", "kernel": "residual_block_fused", "shape": list(shape),
           "dtype": "bfloat16", **res,
           "ms": time_ms(lambda: RB.residual_block_fused(x, w1, b1, w2, b2), 5),
           "plain_ms": time_ms(lambda: RB.residual_block_plain(x, w1, b1, w2, b2), 2),
           "library_ms": time_ms(lib_rb, 5), "bound_ms": b_ms, "bound_by": b_by,
           "gflop": 2 * conv / 1e9, "calls_per_forward": N_BLOCKS,
           "calls_in_run": N_BLOCKS * forwards}
    fail_if(not res["ok"], "residual_block_fused", rec)
    recs["residual_block_fused"].append(rec)
    ref = RB._conv3x3_plain(x, w1, b1)
    out = torch.empty(ref.shape, device="cuda")
    RB.conv3x3_reflect(x, w1, b1, out)
    torch.cuda.synchronize()
    res = compare("conv3x3_reflect", out, ref, "bfloat16")
    xpl = F.pad(x.permute(0, 3, 1, 2), (1, 1, 1, 1), mode="reflect").contiguous(
        memory_format=torch.channels_last)
    b_ms, b_by = bound(x.numel() * 2 + w1.numel() * 2 + c * 2 + m * c * 4, conv, "bfloat16")
    plan = RB.conv_plan(*shape, c)
    rec = {"phase": "serve_full", "kernel": "conv3x3_reflect", "shape": list(shape),
           "cout": c, "dtype": "bfloat16", **res, "plan": list(plan),
           "blocks": RB.conv_blocks(plan, *shape[:3], c),
           "ms": time_ms(lambda: RB.conv3x3_reflect(x, w1, b1, out), 5),
           "plain_ms": time_ms(lambda: RB._conv3x3_plain(x, w1, b1), 2),
           "library_ms": time_ms(lambda: F.conv2d(xpl, W1, b1), 5),
           "bound_ms": b_ms, "bound_by": b_by, "gflop": conv / 1e9,
           "calls_per_forward": 2 * N_BLOCKS, "calls_in_run": 2 * N_BLOCKS * forwards}
    fail_if(not res["ok"], "conv3x3_reflect", rec)
    recs["conv3x3_reflect"].append(rec)
    del x, w1, w2, b1, b2, W1, W2, ref, out, xpl
    torch.cuda.empty_cache()
    return recs


def _pngs(out_dir: str, names: list):
    import numpy as np
    from PIL import Image

    return {n: np.asarray(Image.open(os.path.join(out_dir, os.path.splitext(n)[0]
                                                  + "_pred.png"))) for n in names}


def phase_serve_full(tmp: str, smi: str) -> dict:
    """Serving at full width (voc_semisup_256: ResNet-9, ngf 64, 21 classes,
    256x256 window, bf16) from a checkpoint the port writes: every head and
    quantisation exported through the CLI's --export, then run_serve on a
    512x512 canvas with flip and scales 0.75 / 1.0 / 1.25 (window stacks of
    N = 32, 72 and 128), the quantised artifacts on the same canvas, the
    generate head, HTTP with the same options, --serve_dp, config 1's
    unet_128 and --norm batch artifacts, and the quantisation tool."""
    import numpy as np
    import torch
    from PIL import Image

    from cyclegan_tpu_torch import export, serve
    from cyclegan_tpu_torch.http_serve import make_server
    from cyclegan_tpu_torch.main import main as cli
    from cyclegan_tpu_torch.models.generators import define_Gen
    from cyclegan_tpu_torch.train.checkpoint import CheckpointManager, state_payload
    from cyclegan_tpu_torch.train.cyclegan import CycleGANTrainer
    from cyclegan_tpu_torch.utils.config import preset

    g = torch.Generator(device="cuda").manual_seed(10)

    def randn(shape, dtype=torch.float32, scale=1.0, shift=0.0):
        return (torch.randn(shape, device="cuda", generator=g) * scale + shift).to(dtype)

    def fail_if(bad: bool, what: str, rec: dict):
        emit(rec)
        if bad:
            raise AssertionError(f"serve_full: {what} disagrees with its plain version")

    root = os.path.join(tmp, "serve_full")
    ck = os.path.join(root, "ck")
    os.makedirs(root)
    t0 = time.perf_counter()
    cfg = preset(TRAIN_PRESET).replace(checkpoint_dir=ck)
    trainer = CycleGANTrainer(cfg, NUM_CLASSES, 3, steps_per_epoch=VOC_STEPS_PER_EPOCH,
                              device="cuda")
    state = trainer.init_state(torch.Generator().manual_seed(0))
    state.step = VOC_STEPS_PER_EPOCH
    CheckpointManager(ck).save(0, state_payload(trainer, state))
    del trainer, state
    torch.cuda.empty_cache()

    # --export through the CLI, every head and quantisation.
    base = ["--preset", TRAIN_PRESET, "--checkpoint_dir", ck]
    arts = {}
    for name, extra in (("logits", ["--export_what", "logits"]), ("segment", []),
                        ("segment_u8", ["--export_input", "uint8"]),
                        ("generate", ["--export_what", "generate"]),
                        ("generate_f32", ["--export_what", "generate", "--no_bf16"]),
                        ("logits_int8", ["--export_what", "logits", "--export_quantize", "int8"]),
                        ("logits_bf16", ["--export_what", "logits", "--export_quantize", "bf16"])):
        cli(["--export", os.path.join(root, name), *base, *extra])
        arts[name] = os.path.join(root, name + ".pt")
    export_s = time.perf_counter() - t0
    f32_bytes = os.path.getsize(arts["logits"])

    def weight_bytes(art) -> tuple:
        G = export.build_module(art, torch.device("cuda"))
        sd = G.state_dict()
        return G, sd, sum(t.numel() * t.element_size() for t in sd.values())

    quant = {"float32": {"bytes": f32_bytes,
                         "weight_bytes_on_card": weight_bytes(export.load_artifact(
                             arts["logits"])[0])[2]}}
    for mode in ("int8", "bf16"):
        art, manifest = export.load_artifact(arts[f"logits_{mode}"])
        host = export.dequantize_state(art["state_dict"], art["scales"])
        _, sd, wb = weight_bytes(art)
        dtype = export.DTYPES[art["config"]["dtype"]]
        bitwise = all(torch.equal(sd[k].cpu(), v.to(dtype)) for k, v in host.items())
        stored = sum(t.numel() * t.element_size() for t in art["state_dict"].values())
        ratio = os.path.getsize(arts[f"logits_{mode}"]) / f32_bytes
        quant[mode] = {"bytes": os.path.getsize(arts[f"logits_{mode}"]), "size_ratio": ratio,
                       "stored_weight_bytes": stored, "weight_bytes_on_card": wb,
                       "manifest_quantize": manifest.get("quantize"),
                       "quantised_tensors": sum(t.dtype != torch.float32
                                                for t in art["state_dict"].values()),
                       "loaded_bitwise_equal_host_dequant": bitwise}
        if not bitwise or ratio > QUANT_SIZE_MAX[mode] or \
                manifest.get("quantize") != f"{mode}_weight_only":
            raise AssertionError(f"serve_full: {mode} artifact {quant[mode]}")
    with open(os.path.join(root, "generate.json")) as f:
        gen_manifest = json.load(f)
    if gen_manifest["trained_steps"] != VOC_STEPS_PER_EPOCH or gen_manifest["head"] != "generate":
        raise AssertionError(f"serve_full: generate manifest {gen_manifest}")

    img_dir, gt_dir = _write_inputs(root)
    names = sorted(os.listdir(img_dir))
    canvas = (SERVE_CANVAS, SERVE_CANVAS)
    opts = dict(canvas_hw=canvas, flip=True, scales=SERVE_SCALES)
    wins = serve_windows(SERVE_CANVAS, CROP, SERVE_SCALES)
    batches = math.ceil(N_IMAGES / BATCH)
    forwards = batches * 2 * len(SERVE_SCALES)   # flip doubles the calls
    G_i2l = define_Gen(3, NUM_CLASSES, NGF, "resnet_9blocks", head="none")
    want = net_forward_launches(G_i2l, forwards)

    # The main path: counts set to 0 just before, read just after.
    out_dir = os.path.join(root, "preds")
    _zero_counters()
    summary = serve.run_serve(arts["logits"], img_dir, out_dir, batch_size=BATCH,
                              gt_dir=gt_dir, device="cuda", **opts)
    launches = _read_counters()
    _held_counts(launches, want, "serve_full run_serve")
    preds = _pngs(out_dir, names)
    for n, p in preds.items():
        if p.shape != canvas or p.max() >= NUM_CLASSES:
            raise AssertionError(f"serve_full {n}: shape {p.shape}, max class {p.max()}")
    with open(os.path.join(out_dir, "scores.json")) as f:
        scores = json.load(f)
    if scores["scored"] != N_IMAGES or not 0.0 <= scores["miou"] <= 1.0:
        raise AssertionError(f"serve_full scores.json: {scores}")

    # The end-to-end rate (run_serve's clock: decode, tiled + TTA predict,
    # colorize, PNG write, GT scoring), warm: the run above paid the first
    # batch's set-up, which its 2 batches cannot amortise.
    rate_img, rate_gt = _write_inputs(os.path.join(root, "rate"), SERVE_RATE_IMAGES)
    rates = []
    for i in range(SERVE_RATE_REPEATS):
        r = serve.run_serve(arts["logits"], rate_img, os.path.join(root, f"preds_rate{i}"),
                            batch_size=BATCH, gt_dir=rate_gt, device="cuda", **opts)
        if r["scored"] != SERVE_RATE_IMAGES:
            raise AssertionError(f"serve_full rate run {i}: {r}")
        rates.append(r)

    # Kernel path against the plain seams on one batch of the same TTA
    # (window stacks of N = 32, 72 and 128), and its device time.
    fn, _, _ = export.load_head(arts["logits"], "cuda")
    logits_fn = serve.served_logits(fn, (CROP, CROP), **opts)
    first = names[:BATCH]
    x = torch.from_numpy(np.stack([serve.load_image(os.path.join(img_dir, n), canvas, 3,
                                                    "resize") for n in first])).cuda()
    with torch.inference_mode():
        lk = logits_fn(x)
        with plain_forward_seams():
            lp = logits_fn(x)
        batch_ms = time_ms(lambda: logits_fn(x).argmax(-1), 3)
    decisive = _decisive(lp, "bfloat16")
    agree = lk.argmax(-1) == lp.argmax(-1)
    paths = {"all": float(agree.float().mean()),
             "decisive": float(agree[decisive].float().mean()),
             "decisive_share": float(decisive.float().mean()),
             "max_abs_logit_diff": float((lk - lp).abs().max()),
             "max_abs_logit": float(lp.abs().max())}
    served_equal = float(np.mean(np.stack([preds[n] for n in first])
                                 == lk.argmax(-1).cpu().numpy()))
    keep = dict(zip(first, _decisive(lk, "bfloat16").cpu().numpy()))
    del lk, lp, x
    torch.cuda.empty_cache()
    if paths["decisive"] < ARGMAX_AGREEMENT_MIN:
        raise AssertionError(f"serve_full: argmax kernel vs plain {paths}")
    recs = serve_kernel_records(BATCH * max(wins), 2 * batches, randn, fail_if)

    # The quantised artifacts on the same canvas.
    q_serve = {}
    for mode in ("int8", "bf16"):
        d = os.path.join(root, f"preds_{mode}")
        res = serve.run_serve(arts[f"logits_{mode}"], img_dir, d, batch_size=BATCH,
                              gt_dir=gt_dir, device="cuda", **opts)
        qp = _pngs(d, names)
        q_serve[mode] = {"miou": res["miou"], "pixel_acc": res["pixel_acc"],
                         "argmax_agreement_with_float32": float(np.mean(
                             [np.mean(qp[n] == preds[n]) for n in names])),
                         "argmax_agreement_with_float32_off_ties": float(np.mean(
                             [np.mean(qp[n][keep[n]] == preds[n][keep[n]]) for n in first])),
                         "img_per_s": res["img_per_s"]}

    # The uint8-input segment artifact: the float32 one's PNGs, bitwise.
    for name in ("segment", "segment_u8"):
        serve.run_serve(arts[name], img_dir, os.path.join(root, f"preds_{name}"),
                        batch_size=BATCH, device="cuda")
    u8_equal = all(
        open(os.path.join(root, "preds_segment", f"{os.path.splitext(n)[0]}_pred.png"),
             "rb").read() == open(os.path.join(root, "preds_segment_u8",
                                               f"{os.path.splitext(n)[0]}_pred.png"),
                                  "rb").read() for n in names)
    if not u8_equal:
        raise AssertionError("serve_full: the uint8-input artifact's PNGs differ")

    # The generate head: label maps -> images; float32 kernel vs plain.
    labels = torch.from_numpy(np.stack([np.asarray(Image.open(os.path.join(gt_dir, n)))
                                        for n in first]).astype(np.int32)).cuda()
    G_l2i = define_Gen(NUM_CLASSES, 3, NGF, "resnet_9blocks", head="tanh")
    gen = {}
    for name in ("generate", "generate_f32"):
        gfn, gcfg, _ = export.load_head(arts[name], "cuda")
        _zero_counters()
        img = gfn(labels).float()
        torch.cuda.synchronize()
        counts = _read_counters()
        _held_counts(counts, net_forward_launches(G_l2i, 1), f"serve_full {name}")
        ok = tuple(img.shape) == (BATCH, CROP, CROP, 3) and bool(torch.isfinite(img).all()) \
            and float(img.abs().max()) <= 1.0
        gen[name] = {"dtype": gcfg["dtype"], "shape": list(img.shape), "ok": ok,
                     "max_abs": float(img.abs().max()), "launches": counts}
        if name == "generate_f32":
            with plain_forward_seams():
                ref = gfn(labels).float()
            err = float((img - ref).abs().max())
            gen[name].update(max_abs_err=err, bar=GEN_TOL * float(ref.abs().max()))
            ok = ok and err <= GEN_TOL * float(ref.abs().max())
            gen[name]["ok"] = ok
            gen[name]["ms"] = time_ms(lambda: gfn(labels), 3)
        if not ok:
            raise AssertionError(f"serve_full: generate head {gen[name]}")
        del img
    torch.cuda.empty_cache()

    # HTTP with the same options: /info, 8 concurrent POST /predict.
    server = make_server(arts["logits"], port=0, device="cuda", max_batch=BATCH, **opts)
    thread = threading.Thread(target=server.serve_forever, daemon=True)
    thread.start()
    base_url = f"http://127.0.0.1:{server.server_address[1]}"
    try:
        with urllib.request.urlopen(base_url + "/info", timeout=60) as r:
            info = json.load(r)

        def post(name: str):
            with open(os.path.join(img_dir, name), "rb") as f:
                req = urllib.request.Request(f"{base_url}/predict?format=mask", data=f.read())
            t = time.perf_counter()
            with urllib.request.urlopen(req, timeout=300) as r:
                return name, r.status, r.read(), time.perf_counter() - t

        with ThreadPoolExecutor(max_workers=8) as ex:
            answers = list(ex.map(post, first))
    finally:
        server.shutdown()
        server.server_close()
        thread.join(timeout=30)
    want_tta = {"flip": True, "scales": list(SERVE_SCALES), "canvas_hw": list(canvas),
                "data_parallel": False, "max_batch": BATCH}
    http_agree = []
    for name, status, data, _ in answers:
        got = np.asarray(Image.open(io.BytesIO(data)))
        if status != 200 or got.shape != canvas:
            raise AssertionError(f"serve_full HTTP {name}: {status} {got.shape}")
        http_agree.append(float(np.mean(got[keep[name]] == preds[name][keep[name]])))
    if info.get("tta") != want_tta or min(http_agree) < HTTP_AGREEMENT_MIN:
        raise AssertionError(f"serve_full HTTP: /info tta {info.get('tta')}, agreement off "
                             f"ties {http_agree}")
    lat = sorted(a[3] for a in answers)

    # --serve_dp through the CLI: on one card the single-device path, bitwise.
    dp_dir = os.path.join(root, "preds_dp")
    cli(["--serve", arts["logits"], "--serve_input", img_dir, "--serve_output", dp_dir,
         "--serve_batch", str(BATCH), "--serve_canvas_height", str(SERVE_CANVAS),
         "--serve_canvas_width", str(SERVE_CANVAS), "--serve_flip", "--serve_scales",
         ",".join(map(str, SERVE_SCALES)), "--serve_dp"])
    dp_equal = all(
        open(os.path.join(dp_dir, f"{os.path.splitext(n)[0]}_pred.png"), "rb").read()
        == open(os.path.join(out_dir, f"{os.path.splitext(n)[0]}_pred.png"), "rb").read()
        for n in names)
    if not dp_equal:
        raise AssertionError("serve_full: --serve_dp differs from the single-device path")

    # Config 1's unet_128 and --norm batch artifacts at 128x128.
    cfg1 = {}
    for name, (gen_net, norm) in CFG1_SERVE.items():
        G = define_Gen(3, NUM_CLASSES, NGF, gen_net, norm=norm, head="none",
                       generator=torch.Generator().manual_seed(1))
        if norm == "batch":  # running averages away from their initial 0 / 1
            r = torch.Generator().manual_seed(2)
            for mod in G.modules():
                if hasattr(mod, "running_mean"):
                    mod.running_mean.normal_(0.0, 0.05, generator=r)
                    mod.running_var.uniform_(0.5, 1.5, generator=r)
        art = export.export_generator(G, os.path.join(root, name), gen_net=gen_net, ngf=NGF,
                                      num_classes=NUM_CLASSES, in_channels=3,
                                      crop_hw=(CFG1_CROP, CFG1_CROP), dtype="bfloat16",
                                      head="logits", norm=norm)
        d = os.path.join(root, f"preds_{name}")
        _zero_counters()
        serve.run_serve(art, img_dir, d, batch_size=BATCH, device="cuda")
        counts = _read_counters()
        _held_counts(counts, net_forward_launches(G, batches), f"serve_full {name}")
        fn1, _, _ = export.load_head(art, "cuda")
        x1 = torch.from_numpy(np.stack([serve.load_image(
            os.path.join(img_dir, n), (CFG1_CROP, CFG1_CROP), 3, "resize") for n in first])).cuda()
        with torch.inference_mode():
            k1 = fn1(x1).float()
            with plain_forward_seams():
                p1 = fn1(x1).float()
        dec = _decisive(p1, "bfloat16")
        agree1 = (k1.argmax(-1) == p1.argmax(-1))[dec].float().mean()
        served1 = _pngs(d, first)
        cfg1[name] = {"launches": counts, "argmax_kernel_vs_plain_decisive": float(agree1),
                      "decisive_share": float(dec.float().mean()),
                      "finite": bool(torch.isfinite(k1).all()),
                      "served_equal_kernel_argmax": float(np.mean(
                          np.stack([served1[n] for n in first])
                          == k1.argmax(-1).cpu().numpy()))}
        if agree1 < ARGMAX_AGREEMENT_MIN or not cfg1[name]["finite"]:
            raise AssertionError(f"serve_full {name}: {cfg1[name]}")

    # The quantisation tool at its defaults, in its own process.
    t = time.perf_counter()
    proc = subprocess.run([sys.executable, os.path.join(HERE, "tools",
                                                        "torch_quantize_miou_run.py")],
                          capture_output=True, text=True, timeout=600, check=True)
    tool = json.loads(proc.stdout.strip().splitlines()[-1])
    tool_s = time.perf_counter() - t
    print(json.dumps(tool), flush=True)
    for k in ("miou_f32", "miou_int8", "miou_bf16", "bytes_int8", "bytes_bf16"):
        if k not in tool:
            raise AssertionError(f"torch_quantize_miou_run: no {k} in {tool}")

    rec = {"phase": "serve_full", "preset": TRAIN_PRESET, "canvas": list(canvas),
           "scales": list(SERVE_SCALES), "flip": True, "batch": BATCH, "images": N_IMAGES,
           "windows_per_image_by_scale": wins,
           "window_stacks": [BATCH * w for w in wins], "forwards": forwards,
           "launches": launches, "derived_launches": want,
           "run_serve_img_per_s": [r["img_per_s"] for r in rates],
           "run_serve_s_per_image": [r["elapsed_s"] / SERVE_RATE_IMAGES for r in rates],
           "run_serve_rate_images": SERVE_RATE_IMAGES,
           "run_serve_first_call": {"images": N_IMAGES, "elapsed_s": summary["elapsed_s"],
                                    "img_per_s": summary["img_per_s"]},
           "device_ms_per_batch_of_8": batch_ms,
           "device_img_per_s": BATCH / batch_ms * 1e3, "miou": scores["miou"],
           "argmax_kernel_vs_plain": paths, "agreement_with_served_pngs": served_equal,
           "export_s": export_s, "quantised": quant, "quantised_serving": q_serve,
           "uint8_input_pngs_bitwise_equal": u8_equal, "generate": gen,
           "http": {"tta": info["tta"], "p50_latency_s": statistics.median(lat),
                    "max_latency_s": lat[-1], "min_agreement_off_ties": min(http_agree)},
           "serve_dp_bitwise_equal": dp_equal, "config1": cfg1,
           "quantize_tool": tool, "quantize_tool_s": tool_s,
           "seconds": time.perf_counter() - t0, "nvidia_smi": smi}
    emit(rec)
    return {"records": recs, "launches": launches, "record": rec}


# The data-parallel phase (parallel/): (a) NCCL at world 1 through the
# runner, bitwise the run without a group; (b) two gloo ranks sharing the
# card at full width, 1 row a rank, against one process at the global
# batch 2; (c) the shape of BASELINE config 5 (voc_dp8_bf16: 8 devices, a
# global batch of 64 = 8 a device, bf16) cut to 2 ranks on one card.
DP_STEPS = 3          # (a), (b)
DP_TIMED_STEPS = 5    # (c), after one warm-up step
DP_PROBE_STEPS = 2    # (c), all-reduces timed alone
DP5_PRESET = "voc_dp8_bf16"
DP5_RANKS = 2


def _dp_batch(cfg, rows: int, steps: int, seed: int = 0) -> list:
    """Global host batches of ``rows`` synthetic 256x256 samples with a void
    border and injected pool decisions ((rows,) vectors of the global
    batch): the same in every process that makes them."""
    import numpy as np

    from cyclegan_tpu_torch.data.datasets import DATASET_SPECS, _synthetic_sample
    from cyclegan_tpu_torch.data.transforms import normalize

    n_cls, in_ch, _ = DATASET_SPECS[cfg.dataset]
    imgs, labs = [], []
    for i in range(2 * rows):
        img, lab = _synthetic_sample(i, cfg.crop_hw, n_cls, in_ch)
        imgs.append(normalize(img))
        labs.append(lab.astype(np.int64))
    lab = np.stack(labs[:rows])
    lab[:, :2], lab[:, :, :2] = 255, 255
    rng = np.random.default_rng(seed)
    out = []
    for _ in range(steps):
        use_new = rng.random((2, rows)) > 0.5
        swap = rng.integers(0, cfg.pool_size, (2, rows))
        out.append({"lab_image": np.stack(imgs[:rows]), "unlab_image": np.stack(imgs[rows:]),
                    "lab_label": lab, "pool_use_new_img": use_new[0],
                    "pool_idx_img": swap[0], "pool_use_new_lab": use_new[1],
                    "pool_idx_lab": swap[1]})
    return out


def _dp_trainer(cfg, mesh):
    import torch

    from cyclegan_tpu_torch.data.datasets import DATASET_SPECS
    from cyclegan_tpu_torch.parallel.mesh import replicate_state
    from cyclegan_tpu_torch.train.cyclegan import CycleGANTrainer

    n_cls, in_ch, _ = DATASET_SPECS[cfg.dataset]
    with resblock_env("fused"):
        t = CycleGANTrainer(cfg, n_cls, in_ch, VOC_STEPS_PER_EPOCH, mesh=mesh)
    return t, replicate_state(t, t.init_state(torch.Generator().manual_seed(0)), mesh)


def _dp_rank(out_dir: str) -> dict:
    """One rank of (b) and (c): its record in ``out_dir/rank<r>.json``."""
    import torch
    import torch.distributed as dist

    from cyclegan_tpu_torch.parallel import mesh as M
    from cyclegan_tpu_torch.utils.config import preset

    mesh = M.make_mesh(device="cuda:0")
    rec = {"rank": mesh.rank, "world": mesh.world, "backend": dist.get_backend()}
    # (b) voc_semisup_256 at a global batch of 2, this rank's row.
    cfg = preset(TRAIN_PRESET).replace(batch_size=2)
    t, st = _dp_trainer(cfg, mesh)
    want = expected_launches(t, DP_STEPS)
    batches = _dp_batch(cfg, 2, DP_STEPS)
    _zero_counters()
    losses = []
    for b in batches:
        st, m = t.train_step(st, M.shard_batch(b, mesh))
        losses.append({k: float(v) for k, v in m.items()})
    torch.cuda.synchronize()
    got = _read_counters()
    rec.update(losses=losses, launches=got, expected_launches=want,
               launches_as_derived={k: got.get(k, 0) for k in want} == want)
    del t, st
    torch.cuda.empty_cache()
    # (c) config 5's per-device share: batch 8 a rank, bf16.
    cfg5 = preset(DP5_PRESET).replace(batch_size=8 * mesh.world, num_devices=mesh.world)
    t, st = _dp_trainer(cfg5, mesh)
    batches = _dp_batch(cfg5, cfg5.batch_size, 1 + DP_TIMED_STEPS + DP_PROBE_STEPS, seed=1)
    local = [M.shard_batch(b, mesh) for b in batches]
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    st, _ = t.train_step(st, local[0])  # warm-up
    torch.cuda.synchronize()
    dist.barrier()
    t0 = time.perf_counter()
    for b in local[1:1 + DP_TIMED_STEPS]:
        st, m = t.train_step(st, b)
    torch.cuda.synchronize()
    step_s = (time.perf_counter() - t0) / DP_TIMED_STEPS
    peak = torch.cuda.max_memory_allocated() / 1e9
    # The all-reduces timed alone: every collective of the step synchronised
    # before and after (the probe steps run slower than the timed ones).
    spent, real = [0.0, 0], dist.all_reduce

    def timed_all_reduce(tensor, *a, **k):
        torch.cuda.synchronize()
        ta = time.perf_counter()
        w = real(tensor, *a, **k)
        torch.cuda.synchronize()
        spent[0] += time.perf_counter() - ta
        spent[1] += tensor.numel() * tensor.element_size()
        return w

    M.dist.all_reduce = timed_all_reduce
    try:
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        for b in local[1 + DP_TIMED_STEPS:]:
            st, _ = t.train_step(st, b)
        torch.cuda.synchronize()
        probe_s = (time.perf_counter() - t0) / DP_PROBE_STEPS
    finally:
        M.dist.all_reduce = real
    rec.update(config5={
        "steps_per_s": 1.0 / step_s, "step_ms": step_s * 1e3,
        "global_batch": cfg5.batch_size, "rows_per_rank": cfg5.batch_size // mesh.world,
        "images_per_s": cfg5.batch_size / step_s, "peak_mem_gb": peak,
        "losses_last_timed_step": {k: float(v) for k, v in m.items()},
        "probe_step_ms": probe_s * 1e3,
        "all_reduce_ms_per_step": spent[0] / DP_PROBE_STEPS * 1e3,
        "all_reduce_share_of_probe_step": spent[0] / DP_PROBE_STEPS / probe_s,
        "all_reduce_mb_per_step": spent[1] / DP_PROBE_STEPS / 1e6})
    with open(os.path.join(out_dir, f"rank{mesh.rank}.json"), "w") as f:
        json.dump(rec, f)
    return rec


def phase_dp(smi: str) -> dict:
    """(a) the runner on an NCCL group of one rank against the runner with
    no group: 3 steps of ``voc_semisup_256`` from the synthetic dataset under
    deterministic algorithms, the checkpoints bitwise equal; (b) two gloo
    ranks on the card (NCCL refuses two ranks on one device), a row each,
    3 steps on the kernels against one process at batch 2 within the train
    phase's bf16 bars (TRAIN_TOL), each rank's launch counters equal to the
    counts derived at batch 1; (c) config 5's shape: 2 gloo ranks of 8 rows
    (global batch 16), bf16, 5 timed steps: steps/s, each rank's peak
    memory and the all-reduces' share of a step."""
    import torch
    import torch.distributed as dist

    from cyclegan_tpu_torch.parallel import distributed
    from cyclegan_tpu_torch.parallel import mesh as M
    from cyclegan_tpu_torch.train import checkpoint as ck
    from cyclegan_tpu_torch.train import runner
    from cyclegan_tpu_torch.utils.config import preset

    t_phase = time.perf_counter()
    tmp = tempfile.mkdtemp(prefix="chip_smoke_dp_")
    # (a)
    base = preset(TRAIN_PRESET).replace(dataset="synthetic", dataset_size=CLI_SIZE,
                                        validation_every=0, log_every=1, epochs=2)

    def run_a(name: str) -> dict:
        cfg = base.replace(checkpoint_dir=os.path.join(tmp, name, "ckpt"),
                           results_dir=os.path.join(tmp, name, "res"))
        with resblock_env("fused"), deterministic_algorithms():
            runner.run_cyclegan(cfg, max_steps=DP_STEPS, device="cuda")
        payload, _ = ck.CheckpointManager(cfg.checkpoint_dir).restore()
        return payload

    alone = run_a("alone")
    distributed.maybe_initialize(None, "cuda", rank=0, world=1,
                                 init_method=f"file://{os.path.join(tmp, 'store_a')}")
    try:
        backend = dist.get_backend()
        mesh_a = M.make_mesh(device="cuda")
        grouped = run_a("nccl")
    finally:
        dist.destroy_process_group()
    diffs = []

    def same(a, b, path=""):
        if isinstance(a, dict):
            for k in a:
                same(a[k], b[k], f"{path}/{k}")
        elif isinstance(a, torch.Tensor):
            if not torch.equal(a, b):
                diffs.append(path)
        elif isinstance(a, (list, tuple)):
            for i, (x, y) in enumerate(zip(a, b)):
                same(x, y, f"{path}[{i}]")
        elif a != b:
            diffs.append(path)

    same(alone, grouped)
    if backend != "nccl" or mesh_a.world != 1 or diffs or grouped["step"] != DP_STEPS:
        raise AssertionError(f"dp (a): backend {backend}, world {mesh_a.world}, step "
                             f"{grouped['step']}, differing entries {diffs[:10]}")
    t_a = time.perf_counter()

    # (b) and (c) in two spawned ranks; (b)'s reference in this process.
    world = DP5_RANKS
    ranks = distributed.launch_local(_dp_rank, (tmp,), nprocs=world, world=world,
                                     device="cuda:0", backend="gloo",
                                     init_method=f"file://{os.path.join(tmp, 'store_b')}")
    recs = []
    for r in range(world):
        with open(os.path.join(tmp, f"rank{r}.json")) as f:
            recs.append(json.load(f))
    if ranks["rank"] != 0 or [r["backend"] for r in recs] != ["gloo"] * world:
        raise AssertionError(f"dp: ranks {[(r['rank'], r['backend']) for r in recs]}")
    t_ranks = time.perf_counter()
    cfg = preset(TRAIN_PRESET).replace(batch_size=2)
    t, st = _dp_trainer(cfg, M.Mesh(torch.device("cuda")))
    ref = []
    for b in _dp_batch(cfg, 2, DP_STEPS):
        st, m = t.train_step(st, M.shard_batch(b, t.mesh))
        ref.append({k: float(v) for k, v in m.items()})
    del t, st
    torch.cuda.empty_cache()
    worst = {}
    for key, tols in TRAIN_TOL["bfloat16"].items():
        for r in recs:
            errs = [abs(g[key] - p[key]) / (atol + rtol * abs(p[key]))
                    for g, p, (rtol, atol) in zip(r["losses"], ref, tols)]
            worst.setdefault(key, []).append(max(errs))
            if not all(math.isfinite(g[key]) for g in r["losses"]) or max(errs) > 1.0:
                raise AssertionError(f"dp (b) rank {r['rank']} {key}: {r['losses']} vs one "
                                     f"process at batch 2 {ref}")
        if any(r["losses"] != recs[0]["losses"] for r in recs):
            raise AssertionError(f"dp (b): the ranks report different losses")
    for r in recs:
        if not r["launches_as_derived"]:
            raise AssertionError(f"dp (b) rank {r['rank']}: launch counters {r['launches']} "
                                 f"!= derived at batch 1 {r['expected_launches']}")
    c5 = [r["config5"] for r in recs]
    rec = {"phase": "dp", "nvidia_smi": smi, "seconds": time.perf_counter() - t_phase,
           "a_nccl_world1": {"backend": backend, "steps": DP_STEPS, "bitwise_equal": True,
                             "deterministic_algorithms": True,
                             "seconds": t_a - t_phase},
           "b_gloo_two_ranks": {"preset": TRAIN_PRESET, "global_batch": 2, "rows_per_rank": 1,
                                "losses_rank0": recs[0]["losses"], "losses_one_process": ref,
                                "loss_err_over_tol": worst, "tol": TRAIN_TOL["bfloat16"],
                                "launches_per_rank": [r["launches"] for r in recs],
                                "expected_launches": recs[0]["expected_launches"]},
           "c_config5": {"preset": DP5_PRESET, "ranks": world, "backend": "gloo",
                         "reduced": {"devices": f"8 -> {world} ranks on one card",
                                     "global_batch": f"64 -> {8 * world}"},
                         "per_rank": c5, "steps_per_s": min(c["steps_per_s"] for c in c5),
                         "images_per_s": min(c["images_per_s"] for c in c5)},
           "ranks_seconds": t_ranks - t_a}
    emit(rec)
    print(f"dp (c) {DP5_PRESET} cut to {world} gloo ranks on one card, global batch "
          f"{8 * world}, bf16: {rec['c_config5']['steps_per_s']:.3f} steps/s, peak memory "
          f"{[round(c['peak_mem_gb'], 3) for c in c5]} GB a rank, all-reduce share "
          f"{[round(c['all_reduce_share_of_probe_step'], 3) for c in c5]}; {smi}", flush=True)
    return {"launches": recs[0]["launches"], "record": rec}


# BASELINE configs 3 and 4 at their published widths (ngf 64, ndf 64,
# resnet_9blocks, two 70x70 PatchGANs, bf16 over float32, batch 1, pools of
# 50), each trainer built with its preset's dataset spec: Cityscapes 256x512
# with 19 classes (its 64x128 trunk plane the first non-square one through
# conv_plan, in_plan and chunk_plan) on the default path and on path A, and
# ACDC 256x256 with 1 channel and 4 classes on the default path.
CONFIG_RUNS = (("cityscapes_semisup_512x256", "fused"), ("cityscapes_semisup_512x256", "chunked"),
               ("acdc_semisup", "fused"))
CONFIG_TIMED_STEPS = 3


def _config_trainer(cfg, route: str, mesh):
    import torch

    from cyclegan_tpu_torch.data.datasets import DATASET_SPECS
    from cyclegan_tpu_torch.parallel.mesh import replicate_state
    from cyclegan_tpu_torch.train.cyclegan import CycleGANTrainer

    n_cls, in_ch, _ = DATASET_SPECS[cfg.dataset]
    with resblock_env(route):
        t = CycleGANTrainer(cfg, n_cls, in_ch, VOC_STEPS_PER_EPOCH, mesh=mesh)
    return t, replicate_state(t, t.init_state(torch.Generator().manual_seed(0)), mesh)


def _bf16_agree(name: str, got: list, ref: list) -> dict:
    """Per-step losses within the train phase's bf16 bars; the worst of
    each loss over the steps (err over its bar)."""
    worst = {}
    for key, tols in TRAIN_TOL["bfloat16"].items():
        errs = [abs(g[key] - p[key]) / (atol + rtol * abs(p[key]))
                for g, p, (rtol, atol) in zip(got, ref, tols)]
        worst[key] = max(errs)
        if not all(math.isfinite(g[key]) for g in got) or max(errs) > 1.0:
            raise AssertionError(f"{name} {key}: {got} vs {ref}")
    return worst


def config_plane_checks() -> list:
    """The kernels alone at config 3's non-square planes (batch 1): #1/#2 at
    the stem (256x512x64), down (128x256x128) and trunk (64x128x256)
    planes, #3-#5 (the fused block's VJP on the kernel path's relu mask) and
    #6-#8 at the trunk plane, float32 and bf16, each against its plain
    version at the kernels_train bars: the check of conv_plan, in_plan and
    chunk_plan on a plane whose H differs from its W (at float32 the
    chunked norms' second pass reads its inputs from memory: 64x128x32
    float32 pairs do not fit the shared-memory tile)."""
    import torch

    # float32 references without TF32, as phase_kernels sets them.
    torch.backends.cudnn.allow_tf32 = False
    torch.backends.cuda.matmul.allow_tf32 = False
    g = torch.Generator(device="cuda").manual_seed(3)

    def randn(shape, dtype=torch.float32, scale=1.0, shift=0.0):
        return (torch.randn(shape, device="cuda", generator=g) * scale + shift).to(dtype)

    out = []

    def fail_if(bad: bool, what: str, rec: dict):
        out.append({k: rec.get(k) for k in ("kernel", "shape", "dtype", "act",
                                            "worst_err_over_tol", "max_abs_err")})
        if bad:
            raise AssertionError(f"configs: {what} disagrees with its plain version at a "
                                 f"non-square plane: {rec}")

    trunk = (1, 64, 128, 256)
    for shape, act in (((1, 256, 512, 64), "relu"), ((1, 128, 256, 128), "relu"),
                       (trunk, "none")):
        in_case(shape, act, 0, randn, fail_if, phase="configs")
    for dtype in (torch.float32, torch.bfloat16):
        rb_case(dtype, trunk, 0, randn, fail_if, phase="configs")
    kernels_train_chunked_dw(randn, fail_if, phase="configs",
                             cases=((torch.float32, trunk, 0, 0), (torch.bfloat16, trunk, 0, 0)))
    torch.cuda.empty_cache()
    return out


def phase_configs(smi: str) -> dict:
    """Configs 3 and 4 (CONFIG_RUNS) on the card, unsharded: the kernels at
    config 3's non-square planes (config_plane_checks); for each run 3
    float32 steps on the kernels against 3 on the plain seams at the train
    phase's float32 bars (rounding cannot hide a wrong gradient there), then
    3 bf16 steps on the kernels against 3 on the plain seams from the same
    weights, batch and pool decisions, at its bf16 bars; the launch
    counters against the counts derived for these shapes (path A: 27
    chunked blocks a step, no fused one); then CONFIG_TIMED_STEPS timed
    steps, their median and the peak memory. Returns each run's losses and
    counters."""
    import torch

    from cyclegan_tpu_torch.data.datasets import DATASET_SPECS
    from cyclegan_tpu_torch.parallel import mesh as M
    from cyclegan_tpu_torch.utils.config import preset

    t_phase = time.perf_counter()
    planes = config_plane_checks()
    mesh = M.Mesh(torch.device("cuda"))
    out, recs = {}, []
    for name, route in CONFIG_RUNS:
        cfg = preset(name)
        f32 = cfg.replace(bf16=False)
        losses32 = {}
        for tag, seams in (("kernel", contextlib.nullcontext), ("plain", plain_seams)):
            t, st = _config_trainer(f32, route, mesh)
            losses32[tag] = []
            with seams():
                for b in _dp_batch(f32, 1, TRAIN_STEPS):
                    st, m = t.train_step(st, M.shard_batch(b, mesh))
                    losses32[tag].append({k: float(v) for k, v in m.items()})
            del t, st
            torch.cuda.empty_cache()
        worst32 = {}
        for key, tols in TRAIN_TOL["float32"].items():
            errs = [abs(k_[key] - p_[key]) / (atol + rtol * abs(p_[key]))
                    for k_, p_, (rtol, atol) in zip(losses32["kernel"], losses32["plain"], tols)]
            worst32[key] = max(errs)
            if max(errs) > 1.0 or not all(math.isfinite(k_[key]) for k_ in losses32["kernel"]):
                raise AssertionError(f"configs {name} {route} float32 {key}: {losses32}")
        batches = [M.shard_batch(b, mesh) for b in
                   _dp_batch(cfg, cfg.batch_size, TRAIN_STEPS + CONFIG_TIMED_STEPS)]
        t, st = _config_trainer(cfg, route, mesh)
        want = expected_launches(t, TRAIN_STEPS)
        for k, per_step in PATH_COUNTS.get("chunked" if route == "chunked" else "", {}).items():
            want[k] = per_step * TRAIN_STEPS
        _zero_counters()
        k_losses = []
        for b in batches[:TRAIN_STEPS]:
            st, m = t.train_step(st, b)
            k_losses.append({k: float(v) for k, v in m.items()})
        torch.cuda.synchronize()
        launches = _read_counters()
        if {k: launches.get(k, 0) for k in want} != want:
            raise AssertionError(f"configs {name} {route}: launch counters {launches} != "
                                 f"derived {want}")
        torch.cuda.reset_peak_memory_stats()
        ms = []
        for b in batches[TRAIN_STEPS:]:
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            st, _ = t.train_step(st, b)
            torch.cuda.synchronize()
            ms.append((time.perf_counter() - t0) * 1e3)
        peak = torch.cuda.max_memory_allocated() / 1e9
        del t, st
        torch.cuda.empty_cache()
        pt, ps = _config_trainer(cfg, route, mesh)
        p_losses = []
        with plain_seams():
            for b in batches[:TRAIN_STEPS]:
                ps, m = pt.train_step(ps, b)
                p_losses.append({k: float(v) for k, v in m.items()})
        del pt, ps
        torch.cuda.empty_cache()
        worst = _bf16_agree(f"configs {name} {route}", k_losses, p_losses)
        rec = {"preset": name, "route": route, "crop": list(cfg.crop_hw),
               "classes_channels": list(DATASET_SPECS[cfg.dataset][:2]),
               "losses_kernel_path": k_losses, "losses_plain_path": p_losses,
               "loss_err_over_tol": worst, "float32_losses": losses32,
               "float32_loss_err_over_tol": worst32, "launches_over_3_steps": launches,
               "expected_launches": want, "step_ms_kernel": ms,
               "median_step_ms_kernel": statistics.median(ms), "peak_mem_gb": peak}
        recs.append(rec)
        out[(name, route)] = {"losses": k_losses, "launches": launches, "peak_mem_gb": peak,
                              "median_step_ms": statistics.median(ms)}
    emit({"phase": "configs", "nvidia_smi": smi, "runs": recs, "tol": TRAIN_TOL,
          "plane_checks": planes, "seconds": time.perf_counter() - t_phase})
    for r in recs:
        print(f"configs {r['preset']} ({r['route']}), {r['crop'][0]}x{r['crop'][1]} b1 bf16: "
              f"median {r['median_step_ms_kernel']:.2f} ms, peak {r['peak_mem_gb']:.3f} GB; "
              f"{smi}", flush=True)
    return out


# The spatial axis (parallel/spatial.py): config 3 at spatial_shards 2 as two
# gloo ranks sharing the card (NCCL refuses two ranks on one device), a
# 128x512 slab a rank of the global batch of 1.
SPATIAL_PRESET = "cityscapes_semisup_512x256"
SPATIAL_RANKS = 2
SPATIAL_TIMED_STEPS = 3
SLAB_COUNTERS = ("cg_instance_norm_partials", "cg_instance_norm_slab_apply",
                 "cg_instance_norm_bwd_partials", "cg_instance_norm_bwd_slab_apply")
WHOLE_PLANE_COUNTERS = ("cg_instance_norm_act", "cg_instance_norm_act_bwd",
                        "cg_conv3x3_reflect", "cg_conv3x3_reflect_dgrad",
                        "cg_chunked_in_fwd", "cg_chunked_in_vjp")


# spatial_unet: config 3's crops with U-Net generators; spatial_eval: the
# spatial phase's runner checkpoint tested tiled on a 512x1024 canvas with
# 256x512 windows, flipped and at three scales.
UNET_GEN = "unet_256"
UNET_TIMED_STEPS = 2
SPATIAL_EVAL = dict(eval_resize="tile", resize_height=512, resize_width=1024, eval_flip=True,
                    eval_scales="0.75,1.0,1.25")


def spatial_launches(trainer, steps: int) -> dict:
    """Launch counts of ``steps`` train steps on H slabs: every instance
    norm (the trunk blocks' too: they run unfused) through the slab entries,
    forward and VJP, one launch of each entry a call; conv_dw for every
    trunk convolution; no whole-plane norm or residual-block kernel."""
    g, d = net_counts(trainer.G_i2l), net_counts(trainer.D_img)
    if g["fused"] or g["chunked"]:
        raise AssertionError(f"spatial: whole trunk blocks {g}")
    norms, dw = (3 * g["norms"] + 4 * d["norms"]) * steps, 3 * g["dw"] * steps
    out = {k: norms for k in SLAB_COUNTERS}
    out.update({k: 0 for k in WHOLE_PLANE_COUNTERS})
    out.update(cg_conv_dw=dw)
    return out


def _spatial_rank(out_dir: str) -> dict:
    """One rank of the spatial phase: (a) config 3 at spatial 2, 3 steps
    counted, 3 timed, 1 with its collectives timed alone; (b) the runner at
    --num_devices 2 --spatial_shards 2, 3 steps and --testing. Its record in
    ``out_dir/spatial<r>.json``."""
    import sys as _sys

    import torch
    import torch.distributed as dist

    from cyclegan_tpu_torch.parallel import mesh as M
    from cyclegan_tpu_torch.train import runner
    from cyclegan_tpu_torch.utils.config import preset

    torch.backends.cudnn.allow_tf32 = False  # as in the parent (phase_kernels)
    torch.backends.cuda.matmul.allow_tf32 = False
    mesh = M.make_mesh(spatial=SPATIAL_RANKS, device="cuda:0")
    rec = {"rank": mesh.rank, "world": mesh.world, "spatial": mesh.spatial,
           "backend": dist.get_backend()}
    cfg = preset(SPATIAL_PRESET).replace(spatial_shards=SPATIAL_RANKS,
                                         num_devices=SPATIAL_RANKS)
    t, st = _config_trainer(cfg, "fused", mesh)
    routes = {b.route for net in (t.G_i2l, t.G_l2i) for b in net.trunk}
    batches = [M.shard_batch(b, mesh) for b in
               _dp_batch(cfg, 1, TRAIN_STEPS + SPATIAL_TIMED_STEPS + 1)]
    rec["slab_shape"] = list(batches[0]["unlab_image"].shape)
    want = spatial_launches(t, TRAIN_STEPS)
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    _zero_counters()
    losses = []
    for b in batches[:TRAIN_STEPS]:
        st, m = t.train_step(st, b)
        losses.append({k: float(v) for k, v in m.items()})
    torch.cuda.synchronize()
    got = _read_counters()
    ms = []
    for b in batches[TRAIN_STEPS:TRAIN_STEPS + SPATIAL_TIMED_STEPS]:
        torch.cuda.synchronize()
        dist.barrier()
        t0 = time.perf_counter()
        st, _ = t.train_step(st, b)
        torch.cuda.synchronize()
        ms.append((time.perf_counter() - t0) * 1e3)
    peak = torch.cuda.max_memory_allocated() / 1e9
    # The collectives timed alone, by what makes them: the halo exchanges
    # (parallel/spatial.py's RowGather), the norms' partials (the exchange
    # buffer's all-reduce, ops/blocks.py's InstanceNorm._gather), other
    # slot gathers (parallel/mesh.py::gather_slots),
    # the gradients (all_reduce_mean) and the metrics and counts.
    real = dist.all_reduce
    spent: dict = {}

    def timed_all_reduce(tensor, *a, **k):
        who = _sys._getframe(1).f_code.co_name
        kind = {"forward": "halo", "backward": "halo", "_gather": "norm_partials",
                "gather_slots": "slot_gathers", "all_reduce_mean": "gradients"}.get(
                    who, "metrics_and_counts")
        torch.cuda.synchronize()
        ta = time.perf_counter()
        w = real(tensor, *a, **k)
        torch.cuda.synchronize()
        e = spent.setdefault(kind, [0.0, 0, 0])
        e[0] += time.perf_counter() - ta
        e[1] += 1
        e[2] += tensor.numel() * tensor.element_size()
        return w

    M.dist.all_reduce = timed_all_reduce
    try:
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        st, _ = t.train_step(st, batches[-1])
        torch.cuda.synchronize()
        probe_ms = (time.perf_counter() - t0) * 1e3
    finally:
        M.dist.all_reduce = real
    rec["a"] = {"losses": losses, "launches": got, "expected_launches": want,
                "launches_as_derived": {k: got.get(k, 0) for k in want} == want,
                "trunk_routes": sorted(routes), "step_ms": ms,
                "median_step_ms": statistics.median(ms), "peak_mem_gb": peak,
                "probe_step_ms": probe_ms,
                "collectives_ms": {k: v[0] * 1e3 for k, v in spent.items()},
                "collectives_calls": {k: v[1] for k, v in spent.items()},
                "collectives_mb": {k: v[2] / 1e6 for k, v in spent.items()},
                "halo_and_norm_share_of_probe_step":
                    sum(spent.get(k, [0.0])[0] for k in ("halo", "norm_partials"))
                    / (probe_ms / 1e3)}
    del t, st, batches
    torch.cuda.empty_cache()
    # (b) the runner on the synthetic dataset at config 3's shape, in float32
    # (bf16 rounds the slabs' unfused trunk and the one process's fused
    # kernels apart: ~0.6% of the class maps differ, spread over every row).
    rcfg = preset(SPATIAL_PRESET).replace(
        dataset="synthetic", dataset_size=CLI_SIZE, validation_every=0, log_every=1, epochs=2,
        bf16=False,
        num_devices=SPATIAL_RANKS, spatial_shards=SPATIAL_RANKS,
        checkpoint_dir=os.path.join(out_dir, "runner", "ckpt"),
        results_dir=os.path.join(out_dir, "runner", "res"))
    with resblock_env("fused"):
        runner.run_cyclegan(rcfg, max_steps=TRAIN_STEPS, device="cuda:0")
        test = runner.run_test(rcfg.replace(results_dir=os.path.join(out_dir, "runner", "test2")),
                               device="cuda:0")
    rec["b"] = {"test": test}
    # spatial_unet: config 3 with unet_256 generators at spatial 2.
    rec["unet"] = _spatial_unet_rank(mesh)
    # spatial_eval: --testing of (b)'s checkpoint, tiled, flipped and scaled.
    torch.cuda.synchronize()
    _zero_counters()
    t0 = time.perf_counter()
    with resblock_env("fused"):
        test = runner.run_test(rcfg.replace(
            results_dir=os.path.join(out_dir, "runner", "eval2"), **SPATIAL_EVAL),
            device="cuda:0")
    torch.cuda.synchronize()
    rec["eval"] = {"test": test, "seconds": time.perf_counter() - t0,
                   "launches": _read_counters()}
    with open(os.path.join(out_dir, f"spatial{mesh.rank}.json"), "w") as f:
        json.dump(rec, f)
    return rec


def unet_plane_rows(h: int, downs: int, s: int) -> list:
    """The rows each of ``s`` ranks owns of every plane of a U-Net of
    ``downs`` levels over an input of ``h`` rows (parallel.spatial.slab):
    the input, then each level's down output, to the innermost."""
    from cyclegan_tpu_torch.parallel import spatial as S

    out = []
    for _ in range(downs + 1):
        out.append({"rows": h, "per_rank": [b - a for a, b in (S.slab(h, s, p)
                                                               for p in range(s))]})
        h = S.conv_out_rows(h, 4, 2, 1)
    return out


def _spatial_unet_rank(mesh) -> dict:
    """spatial_unet on one rank: config 3 with UNET_GEN generators at
    spatial 2, TRAIN_STEPS steps counted from the weights, batches and pool
    decisions of the unsharded run, then UNET_TIMED_STEPS timed; the peak
    memory of the rank over them."""
    import torch
    import torch.distributed as dist

    from cyclegan_tpu_torch.parallel import mesh as M
    from cyclegan_tpu_torch.utils.config import preset

    cfg = preset(SPATIAL_PRESET).replace(gen_net=UNET_GEN, spatial_shards=SPATIAL_RANKS,
                                         num_devices=SPATIAL_RANKS)
    t, st = _config_trainer(cfg, "fused", mesh)
    batches = [M.shard_batch(b, mesh) for b in
               _dp_batch(cfg, 1, TRAIN_STEPS + UNET_TIMED_STEPS)]
    want = spatial_launches(t, TRAIN_STEPS)
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    _zero_counters()
    losses = []
    for b in batches[:TRAIN_STEPS]:
        st, m = t.train_step(st, b)
        losses.append({k: float(v) for k, v in m.items()})
    torch.cuda.synchronize()
    got = _read_counters()
    ms = []
    for b in batches[TRAIN_STEPS:]:
        dist.barrier()
        t0 = time.perf_counter()
        st, _ = t.train_step(st, b)
        torch.cuda.synchronize()
        ms.append((time.perf_counter() - t0) * 1e3)
    rec = {"losses": losses, "launches": got, "expected_launches": want,
           "launches_as_derived": {k: got.get(k, 0) for k in want} == want,
           "norms_a_generator_forward": net_counts(t.G_i2l)["norms"],
           "slab_shape": list(batches[0]["unlab_image"].shape), "step_ms": ms,
           "median_step_ms": statistics.median(ms),
           "peak_mem_gb": torch.cuda.max_memory_allocated() / 1e9}
    del t, st, batches
    torch.cuda.empty_cache()
    return rec


SLAB_KERNELS = {"fwd_partials": "in_fwd_partials<", "fwd_apply": "in_fwd_slab_apply<",
                "vjp_partials": "in_bwd_partials<", "vjp_apply": "in_bwd_slab_apply<"}


def slab_layer_kernels(xs, dy, act: str) -> dict:
    """One slab norm layer (``instance_norm_act_slab`` forward and its VJP
    through autograd) profiled: its device activities by name and count.
    The exchange buffer's all-reduce is stood in for by a call that does no
    device work, so whatever the profile holds is the layer's own: it must
    be the two slab kernels a direction, once each, and no fill or copy."""
    import torch

    from cyclegan_tpu_torch.kernels import instance_norm as IN

    group = IN.SlabGroup(SPATIAL_RANKS, 0, lambda buf: None)
    x = xs.detach().requires_grad_(True)

    def layer():
        y = IN.instance_norm_act_slab(x, None, 1e-5, act, group)
        return torch.autograd.grad(y, x, dy)

    layer()
    torch.cuda.synchronize()
    seen, sessions = {}, 0
    # A session can come back without device events (CUPTI starts lazily;
    # on the card whole sessions in a row did): the first is not read, and
    # they repeat until one reports the device's activities.
    while not seen and sessions < 8:
        with torch.profiler.profile(activities=[torch.profiler.ProfilerActivity.CUDA]) as prof:
            layer()
            torch.cuda.synchronize()
        sessions += 1
        if sessions > 1:
            seen = {e.key[:90]: e.count for e in prof.key_averages()
                    if getattr(e, "device_type", None) == torch.autograd.DeviceType.CUDA}
    ours = {k: sum(n for name, n in seen.items() if pat in name)
            for k, pat in SLAB_KERNELS.items()}
    others = {name: n for name, n in seen.items()
              if not any(pat in name for pat in SLAB_KERNELS.values())}
    return {"kernels": ours, "other_device_activities": others, "sessions": sessions,
            "two_kernels_a_direction_and_nothing_else":
                ours == {k: 1 for k in SLAB_KERNELS} and not others}


def slab_kernel_records(randn, fail_if) -> dict:
    """The slab entries alone at config 3's stem and trunk slab shapes
    (bf16, batch 1, two slabs of a 256x512 and of a 64x128 plane). Each
    slab's partials write its slot of an (S, N, C, k) exchange buffer and
    zeros into the other (checked exactly); the slabs' buffers are summed
    as the all-reduce sums them; each slab's apply runs from the sum. Held,
    forward and VJP: the partials against their plain versions, every
    apply against its plain version and the one-launch kernel's rows of the
    whole plane, every slab's statistics bitwise alike, a second call of
    each entry bitwise equal. Timed for one slab: the pair (partials, then
    the apply from the summed buffer) eagerly (ms, CUDA events, host
    included) and as a CUDA-graph replay (device µs a call), the plain
    pair, the library graph of the same function (``var_mean`` of the
    slab, the Chan merge with the other slab's partials, normalise + act;
    its autograd VJP), the bound (each input read once, each output written
    once), and what the gather did around its all-reduce before the
    partials wrote their slot (a zero-filled buffer and a copy into the
    slot, ``parallel/mesh.py::gather_slots``); then one slab norm layer
    profiled (``slab_layer_kernels``)."""
    import torch

    from cyclegan_tpu_torch.kernels import instance_norm as IN

    out = {"instance_norm_act_slab": [], "instance_norm_act_slab_bwd": []}
    d = torch.bfloat16
    tol = TOL[("instance_norm_act", "bfloat16")]
    btol = BWD_TOL[("instance_norm_act_bwd", "bfloat16")]
    S = SPATIAL_RANKS

    def slots(x, k):
        return torch.empty((S, x.shape[0], x.shape[3], k), dtype=torch.float32, device=x.device)

    def removed_gather(p):  # what gather_slots did before its all-reduce
        buf = torch.zeros((S, *p.shape), dtype=p.dtype, device=p.device)
        buf[0].copy_(p)
        return buf

    # Calls a step at these planes: the stem and up2 (64 channels) of 3
    # generator applies, the 9 trunk blocks' two norms of 3 applies.
    for shape, act, calls in (((1, 256, 512, 64), "relu", 6), ((1, 64, 128, 256), "relu", 27),
                              ((1, 64, 128, 256), "none", 27)):
        n, h, w, c = shape
        x = randn(shape, d)
        dy = randn(shape, d)
        hs = h // S
        xsl = [x[:, i * hs:(i + 1) * hs].contiguous() for i in range(S)]
        dys = [dy[:, i * hs:(i + 1) * hs].contiguous() for i in range(S)]
        own = [IN._slab_partials_cuda(t, slots(t, 3), i) for i, t in enumerate(xsl)]
        own_p = [IN.slab_partials_plain(t, slots(t, 3), i) for i, t in enumerate(xsl)]
        parts = sum(own)  # the all-reduce: one slot a rank, zeros elsewhere
        outs = [IN._slab_apply_cuda(t, None, parts, 1e-5, act) for t in xsl]
        y, mean, rstd, count = outs[0]
        y_p = IN.slab_apply_plain(xsl[0], None, sum(own_p), 1e-5, act)[0]
        whole = torch.empty_like(x)
        wm, wr = IN.launch(x, None, whole, 1e-5, act)
        own_b = [IN._slab_bwd_partials_cuda(t, g, mean, rstd, slots(t, 2), i, act)
                 for i, (t, g) in enumerate(zip(xsl, dys))]
        own_bp = [IN.slab_bwd_partials_plain(t, g, mean, rstd, slots(t, 2), i, act)
                  for i, (t, g) in enumerate(zip(xsl, dys))]
        sums = sum(own_b)
        dx = IN._slab_bwd_apply_cuda(xsl[0], dys[0], mean, rstd, sums, count, act)
        dx_p = IN.slab_bwd_apply_plain(xsl[0], dys[0], mean, rstd, sum(own_bp), count, act)
        dx_whole = torch.empty_like(x)
        IN.launch_bwd(x, dy, wm, wr, dx_whole, act)
        again = IN._slab_apply_cuda(xsl[0], None, sum(IN._slab_partials_cuda(
            t, slots(t, 3), i) for i, t in enumerate(xsl)), 1e-5, act)
        dx_again = IN._slab_bwd_apply_cuda(xsl[0], dys[0], mean, rstd, sum(
            IN._slab_bwd_partials_cuda(t, g, mean, rstd, slots(t, 2), i, act)
            for i, (t, g) in enumerate(zip(xsl, dys))), count, act)
        torch.cuda.synchronize()
        others_zero = all(torch.equal(b[j], torch.zeros_like(b[j]))
                          for i, b in enumerate(own + own_b) for j in range(S) if j != i % S)
        checks = {"vs_plain": compare("instance_norm_act", y, y_p, "bfloat16"),
                  "vs_whole_plane": compare("instance_norm_act", y, whole[:, :hs], "bfloat16"),
                  "stats_vs_whole_plane": float(max((mean - wm).abs().max(),
                                                    ((rstd - wr) / wr).abs().max())),
                  "partials_vs_plain": float(max(
                      ((a - b).abs() / b.abs().clamp_min(1.0)).max()
                      for a, b in zip(own + own_b, own_p + own_bp))),
                  "other_slots_zero": others_zero,
                  "stats_alike_on_every_slab": all(
                      torch.equal(o[1], mean) and torch.equal(o[2], rstd) for o in outs),
                  "second_call_bitwise": all(torch.equal(a, b) for a, b in zip(again, outs[0]))}
        bchecks = {"vs_plain": compare_bwd("instance_norm_act_bwd", dx, dx_p, "bfloat16"),
                   "vs_whole_plane": compare_bwd("instance_norm_act_bwd", dx,
                                                 dx_whole[:, :hs], "bfloat16"),
                   "second_call_bitwise": torch.equal(dx_again, dx)}
        ok = (all(v["ok"] for v in (checks["vs_plain"], checks["vs_whole_plane"],
                                    bchecks["vs_plain"], bchecks["vs_whole_plane"]))
              and checks["stats_vs_whole_plane"] <= 1e-4 and checks["partials_vs_plain"] <= 1e-4
              and others_zero and checks["stats_alike_on_every_slab"]
              and checks["second_call_bitwise"] and bchecks["second_call_bitwise"])
        fail_if(not ok, f"slab IN {shape} {act}: {checks} {bchecks}")
        xs, g0 = xsl[0], dys[0]
        elt = xs.element_size()
        buf, bbuf = slots(xs, 3), slots(xs, 2)
        nb, mb, m2b = (t[:, :, None, None] for t in own[1][1].unbind(-1))
        na = float(xs.shape[1] * xs.shape[2])

        def lib(xl):  # NCHW view of the slab
            var, m = torch.var_mean(xl.float(), dim=(2, 3), keepdim=True, correction=0)
            tot = na + nb
            dm = mb - m
            mm = m + dm * (nb / tot)
            rs = torch.rsqrt((var * na + m2b + dm * dm * (na * nb / tot)) / tot + 1e-5)
            return _lib_act((xl.float() - mm) * rs, act).to(xl.dtype)

        def pair():
            IN._slab_partials_cuda(xs, buf, 0)
            return IN._slab_apply_cuda(xs, None, parts, 1e-5, act)

        def pair_p():
            IN.slab_partials_plain(xs, buf, 0)
            return IN.slab_apply_plain(xs, None, parts, 1e-5, act)

        def bpair():
            IN._slab_bwd_partials_cuda(xs, g0, mean, rstd, bbuf, 0, act)
            return IN._slab_bwd_apply_cuda(xs, g0, mean, rstd, sums, count, act)

        def bpair_p():
            IN.slab_bwd_partials_plain(xs, g0, mean, rstd, bbuf, 0, act)
            return IN.slab_bwd_apply_plain(xs, g0, mean, rstd, sums, count, act)

        xl = xs.permute(0, 3, 1, 2)
        gathers = {k: {"graph_us": graph_us(lambda: removed_gather(p[0][0])),
                       "eager_us": time_ms(lambda: removed_gather(p[0][0]), 20) * 1e3}
                   for k, p in (("fwd", own), ("vjp", own_b))}
        layer = slab_layer_kernels(xs, g0, act)
        fail_if(not layer["two_kernels_a_direction_and_nothing_else"],
                f"slab IN layer {shape} {act}: {layer}")
        part_bytes = 4 * n * c * 3
        nbytes = 2 * xs.numel() * elt + S * part_bytes + part_bytes + 4 * n * c * 2
        b_ms, b_by = bound(nbytes, 10 * xs.numel(), "float32")
        out["instance_norm_act_slab"].append({
            "shape": list(xs.shape), "plane": list(shape), "act": act, "calls_per_step": calls,
            "max_abs_err": checks["vs_plain"]["max_abs_err"], "checks": checks,
            "ms": time_ms(pair, 20), "graph_us": graph_us(pair),
            "plain_ms": time_ms(pair_p, 5), "library_ms": time_ms(lambda: lib(xl), 20),
            "library_graph_us": graph_us(lambda: lib(xl)), "bound_ms": b_ms, "bound_by": b_by,
            "removed_gather": gathers["fwd"], "layer": layer})
        xg = xl.detach().requires_grad_(True)
        yl = lib(xg)
        gl = g0.permute(0, 3, 1, 2)
        nbytes = 3 * xs.numel() * elt + (S + 1) * 4 * n * c * 2 + 4 * n * c * 2
        b_ms, b_by = bound(nbytes, 12 * xs.numel(), "float32")
        out["instance_norm_act_slab_bwd"].append({
            "shape": list(xs.shape), "plane": list(shape), "act": act, "calls_per_step": calls,
            "max_abs_err": bchecks["vs_plain"]["max_abs_err"], "checks": bchecks,
            "ms": time_ms(bpair, 20), "graph_us": graph_us(bpair),
            "plain_ms": time_ms(bpair_p, 5),
            "library_ms": time_ms(lambda: torch.autograd.grad(yl, xg, gl, retain_graph=True),
                                  20),
            "bound_ms": b_ms, "bound_by": b_by, "removed_gather": gathers["vjp"]})
    return out


def phase_spatial(smi: str, configs: dict) -> dict:
    """(a) config 3 at spatial_shards 2, two gloo ranks on the card: 3 steps
    on the kernels against the unsharded config-3 run of the configs phase
    (the same weights, batches and pool decisions) at the bf16 bars, every
    rank the same losses, each rank's counters as derived (#1/#2 through
    the slab entries, #8 on every trunk convolution, no #3-#7), the step
    time, each rank's peak memory against the unsharded run's, and the
    halo and norm-partial collectives' share of a step; (b) the runner at
    --num_devices 2 --spatial_shards 2 for 3 float32 steps and --testing,
    whose class maps must equal one process's --testing of the same
    checkpoint on every pixel where the one process's logits are no tie
    (so the confusion matrices agree but for ties); (c) the slab entries
    alone (slab_kernel_records)."""
    import numpy as np
    import torch
    from PIL import Image

    from cyclegan_tpu_torch.data.datasets import make_dataset
    from cyclegan_tpu_torch.data.loader import Loader
    from cyclegan_tpu_torch.parallel import distributed
    from cyclegan_tpu_torch.train import checkpoint as ck
    from cyclegan_tpu_torch.train import runner
    from cyclegan_tpu_torch.utils.config import preset

    t_phase = time.perf_counter()
    tmp = tempfile.mkdtemp(prefix="chip_smoke_spatial_")
    distributed.launch_local(_spatial_rank, (tmp,), nprocs=SPATIAL_RANKS, world=SPATIAL_RANKS,
                             device="cuda:0", backend="gloo",
                             init_method=f"file://{os.path.join(tmp, 'store')}")
    recs = []
    for r in range(SPATIAL_RANKS):
        with open(os.path.join(tmp, f"spatial{r}.json")) as f:
            recs.append(json.load(f))
    t_ranks = time.perf_counter()
    ref = configs[(SPATIAL_PRESET, "fused")]
    worst = _bf16_agree("spatial (a)", recs[0]["a"]["losses"], ref["losses"])
    if any(r["a"]["losses"] != recs[0]["a"]["losses"] for r in recs):
        raise AssertionError("spatial (a): the ranks report different losses")
    for r in recs:
        if not r["a"]["launches_as_derived"] or r["a"]["trunk_routes"] != ["unfused"]:
            raise AssertionError(f"spatial (a) rank {r['rank']}: routes {r['a']['trunk_routes']}"
                                 f", counters {r['a']['launches']} != derived "
                                 f"{r['a']['expected_launches']}")
    # (b): one process's --testing of the same checkpoint.
    rcfg = preset(SPATIAL_PRESET).replace(
        dataset="synthetic", dataset_size=CLI_SIZE, validation_every=0, epochs=2, bf16=False,
        checkpoint_dir=os.path.join(tmp, "runner", "ckpt"),
        results_dir=os.path.join(tmp, "runner", "test1"))
    with resblock_env("fused"):
        one = runner.run_test(rcfg, device="cuda")
        trainer = ck.restore_for_inference(rcfg, semisupervised=True, device="cuda")[0]
    two = recs[0]["b"]["test"]
    # The two runs' class maps (their PNGs) may differ only where the one
    # process's float32 logits tie: a top-2 gap within twice the generator
    # bar (GEN_TOL), as the slabs run the unfused trunk on cuDNN and the one
    # process the fused kernels. On every other pixel the maps, and so the
    # confusion matrices, must be equal.
    val = Loader(make_dataset(rcfg.dataset, split="val"), batch_size=1, crop_hw=rcfg.crop_hw,
                 train=False, drop_last=False)
    pixels = flips = decisive_flips = 0
    for k, batch in enumerate(val.epoch(0)):
        logits = trainer.logits(torch.from_numpy(batch["image"]).cuda()).float()[0]
        maps = [np.asarray(Image.open(os.path.join(tmp, "runner", d, f"pred_{k:05d}.png")))
                for d in ("test1", "test2")]
        top2 = logits.topk(2, dim=-1).values
        decisive = ((top2[..., 0] - top2[..., 1]) > 2 * GEN_TOL).cpu().numpy()
        if (decisive & (logits.argmax(-1).cpu().numpy() != maps[0])).any():
            raise AssertionError(f"spatial (b): image {k}: one process's PNG is not its argmax")
        diff = maps[0] != maps[1]
        pixels += diff.size
        flips += int(diff.sum())
        decisive_flips += int((diff & decisive).sum())
    conf_diff = int(np.abs(np.asarray(one["confusion"]) - np.asarray(two["confusion"])).sum())
    if decisive_flips or not one["confusion"] or k + 1 != len(val.ds):
        raise AssertionError(f"spatial (b): {decisive_flips} decisive pixels of {pixels} differ "
                             f"between the runner at spatial 2 and one process ({flips} in "
                             f"all)")
    spatial_eval = phase_spatial_eval(recs, rcfg, trainer, tmp, smi)
    del trainer
    torch.cuda.empty_cache()
    spatial_unet = phase_spatial_unet(recs, smi)
    # (c)
    g = torch.Generator(device="cuda").manual_seed(12)
    failures = []

    def randn(shape, dtype):
        return torch.randn(shape, generator=g, device="cuda").to(dtype)

    def fail_if(bad, msg):
        if bad:
            failures.append(msg)

    kern = slab_kernel_records(randn, fail_if)
    if failures:
        raise AssertionError(f"spatial (c): {failures}")
    a0 = recs[0]["a"]
    rec = {"phase": "spatial", "nvidia_smi": smi, "seconds": time.perf_counter() - t_phase,
           "ranks_seconds": t_ranks - t_phase,
           "a_config3_spatial2": {
               "preset": SPATIAL_PRESET, "ranks": SPATIAL_RANKS, "backend": recs[0]["backend"],
               "slab_shape": recs[0]["slab_shape"], "losses_rank0": a0["losses"],
               "losses_unsharded": ref["losses"], "loss_err_over_tol": worst,
               "tol": TRAIN_TOL["bfloat16"], "launches_per_rank": [r["a"]["launches"]
                                                                   for r in recs],
               "expected_launches": a0["expected_launches"],
               "median_step_ms": [r["a"]["median_step_ms"] for r in recs],
               "unsharded_median_step_ms": ref["median_step_ms"],
               "peak_mem_gb_per_rank": [r["a"]["peak_mem_gb"] for r in recs],
               "unsharded_peak_mem_gb": ref["peak_mem_gb"],
               "probe_step_ms": [r["a"]["probe_step_ms"] for r in recs],
               "collectives_ms": [r["a"]["collectives_ms"] for r in recs],
               "collectives_calls": a0["collectives_calls"],
               "collectives_mb": a0["collectives_mb"],
               "halo_and_norm_share_of_probe_step":
                   [r["a"]["halo_and_norm_share_of_probe_step"] for r in recs]},
           "b_runner": {"steps": TRAIN_STEPS, "val_images": k + 1, "pixels": pixels,
                        "pixels_differing": flips, "decisive_pixels_differing": 0,
                        "confusion_abs_diff_sum": conf_diff,
                        "confusion_equal": conf_diff == 0, "dtype": "float32",
                        "tie_gap": 2 * GEN_TOL,
                        "miou": [one["miou"], two["miou"]],
                        "pixel_acc": [one["pixel_acc"], two["pixel_acc"]]},
           "c_slab_kernels": kern}
    emit(rec)
    print(f"spatial (a) {SPATIAL_PRESET} at spatial_shards {SPATIAL_RANKS} (gloo ranks on one "
          f"card): median {[round(x, 2) for x in rec['a_config3_spatial2']['median_step_ms']]} "
          f"ms a step (unsharded {ref['median_step_ms']:.2f}), peak "
          f"{[round(r['a']['peak_mem_gb'], 3) for r in recs]} GB a rank (unsharded "
          f"{ref['peak_mem_gb']:.3f}); {smi}", flush=True)
    return {"launches": recs[0]["a"]["launches"], "records": kern, "record": rec,
            "unet": spatial_unet, "eval": spatial_eval}


def phase_spatial_unet(recs: list, smi: str) -> dict:
    """spatial_unet: the ranks' U-Net steps (``_spatial_unet_rank``) against
    the same model unsharded in this process from the same weights, batches
    and pool decisions, at the bf16 bars; both ranks' losses equal; each
    rank's counters as derived (#1/#2 only through the slab entries: 13
    norms a unet_256 forward, 3 generator and 4 discriminator applies a
    step); the step time and each rank's peak memory against the unsharded
    run's."""
    import torch

    from cyclegan_tpu_torch.parallel import mesh as M
    from cyclegan_tpu_torch.utils.config import preset

    t_phase = time.perf_counter()
    cfg = preset(SPATIAL_PRESET).replace(gen_net=UNET_GEN)
    mesh = M.Mesh(torch.device("cuda"))
    t, st = _config_trainer(cfg, "fused", mesh)
    batches = [M.shard_batch(b, mesh) for b in
               _dp_batch(cfg, 1, TRAIN_STEPS + UNET_TIMED_STEPS)]
    want = expected_launches(t, TRAIN_STEPS)
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    _zero_counters()
    ref = []
    for b in batches[:TRAIN_STEPS]:
        st, m = t.train_step(st, b)
        ref.append({k: float(v) for k, v in m.items()})
    torch.cuda.synchronize()
    got = _read_counters()
    _held_counts(got, want, "spatial_unet, unsharded")
    ms = []
    for b in batches[TRAIN_STEPS:]:
        t0 = time.perf_counter()
        st, _ = t.train_step(st, b)
        torch.cuda.synchronize()
        ms.append((time.perf_counter() - t0) * 1e3)
    peak = torch.cuda.max_memory_allocated() / 1e9
    norms = net_counts(t.G_i2l)["norms"]
    del t, st, batches
    torch.cuda.empty_cache()
    u = [r["unet"] for r in recs]
    worst = _bf16_agree("spatial_unet", u[0]["losses"], ref)
    if any(r["losses"] != u[0]["losses"] for r in u):
        raise AssertionError("spatial_unet: the ranks report different losses")
    for r, rank in zip(u, recs):
        if not r["launches_as_derived"] or r["norms_a_generator_forward"] != norms \
                or norms != 13:
            raise AssertionError(f"spatial_unet rank {rank['rank']}: counters "
                                 f"{r['launches']} != derived {r['expected_launches']} "
                                 f"({r['norms_a_generator_forward']} norms a forward)")
    rec = {"phase": "spatial_unet", "preset": SPATIAL_PRESET, "gen_net": UNET_GEN,
           "ranks": SPATIAL_RANKS, "slab_shape": u[0]["slab_shape"],
           "rows_per_rank_by_plane": unet_plane_rows(cfg.crop_height, 8, SPATIAL_RANKS),
           "losses_rank0": u[0]["losses"], "losses_unsharded": ref,
           "loss_err_over_tol": worst, "tol": TRAIN_TOL["bfloat16"],
           "norms_a_generator_forward": norms,
           "launches_per_rank": [r["launches"] for r in u],
           "expected_launches": u[0]["expected_launches"], "launches_unsharded": got,
           "median_step_ms": [r["median_step_ms"] for r in u],
           "unsharded_median_step_ms": statistics.median(ms), "unsharded_step_ms": ms,
           "peak_mem_gb_per_rank": [r["peak_mem_gb"] for r in u],
           "unsharded_peak_mem_gb": peak, "nvidia_smi": smi,
           "seconds_here": time.perf_counter() - t_phase}
    emit(rec)
    print(f"spatial_unet ({SPATIAL_PRESET}, {UNET_GEN}) at spatial_shards {SPATIAL_RANKS}: "
          f"median {[round(r['median_step_ms'], 2) for r in u]} ms a step (unsharded "
          f"{statistics.median(ms):.2f}), peak {[round(r['peak_mem_gb'], 3) for r in u]} GB a "
          f"rank (unsharded {peak:.3f}); {smi}", flush=True)
    return {"launches": u[0]["launches"], "record": rec}


def canvas_logits_fn(trainer, cfg):
    """The runner's composition of --eval_resize tile, --eval_flip and
    --eval_scales around ``trainer.logits`` on one process: tiles
    innermost, the flip inside the scales."""
    from cyclegan_tpu_torch import eval_tile, tta

    def tiled(image):
        return eval_tile.tiled_logits(trainer.logits, image, cfg.crop_hw)

    return tta.scale_avg(tta.flip_avg(tiled), tta.parse_scales(cfg.eval_scales))


def phase_spatial_eval(recs: list, rcfg, trainer, tmp: str, smi: str) -> dict:
    """spatial_eval: the ranks' --testing at --num_devices 2
    --spatial_shards 2 with SPATIAL_EVAL against one process's --testing of
    the same checkpoint with the same flags: the class maps equal on every
    pixel where the one process's canvas logits are no tie (a top-2 gap
    within twice GEN_TOL, read from its canvas logits of each image whose
    maps differ), so the confusion matrices agree but for ties;
    each rank's counters as derived (#1 through its slab entries only: 23
    norms of a ResNet-9 forward, one forward a scale and mirror of each
    image)."""
    import numpy as np
    import torch
    from PIL import Image

    from cyclegan_tpu_torch.data.datasets import make_dataset
    from cyclegan_tpu_torch.data.loader import Loader
    from cyclegan_tpu_torch.ops.blocks import InstanceNorm
    from cyclegan_tpu_torch.train import runner

    cfg = rcfg.replace(results_dir=os.path.join(tmp, "runner", "eval1"), **SPATIAL_EVAL)
    t0 = time.perf_counter()
    with resblock_env("fused"):
        one = runner.run_test(cfg, device="cuda")
    one_s = time.perf_counter() - t0
    ds = make_dataset(cfg.dataset, split="val")
    scales = SPATIAL_EVAL["eval_scales"].split(",")
    forwards = len(ds) * len(scales) * 2
    norms = sum(isinstance(m, InstanceNorm) for m in trainer.G_i2l.modules())
    want = {k: forwards * norms if k in SLAB_COUNTERS[:2] else 0
            for k in SLAB_COUNTERS + WHOLE_PLANE_COUNTERS}
    for r in recs:
        got = {k: r["eval"]["launches"].get(k, 0) for k in want}
        if got != want:
            raise AssertionError(f"spatial_eval rank {r['rank']}: counters {got} != {want}")
    # The canvas logits of one process, on each image whose maps differ
    # (elsewhere there is nothing to explain).
    canvas = canvas_logits_fn(trainer, cfg)
    val = Loader(ds, batch_size=1, crop_hw=(cfg.resize_height, cfg.resize_width), train=False,
                 drop_last=False)
    pixels = flips = decisive_flips = ties = 0
    differing_images = []
    with torch.no_grad():
        for k, batch in enumerate(val.epoch(0)):
            maps = [np.asarray(Image.open(os.path.join(tmp, "runner", d, f"pred_{k:05d}.png")))
                    for d in ("eval1", "eval2")]
            diff = maps[0] != maps[1]
            pixels += diff.size
            if not diff.any():
                continue
            differing_images.append(k)
            logits = canvas(torch.from_numpy(batch["image"]).cuda()).float()[0]
            top2 = logits.topk(2, dim=-1).values
            decisive = ((top2[..., 0] - top2[..., 1]) > 2 * GEN_TOL).cpu().numpy()
            if (decisive & (logits.argmax(-1).cpu().numpy() != maps[0])).any():
                raise AssertionError(f"spatial_eval: image {k}: one process's PNG is not its "
                                     f"canvas argmax")
            ties += int((~decisive).sum())
            flips += int(diff.sum())
            decisive_flips += int((diff & decisive).sum())
    two = recs[0]["eval"]["test"]
    conf_diff = int(np.abs(np.asarray(one["confusion"]) - np.asarray(two["confusion"])).sum())
    if decisive_flips or k + 1 != len(ds) or pixels != len(ds) * 512 * 1024:
        raise AssertionError(f"spatial_eval: {decisive_flips} decisive pixels of {pixels} "
                             f"differ between --testing at spatial 2 and one process ({flips} "
                             f"in all)")
    rec = {"phase": "spatial_eval", "flags": SPATIAL_EVAL, "window": list(rcfg.crop_hw),
           "val_images": len(ds), "pixels": pixels, "pixels_differing": flips,
           "decisive_pixels_differing": decisive_flips, "images_differing": differing_images,
           "tie_pixels_of_those_images": ties,
           "tie_gap": 2 * GEN_TOL, "dtype": "float32",
           "confusion_abs_diff_sum": conf_diff, "confusion_equal": conf_diff == 0,
           "miou": [one["miou"], two["miou"]], "pixel_acc": [one["pixel_acc"],
                                                             two["pixel_acc"]],
           "net_forwards_per_rank": forwards, "launches_per_rank": [
               {k: r["eval"]["launches"].get(k, 0) for k in SLAB_COUNTERS[:2]} for r in recs],
           "seconds_spatial2": [r["eval"]["seconds"] for r in recs],
           "seconds_one_process": one_s, "nvidia_smi": smi}
    emit(rec)
    print(f"spatial_eval (tile 512x1024 / 256x512, flip, scales {SPATIAL_EVAL['eval_scales']}) "
          f"at spatial 2: {flips} of {pixels} pixels differ from one process ({decisive_flips}"
          f" decisive), {rec['seconds_spatial2'][0]:.1f} s against {one_s:.1f} s; {smi}",
          flush=True)
    return {"launches": recs[0]["eval"]["launches"], "record": rec}


def phase_ckpt_devices(smi: str) -> dict:
    """A checkpoint resumes on either device type (train/checkpoint.py): a
    small run of each trainer (resnet_2blocks, ngf 8, 32x32, batch 2,
    dropout on, float32) takes one step on one device, is saved, and is
    resumed on the other (CPU -> card, card -> CPU) or on the same (card ->
    card), where it takes one more step; a CPU payload without its
    dropout seed (as written before the seed was stored) resumes on the
    card too. Held: the nets and the step are the saved ones bitwise; the
    dropout generator is the new device's, seeded by dropout_reseed(stored
    seed, or the resuming trainer's own, step), or on the same device type
    the saved state bitwise; the next step's losses are finite."""
    import numpy as np
    import torch

    from cyclegan_tpu_torch.train import checkpoint as ck
    from cyclegan_tpu_torch.train.cyclegan import CycleGANTrainer
    from cyclegan_tpu_torch.train.supervised import SupervisedTrainer
    from cyclegan_tpu_torch.utils.config import Config

    cfg = Config(gen_net="resnet_2blocks", ngf=8, ndf=8, crop_height=32, crop_width=32,
                 bf16=False, batch_size=2, pool_size=2, epochs=2, decay_epoch=1,
                 use_dropout=True)
    r = np.random.default_rng(1)
    images = r.uniform(-1, 1, (2, 2, 32, 32, 3)).astype(np.float32)
    labels = r.integers(0, NUM_CLASSES, (2, 32, 32))

    def batch(kind: str, device: str) -> dict:
        img, unlab, lab = (torch.from_numpy(a).to(device) for a in (*images, labels))
        if kind == "supervised":
            return {"image": img, "label": lab}
        return {"lab_image": img, "unlab_image": unlab, "lab_label": lab}

    def build(kind: str, device: str, seed: int):
        make = SupervisedTrainer if kind == "supervised" else CycleGANTrainer
        with resblock_env("fused"):
            t = make(cfg, NUM_CLASSES, 3, 2, device=device)
        return t, t.init_state(torch.Generator().manual_seed(seed))

    out = {}
    tmp = tempfile.mkdtemp(prefix="chip_smoke_ckpt_devices_")
    try:
        for kind in ("cyclegan", "supervised"):
            for src, dst, seeded in (("cpu", "cuda", True), ("cuda", "cpu", True),
                                     ("cuda", "cuda", True), ("cpu", "cuda", False)):
                name = f"{kind}_{src}_to_{dst}" + ("" if seeded else "_without_seed")
                ta, sa = build(kind, src, 0)
                sa, _ = ta.train_step(sa, batch(kind, src))
                payload = ck.state_payload(ta, sa)
                if not seeded:
                    del payload["dropout_seed"]
                mngr = ck.CheckpointManager(os.path.join(tmp, name))
                mngr.save(0, payload)
                tb, sb = build(kind, dst, 5)
                seed = sa.dropout_seed if seeded else sb.dropout_seed
                sb, _ = mngr.restore(tb, sb)
                want = sa.dropout.get_state() if src == dst else torch.Generator(
                    device=dst).manual_seed(ck.dropout_reseed(seed, sa.step)).get_state()
                nets = [torch.equal(x.cpu(), y.cpu()) for na, nb in zip(ta.nets(), tb.nets())
                        for x, y in zip(na.state_dict().values(), nb.state_dict().values())]
                rec = {"generator_as_ruled": torch.equal(sb.dropout.get_state().cpu(),
                                                         want.cpu()),
                       "generator_device": sb.dropout.device.type,
                       "nets_bitwise": all(nets), "tensors": len(nets), "step": sb.step}
                sb, m = tb.train_step(sb, batch(kind, dst))
                rec["next_step_losses"] = {k: float(v) for k, v in m.items()}
                out[name] = rec
                if not (rec["generator_as_ruled"] and rec["nets_bitwise"] and rec["step"] == 1
                        and rec["generator_device"] == dst and sb.step == 2
                        and all(map(math.isfinite, rec["next_step_losses"].values()))):
                    raise AssertionError(f"ckpt_devices: {name}: {rec}")
                del ta, sa, tb, sb
    finally:
        import shutil

        shutil.rmtree(tmp, ignore_errors=True)
        torch.cuda.empty_cache()
    rec = {"phase": "ckpt_devices", "config": "resnet_2blocks, ngf 8, 32x32, batch 2, "
                                              "use_dropout, float32", "runs": out,
           "nvidia_smi": smi}
    emit(rec)
    return rec


def kernels_line(recs: dict, runs: dict, sup_recs: dict | None = None,
                 serve_full: dict | None = None, dp: dict | None = None,
                 spatial: dict | None = None, http_bench: dict | None = None) -> dict:
    """One entry per kernel of the train step: bf16 (the path's type), per
    call times summed over the calls of one train step at 256x256, batch 1;
    ``launches`` from the run (3 steps) of the path that runs the kernel
    (``runs``: path -> phase_train's or phase_train_supervised's result).
    ``on_paths``: the same numbers for each supervised path that runs the
    kernel, at its shapes (``sup_recs``: kernels_supervised's records), and
    for tiled + TTA serving (``serve_full``: phase_serve_full's result) at
    its largest window stack, per generator forward; ``dp``: rank 0's
    launches over the dp phase's 3 steps (phase_dp's result); ``max_abs_err``
    the largest over every shape held. ``spatial`` (phase_spatial's result)
    adds the slab entries of #1 and #2: launches of both entries over rank
    0's 3 steps of config 3 at spatial 2, times summed over the calls of one
    such step at its stem and trunk slab shapes, and their launches on the
    spatial_unet and spatial_eval paths; ``http_bench`` (phase_http_bench's
    result) the serving kernels' launches under the HTTP load bench."""
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
    # Each kernel's launches are its C entry's: the fused block's forward
    # convolutions (its VJP's recompute included), the dx chain's input
    # gradients, the weight gradients' cg_conv_dw (path B's conv_dw too).
    counter_of = {"instance_norm_act": "cg_instance_norm_act",
                  "instance_norm_act_bwd": "cg_instance_norm_act_bwd",
                  "residual_block_fused": "cg_conv3x3_reflect",
                  "residual_block_bwd_dx": "cg_conv3x3_reflect_dgrad",
                  "residual_block_bwd_dw": "cg_conv_dw",
                  "residual_block_chunked": "cg_chunked_in_fwd",
                  "residual_block_chunked_bwd": "cg_chunked_in_vjp",
                  "conv_dw": "cg_conv_dw", "conv3x3_reflect": "cg_conv3x3_reflect"}
    entries = []
    for name, (source, replaces) in meta.items():
        path = path_of.get(name, "default")
        rs = recs[name]

        def total(key):
            return sum(r[key] * r["calls_per_step"] for r in rs)

        on_paths = {}
        for sup_path, by_kernel in (sup_recs or {}).items():
            srs = [r for r in by_kernel.get(name, []) if r["calls_per_step"]]
            if not srs:
                continue

            def stotal(key, srs=srs):
                return sum(r[key] * r["calls_per_step"] for r in srs)

            on_paths[sup_path] = {
                "launches": runs[sup_path]["launches"].get(counter_of[name], 0),
                "max_abs_err": max(r["max_abs_err"] for r in srs), "ms": stotal("ms"),
                "plain_ms": stotal("plain_ms"), "bound_ms": stotal("bound_ms"),
                "library_ms": stotal("library_ms"),
                "shapes": sorted({str(r["shape"]) for r in srs}),
                "per": f"one train step ({SUP_PRESET}, {dict(SUP_PATHS[sup_path])}, 128x128, "
                       f"batch 2, bf16): {sum(r['calls_per_step'] for r in srs)} calls"}
        frs = (serve_full or {}).get("records", {}).get(name, [])
        if frs:
            n_win = frs[0]["shape"][0]
            on_paths["serve_full"] = {
                "launches": serve_full["launches"].get(counter_of[name], 0),
                "max_abs_err": max(r["max_abs_err"] for r in frs),
                **{k: sum(r[k] * r["calls_per_forward"] for r in frs)
                   for k in ("ms", "plain_ms", "bound_ms", "library_ms")},
                "shapes": [r["shape"] for r in frs],
                "per": f"one generator forward of a stack of {n_win} windows "
                       f"({TRAIN_PRESET}, {CROP}x{CROP} windows of a {SERVE_CANVAS}x"
                       f"{SERVE_CANVAS} canvas at scale {max(SERVE_SCALES)}, bf16): "
                       f"{sum(r['calls_per_forward'] for r in frs)} calls",
                "launches_over": f"run_serve of {N_IMAGES} images at batch {BATCH}, tiled, "
                                 f"flip, scales {list(SERVE_SCALES)}"}
        hb = (http_bench or {}).get("launches", {}).get(counter_of[name], 0)
        if hb:
            on_paths["http_bench"] = {
                "launches": hb,
                "launches_over": f"tools/torch_http_bench.py, {HTTP_BENCH['clients']} clients x "
                                 f"{HTTP_BENCH['requests']} requests, max_batch {BATCH}, and the "
                                 f"server's warm-up"}
        dp_launches = (dp or {}).get("launches", {}).get(counter_of[name], 0)
        if dp_launches:
            on_paths["dp"] = {"launches": dp_launches,
                              "launches_over": f"{DP_STEPS} train steps of rank 0 of 2 gloo "
                                               f"ranks ({TRAIN_PRESET}, global batch 2)"}
        every = rs + frs + [r for v in (sup_recs or {}).values() for r in v.get(name, [])]
        entries.append({
            "name": name, "route": "cuda", "source": source, "replaces": replaces,
            "launches": runs[path]["launches"].get(counter_of[name], 0),
            "max_abs_err": max(r["max_abs_err"] for r in every),
            "ms": total("ms"), "plain_ms": total("plain_ms"), "bound_ms": total("bound_ms"),
            "bound_by": max(rs, key=lambda r: r["bound_ms"] * r["calls_per_step"])["bound_by"],
            "library_ms": total("library_ms"),
            "per": f"one train step ({TRAIN_PRESET}, {CROP}x{CROP}, batch 1, bf16): "
                   f"{sum(r['calls_per_step'] for r in rs)} calls",
            "launches_over": f"{TRAIN_STEPS} train steps, path {path}", "on_paths": on_paths})
    slab_meta = {"instance_norm_act_slab": (*SLAB_COUNTERS[:2], 126),
                 "instance_norm_act_slab_bwd": (*SLAB_COUNTERS[2:], 146)}
    for name, (c1, c2, line) in slab_meta.items() if spatial else ():
        rs = spatial["records"][name]
        on_paths = {}
        for path, over in (("spatial_unet", f"{TRAIN_STEPS} train steps of rank 0 of "
                                            f"{SPATIAL_RANKS} ({SPATIAL_PRESET}, {UNET_GEN})"),
                           ("spatial_eval", f"--testing of rank 0 of {SPATIAL_RANKS} (tile, "
                                            f"flip, scales {SPATIAL_EVAL['eval_scales']})")):
            n = spatial[path.split("_")[1]]["launches"]
            if n.get(c1, 0) + n.get(c2, 0):
                on_paths[path] = {"launches": n.get(c1, 0) + n.get(c2, 0),
                                  "launches_over": f"{over}, both entries"}
        entries.append({
            "name": name, "route": "cuda", "source": "cyclegan_tpu_torch/csrc/instance_norm.cu",
            "replaces": f"cyclegan_tpu/kernels/instance_norm.py:{line}",
            "launches": spatial["launches"].get(c1, 0) + spatial["launches"].get(c2, 0),
            "max_abs_err": max(r["max_abs_err"] for r in rs),
            **{k: sum(r[k] * r["calls_per_step"] for r in rs)
               for k in ("ms", "plain_ms", "bound_ms", "library_ms")},
            "device_ms": sum(r["graph_us"] * r["calls_per_step"] for r in rs) / 1e3,
            "bound_by": max(rs, key=lambda r: r["bound_ms"] * r["calls_per_step"])["bound_by"],
            "per": f"one train step of {SPATIAL_PRESET} at spatial_shards {SPATIAL_RANKS} "
                   f"(bf16, batch 1), a rank's {sum(r['calls_per_step'] for r in rs)} calls "
                   f"at its stem and trunk slabs (partials + apply, eager; device_ms: the "
                   f"same as CUDA-graph replays; library: var_mean of the slab, the merge "
                   f"with the other slab's partials, normalise + act, and its autograd VJP)",
            "launches_over": f"{TRAIN_STEPS} train steps of rank 0 of {SPATIAL_RANKS}, both "
                             f"entries", "on_paths": on_paths})
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
        http_bench = phase_http_bench(served, smi)
        del served
    recs = phase_kernels_train()
    runs = {path: phase_train(smi, path) for path in TRAIN_PATHS}
    emit({"phase": "graph_capture", "instance_norm": in_graph_capture(),
          "chunked_block": chunked_graph_capture()})
    phase_cli(smi)
    phase_ckpt_devices(smi)
    sup_recs = phase_kernels_supervised()
    t_sup = time.perf_counter()
    runs.update((path, phase_train_supervised(smi, path)) for path in SUP_PATHS)
    phase_remat(smi)
    phase_cli_supervised(smi)
    t_serve = time.perf_counter()
    with tempfile.TemporaryDirectory() as tmp:
        serve_full = phase_serve_full(tmp, smi)
    t_dp = time.perf_counter()
    dp = phase_dp(smi)
    t_configs = time.perf_counter()
    configs = phase_configs(smi)
    t_spatial = time.perf_counter()
    spatial = phase_spatial(smi, configs)
    emit({"phase": "done", "seconds": time.perf_counter() - t0,
          "supervised_phases_seconds": t_serve - t_sup,
          "serve_full_seconds": t_dp - t_serve, "dp_seconds": t_configs - t_dp,
          "configs_seconds": t_spatial - t_configs,
          "spatial_seconds": time.perf_counter() - t_spatial})
    print(smi, flush=True)
    emit(kernels_line(recs, runs, sup_recs, serve_full, dp, spatial, http_bench))
    emit({"ok": True, "device": {"platform": "gpu", "kind": torch.cuda.get_device_name(0),
                                 "count": torch.cuda.device_count()}})
    return 0


if __name__ == "__main__":
    sys.exit(main())
