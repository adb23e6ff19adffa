"""Training and evaluation loops (reference ``model.py .train()``).

Counterpart of ``cyclegan_tpu/train/runner.py``: the epoch loop with
per-step logging (steps/s), per-epoch validation, sample dumps, epoch,
mid-epoch and best checkpoints, preemption (SIGTERM, or
``CYCLEGAN_TPU_PREEMPT_AT_STEP``) with exact resume, and ``run_test``.

The loop never waits on the card for a step's result: metrics are read one
log interval late, and the next two batches are copied to the device
(pinned host memory, ``non_blocking``) while the current step runs.

``run_supervised`` trains the supervised segmenter (configuration 1),
``run_cyclegan`` the semi-supervised CycleGAN (configurations 2-4); both
evaluate with ``--eval_resize tile`` and the ``--eval_flip`` /
``--eval_scales`` TTA when asked (``eval_tile.py``, ``tta.py``).

Data and spatial parallelism (``parallel/``): each rank runs these loops
on its device with a (data, spatial)
:class:`~cyclegan_tpu_torch.parallel.mesh.Mesh`. Its loaders build only
its rows of every global batch, cut to its H slab under a spatial axis
(``--spatial_shards s``: ``--num_devices k`` ranks are k / s data rows of
s slabs each), the trainers make the step the global batch's, evaluation
predicts on slabs and sums the ranks' confusion matrices (the ragged last
batch padded with masked rows), the primary rank alone writes checkpoints,
sample dumps and logs (barriers after each save; the pools' and the dumps'
slabs gathered first), every rank restores, and a preemption is agreed by
all ranks at the save boundaries. Under a spatial axis the tiled and
multi-scale evaluations gather each canvas over the spatial group and run
the network on every rank's slab of each window stack or rescaled canvas
(``parallel.spatial.on_canvas_slabs`` / ``whole_from_slabs``). The XLA
machinery of the JAX runner (``_aligned_jit``) has no counterpart.

Divergences from the JAX runner, on purpose:
- a run cut by ``--max_steps`` inside an epoch saves a mid-epoch checkpoint
  that holds its position, never the epoch checkpoint (the JAX runner saves
  the cut epoch as complete), and a relaunch resumes it; mid-epoch
  checkpoints are therefore looked for on every launch;
- the logged ``step`` is the optimizer step of the run (it goes on counting
  across a resume), not the step of this launch.
"""

from __future__ import annotations

import collections
import itertools
import json
import os
import signal
import threading
import time
from typing import Any, Callable, Iterator

import numpy as np
import torch

from cyclegan_tpu_torch import eval_tile, tta
from cyclegan_tpu_torch.data.datasets import DATASET_SPECS, class_names, make_dataset, split_labeled
from cyclegan_tpu_torch.data.loader import Loader, paired_iterator, paired_steps_per_epoch
from cyclegan_tpu_torch.data.palette import save_prediction_png
from cyclegan_tpu_torch.export import resolve_device
from cyclegan_tpu_torch.parallel import distributed
from cyclegan_tpu_torch.parallel import spatial as spatial_lib
from cyclegan_tpu_torch.parallel.mesh import (Mesh, all_reduce_sum, gather_slab, make_mesh,
                                              replicate_state, select_step)
from cyclegan_tpu_torch.train import checkpoint as checkpoint_lib
from cyclegan_tpu_torch.train import metrics as metrics_lib
from cyclegan_tpu_torch.train.checkpoint import CheckpointManager, load_state, state_payload
from cyclegan_tpu_torch.train.cyclegan import CycleGANTrainer
from cyclegan_tpu_torch.train.supervised import SupervisedTrainer
from cyclegan_tpu_torch.utils.config import Config
from cyclegan_tpu_torch.utils.observability import MetricsLogger, StepProfiler, enable_debug_flags
from cyclegan_tpu_torch.utils.pipeline import InferencePipeline

# The keys of a mid-epoch checkpoint, oldest format first: v1 {state,
# epoch, pos, gstep}, v2 adds spc, v3 (current) adds ga.
MID_KEYS = ("state", "epoch", "pos", "gstep", "spc", "ga")
PREFETCH_DEPTH = 2


def _dataset_spec(cfg: Config) -> tuple[int, int]:
    num_classes, in_ch, _ = DATASET_SPECS[cfg.dataset]
    return num_classes, in_ch


def check_mesh_config(cfg: Config) -> None:
    """What the spatial axis (``spatial_shards`` s > 1) takes, checked
    before any rank starts: s must divide ``num_devices``; the crop's H
    must divide into s slabs of a multiple of 4 rows, so that every plane
    of the ResNet generators splits evenly (the JAX package needs only
    H % s); a tile canvas's H must
    divide into s equal slabs. The windows and rescaled canvases of the
    evaluations need no rule (their rows follow the ceil rule of
    ``parallel.spatial.slab`` at every layer)."""
    s = cfg.spatial_shards
    if s < 1:
        raise ValueError(f"spatial_shards={s}: at least 1")
    if s == 1:
        return
    if cfg.num_devices is not None and cfg.num_devices % s:
        raise ValueError(f"num_devices={cfg.num_devices} not divisible by spatial_shards={s}")
    if cfg.crop_height % (4 * s):
        raise ValueError(
            f"crop_height={cfg.crop_height} must divide by 4 * spatial_shards = {4 * s}: each "
            f"rank's H slab must stay a whole number of rows through the generators' two "
            f"stride-2 convolutions")
    if cfg.eval_resize == "tile" and cfg.resize_height and cfg.resize_height % s:
        raise ValueError(f"tile canvas height {cfg.resize_height} must divide by "
                         f"spatial_shards={s}: each rank loads an equal slab of it")


def _mesh(cfg: Config, device) -> Mesh:
    """This rank's (data, spatial) mesh: the process group brought up when
    the config or the environment asks for one (a group already up is
    used), checked against ``num_devices`` and ``spatial_shards``."""
    check_mesh_config(cfg)
    device = resolve_device(device)  # no card raises here, before any group
    distributed.maybe_initialize(cfg, device)
    return make_mesh(cfg.num_devices, spatial=cfg.spatial_shards, device=device)


def _stacking(cfg: Config) -> tuple[int, int]:
    """(host batches per device call, optimizer steps per device call).

    ``steps_per_call`` stacks K batches for K chained updates;
    ``grad_accum`` stacks K microbatches for ONE update. Mutually
    exclusive."""
    spc = max(int(cfg.steps_per_call or 1), 1)
    ga = max(int(cfg.grad_accum or 1), 1)
    if spc > 1 and ga > 1:
        raise ValueError(f"--steps_per_call {spc} and --grad_accum {ga} are mutually "
                         f"exclusive (both consume the leading batch-stack axis)")
    return spc * ga, (spc if ga == 1 else 1)


def _effective_steps_per_epoch(cfg: Config, steps_per_epoch: int) -> int:
    """Optimizer steps an epoch takes. A batch stack drops the epoch's tail
    that does not fill a stack, and the LR staircase must count what is
    taken; with grad_accum, K host batches make ONE optimizer step."""
    stack, opt_per_call = _stacking(cfg)
    if stack <= 1:
        return steps_per_epoch
    if steps_per_epoch < stack:
        raise ValueError(
            f"the {stack}-batch stack (steps_per_call/grad_accum) exceeds the epoch length "
            f"({steps_per_epoch} steps) — every batch would land in the dropped tail and "
            f"training would silently do nothing; lower --steps_per_call/--grad_accum or "
            f"--batch_size")
    return (steps_per_epoch // stack) * opt_per_call


def _eval_shaping(cfg: Config) -> tuple[tuple[int, int], str]:
    """(target_hw, loader eval_mode) of the val/test loaders. ``--eval_resize
    tile`` scores a fixed canvas (``--resize_height/--resize_width``) tiled
    by crop-size windows: the loader squash-resizes to the canvas and the
    eval functions tile it."""
    if cfg.eval_resize != "tile":
        return cfg.crop_hw, cfg.eval_resize
    if not (cfg.resize_height and cfg.resize_width):
        raise ValueError("--eval_resize tile needs --resize_height/--resize_width "
                         "(the fixed canvas the val images are scored at)")
    if cfg.resize_height < cfg.crop_height or cfg.resize_width < cfg.crop_width:
        raise ValueError(f"tile canvas {cfg.resize_height}x{cfg.resize_width} is smaller "
                         f"than the window {cfg.crop_height}x{cfg.crop_width}")
    if cfg.resize_height % 4 or cfg.resize_width % 4:
        # The l2i sample-dump generator runs on the whole canvas; the
        # generators' down/up pair only round-trips shapes divisible by 4.
        raise ValueError(f"tile canvas {cfg.resize_height}x{cfg.resize_width} must be "
                         f"divisible by 4")
    return (cfg.resize_height, cfg.resize_width), "resize"


def _make_eval_fns(cfg: Config, trainer) -> tuple[Callable, Callable]:
    """(eval_fn(batch) -> confusion matrix, predict(image) -> class map),
    class maps as uint8 when the classes fit (a quarter of the bytes to
    fetch). ``--eval_resize tile``, ``--eval_flip`` and ``--eval_scales``
    wrap the canvas-level logits in the JAX runner's order: the tiling
    innermost (a mirrored or rescaled canvas is tiled again), the flip
    inside the scaling (the average runs over scales x mirror). Without
    them the trainer's own eval step and predict run.

    Under a spatial axis, tiles and scales move rows across the slabs: the
    composition runs on the whole canvas, gathered on every rank, with the
    network run on each rank's slab of every window stack or rescaled
    canvas and its logits gathered; each rank keeps its rows of the
    result. The flip alone stays on the slabs (it mirrors W)."""
    _eval_shaping(cfg)
    scales = tta.parse_scales(cfg.eval_scales)
    sp = spatial_lib.from_mesh(trainer.mesh)
    across = sp is not None and (cfg.eval_resize == "tile" or bool(scales))
    net = spatial_lib.whole_from_slabs(trainer.logits, sp) if across else trainer.logits
    canvas_logits = None
    if cfg.eval_resize == "tile":
        def canvas_logits(image: torch.Tensor) -> torch.Tensor:
            return eval_tile.tiled_logits(net, image, cfg.crop_hw)
    if cfg.eval_flip:
        canvas_logits = tta.flip_avg(canvas_logits or net)
    if scales and cfg.eval_resize == "tile":
        # At set-up, not at the first validation (after a training epoch).
        tta.validate_tile_scales((cfg.resize_height, cfg.resize_width), cfg.crop_hw, scales)
    if scales:
        canvas_logits = tta.scale_avg(canvas_logits or net, scales)
    if across:
        canvas_logits = spatial_lib.on_canvas_slabs(canvas_logits, sp)

    def u8(pred: torch.Tensor) -> torch.Tensor:
        return pred.to(torch.uint8) if trainer.num_classes <= 255 else pred

    if canvas_logits is None:
        return trainer.eval_step, lambda image: u8(trainer.predict(image))

    @torch.no_grad()
    def eval_fn(batch: dict) -> torch.Tensor:
        pred = canvas_logits(batch["image"]).argmax(-1)
        return metrics_lib.confusion_matrix(pred, batch["label"], trainer.num_classes,
                                            ignore_index=trainer.ignore_index)

    @torch.no_grad()
    def predict(image: torch.Tensor) -> torch.Tensor:
        return u8(canvas_logits(image).argmax(-1))

    return eval_fn, predict


def _make_loader(cfg: Config, ds, *, train: bool, seed: int, mesh: Mesh,
                 drop_last: bool = True):
    """The native loader (a prefetch thread and the native pixel library)
    or, with ``--loader grain``, the worker-process loader; it builds this
    rank's rows of every global batch."""
    resize_hw = None
    if train and cfg.resize_height is not None:
        resize_hw = (cfg.resize_height, cfg.resize_width or cfg.resize_height)
    target_hw, eval_mode = (cfg.crop_hw, "resize") if train else _eval_shaping(cfg)
    kw = dict(batch_size=cfg.batch_size, crop_hw=target_hw, train=train, seed=seed,
              drop_last=drop_last, resize_hw=resize_hw, eval_mode=eval_mode,
              process_shard=(mesh.data_index, mesh.dp),
              spatial_shard=(mesh.spatial_index, mesh.spatial))
    if cfg.loader == "grain":
        from cyclegan_tpu_torch.data.grain_loader import GrainLoader

        return GrainLoader(ds, num_workers=cfg.loader_workers, **kw)
    if cfg.loader != "native":
        raise ValueError(f"unknown loader {cfg.loader!r} (native|grain)")
    return Loader(ds, **kw)


def to_device(batch: dict, device: torch.device) -> dict:
    """numpy batch -> tensors on ``device``: integer arrays as int64 (the
    labels the step's one-hot and CE take), copied from pinned memory
    without waiting when the device is a card."""
    out = {}
    for k, v in batch.items():
        t = torch.from_numpy(np.ascontiguousarray(v))
        if not t.is_floating_point() and t.dtype != torch.bool:
            t = t.long()
        if device.type == "cuda":
            t = t.pin_memory().to(device, non_blocking=True)
        out[k] = t
    return out


def _global_hist(hist: torch.Tensor | None, mesh: Mesh, num_classes: int,
                 device) -> torch.Tensor | None:
    """The confusion matrix of the whole split: the ranks' matrices summed
    (None where no rank saw a label)."""
    if mesh.world == 1:
        return hist
    local = torch.zeros((num_classes + 1, num_classes), dtype=torch.int64, device=device)
    if hist is not None:
        local[:num_classes] = hist
        local[num_classes, 0] = 1
    total = all_reduce_sum(local, mesh)
    return total[:num_classes] if int(total[num_classes, 0]) else None


def _evaluate(trainer, val_loader, eval_fn) -> dict:
    """Accumulate the confusion matrix over the val split on the device
    (this rank's rows; the ranks' matrices are summed)."""
    hist = None
    it = val_loader.epoch(0)
    try:
        for batch in it:
            if "label" not in batch:
                continue
            h = eval_fn(to_device(batch, trainer.device))
            hist = h if hist is None else hist + h
    finally:
        it.close()
    hist = _global_hist(hist, trainer.mesh, trainer.num_classes, trainer.device)
    if hist is None:
        return {}
    return {k: float(v) for k, v in metrics_lib.scores(hist.cpu()).items() if v.ndim == 0}


def _restore_mid(mid_ckpt: CheckpointManager, spc: int) -> dict | None:
    """The newest mid-epoch checkpoint as stored (its ``state`` not loaded
    anywhere yet), with its format read from its stored keys: v1 and v2
    lack ``spc`` (then this run's) and ``ga`` (then 1). Keys this version
    does not know (a newer format) refuse; errors of reading the file
    propagate as themselves."""
    step = mid_ckpt.latest_epoch()
    if step is None:
        return None
    keys = mid_ckpt.stored_keys(step)
    if keys is not None:
        unknown = keys - set(MID_KEYS)
        if unknown:
            raise ValueError(f"mid-epoch checkpoint step {step} stores unknown keys "
                             f"{sorted(unknown)} — written by a newer version of this "
                             f"framework? (known: {sorted(MID_KEYS)})")
    try:
        w, _ = mid_ckpt.restore(epoch=step)
    except Exception as e:
        if keys is None:
            e.add_note("mid-checkpoint metadata was missing, so the current format was "
                       "assumed; delete the mid/ directory to restart the epoch")
        raise
    w.setdefault("spc", spc)
    w.setdefault("ga", 1)
    return w


def _train_loop(cfg: Config, trainer, state, batches_of_epoch: Callable[[int], Iterator[dict]],
                val_loader, *, calls_per_epoch: int, max_steps: int | None,
                on_validate=None) -> dict:
    """The epoch loop shared by the trainers: steps, logging, profiling,
    validation, checkpoints and resume. Returns the last validation's
    scores, ``preempted`` when preempted, and ``seconds`` (``train``: the
    step loop, ``input_wait``: of it, the time the loop waited for its next
    device batch, ``validation``: the val passes)."""
    enable_debug_flags(cfg.debug_nans)
    stack, opt_per_call = _stacking(cfg)
    spc = max(int(cfg.steps_per_call or 1), 1)
    ga = max(int(cfg.grad_accum or 1), 1)
    step_fn = select_step(trainer, spc, ga)
    eval_fn, _ = _make_eval_fns(cfg, trainer)
    device, mesh = trainer.device, trainer.mesh
    primary = mesh.rank == 0
    say = print if primary else (lambda *a, **k: None)
    logger = MetricsLogger(cfg.results_dir)
    profiler = StepProfiler(cfg.profile_dir)

    ckpt = CheckpointManager(cfg.checkpoint_dir)
    start_epoch = 0
    restored = ckpt.restore(trainer, state)
    if restored is not None:
        state, start_epoch = restored
        say(f"resumed from epoch {start_epoch - 1}", flush=True)

    # Mid-epoch checkpoints {state, epoch, pos, gstep, spc, ga} under
    # <checkpoint_dir>/mid: every `save_every_steps` steps, on preemption,
    # and when --max_steps cuts an epoch. `pos` counts device calls of the
    # epoch; the loader's per-(seed, epoch, position) draws make the
    # resumed suffix equal to an uninterrupted run's.
    mid_every = max(int(cfg.save_every_steps or 0), 0)
    mid_ckpt = CheckpointManager(os.path.join(cfg.checkpoint_dir, "mid"), max_to_keep=1)
    skip_calls = 0

    def _wrap(epoch: int, pos: int, gstep: int) -> dict:
        return {"state": state_payload(trainer, state), "epoch": epoch, "pos": pos,
                "gstep": gstep, "spc": spc, "ga": ga}

    w = _restore_mid(mid_ckpt, spc)
    # A mid checkpoint older than the last epoch save is stale: its epoch
    # completed. It is checked before anything is loaded.
    if w is not None and int(w["epoch"]) >= start_epoch:
        if int(w["spc"]) != spc or int(w["ga"]) != ga:
            raise ValueError(
                f"mid-epoch checkpoint in {cfg.checkpoint_dir}/mid was written with "
                f"--steps_per_call {int(w['spc'])} --grad_accum {int(w['ga'])} but this run "
                f"uses {spc}/{ga}; its position is stored in device-call units — relaunch "
                f"with the writer's values (or delete the mid/ dir to restart the epoch)")
        state = load_state(trainer, state, w["state"])
        start_epoch, skip_calls = int(w["epoch"]), int(w["pos"])
        say(f"resumed mid-epoch {start_epoch} at call {skip_calls}", flush=True)
    del w
    # Every rank has read what it resumes from before the primary writes.
    distributed.phase_barrier("restored")

    # Best-val-mIoU checkpoint under <checkpoint_dir>/best; its score in
    # best_metric.json beside it, so a resumed run cannot overwrite a
    # better epoch.
    best_ckpt = None
    best_miou = -1.0
    best_metric_path = os.path.join(cfg.checkpoint_dir, "best_metric.json")
    if cfg.keep_best:
        best_ckpt = CheckpointManager(os.path.join(cfg.checkpoint_dir, "best"), max_to_keep=1)
        if os.path.exists(best_metric_path):
            with open(best_metric_path) as f:
                best_miou = float(json.load(f).get("miou", -1.0))

    gstep0 = int(state.step)
    last_mid = gstep0
    preempt = threading.Event()
    prev_handler: Any = None
    if mid_every and threading.current_thread() is threading.main_thread():
        prev_handler = signal.signal(signal.SIGTERM, lambda *_: preempt.set())
    preempt_at = int(os.environ.get("CYCLEGAN_TPU_PREEMPT_AT_STEP", "0") or 0)

    def agreed_preempt() -> bool:
        """Does any rank stop? Asked of every rank at the same save
        boundary (a SIGTERM reaches each rank at its own time)."""
        flag = torch.tensor([int(preempt.is_set())], device=device)
        return bool(int(all_reduce_sum(flag, mesh)))

    def save(mngr: CheckpointManager, step: int, payload: Callable[[], dict]) -> None:
        """Write on the primary (only it builds the payload's host copies,
        except under a spatial axis, where every rank gathers the pools'
        slabs); the ranks go on when the file is whole."""
        if primary or mesh.spatial > 1:
            built = payload()
            if primary:
                mngr.save(step, built)
        distributed.phase_barrier("save")

    def stacked(gen):
        """Group K consecutive host batches into one leading-K stack; a
        tail of fewer than K is dropped."""
        buf = []
        for b in gen:
            buf.append(b)
            if len(buf) == stack:
                yield {k: np.stack([x[k] for x in buf]) for k in buf[0]}
                buf = []

    def device_batches(epoch: int, skip: int) -> Iterator[dict]:
        """The epoch's device calls, PREFETCH_DEPTH of them in flight; the
        first ``skip`` (already trained before a resume) are dropped on the
        host, before any copy."""
        gen = batches_of_epoch(epoch)
        try:
            calls = stacked(gen) if stack > 1 else gen
            q: collections.deque = collections.deque()
            for b in itertools.islice(calls, skip, None):
                q.append(to_device(b, device))
                if len(q) >= PREFETCH_DEPTH:
                    yield q.popleft()
            while q:
                yield q.popleft()
        finally:
            gen.close()

    result: dict = {}
    seconds = {"train": 0.0, "input_wait": 0.0, "validation": 0.0}
    total_steps = 0
    stop = preempted = False
    # Metrics are logged one interval late: a log step queues its metrics
    # (device tensors) and prints the previous log step's, long computed.
    pending: tuple | None = None

    def flush_pending():
        nonlocal pending
        if pending is not None:
            kw, dev_m = pending
            logger.log(metrics=dev_m, **kw)
            pending = None

    try:
        for epoch in range(start_epoch, cfg.epochs):
            epoch_base = skip_calls if epoch == start_epoch else 0
            t0, n, calls = time.perf_counter(), 0, 0
            batches = device_batches(epoch, epoch_base)
            try:
                while True:
                    tw = time.perf_counter()
                    batch = next(batches, None)
                    seconds["input_wait"] += time.perf_counter() - tw
                    if batch is None:
                        break
                    profiler.maybe_start(total_steps)
                    state, m = step_fn(state, batch)
                    n += opt_per_call
                    calls += 1
                    total_steps += opt_per_call
                    profiler.maybe_stop(total_steps)
                    gstep = gstep0 + total_steps
                    if calls % max(cfg.log_every // opt_per_call, 1) == 0:
                        sps = n / (time.perf_counter() - t0)
                        flush_pending()
                        pending = (dict(step=gstep, epoch=epoch, steps_per_sec=sps), m)
                    if max_steps is not None and total_steps >= max_steps:
                        stop = True
                        break
                    if mid_every:
                        if preempt_at and gstep >= preempt_at:
                            preempt.set()
                        boundary = gstep - last_mid >= mid_every
                        if mesh.world == 1:
                            preempted = preempt.is_set()
                        elif boundary:
                            preempted = agreed_preempt()
                        if boundary or preempted:
                            save(mid_ckpt, gstep,
                                 lambda: _wrap(epoch, epoch_base + calls, gstep))
                            last_mid = gstep
                        if preempted:
                            break
            finally:
                batches.close()
                seconds["train"] += time.perf_counter() - t0
            pos = epoch_base + calls
            if preempted:
                # The epoch is incomplete: no epoch checkpoint (a resume
                # would skip the rest of its data); the mid checkpoint just
                # saved holds the position.
                say(f"[preempt] saved mid-epoch checkpoint at step {last_mid}; exiting",
                    flush=True)
                break
            if stop and pos < calls_per_epoch:
                gstep = gstep0 + total_steps
                save(mid_ckpt, gstep, lambda: _wrap(epoch, pos, gstep))
                say(f"[max_steps] stopped in epoch {epoch} at call {pos} of "
                    f"{calls_per_epoch}; saved a mid-epoch checkpoint at step {gstep}",
                    flush=True)
                break
            if cfg.validation_every > 0 and (epoch + 1) % cfg.validation_every == 0:
                tv = time.perf_counter()
                result = _evaluate(trainer, val_loader, eval_fn)
                seconds["validation"] += time.perf_counter() - tv
                say(f"[epoch {epoch}] val {result}", flush=True)
                if best_ckpt is not None and result.get("miou", -1.0) > best_miou:
                    best_miou = float(result["miou"])
                    save(best_ckpt, epoch, lambda: state_payload(trainer, state))
                    if primary:
                        with open(best_metric_path, "w") as f:
                            json.dump({"miou": best_miou, "epoch": epoch}, f)
                    say(f"[epoch {epoch}] new best miou {best_miou:.4f} -> best/", flush=True)
                if on_validate is not None and (primary or mesh.spatial > 1):
                    on_validate(state, epoch)  # a slab's forward needs its whole group
            save(ckpt, epoch, lambda: state_payload(trainer, state))
            if stop:
                break
        flush_pending()
    finally:
        # Also on errors: the replaced SIGTERM handler must not outlive the loop.
        if prev_handler is not None:
            signal.signal(signal.SIGTERM, prev_handler)
        profiler.finish()
        logger.close()
        for mngr in (ckpt, mid_ckpt, best_ckpt):
            if mngr is not None:
                mngr.wait()
                mngr.close()
    if preempted:
        result = dict(result, preempted=True)
    return dict(result, seconds=seconds)


def run_supervised(cfg: Config, *, max_steps: int | None = None, device=None) -> dict:
    """The supervised segmentation run (configuration 1) on ``device``
    (default the CUDA device): one generator trained on the labeled train
    split with pixel cross-entropy, validated every ``validation_every``
    epochs."""
    mesh = _mesh(cfg, device)
    num_classes, in_ch = _dataset_spec(cfg)
    train_ds = make_dataset(cfg.dataset, cfg.data_root, split="train", size=cfg.dataset_size)
    val_ds = make_dataset(cfg.dataset, cfg.data_root, split="val")
    train_loader = _make_loader(cfg, train_ds, train=True, seed=cfg.seed, mesh=mesh)
    val_loader = _make_loader(cfg, val_ds, train=False, seed=0, drop_last=False, mesh=mesh)
    steps_per_epoch = train_loader.steps_per_epoch()
    if steps_per_epoch == 0:
        raise ValueError(f"empty epoch: {len(train_ds)} training images < batch_size "
                         f"{cfg.batch_size} — lower batch_size or raise dataset_size")
    trainer = SupervisedTrainer(cfg, num_classes, in_ch,
                                _effective_steps_per_epoch(cfg, steps_per_epoch), mesh=mesh)
    state = replicate_state(trainer, trainer.init_state(torch.Generator().manual_seed(cfg.seed)),
                            mesh)
    return _train_loop(cfg, trainer, state, train_loader.epoch, val_loader,
                       calls_per_epoch=steps_per_epoch // _stacking(cfg)[0],
                       max_steps=max_steps)


def run_cyclegan(cfg: Config, *, max_steps: int | None = None, device=None) -> dict:
    """The semi-supervised CycleGAN run (configurations 2-4) on ``device``
    (default the CUDA device)."""
    mesh = _mesh(cfg, device)
    num_classes, in_ch = _dataset_spec(cfg)
    train_ds = make_dataset(cfg.dataset, cfg.data_root, split="train", size=cfg.dataset_size)
    lab_ds, unlab_ds = split_labeled(train_ds, cfg.labeled_fraction, cfg.seed)
    val_ds = make_dataset(cfg.dataset, cfg.data_root, split="val")
    lab_loader = _make_loader(cfg, lab_ds, train=True, seed=cfg.seed, mesh=mesh)
    unlab_loader = _make_loader(cfg, unlab_ds, train=True, seed=cfg.seed + 1, mesh=mesh)
    val_loader = _make_loader(cfg, val_ds, train=False, seed=0, drop_last=False, mesh=mesh)
    steps_per_epoch = paired_steps_per_epoch(lab_loader, unlab_loader, cfg.pairing)
    if steps_per_epoch == 0:
        raise ValueError(f"empty paired epoch: labeled split has "
                         f"{lab_loader.steps_per_epoch()} batches of size {cfg.batch_size} "
                         f"— lower batch_size, raise labeled_fraction, or use --pairing cycle")
    trainer = CycleGANTrainer(cfg, num_classes, in_ch,
                              _effective_steps_per_epoch(cfg, steps_per_epoch), mesh=mesh)
    _, predict = _make_eval_fns(cfg, trainer)
    state = replicate_state(trainer, trainer.init_state(torch.Generator().manual_seed(cfg.seed)),
                            mesh)

    def batches(epoch: int) -> Iterator[dict]:
        pairs = paired_iterator(lab_loader, unlab_loader, epoch, mode=cfg.pairing)
        try:
            for lab_batch, unlab_batch in pairs:
                yield {"lab_image": lab_batch["image"], "lab_label": lab_batch["label"],
                       "unlab_image": unlab_batch["image"]}
        finally:
            pairs.close()

    return _train_loop(
        cfg, trainer, state, batches, val_loader,
        calls_per_epoch=steps_per_epoch // _stacking(cfg)[0], max_steps=max_steps,
        on_validate=lambda s, e: _dump_samples(cfg, trainer, val_loader, e, predict=predict))


def _dump_samples(cfg: Config, trainer: CycleGANTrainer, val_loader, epoch: int, n: int = 4,
                  predict=None) -> None:
    """Sample dumps: the input image, the coloured ground truth and
    prediction, and the label->image generator's synthesis. Under a
    spatial axis every rank runs the forwards on its slab and the slabs are
    gathered; the primary writes."""
    from PIL import Image

    mesh = trainer.mesh
    # One batch; the epoch generator is closed here so its thread stops now.
    it = val_loader.epoch(0)
    try:
        batch = next(it)
    finally:
        it.close()
    if predict is None:
        _, predict = _make_eval_fns(cfg, trainer)
    dev = to_device({k: v[:n] for k, v in batch.items()}, trainer.device)
    pred = gather_slab(predict(dev["image"]), mesh)
    gen = None
    if "label" in batch:
        gen = gather_slab(trainer.generate_image(dev["label"]).float(), mesh).cpu().numpy()
    batch = {k: gather_slab(v, mesh).cpu().numpy() for k, v in dev.items()}
    if mesh.rank != 0:
        return
    imgs, pred = batch["image"], pred.cpu().numpy()
    os.makedirs(cfg.results_dir, exist_ok=True)

    def to_u8(x):  # [-1, 1] float -> uint8 RGB or gray
        u = np.clip((np.asarray(x) + 1.0) * 127.5, 0, 255).astype(np.uint8)
        return u[..., 0] if u.shape[-1] == 1 else u

    if gen is not None:
        gen = to_u8(gen)
    for i in range(min(n, pred.shape[0])):
        stem = os.path.join(cfg.results_dir, f"epoch{epoch}_sample{i}")
        Image.fromarray(to_u8(imgs[i])).save(f"{stem}_input.png")
        save_prediction_png(pred[i].astype(np.uint8), f"{stem}_pred.png")
        if "label" in batch:
            save_prediction_png(batch["label"][i].astype(np.uint8), f"{stem}_gt.png")
        if gen is not None:
            Image.fromarray(gen[i]).save(f"{stem}_generated.png")


def run_test(cfg: Config, *, semisupervised: bool = True, device=None) -> dict:
    """Restore the newest checkpoint, predict the val split, write its
    palette PNGs to ``results_dir`` and report mIoU, pixel accuracy and the
    per-class IoU (and the ``confusion`` matrix, as lists of ints). One
    forward a batch gives both the PNGs and the scores;
    batch k+1 is enqueued before batch k is fetched (InferencePipeline).
    Under a data mesh each rank predicts and writes its rows of every batch
    and the scores are the summed confusion matrix's; under a spatial axis
    each rank predicts its slab, the slabs are gathered, and the first rank
    of each spatial group writes its rows."""
    mesh = _mesh(cfg, device)
    target_hw, eval_mode = _eval_shaping(cfg)
    trainer, _, num_classes, _ = checkpoint_lib.restore_for_inference(
        cfg, semisupervised=semisupervised, device=mesh.device, mesh=mesh)
    _, predict = _make_eval_fns(cfg, trainer)
    val_ds = make_dataset(cfg.dataset, cfg.data_root, split="val")
    val_loader = Loader(val_ds, batch_size=cfg.batch_size, crop_hw=target_hw, train=False,
                        drop_last=False, eval_mode=eval_mode,
                        process_shard=(mesh.data_index, mesh.dp),
                        spatial_shard=(mesh.spatial_index, mesh.spatial))
    os.makedirs(cfg.results_dir, exist_ok=True)
    hist = None
    rows = cfg.batch_size // mesh.dp
    n_total = len(val_ds)

    def consume(k: int, pred: np.ndarray) -> None:
        if mesh.spatial_index:
            return  # the group's first rank writes the gathered maps
        first = k * cfg.batch_size + mesh.data_index * rows  # global index of row 0
        for j, p in enumerate(pred):
            if first + j >= n_total:
                break  # padding rows of the last batch
            save_prediction_png(p.astype(np.uint8),
                                os.path.join(cfg.results_dir, f"pred_{first + j:05d}.png"))

    pipe = InferencePipeline(consume)
    it = val_loader.epoch(0)
    try:
        for k, batch in enumerate(it):
            dev = to_device(batch, trainer.device)
            pred = predict(dev["image"])
            pipe.put(k, gather_slab(pred, mesh))
            if "label" in dev:
                h = metrics_lib.confusion_matrix(pred, dev["label"], num_classes,
                                                 ignore_index=trainer.ignore_index)
                hist = h if hist is None else hist + h
    finally:
        it.close()
    pipe.flush()
    hist = _global_hist(hist, mesh, num_classes, trainer.device)
    out: dict = {}
    if hist is not None:
        s = metrics_lib.scores(hist.cpu())
        out = {k: float(v) for k, v in s.items() if v.ndim == 0}
        names = class_names(cfg.dataset, num_classes)
        out["per_class_iou"] = {nm: float(v) for nm, v in zip(names, s["per_class_iou"])}
        out["confusion"] = hist.cpu().tolist()
        if mesh.rank == 0:
            print(f"test scores: "
                  f"{ {k: v for k, v in out.items() if k not in ('per_class_iou', 'confusion')} }",
                  flush=True)
            for nm, v in out["per_class_iou"].items():
                print(f"  iou[{nm}]: {v:.4f}", flush=True)
    distributed.phase_barrier("test")  # every rank's PNGs are written
    return out
