"""Training and evaluation loops (reference ``model.py .train()``).

Counterpart of ``cyclegan_tpu/train/runner.py``: the epoch loop with
per-step logging (steps/s), per-epoch validation, sample dumps, epoch,
mid-epoch and best checkpoints, preemption (SIGTERM, or
``CYCLEGAN_TPU_PREEMPT_AT_STEP``) with exact resume, and ``run_test``.

The loop never waits on the card for a step's result: metrics are read one
log interval late, and the next two batches are copied to the device
(pinned host memory, ``non_blocking``) while the current step runs.

What the port does not run yet raises ``NotImplementedError`` naming the
ROADMAP Queue 1 item that brings it: ``--model supervised`` (item 6),
``--eval_resize tile``, ``--eval_flip`` and ``--eval_scales`` (item 8), and
more than one device, spatial shards or processes (item 11). The XLA and
gloo machinery of the JAX runner (``_aligned_jit``, the phase barriers) has
no counterpart.

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

from cyclegan_tpu_torch.data.datasets import DATASET_SPECS, class_names, make_dataset, split_labeled
from cyclegan_tpu_torch.data.loader import Loader, paired_iterator, paired_steps_per_epoch
from cyclegan_tpu_torch.data.palette import save_prediction_png
from cyclegan_tpu_torch.train import checkpoint as checkpoint_lib
from cyclegan_tpu_torch.train import metrics as metrics_lib
from cyclegan_tpu_torch.train.checkpoint import CheckpointManager, load_state, state_payload
from cyclegan_tpu_torch.train.cyclegan import CycleGANTrainer
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


def _check_single_device(cfg: Config) -> None:
    """The port runs one process on one device."""
    multi = {"num_devices": (cfg.num_devices or 1) > 1, "spatial_shards": cfg.spatial_shards > 1,
             "num_processes": (cfg.num_processes or 1) > 1,
             "coordinator_address": cfg.coordinator_address is not None}
    asked = [k for k, v in multi.items() if v]
    if asked:
        raise NotImplementedError(
            f"{', '.join(asked)}: data/spatial parallelism and multi-process runs arrive with "
            f"the parallel slice of the port (ROADMAP Queue 1 item 11)")


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
    """(target_hw, loader eval_mode) of the val/test loaders."""
    if cfg.eval_resize == "tile":
        raise NotImplementedError("--eval_resize tile (eval_tile.py) arrives with a later "
                                  "slice of the port (ROADMAP Queue 1 item 8)")
    return cfg.crop_hw, cfg.eval_resize


def select_step(trainer, steps_per_call: int = 1, grad_accum: int = 1) -> Callable:
    """The trainer step for a (steps_per_call, grad_accum) setting: the
    plain ``train_step``, ``multi_step`` (K optimizer steps a call) or
    ``accum_step`` (ONE update from K microbatches). The stacked forms take
    leading-K batch stacks and exclude each other (counterpart of
    ``cyclegan_tpu/parallel/mesh.py::select_step``)."""
    if steps_per_call > 1 and grad_accum > 1:
        raise ValueError(f"steps_per_call={steps_per_call} and grad_accum={grad_accum} are "
                         f"mutually exclusive (both consume the leading batch-stack axis)")
    if grad_accum > 1:
        return trainer.accum_step
    return trainer.train_step if steps_per_call <= 1 else trainer.multi_step


def _make_eval_fns(cfg: Config, trainer) -> tuple[Callable, Callable]:
    """(eval_fn(batch) -> confusion matrix, predict(image) -> class map),
    class maps as uint8 when the classes fit (a quarter of the bytes to
    fetch)."""
    if cfg.eval_flip or cfg.eval_scales:
        raise NotImplementedError("--eval_flip and --eval_scales (tta.py) arrive with a later "
                                  "slice of the port (ROADMAP Queue 1 item 8)")
    _eval_shaping(cfg)

    def predict(image: torch.Tensor) -> torch.Tensor:
        pred = trainer.predict(image)
        return pred.to(torch.uint8) if trainer.num_classes <= 255 else pred

    return trainer.eval_step, predict


def _make_loader(cfg: Config, ds, *, train: bool, seed: int, drop_last: bool = True):
    """The native loader (a prefetch thread and the native pixel library)
    or, with ``--loader grain``, the worker-process loader."""
    resize_hw = None
    if train and cfg.resize_height is not None:
        resize_hw = (cfg.resize_height, cfg.resize_width or cfg.resize_height)
    target_hw, eval_mode = (cfg.crop_hw, "resize") if train else _eval_shaping(cfg)
    kw = dict(batch_size=cfg.batch_size, crop_hw=target_hw, train=train, seed=seed,
              drop_last=drop_last, resize_hw=resize_hw, eval_mode=eval_mode)
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


def _evaluate(trainer, val_loader, eval_fn) -> dict:
    """Accumulate the confusion matrix over the val split on the device."""
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
    device = trainer.device
    logger = MetricsLogger(cfg.results_dir)
    profiler = StepProfiler(cfg.profile_dir)

    ckpt = CheckpointManager(cfg.checkpoint_dir)
    start_epoch = 0
    restored = ckpt.restore(trainer, state)
    if restored is not None:
        state, start_epoch = restored
        print(f"resumed from epoch {start_epoch - 1}", flush=True)

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
        print(f"resumed mid-epoch {start_epoch} at call {skip_calls}", flush=True)
    del w

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
                        preempted = preempt.is_set()
                        if gstep - last_mid >= mid_every or preempted:
                            mid_ckpt.save(gstep, _wrap(epoch, epoch_base + calls, gstep))
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
                print(f"[preempt] saved mid-epoch checkpoint at step {last_mid}; exiting",
                      flush=True)
                break
            if stop and pos < calls_per_epoch:
                gstep = gstep0 + total_steps
                mid_ckpt.save(gstep, _wrap(epoch, pos, gstep))
                print(f"[max_steps] stopped in epoch {epoch} at call {pos} of "
                      f"{calls_per_epoch}; saved a mid-epoch checkpoint at step {gstep}",
                      flush=True)
                break
            if cfg.validation_every > 0 and (epoch + 1) % cfg.validation_every == 0:
                tv = time.perf_counter()
                result = _evaluate(trainer, val_loader, eval_fn)
                seconds["validation"] += time.perf_counter() - tv
                print(f"[epoch {epoch}] val {result}", flush=True)
                if best_ckpt is not None and result.get("miou", -1.0) > best_miou:
                    best_miou = float(result["miou"])
                    best_ckpt.save(epoch, state_payload(trainer, state))
                    with open(best_metric_path, "w") as f:
                        json.dump({"miou": best_miou, "epoch": epoch}, f)
                    print(f"[epoch {epoch}] new best miou {best_miou:.4f} -> best/", flush=True)
                if on_validate is not None:
                    on_validate(state, epoch)
            ckpt.save(epoch, state_payload(trainer, state))
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
    raise NotImplementedError("--model supervised (train/supervised.py) arrives with a later "
                              "slice of the port (ROADMAP Queue 1 item 6)")


def run_cyclegan(cfg: Config, *, max_steps: int | None = None, device=None) -> dict:
    """The semi-supervised CycleGAN run (configurations 2-4) on ``device``
    (default the CUDA device)."""
    _check_single_device(cfg)
    num_classes, in_ch = _dataset_spec(cfg)
    train_ds = make_dataset(cfg.dataset, cfg.data_root, split="train", size=cfg.dataset_size)
    lab_ds, unlab_ds = split_labeled(train_ds, cfg.labeled_fraction, cfg.seed)
    val_ds = make_dataset(cfg.dataset, cfg.data_root, split="val")
    lab_loader = _make_loader(cfg, lab_ds, train=True, seed=cfg.seed)
    unlab_loader = _make_loader(cfg, unlab_ds, train=True, seed=cfg.seed + 1)
    val_loader = _make_loader(cfg, val_ds, train=False, seed=0, drop_last=False)
    steps_per_epoch = paired_steps_per_epoch(lab_loader, unlab_loader, cfg.pairing)
    if steps_per_epoch == 0:
        raise ValueError(f"empty paired epoch: labeled split has "
                         f"{lab_loader.steps_per_epoch()} batches of size {cfg.batch_size} "
                         f"— lower batch_size, raise labeled_fraction, or use --pairing cycle")
    trainer = CycleGANTrainer(cfg, num_classes, in_ch,
                              _effective_steps_per_epoch(cfg, steps_per_epoch), device=device)
    _, predict = _make_eval_fns(cfg, trainer)
    state = trainer.init_state(torch.Generator().manual_seed(cfg.seed))

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
    prediction, and the label->image generator's synthesis."""
    from PIL import Image

    os.makedirs(cfg.results_dir, exist_ok=True)
    # One batch; the epoch generator is closed here so its thread stops now.
    it = val_loader.epoch(0)
    try:
        batch = next(it)
    finally:
        it.close()
    imgs = batch["image"][:n]
    if predict is None:
        _, predict = _make_eval_fns(cfg, trainer)
    pred = predict(to_device({"image": imgs}, trainer.device)["image"]).cpu().numpy()

    def to_u8(x):  # [-1, 1] float -> uint8 RGB or gray
        u = np.clip((np.asarray(x) + 1.0) * 127.5, 0, 255).astype(np.uint8)
        return u[..., 0] if u.shape[-1] == 1 else u

    gen = None
    if "label" in batch:
        labels = to_device({"label": batch["label"][:n]}, trainer.device)["label"]
        gen = to_u8(trainer.generate_image(labels).float().cpu().numpy())
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
    per-class IoU. One forward a batch gives both the PNGs and the scores;
    batch k+1 is enqueued before batch k is fetched (InferencePipeline)."""
    _check_single_device(cfg)
    target_hw, eval_mode = _eval_shaping(cfg)
    trainer, _, num_classes, _ = checkpoint_lib.restore_for_inference(
        cfg, semisupervised=semisupervised, device=device)
    _, predict = _make_eval_fns(cfg, trainer)
    val_ds = make_dataset(cfg.dataset, cfg.data_root, split="val")
    val_loader = Loader(val_ds, batch_size=cfg.batch_size, crop_hw=target_hw, train=False,
                        drop_last=False, eval_mode=eval_mode)
    os.makedirs(cfg.results_dir, exist_ok=True)
    hist = None
    idx = 0
    n_total = len(val_ds)

    def consume(_, pred: np.ndarray) -> None:
        nonlocal idx
        for p in pred:
            if idx >= n_total:
                break  # padding rows of the last batch
            save_prediction_png(p.astype(np.uint8),
                                os.path.join(cfg.results_dir, f"pred_{idx:05d}.png"))
            idx += 1

    pipe = InferencePipeline(consume)
    it = val_loader.epoch(0)
    try:
        for batch in it:
            dev = to_device(batch, trainer.device)
            pred = predict(dev["image"])
            pipe.put(None, pred)
            if "label" in dev:
                h = metrics_lib.confusion_matrix(pred, dev["label"], num_classes,
                                                 ignore_index=trainer.ignore_index)
                hist = h if hist is None else hist + h
    finally:
        it.close()
    pipe.flush()
    out: dict = {}
    if hist is not None:
        s = metrics_lib.scores(hist.cpu())
        out = {k: float(v) for k, v in s.items() if v.ndim == 0}
        names = class_names(cfg.dataset, num_classes)
        out["per_class_iou"] = {nm: float(v) for nm, v in zip(names, s["per_class_iou"])}
        print(f"test scores: { {k: v for k, v in out.items() if k != 'per_class_iou'} }",
              flush=True)
        for nm, v in out["per_class_iou"].items():
            print(f"  iou[{nm}]: {v:.4f}", flush=True)
    return out
