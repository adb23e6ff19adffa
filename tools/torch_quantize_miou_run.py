#!/usr/bin/env python3
"""Quantisation's cost in mIoU for cyclegan_tpu_torch: float32 against
int8 and bf16 weight-only artifacts of one checkpoint, on the card.

The port's counterpart of ``tools/quantize_miou_run.py``. Trains the
port's supervised segmenter (``SupervisedTrainer``) on the synthetic
corpus for ``--steps`` (or takes ``--checkpoint``), exports the same
checkpoint three ways through ``export.run_export`` (the CLI's
``--export``), serves the same validation PNGs with each through
``serve.run_serve`` with ground-truth scoring, and prints one JSON line:
the three mIoUs and pixel accuracies, the deltas of int8 and bf16 from
float32, the class maps' agreement with the float32 artifact's, the
``.pt`` sizes, and ``miou_background_only``, the score of class 0
everywhere on the same masks. At the default 300 steps the net is still
at about that score (it predicts background nearly everywhere), so its
mIoU deltas say little and the agreement is the measure; pass a
``--checkpoint`` of a trained run for deltas that mean something.

    python3 tools/torch_quantize_miou_run.py [--steps 300] [--size 64] [--device cpu]

Runs on the CUDA card by default (the kernels), ``--device cpu`` on the
CPU (their plain versions). Imports nothing of JAX or the JAX package.
"""

from __future__ import annotations

import argparse
import json
import os
import sys
import tempfile
import time
from pathlib import Path

sys.path.insert(0, str(Path(__file__).resolve().parent.parent))

import numpy as np  # noqa: E402
import torch  # noqa: E402
from PIL import Image  # noqa: E402

from cyclegan_tpu_torch.data.datasets import make_dataset  # noqa: E402
from cyclegan_tpu_torch.data.loader import Loader  # noqa: E402
from cyclegan_tpu_torch.export import run_export  # noqa: E402
from cyclegan_tpu_torch.serve import run_serve  # noqa: E402
from cyclegan_tpu_torch.train.checkpoint import CheckpointManager, state_payload  # noqa: E402
from cyclegan_tpu_torch.train.metrics import confusion_matrix, scores  # noqa: E402
from cyclegan_tpu_torch.train.supervised import SupervisedTrainer  # noqa: E402
from cyclegan_tpu_torch.utils.config import Config  # noqa: E402

MODES = (None, "bf16", "int8")


def train_and_measure(steps: int, size: int, ngf: int, batch: int, classes: int,
                      workdir: str, *, device: str = "cuda", checkpoint_dir: str | None = None,
                      semisupervised: bool = False, gen_net: str = "resnet_6blocks",
                      ndf: int = 8, bf16: bool = False, val_images: int = 24) -> dict:
    """Train (unless ``checkpoint_dir`` names a run to measure), export
    float32 / bf16 / int8 artifacts of the same checkpoint, serve the same
    validation PNGs with each; returns the scores and sizes."""
    work = Path(workdir)
    cfg = Config(dataset="synthetic", gen_net=gen_net, ngf=ngf, ndf=ndf, bf16=bf16,
                 crop_height=size, crop_width=size, batch_size=batch, epochs=10_000,
                 decay_epoch=5_000, checkpoint_dir=checkpoint_dir or str(work / "ckpt"),
                 results_dir=str(work / "out"))
    out = {"steps": None if checkpoint_dir else steps, "size": size, "ngf": ngf,
           "gen_net": gen_net, "bf16": bf16, "checkpoint": checkpoint_dir, "device": device}
    if device == "cuda":
        out["device_name"] = torch.cuda.get_device_name(0)
    if checkpoint_dir is None:
        loader = Loader(make_dataset("synthetic", split="train", size=64), batch_size=batch,
                        crop_hw=(size, size), train=True, seed=0)
        trainer = SupervisedTrainer(cfg, classes, 3, steps_per_epoch=1, device=device)
        state = trainer.init_state(torch.Generator().manual_seed(0))
        t0, done, epoch = time.perf_counter(), 0, 0
        while done < steps:
            for b in loader.epoch(epoch):
                state, m = trainer.train_step(state, {
                    "image": torch.from_numpy(b["image"]).to(device),
                    "label": torch.from_numpy(b["label"]).to(device)})
                done += 1
                if done >= steps:
                    break
            epoch += 1
        out["final_ce_loss"] = float(m["ce_loss"])
        out["train_s"] = time.perf_counter() - t0
        CheckpointManager(cfg.checkpoint_dir).save(0, state_payload(trainer, state))

    # The validation set as PNGs and masks: a serving host's input.
    img_dir, gt_dir = work / "val_img", work / "val_gt"
    img_dir.mkdir(parents=True, exist_ok=True)
    gt_dir.mkdir(parents=True, exist_ok=True)
    val = Loader(make_dataset("synthetic", split="val", size=val_images), batch_size=1,
                 crop_hw=(size, size), train=False, drop_last=False)
    for i, b in enumerate(val.epoch(0)):
        px = np.clip((b["image"][0] + 1.0) * 127.5, 0, 255).astype(np.uint8)
        Image.fromarray(px).save(img_dir / f"img_{i:03d}.png")
        Image.fromarray(b["label"][0].astype(np.uint8), mode="L").save(
            gt_dir / f"img_{i:03d}.png")

    preds = {}
    for quant in MODES:
        name = quant or "f32"
        path = run_export(cfg, str(work / f"seg_{name}"), semisupervised=semisupervised,
                          what="segment", quantize=quant, device=device,
                          num_classes=None if checkpoint_dir else classes)
        res = run_serve(path, str(img_dir), str(work / f"pred_{name}"), batch_size=4,
                        gt_dir=str(gt_dir), device=device)
        out[f"miou_{name}"] = float(res["miou"])
        out[f"pixel_acc_{name}"] = float(res["pixel_acc"])
        out[f"bytes_{name}"] = os.path.getsize(path)
        preds[name] = np.stack([np.asarray(Image.open(work / f"pred_{name}" / f))
                                for f in sorted(os.listdir(work / f"pred_{name}"))
                                if f.endswith("_pred.png")])
    # Class 0 everywhere, scored on the same masks.
    n_cls = len(res["per_class_iou"])
    hist = sum(confusion_matrix(torch.zeros(m.shape, dtype=torch.long),
                                torch.from_numpy(m).long(), n_cls)
               for m in (np.asarray(Image.open(gt_dir / f)) for f in sorted(os.listdir(gt_dir))))
    out["miou_background_only"] = float(scores(hist)["miou"])
    for name in ("bf16", "int8"):
        out[f"delta_{name}"] = out[f"miou_{name}"] - out["miou_f32"]
        out[f"agreement_{name}"] = float(np.mean(preds[name] == preds["f32"]))
        out[f"size_ratio_{name}"] = out[f"bytes_{name}"] / out["bytes_f32"]
    return out


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--steps", type=int, default=None,
                    help="training steps (default 300); not with --checkpoint")
    ap.add_argument("--size", type=int, default=64)
    ap.add_argument("--ngf", type=int, default=8)
    ap.add_argument("--batch", type=int, default=4)
    ap.add_argument("--classes", type=int, default=None,
                    help="classes of the trained net (default 21); not with --checkpoint")
    ap.add_argument("--checkpoint", default=None,
                    help="measure an existing checkpoint directory instead of training "
                         "one (--gen_net/--ngf/--ndf/--semisup as it was trained)")
    ap.add_argument("--semisup", action="store_true",
                    help="the checkpoint is a semi-supervised CycleGAN run (G_i2l segments)")
    ap.add_argument("--gen_net", default="resnet_6blocks")
    ap.add_argument("--ndf", type=int, default=8)
    ap.add_argument("--bf16", action="store_true", help="compute in bf16 (train and serve)")
    ap.add_argument("--device", choices=["cuda", "cpu"], default="cuda")
    args = ap.parse_args(argv)
    if args.checkpoint and (args.steps is not None or args.classes is not None):
        ap.error("--steps/--classes configure the net this tool trains; --checkpoint "
                 "skips training")
    if args.device == "cuda" and not torch.cuda.is_available():
        print("torch_quantize_miou_run: no CUDA device (pass --device cpu)", file=sys.stderr)
        return 1
    with tempfile.TemporaryDirectory() as tmp:
        print(json.dumps(train_and_measure(
            300 if args.steps is None else args.steps, args.size, args.ngf, args.batch,
            21 if args.classes is None else args.classes, tmp, device=args.device,
            checkpoint_dir=args.checkpoint, semisupervised=args.semisup,
            gen_net=args.gen_net, ndf=args.ndf, bf16=args.bf16)), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
