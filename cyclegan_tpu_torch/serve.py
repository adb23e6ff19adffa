"""Serve an exported artifact over a directory of images.

Counterpart of ``cyclegan_tpu/serve.py``: load the port's artifact
(``cyclegan_tpu_torch.export``), stream a directory of images through the
predictor on the card, write VOC-palette ``<stem>_pred.png`` files and,
given same-stem ground-truth masks, score them into ``scores.json``.

CLI: ``python -m cyclegan_tpu_torch.main --serve model.pt --serve_input
imgs/ --serve_output preds/ [--serve_gt masks/]``. Tiled serving, flip and
multi-scale TTA and data-parallel serving are not ported yet.
"""

from __future__ import annotations

import json
import os
import time
from typing import Callable, Iterable

import numpy as np
import torch

from cyclegan_tpu_torch.data.datasets import class_names
from cyclegan_tpu_torch.data.palette import encode_colormap, save_prediction_png
from cyclegan_tpu_torch.data.transforms import eval_transform
from cyclegan_tpu_torch.export import load_head, resolve_device
from cyclegan_tpu_torch.train import metrics as metrics_lib
from cyclegan_tpu_torch.utils.pipeline import InferencePipeline

IMG_EXTS = (".png", ".jpg", ".jpeg", ".bmp")


def _list_images(directory: str) -> list[str]:
    names = sorted(n for n in os.listdir(directory) if n.lower().endswith(IMG_EXTS))
    if not names:
        raise FileNotFoundError(f"no images ({'/'.join(IMG_EXTS)}) in {directory}")
    stems: dict[str, str] = {}
    for n in names:
        s = os.path.splitext(n)[0]
        if s in stems:
            # Outputs and GT masks are keyed by stem; a collision would
            # overwrite one prediction and double-count scores.
            raise ValueError(f"duplicate image stem {s!r} in {directory} "
                             f"({stems[s]} vs {n}): rename one")
        stems[s] = n
    return names


def load_image(path: str, hw: tuple[int, int], in_channels: int, eval_resize: str,
               input_dtype: str = "float32") -> np.ndarray:
    from PIL import Image

    with Image.open(path) as im:
        arr = np.asarray(im.convert("L" if in_channels == 1 else "RGB"))
    if arr.ndim == 2:
        arr = arr[..., None]
    # uint8-input artifacts normalize on the device: ship raw shaped pixels.
    img, _ = eval_transform(arr, None, crop_hw=hw, mode=eval_resize,
                            normalize_img=input_dtype != "uint8")
    return img


def load_mask(path: str, hw: tuple[int, int], num_classes: int,
              eval_resize: str) -> np.ndarray:
    """GT mask -> (H, W) class indices. P-mode and grayscale PNGs carry
    indices directly; RGB masks go through the palette codec."""
    from PIL import Image

    with Image.open(path) as im:
        arr = np.asarray(im)
    if arr.ndim == 3:
        arr = encode_colormap(arr, num_classes)
    _, lab = eval_transform(np.zeros(arr.shape[:2] + (1,), np.uint8),
                            arr.astype(np.int32), crop_hw=hw, mode=eval_resize)
    return lab


def _chunks(seq: list, n: int) -> Iterable[list]:
    for i in range(0, len(seq), n):
        yield seq[i:i + n]


def build_predictor(artifact_path: str, *, eval_resize: str = "resize",
                    device: str | torch.device | None = None,
                    canvas_hw: tuple[int, int] | None = None,
                    data_parallel: bool = False, flip: bool = False,
                    scales: tuple[float, ...] | None = None
                    ) -> tuple[Callable[[np.ndarray], torch.Tensor], dict]:
    """Load an artifact and build its batched predictor on ``device``
    (default: the CUDA device; without one this raises rather than run on
    the CPU).

    Returns ``(predict_batch, info)``: ``predict_batch`` maps an
    ``(N, H, W, C)`` numpy batch, already ``eval_transform``-shaped at
    ``info['load_hw']``, to an ``(N, H, W)`` tensor of class indices that
    stays on the device until the caller fetches it. Both heads serve class
    maps (``logits`` artifacts through an argmax here).
    """
    if canvas_hw is not None or scales:
        raise NotImplementedError("tiled and multi-scale serving are not ported "
                                  "to cyclegan_tpu_torch yet")
    if flip:
        raise NotImplementedError("flip TTA is not ported to cyclegan_tpu_torch yet")
    if data_parallel:
        raise NotImplementedError("data-parallel serving (--serve_dp) is not ported "
                                  "to cyclegan_tpu_torch yet")
    if eval_resize not in ("resize", "center_crop"):
        raise ValueError(f"serving supports eval_resize resize|center_crop, got "
                         f"{eval_resize!r}")
    dev = resolve_device(device)
    fn, cfg, manifest = load_head(artifact_path, dev)
    if cfg["head"] == "logits":
        head_fn = fn
        fn = lambda x: torch.argmax(head_fn(x), dim=-1)  # noqa: E731
    in_dtype = cfg["input_dtype"]

    def predict_batch(batch: np.ndarray) -> torch.Tensor:
        x = torch.from_numpy(np.ascontiguousarray(batch, dtype=np.dtype(in_dtype)))
        if dev.type == "cuda":
            # Pinned memory makes the copy asynchronous: the host does not
            # wait for the kernels already queued ahead of it.
            x = x.pin_memory().to(dev, non_blocking=True)
        return fn(x)

    h, w = cfg["crop_hw"]
    info = {"load_hw": (h, w), "window_hw": (h, w), "in_channels": cfg["in_channels"],
            "num_classes": cfg["num_classes"], "head": cfg["head"],
            "manifest": manifest, "eval_resize": eval_resize, "input_dtype": in_dtype,
            "device": str(dev)}
    return predict_batch, info


def run_serve(artifact_path: str, input_dir: str, output_dir: str, *,
              batch_size: int = 8, gt_dir: str | None = None,
              eval_resize: str = "resize", device: str | torch.device | None = None,
              canvas_hw: tuple[int, int] | None = None, data_parallel: bool = False,
              flip: bool = False, scales: tuple[float, ...] | None = None) -> dict:
    """Run an artifact over ``input_dir``: one ``<stem>_pred.png`` per image
    in ``output_dir``; with ``gt_dir`` holding same-stem masks, accumulate the
    confusion matrix and write ``scores.json``. Returns the summary dict."""
    predict_batch, info = build_predictor(
        artifact_path, eval_resize=eval_resize, device=device, canvas_hw=canvas_hw,
        data_parallel=data_parallel, flip=flip, scales=scales)
    load_hw, c = info["load_hw"], info["in_channels"]
    num_classes = info["num_classes"]

    names = _list_images(input_dir)
    os.makedirs(output_dir, exist_ok=True)
    hist = None
    scored = 0
    t0 = time.perf_counter()

    def consume(chunk: list[str], pred: np.ndarray) -> None:
        nonlocal hist, scored
        for name, p in zip(chunk, pred):
            stem = os.path.splitext(name)[0]
            save_prediction_png(p.astype(np.uint8),
                                os.path.join(output_dir, f"{stem}_pred.png"))
            if gt_dir is None:
                continue
            mask_path = os.path.join(gt_dir, stem + ".png")
            if not os.path.exists(mask_path):
                continue
            lab = load_mask(mask_path, load_hw, num_classes, eval_resize)
            hh = metrics_lib.confusion_matrix(torch.from_numpy(p), torch.tensor(lab),
                                              num_classes)
            hist = hh if hist is None else hist + hh
            scored += 1

    pipe = InferencePipeline(consume)
    for chunk in _chunks(names, max(batch_size, 1)):
        batch = np.stack([load_image(os.path.join(input_dir, n), load_hw, c,
                                     eval_resize, info["input_dtype"]) for n in chunk])
        pipe.put(chunk, predict_batch(batch))
    pipe.flush()

    elapsed = time.perf_counter() - t0
    out = {"images": len(names), "scored": scored,
           "output_dir": os.path.abspath(output_dir),
           # End to end: decode + predict + colorize + write, first batch's
           # kernel build and warm-up included.
           "elapsed_s": round(elapsed, 3),
           "img_per_s": round(len(names) / elapsed, 3) if elapsed else None}
    if hist is not None:
        s = metrics_lib.scores(hist)
        out.update({k: float(v) for k, v in s.items() if v.dim() == 0})
        cls_names = info["manifest"].get("class_names")
        if not cls_names or len(cls_names) != num_classes:
            cls_names = class_names(info["manifest"].get("dataset", ""), num_classes)
        out["per_class_iou"] = {n: float(v) for n, v in zip(cls_names, s["per_class_iou"])}
        with open(os.path.join(output_dir, "scores.json"), "w") as f:
            json.dump({k: v for k, v in out.items() if k != "output_dir"}, f,
                      indent=2, sort_keys=True)
    print(f"served {len(names)} images -> {output_dir}"
          + (f"; scores over {scored}: "
             + json.dumps({k: round(v, 4) for k, v in out.items()
                           if isinstance(v, float)})
             if scored else ""), flush=True)
    return out
