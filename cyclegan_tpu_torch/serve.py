"""Serve an exported artifact over a directory of images.

Counterpart of ``cyclegan_tpu/serve.py``: load the port's artifact
(``cyclegan_tpu_torch.export``), stream a directory of images through the
predictor on the card, write VOC-palette ``<stem>_pred.png`` files and,
given same-stem ground-truth masks, score them into ``scores.json``.

CLI: ``python -m cyclegan_tpu_torch.main --serve model.pt --serve_input
imgs/ --serve_output preds/ [--serve_gt masks/]
[--serve_canvas_height H --serve_canvas_width W] [--serve_flip]
[--serve_scales 0.75,1.0,1.25] [--serve_dp]`` (the canvas, flip and scales
need a logits-head artifact; ``--serve_dp`` splits each batch over every
visible card).
"""

from __future__ import annotations

import itertools
import json
import os
import time
from functools import partial
from typing import Callable, Iterable

import numpy as np
import torch

from cyclegan_tpu_torch.data.datasets import class_names
from cyclegan_tpu_torch.data.palette import encode_colormap, save_prediction_png
from cyclegan_tpu_torch.data.transforms import eval_transform
from cyclegan_tpu_torch.eval_tile import tiled_logits
from cyclegan_tpu_torch.export import (build_module, head_fn, load_artifact, resolve_device,
                                       uint8_output)
from cyclegan_tpu_torch.train import metrics as metrics_lib
from cyclegan_tpu_torch.tta import flip_avg, scale_avg, validate_tile_scales
from cyclegan_tpu_torch.utils.observability import span
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


def data_parallel_predictor(replicas: list[Callable[[np.ndarray], torch.Tensor]]
                  ) -> Callable[[np.ndarray], torch.Tensor]:
    """One predictor over ``replicas`` (one per device): the batch is
    zero-padded to a multiple of their count and split in order, each part
    goes to its replica, and the parts' outputs are joined on the first
    replica's device and cut back to the batch (the JAX package's
    ``--serve_dp``). One replica is returned as it is."""
    if len(replicas) == 1:
        return replicas[0]
    n = len(replicas)

    def predict(batch: np.ndarray) -> torch.Tensor:
        b = batch.shape[0]
        pad = (-b) % n
        if pad:
            batch = np.concatenate([batch, np.zeros((pad,) + batch.shape[1:], batch.dtype)])
        outs = [fn(part) for fn, part in zip(replicas, np.split(batch, n))]
        dev = outs[0].device
        return torch.cat([o.to(dev, non_blocking=True) for o in outs])[:b]

    return predict


def served_logits(logits_fn: Callable[[torch.Tensor], torch.Tensor], window_hw: tuple[int, int],
                  *, canvas_hw: tuple[int, int] | None = None, flip: bool = False,
                  scales: tuple[float, ...] | None = None
                  ) -> Callable[[torch.Tensor], torch.Tensor]:
    """The logits a logits artifact serves, in the JAX package's order:
    tiled over the canvas (``eval_tile.tiled_logits``), flip around that
    (``tta.flip_avg``), the scales around both (``tta.scale_avg``)."""
    if canvas_hw is not None:
        logits_fn = partial(tiled_logits, logits_fn, crop_hw=tuple(window_hw))
    if flip:
        logits_fn = flip_avg(logits_fn)
    if scales:
        logits_fn = scale_avg(logits_fn, tuple(scales))
    return logits_fn


def _check_options(cfg: dict, eval_resize: str, canvas_hw, flip: bool, scales) -> None:
    """Refuse what the JAX ``build_predictor`` refuses, in its order."""
    if eval_resize not in ("resize", "center_crop"):
        # "tile" is the framework-eval spelling; serving spells it
        # --serve_canvas_height/width (with a logits-head artifact).
        raise ValueError(f"serving supports eval_resize resize|center_crop, got "
                         f"{eval_resize!r} (for tiled serving pass --serve_canvas_height/"
                         f"--serve_canvas_width with a logits-head artifact)")
    head = cfg["head"]
    if head not in ("segment", "logits"):
        raise ValueError(f"artifact head is {head!r}; --serve drives the image->label segment "
                         f"or logits head (the generate head consumes label maps: call "
                         f"export.load_head() directly)")
    if scales and cfg["input_dtype"] == "uint8":
        raise ValueError("--serve_scales resamples the input canvas in float; multi-scale "
                         "TTA needs a float32-input artifact (this one takes uint8)")
    if flip and head != "logits":
        raise ValueError(f"--serve_flip averages LOGITS of the image and its mirror; export "
                         f"with --export_what logits (this artifact's head is {head!r})")
    if scales and canvas_hw is None:
        raise ValueError("--serve_scales needs tiled serving (--serve_canvas_height/"
                         "--serve_canvas_width + a logits-head artifact): the artifact's "
                         "window is fixed-shape, so multi-scale works by re-tiling rescaled "
                         "canvases")
    if canvas_hw is not None:
        if head != "logits":
            raise ValueError(f"tiled serving averages window LOGITS; export with "
                             f"--export_what logits (this artifact's head is {head!r})")
        (ch, cw), (h, w) = canvas_hw, cfg["crop_hw"]
        if ch < h or cw < w:
            raise ValueError(f"serve canvas {ch}x{cw} smaller than the artifact window "
                             f"{h}x{w}")


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

    ``canvas_hw``: tiled serving of a logits artifact: images are loaded
    at this canvas and the artifact's window slides over it with 50%
    overlap, all windows of a batch in one call (``eval_tile.tiled_logits``).
    ``flip``: the logits averaged with the mirrored logits of the mirror
    image (``tta.flip_avg``; logits head). ``scales``: the logits at each
    scale of the canvas, resized back and averaged (``tta.scale_avg``;
    needs ``canvas_hw`` and a float32-input artifact). Flip wraps the tiled
    function and the scales wrap both, as in the JAX package.
    ``data_parallel``: one replica per visible CUDA device, each batch split
    over them (:func:`data_parallel_predictor`); with one device (or on the CPU) the
    single-device path.

    Spans (``utils.observability``): each replica's call is a
    ``serve.predict`` (unit: that replica's call count; the input's copy,
    the argmax and the uint8 cast are its own time) over ``serve.scale``
    (:func:`tta.scale_avg`), ``serve.flip`` (:func:`tta.flip_avg`),
    ``serve.tiles`` (:func:`eval_tile.tiled_logits`) and ``serve.forward``,
    the generator on one stack of windows.
    """
    dev = resolve_device(device)
    art, manifest = load_artifact(artifact_path)
    cfg = art["config"]
    _check_options(cfg, eval_resize, canvas_hw, flip, scales)
    h, w = cfg["crop_hw"]
    if scales:
        validate_tile_scales(canvas_hw, (h, w), tuple(scales))
    in_dtype = cfg["input_dtype"]
    if data_parallel and dev.type == "cuda" and torch.cuda.device_count() > 1:
        devices = [torch.device("cuda", i) for i in range(torch.cuda.device_count())]
    else:
        devices = [dev]

    def replica(d: torch.device) -> Callable[[np.ndarray], torch.Tensor]:
        G = build_module(art, d)

        def generator(x: torch.Tensor) -> torch.Tensor:
            with span("serve.forward"):
                return G(x)

        fn = head_fn(generator, cfg, d)
        if cfg["head"] == "logits":
            logits_fn = served_logits(fn, (h, w), canvas_hw=canvas_hw, flip=flip,
                                      scales=scales)
            fn = lambda x: torch.argmax(logits_fn(x), dim=-1)  # noqa: E731
            if cfg["num_classes"] <= 255:
                fn = uint8_output(fn)
        fn = torch.inference_mode()(fn)
        calls = itertools.count()

        def predict(batch: np.ndarray) -> torch.Tensor:
            with span("serve.predict", unit=next(calls)):
                x = torch.from_numpy(np.ascontiguousarray(batch, dtype=np.dtype(in_dtype)))
                if d.type != "cuda":
                    return fn(x)
                # Pinned memory makes the copy asynchronous: the host does
                # not wait for the kernels already queued ahead of it. The
                # kernels launch on the current device, so each replica
                # makes its own device current.
                with torch.cuda.device(d):
                    return fn(x.pin_memory().to(d, non_blocking=True))

        return predict

    predict_batch = data_parallel_predictor([replica(d) for d in devices])
    info = {"load_hw": tuple(canvas_hw) if canvas_hw is not None else (h, w),
            "window_hw": (h, w), "in_channels": cfg["in_channels"],
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
    confusion matrix and write ``scores.json``. Returns the summary dict.
    ``canvas_hw``, ``flip``, ``scales`` and ``data_parallel`` are
    :func:`build_predictor`'s; with a canvas, images and masks are loaded at
    it and the PNGs are canvas-sized."""
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
