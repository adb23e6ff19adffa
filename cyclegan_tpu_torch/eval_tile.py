"""Tiled (sliding-window) evaluation on a fixed canvas.

Counterpart of ``cyclegan_tpu/eval_tile.py``: ``--eval_resize tile`` scores
each validation image on a canvas of ``--resize_height`` x
``--resize_width`` by sliding the training-crop window over it with 50%
overlap (the last window pinned to the edge), averaging the windows'
logits in float32 where they overlap, and taking the argmax at canvas
resolution. All windows of a batch run as one call of the logits function
(P * B windows). Tensors use the JAX package's layout: images (B, H, W, C),
logits (B, H, W, K).
"""

from __future__ import annotations

from typing import Callable

import torch

from cyclegan_tpu_torch.train import metrics
from cyclegan_tpu_torch.utils.observability import span

LogitsFn = Callable[[torch.Tensor], torch.Tensor]


def window_positions(size: int, win: int, stride: int) -> list[int]:
    """Window offsets covering [0, size): a regular stride, the last window
    pinned to the end so the canvas edge is always covered."""
    if size <= win:
        return [0]
    pos = list(range(0, size - win + 1, stride))
    if pos[-1] != size - win:
        pos.append(size - win)
    return pos


def tiled_logits(logits_fn: LogitsFn, images: torch.Tensor, crop_hw: tuple[int, int], *,
                 overlap: float = 0.5) -> torch.Tensor:
    """(B, H, W, C) canvas images -> (B, H, W, K) float32 overlap-averaged
    logits. ``logits_fn(windows)`` is called once on the (P*B, ch, cw, C)
    stack of all windows. Raises if the canvas is smaller than the window.
    Span: ``serve.tiles`` (the gather, the call and the stitch)."""
    b, h, w, _ = images.shape
    ch, cw = crop_hw
    if h < ch or w < cw:
        raise ValueError(f"canvas {h}x{w} smaller than the window {ch}x{cw}")
    sy = max(int(round(ch * (1.0 - overlap))), 1)
    sx = max(int(round(cw * (1.0 - overlap))), 1)
    ys = window_positions(h, ch, sy)
    xs = window_positions(w, cw, sx)
    with span("serve.tiles"):
        wins = torch.cat([images[:, y:y + ch, x:x + cw, :] for y in ys for x in xs])
        logits = logits_fn(wins)
        k = logits.shape[-1]
        # float32 accumulation: bf16 logits would round the sum before the average.
        acc = torch.zeros((b, h, w, k), dtype=torch.float32, device=logits.device)
        cnt = torch.zeros((h, w, 1), dtype=torch.float32, device=logits.device)
        i = 0
        for y in ys:
            for x in xs:
                acc[:, y:y + ch, x:x + cw, :] += logits[i * b:(i + 1) * b].float()
                cnt[y:y + ch, x:x + cw, :] += 1.0
                i += 1
        return acc / cnt


def tiled_predict(trainer, images: torch.Tensor, crop_hw: tuple[int, int], *,
                  overlap: float = 0.5) -> torch.Tensor:
    """Canvas images -> (B, H, W) class map through the tiled logits of
    ``trainer.logits``."""
    return tiled_logits(trainer.logits, images, crop_hw, overlap=overlap).argmax(-1)


def tiled_eval_step(trainer, batch: dict, crop_hw: tuple[int, int], *,
                    overlap: float = 0.5) -> torch.Tensor:
    """Confusion-matrix contribution of one canvas batch (the tile-mode
    drop-in for ``trainer.eval_step``)."""
    pred = tiled_predict(trainer, batch["image"], crop_hw, overlap=overlap)
    return metrics.confusion_matrix(pred, batch["label"], trainer.num_classes,
                                    ignore_index=trainer.ignore_index)
