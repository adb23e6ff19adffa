"""Test-time augmentation: horizontal-flip and multi-scale logit averaging.

Counterpart of ``cyclegan_tpu/tta.py``. ``--eval_flip true`` averages each
image's logits with the mirrored logits of its mirror image;
``--eval_scales 0.75,1.0,1.25`` runs the net at each scale of the image,
resizes the logits back and averages them. Both accumulate in float32 and
compose with ``--eval_resize tile`` (they wrap the whole canvas-level
logits function). Tensors use the JAX package's layout: images (N, H, W,
C), logits (N, H, W, K).

Resizing is bilinear with half-pixel centres and, when it shrinks, an
antialiasing triangle filter as wide as the scale asks: the semantics of
``jax.image.resize(..., "linear")``, which ``F.interpolate(...,
"bilinear", align_corners=False, antialias=True)`` has too. The two sum
in another order (float32 rounding; the CPU tests hold them to 1e-5).
"""

from __future__ import annotations

from typing import Callable

import torch
import torch.nn.functional as F

from cyclegan_tpu_torch.utils.observability import span

LogitsFn = Callable[[torch.Tensor], torch.Tensor]


def flip_avg(logits_fn: LogitsFn) -> LogitsFn:
    """Wrap ``images -> logits`` with horizontal-flip TTA:
    ``0.5 * (f(x) + hflip(f(hflip(x))))``, in float32. Span:
    ``serve.flip`` (both calls, the flips and the average)."""

    def fn(images: torch.Tensor) -> torch.Tensor:
        with span("serve.flip"):
            straight = logits_fn(images).float()
            mirrored = logits_fn(images.flip(2)).flip(2).float()
            return 0.5 * (straight + mirrored)

    return fn


def parse_scales(spec: str | None) -> tuple[float, ...] | None:
    """``"0.75,1.0,1.25"`` -> (0.75, 1.0, 1.25); None or empty -> None."""
    if not spec:
        return None
    scales = tuple(float(s) for s in str(spec).split(",") if s.strip())
    if not scales or any(s <= 0 for s in scales):
        raise ValueError(f"bad eval_scales {spec!r} (comma-separated "
                         f"positive floats, e.g. '0.75,1.0,1.25')")
    return scales


def snapped_dims(h: int, w: int, scale: float, *, snap: int = 4) -> tuple[int, int]:
    """The (H, W) :func:`scale_avg` runs ``scale`` at: multiples of ``snap``
    (the ResNet generators' down/up pair round-trips only /4 shapes); shared
    with the runner's tile-mode check so both use the same arithmetic."""
    hs = max(int(round(h * scale / snap)) * snap, snap)
    ws = max(int(round(w * scale / snap)) * snap, snap)
    return hs, ws


def validate_tile_scales(canvas_hw: tuple[int, int], window_hw: tuple[int, int],
                         scales: tuple[float, ...] | None, *, snap: int = 4) -> None:
    """Raise at set-up if a TTA scale shrinks a tile-mode canvas below the
    sliding window (else the first validation, after a training epoch,
    would)."""
    if not scales:
        return
    ch, cw = canvas_hw
    wh, ww = window_hw
    for s in scales:
        hs, ws = snapped_dims(ch, cw, s, snap=snap)
        if hs < wh or ws < ww:
            raise ValueError(
                f"eval/serve scale {s} shrinks the {ch}x{cw} canvas to "
                f"{hs}x{ws}, smaller than the {wh}x{ww} sliding window — "
                f"raise the canvas (--resize_height/width or "
                f"--serve_canvas_height/width) or drop the scale")


def resize(x: torch.Tensor, hw: tuple[int, int]) -> torch.Tensor:
    """(N, H, W, C) -> (N, h, w, C) float32, ``jax.image.resize`` "linear"
    semantics (antialiased when it shrinks)."""
    y = F.interpolate(x.float().permute(0, 3, 1, 2), size=hw, mode="bilinear",
                      align_corners=False, antialias=True)
    return y.permute(0, 2, 3, 1)


def scale_avg(logits_fn: LogitsFn, scales: tuple[float, ...], *, snap: int = 4) -> LogitsFn:
    """Multi-scale TTA: run ``logits_fn`` at each scale of the image (dims
    snapped to ``snap``), resize the logits back to the input's grid and
    average them in float32. Wrap :func:`flip_avg` inside it to average
    over scales x {identity, mirror}. Span: ``serve.scale``, one a scale
    (its resizes, the call and the sum)."""
    if not scales:
        raise ValueError("scale_avg needs at least one scale")

    def fn(images: torch.Tensor) -> torch.Tensor:
        _, h, w, _ = images.shape
        acc = None
        for s in scales:
            with span("serve.scale"):
                hs, ws = snapped_dims(h, w, s, snap=snap)
                if (hs, ws) == (h, w):
                    lo = logits_fn(images).float()
                else:
                    lo = resize(logits_fn(resize(images, (hs, ws))), (h, w))
                acc = lo if acc is None else acc + lo
        return acc / len(scales)

    return fn
