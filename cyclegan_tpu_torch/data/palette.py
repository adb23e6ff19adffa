"""VOC colormap <-> class-index codecs and one-hot encoding (numpy + PIL).

A copy of ``cyclegan_tpu/data/palette.py``. The prediction PNG is always
the P-mode palette PNG (one index byte per pixel, rendered with the VOC
palette); the JAX package's ``CYCLEGAN_TPU_PRED_PNG=rgb`` alternative is
not carried over (``decode_colormap`` gives the RGB rendering).
"""

from __future__ import annotations

import functools

import numpy as np


@functools.lru_cache(maxsize=4)
def voc_colormap(num_classes: int = 256) -> np.ndarray:
    """The standard PASCAL VOC color palette (bit-interleaving algorithm)."""
    cmap = np.zeros((num_classes, 3), dtype=np.uint8)
    for i in range(num_classes):
        r = g = b = 0
        c = i
        for j in range(8):
            r |= ((c >> 0) & 1) << (7 - j)
            g |= ((c >> 1) & 1) << (7 - j)
            b |= ((c >> 2) & 1) << (7 - j)
            c >>= 3
        cmap[i] = (r, g, b)
    return cmap


@functools.lru_cache(maxsize=4)
def _encode_lut(num_classes: int) -> np.ndarray:
    """24-bit color -> class-index LUT (16 MB, built once per class count)."""
    cmap = voc_colormap(256)
    lut = np.full(1 << 24, 255, dtype=np.uint8)
    keys = (cmap[:, 0].astype(np.int64) << 16) | (cmap[:, 1].astype(np.int64) << 8) | cmap[:, 2]
    for idx in range(num_classes):
        lut[keys[idx]] = idx
    lut[keys[255]] = 255  # void
    return lut


def encode_colormap(rgb: np.ndarray, num_classes: int = 21) -> np.ndarray:
    """RGB palette image (H, W, 3) uint8 -> class-index map (H, W) uint8.
    Unknown colors (e.g. the void border (224, 224, 192)) map to 255."""
    lut = _encode_lut(num_classes)
    flat = (rgb[..., 0].astype(np.int64) << 16) | (rgb[..., 1].astype(np.int64) << 8) | rgb[..., 2]
    return lut[flat]


def decode_colormap(labels: np.ndarray) -> np.ndarray:
    """Class-index map (H, W) -> RGB (H, W, 3) uint8 via the VOC palette."""
    return voc_colormap(256)[np.clip(labels, 0, 255)]


def palette_image(labels: np.ndarray):
    """Class-index map (H, W) -> P-mode PIL image carrying the VOC palette:
    it renders as ``decode_colormap`` does, with one index byte a pixel."""
    from PIL import Image

    im = Image.fromarray(
        np.ascontiguousarray(np.clip(labels, 0, 255).astype(np.uint8)), mode="P")
    im.putpalette(voc_colormap(256).tobytes())
    return im


def save_prediction_png(labels: np.ndarray, fp) -> None:
    """Write a class map (H, W) as a P-mode PNG carrying the VOC palette
    (path or file object). Reading it back gives the indices unchanged."""
    palette_image(labels).save(fp, format="PNG")


def one_hot(labels: np.ndarray, num_classes: int, *, ignore_index: int | None = 255
            ) -> np.ndarray:
    """(..., H, W) int labels -> (..., H, W, num_classes) float32 one-hot;
    ignored pixels are all zeros."""
    safe = np.where(labels == ignore_index, 0, labels) if ignore_index is not None else labels
    oh = np.eye(num_classes, dtype=np.float32)[safe]
    if ignore_index is not None:
        oh = oh * (labels != ignore_index)[..., None].astype(np.float32)
    return oh
