"""VOC colormap <-> class-index codecs (numpy + PIL).

A copy of what serving needs from ``cyclegan_tpu/data/palette.py``. The
prediction PNG is always the P-mode palette PNG (one index byte per pixel,
rendered with the VOC palette); the JAX package's RGB alternative is not
carried over.
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


def save_prediction_png(labels: np.ndarray, fp) -> None:
    """Write a class map (H, W) as a P-mode PNG carrying the VOC palette
    (path or file object). Reading it back gives the indices unchanged."""
    from PIL import Image

    im = Image.fromarray(
        np.ascontiguousarray(np.clip(labels, 0, 255).astype(np.uint8)), mode="P")
    im.putpalette(voc_colormap(256).tobytes())
    im.save(fp, format="PNG")
