"""Evaluation-image shaping (numpy + PIL).

A copy of the serving half of ``cyclegan_tpu/data/transforms.py``
(``normalize``, ``resize_pair``, ``eval_transform``): the port may not
import the JAX package, so it keeps its own. Outputs are exactly
(crop_h, crop_w).
"""

from __future__ import annotations

import numpy as np
from PIL import Image


def _resize_one(arr: np.ndarray, size_hw: tuple[int, int], resample) -> np.ndarray:
    """PIL resize that tolerates a trailing singleton channel ((H, W, 1)
    grayscale, which PIL rejects and would drop on return)."""
    h, w = size_hw
    gray3d = arr.ndim == 3 and arr.shape[-1] == 1
    out = np.asarray(Image.fromarray(arr[..., 0] if gray3d else arr).resize((w, h), resample))
    return out[..., None] if gray3d else out


def resize_pair(img: np.ndarray, lab: np.ndarray | None, size_hw: tuple[int, int]
                ) -> tuple[np.ndarray, np.ndarray | None]:
    """Resize image (bilinear) and label (nearest) to (h, w)."""
    img = _resize_one(img, size_hw, Image.BILINEAR)
    if lab is not None:
        lab = _resize_one(lab, size_hw, Image.NEAREST)
    return img, lab


def normalize(img: np.ndarray) -> np.ndarray:
    """uint8 [0, 255] -> float32 [-1, 1] (torchvision Normalize(0.5, 0.5))."""
    return img.astype(np.float32) / 127.5 - 1.0


def eval_transform(img: np.ndarray, lab: np.ndarray | None, *,
                   crop_hw: tuple[int, int], mode: str = "resize",
                   normalize_img: bool = True
                   ) -> tuple[np.ndarray, np.ndarray | None]:
    """Deterministic val-image shaping.

    - ``"resize"`` (default): squash-resize to exactly (crop_h, crop_w).
    - ``"center_crop"``: aspect-preserving resize of the shorter side to the
      crop size, then a center crop.

    ``normalize_img=False`` returns the shaped uint8 pixels unscaled, for
    uint8-input artifacts that normalize on the device.
    """
    if mode == "center_crop":
        ch, cw = crop_hw
        h, w = img.shape[:2]
        scale = max(ch / h, cw / w)
        img, lab = resize_pair(img, lab, (max(ch, int(round(h * scale))),
                                          max(cw, int(round(w * scale)))))
        h, w = img.shape[:2]
        top, left = (h - ch) // 2, (w - cw) // 2
        img = np.ascontiguousarray(img[top:top + ch, left:left + cw])
        if lab is not None:
            lab = np.ascontiguousarray(lab[top:top + ch, left:left + cw])
    elif mode == "resize":
        img, lab = resize_pair(img, lab, crop_hw)
    else:
        raise ValueError(f"unknown eval mode {mode!r} (resize|center_crop)")
    return (normalize(img) if normalize_img else img), lab
