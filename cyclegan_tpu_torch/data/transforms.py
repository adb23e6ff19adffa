"""Image/label transforms (numpy + PIL).

A copy of ``cyclegan_tpu/data/transforms.py`` (the port may not import the
JAX package, so it keeps its own): resize -> random crop -> random
horizontal flip -> normalize to [-1, 1] for training, and the deterministic
evaluation shaping. The augment draws come from an injected
``numpy.random.Generator`` in the order crop top, crop left, flip: the
contract that makes the port's batches bit-identical to the JAX package's.
Outputs are exactly (crop_h, crop_w).
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


def random_crop_pair(img: np.ndarray, lab: np.ndarray | None, crop_hw: tuple[int, int],
                     rng: np.random.Generator) -> tuple[np.ndarray, np.ndarray | None]:
    """Random (crop_h, crop_w) window of both; an image smaller than the
    window is upscaled first so the crop always fits."""
    ch, cw = crop_hw
    h, w = img.shape[:2]
    if h < ch or w < cw:
        scale = max(ch / h, cw / w)
        img, lab = resize_pair(img, lab, (max(ch, int(round(h * scale))),
                                          max(cw, int(round(w * scale)))))
        h, w = img.shape[:2]
    top = int(rng.integers(0, h - ch + 1))
    left = int(rng.integers(0, w - cw + 1))
    img = img[top:top + ch, left:left + cw]
    if lab is not None:
        lab = lab[top:top + ch, left:left + cw]
    return img, lab


def random_hflip_pair(img: np.ndarray, lab: np.ndarray | None, rng: np.random.Generator,
                      p: float = 0.5) -> tuple[np.ndarray, np.ndarray | None]:
    if rng.random() < p:
        img = img[:, ::-1]
        if lab is not None:
            lab = lab[:, ::-1]
    return img, lab


def normalize(img: np.ndarray) -> np.ndarray:
    """uint8 [0, 255] -> float32 [-1, 1] (torchvision Normalize(0.5, 0.5))."""
    return img.astype(np.float32) / 127.5 - 1.0


def draw_train_params(img: np.ndarray, lab: np.ndarray | None, *, crop_hw: tuple[int, int],
                      rng: np.random.Generator, resize_hw: tuple[int, int] | None = None,
                      flip_p: float = 0.5):
    """Resize (if asked, or if the image is smaller than the crop) and draw
    the crop and flip parameters: ``(img, lab, top, left, flip)``. The draw
    order (top, left, flip) is the contract the numpy and native pixel
    paths share."""
    if resize_hw is not None:
        img, lab = resize_pair(img, lab, resize_hw)
    ch, cw = crop_hw
    h, w = img.shape[:2]
    if h < ch or w < cw:
        scale = max(ch / h, cw / w)
        img, lab = resize_pair(img, lab, (max(ch, int(round(h * scale))),
                                          max(cw, int(round(w * scale)))))
        h, w = img.shape[:2]
    top = int(rng.integers(0, h - ch + 1))
    left = int(rng.integers(0, w - cw + 1))
    flip = rng.random() < flip_p
    return img, lab, top, left, flip


def train_transform(img: np.ndarray, lab: np.ndarray | None, *, crop_hw: tuple[int, int],
                    rng: np.random.Generator, resize_hw: tuple[int, int] | None = None
                    ) -> tuple[np.ndarray, np.ndarray | None]:
    """resize -> random crop -> random flip -> normalize (the numpy path)."""
    img, lab, top, left, flip = draw_train_params(img, lab, crop_hw=crop_hw, rng=rng,
                                                  resize_hw=resize_hw)
    ch, cw = crop_hw
    img = img[top:top + ch, left:left + cw]
    lab = lab[top:top + ch, left:left + cw] if lab is not None else None
    if flip:
        img = img[:, ::-1]
        lab = lab[:, ::-1] if lab is not None else None
    img = normalize(np.ascontiguousarray(img))
    lab = np.ascontiguousarray(lab) if lab is not None else None
    return img, lab


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
