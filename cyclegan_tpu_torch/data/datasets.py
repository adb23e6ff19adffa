"""Dataset tables and the synthetic sample (copies of
``cyclegan_tpu/data/datasets.py``'s ``DATASET_SPECS``, ``CLASS_NAMES``,
``class_names`` and ``_synthetic_sample``; the dataset readers arrive with
the data slice)."""

from __future__ import annotations

import numpy as np

DATASET_SPECS = {
    # name: (num_classes, in_channels, ignore_index)
    "voc2012": (21, 3, 255),
    "cityscapes": (19, 3, 255),
    "acdc": (4, 1, 255),
    "synthetic": (21, 3, 255),
    "synthetic_gray": (4, 1, 255),
}

# VOC in the official devkit order; Cityscapes in the 19-trainId order; ACDC
# in the cardiac-MRI convention.
CLASS_NAMES = {
    "voc2012": (
        "background", "aeroplane", "bicycle", "bird", "boat", "bottle",
        "bus", "car", "cat", "chair", "cow", "diningtable", "dog", "horse",
        "motorbike", "person", "pottedplant", "sheep", "sofa", "train",
        "tvmonitor",
    ),
    "cityscapes": (
        "road", "sidewalk", "building", "wall", "fence", "pole",
        "traffic light", "traffic sign", "vegetation", "terrain", "sky",
        "person", "rider", "car", "truck", "bus", "train", "motorcycle",
        "bicycle",
    ),
    "acdc": ("background", "right ventricle", "myocardium", "left ventricle"),
}


def class_names(dataset: str, num_classes: int) -> tuple[str, ...]:
    """The dataset's name table when its length matches ``num_classes``,
    else ``class_{i}`` for every class."""
    names = CLASS_NAMES.get(dataset)
    if names is not None and len(names) == num_classes:
        return names
    return tuple(f"class_{i}" for i in range(num_classes))


def _synthetic_sample(idx: int, size_hw: tuple[int, int], num_classes: int,
                      in_channels: int) -> tuple[np.ndarray, np.ndarray]:
    """Deterministic random-shapes image (uint8 HWC) and its exact mask
    (uint8 HW). Class k has its own base intensity and hue, so a
    segmentation net can learn the mapping."""
    rng = np.random.default_rng(977_131 + idx)
    h, w = size_hw
    lab = np.zeros((h, w), np.uint8)  # class 0 = background
    img = np.empty((h, w, 3), np.float32)
    bg = rng.uniform(0, 60, size=3)
    img[:] = bg
    yy, xx = np.mgrid[0:h, 0:w]
    for _ in range(rng.integers(2, 6)):
        cls = int(rng.integers(1, num_classes))
        cy, cx = rng.uniform(0, h), rng.uniform(0, w)
        ry, rx = rng.uniform(h * 0.08, h * 0.3), rng.uniform(w * 0.08, w * 0.3)
        if rng.random() < 0.5:
            mask = ((yy - cy) / ry) ** 2 + ((xx - cx) / rx) ** 2 <= 1.0
        else:
            mask = (np.abs(yy - cy) <= ry) & (np.abs(xx - cx) <= rx)
        lab[mask] = cls
        hue = np.array([
            100 + 155 * ((cls * 37) % 100) / 100,
            100 + 155 * ((cls * 59) % 100) / 100,
            100 + 155 * ((cls * 83) % 100) / 100,
        ])
        img[mask] = hue + rng.normal(0, 4, size=3)
    img += rng.normal(0, 5, size=img.shape)
    img = np.clip(img, 0, 255).astype(np.uint8)
    if in_channels == 1:
        img = img.mean(axis=-1, keepdims=True).astype(np.uint8)
    return img, lab
