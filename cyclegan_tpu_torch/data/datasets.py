"""Dataset readers, tables and the synthetic generator (a copy of
``cyclegan_tpu/data/datasets.py``).

Directory-convention readers for VOC2012, Cityscapes and ACDC, and a
synthetic dataset (random coloured shapes with exact masks) that needs no
data on disk. A dataset yields (image uint8 HWC, label uint8 HW) pairs; the
loader applies the transforms. The labeled/unlabeled split is drawn from a
fixed seed.
"""

from __future__ import annotations

import os
from dataclasses import dataclass, field
from typing import Sequence

import numpy as np
from PIL import Image

from cyclegan_tpu_torch.data.palette import encode_colormap

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


@dataclass
class SegmentationDataset:
    """Samples loaded lazily: ``items`` are (image path, label path or None)
    pairs, or ints for the synthetic dataset (generated once, then cached)."""

    name: str
    items: Sequence
    num_classes: int
    in_channels: int
    ignore_index: int = 255
    synthetic_size_hw: tuple[int, int] = (160, 160)
    _cache: dict = field(default_factory=dict, repr=False)

    def __len__(self) -> int:
        return len(self.items)

    def get(self, i: int) -> tuple[np.ndarray, np.ndarray | None]:
        item = self.items[i]
        if isinstance(item, (int, np.integer)):
            if item not in self._cache:
                self._cache[item] = _synthetic_sample(
                    int(item), self.synthetic_size_hw, self.num_classes, self.in_channels)
            return self._cache[item]
        img_path, lab_path = item
        img = np.asarray(Image.open(img_path).convert("L" if self.in_channels == 1 else "RGB"))
        if self.in_channels == 1:
            img = img[..., None]
        lab = None
        if lab_path is not None:
            lab_img = Image.open(lab_path)
            if lab_img.mode == "P":
                lab = np.asarray(lab_img)  # palette indices are the class ids
            elif lab_img.mode in ("RGB", "RGBA"):
                # An RGB-encoded palette mask: decode the colours. PIL's
                # convert('P') would quantize to the web palette instead.
                lab = encode_colormap(np.asarray(lab_img.convert("RGB")), self.num_classes)
            else:
                lab = np.asarray(lab_img.convert("L"))
        return img, lab


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


def _voc_items(root: str, split: str):
    list_file = os.path.join(root, "ImageSets", "Segmentation", f"{split}.txt")
    with open(list_file) as f:
        names = [ln.strip() for ln in f if ln.strip()]
    return [(os.path.join(root, "JPEGImages", n + ".jpg"),
             os.path.join(root, "SegmentationClass", n + ".png")) for n in names]


def _cityscapes_items(root: str, split: str):
    img_root = os.path.join(root, "leftImg8bit", split)
    lab_root = os.path.join(root, "gtFine", split)
    items = []
    for city in sorted(os.listdir(img_root)):
        for fn in sorted(os.listdir(os.path.join(img_root, city))):
            if not fn.endswith("leftImg8bit.png"):
                continue
            base = fn[: -len("_leftImg8bit.png")]
            items.append((os.path.join(img_root, city, fn),
                          os.path.join(lab_root, city, base + "_gtFine_labelTrainIds.png")))
    return items


def _acdc_items(root: str, split: str):
    """ACDC as per-slice PNGs: <root>/<split>/{images,labels}/*.png."""
    img_dir = os.path.join(root, split, "images")
    lab_dir = os.path.join(root, split, "labels")
    items = []
    for fn in sorted(os.listdir(img_dir)):
        lab = os.path.join(lab_dir, fn)
        items.append((os.path.join(img_dir, fn), lab if os.path.exists(lab) else None))
    return items


def make_dataset(name: str, root: str | None = None, *, split: str = "train",
                 size: int | None = None) -> SegmentationDataset:
    """Build a dataset; the synthetic ones need no ``root``."""
    if name not in DATASET_SPECS:
        raise ValueError(f"unknown dataset: {name!r} (expected {sorted(DATASET_SPECS)})")
    num_classes, in_ch, ignore = DATASET_SPECS[name]
    if name.startswith("synthetic"):
        n = size or (200 if split == "train" else 40)
        offset = {"train": 0, "val": 1_000_000, "test": 2_000_000}.get(split, 0)
        items = list(range(offset, offset + n))
    else:
        if root is None or not os.path.isdir(root):
            raise FileNotFoundError(f"dataset root for {name!r} not found: {root!r} — use "
                                    f"dataset='synthetic' for a no-data run")
        items = {"voc2012": _voc_items, "cityscapes": _cityscapes_items,
                 "acdc": _acdc_items}[name](root, split)
        if size is not None:
            items = items[:size]
    return SegmentationDataset(name, items, num_classes, in_ch, ignore)


def split_labeled(ds: SegmentationDataset, labeled_fraction: float, seed: int = 0
                  ) -> tuple[SegmentationDataset, SegmentationDataset]:
    """Fixed-seed labeled/unlabeled split for semi-supervision; an empty
    unlabeled part reuses the labeled items."""
    n = len(ds)
    n_lab = max(1, int(round(n * labeled_fraction)))
    perm = np.random.default_rng(seed).permutation(n)
    lab_items = [ds.items[i] for i in perm[:n_lab]]
    unlab_items = [ds.items[i] for i in perm[n_lab:]] or lab_items

    def mk(items):
        return SegmentationDataset(ds.name, items, ds.num_classes, ds.in_channels,
                                   ds.ignore_index, ds.synthetic_size_hw)

    return mk(lab_items), mk(unlab_items)
