"""Class-name tables (a copy of ``cyclegan_tpu/data/datasets.py``'s
``CLASS_NAMES`` and ``class_names``; the dataset readers arrive with the
data slice)."""

from __future__ import annotations

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
