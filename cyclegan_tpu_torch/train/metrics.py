"""Segmentation metrics on tensors (reference ``scores()``).

Counterpart of ``cyclegan_tpu/train/metrics.py``: a confusion matrix by
bincount, and pixel accuracy, mean class accuracy, per-class IoU, mIoU and
frequency-weighted IoU derived from it.
"""

from __future__ import annotations

import torch


def confusion_matrix(pred: torch.Tensor, label: torch.Tensor, num_classes: int, *,
                     ignore_index: int | None = 255) -> torch.Tensor:
    """(num_classes, num_classes) int64 histogram; rows = ground truth,
    columns = prediction. Labels equal to ``ignore_index`` or >= num_classes
    are dropped."""
    # Index math in int32 and up: uint8 predictions would wrap in
    # label * num_classes + pred.
    pred = pred.reshape(-1).to(torch.int32)
    label = label.reshape(-1).to(torch.int32)
    valid = label < num_classes
    if ignore_index is not None:
        valid &= label != ignore_index
    idx = label[valid] * num_classes + pred[valid]
    hist = torch.bincount(idx, minlength=num_classes * num_classes)
    return hist[:num_classes * num_classes].reshape(num_classes, num_classes)


def scores(hist: torch.Tensor) -> dict[str, torch.Tensor]:
    """The reference's metric dict from an accumulated confusion matrix."""
    hist = hist.to(torch.float64)
    tp = torch.diagonal(hist)
    gt_total = hist.sum(dim=1)
    pred_total = hist.sum(dim=0)
    union = gt_total + pred_total - tp
    total = hist.sum().clamp_min(1)

    pixel_acc = tp.sum() / total
    class_acc = tp / gt_total.clamp_min(1)
    present = gt_total > 0
    mean_acc = torch.where(present, class_acc, 0.0).sum() / present.sum().clamp_min(1)
    iou = tp / union.clamp_min(1)
    valid_iou = union > 0
    miou = torch.where(valid_iou, iou, 0.0).sum() / valid_iou.sum().clamp_min(1)
    freq = gt_total / total
    fwiou = torch.where(valid_iou, freq * iou, 0.0).sum()
    return {"pixel_acc": pixel_acc, "mean_acc": mean_acc, "miou": miou,
            "fwiou": fwiou, "per_class_iou": iou}
