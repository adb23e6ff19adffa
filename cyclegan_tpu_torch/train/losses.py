"""Losses (reference ``nn.MSELoss`` / ``nn.L1Loss`` / ``nn.CrossEntropyLoss``).

Counterpart of ``cyclegan_tpu/train/losses.py``: LSGAN adversarial = MSE
against constant 0/1 targets; cycle consistency = L1; supervised
segmentation = pixel cross-entropy masking the ignore index (VOC's 255
border). All in float32, all means. Logits are channels-last ``(..., K)``,
the JAX package's layout. ``count`` replaces a mean's divisor: a rank
holding an H slab (or rows) of a larger batch divides its sum by the
count of the whole, so that the ranks' losses add up to its mean.
"""

from __future__ import annotations

import torch


def _mean(t: torch.Tensor, count: float | None) -> torch.Tensor:
    return t.mean() if count is None else t.sum() / count


def lsgan_loss(scores: torch.Tensor, target_is_real: bool,
               count: float | None = None) -> torch.Tensor:
    """MSE against an all-ones (real) or all-zeros (fake) target map."""
    scores = scores.float()
    return _mean(torch.square(scores - (1.0 if target_is_real else 0.0)), count)


def l1_loss(a: torch.Tensor, b: torch.Tensor, count: float | None = None) -> torch.Tensor:
    return _mean((a.float() - b.float()).abs(), count)


def cross_entropy_loss(logits: torch.Tensor, labels: torch.Tensor, *,
                       ignore_index: int | None = 255,
                       count: torch.Tensor | None = None) -> torch.Tensor:
    """Pixel cross-entropy of channels-last logits (N, H, W, K) against
    (N, H, W) integer labels: the mean over the pixels that are not
    ``ignore_index``, with a count of at least 1 (an all-void batch gives 0).
    ``count`` replaces that count as the divisor (a data-parallel rank
    divides by the global batch's valid pixels over the ranks)."""
    log_probs = torch.log_softmax(logits.float(), dim=-1)
    labels = labels.long()
    if ignore_index is not None:
        valid = labels != ignore_index
        safe = torch.where(valid, labels, 0)
    else:
        valid = torch.ones_like(labels, dtype=torch.bool)
        safe = labels
    picked = log_probs.gather(-1, safe.unsqueeze(-1)).squeeze(-1)
    picked = torch.where(valid, picked, 0.0)
    return -picked.sum() / (valid.sum().clamp_min(1) if count is None else count)
