"""LR schedule and optimizer (reference ``utils.LambdaLR`` and Adam).

Counterpart of ``cyclegan_tpu/train/schedule.py``. The reference's factor
``1 - max(0, epoch + offset - decay_epoch) / (epochs - decay_epoch)`` is
constant until ``decay_epoch`` and then falls linearly to 0 at ``epochs``;
it is stepped per epoch, kept here by the staircase ``epoch = step //
steps_per_epoch`` inside a ``torch.optim.lr_scheduler.LambdaLR`` stepped
once per update. Adam has the reference's betas (0.5, 0.999) and eps 1e-8
(torch's update is optax's ``scale_by_adam``: eps after the square root of
the bias-corrected second moment).
"""

from __future__ import annotations

from typing import Callable, Iterable

import torch


def lambda_lr_factor(epoch: int, *, epochs: int, offset: int, decay_epoch: int) -> float:
    """The reference's per-epoch multiplicative LR factor, clamped at 0 (a
    run past ``epochs`` must not turn the LR negative); ``epochs ==
    decay_epoch`` means a constant LR."""
    num = max(0.0, float(epoch) + offset - decay_epoch)
    denom = max(epochs - decay_epoch, 1)
    return max(0.0, 1.0 - num / float(denom))


def make_lambda_lr(*, epochs: int, decay_epoch: int, steps_per_epoch: int,
                   offset: int = 0) -> Callable[[int], float]:
    """Step -> LR factor with the per-epoch staircase (for ``LambdaLR``)."""

    def factor(step: int) -> float:
        return lambda_lr_factor(step // steps_per_epoch, epochs=epochs, offset=offset,
                                decay_epoch=decay_epoch)

    return factor


def make_adam(params: Iterable[torch.nn.Parameter], lr: float, *, b1: float = 0.5,
              b2: float = 0.999, eps: float = 1e-8) -> torch.optim.Adam:
    """Adam with the reference's betas."""
    return torch.optim.Adam(params, lr=lr, betas=(b1, b2), eps=eps)


def make_scheduler(opt: torch.optim.Optimizer, *, epochs: int, decay_epoch: int,
                   steps_per_epoch: int, offset: int = 0
                   ) -> torch.optim.lr_scheduler.LambdaLR:
    """LambdaLR over steps reproducing the per-epoch staircase; step it once
    after each ``opt.step()``."""
    return torch.optim.lr_scheduler.LambdaLR(
        opt, make_lambda_lr(epochs=epochs, decay_epoch=decay_epoch,
                            steps_per_epoch=steps_per_epoch, offset=offset))
