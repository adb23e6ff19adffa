"""Faults planted in the program, to show that ``correct`` fails under them.

Each is a context manager that breaks the port underneath an unchanged
run: the tests hold each against the cells' limits at a CPU size, and
``calibrate.py --planted NAME:SEEDS`` reads it on the card at the cell's
own size. Never used by a run.
"""

from __future__ import annotations

import contextlib


@contextlib.contextmanager
def _patched(module, name, value):
    old = getattr(module, name)
    setattr(module, name, value)
    try:
        yield
    finally:
        setattr(module, name, old)


def state_unchanged():
    """Every update is skipped: the step returns its parameters unchanged."""
    from cyclegan_tpu_torch.train import cyclegan

    return _patched(cyclegan.CycleGANTrainer, "_update", lambda self, *a: None)


def half_batch():
    """Each step takes the first half of its batch's rows, means over those."""
    from cyclegan_tpu_torch.train import cyclegan

    step = cyclegan.CycleGANTrainer.train_step

    def half(self, state, batch):
        return step(self, state, {k: v[:len(v) // 2] for k, v in batch.items()})

    return _patched(cyclegan.CycleGANTrainer, "train_step", half)


def never_swap():
    """A full pool hands back every new fake: the swap branch is lost."""
    import torch

    from cyclegan_tpu_torch.train import cyclegan

    query = cyclegan.pool_query_with_decisions

    def keep_new(state, items, use_new, rand_idx):
        return query(state, items, torch.ones_like(torch.as_tensor(use_new)), rand_idx)

    return _patched(cyclegan, "pool_query_with_decisions", keep_new)


def no_decay():
    """The LambdaLR keeps the factor 1: the schedule never decays."""
    from cyclegan_tpu_torch.train import schedule

    return _patched(schedule, "make_lambda_lr", lambda **kw: (lambda step: 1.0))


def answer_altered():
    """Every served class is moved to the next class."""
    import torch

    import cyclegan_tpu_torch.serve as port_serve

    uint8_output = port_serve.uint8_output

    def altered(fn):
        inner = uint8_output(fn)
        return lambda x: ((inner(x).long() + 1) % 21).to(torch.uint8)

    return _patched(port_serve, "uint8_output", altered)


TRAIN = {"state_unchanged": state_unchanged, "half_batch": half_batch,
         "never_swap": never_swap, "no_decay": no_decay}
SERVE = {"answer_altered": answer_altered}
