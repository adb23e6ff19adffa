"""The numbers that decide ``correct``, each a gap between the program's
reading and the reference's, and the verdict against the cell's limits.

Leaf norms are compared by the worst leaf: the gap between the program's
norm and the reference's, over the larger of that leaf's reference norm
and the median leaf's (some gradients are all but zero). The parameter
change leaves out leaves whose reference gradient is under a thousandth of
the median leaf's: a bias ahead of an instance norm has a gradient of zero
to rounding, and Adam moves it by its round-off alone.
"""

from __future__ import annotations

import math
import statistics

NEGLIGIBLE_GRAD = 1e-3


def loss_gap(prog: list, ref: list, keys) -> float:
    """Widest relative gap of any loss of any step."""
    return max(abs(p[k] - r[k]) / max(abs(r[k]), 1e-12)
               for p, r in zip(prog, ref) for k in keys)


def leaf_gap(prog: dict, ref: dict, names=None) -> float:
    names = sorted(ref) if names is None else sorted(names)
    med = statistics.median(ref[n] for n in names)
    return max(abs(prog.get(n, 0.0) - ref[n]) / max(ref[n], med, 1e-30) for n in names)


def moved_leaves(ref_grads: dict) -> list:
    """Leaves whose reference gradient is not nought to rounding."""
    med = statistics.median(ref_grads.values())
    return [n for n, g in ref_grads.items() if g >= NEGLIGIBLE_GRAD * med]


def median_leaf_gap(prog: dict, ref: dict, names) -> float:
    """The median leaf's gap (each leaf's as in :func:`leaf_gap`)."""
    med = statistics.median(ref[n] for n in names)
    return statistics.median(abs(prog.get(n, 0.0) - ref[n]) / max(ref[n], med, 1e-30)
                             for n in names)


def train_numbers(prog: dict, ref: dict, loss_keys) -> dict:
    """The numbers compared, of two readings ({"losses": [per step {key:
    float}], "grads": {leaf: norm of the first gradient}, "change": {leaf:
    norm of the change after the steps}}): ``step1_loss_gap``, the widest
    gap of the first step's losses (the later steps' losses follow Adam's
    first update, which moves every weight by the learning rate times the
    sign of its gradient, so rounding that flips a sign moves them; PERF.md
    has both readings), and over the leaves that move the worst leaf's and
    the median leaf's gap of the first gradient and the worst leaf's gap
    of the change."""
    moved = moved_leaves(ref["grads"])
    return {"step1_loss_gap": loss_gap(prog["losses"][:1], ref["losses"][:1], loss_keys),
            "grad_gap": leaf_gap(prog["grads"], ref["grads"], moved),
            "grad_median_gap": median_leaf_gap(prog["grads"], ref["grads"], moved),
            "change_gap": leaf_gap(prog["change"], ref["change"], moved)}


def worst_leaf(prog: dict, ref: dict, names=None) -> list:
    names = sorted(ref) if names is None else sorted(names)
    med = statistics.median(ref[n] for n in names)
    gaps = {n: abs(prog.get(n, 0.0) - ref[n]) / max(ref[n], med, 1e-30) for n in names}
    n = max(gaps, key=gaps.get)
    return [n, gaps[n], prog.get(n, 0.0), ref[n]]


def train_detail(prog: dict, ref: dict, loss_keys) -> dict:
    """What the numbers are made of: every loss's gap at every step, every
    step's widest, and the worst leaf (name, gap, program's and reference's
    norms) of the gradient and the change, over the moved leaves and over
    all."""
    moved = moved_leaves(ref["grads"])
    return {"loss_by_key": {k: [abs(p[k] - r[k]) / max(abs(r[k]), 1e-12)
                                for p, r in zip(prog["losses"], ref["losses"])]
                            for k in loss_keys},
            "loss_gap_by_step": [loss_gap([p], [r], loss_keys)
                                 for p, r in zip(prog["losses"], ref["losses"])],
            "ref_losses_step1": ref["losses"][0],
            "moved": len(moved), "leaves": len(ref["grads"]),
            "grad_worst_moved": worst_leaf(prog["grads"], ref["grads"], moved),
            "grad_worst_all": worst_leaf(prog["grads"], ref["grads"]),
            "change_worst_moved": worst_leaf(prog["change"], ref["change"], moved),
            "change_worst_all": worst_leaf(prog["change"], ref["change"]),
            "change_median_gap": median_leaf_gap(prog["change"], ref["change"], moved),
            "loss_gap_all_steps": loss_gap(prog["losses"], ref["losses"], loss_keys),
            "grad_gaps_moved": sorted(
                ((abs(prog["grads"].get(n, 0.0) - ref["grads"][n])
                  / max(ref["grads"][n], statistics.median(ref["grads"][m] for m in moved)), n)
                 for n in moved), reverse=True)[:8]}


def verdict(numbers: dict, limits: dict) -> tuple[bool, dict]:
    """(every number finite and within its limit, {name: {value, limit}})."""
    missing = set(numbers) - set(limits)
    if missing:
        raise KeyError(f"no limit for {sorted(missing)}")
    checks = {k: {"value": v, "limit": limits[k]} for k, v in numbers.items()}
    ok = all(math.isfinite(v) and v <= limits[k] for k, v in numbers.items())
    return ok, checks
