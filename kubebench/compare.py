"""The comparisons that decide ``correct``: how a program's readings are
held against the reference's. Imports nothing of the program."""

from __future__ import annotations

import statistics

# leaves whose reference gradient is under this share of the median
# leaf's move by round-off alone under Adam, and are left out of the
# comparison of the parameters' change
NOUGHT_GRAD = 1e-3


def worst_leaf(prog: dict, ref: dict, keep=None) -> tuple[float, str]:
    """The worst leaf's gap between the program's and the reference's norm
    (not the norm of their difference), against the reference's norm of
    that leaf or of the median leaf, whichever is larger. -> (gap, leaf)."""
    names = [k for k in ref if keep is None or k in keep]
    if set(prog) != set(ref):
        raise ValueError(f"leaves differ: {sorted(set(prog) ^ set(ref))}")
    med = statistics.median(ref[k] for k in names)
    return max((abs(prog[k] - ref[k]) / max(ref[k], med), k) for k in names)


def moving_leaves(first_grad_ref: dict) -> set:
    med = statistics.median(first_grad_ref.values())
    return {k for k, g in first_grad_ref.items() if g >= NOUGHT_GRAD * med}


def train_readings(prog: dict, ref: dict) -> dict:
    """The training cells' numbers: the steps' losses (the largest gap,
    and the first step's alone), each leaf's first gradient, each leaf's
    change after the steps the reference followed. A cell's limits file
    names the ones it compares."""
    grad, grad_leaf = worst_leaf(prog["first_grad"], ref["first_grad"])
    change, change_leaf = worst_leaf(prog["change"], ref["change"],
                                     moving_leaves(ref["first_grad"]))
    # relative loss gaps of the steps both took
    steps = [abs(p - r) / abs(r) for p, r in zip(prog["losses"], ref["losses"])]
    return {"loss_gap": max(steps), "first_loss_gap": steps[0], "loss_gap_by_step": steps,
            "grad_norm_gap": grad, "change_norm_gap": change,
            "worst_leaf": {"grad_norm_gap": grad_leaf, "change_norm_gap": change_leaf}}
