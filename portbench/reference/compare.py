"""The numbers that decide ``correct``, each a gap between what the timed
path produced and what the plain reference gives for the same inputs.

Training (the first three steps of the object the window drives):

* ``loss_gap``: the largest relative gap of a step's loss;
* ``grad_gap``: the first step's gradient as the optimizer got it (read
  from its first moment after one step, ``m / (1 - beta1)``), by the worst
  leaf: the gap between the program's and the reference's norm of that
  leaf, over the larger of the reference's norm of it and of the median
  leaf;
* ``change_gap``: the same for each leaf's change after the three steps,
  leaving out the leaves whose reference gradient is under a thousandth of
  the median leaf's (they move under Adam by round-off alone);
* ``grad_gap_median``, ``change_gap_median``: the median leaf's gap instead
  of the worst, steady where one small leaf's gap swings from seed to seed
  (a router whose top-2 choice of a few tokens flips on rounding).

A cell's limits file names the numbers it compares.

Serving (greedy requests the window finished):

* ``served_gap``: the widest gap by which a served token's reference logit
  lies below the reference's best at that position.
"""

from __future__ import annotations

import statistics

import torch

#: Leaves whose reference gradient norm is under this share of the median
#: leaf's are left out of ``change_gap``.
NOUGHT_GRAD = 1e-3


def _gaps(prog: list, ref: list, keep=None) -> list[tuple[float, int]]:
    """``(gap, leaf)`` of every kept leaf: the gap of the norms over the
    larger of the reference's norm of the leaf and of the median leaf."""
    idx = [i for i in range(len(ref)) if keep is None or keep[i]]
    floor = statistics.median(ref[i] for i in idx)
    return [(abs(prog[i] - ref[i]) / max(ref[i], floor), i) for i in idx]


def train_numbers(prog: dict, ref: dict, names: list) -> dict:
    """``{number: value}`` plus the worst leaves, from the program's and the
    reference's ``losses``, ``first_grad`` and ``change``."""
    loss_gap = max(abs(a - b) / abs(b) for a, b in zip(prog["losses"], ref["losses"]))
    grad = _gaps(prog["first_grad"], ref["first_grad"])
    floor = statistics.median(ref["first_grad"])
    keep = [g >= NOUGHT_GRAD * floor for g in ref["first_grad"]]
    change = _gaps(prog["change"], ref["change"], keep)
    return {
        "numbers": {"loss_gap": loss_gap, "grad_gap": max(grad)[0], "change_gap": max(change)[0],
                    "grad_gap_median": statistics.median(g for g, _ in grad),
                    "change_gap_median": statistics.median(g for g, _ in change)},
        "where": {"grad_gap": names[max(grad)[1]], "change_gap": names[max(change)[1]],
                  "left_out": [n for n, k in zip(names, keep) if not k]},
    }


def served_gaps(ref_logits: torch.Tensor, served: torch.Tensor) -> torch.Tensor:
    """Per position, the best reference logit minus the served token's."""
    best = ref_logits.max(dim=-1).values
    return best - ref_logits.gather(-1, served[:, None])[:, 0]


def held(numbers: dict, limits: dict) -> dict:
    """``{number: {"value", "limit"}}`` of each number the cell's limits
    file names: what decides ``correct``."""
    return {k: {"value": v, "limit": limits[k]} for k, v in numbers.items() if k in limits}


def within(checked: dict) -> bool:
    return all(c["value"] <= c["limit"] for c in checked.values())
