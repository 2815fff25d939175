"""The numbers that decide ``correct``: each a gap between what the timed
path produced and what the plain reference computes from the same
inputs, judged against the cell's limits (``workloads/<cell>.json``,
``limits``)."""
from __future__ import annotations

import statistics
from typing import Dict, List, Optional, Sequence

# a leaf whose reference gradient is under this share of the median
# leaf's is nought to rounding (a key's bias under softmax): Adam moves
# it by round-off alone, so it is left out of the change's comparison
GRAD_NOUGHT = 1e-3


def loss_gap(prog: Sequence[Sequence[float]],
             ref: Sequence[Sequence[float]]) -> float:
    """The largest relative gap of a step's total loss (the last entry of
    each row), over the steps."""
    return max(abs(p[-1] - r[-1]) / max(abs(r[-1]), 1e-12)
               for p, r in zip(prog, ref))


def term_gap(prog: Sequence[Sequence[float]],
             ref: Sequence[Sequence[float]]) -> float:
    """The largest gap of a loss term, over the terms of every step, each
    against the larger of its reference magnitude and the median term's
    of that step."""
    worst = 0.0
    for p, r in zip(prog, ref):
        floor = statistics.median(abs(x) for x in r)
        for a, b in zip(p, r):
            worst = max(worst, abs(a - b) / max(abs(b), floor, 1e-12))
    return worst


def leaf_gaps(prog: Dict[str, float], ref: Dict[str, float],
              leaves: Optional[List[str]] = None) -> List[float]:
    """Each leaf's gap of two norms, program against reference, against
    the larger of the reference leaf's norm and the median leaf's."""
    names = leaves if leaves is not None else list(ref)
    floor = statistics.median(ref[n] for n in names)
    return [abs(prog[n] - ref[n]) / max(ref[n], floor, 1e-30)
            for n in names]


def worst_leaf(prog: Dict[str, float], ref: Dict[str, float],
               leaves: Optional[List[str]] = None) -> float:
    """The largest of ``leaf_gaps``."""
    return max(leaf_gaps(prog, ref, leaves))


def median_leaf(prog: Dict[str, float], ref: Dict[str, float],
                leaves: Optional[List[str]] = None) -> float:
    """The median of ``leaf_gaps``."""
    return statistics.median(leaf_gaps(prog, ref, leaves))


def moving_leaves(ref_grad: Dict[str, float]) -> List[str]:
    """The leaves whose reference gradient is not nought to rounding."""
    med = statistics.median(ref_grad.values())
    return [n for n, g in ref_grad.items() if g >= GRAD_NOUGHT * med]


TRAIN_NUMBERS = ("loss_gap", "term_gap", "grad_gap", "median_change_gap",
                 "rect_change_gap")


def train_numbers(prog: Dict, ref: Dict) -> Dict[str, float]:
    """The training cell's compared numbers from two reads of the
    compared steps (``reference/train.Reads``' keys); every number is
    infinite where the two sides ran different terms, leaves or RAdam
    branches, or no step took the rectified branch."""
    if list(prog["terms"]) != list(ref["terms"]) \
            or prog["names"] != ref["names"] \
            or prog["rectified"] != ref["rectified"] \
            or ref["rect_change"] is None:
        return {k: float("inf") for k in TRAIN_NUMBERS}

    def leaves(key, side):
        return dict(zip(side["names"], side[key]))
    rg = leaves("grad", ref)
    moving = moving_leaves(rg)
    # the first steps' change by its median leaf: RAdam's unrectified
    # update, the learning rate times the clipped gradient's mean, is
    # under one unit in the last place of most leaves' values, so a leaf's
    # change there is a few rounding steps of its values, and one element
    # rounded the other way moves that leaf's norm by some thousandths of
    # itself; the rectified steps, which divide by the second moment's
    # root, move a leaf thousands of times as far, and their change is
    # held leaf by leaf
    return {"loss_gap": loss_gap(prog["losses"], ref["losses"]),
            "term_gap": term_gap(prog["losses"], ref["losses"]),
            "grad_gap": worst_leaf(leaves("grad", prog), rg),
            "median_change_gap": median_leaf(leaves("change", prog),
                                             leaves("change", ref), moving),
            "rect_change_gap": worst_leaf(leaves("rect_change", prog),
                                          leaves("rect_change", ref),
                                          moving)}
