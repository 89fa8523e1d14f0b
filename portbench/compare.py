"""The numbers that decide `correct`, from a side under test and the reference.

Both sides come as records of one form (`reference/train.py`,
`reference/enhance.py`), so the control, the reference in a lower
precision put in the program's place, gives the same numbers as the
program does.

Training steps, after the benchmark's rule: each step's loss as a gap
relative to the reference's; the first gradient and the change of the
weights after the steps followed, each leaf by the gap between the two
sides' norms (not the norm of their difference), over the larger of the
reference leaf's norm and the median leaf's, the worst leaf counting.
Leaves whose reference gradient is under a thousandth of the median
leaf's move under Adam by round-off alone (a key bias under softmax is
the classic case) and are left out of the change.
"""
from __future__ import annotations

from typing import Dict

import numpy as np

TINY_GRAD = 1e-3


def leaf_gap(side: Dict[str, float], ref: Dict[str, float],
             keep=None) -> float:
    keys = [k for k in ref if keep is None or k in keep]
    if set(side) != set(ref) or not keys:
        return float("inf")
    med = float(np.median([ref[k] for k in ref]))
    return max(abs(side[k] - ref[k]) / max(ref[k], med, 1e-30)
               for k in keys)


def moved(grad: Dict[str, float]) -> set:
    med = float(np.median(list(grad.values())))
    return {k for k, v in grad.items() if v >= TINY_GRAD * med}


def loss_gap(side, ref) -> float:
    if len(side) != len(ref) or not ref:
        return float("inf")
    return max(abs(a - b) / max(abs(b), 1e-30)
               for s, r in zip(side, ref) for a, b in zip(s, r))


def pcm_numbers(side: Dict[str, np.ndarray], ref: Dict[str, np.ndarray]):
    """(largest gap in LSB, RMS gap in LSB over every sample compared)."""
    if set(side) != set(ref) or not ref:
        return float("inf"), float("inf")
    worst, sq, count = 0.0, 0.0, 0
    for k in ref:
        a, b = np.asarray(side[k], np.int64), np.asarray(ref[k], np.int64)
        if a.shape != b.shape:
            return float("inf"), float("inf")
        d = np.abs(a - b)
        worst = max(worst, float(d.max(initial=0)))
        sq += float((d.astype(np.float64) ** 2).sum())
        count += d.size
    return worst, (sq / max(count, 1)) ** 0.5


def score_gap(side, ref) -> float:
    if set(side) != set(ref) or not ref:
        return float("inf")
    return max(float(np.max(np.abs(np.asarray(side[k], np.float64)
                                   - np.asarray(ref[k], np.float64))))
               for k in ref)


def score_gaps_by_metric(side: dict, ref: dict) -> Dict[str, float]:
    """The widest score gap of each metric (a reading beside the numbers,
    for finding which metric a wide `score_gap` comes from)."""
    names = ("siib", "haspi", "estoi", "pesq", "visqol")
    return {m: max(abs(float(side[k][i]) - float(ref[k][i])) for k in ref)
            for i, m in enumerate(names)}


STEPS = ("d", "g", "g_own", "win_d", "win_g")


def train_numbers(side: dict, ref: dict) -> Dict[str, float]:
    """`d_*`: epoch 1's first D steps from the seed; `g_*`: epoch 2's first
    G steps from the drawn generator and the program's discriminators;
    `g_own_*`: the same from the reference's own replay of epoch 1 (where
    the reference made it); `win_d_*`, `win_g_*`: the window's last
    epoch's first steps, from the program's state there."""
    pm, pr = pcm_numbers(side["pcm"], ref["pcm"])
    out = {"pcm_max_lsb": pm, "pcm_rms_lsb": pr,
           "score_gap": score_gap(side["scores"], ref["scores"])}
    for k in STEPS:
        if f"{k}_losses" not in ref:
            continue
        out[f"{k}_loss_gap"] = loss_gap(side[f"{k}_losses"],
                                        ref[f"{k}_losses"])
        out[f"{k}_grad_gap"] = leaf_gap(side[f"{k}_grad1"], ref[f"{k}_grad1"])
        out[f"{k}_change_gap"] = leaf_gap(side[f"{k}_change"],
                                          ref[f"{k}_change"],
                                          moved(ref[f"{k}_grad1"]))
    return out


def enhance_numbers(side: dict, ref: dict) -> Dict[str, float]:
    pm, pr = pcm_numbers(side["pcm"], ref["pcm"])
    return {"pcm_max_lsb": pm, "pcm_rms_lsb": pr}


def define_all(checks, numbers: Dict[str, float]) -> None:
    """The numbers the cell's file gives a limit decide `correct`; one it
    lists that the comparison does not give leaves the run not correct."""
    for name, value in numbers.items():
        if name in checks.limits:
            checks.define(name, value)


def train_checks(checks, side: dict, ref: dict) -> None:
    define_all(checks, train_numbers(side, ref))
