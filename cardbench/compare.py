"""The numbers that decide ``correct``, and their judgement.

Each number compares the program's readings of its first training steps
with the reference's (``cardbench.reference.train``):

* ``loss_gap``: the largest absolute gap between the two sides' loss of
  the same step;
* ``grad_norm_gap``: the largest gap between the two sides' global
  gradient norm (before clipping) of the same step, over the reference's;
* ``grad_leaf_gap``: over every layer's slice of every leaf, the gap
  between the norms of the first step's gradient as the optimizer gets it,
  over the larger of the reference's norm of that slice and of the median
  slice;
* ``change_leaf_gap``: the same of the change of the parameters over the
  steps, leaving out the slices whose reference gradient is under
  ``ZERO_GRAD`` of the median slice's (they move by round-off alone).

The gap of two norms, not the norm of their difference: rounding that
scatters each element's error leaves a norm nearly as it was, while a step
that drops half the batch, updates nothing or counts a leaf twice moves it.
"""

from __future__ import annotations

from statistics import median

ZERO_GRAD = 1e-3
NUMBERS = ("loss_gap", "grad_norm_gap", "grad_leaf_gap", "change_leaf_gap")


def _leaf_gap(got: dict[str, float], want: dict[str, float],
              keys: list[str]) -> tuple[float, str]:
    floor = median([want[k] for k in keys])
    worst, where = 0.0, ""
    for k in keys:
        gap = abs(got[k] - want[k]) / max(want[k], floor, 1e-30)
        if gap >= worst:
            worst, where = gap, k
    return worst, where


def gaps(got: dict, want: dict) -> tuple[dict[str, float], dict[str, str]]:
    """The numbers, and the slice each leaf number was worst at."""
    if set(got["grad"]) != set(want["grad"]) or \
            set(got["change"]) != set(want["change"]):
        raise ValueError("the two sides' leaves differ")
    steps = len(want["loss"])
    if len(got["loss"]) != steps or len(got["grad_norm"]) != steps:
        raise ValueError("the two sides took different numbers of steps")
    keys = sorted(want["grad"])
    floor = median([want["grad"][k] for k in keys])
    moving = [k for k in keys if want["grad"][k] >= ZERO_GRAD * floor]
    grad, grad_at = _leaf_gap(got["grad"], want["grad"], keys)
    change, change_at = _leaf_gap(got["change"], want["change"], moving)
    numbers = {
        "loss_gap": max(abs(a - b) for a, b in zip(got["loss"],
                                                   want["loss"])),
        "grad_norm_gap": max(abs(a - b) / b for a, b in
                             zip(got["grad_norm"], want["grad_norm"])),
        "grad_leaf_gap": grad,
        "change_leaf_gap": change,
    }
    return numbers, {"grad_leaf_gap": grad_at, "change_leaf_gap": change_at}


def judge(numbers: dict[str, float], limits: dict) -> tuple[bool, dict]:
    """(correct, {name: {"value", "limit"}}) for every number that has a
    limit; a number that is not finite fails."""
    checks = {}
    ok = True
    for name, spec in limits["numbers"].items():
        value = numbers[name]
        passed = value == value and value <= spec["limit"]
        ok = ok and passed
        checks[name] = {"value": value, "limit": spec["limit"]}
    return ok, checks
