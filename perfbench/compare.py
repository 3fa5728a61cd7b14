"""The numbers that decide ``correct`` for a training cell, and their
reading from a run of SGD steps.

Both sides are read alike, from their state: a step's loss; the first
gradient as the optimizer got it, ``||w_0 - w_1|| / lr`` for each leaf;
and each leaf's change after the checked steps, ``||w_n - w_0||``, where
``w_0`` is drawn again from the seed. Each norm is compared by the worst
leaf: the gap between the two sides' norms over the reference's norm of
that leaf or of the median leaf, whichever is larger. Leaves whose
reference gradient is under a thousandth of the median leaf's (nought to
rounding) are left out of both gradient numbers.
"""

from __future__ import annotations

import math
import statistics

import torch

from perfbench.weights import diff_norm

#: Leaves whose reference gradient norm is below this share of the median
#: leaf's are left out.
NEGLIGIBLE_LEAF = 1e-3


class Readings:
    """One side's readings over the checked steps."""

    def __init__(self, losses, grad_norms, change_norms):
        self.losses = [float(x) for x in losses]
        self.grad_norms = {k: float(v) for k, v in grad_norms.items()}
        self.change_norms = {k: float(v) for k, v in change_norms.items()}


def read_steps(leaves, losses, initial, learning_rate, steps):
    """Drive ``steps`` SGD steps and read them. ``leaves`` maps names to
    the live parameters the steps update in place; ``losses`` yields one
    loss a step (after the step's update); ``initial()`` draws the
    leaves' starting values again. Norms stay on the device until
    :class:`Readings` reads them."""
    taken, grad_norms, change_norms = [], {}, {}
    for k, value in enumerate(losses):
        taken.append(value)
        with torch.no_grad():
            if k == 0:
                start = initial()
                grad_norms = {n: diff_norm(start[n], leaves[n]) / learning_rate
                              for n in leaves}
                del start
            if k == steps - 1:
                start = initial()
                change_norms = {n: diff_norm(leaves[n], start[n]) for n in leaves}
                del start
                break
    if len(taken) < steps:
        raise RuntimeError(f"the checked steps ended after {len(taken)} of {steps}")
    return taken, grad_norms, change_norms


def loss_gap(program, reference):
    """Largest relative gap of a step's loss."""
    return max(abs(p - r) / abs(r) for p, r in zip(program.losses, reference.losses))


def _norm_gap(program, reference, kept):
    median = statistics.median(reference[name] for name in kept)
    return max(abs(program[name] - reference[name]) / max(reference[name], median)
               for name in kept)


def kept_leaves(reference):
    median = statistics.median(reference.grad_norms.values())
    return [name for name, g in reference.grad_norms.items() if g >= NEGLIGIBLE_LEAF * median]


def gaps(program, reference):
    """The three model numbers, program against reference."""
    kept = kept_leaves(reference)
    return {"loss_gap": loss_gap(program, reference),
            "grad_norm_gap": _norm_gap(program.grad_norms, reference.grad_norms, kept),
            "change_norm_gap": _norm_gap(program.change_norms, reference.change_norms, kept)}


def judge(values, limits):
    """``(correct, checks)``: every number at or under its limit (a number
    that is not finite fails), each given with its limit."""
    checks, correct = {}, True
    for name, value in values.items():
        limit = limits[name]
        finite = value is not None and math.isfinite(value)
        ok = finite and value <= limit
        correct = correct and ok
        checks[name] = {"value": value if finite else None, "limit": limit}
    return correct, checks
