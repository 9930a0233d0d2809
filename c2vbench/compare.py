"""The numbers that decide ``correct``, each held to its limit.

Training (the program's first steps against the reference's):

- ``loss_gap``: the largest relative gap of a step's loss;
- ``grad_gap``: by the worst leaf, the gap between the norms of the
  program's first gradient (worked out from its optimizer's first moment
  after one step) and the reference's, over the reference's norm of that
  leaf or of the median leaf, whichever is larger;
- ``step_gap``: the same for the norm of each leaf's change over the steps.

A leaf whose reference gradient is under a thousandth of the median leaf's
moves by round-off alone and is left out of both leaf numbers.

Serving: ``cv_gap``, the largest absolute gap of a code vector's element
over the answers compared (the elements lie in ``[-1, 1]``).
"""

from __future__ import annotations

import statistics

import numpy as np

TINY_LEAF = 1e-3


def _leaf_gap(prog: dict, ref: dict, counted: list) -> float:
    med = statistics.median(ref[k] for k in counted)
    return max(abs(prog[k] - ref[k]) / max(ref[k], med, 1e-30) for k in counted)


def train_gaps(prog: dict, ref: dict) -> dict:
    """``{"loss_gap", "grad_gap", "step_gap"}`` of two ``follow_train``-shaped
    readings (``losses``, ``grad``, ``delta``)."""
    losses = [abs(p - r) / max(abs(r), 1e-30) for p, r in zip(prog["losses"], ref["losses"])]
    if len(prog["losses"]) != len(ref["losses"]) or not all(np.isfinite(prog["losses"])):
        losses.append(float("inf"))
    med = statistics.median(ref["grad"].values())
    counted = [k for k, v in ref["grad"].items() if v >= TINY_LEAF * med]
    return {"loss_gap": max(losses), "grad_gap": _leaf_gap(prog["grad"], ref["grad"], counted),
            "step_gap": _leaf_gap(prog["delta"], ref["delta"], counted)}


def cv_gap(got: list, want: list) -> float:
    """The largest element gap of the answers' code vectors; a missing or
    non-finite answer reads infinity."""
    worst = 0.0
    for g, w in zip(got, want):
        g = np.asarray(g, np.float64) if g is not None else None
        if g is None or g.shape != tuple(w.shape) or not np.isfinite(g).all():
            return float("inf")
        worst = max(worst, float(np.abs(g - w.double().numpy()).max()))
    return worst


def judge(values: dict, limits: dict) -> dict:
    """``{name: {"value", "limit"}}`` in the limits' order; a value that is
    missing or not a number fails."""
    return {k: {"value": float(values.get(k, float("nan"))), "limit": float(lim)}
            for k, lim in limits.items()}


def passed(checks: dict) -> bool:
    return all(np.isfinite(c["value"]) and c["value"] <= c["limit"] for c in checks.values())
