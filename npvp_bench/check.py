"""The numbers that decide ``correct``: each compared against the limit that
``limits/<workload>.json`` gives it, and printed beside it.

Serving: for every compared request, the program's predicted frames
against the plain reference's, as the relative RMS gap
``‖program − reference‖ / ‖reference‖`` and the largest absolute gap; the
worst request counts.

Training: the first three steps of the loop (set-up), replayed by the
reference from the same weights, batches and step seeds, and one step of
the window, replayed from the program's state before it:

- ``loss_gap``: the largest relative gap of a set-up step's loss;
- ``grad_norm_gap``: over the predictor's leaves, the largest gap between
  the norm of the first step's gradient as the optimizer took it (its
  first moment over 1 − β1) and the reference's, over the larger of the
  reference leaf's norm and the median leaf's;
- ``update_norm_gap``: the same of the parameters' change after the third
  step, over the leaves whose first reference gradient is at least a
  thousandth of the median leaf's (a leaf with no gradient but rounding,
  such as a key bias under softmax, moves under Adam by that rounding);
- ``timed_loss_gap``, ``timed_grad_norm_gap``, ``timed_update_norm_gap``:
  the same of the window's step.

A number without a limit is worked out and logged, not compared.
"""

from __future__ import annotations

import math
import statistics
from typing import Dict, List

import torch


def frames_gaps(program: torch.Tensor, reference: torch.Tensor):
    """(relative RMS gap, largest absolute gap) of one request's frames."""
    p, r = program.double(), reference.double()
    rel = float(torch.linalg.vector_norm(p - r)
                / torch.linalg.vector_norm(r).clamp(min=1e-30))
    return rel, float((p - r).abs().max())


def leaf_gap(program: Dict[str, float], reference: Dict[str, float],
             keep=None):
    """(largest |program − reference| of per-leaf norms over the larger of
    the reference leaf's norm and the median of the reference's, the leaf
    where it is)."""
    names = [k for k in reference if keep is None or keep(k)]
    med = statistics.median(reference[k] for k in names)
    worst, where = 0.0, None
    for k in names:
        gap = abs(program[k] - reference[k]) / max(reference[k], med, 1e-30)
        if not math.isfinite(gap):
            return float("inf"), k
        if gap > worst:
            worst, where = gap, k
    return worst, where


def judge(values: Dict[str, float], limits: Dict[str, float]):
    """(correct, the numbers with their limits in the limits' order): every
    limit needs a finite number at or below it."""
    rows, ok = {}, True
    for name, limit in limits.items():
        v = values.get(name, float("nan"))
        rows[name] = {"value": v, "limit": limit}
        if not (math.isfinite(v) and v <= limit):
            ok = False
    return ok, rows


def lines(rows) -> List[str]:
    return [f"check {k}: {r['value']!r} (limit {r['limit']!r})"
            for k, r in rows.items()]
