"""Krylov health monitor on 0-d tensors (port of
:mod:`repro.resilience.monitor`).

One failure taxonomy for every solver, computed from the already-reduced
convergence metric each solver carries:

====  ===========  =====================================================
code  name         meaning
====  ===========  =====================================================
0     ok           healthy
1     non_finite   the convergence metric went NaN/Inf — always wins
2     divergence   metric ran ``divergence``× past its best
3     stagnation   no new best metric for ``stagnation`` steps
4     breakdown    an exact recurrence breakdown the solver flags
====  ===========  =====================================================

The record stays on the metric's device; the first failure sticks and
``at_iter`` stamps the iteration it was detected.
"""
from __future__ import annotations

from typing import NamedTuple

import torch

OK = 0
NON_FINITE = 1
DIVERGENCE = 2
STAGNATION = 3
BREAKDOWN = 4

NAMES = {OK: "ok", NON_FINITE: "non_finite", DIVERGENCE: "divergence",
         STAGNATION: "stagnation", BREAKDOWN: "breakdown"}


class Health(NamedTuple):
    code: torch.Tensor        # int32 failure code, 0 while healthy
    at_iter: torch.Tensor     # int32 iteration of first failure (0 if none)
    best: torch.Tensor        # best (smallest) metric value seen
    since_best: torch.Tensor  # int32 steps since the best last improved


def init(metric0: torch.Tensor) -> Health:
    """Fresh record seeded with the initial metric (a non-finite start is
    classified at iteration 0)."""
    finite = torch.isfinite(metric0)
    code = torch.where(finite, OK, NON_FINITE).to(torch.int32)
    zero = torch.zeros_like(code)
    best = torch.where(finite, metric0, torch.full_like(metric0, torch.inf))
    return Health(code, zero, best, zero)


def update(h: Health, metric: torch.Tensor, k: int, *, breakdown=None,
           divergence=None, stagnation: int | None = None) -> Health:
    """Advance the monitor one step on the current metric.

    ``breakdown`` is the solver's boolean breakdown flag (already masked by
    "and not converged"); ``divergence`` is the blow-up factor over the
    best metric, in the metric's own scale; ``stagnation`` is a window of
    steps with no new best.  Severity when several fire at once:
    non_finite > breakdown > divergence > stagnation.
    """
    improved = metric < h.best
    best = torch.where(improved, metric, h.best)
    since = torch.where(improved, 0, h.since_best + 1).to(torch.int32)
    code = torch.zeros_like(h.code)
    if stagnation is not None:
        code = torch.where(since >= stagnation, STAGNATION, code)
    if divergence is not None:
        code = torch.where(metric > divergence * best, DIVERGENCE, code)
    if breakdown is not None:
        code = torch.where(breakdown, BREAKDOWN, code)
    code = torch.where(torch.isfinite(metric), code, NON_FINITE)
    code = torch.where(h.code != OK, h.code, code).to(torch.int32)
    at = torch.where((h.code == OK) & (code != OK), k, h.at_iter)
    return Health(code, at.to(torch.int32), best, since)


def ok(h: Health) -> torch.Tensor:
    """Healthy flag (the loop's continuation condition)."""
    return h.code == OK


def info(h: Health) -> dict:
    """The ``SolveResult.info`` payload every monitored solver emits."""
    return {"fail_code": h.code, "fail_iter": h.at_iter}


def classify(code) -> str:
    """Human name for a failure code."""
    return NAMES.get(int(code), "unknown")
