"""Inverse-temperature (beta) ladders (port of
``rwm_pt_tpu.ladders.ladders``: the geometric ladder, the harness's
default).

Not ported yet (ROADMAP Queue A item 10): the iterative ladder
construction and its swap-probability estimator.
"""
from __future__ import annotations

from typing import List


def construct_geometric_ladder(beta_0: float = 1.0, beta_min: float = 1e-2,
                               c: float = 0.5) -> List[float]:
    """Geometric ladder: multiply by ``c`` until ``beta_min``, then append
    it (the reference PT algorithm's fallback ladder)."""
    ladder = []
    curr = beta_0
    while curr > beta_min:
        ladder.append(curr)
        curr = curr * c
    ladder.append(beta_min)
    return ladder
