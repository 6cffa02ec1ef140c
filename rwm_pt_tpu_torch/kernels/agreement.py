"""Hold a fused kernel's results against its plain PyTorch version's.

Both versions consume one Philox stream, so they follow one trajectory up
to f32 rounding.  Rounding can flip a rare accept decision, after which
that replica's trajectory parts ways for good (two random walks driven by
the same increments from different points never meet).  So a replica
*agrees* when its final x agrees to ``X_ATOL`` in every coordinate, and on
the agreeing replicas every other output must agree too: counters exactly,
floats (log-densities, Kahan sums) to ``RTOL``, and a recorded trace
(``chain``, whose replica axis holds the first few replicas only) to
``X_ATOL`` like x.  An off-by-one in the burn-in gate, a wrong cold-rung
jump or a snapshot taken at the wrong step then fails even where x agrees.
"""
from __future__ import annotations

from typing import NamedTuple

import torch

X_ATOL = 1e-3     # a replica agrees when its final x agrees to this
RTOL = 1e-4       # floats other than x, on the agreeing replicas
FLOAT_ATOL = 1e-6

PT_OUTPUTS = ("x", "lp", "acc", "swapacc", "betajump", "coldjump")
RWM_OUTPUTS = ("x", "lp", "acc", "jump")
PT_REC_OUTPUTS = PT_OUTPUTS + ("chain",)
RWM_REC_OUTPUTS = RWM_OUTPUTS + ("chain",)


class Agreement(NamedTuple):
    frac: float          # share of replicas whose final x agrees
    max_dx: float        # max |x_kernel - x_plain| over them
    max_rel: dict        # float output -> max |k - p| / max(|p|, 1e-6)
    #                      (the trace: max |k - p|)
    mismatched: dict     # output -> agreeing replicas where it disagrees


def hold(kernel_out, plain_out, names) -> Agreement:
    """Compare two tuples of outputs named ``names``, ``names[0] == "x"``;
    every output has the replica axis last."""
    xk, xp = kernel_out[0], plain_out[0]
    diff = (xk - xp).abs().reshape(-1, xk.shape[-1]).amax(0)
    ok = diff < X_ATOL
    frac = ok.float().mean().item()
    max_dx = diff[ok].max().item() if ok.any() else float("inf")
    max_rel, mismatched = {}, {}
    for name, a, b in zip(names[1:], kernel_out[1:], plain_out[1:]):
        sel = ok[:a.shape[-1]]
        a, b = a[..., sel], b[..., sel]
        if name == "chain":
            err = (a - b).abs()
            max_rel[name] = err.max().item() if err.numel() else 0.0
            bad = ~(err < X_ATOL)
        elif a.dtype.is_floating_point:
            err = (a - b).abs()
            max_rel[name] = (err / b.abs().clamp_min(1e-6)).max().item() \
                if err.numel() else 0.0
            bad = ~torch.isclose(a, b, rtol=RTOL, atol=FLOAT_ATOL)
        else:
            bad = a != b
        if bad.ndim > 1:
            bad = bad.flatten(0, -2).any(0)
        n_bad = int(bad.sum())
        if n_bad:
            mismatched[name] = n_bad
    return Agreement(frac, max_dx, max_rel, mismatched)


def describe(a: Agreement) -> str:
    rel = ", ".join(f"{k} {v:.3g}" for k, v in a.max_rel.items())
    return (f"agree {a.frac:.5f} of replicas (x to {X_ATOL}), max |dx| over "
            f"them {a.max_dx:.3g}; on them max rel diff {rel} (rtol {RTOL}, "
            f"counters exact); mismatched {a.mismatched or 'none'}")
