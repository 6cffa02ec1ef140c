"""MCMC convergence diagnostics: split-R-hat, ESS, IACT, MCSE.

A copy of ``rwm_pt_tpu.analysis.diagnostics`` (numpy only), kept here so
that the PyTorch package imports nothing of the JAX package; the two are
held bit for bit equal by ``tests/test_torch_diagnostics.py``.

Post-processing over the recorded traces of many chains:

* ``split_rhat``            — rank-free split-chain potential scale reduction
                              (Gelman et al., BDA3 eq. 11.4; Vehtari et al.
                              2021 split-chain form).
* ``effective_sample_size`` — split-chain ESS with FFT autocovariance and
                              Geyer's initial-monotone-sequence truncation
                              (Stan reference manual, "Effective Sample Size").
* ``integrated_autocorr_time`` — IACT = N_total / ESS.
* ``mcse_mean``             — Monte-Carlo standard error of the posterior
                              mean, sd / sqrt(ESS).
* ``autocorrelation``       — per-chain normalized autocorrelation function.

All functions are host-side NumPy and accept draws shaped ``(n,)``,
``(n, chains)`` or ``(n, dim, chains)`` — the last matching the thinned trace
layout the samplers record (``RWMResult.chain``, ``PTResult.chain``).
"""
from __future__ import annotations

import numpy as np

__all__ = [
    "autocorrelation",
    "effective_sample_size",
    "integrated_autocorr_time",
    "mcse_mean",
    "split_rhat",
]


def _as_draws_chains(x) -> np.ndarray:
    """Normalize input to float64 ``(n_draws, n_chains)``."""
    a = np.asarray(x, dtype=np.float64)
    if a.ndim == 1:
        a = a[:, None]
    if a.ndim != 2:
        raise ValueError(
            f"expected (n,) or (n, chains) draws, got shape {a.shape}")
    if a.shape[0] < 4:
        raise ValueError("need at least 4 draws per chain")
    return a


def _split_chains(a: np.ndarray) -> np.ndarray:
    """Split each chain in half -> (n//2, 2*chains); drops an odd last draw."""
    n = a.shape[0] // 2
    return np.concatenate([a[:n], a[n:2 * n]], axis=1)


def _raw_acov(a: np.ndarray, n_lags: int) -> np.ndarray:
    """Unnormalized linear autocovariance sums per chain, lags 0..n_lags-1.

    FFT-based (O(n log n)) with zero-padding to the next power of two >= 2n
    so the circular convolution equals the linear one.  Returns the raw
    cross-term sums; callers divide by their estimator's lag count.
    """
    n = a.shape[0]
    a = a - a.mean(axis=0, keepdims=True)
    m = 1 << (2 * n - 1).bit_length()
    f = np.fft.rfft(a, n=m, axis=0)
    return np.fft.irfft(f * np.conj(f), n=m, axis=0)[:n_lags].real


def autocorrelation(x, max_lag: int | None = None) -> np.ndarray:
    """Normalized per-chain autocorrelation, averaged over chains.

    Returns ``rho[0..max_lag]`` with ``rho[0] == 1``.  A zero-variance
    (stuck) chain is perfectly correlated: it contributes ``rho == 1`` at
    every lag rather than diluting the average.
    """
    a = _as_draws_chains(x)
    n = a.shape[0]
    if max_lag is None:
        max_lag = n - 1
    max_lag = min(max_lag, n - 1)
    acov = _raw_acov(a, max_lag + 1)
    acov /= np.arange(n, n - max_lag - 1, -1)[:, None]  # unbiased divisor
    var = acov[0].copy()
    stuck = var == 0
    var[stuck] = 1.0
    rho = acov / var
    rho[:, stuck] = 1.0
    return rho.mean(axis=1)


def _ess_one(a: np.ndarray) -> float:
    """Split-chain ESS of one scalar quantity, draws ``(n, chains)``.

    Stan manual / Vehtari et al. 2021: combine within-chain autocovariances
    with the between-chain variance, truncate the autocorrelation sum at the
    first negative even/odd pair sum (Geyer initial positive sequence), and
    enforce monotone decrease (initial monotone sequence).
    """
    a = _split_chains(a)
    n, m = a.shape
    mean_c = a.mean(axis=0)
    within_acov = _acov_per_chain(a)                       # (n, m), biased
    w = a.var(axis=0, ddof=1).mean()                       # mean within var
    var_b = mean_c.var(ddof=1) if m > 1 else 0.0
    var_plus = w * (n - 1) / n + var_b
    if var_plus <= 0 or w <= 0:
        return float(n * m)                                # constant chains
    rho = 1.0 - (w - within_acov.mean(axis=1)) / var_plus  # (n,)
    rho[0] = 1.0
    # Geyer initial positive + monotone sequence over pair sums
    # P_t = rho[2t] + rho[2t+1]; tau = -1 + 2 * sum of running-min P_t
    tau = -1.0
    prev_pair = np.inf
    t = 0
    while 2 * t + 1 < n:
        pair = rho[2 * t] + rho[2 * t + 1]
        if pair < 0:
            break
        pair = min(pair, prev_pair)                        # monotone sequence
        prev_pair = pair
        tau += 2.0 * pair
        t += 1
    tau = max(tau, 1.0 / np.log10(max(n * m, 10)))
    ess = n * m / tau
    # cap: antithetic chains can yield ess > n*m; Stan caps at n*m*log10(n*m)
    return float(min(ess, n * m * np.log10(max(n * m, 10))))


def _acov_per_chain(a: np.ndarray) -> np.ndarray:
    return _raw_acov(a, a.shape[0]) / a.shape[0]           # biased (Stan's)


def _per_quantity(x, fn):
    """Apply ``fn((n, chains))`` over the dim axis of (n,)/(n,C)/(n,d,C)."""
    a = np.asarray(x, dtype=np.float64)
    if a.ndim == 3:
        return np.array([fn(_as_draws_chains(a[:, j, :]))
                         for j in range(a.shape[1])])
    return fn(_as_draws_chains(a))


def effective_sample_size(x):
    """Split-chain ESS.  ``x``: (n,), (n, chains) or (n, dim, chains).

    Returns a scalar, or a (dim,) array for 3-D input.
    """
    return _per_quantity(x, _ess_one)


def integrated_autocorr_time(x):
    """IACT tau = total draws / ESS (tau = 1 for iid draws).

    The total counts the draws the split-chain ESS actually uses:
    ``2 * (n // 2)`` per chain (an odd trailing draw is dropped by the
    split), so tau is not overstated for odd-length traces."""
    a = np.asarray(x, dtype=np.float64)
    total = 2 * (a.shape[0] // 2) * (a.shape[-1] if a.ndim > 1 else 1)
    return total / effective_sample_size(x)


def mcse_mean(x):
    """Monte-Carlo standard error of the mean: sd / sqrt(ESS)."""

    def one(a):
        sd = a.std(ddof=1)
        return float(sd / np.sqrt(_ess_one(a)))

    return _per_quantity(x, one)


def _rhat_one(a: np.ndarray) -> float:
    a = _split_chains(a)
    n, m = a.shape
    mean_c = a.mean(axis=0)
    var_c = a.var(axis=0, ddof=1)
    w = var_c.mean()
    b = n * mean_c.var(ddof=1)
    if w <= 0:
        return 1.0
    var_plus = (n - 1) / n * w + b / n
    return float(np.sqrt(var_plus / w))


def split_rhat(x):
    """Split-chain potential scale reduction factor R-hat.

    Values near 1.0 indicate convergence; > ~1.01 (Vehtari et al. 2021) is
    cause for concern.  Works with a single chain too (it is split in half,
    so slow drift is still detected).
    """
    return _per_quantity(x, _rhat_one)
