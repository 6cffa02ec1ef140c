"""Shared pieces of the tests that hold the PyTorch port against the JAX
package (tests/test_torch_*.py).  Inputs are made with numpy from a seed
and handed to both sides."""
import jax.numpy as jnp
import numpy as np
import torch

from rwm_pt_tpu.kernels import pallas_pt, pallas_rwm

Z_MAX = 4.5   # per-statistic invariance bound of tests/test_invariance.py


def make_draws(seed, S, T, d, C):
    """Standard normals (S, T, d, C), MH uniforms (S, T, C) and swap
    uniforms (S, T-1, C), float32, from numpy."""
    rng = np.random.default_rng(seed)
    return (rng.standard_normal((S, T, d, C)).astype(np.float32),
            rng.random((S, T, C), dtype=np.float32),
            rng.random((S, max(T - 1, 0), C), dtype=np.float32))


def make_proposal_draws(seed, kind, S, T, d, C):
    """Injected draws of proposal ``kind``: increment draws (S, T, d, C)
    (standard normals, or for Laplace uniforms on the 2^-24 grid), MH and
    swap uniforms as :func:`make_draws`, and for UniformRadius the radius
    uniforms (S, T, C)."""
    inc, u_mh, u_sw = make_draws(seed, S, T, d, C)
    rng = np.random.default_rng(seed + 1)
    if kind == "Laplace":
        inc = (rng.integers(0, 1 << 24, inc.shape) * 2.0 ** -24).astype(
            np.float32)
    if kind == "UniformRadius":
        return inc, u_mh, u_sw, rng.random((S, T, C), dtype=np.float32)
    return inc, u_mh, u_sw


def run_jax_body(monkeypatch, target, x0, betas, sigmas, draws, step0,
                 burn_in, swap_every, acc0=None, swapacc0=None, bj0=None,
                 cj0=None, kind="Normal", snapshots=None):
    """Drive the Pallas PT kernel's own step body
    (``pallas_pt._pt_body_fn``) eagerly, step by step, on the given draws.

    The body draws its increments through the ``draw_inc`` argument and its
    uniforms through the module global ``_uniform``; ``monkeypatch``
    replaces the latter for the test only.  Per step the body asks for T
    (increment, MH uniform) pairs, then T-1 swap uniforms, even on steps
    without a swap.  ``draw_inc`` is the kernel's own for proposal
    ``kind`` (``pallas_pt.py:119-124``): ``_normal * sigma_t``,
    ``pallas_rwm._laplace(shape, scale_t)`` with ``sigmas`` the ``(T, d)``
    Laplace scales, or ``pallas_rwm._uniform_ball(shape, radius_t)``, with
    ``pallas_rwm._uniform``/``_normal`` fed the injected draws of
    :func:`make_proposal_draws`.  ``snapshots``, a list, receives the cold
    rung (numpy ``(d, C)``) after every step, after the swap sweep.
    Returns numpy ``(x (d,T,C), lp, acc, swapacc, betajump, coldjump)``."""
    inc, u_mh, u_sw = draws[:3]
    d, T, C = x0.shape
    feed = []
    monkeypatch.setattr(pallas_pt, "_uniform", lambda shape: feed.pop(0))
    cur = {"s": 0}
    sig = jnp.asarray(sigmas, jnp.float32)

    def draw_inc(t, shape):
        assert shape == (d, C)
        s = cur["s"]
        if kind == "Normal":
            return jnp.asarray(inc[s, t]) * sig[t]
        if kind == "Laplace":
            monkeypatch.setattr(pallas_rwm, "_uniform",
                                lambda shape: jnp.asarray(inc[s, t]))
            return pallas_rwm._laplace(shape, sig[t][:, None])
        monkeypatch.setattr(pallas_rwm, "_normal",
                            lambda shape, impl=None: jnp.asarray(inc[s, t]))
        monkeypatch.setattr(pallas_rwm, "_uniform",
                            lambda shape: jnp.asarray(draws[3][s, t])[None])
        return pallas_rwm._uniform_ball(shape, sig[t])

    body = pallas_pt._pt_body_fn(target, draw_inc,
                                 jnp.asarray(betas, jnp.float32), burn_in,
                                 swap_every, d, T, C, step0)
    z_i = np.zeros((1, C), np.int32)
    z_f = jnp.zeros((1, C), jnp.float32)
    x = tuple(jnp.asarray(x0[:, t]) for t in range(T))
    lp = tuple(target.log_density_td(x[t])[None, :] for t in range(T))
    acc = tuple(jnp.asarray(z_i if acc0 is None else acc0[t][None])
                for t in range(T))
    carry = (x, lp, acc,
             jnp.asarray(z_i if swapacc0 is None else swapacc0[None]),
             z_f if bj0 is None else jnp.asarray(bj0[None]), z_f,
             z_f if cj0 is None else jnp.asarray(cj0[None]), z_f)
    for s in range(inc.shape[0]):
        cur["s"] = s
        feed[:] = ([jnp.asarray(u_mh[s, t])[None] for t in range(T)]
                   + [jnp.asarray(u_sw[s, j])[None] for j in range(T - 1)])
        carry = body(s, carry)
        assert not feed, "the body drew fewer uniforms than expected"
        if snapshots is not None:
            snapshots.append(np.asarray(carry[0][0]))
    x, lp, acc, swapacc, bj, _, cj, _ = carry
    return (np.stack([np.asarray(v) for v in x], axis=1),
            np.concatenate([np.asarray(v) for v in lp]),
            np.concatenate([np.asarray(v) for v in acc]),
            np.asarray(swapacc)[0], np.asarray(bj)[0], np.asarray(cj)[0])


def f32_sigmas(base, betas, mult=None):
    """Per-rung std sqrt(base * c / beta) in float32, as both wrappers
    compute it."""
    betas = np.asarray(betas, np.float32)
    mult = np.ones_like(betas) if mult is None else np.asarray(mult,
                                                              np.float32)
    return np.sqrt(np.float32(base) * mult / betas).astype(np.float32)


def invariance_max_z(evolved, exact, target):
    """Max z over the per-coordinate means and second moments and the mean
    log-density of two ``(d, C)`` ensembles (tests/test_invariance.py)."""
    def stats(x):
        f = torch.cat([x, x * x, target.log_density_td(x)[None]], dim=0)
        return f.mean(dim=1), f.var(dim=1, unbiased=False), x.shape[1]
    m1, v1, n1 = stats(evolved)
    m2, v2, n2 = stats(exact)
    assert torch.isfinite(m1).all()
    return float(((m1 - m2).abs()
                  / torch.sqrt(v1 / n1 + v2 / n2 + 1e-12)).max())


def rate_z(a, b):
    """z of the difference of the means of two per-replica rate arrays
    (replicas independent)."""
    a, b = np.asarray(a, np.float64), np.asarray(b, np.float64)
    se = np.sqrt(a.var() / a.size + b.var() / b.size) + 1e-12
    return abs(a.mean() - b.mean()) / se
