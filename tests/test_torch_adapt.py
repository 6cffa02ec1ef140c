"""The port's burn-in tuners (rwm_pt_tpu_torch/kernels/adapt.py) against the
JAX package's (rwm_pt_tpu/kernels/adapt.py).

The helpers are held exactly (rtol 1e-6).  The engines draw from other
streams than JAX (torch.Generator per step against threefry), so they are
held statistically, on the configurations of tests/test_adaptive.py:20-158:
the JAX tests' bounds on the post-burn-in acceptance, and the port's tuned
quantity (``log c`` for the scale tuners, ``log beta_t`` of rungs 1.. for
the ladder tuner) within ``TOL`` of JAX's, component by component.

Tolerance, derived once from the JAX runs' seed-to-seed spread (``python
tests/test_torch_adapt.py`` reruns the derivation): each configuration ran
on JAX with keys 0..4; ``s`` is the largest per-component standard
deviation (ddof 1) of the tuned quantity over those five runs.  The port
and JAX are two independent runs, whose difference has standard deviation
``sqrt(2) s``; the bound is five of those, ``TOL = 5 sqrt(2) s``, rounded
up to two significant digits.  The spreads (JAX 0.9.0 on the CPU):
rwm-small 0.0042, rwm-large 0.0043, rwm-target-0.5
0.0027, rwm-uniform-radius 0.0022, pt 0.0062, ladder 0.0070.
"""
import math
import sys

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from rwm_pt_tpu.kernels import adapt as jadapt
from rwm_pt_tpu.proposals import NormalProposal as JNormal
from rwm_pt_tpu.proposals import UniformRadiusProposal as JUniform
from rwm_pt_tpu.targets import MultivariateNormal as JMVN
from rwm_pt_tpu_torch.kernels import adapt as tadapt
from rwm_pt_tpu_torch.proposals import NormalProposal as TNormal
from rwm_pt_tpu_torch.proposals import UniformRadiusProposal as TUniform
from rwm_pt_tpu_torch.targets import MultivariateNormal as TMVN

torch.set_num_threads(1)
OPT_VAR = 2.38 ** 2 / 10      # tests/test_adaptive.py's near-optimal variance
# name -> (tuner, dim, proposal, base scale, run kwargs, accept bound)
CONFIGS = {
    "rwm-small": ("rwm", 10, "Normal", OPT_VAR / 100,
                  dict(num_chains=256, num_iterations=2000, burn_in=3000),
                  0.04),
    "rwm-large": ("rwm", 10, "Normal", OPT_VAR * 25,
                  dict(num_chains=256, num_iterations=2000, burn_in=3000),
                  0.04),
    "rwm-target-0.5": ("rwm", 10, "Normal", OPT_VAR,
                       dict(num_chains=256, num_iterations=2000,
                            burn_in=3000, target_accept=0.5), 0.05),
    "rwm-uniform-radius": ("rwm", 10, "UniformRadius", 0.05,
                           dict(num_chains=256, num_iterations=2000,
                                burn_in=3000), 0.05),
    "pt": ("pt", 10, "Normal", OPT_VAR / 100,
           dict(num_chains=128, num_iterations=2000, burn_in=3000,
                swap_every=20), 0.05),
    "ladder": ("ladder", 5, "Normal", 2.38 ** 2 / 5,
               dict(num_rungs=6, num_chains=256, num_iterations=4000,
                    burn_in=4000, swap_every=10, adapt_swap_every=10,
                    adapt_every=200), 0.06),
}
# 5 sqrt(2) x the JAX seed-to-seed spread (module docstring)
TOL = {"rwm-small": 0.030, "rwm-large": 0.031, "rwm-target-0.5": 0.019,
       "rwm-uniform-radius": 0.016, "pt": 0.044, "ladder": 0.050}


def _run(side, name, seed):
    """(result, tuned quantity as numpy) of configuration ``name``."""
    tuner, d, prop, scale, kw, _ = CONFIGS[name]
    if side == "jax":
        tgt = JMVN.create(d)
        p = (JNormal if prop == "Normal" else JUniform).create(d, scale)
        key = jax.random.key(seed)
        if tuner == "rwm":
            out = jadapt.run_rwm_adaptive(tgt, p, key, adapt_every=100, **kw)
        elif tuner == "pt":
            out = jadapt.run_pt_adaptive(tgt, p, key,
                                         jnp.geomspace(1.0, 0.01, 6),
                                         adapt_every=100, **kw)
        else:
            out = jadapt.run_pt_ladder_adaptive(tgt, p, key, **kw)
        tuned = np.asarray(out[1], np.float64)
    else:
        tgt = TMVN.create(d, device="cpu")
        p = (TNormal if prop == "Normal" else TUniform).create(
            d, scale, device="cpu")
        if tuner == "rwm":
            out = tadapt.run_rwm_adaptive(tgt, p, seed, adapt_every=100,
                                          device="cpu", **kw)
        elif tuner == "pt":
            out = tadapt.run_pt_adaptive(
                tgt, p, seed, np.geomspace(1.0, 0.01, 6), adapt_every=100,
                device="cpu", **kw)
        else:
            out = tadapt.run_pt_ladder_adaptive(tgt, p, seed, device="cpu",
                                                **kw)
        tuned = out[1].double().numpy()
    # log c of the scale tuners, log beta of rungs 1.. of the ladder tuner
    return out, np.log(tuned if tuner != "ladder" else tuned[1:])


def _mean_rate(res, tuner):
    r = (res.swap_acceptance_rate if tuner == "ladder"
         else res.acceptance_rate)
    return np.asarray(r, np.float64).reshape(
        (6, -1) if tuner == "pt" else (-1,)).mean(axis=-1)


@pytest.mark.parametrize("name", list(CONFIGS))
def test_engine_matches_jax(name):
    """The JAX test's acceptance bound on both sides (per rung for PT, the
    swap acceptance for the ladder), and the tuned quantity within TOL."""
    tuner, _, _, _, kw, bound = CONFIGS[name]
    target = kw.get("target_accept", 0.234)
    tout, tq = _run("port", name, 0)
    jout, jq = _run("jax", name, 0)
    for res in (tout.result, jout.result):
        assert np.all(np.abs(_mean_rate(res, tuner) - target) < bound)
    assert tq.shape == jq.shape
    np.testing.assert_array_less(np.abs(tq - jq), TOL[name])
    if tuner == "ladder":
        betas = tout.tuned_betas.numpy()
        assert betas[0] == 1.0 and np.all(np.diff(betas) < 0)
    if tuner == "pt":       # the post-burn-in phase still swaps
        assert float(tout.result.swap_acceptance_rate.mean()) > 0.0
    if name == "rwm-small":  # the tuned variance undoes the mis-scaling
        assert 0.3 < float(tout.tuned_scale_multiplier) / 100 < 3.0


def test_rm_update_matches_jax():
    rng = np.random.default_rng(0)
    log_c = rng.normal(size=6).astype(np.float32)
    acc = rng.random(6).astype(np.float32)
    for n in (1, 2, 7, 30):
        want = np.asarray(jadapt._rm_update(
            jnp.asarray(log_c), jnp.asarray(acc), jnp.asarray(n, jnp.int32),
            0.234, -0.5, 3.0))
        got = tadapt._rm_update(torch.from_numpy(log_c),
                                torch.from_numpy(acc), n, 0.234, -0.5, 3.0)
        np.testing.assert_allclose(got.numpy(), want, rtol=1e-6)


def test_betas_from_rho_matches_jax():
    rho = np.linspace(-10.0, 10.0, 9).astype(np.float32)
    want = np.asarray(jadapt._betas_from_rho(jnp.asarray(rho)))
    got = tadapt._betas_from_rho(torch.from_numpy(rho)).numpy()
    np.testing.assert_allclose(got, want, rtol=1e-6)
    assert got[0] == 1.0 and np.all(np.diff(got) < 0)


def test_post_phase_is_exact():
    """tests/test_adaptive.py:43-53: a 25x-oversized proposal tuned on a
    2-d MVN, then frozen; the final states sample N(0, I)."""
    tgt = TMVN.create(2, device="cpu")
    p = TNormal.create(2, 50.0, device="cpu")
    out = tadapt.run_rwm_adaptive(tgt, p, 3, num_chains=512,
                                  num_iterations=4000, burn_in=3000,
                                  device="cpu")
    x = out.result.state.x.numpy()
    assert np.abs(x.mean()) < 0.15 and abs(x.std() - 1.0) < 0.15


def test_ladder_swap_accounting():
    """Only post-burn-in production swaps count: exactly n_events (T-1)
    attempts; measurement swaps during burn-in count nothing."""
    tgt = TMVN.create(3, device="cpu")
    p = TNormal.create(3, 1.0, device="cpu")
    T, n, b, se = 4, 300, 200, 25
    out = tadapt.run_pt_ladder_adaptive(
        tgt, p, 0, num_rungs=T, num_chains=8, num_iterations=n, burn_in=b,
        swap_every=se, adapt_swap_every=10, adapt_every=100, device="cpu")
    n_events = (b + n) // se - b // se
    assert out.result.state.swap_attempt_count == n_events * (T - 1)
    assert out.result.state.step == b + n
    assert int(out.result.state.swap_accept_count.max()) <= n_events * (T - 1)


@pytest.mark.parametrize("case", ["adapt_every", "unroll"])
def test_ladder_errors_match_jax(case):
    """``adapt_every`` not a multiple of ``adapt_swap_every`` raises JAX's
    ValueError; ``unroll`` is accepted and changes nothing."""
    kw = dict(num_rungs=3, num_chains=4, num_iterations=10, burn_in=20,
              swap_every=5)
    tgt, p = TMVN.create(2, device="cpu"), TNormal.create(2, 1.0,
                                                          device="cpu")
    if case == "adapt_every":
        with pytest.raises(ValueError) as je:
            jadapt.run_pt_ladder_adaptive(
                JMVN.create(2), JNormal.create(2, 1.0), jax.random.key(0),
                adapt_swap_every=7, adapt_every=20, **kw)
        with pytest.raises(ValueError) as te:
            tadapt.run_pt_ladder_adaptive(tgt, p, 0, adapt_swap_every=7,
                                          adapt_every=20, device="cpu", **kw)
        assert str(te.value) == str(je.value)
        return
    a = tadapt.run_pt_ladder_adaptive(tgt, p, 0, adapt_every=10,
                                      device="cpu", **kw)
    b = tadapt.run_pt_ladder_adaptive(tgt, p, 0, adapt_every=10, unroll=8,
                                      device="cpu", **kw)
    assert torch.equal(a.result.state.x, b.result.state.x)
    assert torch.equal(a.tuned_betas, b.tuned_betas)


def derive_tolerances(seeds=range(5)):
    """The JAX seed-to-seed spread of each configuration's tuned quantity
    and the bound derived from it (module docstring)."""
    for name in CONFIGS:
        q = np.stack([_run("jax", name, s)[1].ravel() for s in seeds])
        s = float(np.max(np.std(q, axis=0, ddof=1)))
        tol = 5 * math.sqrt(2) * s
        print(f"{name}: spread {s:.4f}, 5 sqrt(2) spread {tol:.4f}",
              flush=True)


def ladder_on_rosenbrock(seeds=range(3), num_chains=256):
    """Both packages' ladder tuners side by side at the flagship's target
    and proposal (FullRosenbrock d=30, T=10, Normal variance 0.5^2/30,
    swap every 100, burn-in 3000 in windows of 100) at ``num_chains``
    chains: the tuned ladder and the post-burn-in per-rung MH and mean
    swap acceptance of each run."""
    from rwm_pt_tpu.targets import FullRosenbrock as JRosen
    from rwm_pt_tpu_torch.targets import FullRosenbrock as TRosen
    d, var = 30, 0.5 ** 2 / 30
    kw = dict(num_rungs=10, num_chains=num_chains, num_iterations=1000,
              burn_in=3000, swap_every=100, adapt_every=100)
    np.set_printoptions(precision=4, linewidth=200)
    for seed in seeds:
        jout = jadapt.run_pt_ladder_adaptive(
            JRosen.create(d), JNormal.create(d, var), jax.random.key(seed),
            **kw)
        tout = tadapt.run_pt_ladder_adaptive(
            TRosen.create(d, device="cpu"),
            TNormal.create(d, var, device="cpu"), seed, device="cpu", **kw)
        for side, out in (("jax", jout), ("port", tout)):
            res = out.result
            print(f"seed {seed} {side}: ladder "
                  f"{np.asarray(out[1], np.float64)}\n  per-rung MH acc "
                  f"{np.asarray(res.acceptance_rate).mean(axis=-1)}, swap "
                  f"acc {np.asarray(res.swap_acceptance_rate).mean():.4f}",
                  flush=True)


if __name__ == "__main__":
    jax.config.update("jax_platforms", "cpu")
    if sys.argv[1:2] == ["ladder-rosenbrock"]:
        ladder_on_rosenbrock()
    else:
        derive_tolerances(range(int(sys.argv[1]) if len(sys.argv) > 1
                                else 5))
