"""The eager engines' options ported from JAX (ROADMAP A7): the CPU PT
semantics (swap instead of move, with JAX's MH-attempt normalisation),
``symmetric=False``, ``progress_every`` and the harness's
``progress_bar``, ``unroll``, and float64 runs."""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from _torch_port_helpers import rate_z
from rwm_pt_tpu.kernels import run_pt as jrun_pt
from rwm_pt_tpu.proposals import NormalProposal as JNormal
from rwm_pt_tpu.targets import MultivariateNormal as JMVN
from rwm_pt_tpu_torch.api import MCMCSimulation as TSim
from rwm_pt_tpu_torch.kernels import run_pt, run_rwm
from rwm_pt_tpu_torch.proposals import LaplaceProposal, NormalProposal
from rwm_pt_tpu_torch.targets import MultivariateNormal
from rwm_pt_tpu_torch.utils import default_float, set_x64

torch.set_num_threads(1)
CPU = "cpu"
Z_MAX = 5.0


def test_cpu_semantics_rates_match_jax():
    """Per-rung MH and swap acceptance of the CPU semantics within 5 MC
    standard errors of JAX's scan engine (replicas independent)."""
    d, C, betas = 3, 512, [1.0, 0.5, 0.25, 0.1]
    kw = dict(num_chains=C, num_iterations=300, burn_in=50, swap_every=5,
              cpu_semantics=True)
    j = jrun_pt(JMVN.create(d), JNormal.create(d, 2.0), jax.random.key(3),
                jnp.asarray(betas, jnp.float32), **kw)
    t = run_pt(MultivariateNormal.create(d, device=CPU),
               NormalProposal.create(d, 2.0, device=CPU), 3, betas,
               device=CPU, **kw)
    ja, ta = np.asarray(j.acceptance_rate), t.acceptance_rate.numpy()
    for r in range(len(betas)):
        assert rate_z(ta[r], ja[r]) < Z_MAX, r
    assert rate_z(t.swap_acceptance_rate.numpy(),
                  np.asarray(j.swap_acceptance_rate)) < Z_MAX
    # swaps run from the first swap step on, burn-in included
    assert t.state.swap_attempt_count == int(j.state.swap_attempt_count) \
        == (350 // 5) * 3


def test_cpu_semantics_acceptance_normalization():
    """As JAX's test: rungs below the hottest attempt MH only on non-swap
    steps, so tiny steps (acceptance ~1) must read ~1, not 1 - 1/4."""
    res = run_pt(MultivariateNormal.create(2, device=CPU),
                 NormalProposal.create(2, 1e-6, device=CPU), 0,
                 np.geomspace(1.0, 0.1, 4).astype(np.float32),
                 num_chains=16, num_iterations=400, burn_in=0, swap_every=4,
                 cpu_semantics=True, device=CPU)
    assert float(res.acceptance_rate.min()) > 0.99
    # only the hottest rung moves on a swap step
    assert int(res.state.accept_count[:-1].max()) <= 400 - 100


@pytest.mark.parametrize("engine", ["rwm", "pt"])
@pytest.mark.parametrize("prop", ["Normal", "Laplace"])
def test_symmetric_false_equals_true_on_symmetric_proposals(engine, prop):
    """The correction log q(x|y) - log q(y|x) of a symmetric proposal is 0
    exactly: the run is the symmetric run bit for bit."""
    d = 3
    tgt = MultivariateNormal.create(d, device=CPU)
    p = (NormalProposal.create(d, 0.8, device=CPU) if prop == "Normal"
         else LaplaceProposal.create(d, 0.8, device=CPU))
    runs = []
    for sym in (True, False):
        if engine == "rwm":
            r = run_rwm(tgt, p, 7, num_chains=16, num_iterations=60,
                        burn_in=5, symmetric=sym, device=CPU)
        else:
            r = run_pt(tgt, p, 7, [1.0, 0.4], num_chains=16,
                       num_iterations=60, burn_in=5, swap_every=4,
                       symmetric=sym, device=CPU)
        runs.append(r.state)
    assert torch.equal(runs[0].x, runs[1].x)
    assert torch.equal(runs[0].accept_count, runs[1].accept_count)


def test_asymmetric_correction_enters_the_ratio():
    """A proposal whose increment density is not symmetric moves the chain
    differently once ``symmetric=False`` (the correction is read)."""
    class Skewed(NormalProposal):
        def log_q_ratio(self, inc, betas):
            return torch.full(inc.shape[1:], -50.0)
    tgt = MultivariateNormal.create(2, device=CPU)
    p = Skewed.create(2, 0.5, device=CPU)
    a = run_rwm(tgt, p, 1, num_chains=32, num_iterations=40, device=CPU)
    b = run_rwm(tgt, p, 1, num_chains=32, num_iterations=40, device=CPU,
                symmetric=False)
    assert float(a.acceptance_rate.mean()) > 0.3
    assert float(b.acceptance_rate.mean()) == 0.0


@pytest.mark.parametrize("engine", ["rwm", "pt"])
def test_progress_every_prints_and_leaves_the_run(engine, capsys):
    tgt = MultivariateNormal.create(2, device=CPU)
    p = NormalProposal.create(2, 1.0, device=CPU)
    kw = dict(num_chains=4, num_iterations=25, burn_in=5, device=CPU,
              unroll=8)
    if engine == "rwm":
        run = lambda **k: run_rwm(tgt, p, 2, **kw, **k)  # noqa: E731
    else:
        run = lambda **k: run_pt(tgt, p, 2, [1.0, 0.5],  # noqa: E731
                                 swap_every=3, **kw, **k)
    a = run(progress_every=10)
    out = capsys.readouterr().out
    assert out.count("progress: step") == 3
    assert "progress: step 10/30" in out and "progress: step 30/30" in out
    assert "steps/s/chain" in out
    b = run()
    assert capsys.readouterr().out == ""
    assert torch.equal(a.state.x, b.state.x)


def test_harness_progress_bar_on_the_eager_engine(capsys):
    sim = TSim(dim=2, sigma=1.0, num_iterations=2500, algorithm="RWM",
               target_dist="MultivariateNormal", num_chains=4,
               record_chain=False, seed=1, engine="scan", device=CPU)
    sim.generate_samples(progress_bar=True, verbose=False)
    out = capsys.readouterr().out
    assert "progress: step 1,000/" in out and "progress: step 2,000/" in out
    plain = TSim(dim=2, sigma=1.0, num_iterations=2500, algorithm="RWM",
                 target_dist="MultivariateNormal", num_chains=4,
                 record_chain=False, seed=1, engine="scan", device=CPU)
    plain.generate_samples(verbose=False)
    assert torch.equal(sim._result.state.x, plain._result.state.x)


def test_harness_cpu_semantics_runs_eager():
    sim = TSim(dim=2, sigma=1.0, num_iterations=200, algorithm="PT",
               target_dist="MultivariateNormal", num_chains=8, burn_in=40,
               seed=3, record_chain=False, geom_temp_spacing=True,
               swap_every=10, cpu_semantics=True, device=CPU)
    sim.generate_samples(verbose=False)
    assert sim.engine_used == "scan"
    assert float(sim._result.acceptance_rate.max()) <= 1.0
    assert sim._result.state.swap_attempt_count == 24 * (len(
        sim.beta_ladder) - 1)


def test_float64_runs_keep_float64():
    set_x64(True)
    try:
        assert default_float() == torch.float64
        sim = TSim(dim=2, sigma=1.0, num_iterations=50, algorithm="PT",
                   target_dist="MultivariateNormal", num_chains=4,
                   record_chain=False, seed=2, device=CPU)
        sim.generate_samples(verbose=False)
        assert sim.engine_used == "scan"
        st = sim._result.state
        assert st.x.dtype == st.logp.dtype == torch.float64
        r = run_rwm(MultivariateNormal.create(2, device=CPU),
                    NormalProposal.create(2, 1.0, device=CPU), 0,
                    num_chains=4, num_iterations=10, device=CPU)
        assert r.state.x.dtype == r.esjd.dtype == torch.float64
    finally:
        set_x64(False)
