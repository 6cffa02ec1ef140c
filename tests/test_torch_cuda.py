"""The port's CUDA kernels against their plain PyTorch versions, on the card.

Imports torch and the port only (no JAX), so it also runs where JAX is not
installed:

    python -m pytest --noconftest -p no:cacheprovider -m cuda tests/test_torch_cuda.py

Without a card every test skips; whether a card is present is decided
inside each test, so every pytest-xdist worker collects the same tests.
"""
from collections import Counter

import numpy as np
import pytest
import torch

from rwm_pt_tpu_torch.api import MCMCSimulation
from rwm_pt_tpu_torch.kernels import agreement, run_pt_fused, run_rwm_fused
from rwm_pt_tpu_torch.kernels.draws import seed_key
from rwm_pt_tpu_torch.kernels.fused_pt import (_run_pt_fused_plain,
                                               launch_pt_kernel, rung_scales)
from rwm_pt_tpu_torch.kernels.fused_rwm import (_run_rwm_fused_plain,
                                                launch_rwm_kernel,
                                                proposal_scale)
from rwm_pt_tpu_torch.proposals import (NormalProposal,
                                        create_proposal_distribution)
from rwm_pt_tpu_torch.targets import FullRosenbrock, MultivariateNormal

torch.set_num_threads(1)
pytestmark = pytest.mark.cuda
AGREE_ATOL, AGREE_MIN = agreement.X_ATOL, 0.95


def _card():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device: the port's kernels run on the card "
                    "only")
    return torch.device("cuda")


def _rates_agree(a, b, n):
    pa, pb = a.sum().item() / n, b.sum().item() / n
    p = 0.5 * (pa + pb)
    return abs(pa - pb) < 5 * np.sqrt(max(p * (1 - p), 1e-12) * 2 / n)


@pytest.mark.parametrize("kind", ["rosenbrock", "mvn_iso"])
def test_pt_kernel_matches_plain(kind):
    """Nearly every replica agrees to 1e-3 (f32 rounding can flip a rare
    accept decision, after which that replica diverges); on those replicas
    every counter is equal and lp, the beta-jump and the cold-jump sums
    agree to rtol 1e-4; the counters' rates agree to 5 standard errors; the
    launch counter moves by one."""
    dev = _card()
    d, T, C = (30, 10, 2048) if kind == "rosenbrock" else (10, 6, 1000)
    target = (FullRosenbrock.create(d, device=dev) if kind == "rosenbrock"
              else MultivariateNormal.create(d, device=dev))
    betas = torch.logspace(0, -2, T, device=dev)
    base = 0.5 ** 2 / d if kind == "rosenbrock" else 2.38 ** 2 / d
    sig = torch.sqrt(torch.tensor(base, device=dev) / betas)
    g = torch.Generator(device=dev).manual_seed(1)
    x0 = (0.5 * torch.randn(d, 1, C, generator=g, device=dev)).expand(
        d, T, C).contiguous()
    zi = lambda *s: torch.zeros(*s, dtype=torch.int32, device=dev)  # noqa
    zf = lambda *s: torch.zeros(*s, device=dev)  # noqa
    args = (target, x0, zi(T, C), zi(C), zf(C), zf(C), betas, sig,
            seed_key(3), 7, 200, 50, 10)
    before = launch_pt_kernel.launches["fused_pt"]
    k = launch_pt_kernel(*args)
    assert launch_pt_kernel.launches["fused_pt"] == before + 1
    p = _run_pt_fused_plain(*args)
    a = agreement.hold(k, p, agreement.PT_OUTPUTS)
    assert a.frac >= AGREE_MIN
    assert not a.mismatched, agreement.describe(a)
    assert torch.isfinite(k[1]).all()
    n_mh = (207 - 50) * T * C
    assert _rates_agree(k[2], p[2], n_mh)
    assert _rates_agree(k[3], p[3], (207 // 10 - 5) * (T - 1) * C)


def test_rwm_kernel_matches_plain():
    dev = _card()
    d, C = 10, 2000          # C not a multiple of the 128-thread block
    target = MultivariateNormal.create(d, device=dev)
    x0 = torch.randn(d, C, device=dev)
    args = (target, x0, torch.zeros(C, dtype=torch.int32, device=dev),
            torch.zeros(C, device=dev), torch.tensor(1.0, device=dev),
            torch.sqrt(torch.tensor(2.38 ** 2 / d, device=dev)), seed_key(9),
            0, 200, 20)
    before = launch_rwm_kernel.launches["fused_rwm"]
    k = launch_rwm_kernel(*args)
    assert launch_rwm_kernel.launches["fused_rwm"] == before + 1
    p = _run_rwm_fused_plain(*args)
    a = agreement.hold(k, p, agreement.RWM_OUTPUTS)
    assert a.frac >= AGREE_MIN
    assert not a.mismatched, agreement.describe(a)
    assert _rates_agree(k[2], p[2], 180 * C)


def test_resume_on_card_equals_uninterrupted():
    """The counter carries the absolute step: a resumed kernel run draws
    what an uninterrupted one would.  The resumed launch recomputes the
    log-densities from x, which may round differently from the carried
    ones, so a rare replica may part ways."""
    dev = _card()
    target = FullRosenbrock.create(8, device=dev)
    kw = dict(base_variance=0.05, num_chains=500, burn_in=5, swap_every=4,
              device=dev)
    whole = run_pt_fused(target, 4, [1.0, 0.5, 0.2], num_iterations=60, **kw)
    a = run_pt_fused(target, 4, [1.0, 0.5, 0.2], num_iterations=25, **kw)
    b = run_pt_fused(target, 4, [1.0, 0.5, 0.2], num_iterations=35,
                     resume_state=a.state, **kw)
    same = (whole.state.x - b.state.x).abs().amax(dim=(0, 1)) < AGREE_ATOL
    assert same.float().mean().item() >= 0.99
    assert _rates_agree(whole.state.accept_count, b.state.accept_count,
                        60 * 3 * 500)
    assert b.state.swap_attempt_count == whole.state.swap_attempt_count


def test_unsupported_inputs_raise_on_card():
    dev = _card()
    full = MultivariateNormal.create(3, cov=np.diag([1.0, 2.0, 3.0]),
                                     device=dev)
    with pytest.raises(NotImplementedError, match="ROADMAP"):
        run_pt_fused(full, 0, [1.0, 0.5], base_variance=1.0, num_chains=4,
                     num_iterations=2, device=dev)
    with pytest.raises(NotImplementedError, match="ROADMAP"):
        run_rwm_fused(full, 0, base_variance=1.0, num_chains=4,
                      num_iterations=2, device=dev)
    iso = MultivariateNormal.create(3, device=dev)
    with pytest.raises(ValueError, match="draws"):
        run_rwm_fused(iso, 0, base_variance=1.0, num_chains=4,
                      num_iterations=1, device=dev, draws=())
    r = run_rwm_fused(iso, 0, proposal=NormalProposal.create(3, 1.0,
                                                             device=dev),
                      num_chains=4, num_iterations=0, device=dev)
    assert r.state.step == 0 and torch.isfinite(r.state.logp).all()


PARAMS = {"Normal": {"base_variance_scalar": 0.04},
          "Laplace": {"base_variance_vector": 0.04},
          "UniformRadius": {"base_radius": 0.75}}


@pytest.mark.parametrize("algo,prop,record", [
    ("pt", "Laplace", False), ("pt", "UniformRadius", False),
    ("pt", "Normal", True), ("rwm", "Laplace", False),
    ("rwm", "UniformRadius", False), ("rwm", "Normal", True)],
    ids=["pt-laplace", "pt-uniform_radius", "pt-record", "rwm-laplace",
         "rwm-uniform_radius", "rwm-record"])
def test_new_variant_matches_plain(algo, prop, record):
    """The Laplace, UniformRadius and recording variants against their
    plain versions, with the hold of the Normal kernels; a recorded trace
    (every 7th of 150 steps, so 3 trailing steps go unrecorded) agrees to
    1e-3 on the agreeing replicas.  Every replica is recorded, so that
    PT's two recorded swap steps (absolute 80 and 150) show a snapshot
    taken before the swap sweep.  d=14 puts UniformRadius's radius word
    (slot d+2) in a Philox block that Normal never draws."""
    dev = _card()
    d, T, C = 14, 5, 1000
    target = FullRosenbrock.create(d, device=dev)
    p = create_proposal_distribution(d, {"name": prop,
                                         "params": PARAMS[prop]}, device=dev)
    g = torch.Generator(device=dev).manual_seed(2)
    zi = lambda *s: torch.zeros(*s, dtype=torch.int32, device=dev)  # noqa
    zf = lambda *s: torch.zeros(*s, device=dev)  # noqa
    kw = dict(record_every=7 if record else 0,
              record_chains=C if record else 0)
    if algo == "pt":
        betas = torch.logspace(0, -2, T, device=dev)
        kind, sig = rung_scales(p, None, betas, torch.ones_like(betas))
        x0 = (0.5 * torch.randn(d, 1, C, generator=g, device=dev)).expand(
            d, T, C).contiguous()
        args = (target, x0, zi(T, C), zi(C), zf(C), zf(C), betas, sig,
                seed_key(5), 3, 150, 20, 10)
        launch, plain = launch_pt_kernel, _run_pt_fused_plain
        names = agreement.PT_REC_OUTPUTS if record else agreement.PT_OUTPUTS
    else:
        beta = torch.tensor(1.0, device=dev)
        kind, scale = proposal_scale(p, None, beta)
        x0 = 0.5 * torch.randn(d, C, generator=g, device=dev)
        args = (target, x0, zi(C), zf(C), beta, scale, seed_key(5), 3, 150,
                20)
        launch, plain = launch_rwm_kernel, _run_rwm_fused_plain
        names = (agreement.RWM_REC_OUTPUTS if record
                 else agreement.RWM_OUTPUTS)
    before = Counter(launch.launches)
    k = launch(*args, kind=kind, **kw)
    lib = f"fused_{algo}" + {"Normal": "", "Laplace": "_laplace",
                             "UniformRadius": "_uniform_radius"}[prop]
    want = Counter({lib: 1})
    if record:
        want[f"fused_{algo}_record"] = 1
    assert launch.launches - before == want
    pl = plain(*args, kind=kind, **kw)
    a = agreement.hold(k, pl, names)
    assert a.frac >= AGREE_MIN, agreement.describe(a)
    assert not a.mismatched, agreement.describe(a)
    if record:
        assert tuple(k[-1].shape) == (150 // 7, d, C)
        assert torch.isfinite(k[-1]).all()


@pytest.mark.parametrize("algo", ["PT", "RWM"])
def test_recorded_harness_run_on_card(algo):
    """MCMCSimulation records on the fused kernel in one launch, with no
    limit on the recorded batch; the burn-in entries are trimmed."""
    dev = _card()
    sim = MCMCSimulation(dim=6, sigma=0.3, num_iterations=300,
                         algorithm=algo, target_dist="FullRosenbrock",
                         beta_ladder=[1.0, 0.5, 0.25], num_chains=5000,
                         swap_every=10, burn_in=20, record_chains=3,
                         device=dev)
    launch = launch_pt_kernel if algo == "PT" else launch_rwm_kernel
    src = "fused_pt" if algo == "PT" else "fused_rwm"
    before = Counter(launch.launches)
    chain = sim.generate_samples(verbose=False)
    assert launch.launches - before == Counter({src: 1, src + "_record": 1})
    assert sim.engine_used == "pallas"
    assert chain.shape == (300, 6) and np.isfinite(chain).all()
    assert np.isfinite(sim.split_rhat()).all()
    assert np.isfinite(sim.effective_sample_size()).all()
    info = sim.get_diagnostic_info()
    assert info["backend"].startswith("cuda")
    assert info["devices"] == [torch.cuda.get_device_name(dev)]
