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
from rwm_pt_tpu_torch.kernels import _build, draw_probes, draws, ptxas_report
from rwm_pt_tpu_torch.kernels._build import by_variant
from rwm_pt_tpu_torch.targets import (FullRosenbrock, MultivariateNormal,
                                      get_target_distribution)

torch.set_num_threads(1)
pytestmark = pytest.mark.cuda
AGREE_ATOL, AGREE_MIN = agreement.X_ATOL, 0.95
STUDY_DRAWS = ("icdf_fastlog", "lax_erfinv", "fake_uniform")
WARP_DRAW = draws.resolve_normal_impl("pt", 65536)


@pytest.fixture(scope="module", autouse=True)
def _libraries():
    """Build the libraries these tests launch, one nvcc each, all at once
    (a test that needs another builds it on first use)."""
    if not torch.cuda.is_available():
        return
    lib = _build.lib_name
    names = [lib(v, "rosenbrock", d)
             for v in ("fused_pt", "fused_rwm", "fused_pt_laplace",
                       "fused_rwm_laplace", "fused_pt_uniform_radius",
                       "fused_rwm_uniform_radius")
             for d in (6, 8, 14, 30)]
    names += [lib(v, "rosenbrock", 9) for v in (
        "fused_pt_bm", "fused_rwm_bm", "fused_pt_uniform_radius_bm",
        "fused_rwm_uniform_radius_bm")]
    names += [lib(v, "rosenbrock", d)
              for v in ("fused_pt_bm", "fused_rwm_bm") for d in (6, 8)]
    names += [lib(v, "mvn_iso", d) for v in ("fused_pt", "fused_rwm")
              for d in (3, 10)]
    names += [lib(v, kind, KIND_CASES[kind][2])
              for v in ("fused_pt", "fused_rwm") for kind in KIND_CASES]
    names.append(lib("fused_pt", "mvn_full", 30))
    names.append(lib("fused_pt", "rosenbrock", 64))
    names += [lib(v, "mvn_iso", d)
              for v in ("fused_pt", "fused_rwm", "fused_pt_bm", "fused_rwm_bm")
              for d in (1, 32, 33)]
    names += [lib(_build.library(f"fused_{a}", "Normal", draws.
                                 resolve_normal_impl(a, 65536, "rosenbrock")),
                  "rosenbrock", 30) for a in ("pt", "rwm")]
    names += [lib(_build.library(f"fused_{a}", p, impl), "rosenbrock", 9)
              for a in ("pt", "rwm") for p in ("Normal", "UniformRadius")
              for impl in STUDY_DRAWS]
    names.append(_build.PROBES)
    names += [lib(_build.library(f"fused_{a}", "Normal", WARP_DRAW), k, d)
              for a in ("pt", "rwm") for k in ("rosenbrock", "mvn_iso")
              for d in (100, 200, 500, 1000)]
    for a in ("pt", "rwm"):
        v = _build.library(f"fused_{a}", "Normal", draws.resolve_normal_impl(
            a, 1003, "super_funnel"))
        for J, K in SF_SHAPES:
            tg = get_target_distribution("SuperFunnel", 0, J=J, K=K,
                                         device="cpu")
            names += [_build.route(v, tg, specialize=spec)[0]
                      for spec in (True, False)]
    names += [_build.ladder_lib(k, 7) for k in _build.TARGET_KINDS
              if k not in ("rosenbrock", "super_funnel")]
    names += [_build.ladder_lib("mvn_iso", d) for d in (100, 200, 300, 1000)]
    names += [_build.ladder_lib(k, d) for k in LADDER_CASES
              for d in (72, 253, 509)]
    for a, kind, d in WIDER_CASES:   # the widest buckets, both layouts
        n = lib(_build.library(f"fused_{a}", "Normal", WARP_DRAW), kind, d)
        names += [n] + ([_build.cluster_lib(n)] if a == "pt" else [])
    names += [_build.ladder_lib("mvn_full", d) for d in WIDER_LADDER_D]
    _build.build(list(dict.fromkeys(names)))


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
    before = launch_pt_kernel.launches[f"fused_pt.{kind}"]
    k = launch_pt_kernel(*args)
    assert launch_pt_kernel.launches[f"fused_pt.{kind}"] == before + 1
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
    before = launch_rwm_kernel.launches["fused_rwm.mvn_iso"]
    k = launch_rwm_kernel(*args)
    assert launch_rwm_kernel.launches["fused_rwm.mvn_iso"] == before + 1
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


def test_unsupported_inputs_raise_on_card(monkeypatch):
    dev = _card()
    # a dataset that no thread-per-replica block holds (80,010 parameter
    # words, d = 26) is refused, naming the words; no fallback
    big = get_target_distribution("SuperFunnel", 0, n_per_group=4000,
                                  device=dev)
    with pytest.raises(ValueError, match="80010 of its words"):
        run_pt_fused(big, 0, [1.0, 0.5], base_variance=0.01, num_chains=64,
                     num_iterations=2, device=dev)
    with pytest.raises(ValueError, match="80010 of its words"):
        run_rwm_fused(big, 0, base_variance=0.01, num_chains=64,
                      num_iterations=2, device=dev)
    # and a fixed-shape build of it, routed there by a raised word limit,
    # fails to build (the kernel's own limit) and raises: no fallback
    monkeypatch.setattr(_build, "SF_FIXED_MAX_WORDS", 10 ** 6)
    x0 = torch.zeros(big.dim, 64, device=dev)
    with pytest.raises(RuntimeError, match="kernel build failed"):
        launch_rwm_kernel(big, x0, torch.zeros(64, dtype=torch.int32,
                                               device=dev),
                          torch.zeros(64, device=dev),
                          torch.tensor(1.0, device=dev),
                          torch.tensor(0.1, device=dev), seed_key(1), 0, 2,
                          0)
    # likewise a team dataset over the shared-memory budget (d = 166,
    # 12,972 padded words) routed to a fixed team build by a raised budget
    monkeypatch.setattr(_build, "PARAMS_SHARED_MAX", 10 ** 6)
    wide_sf = get_target_distribution("SuperFunnel", 0, J=40, K=3,
                                      n_per_group=80, device=dev)
    assert _build.fixed_shape(_build.route("fused_rwm", wide_sf)[0])
    x0 = torch.zeros(wide_sf.dim, 64, device=dev)
    with pytest.raises(RuntimeError, match="kernel build failed"):
        launch_rwm_kernel(wide_sf, x0, torch.zeros(64, dtype=torch.int32,
                                                   device=dev),
                          torch.zeros(64, device=dev),
                          torch.tensor(1.0, device=dev),
                          torch.tensor(0.1, device=dev), seed_key(1), 0, 2,
                          0)
    monkeypatch.undo()
    wide = FullRosenbrock.create(4093, device=dev)   # above the warp buckets
    with pytest.raises(NotImplementedError, match="ROADMAP"):
        run_pt_fused(wide, 0, [1.0, 0.5], base_variance=1.0, num_chains=4,
                     num_iterations=2, device=dev)
    with pytest.raises(NotImplementedError, match="ROADMAP"):
        run_rwm_fused(wide, 0, base_variance=1.0, num_chains=4,
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
    assert by_variant(launch.launches - before) == want
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
    variant = _build.library(src, "Normal", draws.resolve_normal_impl(
        algo.lower(), 5000, "rosenbrock"))
    before = Counter(launch.launches)
    chain = sim.generate_samples(verbose=False)
    assert by_variant(launch.launches - before) == Counter(
        {variant: 1, src + "_record": 1})
    assert sim.engine_used == "pallas"
    assert chain.shape == (300, 6) and np.isfinite(chain).all()
    assert np.isfinite(sim.split_rhat()).all()
    assert np.isfinite(sim.effective_sample_size()).all()
    info = sim.get_diagnostic_info()
    assert info["backend"].startswith("cuda")
    assert info["devices"] == [torch.cuda.get_device_name(dev)]


# target kind -> (registry name, registry kwargs, dim, Normal variance)
KIND_CASES = {
    "mvn_full": ("MultivariateNormal", "cov", 7, 0.8),
    "scaled_mvn": ("MultivariateNormalScaled", None, 7, 0.5),
    "three_mixture": ("ThreeMixtureScaled", None, 7, 0.8),
    "rough_carpet": ("RoughCarpetScaled", None, 7, 0.5),
    "even_rosenbrock": ("EvenRosenbrock", None, 8, 0.05),
    "hybrid_rosenbrock": ("HybridRosenbrock", {"n1": 3, "n2": 3}, 7, 0.01),
    "hypercube": ("Hypercube", None, 7, 0.1),
    "iid_gamma": ("IIDGamma", None, 7, 2.0),
    "iid_beta": ("IIDBeta", None, 7, 0.01),
    "neal_funnel": ("NealFunnel", None, 7, 0.5),
}


def kind_target(kind, dev):
    name, kw, d, var = KIND_CASES[kind]
    if kw == "cov":
        a = np.random.default_rng(3).normal(size=(d, d))
        kw = {"cov": a @ a.T / d + np.eye(d)}
    t = get_target_distribution(name, d, device=dev, **(kw or {}))
    assert _build.kernel_target(t)[0] == kind
    return t, var


@pytest.mark.parametrize("algo", ["pt", "rwm"])
@pytest.mark.parametrize("kind", list(KIND_CASES))
def test_target_kind_matches_plain(kind, algo):
    """Every target kind's library against the plain version (which calls
    the target's log_density_td) with the hold of the Normal kernels, from
    the target's own initial states; the launch is counted under
    ``<variant>.<kind>``."""
    dev = _card()
    target, var = kind_target(kind, dev)
    d, T, C = target.dim, 4, 1000
    g = torch.Generator(device=dev).manual_seed(4)
    x0 = target.init_sample(C, g).T.contiguous()
    zi = lambda *s: torch.zeros(*s, dtype=torch.int32, device=dev)  # noqa
    zf = lambda *s: torch.zeros(*s, device=dev)  # noqa
    if algo == "pt":
        betas = torch.logspace(0, -1.5, T, device=dev)
        sig = torch.sqrt(torch.tensor(var, device=dev) / betas)
        args = (target, x0[:, None].expand(d, T, C).contiguous(), zi(T, C),
                zi(C), zf(C), zf(C), betas, sig, seed_key(6), 0, 150, 20, 10)
        launch, plain, names = (launch_pt_kernel, _run_pt_fused_plain,
                                agreement.PT_OUTPUTS)
    else:
        beta = torch.tensor(1.0, device=dev)
        args = (target, x0, zi(C), zf(C), beta,
                torch.sqrt(torch.tensor(var, device=dev)), seed_key(6), 0,
                150, 20)
        launch, plain, names = (launch_rwm_kernel, _run_rwm_fused_plain,
                                agreement.RWM_OUTPUTS)
    before = Counter(launch.launches)
    k = launch(*args)
    assert launch.launches - before == Counter(
        {f"fused_{algo}.{kind}": 1})
    p = plain(*args)
    a = agreement.hold(k, p, names, lp_of=target.log_density_td)
    assert a.frac >= AGREE_MIN, agreement.describe(a)
    assert not a.mismatched, agreement.describe(a)
    assert (k[2] > 0).any()


@pytest.mark.parametrize("algo,prop", [("pt", "Normal"),
                                       ("pt", "UniformRadius"),
                                       ("rwm", "Normal"),
                                       ("rwm", "UniformRadius")])
def test_box_muller_matches_plain(algo, prop):
    """The Box-Muller variants against their plain versions at an odd d
    (the last pair's angle in slot d+3) and with NORMAL_IMPL = "bm" through
    the entry points."""
    _hold_draw_variant(algo, prop, "bm")


@pytest.mark.parametrize("algo,prop,impl", [
    (a, p, i) for a in ("pt", "rwm") for p in ("Normal", "UniformRadius")
    for i in STUDY_DRAWS])
def test_study_draw_matches_plain(algo, prop, impl):
    """The draw study's variants (icdf_fastlog, lax_erfinv, fake_uniform)
    against their plain versions, and forced through the entry points with
    NORMAL_IMPL, each launch counted under its own library."""
    _hold_draw_variant(algo, prop, impl)


def _hold_draw_variant(algo, prop, impl):
    """Hold the ``impl`` variant of kernel ``algo`` for ``prop`` against
    its plain version on FullRosenbrock d=9, then run it once through the
    entry point with ``draws.NORMAL_IMPL = impl``."""
    dev = _card()
    d, T, C = 9, 4, 1000
    target = FullRosenbrock.create(d, device=dev)
    p = create_proposal_distribution(d, {"name": prop,
                                         "params": PARAMS[prop]}, device=dev)
    g = torch.Generator(device=dev).manual_seed(7)
    zi = lambda *s: torch.zeros(*s, dtype=torch.int32, device=dev)  # noqa
    zf = lambda *s: torch.zeros(*s, device=dev)  # noqa
    if algo == "pt":
        betas = torch.logspace(0, -2, T, device=dev)
        kind, sig = rung_scales(p, None, betas, torch.ones_like(betas))
        x0 = (0.5 * torch.randn(d, 1, C, generator=g, device=dev)).expand(
            d, T, C).contiguous()
        args = (target, x0, zi(T, C), zi(C), zf(C), zf(C), betas, sig,
                seed_key(8), 0, 150, 20, 10)
        launch, plain, names = (launch_pt_kernel, _run_pt_fused_plain,
                                agreement.PT_OUTPUTS)
    else:
        beta = torch.tensor(1.0, device=dev)
        kind, sig = proposal_scale(p, None, beta)
        x0 = 0.5 * torch.randn(d, C, generator=g, device=dev)
        args = (target, x0, zi(C), zf(C), beta, sig, seed_key(8), 0, 150, 20)
        launch, plain, names = (launch_rwm_kernel, _run_rwm_fused_plain,
                                agreement.RWM_OUTPUTS)
    variant = _build.library(f"fused_{algo}", prop, impl)
    before = Counter(launch.launches)
    k = launch(*args, kind=kind, draw=impl)
    assert by_variant(launch.launches - before) == Counter({variant: 1})
    a = agreement.hold(k, plain(*args, kind=kind, draw=impl), names)
    assert a.frac >= AGREE_MIN, agreement.describe(a)
    assert not a.mismatched, agreement.describe(a)
    old = draws.NORMAL_IMPL
    draws.NORMAL_IMPL = impl
    try:
        before = Counter(launch.launches)
        run = run_pt_fused if algo == "pt" else run_rwm_fused
        extra = ([1.0, 0.5],) if algo == "pt" else ()
        run(target, 1, *extra, proposal=p, num_chains=64, num_iterations=5,
            device=dev)
        assert by_variant(launch.launches - before) == Counter({variant: 1})
    finally:
        draws.NORMAL_IMPL = old


def test_even_odd_sweep_matches_plain():
    """The even/odd pair order of the PT kernel against its plain
    version, swapping every 5 steps."""
    dev = _card()
    d, T, C = 6, 7, 1000
    target = MultivariateNormal.create(d, device=dev)
    betas = torch.logspace(0, -2, T, device=dev)
    sig = torch.sqrt(torch.tensor(2.38 ** 2 / d, device=dev) / betas)
    g = torch.Generator(device=dev).manual_seed(9)
    x0 = torch.randn(d, T, C, generator=g, device=dev)
    zi = lambda *s: torch.zeros(*s, dtype=torch.int32, device=dev)  # noqa
    zf = lambda *s: torch.zeros(*s, device=dev)  # noqa
    args = (target, x0, zi(T, C), zi(C), zf(C), zf(C), betas, sig,
            seed_key(10), 0, 150, 20, 5)
    k = launch_pt_kernel(*args, swap_sweep="even_odd")
    p = _run_pt_fused_plain(*args, swap_sweep="even_odd")
    a = agreement.hold(k, p, agreement.PT_OUTPUTS)
    assert a.frac >= AGREE_MIN, agreement.describe(a)
    assert not a.mismatched, agreement.describe(a)
    seq = _run_pt_fused_plain(*args)
    assert not torch.equal(seq[3], p[3])   # the two orders differ


def _mvn_full(d, dev):
    a = np.random.default_rng(3).normal(size=(d, d))
    return get_target_distribution("MultivariateNormal", d, device=dev,
                                   cov=a @ a.T / d + np.eye(d))


@pytest.mark.parametrize("kind,T,d", [("rosenbrock", 20, 30),
                                      ("rosenbrock", 32, 64),
                                      ("mvn_full", 32, 30)])
def test_runtime_replicas_per_block_match_plain(kind, T, d):
    """Launches whose 32 x T threads exceed the kernel's 320-thread launch
    bound (T = 20 and T = 32, at d = 30 and at the 64 bucket, where the
    state and sine slabs take 120 KB a block, and the full-covariance MVN)
    take the instantiation that reads R, the replicas a block, at run time:
    fewer than 32, and 1003 replicas leave a ragged last block.  It is
    held against the plain version like the R=32 kernel."""
    dev = _card()
    C = 1003
    target = (FullRosenbrock.create(d, device=dev) if kind == "rosenbrock"
              else _mvn_full(d, dev))
    name = _build.lib_name("fused_pt", kind, d)
    n_params = _build.kernel_target(target)[1].numel()
    geo = _build.launch_geometry(name, d, C, T, "Normal", "icdf", n_params)
    assert geo.runtime_r and geo.replicas < 32 and C % geo.replicas, geo
    assert _build.kernel_info(name, d, T, geo.replicas, n_params,
                              runtime_r=True)["blocks_per_sm"] >= 1
    base = 0.5 ** 2 / d if kind == "rosenbrock" else 0.4
    betas = torch.logspace(0, -2, T, device=dev)
    sig = torch.sqrt(torch.tensor(base, device=dev) / betas)
    g = torch.Generator(device=dev).manual_seed(11)
    x0 = target.init_sample(C, g).T[:, None].expand(d, T, C).contiguous()
    zi = lambda *s: torch.zeros(*s, dtype=torch.int32, device=dev)  # noqa
    zf = lambda *s: torch.zeros(*s, device=dev)  # noqa
    args = (target, x0, zi(T, C), zi(C), zf(C), zf(C), betas, sig,
            seed_key(12), 0, 150, 20, 10)
    before = Counter(launch_pt_kernel.launches)
    k = launch_pt_kernel(*args)
    assert launch_pt_kernel.launches - before == Counter(
        {f"fused_pt.{kind}": 1})
    a = agreement.hold(k, _run_pt_fused_plain(*args), agreement.PT_OUTPUTS,
                       lp_of=target.log_density_td)
    assert a.frac >= AGREE_MIN, agreement.describe(a)
    assert not a.mismatched, agreement.describe(a)
    assert (k[2] > 0).any() and (k[3] > 0).any()


@pytest.mark.parametrize("algo", ["pt", "rwm"])
def test_main_path_library_layout(algo):
    """The flagship's and the RWM headline's libraries: no stack frame and
    no spills in either instantiation (Box-Muller's sines wait in shared
    memory), the PT one 32 replicas a block and at least two 320-thread
    blocks an SM; the shared bytes and blocks per SM of
    ``_build.launch_geometry`` are what the CUDA runtime reports."""
    _card()
    d, T, C = 30, 10, 65536
    draw = draws.resolve_normal_impl(algo, C, "rosenbrock")
    name = _build.lib_name(_build.library(f"fused_{algo}", "Normal", draw),
                           "rosenbrock", d)
    entries = ptxas_report.parse(_build.build([name])[name])
    assert entries and all(f == 0 and sp == 0 for _, _, f, sp in entries), \
        entries
    # built under its source's cap, not one of the fewer-block exceptions
    assert _build._parts(name)[5] == _build.MIN_BLOCKS[f"fused_{algo}"]
    if algo == "pt":
        geo = _build.launch_geometry(name, d, C, T, "Normal", draw, d + 1)
        info = _build.kernel_info(name, d, T, geo.replicas, d + 1)
        assert not geo.runtime_r and geo.replicas == 32, geo
        assert info["blocks_per_sm"] >= 2, info
    else:
        geo = _build.launch_geometry(name, d, C, 0, "Normal", draw, d + 1)
        info = _build.kernel_info(name, d, 1, geo.replicas, d + 1)
    assert info["local_bytes"] == 0
    assert info["shared_bytes"] == geo.shared_bytes
    assert info["blocks_per_sm"] == geo.blocks_per_sm, (info, geo)


# (algo, d, T, C): d at the bottom and top of a bucket and just above it,
# one rung and 32 rungs, one replica, and C not a multiple of the block
EDGE_CASES = [("pt", 1, 4, 1000), ("pt", 32, 4, 1000), ("pt", 33, 4, 1000),
              ("pt", 32, 1, 1000), ("pt", 1, 32, 1000), ("pt", 33, 3, 1),
              ("rwm", 1, 1, 1000), ("rwm", 32, 1, 1000),
              ("rwm", 33, 1, 1000), ("rwm", 33, 1, 1),
              # more than 32 rungs: the runtime-R instantiation, 9, 6 and 5
              # replicas a block
              ("pt", 32, 33, 1000), ("pt", 10, 50, 1000),
              ("pt", 64, 64, 1000)]


@pytest.mark.parametrize("draw", ["icdf", "bm"])
@pytest.mark.parametrize("algo,d,T,C", EDGE_CASES,
                         ids=[f"{a}-d{d}-T{t}-C{c}"
                              for a, d, t, c in EDGE_CASES])
def test_edge_shapes_match_plain(algo, d, T, C, draw):
    """The slab layout at the edges of its shapes, held against the plain
    version on the isotropic MVN (Box-Muller's sines too: at d = 1 the
    only pair's angle sits in slot d+3, at d = 33 the sines take 17 rows):
    every replica that runs shares no column with another."""
    dev = _card()
    target = MultivariateNormal.create(d, device=dev)
    g = torch.Generator(device=dev).manual_seed(13)
    zi = lambda *s: torch.zeros(*s, dtype=torch.int32, device=dev)  # noqa
    zf = lambda *s: torch.zeros(*s, device=dev)  # noqa
    var = 2.38 ** 2 / d
    if algo == "pt":
        betas = torch.logspace(0, -1.5, T, device=dev)
        sig = torch.sqrt(torch.tensor(var, device=dev) / betas)
        x0 = torch.randn(d, T, C, generator=g, device=dev)
        args = (target, x0, zi(T, C), zi(C), zf(C), zf(C), betas, sig,
                seed_key(14), 0, 120, 20, 5)
        launch, plain, names = (launch_pt_kernel, _run_pt_fused_plain,
                                agreement.PT_OUTPUTS)
    else:
        x0 = torch.randn(d, C, generator=g, device=dev)
        args = (target, x0, zi(C), zf(C), torch.tensor(1.0, device=dev),
                torch.sqrt(torch.tensor(var, device=dev)), seed_key(14), 0,
                120, 20)
        launch, plain, names = (launch_rwm_kernel, _run_rwm_fused_plain,
                                agreement.RWM_OUTPUTS)
    k = launch(*args, draw=draw)
    p = plain(*args, draw=draw)
    a = agreement.hold(k, p, names, lp_of=target.log_density_td)
    assert a.frac >= (AGREE_MIN if C > 1 else 1.0), agreement.describe(a)
    assert not a.mismatched, agreement.describe(a)
    assert torch.isfinite(k[1]).all() and (k[2] > 0).any()


@pytest.mark.parametrize("impl", draws.NORMAL_IMPLS)
def test_draw_normals_probe_matches_plain(impl):
    """The normal-draw probe kernel against its plain version on the same
    Philox words: every element to rtol 1e-5 (CUDA's erfinvf and ATen's
    erfinv may differ by a few ulp), the launch counted under its draw."""
    dev = _card()
    n = 1 << 16
    before = Counter(draw_probes.draw_normals.launches)
    z = draw_probes.draw_normals(impl, 7, n, device=dev)
    torch.cuda.synchronize()
    assert draw_probes.draw_normals.launches - before == Counter({impl: 1})
    assert z.shape == (8, n // 8) and torch.isfinite(z).all()
    p = draw_probes._draw_normals_plain(impl, 7, n, dev)
    torch.testing.assert_close(z, p, rtol=1e-5, atol=1e-6)


def test_fast_log_probe_matches_plain():
    """The fast_log probe kernel on the 8192 inputs of
    tests/test_pallas_kernels.py:454-457: its plain version's bits (both
    round every product and sum on its own), and within the JAX test's
    bound 1e-6 + 1e-7 |log y| of float64 log."""
    dev = _card()
    y = np.concatenate([
        np.logspace(-37, 0, 4096).astype(np.float32),
        np.random.default_rng(0).uniform(1e-7, 1.0, 4096).astype(np.float32),
    ]).reshape(8, 1024)
    yt = torch.from_numpy(y).to(dev)
    before = Counter(draw_probes.fast_log.launches)
    out = draw_probes.fast_log(yt)
    torch.cuda.synchronize()
    assert draw_probes.fast_log.launches - before == Counter({"fast_log": 1})
    torch.testing.assert_close(out, draws.fast_log(yt), rtol=2.4e-7,
                               atol=1e-30)
    exact = np.log(y.astype(np.float64))
    err = np.abs(out.cpu().numpy().astype(np.float64) - exact)
    assert (err < 1e-6 + 1e-7 * np.abs(exact)).all()


def _log_inputs(n, dev, seed=5):
    """n finite positive f32 inputs for fast_log: half log-spaced over
    1e-37 .. 1, half uniform on [1e-7, 1), as the JAX test makes them."""
    g = torch.Generator(device=dev).manual_seed(seed)
    k = n // 2
    return torch.cat([
        torch.logspace(-37, 0, k, dtype=torch.float64, device=dev).float(),
        1e-7 + (1 - 1e-7) * torch.rand(n - k, generator=g, device=dev)])


def _assert_fast_log(out, y):
    """The kernel's logs ``out`` of ``y``: the plain version's to 2 ulp and
    within the JAX test's bound 1e-6 + 1e-7 |log y| of float64 log."""
    torch.testing.assert_close(out, draws.fast_log(y), rtol=2.4e-7,
                               atol=1e-30)
    exact = torch.log(y.double())
    assert ((out.double() - exact).abs()
            < 1e-6 + 1e-7 * exact.abs()).all()


@pytest.mark.parametrize("impl", draws.NORMAL_IMPLS)
@pytest.mark.parametrize("n", [1 << 24, 8 * 1001])
def test_draw_normals_probe_large_and_ragged(impl, n):
    """The normal-draw probe at the bandwidth shape (2^24 normals, 2^21
    columns, 8192 blocks) and at 1001 columns (not a multiple of 4 or of a
    block, so the last block is ragged) against its plain version to rtol
    1e-5."""
    dev = _card()
    z = draw_probes.draw_normals(impl, 11, n, device=dev)
    p = draw_probes._draw_normals_plain(impl, 11, n, dev)
    torch.testing.assert_close(z, p, rtol=1e-5, atol=1e-6)


@pytest.mark.parametrize("y_off,out_off", [(0, 0), (1, 0), (2, 0), (3, 0),
                                           (0, 1), (1, 3), (3, 3)])
def test_fast_log_probe_long_and_misaligned(y_off, out_off):
    """fast_log on 2^24 + 3 floats read from ``y_off`` floats into a buffer
    and written ``out_off`` floats into another: the scalar head up to y's
    16-byte boundary, the float4 body (scalar stores where out is off by
    another amount) and the scalar tail of n % 4, all the plain version's."""
    dev = _card()
    n = (1 << 24) + 3
    y = _log_inputs(n + y_off, dev)[y_off:]
    assert (y.data_ptr() % 16 == 0) == (y_off == 0)
    buf = torch.full((n + out_off,), float("nan"), device=dev)
    out = draw_probes.fast_log(y, out=buf[out_off:])
    torch.cuda.synchronize()
    assert out.data_ptr() == buf[out_off:].data_ptr()
    _assert_fast_log(out, y)
    if out_off:
        assert torch.isnan(buf[:out_off]).all()


def test_fast_log_probe_in_place_and_overlap():
    """fast_log on the card into ``out=y`` (in place, from a misaligned
    view) gives the plain version's logs of the old ``y``; an ``out``
    shifted one float against ``y`` raises and launches nothing."""
    dev = _card()
    n = (1 << 20) + 3
    buf = _log_inputs(n + 2, dev)
    y = buf[1:n + 1]
    want = draws.fast_log(y.clone())
    before = Counter(draw_probes.fast_log.launches)
    assert draw_probes.fast_log(y, out=y) is y
    torch.cuda.synchronize()
    torch.testing.assert_close(y, want, rtol=2.4e-7, atol=1e-30)
    with pytest.raises(ValueError, match="out overlaps y"):
        draw_probes.fast_log(buf[:n], out=buf[1:n + 1])
    assert draw_probes.fast_log.launches - before == Counter(
        {"fast_log": 1})


def test_probes_launch_on_the_current_stream():
    """Inside ``torch.cuda.stream(side)`` both probes launch on ``side``:
    their inputs and outputs are written there after a sleep of ~10 ms, so
    a launch on another stream would read the old input or be overwritten;
    the results are read after ``side.synchronize()``."""
    dev = _card()
    y = _log_inputs(1 << 20, dev)
    y_in = torch.ones_like(y)
    z_out = torch.empty((8, 1 << 17), device=dev)
    torch.cuda.synchronize()
    side = torch.cuda.Stream()
    with torch.cuda.stream(side):
        torch.cuda._sleep(20_000_000)
        y_in.copy_(y)
        z_out.fill_(float("nan"))
        flog = draw_probes.fast_log(y_in)
        z = draw_probes.draw_normals("lax_erfinv", 3, 1 << 20, device=dev,
                                     out=z_out)
    side.synchronize()
    _assert_fast_log(flog, y)
    torch.testing.assert_close(z, draw_probes._draw_normals_plain(
        "lax_erfinv", 3, 1 << 20, dev), rtol=1e-5, atol=1e-6)


@pytest.mark.parametrize("impl", draws.NORMAL_IMPLS)
def test_probes_reuse_out(impl):
    """Both probes write into a reused ``out=`` and return it: each call's
    values are its own call's, none left from the last."""
    dev = _card()
    n = 1 << 16
    out = torch.empty((8, n // 8), device=dev)
    for seed in (1, 2):
        before = Counter(draw_probes.draw_normals.launches)
        assert draw_probes.draw_normals(impl, seed, n, device=dev,
                                        out=out) is out
        assert draw_probes.draw_normals.launches - before == Counter(
            {impl: 1})
        torch.testing.assert_close(out, draw_probes._draw_normals_plain(
            impl, seed, n, dev), rtol=1e-5, atol=1e-6)
    lout = torch.empty(n, device=dev)
    for seed in (1, 2):
        y = _log_inputs(n, dev, seed)
        assert draw_probes.fast_log(y, out=lout) is lout
        _assert_fast_log(lout, y)


def test_probes_replay_in_a_cuda_graph():
    """Each probe captured in a CUDA graph (after a warm-up on the capture's
    side stream) replays to the eager launch's values; fast_log's replay
    reads what its input holds at replay time."""
    dev = _card()
    n = 1 << 20
    y = _log_inputs(n, dev)
    y_static = y.clone()
    z_out = torch.empty((8, n // 8), device=dev)
    l_out = torch.empty_like(y)
    side = torch.cuda.Stream()
    side.wait_stream(torch.cuda.current_stream())
    with torch.cuda.stream(side):
        draw_probes.draw_normals("bm", 9, n, device=dev, out=z_out)
        draw_probes.fast_log(y_static, out=l_out)
    torch.cuda.current_stream().wait_stream(side)
    g = torch.cuda.CUDAGraph()
    with torch.cuda.graph(g):
        draw_probes.draw_normals("bm", 9, n, device=dev, out=z_out)
        draw_probes.fast_log(y_static, out=l_out)
    z_out.zero_()
    y2 = _log_inputs(n, dev, seed=6)
    y_static.copy_(y2)
    g.replay()
    torch.cuda.synchronize()
    assert torch.equal(z_out, draw_probes.draw_normals("bm", 9, n,
                                                        device=dev))
    assert torch.equal(l_out, draw_probes.fast_log(y2))


def test_probe_launch_errors_raise(monkeypatch):
    """A nonzero cudaError from a probe's C entry point raises with its
    code and counts no launch: the entry refuses an unknown draw code
    (cudaErrorInvalidValue), and the wrapper raises on what it returns."""
    dev = _card()
    out = torch.empty((8, 8), device=dev)
    draw_probes.draw_normals("bm", 1, 64, device=dev, out=out)
    stream = torch.cuda.current_stream().cuda_stream
    assert draw_probes._DRAW_NORMALS(99, 1, 0, 8, out.data_ptr(),
                                     stream) == 1
    before = Counter(draw_probes.draw_normals.launches)
    monkeypatch.setattr(draw_probes, "_DRAW_NORMALS", lambda *a: 700)
    with pytest.raises(RuntimeError, match="cudaError 700"):
        draw_probes.draw_normals("bm", 1, 64, device=dev)
    monkeypatch.setattr(draw_probes, "_FAST_LOG", lambda *a: 1)
    with pytest.raises(RuntimeError, match="cudaError 1"):
        draw_probes.fast_log(_log_inputs(64, dev))
    assert draw_probes.draw_normals.launches == before


WARP_CASES = [("pt", 65, "sequential", 10), ("pt", 100, "even_odd", 10),
              ("pt", 100, "sequential", 17),
              ("pt", 200, "sequential", 16), ("pt", 200, "even_odd", 17),
              ("pt", 200, "sequential", 31), ("pt", 200, "even_odd", 32),
              ("rwm", 65, None, 1), ("rwm", 100, None, 1),
              ("rwm", 200, None, 1),
              # the wide buckets (.w512, .w1024): their edges, 32 rungs in
              # the 512 bucket and the 1024 bucket's most (26) of this kind
              ("pt", 253, "sequential", 10), ("pt", 508, "even_odd", 32),
              ("pt", 509, "sequential", 17), ("pt", 1000, "even_odd", 26),
              ("pt", 1020, "sequential", 10), ("rwm", 253, None, 1),
              ("rwm", 509, None, 1), ("rwm", 1020, None, 1)]


def _fits(dmax, g, d, T):
    """Whether a replica of T rung-teams of g lanes at d coordinates fits a
    block of warp bucket ``dmax`` (its threads and rows)."""
    try:
        _build.pt_warp_geometry(64, _build.pt_team_threads(dmax, g), d, dmax,
                                T, 1003, n_params=d + 1, team=g)
    except ValueError:
        return False
    return True


def _team_cases(cases):
    """Each case at every team size its warp bucket's libraries hold that
    takes its rungs (``_build.library_teams``, a static table: every
    worker collects the same tests)."""
    out = []
    for algo, d, sweep, T in cases:
        dmax = _build.warp_bucket(d)
        lib = _build.lib_name(f"fused_{algo}", "rosenbrock", d)
        out += [(algo, d, sweep, T, g) for g in _build.library_teams(lib)
                if algo == "rwm" or _fits(dmax, g, d, T)]
    return out


@pytest.mark.parametrize("algo,d,sweep,T,team", _team_cases(WARP_CASES))
def test_warp_kernels_match_plain(algo, d, sweep, T, team):
    """Above 64 dimensions the wrappers launch the warp library (a team of
    G lanes a replica, its launch counted under ``<variant>.<kind>.w128``,
    ``.w256``, ``.w512`` or ``.w1024``), held against the plain version
    like the thread kernels at every team size G the library holds
    (``team=`` forces it): FullRosenbrock, whose neighbour terms cross
    lanes, 1003 replicas (a ragged last block), PT on 10 rungs, on 16 and
    32 in the 256 bucket, at the wide buckets' edges, on 32 rungs in the
    512 bucket and 26 in the 1024 bucket; odd ladders of 17 and 31 rungs,
    whose blocks below G = 32 are padded to whole warps with idle
    teams."""
    dev = _card()
    C = 1003
    target = FullRosenbrock.create(d, device=dev)
    g = torch.Generator(device=dev).manual_seed(31)
    x0 = target.init_sample(C, g).T.contiguous()
    zi = lambda *s: torch.zeros(*s, dtype=torch.int32, device=dev)  # noqa
    zf = lambda *s: torch.zeros(*s, device=dev)  # noqa
    var = 0.5 ** 2 / d
    if algo == "pt":
        betas = torch.logspace(0, -2, T, device=dev)
        sig = torch.sqrt(torch.tensor(var, device=dev) / betas)
        args = (target, x0[:, None].expand(d, T, C).contiguous(), zi(T, C),
                zi(C), zf(C), zf(C), betas, sig, seed_key(32), 0, 150, 20,
                10)
        launch, plain, names = (launch_pt_kernel, _run_pt_fused_plain,
                                agreement.PT_OUTPUTS)
        kw = dict(draw=WARP_DRAW, swap_sweep=sweep, team=team)
    else:
        args = (target, x0, zi(C), zf(C), torch.tensor(1.0, device=dev),
                torch.sqrt(torch.tensor(var, device=dev)), seed_key(32), 0,
                150, 20)
        launch, plain, names = (launch_rwm_kernel, _run_rwm_fused_plain,
                                agreement.RWM_OUTPUTS)
        kw = dict(draw=WARP_DRAW, team=team)
    before = Counter(launch.launches)
    k = launch(*args, **kw)
    kw.pop("team")
    variant = _build.library(f"fused_{algo}", "Normal", WARP_DRAW)
    assert launch.launches - before == Counter(
        {f"{variant}.rosenbrock.w{_build.warp_bucket(d)}": 1})
    a = agreement.hold(k, plain(*args, **kw), names,
                       lp_of=target.log_density_td)
    assert a.frac >= AGREE_MIN, agreement.describe(a)
    assert not a.mismatched, agreement.describe(a)
    assert (k[2] > 0).any()


# SuperFunnel's (J, K): the thread kernels in every register bucket (J = 2,
# K = 1: d = 8; J = 3, K = 2: d = 14; the reference's J = 5, K = 3: d = 26;
# J = 10, K = 3: d = 46), the team kernels at J = 10, K = 5 (d = 68,
# .w128), J = 40, K = 3 (d = 166, .w256) and J = 100, K = 3 (d = 406,
# .w512)
SF_THREAD = ((2, 1), (3, 2), (5, 3), (10, 3))
SF_SHAPES = SF_THREAD + ((10, 5), (40, 3), (100, 3))


def _sf_cases():
    """SuperFunnel's layouts: the thread kernels at each SF_THREAD shape,
    the team kernels at every team size their library holds (a static
    table)."""
    out = []
    for algo in ("pt", "rwm"):
        out += [(algo, J, K, None) for J, K in SF_THREAD]
        for J, K in SF_SHAPES[len(SF_THREAD):]:
            d = J + J * K + K + 3
            dmax = _build.warp_bucket(d)
            out += [(algo, J, K, g) for g in _build.library_teams(
                _build.lib_name(f"fused_{algo}", "super_funnel", d))
                    if algo == "rwm" or 8 * g <= _build.pt_team_threads(
                        dmax, g)]
    return out


@pytest.mark.parametrize("algo,J,K,team", _sf_cases())
def test_super_funnel_kernels_match_plain(algo, J, K, team):
    """SuperFunnel (kind 12) held against its plain version in both
    layouts and at every team size, PT on the geometric ladder (T = 8) and
    RWM, from the default init 1e-8 N(0, 1), where most states start at
    -inf (log-ratio NaN until a proposal is valid: rejected, as in the
    plain version); the launch counted under the library's key.  Every
    shape holds the fixed-shape build the route takes (the team shapes' at
    each team size) and the run-time-shape library (``specialize=False``)
    alike, and the two give the same outputs bit for bit."""
    dev = _card()
    C = 1003
    target = get_target_distribution("SuperFunnel", 0, J=J, K=K,
                                     device=dev)
    d = target.dim
    g = torch.Generator(device=dev).manual_seed(41)
    x0 = target.init_sample(C, g).T.contiguous()
    assert torch.isinf(target.log_density_td(x0)).float().mean() > 0.5
    zi = lambda *s: torch.zeros(*s, dtype=torch.int32, device=dev)  # noqa
    zf = lambda *s: torch.zeros(*s, device=dev)  # noqa
    var = 0.01
    draw = draws.resolve_normal_impl(algo, C, "super_funnel")
    steps = 100 if team is None else 40
    if algo == "pt":
        betas = torch.tensor([0.5 ** t for t in range(7)] + [0.01],
                             device=dev)
        sig = torch.sqrt(torch.tensor(var, device=dev) / betas)
        args = (target, x0[:, None].expand(d, 8, C).contiguous(), zi(8, C),
                zi(C), zf(C), zf(C), betas, sig, seed_key(42), 0, steps, 10,
                5)
        launch, plain, names = (launch_pt_kernel, _run_pt_fused_plain,
                                agreement.PT_OUTPUTS)
    else:
        args = (target, x0, zi(C), zf(C), torch.tensor(1.0, device=dev),
                torch.sqrt(torch.tensor(var, device=dev)), seed_key(42), 0,
                steps, 10)
        launch, plain, names = (launch_rwm_kernel, _run_rwm_fused_plain,
                                agreement.RWM_OUTPUTS)
    kw = dict(draw=draw)
    p = plain(*args, **kw)
    outs = []
    for spec in (True, False):
        before = Counter(launch.launches)
        k = launch(*args, **kw, specialize=spec,
                   **({} if team is None else {"team": team}))
        lib = _build.route(_build.library(f"fused_{algo}", "Normal", draw),
                           target, specialize=spec)[0]
        assert (_build.fixed_shape(lib) is not None) == spec
        assert _build.is_warp(lib) == (team is not None)
        assert launch.launches - before == Counter(
            {_build.launch_key(lib): 1})
        a = agreement.hold(k, p, names, lp_of=target.log_density_td)
        assert a.frac >= AGREE_MIN, agreement.describe(a)
        assert not a.mismatched, agreement.describe(a)
        assert (k[2] > 0).any() and torch.isfinite(k[1]).any()
        outs.append(k)
    fixed, run_time = outs
    for name, x, y in zip(names, fixed, run_time):
        assert torch.equal(x, y), name


@pytest.mark.parametrize("team", _build.WARP_TEAMS[128])
def test_warp_lanes_accept_alike(team):
    """A state where the lanes' partial sums of lp round differently from
    one another: |x| ~ 1 in 100 coordinates (lp ~ -100, an ulp of 8e-6),
    steps of 1e-3 and beta = 1e4, so that the log-ratio's rounding moves
    it by ~0.04 and about one decision in a thousand hinges on it.  The
    butterfly sums give every lane of a team the same lp, so every
    recorded step of every chain moves all of its coordinates or none (an
    increment rounds to 0 on about 5e-5 of them): no row is torn, at every
    team size G.  The final lp is the target's at the final x, and on the
    chains whose final x agrees with the plain version's the counters are
    the plain version's."""
    dev = _card()
    d, C, S = 100, 1024, 100
    target = MultivariateNormal.create(d, device=dev)
    g = torch.Generator(device=dev).manual_seed(21)
    x0 = torch.randn(d, C, generator=g, device=dev)
    zi = lambda *s: torch.zeros(*s, dtype=torch.int32, device=dev)  # noqa
    zf = lambda *s: torch.zeros(*s, device=dev)  # noqa
    args = (target, x0, zi(C), zf(C), torch.tensor(1e4, device=dev),
            torch.tensor(1e-3, device=dev), seed_key(23), 0, S, 0)
    out = launch_rwm_kernel(*args, draw=WARP_DRAW, record_every=1,
                            record_chains=C, team=team)
    chain = out[4]                                   # (S, d, C)
    prev = torch.cat([x0[None], chain[:-1]])
    moved = (chain != prev).float().mean(1)          # (S, C)
    assert ((moved == 0) | (moved >= 0.97)).all(), moved[
        (moved > 0) & (moved < 0.97)][:10]
    assert 0 < int(out[2].sum()) < S * C
    torch.testing.assert_close(out[1], target.log_density_td(out[0]),
                               rtol=1e-5, atol=1e-4)
    a = agreement.hold(out[:4], _run_rwm_fused_plain(*args, draw=WARP_DRAW),
                       agreement.RWM_OUTPUTS, lp_of=target.log_density_td)
    assert a.frac > 0.5 and not a.mismatched, agreement.describe(a)


# ------------------------------------------------- the ladder kernel (A10)
LADDER_CASES = {"mvn_iso": ("MultivariateNormal", None, 7)}
LADDER_CASES.update({k: (n, kw, d) for k, (n, kw, d, _) in KIND_CASES.items()})


def ladder_target(kind, dev):
    name, kw, d = LADDER_CASES[kind]
    if kw == "cov":
        a = np.random.default_rng(5).normal(size=(d, d))
        kw = {"cov": a @ a.T / d + np.eye(d)}
    return get_target_distribution(name, 0 if kind == "hybrid_rosenbrock"
                                   else d, device=dev, **(kw or {}))


def _same_ladder(k, p):
    assert len(k.betas) == len(p.betas) and k.probes == p.probes
    np.testing.assert_allclose(k.betas, p.betas, rtol=1e-5)
    np.testing.assert_allclose(k.a_hats, p.a_hats, rtol=1e-4, atol=1e-7)


@pytest.mark.parametrize("N", [1, 255, 257, 3000])
@pytest.mark.parametrize("kind", sorted(LADDER_CASES))
def test_ladder_kernel_matches_plain(kind, N):
    """One launch builds the plain version's ladder: the same rungs and
    probes, the swap estimates to their ulps (the gamma kinds bit for
    bit: their rejection tests are exact on both sides), on grids sized
    below one wave (N = 1, 255, 257: one or two tiles a probe) and at the
    harness's N = 3000."""
    from rwm_pt_tpu_torch.kernels import ladder_build
    from rwm_pt_tpu_torch.ladders import ladders as L
    dev = _card()
    tg = ladder_target(kind, dev)
    kw = dict(N_samples_swap_est=N, tolerance=0.02, seed=3,
              max_pn_adjustment_steps=40)
    ladder_build.launch_ladder_kernel.launches.clear()
    k = ladder_build.launch_ladder_kernel(tg, **kw)
    assert ladder_build.launch_ladder_kernel.launches == {
        f"ladder_build.{kind}": 1}
    p = L._construct_iterative_ladder_device_plain(tg, **kw)
    _same_ladder(k, p)
    if kind in ("iid_gamma", "iid_beta"):
        np.testing.assert_array_equal(k.a_hats, p.a_hats)   # NaN == NaN
    assert L.construct_iterative_ladder_device(tg, **kw) == k.betas


@pytest.mark.parametrize("kind,d", [("mvn_iso", 100), ("mvn_iso", 200),
                                    ("mvn_iso", 300), ("mvn_iso", 1000),
                                    ("mvn_full", 7), ("mvn_iso", 7)])
def test_ladder_kernel_bucket_and_precision(kind, d):
    """The d = 100, 200, 300 and 1000 iso MVN (the rolled .d128, .d256,
    .d512 and .d1024 buckets: warp-units, a tile's partials summed by its
    last unit), the max_T cap and the bfloat16 matmul operands against the
    plain version."""
    from rwm_pt_tpu_torch.kernels import ladder_build
    from rwm_pt_tpu_torch.ladders import ladders as L
    dev = _card()
    tg = (get_target_distribution("MultivariateNormal", d, device=dev)
          if d >= 100 else ladder_target(kind, dev))
    for kw in (dict(N_samples_swap_est=3000, tolerance=0.02, seed=4),
               dict(N_samples_swap_est=3000, tolerance=0.02, seed=4,
                    max_T=4, matmul_precision="bfloat16")):
        k = ladder_build.launch_ladder_kernel(tg, **kw)
        _same_ladder(k, L._construct_iterative_ladder_device_plain(tg, **kw))
    assert len(k.betas) == 4


@pytest.mark.parametrize("kind", sorted(LADDER_CASES))
def test_ladder_kernel_rolled_bucket_matches_plain(kind):
    """Every kind in the rolled .d128 bucket (d = 72; HybridRosenbrock
    n1 = 8, n2 = 10: 71), whose coordinates loop a Philox block at a time:
    the plain version's ladder."""
    from rwm_pt_tpu_torch.kernels import ladder_build
    from rwm_pt_tpu_torch.ladders import ladders as L
    dev = _card()
    name, kw, _ = LADDER_CASES[kind]
    if kw == "cov":
        a = np.random.default_rng(5).normal(size=(72, 72))
        kw = {"cov": a @ a.T / 72 + np.eye(72)}
    if kind == "hybrid_rosenbrock":
        tg = get_target_distribution(name, 0, n1=8, n2=10, device=dev)
    else:
        tg = get_target_distribution(name, 72, device=dev, **(kw or {}))
    opts = dict(N_samples_swap_est=3000, tolerance=0.02, seed=7,
                max_pn_adjustment_steps=40)
    _same_ladder(ladder_build.launch_ladder_kernel(tg, **opts),
                 L._construct_iterative_ladder_device_plain(tg, **opts))


@pytest.mark.parametrize("d", [253, 509])
@pytest.mark.parametrize("kind", sorted(LADDER_CASES))
def test_ladder_kernel_wide_buckets_match_plain(kind, d):
    """Every kind at the least d of the wide buckets (.d512 at 253,
    .d1024 at 509; HybridRosenbrock n1 = 2: d = 1 + n2, EvenRosenbrock one
    more), the launch counted under the kind: the plain version's
    ladder."""
    from rwm_pt_tpu_torch.kernels import ladder_build
    from rwm_pt_tpu_torch.ladders import ladders as L
    dev = _card()
    name, kw, _ = LADDER_CASES[kind]
    d = d + 1 if kind == "even_rosenbrock" else d
    if kw == "cov":
        a = np.random.default_rng(5).normal(size=(d, d))
        kw = {"cov": a @ a.T / d + np.eye(d)}
    if kind == "hybrid_rosenbrock":
        tg = get_target_distribution(name, 0, n1=2, n2=d - 1, device=dev)
    else:
        tg = get_target_distribution(name, d, device=dev, **(kw or {}))
    assert _build.ladder_lib(kind, tg.dim).endswith(
        f".d{_build.warp_bucket(tg.dim)}")
    opts = dict(N_samples_swap_est=1000, tolerance=0.05, seed=9,
                max_pn_adjustment_steps=20, max_T=64)
    ladder_build.launch_ladder_kernel.launches.clear()
    k = ladder_build.launch_ladder_kernel(tg, **opts)
    assert ladder_build.launch_ladder_kernel.launches == {
        f"ladder_build.{kind}": 1}
    _same_ladder(k, L._construct_iterative_ladder_device_plain(tg, **opts))


@pytest.mark.parametrize("kind,d,N", [("three_mixture", 7, 3000),
                                      ("three_mixture", 7, 20000),
                                      ("three_mixture", 7, 32768),
                                      ("mvn_iso", 100, 3000),
                                      ("mvn_iso", 100, 20000)])
def test_ladder_kernel_repeats_bit_for_bit(kind, d, N):
    """Builds on grids of several blocks (12 tiles a probe, where every
    block sums the slots; 79 and 128, where the last block to arrive
    publishes the sum; the rolled bucket's warp-units at d = 100),
    repeated 20 times, land the same ladder and swap estimates bit for
    bit, whatever the blocks' order: a block running ahead into the next
    probe writes its tile sums into the other half of the buffer."""
    from rwm_pt_tpu_torch.kernels import ladder_build
    dev = _card()
    tg = (get_target_distribution("MultivariateNormal", d, device=dev)
          if d >= 100 else ladder_target(kind, dev))
    kw = dict(N_samples_swap_est=N, tolerance=0.005, seed=8)
    first = ladder_build.launch_ladder_kernel(tg, **kw)
    assert first.probes > 10
    for _ in range(20):
        k = ladder_build.launch_ladder_kernel(tg, **kw)
        assert (k.probes, k.betas) == (first.probes, first.betas)
        assert list(map(repr, k.a_hats)) == list(map(repr, first.a_hats))


@pytest.mark.parametrize("power,clamp,max_T", [(-0.6, (-1.5, 3.0), 33),
                                               (-0.1, (-10.0, 0.2), 1024)])
def test_ladder_kernel_takes_pn_exponent_clamp_and_room(power, clamp, max_T):
    """The pn exponent and clamp (the harness's options) and a ladder room
    of the fused kernel's rungs or of the eager engines' reach the kernel:
    the plain version's ladder, whose probes differ from the defaults'."""
    from rwm_pt_tpu_torch.kernels import ladder_build
    from rwm_pt_tpu_torch.ladders import ladders as L
    dev = _card()
    tg = ladder_target("three_mixture", dev)
    base = dict(N_samples_swap_est=3000, tolerance=0.005, seed=6,
                max_T=max_T)
    kw = dict(base, pn_update_power=power, pn_clamping_range=clamp)
    k = ladder_build.launch_ladder_kernel(tg, **kw)
    _same_ladder(k, L._construct_iterative_ladder_device_plain(tg, **kw))
    assert k.a_hats != ladder_build.launch_ladder_kernel(tg, **base).a_hats


def test_ladder_kernel_refuses_before_launching():
    from rwm_pt_tpu_torch.kernels import ladder_build
    from rwm_pt_tpu_torch.ladders import construct_iterative_ladder_device
    dev = _card()
    ladder_build.launch_ladder_kernel.launches.clear()
    for name in ("FullRosenbrock", "SuperFunnel"):
        with pytest.raises(NotImplementedError, match="direct_sample"):
            construct_iterative_ladder_device(
                get_target_distribution(name, 4, device=dev))
        with pytest.raises(NotImplementedError):
            ladder_build.launch_ladder_kernel(
                get_target_distribution(name, 4, device=dev))
    with pytest.raises(NotImplementedError, match="4092"):
        ladder_build.launch_ladder_kernel(
            get_target_distribution("MultivariateNormal", 4093, device=dev))
    assert not ladder_build.launch_ladder_kernel.launches


# ---------------------------------------------- the sharded runs (B9, A13)
SHARDED_PT = ("x", "logp", "accept_count", "swap_accept_count",
              "sum_beta_sq_jump", "sum_sq_jump_cold")


@pytest.mark.parametrize("algo,d", [("pt", 30), ("rwm", 30), ("pt", 100),
                                    ("rwm", 100)])
def test_sharded_runs_equal_unsharded_bit_for_bit(algo, d):
    """On meshes of 2 and 4 virtual shards of the card, the chains-sharded
    kernels draw the unsharded launch's words (the Philox counter's
    replica offset) and take its team size: x, lp and every counter and
    sum equal bit for bit, one launch a shard."""
    from rwm_pt_tpu_torch.kernels import (fused_pt, fused_rwm,
                                          run_pt_fused_sharded,
                                          run_rwm_fused_sharded)
    from rwm_pt_tpu_torch.parallel import make_mesh
    dev = _card()
    tg = FullRosenbrock.create(d, device=dev)
    betas = torch.logspace(0, -2, 6, device=dev)
    kw = dict(base_variance=0.25 / d, num_chains=8192, num_iterations=120,
              burn_in=20)
    if algo == "pt":
        ref = run_pt_fused(tg, 3, betas, swap_every=10, device=dev, **kw)
        fields = SHARDED_PT
    else:
        ref = run_rwm_fused(tg, 3, device=dev, **kw)
        fields = ("x", "logp", "accept_count", "sum_sq_jump")
    for k in (2, 4):
        mesh = make_mesh((k,), devices=[dev] * k)
        launch_pt_kernel.launches.clear()
        launch_rwm_kernel.launches.clear()
        res = (run_pt_fused_sharded(tg, 3, betas, mesh, swap_every=10, **kw)
               if algo == "pt" else run_rwm_fused_sharded(tg, 3, mesh, **kw))
        seen = (fused_pt.launch_pt_kernel if algo == "pt"
                else fused_rwm.launch_rwm_kernel).launches
        assert sum(seen.values()) == k
        for f in fields:
            assert torch.equal(getattr(res.state, f),
                               getattr(ref.state, f)), (k, f)


@pytest.mark.parametrize("d", [30, 100])
def test_tempsharded_hybrid_across_partitions(d):
    """The temps-sharded hybrid at T = 10 on 2, 5 and 10 virtual shards and
    a 2 x 5 chains x temps mesh: x, lp, MH and swap counts equal bit for
    bit; against the unsharded kernel's even/odd sweep the agreement gate
    holds (the cold-jump sum, MH and swap moves summed apart, left out).
    At d = 100 every segment's team launch (1 or 2 rungs) takes the team
    size the whole ladder resolves."""
    from rwm_pt_tpu_torch.kernels import run_pt_fused_tempsharded
    from rwm_pt_tpu_torch.parallel import make_mesh
    dev = _card()
    tg = FullRosenbrock.create(d, device=dev)
    betas = torch.logspace(0, -2, 10, device=dev)
    kw = dict(base_variance=0.25 / d, num_chains=4096, num_iterations=300,
              burn_in=50, swap_every=25)
    runs = [run_pt_fused_tempsharded(tg, 5, betas,
                                     make_mesh(s, n, devices=[dev] * k), **kw)
            for s, n, k in (((2,), ("temps",), 2), ((5,), ("temps",), 5),
                            ((10,), ("temps",), 10),
                            ((2, 5), ("chains", "temps"), 10))]
    for r in runs[1:]:
        for f in SHARDED_PT[:4]:
            assert torch.equal(getattr(r.state, f),
                               getattr(runs[0].state, f)), f
    eo = run_pt_fused(tg, 5, betas, swap_sweep="even_odd", device=dev, **kw)
    ag = agreement.hold(
        tuple(getattr(runs[0].state, f) for f in SHARDED_PT[:5]),
        tuple(getattr(eo.state, f) for f in SHARDED_PT[:5]),
        ("x", "lp", "acc", "swapacc", "betajump"))
    assert ag.frac >= AGREE_MIN and not ag.mismatched, agreement.describe(ag)
    assert runs[0].state.swap_attempt_count == eo.state.swap_attempt_count


# ---------------------------------------------------------- more rungs
def _cluster_case(dev, d, T, C=1003, prop="Normal", steps=60):
    """A PT launch of T rungs 1 .. 0.5 on the iso MVN at d coordinates
    from its init (``prop`` of variance 2.38^2 / d), a swap every 3
    steps: (target, args, kw)."""
    tg = MultivariateNormal.create(d, device=dev)
    g = torch.Generator(device=dev).manual_seed(41)
    var = 2.38 ** 2 / d
    pr = None if prop == "Normal" else create_proposal_distribution(
        d, {"name": "Laplace", "params": {"base_variance_vector": var}},
        device=dev)
    betas = torch.logspace(0, -0.3, T, device=dev)
    kind, sig = rung_scales(pr, var, betas, torch.ones_like(betas))
    x0 = tg.init_sample(C, g).T[:, None].expand(d, T, C).contiguous()
    zi = lambda *s: torch.zeros(*s, dtype=torch.int32, device=dev)  # noqa
    zf = lambda *s: torch.zeros(*s, device=dev)  # noqa
    return tg, (tg, x0, zi(T, C), zi(C), zf(C), zf(C), betas, sig,
                seed_key(43), 0, steps, 10, 3), dict(kind=kind,
                                                      draw=WARP_DRAW)


@pytest.mark.parametrize("sweep", ["sequential", "even_odd"])
def test_cluster_build_equals_one_block_bit_for_bit(sweep):
    """At d = 300 and T = 16, which one block of teams of 16 lanes holds,
    the cluster build forced over 2 and 3 blocks (the last one's slots
    ragged) equals the one-block build bit for bit: x, lp, the counters,
    both Kahan sums and the cold trace; its launches count under the
    ``.c512`` library."""
    dev = _card()
    tg, args, kw = _cluster_case(dev, 300, 16)
    kw.update(swap_sweep=sweep, record_every=5, record_chains=64, team=16)
    one = launch_pt_kernel(*args, **kw)
    variant = _build.library("fused_pt", "Normal", WARP_DRAW)
    for k in (2, 3):
        before = Counter(launch_pt_kernel.launches)
        out = launch_pt_kernel(*args, cluster=k, **kw)
        assert launch_pt_kernel.launches - before == Counter(
            {f"{variant}.mvn_iso.c512": 1, "fused_pt_record": 1})
        for name, a, b in zip(agreement.PT_REC_OUTPUTS, one, out):
            assert torch.equal(a, b), (k, name)
    assert (one[3] > 0).any() and (one[2] > 0).any()


@pytest.mark.parametrize("prop,sweep,team", [
    ("Normal", "sequential", None), ("Normal", "even_odd", 16),
    ("Normal", "sequential", 32), ("Laplace", "even_odd", None)])
def test_cluster_build_matches_plain_at_d1000_T50(prop, sweep, team):
    """d = 1000 and T = 50, a ladder no block holds: the geometry takes the
    cluster build (``.c1024``), here at the team size it picks and at
    each forced, under Laplace with its scales read through L2; held
    against the plain version (the agreement gate, counters exact)."""
    dev = _card()
    tg, args, kw = _cluster_case(dev, 1000, 50, C=300, prop=prop, steps=30)
    kw["swap_sweep"] = sweep
    before = Counter(launch_pt_kernel.launches)
    k = launch_pt_kernel(*args, team=team, **kw)
    seen = launch_pt_kernel.launches - before
    assert list(seen) == [f"{_build.library('fused_pt', prop, WARP_DRAW)}"
                          f".mvn_iso.c1024"], seen
    a = agreement.hold(k, _run_pt_fused_plain(*args, **kw),
                       agreement.PT_OUTPUTS, lp_of=tg.log_density_td)
    assert a.frac >= AGREE_MIN and not a.mismatched, agreement.describe(a)
    assert (k[3] > 0).any() and (k[2] > 0).any()


def test_refused_cluster_raises():
    """A cluster the card refuses (16 blocks: above the portable 8, which
    the build does not unlock) raises at the launch and counts nothing;
    nothing runs in its place."""
    dev = _card()
    _, args, kw = _cluster_case(dev, 300, 16, C=64, steps=4)
    before = Counter(launch_pt_kernel.launches)
    with pytest.raises(RuntimeError, match="kernel launch failed"):
        launch_pt_kernel(*args, cluster=16, **kw)
    assert launch_pt_kernel.launches == before
    out = launch_pt_kernel(*args, cluster=2, **kw)   # the next launch runs
    torch.cuda.synchronize()
    assert torch.isfinite(out[1]).all()


# ------------------------------------------ the widest buckets (A15, d <= 4092)
# (algo, kind, d): the 2048 and 4096 buckets' least and largest d beside
# them, the iso MVN, FullRosenbrock and the full MVN (three rows, its
# precision through L2)
WIDER_CASES = [(a, k, d) for d in (2045, 4092)
               for k in ("mvn_iso", "rosenbrock", "mvn_full")
               for a in ("pt", "rwm")]
WIDER_LADDER_D = (30, 500, 2000)


def _wider_target(kind, d, dev):
    if kind == "mvn_full":
        a = np.random.default_rng(5).normal(size=(d, d))
        return get_target_distribution("MultivariateNormal", d,
                                       cov=a @ a.T / d + np.eye(d),
                                       device=dev), 1.5 * 2.38 ** 2 / d
    if kind == "mvn_iso":
        return MultivariateNormal.create(d, device=dev), 2.38 ** 2 / d
    return FullRosenbrock.create(d, device=dev), 0.5 ** 2 / d


@pytest.mark.parametrize("algo,kind,d", WIDER_CASES)
def test_wider_buckets_match_plain(algo, kind, d):
    """Each library of the ``.w2048`` / ``.w4096`` buckets (one warp a
    state) and PT's cluster builds ``.c2048`` / ``.c4096`` at d = 2045 and
    4092, launched with the layout the geometry takes (PT at T = 10: one
    block or a cluster), held against the plain version: the agreement
    gate, counters exact; the launch counted under that library."""
    dev = _card()
    C = 64 if kind == "mvn_full" else 256
    tg, var = _wider_target(kind, d, dev)
    g = torch.Generator(device=dev).manual_seed(51)
    x0 = tg.init_sample(C, g).T.contiguous()
    zi = lambda *s: torch.zeros(*s, dtype=torch.int32, device=dev)  # noqa
    zf = lambda *s: torch.zeros(*s, device=dev)  # noqa
    if algo == "pt":
        T = 10
        betas = torch.logspace(0, -2, T, device=dev)
        sig = torch.sqrt(torch.tensor(var, device=dev) / betas)
        args = (tg, x0[:, None].expand(d, T, C).contiguous(), zi(T, C),
                zi(C), zf(C), zf(C), betas, sig, seed_key(52), 0, 20, 5, 5)
        launch, plain, names = (launch_pt_kernel, _run_pt_fused_plain,
                                agreement.PT_OUTPUTS)
    else:
        args = (tg, x0, zi(C), zf(C), torch.tensor(1.0, device=dev),
                torch.sqrt(torch.tensor(var, device=dev)), seed_key(52), 0,
                20, 5)
        launch, plain, names = (launch_rwm_kernel, _run_rwm_fused_plain,
                                agreement.RWM_OUTPUTS)
    before = Counter(launch.launches)
    k = launch(*args, draw=WARP_DRAW)
    seen = launch.launches - before
    variant = _build.library(f"fused_{algo}", "Normal", WARP_DRAW)
    bucket = _build.warp_bucket(d)
    assert len(seen) == 1 and sum(seen.values()) == 1, seen
    key = next(iter(seen))
    assert key in (f"{variant}.{kind}.w{bucket}", f"{variant}.{kind}.c"
                   f"{bucket}"), key
    a = agreement.hold(k, plain(*args, draw=WARP_DRAW), names,
                       lp_of=tg.log_density_td)
    assert a.frac >= AGREE_MIN and not a.mismatched, agreement.describe(a)
    assert (k[2] > 0).any()


@pytest.mark.parametrize("d", WIDER_LADDER_D)
def test_full_mvn_ladder_kernel_lands_plain_ladder(d):
    """The full MVN's ladder in its warp form (above the 16 bucket: a warp
    a side-sample, S and cov_inv^T in global tables) at d = 30, 500 and
    2000: the plain version's ladder (the same rungs and probes, the swap
    estimates to their ulps), one launch, no local memory."""
    from rwm_pt_tpu_torch.kernels import ladder_build
    from rwm_pt_tpu_torch.ladders import ladders as L
    dev = _card()
    tg, _ = _wider_target("mvn_full", d, dev)
    opts = dict(N_samples_swap_est=3000, tolerance=0.05, beta_min=0.3,
                seed=1, max_T=64)
    ladder_build.launch_ladder_kernel.launches.clear()
    k = ladder_build.launch_ladder_kernel(tg, **opts)
    assert ladder_build.launch_ladder_kernel.launches == {
        "ladder_build.mvn_full": 1}
    _same_ladder(k, L._construct_iterative_ladder_device_plain(tg, **opts))
    assert len(k.betas) >= 3
    info = ladder_build.info("mvn_full", d,
                             _build.kernel_target(tg)[1].numel())
    assert info["local_bytes"] == 0 and info["blocks_per_sm"] >= 1


# ------------------------------------ PT's wide teams (the 2048 and 4096 buckets)
# (kind, d, team): teams of two and four warps a state, in one block (d =
# 2000, G = 64) or over a cluster (G = 128 at d = 2000, both at d = 4000);
# the kinds that sum their lp in index order, whose results equal G = 32's
WIDE_TEAM_CASES = [(k, d, g, "Normal") for k, d, teams in (
    ("mvn_iso", 2000, (64,)), ("rosenbrock", 2000, (64,)),
    ("iid_gamma", 2000, (64,)), ("hypercube", 2000, (64,)),
    ("mvn_iso", 4000, (64, 128)), ("iid_beta", 4000, (64, 128)))
    for g in teams] + [("iid_gamma", 2000, 64, "UniformRadius"),
                       ("iid_gamma", 4000, 128, "UniformRadius")]
INDEX_ORDER_KINDS = ("iid_gamma", "iid_beta", "neal_funnel")
WIDE_TEAM_NAMES = {"mvn_iso": "MultivariateNormal",
                   "rosenbrock": "FullRosenbrock", "iid_gamma": "IIDGamma",
                   "iid_beta": "IIDBeta", "neal_funnel": "NealFunnel",
                   "hypercube": "Hypercube"}


def _wide_team_case(kind, d, dev, C=96, steps=16, prop="Normal"):
    """A PT launch of T = 10 rungs 1 .. 0.5 on ``kind`` at d from its
    init (close enough that swaps are taken), a swap every 4 steps after 4
    of burn-in: (target, args, kw)."""
    tg = get_target_distribution(WIDE_TEAM_NAMES[kind], d, device=dev)
    var = {"mvn_iso": 2.38 ** 2, "rosenbrock": 0.25}.get(kind, 0.1) / d
    pr = None if prop == "Normal" else create_proposal_distribution(
        d, {"name": prop, "params": (
            {"base_radius": float(np.sqrt(var * d))}
            if prop == "UniformRadius" else {"base_variance_vector": var})},
        device=dev)
    g = torch.Generator(device=dev).manual_seed(71)
    betas = torch.logspace(0, -0.3, 10, device=dev)
    k, sig = rung_scales(pr, var, betas, torch.ones_like(betas))
    x0 = tg.init_sample(C, g).T[:, None].expand(d, 10, C).contiguous()
    zi = lambda *s: torch.zeros(*s, dtype=torch.int32, device=dev)  # noqa
    zf = lambda *s: torch.zeros(*s, device=dev)  # noqa
    return tg, (tg, x0, zi(10, C), zi(C), zf(C), zf(C), betas, sig,
                seed_key(72), 0, steps, 4, 4), dict(kind=k, draw=WARP_DRAW)


@pytest.mark.parametrize("kind,d,team,prop", WIDE_TEAM_CASES)
def test_wide_teams_match_plain(kind, d, team, prop):
    """Each wide team size (G = 64, 128: a state over two or four warps,
    named barriers, the warps' partials in the team's words) held against
    the plain version (the agreement gate, counters exact), launched once
    under the bucket's library (one block) or its cluster build, and
    again bit for bit (no race between a team's warps)."""
    dev = _card()
    tg, args, kw = _wide_team_case(kind, d, dev, prop=prop)
    before = Counter(launch_pt_kernel.launches)
    k = launch_pt_kernel(*args, team=team, **kw)
    seen = launch_pt_kernel.launches - before
    variant = _build.library("fused_pt", prop, WARP_DRAW)
    bucket = _build.warp_bucket(d)
    assert len(seen) == 1 and next(iter(seen)) in (
        f"{variant}.{kind}.w{bucket}", f"{variant}.{kind}.c{bucket}"), seen
    again = launch_pt_kernel(*args, team=team, **kw)
    for name, a, b in zip(agreement.PT_OUTPUTS, k, again):
        assert torch.equal(a, b), name
    a = agreement.hold(k, _run_pt_fused_plain(*args, **kw),
                       agreement.PT_OUTPUTS, lp_of=tg.log_density_td)
    assert a.frac >= AGREE_MIN and not a.mismatched, agreement.describe(a)
    assert (k[2] > 0).any() and (k[3] > 0).any()


@pytest.mark.parametrize("prop", ["Normal", "Laplace"])
@pytest.mark.parametrize("team,d", [(64, 2000), (128, 4000)])
@pytest.mark.parametrize("kind", INDEX_ORDER_KINDS)
def test_wide_teams_equal_g32_on_index_order_kinds(kind, team, d, prop):
    """IIDGamma, IIDBeta and NealFunnel sum their log-density in index order
    at every team size, and a wide team sums its cold-rung jump in G = 32's
    order: at G = 64 (d = 2000, one block) and 128 (d = 4000, a cluster;
    the 2048 bucket holds no G = 128) x, lp, the counters
    and both Kahan sums equal G = 32's bit for bit under the Normal and
    Laplace proposals (UniformRadius's norm is a butterfly sum at every
    team size, so it rounds by G as G = 4 and 32 do)."""
    dev = _card()
    tg, args, kw = _wide_team_case(kind, d, dev, C=64, prop=prop)
    ref = launch_pt_kernel(*args, team=32, **kw)
    out = launch_pt_kernel(*args, team=team, **kw)
    for name, a, b in zip(agreement.PT_OUTPUTS, ref, out):
        assert torch.equal(a, b), name
    assert (ref[2] > 0).any()


# ----------------------------------- RWM's wide teams (the 2048 and 4096 buckets)
# (kind, d, team, proposal): chains over two and four warps, blocks of
# several teams and a ragged edge (301 chains: 151 blocks of two); the
# three-row kinds' terms row in the pool's global rows
RWM_WIDE_TEAM_CASES = [(k, d, g, "Normal") for k, d, teams in (
    ("mvn_iso", 2000, (64,)), ("rosenbrock", 2000, (64,)),
    ("iid_gamma", 2000, (64,)), ("hypercube", 2000, (64,)),
    ("neal_funnel", 2000, (64,)), ("mvn_iso", 4000, (64, 128)),
    ("iid_beta", 4000, (64, 128))) for g in teams] + [
        ("iid_gamma", 2000, 64, "UniformRadius"),
        ("iid_gamma", 4000, 128, "UniformRadius"),
        ("mvn_iso", 2000, 64, "Laplace")]


def _rwm_wide_team_case(kind, d, dev, C=301, steps=16, prop="Normal"):
    """An RWM launch on ``kind`` at d from its init, 4 steps of burn-in:
    (target, args, kw)."""
    tg = get_target_distribution(WIDE_TEAM_NAMES[kind], d, device=dev)
    var = {"mvn_iso": 2.38 ** 2, "rosenbrock": 0.25}.get(kind, 0.1) / d
    pr = None if prop == "Normal" else create_proposal_distribution(
        d, {"name": prop, "params": (
            {"base_radius": float(np.sqrt(var * d))}
            if prop == "UniformRadius" else {"base_variance_vector": var})},
        device=dev)
    g = torch.Generator(device=dev).manual_seed(73)
    beta = torch.tensor(1.0, device=dev)
    k, scale = proposal_scale(pr, var, beta)
    x0 = tg.init_sample(C, g).T.contiguous()
    zi = torch.zeros(C, dtype=torch.int32, device=dev)
    return tg, (tg, x0, zi, torch.zeros(C, device=dev), beta, scale,
                seed_key(74), 0, steps, 4), dict(kind=k, draw=WARP_DRAW)


@pytest.mark.parametrize("kind,d,team,prop", RWM_WIDE_TEAM_CASES)
def test_rwm_wide_teams_match_plain(kind, d, team, prop):
    """Each of RWM's wide team sizes (G = 64, 128: a chain over two or four
    warps, named barriers, the first warp's jump in G = 32's order) held
    against the plain version (the agreement gate, counters exact),
    launched under the bucket's library, and again bit for bit (no race
    between a team's warps, nor in the terms pool's slots)."""
    dev = _card()
    tg, args, kw = _rwm_wide_team_case(kind, d, dev, prop=prop)
    before = Counter(launch_rwm_kernel.launches)
    k = launch_rwm_kernel(*args, team=team, **kw)
    seen = launch_rwm_kernel.launches - before
    variant = _build.library("fused_rwm", prop, WARP_DRAW)
    assert dict(seen) == {
        f"{variant}.{kind}.w{_build.warp_bucket(d)}": 1}, seen
    again = launch_rwm_kernel(*args, team=team, **kw)
    for name, a, b in zip(agreement.RWM_OUTPUTS, k, again):
        assert torch.equal(a, b), name
    a = agreement.hold(k, _run_rwm_fused_plain(*args, **kw),
                       agreement.RWM_OUTPUTS, lp_of=tg.log_density_td)
    assert a.frac >= AGREE_MIN and not a.mismatched, agreement.describe(a)
    assert (k[2] > 0).any()


@pytest.mark.parametrize("prop", ["Normal", "Laplace"])
@pytest.mark.parametrize("team,d", [(64, 2000), (128, 4000)])
@pytest.mark.parametrize("kind", INDEX_ORDER_KINDS)
def test_rwm_wide_teams_equal_g32_on_index_order_kinds(kind, team, d, prop):
    """IIDGamma, IIDBeta and NealFunnel sum their log-density in index
    order at every team size, and a wide team sums its squared jump in
    G = 32's order: x, lp, the counter and the Kahan ESJD equal G = 32's
    bit for bit at G = 64 (d = 2000) and 128 (d = 4000) under the Normal
    and Laplace proposals."""
    dev = _card()
    tg, args, kw = _rwm_wide_team_case(kind, d, dev, C=200, prop=prop)
    ref = launch_rwm_kernel(*args, team=32, **kw)
    out = launch_rwm_kernel(*args, team=team, **kw)
    for name, a, b in zip(agreement.RWM_OUTPUTS, ref, out):
        assert torch.equal(a, b), name
    assert (ref[2] > 0).any()


def test_rwm_wide_team_geometry():
    """RWM's geometry takes G = 64 at d = 2000 and G = 128 at 4000 for
    65,536 chains (13 and 6 chains a block, one block an SM: 26 and 24
    warps) and for the study CLI's 1024, and one warp a chain for IIDGamma
    (14 chains a block, its terms row in L2); the card's occupancy agrees
    with the count."""
    dev = _card()
    tg = get_target_distribution("IIDGamma", 2000, device=dev)
    lib = _build.lib_name(_build.library("fused_rwm", "Normal", WARP_DRAW),
                          "iid_gamma", 2000)
    geo = _build.launch_geometry(lib, 2000, 65536, 0, "Normal", WARP_DRAW,
                                 _build.kernel_target(tg)[1].numel())
    assert (geo.team, geo.replicas) == (32, 14), geo
    for d, team in ((2000, 64), (4000, 128)):
        tg = get_target_distribution("MultivariateNormal", d, device=dev)
        lib = _build.lib_name(_build.library("fused_rwm", "Normal",
                                             WARP_DRAW), "mvn_iso", d)
        n = _build.kernel_target(tg)[1].numel()
        for C in (65536, 1024):
            geo = _build.launch_geometry(lib, d, C, 0, "Normal", WARP_DRAW,
                                         n)
            assert geo.team == team, geo
            info = _build.kernel_info(lib, d, 1, geo.replicas, n, team=team)
            assert info["blocks_per_sm"] == geo.blocks_per_sm >= 1
            assert info["local_bytes"] == 0
            if C == 65536:
                assert geo.replicas == (13 if d == 2000 else 6)
                assert _build.resident_warps(geo) >= _build.MIN_TEAM_WARPS


def test_wide_team_geometry_and_the_cluster_split():
    """The geometry takes G = 64 in one block at d = 2000, T = 10 and
    G = 128 over clusters of two blocks at d = 4000 (65,536 replicas);
    the measuring build's split of a swap step at d = 1000, T = 50 has
    every part and sums to a positive step."""
    from rwm_pt_tpu_torch.kernels import fused_pt
    dev = _card()
    for d, team, cluster in ((2000, 64, 0), (4000, 128, 2)):
        tg = get_target_distribution("MultivariateNormal", d, device=dev)
        lib = _build.lib_name(_build.library("fused_pt", "Normal",
                                             WARP_DRAW), "mvn_iso", d)
        geo = _build.launch_geometry(lib, d, 65536, 10, "Normal", WARP_DRAW,
                                     _build.kernel_target(tg)[1].numel())
        assert (geo.team, geo.cluster) == (team, cluster), geo
        assert _build.resident_warps(geo) >= _build.MIN_TEAM_WARPS
    _, args, kw = _cluster_case(dev, 1000, 50, C=2048, steps=30)
    split = fused_pt.swap_split(*args, **kw)
    assert split["swap_steps"] > 0 and split["steps"] > 0
    assert all(split[k] >= 0 for k in fused_pt.SWAP_SPLIT)
    assert split["swap_step"] > 0 and split["cluster"] >= 2
