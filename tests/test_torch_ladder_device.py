"""The one-program iterative ladder builder
(``rwm_pt_tpu_torch.ladders.construct_iterative_ladder_device``, ROADMAP
A10) on the CPU, where it runs its plain version: its decisions held
exactly against JAX's ``construct_iterative_ladder_device`` with a
deterministic swap rate (the ``max_T`` cap, the rescue, the stop below
beta_min), the host builder's ladder on the shared Philox stream for every
target with a direct sampler, and the refusals (JAX's ladder within
Monte-Carlo error: ``test_torch_ladder_device_parity.py``).  The kernel itself is held on the card
(``test_torch_cuda.py``, ``chip_smoke.py`` phase 18)."""
import math

import jax.numpy as jnp
import numpy as np
import pytest
import torch
from flax import struct

from rwm_pt_tpu.ladders.ladders import \
    construct_iterative_ladder_device as jdevice
from rwm_pt_tpu.targets import get_target_distribution as jget
from rwm_pt_tpu_torch.kernels import draws
from rwm_pt_tpu_torch.kernels.ladder_build import (LADDER_KINDS,
                                                   ladder_kind,
                                                   sampler_params)
from rwm_pt_tpu_torch.ladders import (construct_iterative_ladder,
                                      construct_iterative_ladder_device)
from rwm_pt_tpu_torch.ladders import ladders as L
from rwm_pt_tpu_torch.targets import get_target_distribution as tget

torch.set_num_threads(1)
CPU = "cpu"


# ---- a deterministic swap rate: every sample of a side is the row (k log
# beta), the log-density its coordinate, so a_hat = exp(-k (beta - beta*)
# log(beta / beta*)) whatever the draws
@struct.dataclass
class JStub:
    k: float = struct.field(pytree_node=False, default=1.0)

    def direct_sample(self, key, n, beta=1.0):
        b = jnp.asarray(beta, jnp.float32)
        return jnp.full((n, 1), self.k * jnp.log(b), jnp.float32)

    def log_density(self, x):
        return x[..., 0]


class TStub:
    def __init__(self, k):
        self.k = k
        self.device = torch.device(CPU)

    def stream_sample(self, stream, n, beta, matmul_precision="float32"):
        return torch.full((n, 1), self.k) * torch.log(beta).expand(n, 1)

    def log_density(self, x):
        return x[..., 0]


@pytest.mark.parametrize("k,kw", [
    (4.0, dict(target_swap_acceptance_rate=0.3, tolerance=1e-3,
               max_pn_adjustment_steps=200)),
    (30.0, dict(target_swap_acceptance_rate=0.234, tolerance=1e-3,
                max_pn_adjustment_steps=200, max_T=5)),
    (6.0, dict(target_swap_acceptance_rate=0.3, tolerance=1e-9,
               max_pn_adjustment_steps=6,
               convergence_failure_tolerance_factor=1e9)),
    (1e-4, dict(target_swap_acceptance_rate=0.234, tolerance=1e-6,
                max_pn_adjustment_steps=50)),
    (6.0, dict(target_swap_acceptance_rate=0.3, tolerance=1e-9,
               max_pn_adjustment_steps=6,
               convergence_failure_tolerance_factor=1.0)),
], ids=["found", "max_T", "rescue", "stop_below_beta_min", "no_rescue"])
def test_decisions_equal_jax(k, kw):
    """One deterministic a_hat in both packages: the same rungs (JAX runs
    the recurrence in float32, the port in float64, as its kernel does)."""
    j = jdevice(JStub(k), N_samples_swap_est=8, **kw)
    p = L._construct_iterative_ladder_device_plain(
        TStub(k), N_samples_swap_est=8, **kw)
    assert len(p.betas) == len(j)
    np.testing.assert_allclose(p.betas, j, rtol=1e-5)
    assert p.betas == construct_iterative_ladder_device(
        TStub(k), N_samples_swap_est=8, **kw)
    if "max_T" in kw:
        assert len(j) == kw["max_T"] and j[-1] == pytest.approx(0.01)
    if kw.get("convergence_failure_tolerance_factor") == 1e9:
        # every rung rescued after its 6 probes
        assert p.probes == 6 * (len(p.betas) - 2) and len(p.betas) > 3
    if k == 1e-4:
        # a_hat ~ 1 drives beta* under beta_min: no rung, no rescue
        assert p.betas == [1.0, 0.01]
    if kw.get("convergence_failure_tolerance_factor") == 1.0:
        assert p.betas == [1.0, 0.01] and p.probes == 6


# every registry target with a direct sampler: one per kernel kind
KINDS = {"mvn_iso": ("MultivariateNormal", 5, {}),
         "mvn_full": ("MultivariateNormal", 4,
                      dict(cov=np.array([[2.0, .5, 0, 0], [.5, 1, .2, 0],
                                         [0, .2, 1, .3], [0, 0, .3, .5]]))),
         "scaled_mvn": ("MultivariateNormalScaled", 6, {}),
         "three_mixture": ("ThreeMixtureScaled", 10, {}),
         "rough_carpet": ("RoughCarpetScaled", 4, {}),
         "even_rosenbrock": ("EvenRosenbrock", 6, {}),
         "hybrid_rosenbrock": ("HybridRosenbrock", 0, dict(n1=3, n2=3)),
         "hypercube": ("Hypercube", 3, {}),
         "iid_gamma": ("IIDGamma", 3, {}),
         "iid_beta": ("IIDBeta", 2, {}),
         "neal_funnel": ("NealFunnel", 4, {})}


def test_every_kind_with_a_sampler_is_listed():
    assert sorted(KINDS) == sorted(LADDER_KINDS)


@pytest.mark.parametrize("kind", sorted(KINDS))
def test_plain_device_builder_equals_host_builder(kind):
    """One seed, one probe stream: the host loop and the plain device
    builder take the same decisions and land the same ladder."""
    name, d, kw = KINDS[kind]
    tg = tget(name, d, device=CPU, **kw)
    assert ladder_kind(tg) == kind
    assert sampler_params(kind, tg).dtype == torch.float32
    opts = dict(N_samples_swap_est=400, tolerance=0.02,
                max_pn_adjustment_steps=25, seed=5)
    host = construct_iterative_ladder(tg, **opts)
    dev = L._construct_iterative_ladder_device_plain(tg, **opts)
    assert len(dev.betas) == len(host)
    np.testing.assert_allclose(dev.betas, host, rtol=1e-5)
    assert dev.betas[0] == 1.0 and dev.betas[-1] == 0.01
    assert dev.probes == len(dev.a_hats) >= len(host) - 2


@pytest.mark.parametrize("name", ["FullRosenbrock", "SuperFunnel"])
def test_targets_without_a_sampler_raise(name):
    for build in (construct_iterative_ladder_device,
                  construct_iterative_ladder):
        with pytest.raises(NotImplementedError, match="direct_sample"):
            build(tget(name, 4, device=CPU))
    with pytest.raises(NotImplementedError):
        ladder_kind(tget(name, 4, device=CPU))
    with pytest.raises(NotImplementedError, match="direct_sample"):
        jdevice(jget("FullRosenbrock", 4))


def test_partition_sum_is_the_kernels_order():
    """Tiles of 256 summed by the halving tree, tile r 256 + t added in
    order into slot t, the slots by the tree: a float64 sum."""
    rng = np.random.default_rng(0)
    for n in (1, 255, 256, 257, 70000):
        v = torch.from_numpy(rng.random(n).astype(np.float32))
        s = float(L.partition_sum(v))
        assert s == pytest.approx(float(v.double().sum()), rel=1e-12)
    v = torch.zeros(256 * 256 + 256, dtype=torch.float64)
    v[256 * 256] = 1.0          # tile 256: row 1, slot 0
    v[3] = 2.0
    assert float(L.partition_sum(v)) == 3.0


def test_probe_counters_carry_the_ladder_tag():
    """A probe's counters have the tag in the word where a fused run keeps
    its rung (< 32), so no probe word is a fused run's; the words are
    Philox of (block, sample, tag | side << 20, probe)."""
    key = draws.seed_key(9)
    w = draws.ladder_words(key, 3, 1, 5, 7, CPU)
    assert w.shape == (5, 7)
    blk = draws.philox4x32(torch.tensor(1), torch.tensor(4),
                           torch.tensor(draws.LADDER_TAG | 1 << 20),
                           torch.tensor(3), *key)
    assert [int(b) for b in blk[:3]] == [int(x) for x in w[4, 4:7]]
    fused = draws.slot_words(key, 3, 2, 8, 5, CPU)
    assert not set(fused.flatten().tolist()) & set(w.flatten().tolist())


def test_gamma_stream_draws_the_gamma_law():
    """Marsaglia-Tsang on the stream: mean and variance of Gamma(a) for a
    shape above and below 1 (the boost), NaN for a NaN shape."""
    for a in (2.0, 0.3):
        g = draws.ladder_gamma(draws.seed_key(1), 1, 0, 0,
                               torch.tensor(a), 20000, 2, CPU)
        assert float(g.mean()) == pytest.approx(a, rel=0.03)
        assert float(g.var()) == pytest.approx(a, rel=0.08)
    g = draws.ladder_gamma(draws.seed_key(1), 1, 0, 0,
                           torch.tensor(math.nan), 3, 2, CPU)
    assert torch.isnan(g).all()


def test_bfloat16_operands_change_the_full_mvn_only_slightly():
    """``matmul_precision='bfloat16'`` rounds the MVN's product operands:
    the plain builder still builds a ladder of the same length."""
    tg = tget("MultivariateNormal", 4, device=CPU, cov=KINDS["mvn_full"][2][
        "cov"])
    opts = dict(N_samples_swap_est=2000, tolerance=0.02, seed=2)
    a = construct_iterative_ladder_device(tg, **opts)
    b = construct_iterative_ladder_device(tg, matmul_precision="bfloat16",
                                          **opts)
    assert len(a) == len(b) and a != b
    np.testing.assert_allclose(a, b, rtol=0.05)
    with pytest.raises(ValueError, match="matmul_precision"):
        construct_iterative_ladder_device(tg, matmul_precision="tf32")
