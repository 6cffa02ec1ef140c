"""The iterative ladder of the port's callers (``MCMCSimulation``,
``experiment_pt``): the device builder with room for the rungs the run
takes, so the host loop's uncapped ladder; ``check_room`` raising where
the search needs more; the pn exponent and clamp passed through to the
builder, held exactly against JAX's host loop on a deterministic swap
rate; and a float64 target estimated as its float32 copy."""
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from flax import struct

from rwm_pt_tpu.ladders.ladders import \
    construct_iterative_ladder as jhost
from rwm_pt_tpu_torch.api import MCMCSimulation
from rwm_pt_tpu_torch.ladders import (construct_iterative_ladder,
                                      construct_iterative_ladder_device)
from rwm_pt_tpu_torch.ladders import ladders as L
from rwm_pt_tpu_torch.targets import get_target_distribution as tget
from rwm_pt_tpu_torch.utils import set_x64

torch.set_num_threads(1)
CPU = "cpu"


# a deterministic swap rate, as in test_torch_ladder_device.py: a_hat =
# exp(-k (beta - beta*) log(beta / beta*)) whatever the draws
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


STUB = dict(target_swap_acceptance_rate=0.5, tolerance=1e-3,
            max_pn_adjustment_steps=200, N_samples_swap_est=8)


@pytest.mark.parametrize("room", [0, 1, 5])
def test_check_room_takes_the_uncapped_ladder_or_raises(room):
    """With room for the uncapped ladder's M rungs (more than JAX's
    default 24, or more) the capped device builder lands that ladder and
    ``check_room`` returns it; with room for M - 1 it raises."""
    full = construct_iterative_ladder(TStub(300.0), **STUB)
    m = len(full)
    assert m > 24
    rungs = m + room
    got = L.check_room(construct_iterative_ladder_device(
        TStub(300.0), max_T=rungs + 1, **STUB), rungs)
    assert got == full
    with pytest.raises(NotImplementedError, match=f"more than {m - 1}"):
        L.check_room(construct_iterative_ladder_device(
            TStub(300.0), max_T=m, **STUB), m - 1)


@pytest.mark.parametrize("power,clamp", [(-0.6, (-1.5, 3.0)),
                                         (-0.1, (-10.0, 0.2)),
                                         (-0.25, (-10.0, 10.0))])
def test_pn_exponent_and_clamp_match_jax_host_loop(power, clamp):
    """The builders take the host loop's pn exponent and clamp: on the
    deterministic swap rate both port builders land JAX's host ladder."""
    kw = dict(STUB, pn_update_power=power, pn_clamping_range=clamp)
    j = jhost(JStub(6.0), **kw)
    host = construct_iterative_ladder(TStub(6.0), **kw)
    dev = L._construct_iterative_ladder_device_plain(TStub(6.0), max_T=64,
                                                     **kw)
    assert len(host) == len(j) == len(dev.betas)
    np.testing.assert_allclose(host, j, rtol=1e-5)
    assert dev.betas == host


def _mvn_sim(**kw):
    return MCMCSimulation(
        dim=10, sigma=0.5, num_iterations=10, algorithm="PT",
        target_dist=tget("MultivariateNormal", 10, device=CPU),
        num_chains=4, seed=1, iterative_temp_spacing=True,
        swap_acceptance_rate=0.75, beta_min_iterative=1e-3,
        N_samples_swap_est=600, iterative_tolerance=0.03, device=CPU, **kw)


def test_harness_ladder_is_not_cut_at_24_rungs():
    """A ladder of more than 24 rungs (28 here), within the fused kernel's
    32: the harness's is the host loop's, where JAX's default ``max_T``
    would have cut it."""
    host = construct_iterative_ladder(
        tget("MultivariateNormal", 10, device=CPU),
        target_swap_acceptance_rate=0.75, beta_min=1e-3,
        N_samples_swap_est=600, tolerance=0.03, seed=1)
    assert 24 < len(host) <= 32
    sim = _mvn_sim(engine="pallas")
    assert sim.beta_ladder == host
    capped = construct_iterative_ladder_device(
        tget("MultivariateNormal", 10, device=CPU),
        target_swap_acceptance_rate=0.75, beta_min=1e-3,
        N_samples_swap_est=600, tolerance=0.03, seed=1)
    assert len(capped) == 24 and capped[:23] == host[:23]


def test_harness_pn_options_reach_the_device_builder():
    """``iterative_pn_update_power`` and the pn clamp reach the device
    builder (no host-loop branch): the harness's ladder is the host
    loop's under the same options, and differs from the default one."""
    tg = tget("ThreeMixture", 3, device=CPU)
    opts = dict(N_samples_swap_est=500, tolerance=0.02, seed=4)
    sim = MCMCSimulation(
        dim=3, sigma=0.5, num_iterations=10, algorithm="PT", target_dist=tg,
        num_chains=4, seed=4, iterative_temp_spacing=True,
        N_samples_swap_est=500, iterative_tolerance=0.02,
        iterative_pn_update_power=-0.7, iterative_pn_clamp_min=-1.0,
        iterative_pn_clamp_max=1.0, device=CPU)
    host = construct_iterative_ladder(tg, pn_update_power=-0.7,
                                      pn_clamping_range=(-1.0, 1.0), **opts)
    assert sim.beta_ladder == host
    assert host != construct_iterative_ladder(tg, **opts)


def test_float64_target_builds_its_float32_ladder():
    """Under x64 the full-covariance MVN (a matmul in its sampler) builds
    its ladder, as the float32 copy the kernel computes with."""
    cov = np.array([[2.0, 0.5, 0.0], [0.5, 1.0, 0.2], [0.0, 0.2, 1.0]])
    opts = dict(N_samples_swap_est=500, tolerance=0.03, seed=2)
    a = construct_iterative_ladder_device(
        tget("MultivariateNormal", 3, device=CPU, cov=cov), **opts)
    set_x64(True)
    try:
        tg = tget("MultivariateNormal", 3, device=CPU, cov=cov)
        assert tg.dtype == torch.float64
        b = construct_iterative_ladder_device(tg, **opts)
        x = tg.direct_sample(50, 0.5, torch.Generator().manual_seed(1))
    finally:
        set_x64(False)
    assert len(a) == len(b)
    np.testing.assert_allclose(a, b, rtol=1e-4)
    assert x.dtype == torch.float64 and x.shape == (50, 3)


@pytest.mark.parametrize("engine", ["pallas", "auto"])
def test_harness_ladder_beyond_the_fused_kernel(engine, monkeypatch):
    """A ladder that needs more than the fused kernel's rungs (42 here,
    against a fit set to 32: the real fit at d = 10, 256, takes a ladder
    whose search costs minutes on the CPU): ``engine='pallas'`` raises,
    naming the fit's layout, the search stopped at its room; ``'auto'``
    takes the host loop's whole ladder, for the eager engine."""
    from rwm_pt_tpu_torch.kernels import _build
    monkeypatch.setattr(_build, "target_rungs_fit",
                        lambda *a: _build.RungsFit(32, "a fit of 32"))
    tg = tget("MultivariateNormal", 10, device=CPU)
    kw = dict(dim=10, sigma=0.5, num_iterations=10, algorithm="PT",
              target_dist=tg, num_chains=4, seed=1,
              iterative_temp_spacing=True, swap_acceptance_rate=0.8,
              beta_min_iterative=1e-4, N_samples_swap_est=300,
              iterative_tolerance=0.05, device=CPU, engine=engine)
    if engine == "pallas":
        with pytest.raises(NotImplementedError,
                           match=r"more than 32 rungs.*\(a fit of 32\)"):
            MCMCSimulation(**kw)
        return
    host = construct_iterative_ladder(
        tg, target_swap_acceptance_rate=0.8, beta_min=1e-4,
        N_samples_swap_est=300, tolerance=0.05, seed=1)
    sim = MCMCSimulation(**kw)
    assert len(host) > 32 and sim.beta_ladder == host
    assert "at most 32 rungs" in sim._fused_refusal()
