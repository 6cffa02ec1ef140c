"""The port's mesh (``rwm_pt_tpu_torch.parallel``) and sharded fused runs
(``rwm_pt_tpu_torch.kernels.fused_sharded``) against the JAX package's
(``rwm_pt_tpu.parallel``, ``rwm_pt_tpu.kernels.pallas_sharded``), on meshes
of virtual CPU shards (the port: ``make_mesh(devices=[cpu] * k)``; JAX: the
suite's 8 virtual CPU devices).

The port's Philox counter carries the whole run's replica and rung, so a
sharded run draws what the unsharded run draws: the chains-sharded plain
runs equal the unsharded ones bit for bit at every partition, and the
temps-sharded hybrid equals itself across partitions (and the unsharded
``even_odd`` run in x, lp and the counters) with its MH phase live.  Its
swap event is held against JAX's ``_tempsharded_swap_event`` under
``shard_map`` on JAX's own uniforms."""
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from jax.sharding import Mesh as JMesh
from jax.sharding import PartitionSpec as P

from _torch_port_helpers import rate_z
from rwm_pt_tpu.kernels import PTState as JPTState
from rwm_pt_tpu.kernels import run_pt as jrun_pt
from rwm_pt_tpu.kernels.pallas_sharded import \
    _tempsharded_swap_event as jevent
from rwm_pt_tpu.parallel import chain_sharding as jchain_sharding
from rwm_pt_tpu.parallel import make_mesh as jmake_mesh
from rwm_pt_tpu.parallel import pooled_mean as jpooled_mean
from rwm_pt_tpu.parallel import pt_sharding as jpt_sharding
from rwm_pt_tpu.parallel import shard_init_states as jshard_init_states
from rwm_pt_tpu.proposals import NormalProposal as JNormalProposal
from rwm_pt_tpu.targets import MultivariateNormal as JMVN
from rwm_pt_tpu_torch.convert import pt_state_from_numpy
from rwm_pt_tpu_torch.kernels import (draws, fused_sharded, run_pt_fused,
                                      run_pt_fused_sharded,
                                      run_pt_fused_tempsharded, run_rwm_fused,
                                      run_rwm_fused_sharded)
from rwm_pt_tpu_torch.parallel import (ShardedTensor, chain_sharding,
                                       make_mesh, pooled_mean, pt_sharding,
                                       shard_init_states)
from rwm_pt_tpu_torch.targets import FullRosenbrock, MultivariateNormal

torch.set_num_threads(1)
CPU = torch.device("cpu")
PT_STATE = ("x", "logp", "accept_count", "swap_accept_count",
            "sum_beta_sq_jump", "sum_sq_jump_cold")
RWM_STATE = ("x", "logp", "accept_count", "sum_sq_jump")


def cpu_mesh(sizes, names=("chains",)):
    return make_mesh(sizes, names, devices=[CPU] * int(np.prod(sizes)))


def assert_equal(a, b, fields):
    for f in fields:
        assert torch.equal(getattr(a, f), getattr(b, f)), f


# ------------------------------------------------------------ mesh helpers
def test_mesh_helpers_match_jax():
    """JAX's ``test_mesh_helpers`` / ``test_sharding_spec_helpers``: the same
    shapes, axis names, specs and ValueError; the port's default mesh
    covers the cards and raises without one."""
    jmesh, mesh = jmake_mesh(), cpu_mesh((8,))
    assert mesh.devices.size == jmesh.devices.size == 8
    assert mesh.axis_names == tuple(jmesh.axis_names)
    assert mesh.shape == dict(jmesh.shape)
    jmesh2 = jmake_mesh((4, 2), ("chains", "temps"))
    mesh2 = cpu_mesh((4, 2), ("chains", "temps"))
    assert mesh2.axis_names == tuple(jmesh2.axis_names)
    assert mesh2.shape == dict(jmesh2.shape)
    assert mesh2.devices.shape == jmesh2.devices.shape
    for m, jm in ((mesh, jmesh), (mesh2, jmesh2)):
        for nd in (1, 2, 3):
            assert pt_sharding(m, nd).spec == tuple(jpt_sharding(jm, nd).spec)
            assert (chain_sharding(m, nd).spec
                    == tuple(jchain_sharding(jm, nd).spec))
    with pytest.raises(ValueError) as je:
        jmake_mesh((3, 2), ("chains", "temps"))
    with pytest.raises(ValueError) as te:
        make_mesh((3, 2), ("chains", "temps"), devices=[CPU] * 8)
    assert str(te.value) == str(je.value)
    with pytest.raises(RuntimeError, match="is_available"):
        make_mesh()


@pytest.mark.parametrize("pt,sizes,names", [
    (False, (8,), ("chains",)), (True, (8,), ("chains",)),
    (True, (4, 2), ("chains", "temps")), (False, (4, 2), ("chains", "temps"))])
def test_shard_init_states_match_jax(pt, sizes, names):
    """Each mesh device holds the piece JAX's ``shard_init_states`` puts
    there; the pieces gather back to the tensor, and the pooled mean is
    JAX's."""
    rng = np.random.default_rng(3)
    x = rng.standard_normal((3, 4, 64) if pt else (3, 64)).astype(np.float32)
    jm = jmake_mesh(sizes, names)
    jx = jshard_init_states(jnp.asarray(x), jm, pt=pt)
    sx = shard_init_states(torch.from_numpy(x), cpu_mesh(sizes, names), pt=pt)
    assert sx.sharding.spec == tuple(jx.sharding.spec)
    flat = list(jm.devices.flat)
    for shard in jx.addressable_shards:
        pos = np.unravel_index(flat.index(shard.device), jm.devices.shape)
        np.testing.assert_array_equal(sx.pieces[pos].numpy(),
                                      np.asarray(shard.data))
    assert torch.equal(sx.gather(), torch.from_numpy(x))
    assert float(pooled_mean(sx)) == pytest.approx(float(jpooled_mean(jx)),
                                                   rel=1e-6)


# ------------------------------------------- the counter offsets (draws)
def test_counter_offsets_draw_the_unsharded_words():
    """A shard's words (``replica0``, ``rung0``) are the unsharded step's
    words of its rows, for every proposal's draws."""
    key, d, T, C = draws.seed_key(21), 5, 6, 40
    full = draws.slot_words(key, 7, T, d + 3, C, "cpu")
    part = draws.slot_words(key, 7, 2, d + 3, 10, "cpu", replica0=30,
                            rung0=3)
    assert torch.equal(part, full[3:5, :, 30:40])
    for kind in ("Normal", "Laplace", "UniformRadius"):
        a = draws.step_draws(key, 7, T, d, C, "cpu", kind=kind)
        b = draws.step_draws(key, 7, 2, d, 10, "cpu", kind=kind,
                             replica0=30, rung0=3)
        for u, v in zip(a, b):
            if u is not None:
                assert torch.equal(u[3:5, ..., 30:40], v), kind
    sw = draws.swap_uniforms(key, 7, d, torch.tensor([1, 4]), 30, 10)
    assert torch.equal(sw, a[2][[1, 4], 30:40])


# ------------------------------------------------- chains-sharded runs
@pytest.mark.parametrize("shards", [1, 2, 4, 8])
@pytest.mark.parametrize("algo", ["pt", "rwm"])
def test_chains_sharded_equals_unsharded(algo, shards):
    """On 1, 2, 4 and 8 virtual shards the sharded plain run equals the
    unsharded one bit for bit: x, lp, every counter and sum, the rates."""
    tgt = FullRosenbrock.create(4, device=CPU)
    kw = dict(base_variance=0.05, num_chains=256, num_iterations=40,
              burn_in=10)
    mesh = cpu_mesh((shards,))
    if algo == "pt":
        betas = torch.logspace(0, -2, 6)
        ref = run_pt_fused(tgt, 7, betas, swap_every=5, device=CPU, **kw)
        res = run_pt_fused_sharded(tgt, 7, betas, mesh, swap_every=5, **kw)
        assert_equal(res.state, ref.state, PT_STATE)
        assert res.state.swap_attempt_count == ref.state.swap_attempt_count
        for f in ("swap_acceptance_rate", "pt_esjd", "cold_esjd",
                  "acceptance_rate"):
            assert torch.equal(getattr(res, f), getattr(ref, f)), f
    else:
        ref = run_rwm_fused(tgt, 7, device=CPU, **kw)
        res = run_rwm_fused_sharded(tgt, 7, mesh, **kw)
        assert_equal(res.state, ref.state, RWM_STATE)
        assert torch.equal(res.acceptance_rate, ref.acceptance_rate)
        assert torch.equal(res.esjd, ref.esjd)
    assert res.state.step == ref.state.step


def test_rwm_sharded_shapes_and_layout():
    """JAX's ``test_rwm_sharded_shapes_and_layout``: global outputs."""
    res = run_rwm_fused_sharded(MultivariateNormal.create(3, device=CPU), 0,
                                cpu_mesh((8,)), base_variance=0.5,
                                num_chains=1024, num_iterations=3, burn_in=1)
    assert res.state.x.shape == (3, 1024)
    assert res.acceptance_rate.shape == (1024,)
    assert res.state.step == 4
    assert res.state.x.device == CPU


def test_pt_sharded_shapes_and_counts():
    """JAX's ``test_pt_sharded_shapes_and_counts``: 3 swap events x (T-1)
    pairs."""
    betas = np.geomspace(1.0, 0.01, 4).astype(np.float32)
    res = run_pt_fused_sharded(MultivariateNormal.create(3, device=CPU), 0,
                               betas, cpu_mesh((8,)), base_variance=0.5,
                               num_chains=512, num_iterations=6, burn_in=0,
                               swap_every=2)
    assert res.state.x.shape == (3, 4, 512)
    assert res.state.logp.shape == (4, 512)
    assert res.state.swap_attempt_count == 9
    assert res.swap_acceptance_rate.shape == (512,)


def test_per_shard_initial_states_differ():
    """Each shard starts from its slice of the unsharded run's init: the
    eight shards are not copies of one block (JAX's
    ``test_per_shard_initial_states_differ``), and the run is the
    unsharded one."""
    tgt = MultivariateNormal.create(2, device=CPU)
    kw = dict(base_variance=0.5, num_chains=64, num_iterations=1)
    res = run_rwm_fused_sharded(tgt, 0, cpu_mesh((8,)), **kw)
    shards = res.state.x.numpy().reshape(2, 8, 8)
    assert not np.allclose(shards[:, 0], shards[:, 1])
    assert torch.equal(res.state.x,
                       run_rwm_fused(tgt, 0, device=CPU, **kw).state.x)


@pytest.mark.parametrize("sharded_input", [False, True])
def test_explicit_init_states_are_scattered(sharded_input, monkeypatch):
    """A global ``(d, C)`` init, or the mesh's ``shard_init_states`` of it,
    reaches the shards in order (JAX's
    ``test_explicit_init_states_are_scattered``); the shards take the
    latter's pieces as they lie, never gathered."""
    mesh = cpu_mesh((8,))
    x0 = torch.arange(2 * 64, dtype=torch.float32).reshape(2, 64)
    init = shard_init_states(x0, mesh) if sharded_input else x0
    monkeypatch.setattr(ShardedTensor, "gather", None)
    res = run_rwm_fused_sharded(MultivariateNormal.create(2, device=CPU), 0,
                                mesh, base_variance=1e-12, num_chains=64,
                                num_iterations=1, init_states=init)
    np.testing.assert_allclose(res.state.x.numpy(), x0.numpy(), atol=1e-3)


def test_temp_sharded_and_indivisible_meshes_rejected():
    """JAX's messages: a temps axis over 1 ("temperature-sharded"), chains
    "not divisible", no chains axis, no temps axis, T not divisible."""
    tgt = MultivariateNormal.create(3, device=CPU)
    betas = np.geomspace(1.0, 0.01, 4).astype(np.float32)
    kw = dict(base_variance=0.5, num_chains=512, num_iterations=2)
    with pytest.raises(ValueError, match="temperature-sharded"):
        run_pt_fused_sharded(tgt, 0, betas,
                             cpu_mesh((4, 2), ("chains", "temps")), **kw)
    with pytest.raises(ValueError, match="not divisible"):
        run_rwm_fused_sharded(tgt, 0, cpu_mesh((8,)), base_variance=0.5,
                              num_chains=100, num_iterations=2)
    with pytest.raises(ValueError, match="no 'chains' axis"):
        run_rwm_fused_sharded(tgt, 0, cpu_mesh((2,), ("temps",)),
                              base_variance=0.5, num_chains=64,
                              num_iterations=2)
    with pytest.raises(ValueError, match="no 'temps' axis"):
        run_pt_fused_tempsharded(tgt, 0, betas, cpu_mesh((2,)), **kw)
    with pytest.raises(ValueError, match="T=4 not divisible by 3"):
        run_pt_fused_tempsharded(tgt, 0, betas, cpu_mesh((3,), ("temps",)),
                                 **kw)


def test_tempsharded_takes_its_meshs_pieces(monkeypatch):
    """The hybrid on a ``(chains, temps)`` mesh runs from that mesh's
    ``shard_init_states(pt=True)`` pieces, never gathered, exactly as from
    the global ``(d, T, C)`` init."""
    tgt = MultivariateNormal.create(3, device=CPU)
    betas = np.geomspace(1.0, 0.01, 4).astype(np.float32)
    mesh = cpu_mesh((2, 2), ("chains", "temps"))
    x0 = torch.from_numpy(np.random.default_rng(4).normal(
        size=(3, 4, 64)).astype(np.float32))
    kw = dict(base_variance=0.5, num_chains=64, num_iterations=20,
              swap_every=5)
    ref = run_pt_fused_tempsharded(tgt, 0, betas, mesh, init_states=x0, **kw)
    pieces = shard_init_states(x0, mesh, pt=True)
    monkeypatch.setattr(ShardedTensor, "gather", None)
    res = run_pt_fused_tempsharded(tgt, 0, betas, mesh, init_states=pieces,
                                   **kw)
    for f in ("x", "logp", "accept_count", "swap_accept_count"):
        assert torch.equal(getattr(res.state, f), getattr(ref.state, f)), f


# ------------------------------------------------ the swap event vs JAX
def _jax_event(x, lp, betas, n_t, key_pairs, step, burn_in):
    """JAX's event under shard_map on a temps mesh of n_t devices, each
    device's partial counters returned side by side."""
    T, C = lp.shape
    spec = JPTState(x=P(None, "temps", None), logp=P("temps", None),
                    accept_count=P("temps", None), swap_attempt_count=P(),
                    swap_accept_count=P("temps"),
                    sum_beta_sq_jump=P("temps"), sum_sq_jump_cold=P("temps"),
                    step=P())
    st = JPTState(x=jnp.asarray(x), logp=jnp.asarray(lp),
                  accept_count=jnp.zeros((T, C), jnp.int32),
                  swap_attempt_count=jnp.zeros((), jnp.int32),
                  swap_accept_count=jnp.zeros(n_t * C, jnp.int32),
                  sum_beta_sq_jump=jnp.zeros(n_t * C, jnp.float32),
                  sum_sq_jump_cold=jnp.zeros(n_t * C, jnp.float32),
                  step=jnp.asarray(step, jnp.int32))
    mesh = JMesh(np.array(jax.devices()[:n_t]), ("temps",))

    def local(s, b):
        return jevent(s, key_pairs, b, jax.lax.axis_index("temps"), n_t, T,
                      burn_in)
    f = jax.shard_map(local, mesh=mesh, in_specs=(spec, P("temps")),
                      out_specs=spec, check_vma=False)
    return jax.jit(f)(st, jnp.asarray(betas))


@pytest.mark.parametrize("post", [True, False], ids=["post", "burn-in"])
@pytest.mark.parametrize("n_t", [2, 4])
def test_swap_event_matches_jax(n_t, post):
    """The port's event on the same state (through ``convert.py``) and
    JAX's uniforms ``uniform(fold_in(key_pairs, g), (C,))``: x, lp and
    every shard's swap count equal, its beta-jump sum and the cold jump to
    rtol 1e-6; before burn-in nothing moves."""
    d, T, C, burn_in = 3, 8, 64, 100
    step = 150 if post else 100
    rng = np.random.default_rng(5 + n_t)
    x = rng.standard_normal((d, T, C)).astype(np.float32)
    lp = (3.0 * rng.standard_normal((T, C))).astype(np.float32)
    betas = np.geomspace(1.0, 0.01, T).astype(np.float32)
    key_pairs = jax.random.key(11)
    u = np.stack([np.asarray(jax.random.uniform(
        jax.random.fold_in(key_pairs, g), (C,))) for g in range(T - 1)])
    js = _jax_event(x, lp, betas, n_t, key_pairs, step, burn_in)
    tl = T // n_t
    column = [pt_state_from_numpy(dict(
        x=x[:, t * tl:(t + 1) * tl], logp=lp[t * tl:(t + 1) * tl],
        accept_count=np.zeros((tl, C), np.int32),
        swap_attempt_count=np.int32(0),
        swap_accept_count=np.zeros(C, np.int32),
        sum_beta_sq_jump=np.zeros(C, np.float32),
        sum_sq_jump_cold=np.zeros(C, np.float32), step=np.int32(step)),
        device=CPU) for t in range(n_t)]
    out = fused_sharded._tempsharded_swap_event(
        column, [torch.from_numpy(betas[t * tl:(t + 1) * tl])
                 for t in range(n_t)], T, burn_in, None, 0,
        u=torch.from_numpy(u))
    np.testing.assert_array_equal(
        torch.cat([s.x for s in out], 1).numpy(), np.asarray(js.x))
    np.testing.assert_array_equal(
        torch.cat([s.logp for s in out], 0).numpy(), np.asarray(js.logp))
    jacc = np.asarray(js.swap_accept_count).reshape(n_t, C)
    jbsq = np.asarray(js.sum_beta_sq_jump).reshape(n_t, C)
    for t, s in enumerate(out):
        np.testing.assert_array_equal(s.swap_accept_count.numpy(), jacc[t])
        np.testing.assert_allclose(s.sum_beta_sq_jump.numpy(), jbsq[t],
                                   rtol=1e-6)
    np.testing.assert_allclose(
        out[0].sum_sq_jump_cold.numpy(),
        np.asarray(js.sum_sq_jump_cold).reshape(n_t, C)[0], rtol=1e-6)
    moved = int(jacc.sum())
    assert (moved > 0) == post
    if not post:
        np.testing.assert_array_equal(np.asarray(js.x), x)


def test_swap_event_uniforms_are_on_the_cpu_only():
    """``u=`` replaces the Philox stream on the CPU only, like ``draws=``;
    without it the event reads the fused stream's swap words."""
    st = dataclasses.replace
    s = run_pt_fused(MultivariateNormal.create(2, device=CPU), 0,
                     np.float32([1.0, 0.5]), base_variance=0.5,
                     num_chains=8, num_iterations=1, device=CPU).state
    out = fused_sharded._tempsharded_swap_event(
        [st(s, step=5)], [torch.tensor([1.0, 0.5])], 2, 0,
        draws.seed_key(0), 0)
    assert out[0].x.shape == s.x.shape
    meta = torch.empty(0, device="meta")
    with pytest.raises(ValueError, match="CPU only"):
        fused_sharded._tempsharded_swap_event(
            [st(s, x=s.x.to("meta"), step=5)], [meta], 2, 0, None, 0,
            u=torch.zeros(1, 8))


# ------------------------------------------------------------- the hybrid
def _hybrid(n_t, n_c=1, T=8, C=64, iters=400, burn_in=100, se=50,
            var=0.5, seed=3):
    names = ("temps",) if n_c == 1 else ("chains", "temps")
    sizes = (n_t,) if n_c == 1 else (n_c, n_t)
    betas = np.geomspace(1.0, 0.01, T).astype(np.float32)
    return run_pt_fused_tempsharded(
        MultivariateNormal.create(3, device=CPU), seed, betas,
        cpu_mesh(sizes, names), base_variance=var, num_chains=C,
        num_iterations=iters, burn_in=burn_in, swap_every=se)


@pytest.fixture(scope="module")
def one_shard_hybrid():
    """The hybrid on one temps shard and the unsharded ``even_odd`` run of
    the same configuration (``_hybrid``'s)."""
    betas = np.geomspace(1.0, 0.01, 8).astype(np.float32)
    eo = run_pt_fused(MultivariateNormal.create(3, device=CPU), 3, betas,
                      base_variance=0.5, num_chains=64, num_iterations=400,
                      burn_in=100, swap_every=50, swap_sweep="even_odd",
                      device=CPU)
    return _hybrid(1), eo


@pytest.mark.parametrize("n_t,n_c", [(2, 1), (4, 1), (8, 1), (4, 2)])
def test_hybrid_bitwise_identical_across_partitions(one_shard_hybrid, n_t,
                                                    n_c):
    """JAX's ``test_bitwise_identical_across_mesh_partitionings`` with the
    MH phase live: temps partitions 2, 4 and 8 (one rung a shard) and a
    2 x 4 chains x temps mesh give the one-shard run's x, lp and MH and
    swap counts bit for bit, its beta-jump sums to rtol 1e-6, and the
    one-shard run equals the unsharded run with the ``even_odd`` sweep
    (the kernel's order and swap words) in those fields."""
    one, eo = one_shard_hybrid
    r = _hybrid(n_t, n_c)
    assert_equal(r.state, one.state, PT_STATE[:4])
    np.testing.assert_allclose(r.pt_esjd.numpy(), one.pt_esjd.numpy(),
                               rtol=1e-6)
    assert_equal(eo.state, one.state, PT_STATE[:4])
    assert int(one.state.swap_accept_count.sum()) > 0
    assert 0 < float(one.acceptance_rate.mean()) < 1


def test_hybrid_swap_attempt_accounting():
    """JAX's ``test_swap_attempt_accounting``: (400 + 100) / 50 = 10
    events, 2 before burn-in: 8 x 7 attempts."""
    r = _hybrid(2)
    assert r.state.swap_attempt_count == 8 * 7
    assert r.state.x.shape == (3, 8, 64)
    assert r.swap_acceptance_rate.shape == (64,)
    assert r.state.step == 500


def test_hybrid_chains_and_temps_2d_mesh():
    """JAX's ``test_chains_and_temps_2d_mesh``: a 2 (temps) x 4 (chains)
    mesh, T = 4, 100 steps, swap every 25: 4 x 3 attempts."""
    r = _hybrid(2, 4, T=4, iters=100, burn_in=0, se=25)
    assert r.state.x.shape == (3, 4, 64)
    assert r.state.swap_attempt_count == 4 * 3
    assert torch.isfinite(r.state.logp).all()


def test_hybrid_rates_match_jax_scan():
    """The hybrid on 4 temps shards against JAX's scan ``run_pt`` (its
    even/odd sweep) at the same configuration: per-rung MH and swap
    acceptance within 5 Monte-Carlo standard errors."""
    d, T, C, var = 3, 8, 512, 2.38 ** 2 / 3
    betas = np.geomspace(1.0, 0.01, T).astype(np.float32)
    kw = dict(num_chains=C, num_iterations=600, burn_in=100, swap_every=10)
    jr = jrun_pt(JMVN.create(d), JNormalProposal.create(d, var),
                 jax.random.key(4), jnp.asarray(betas), **kw)
    r = run_pt_fused_tempsharded(MultivariateNormal.create(d, device=CPU), 5,
                                 betas, cpu_mesh((4,), ("temps",)),
                                 base_variance=var, **kw)
    assert r.state.swap_attempt_count == int(jr.state.swap_attempt_count)
    ja = np.asarray(jr.acceptance_rate)
    for t in range(T):
        assert rate_z(r.acceptance_rate[t].numpy(), ja[t]) < 5, t
    assert rate_z(r.swap_acceptance_rate.numpy(),
                  np.asarray(jr.swap_acceptance_rate)) < 5
