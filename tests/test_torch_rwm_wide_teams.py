"""RWM's wide teams (``csrc/fused_rwm_warp.cu``: G = 64 and 128 lanes, two
and four warps a chain, in the 2048 and 4096 buckets beside G = 32) and
the three-row kinds' terms row in global memory there, on the CPU: the
libraries' team sizes, the shared words against a transcription of the
kernel's count, the geometry with the named barriers' cap, the team
rule's picks, the terms pool off the card and the kernel's constants
against their Python mirror; and the plain version the kernels are held
against, step for step against the JAX package's Pallas body at full
width (d = 2000 and 4092).  The kernels themselves are held on the card
(``tests/test_torch_cuda.py -k rwm_wide_team``, ``chip_smoke.py`` phase
22g)."""
import re
from pathlib import Path

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from _torch_port_helpers import f32_sigmas, make_draws, run_jax_body
from rwm_pt_tpu_torch.convert import rwm_state_from_numpy
from rwm_pt_tpu_torch.kernels import _build, run_rwm_fused
from test_torch_wide import _pair, _start
from test_torch_wider import _lp_atol

torch.set_num_threads(1)
CPU = "cpu"
RTOL, ATOL = 1e-5, 1e-6
CSRC = Path(_build.CSRC)
SOURCE = (CSRC / "fused_rwm_warp.cu").read_text()
# kind -> parameter words at d (csrc/targets.cuh's vectors)
KIND_WORDS = {"mvn_iso": lambda d: 1 + d, "rosenbrock": lambda d: 2 + d,
              "iid_gamma": lambda d: 3, "iid_beta": lambda d: 3,
              "mvn_full": lambda d: 1 + d + d * d,
              "super_funnel": lambda d: 12000}
VARIANTS = ("fused_rwm_lax_erfinv", "fused_rwm_laplace",
            "fused_rwm_uniform_radius_bm", "fused_rwm_icdf_fastlog")


# ------------------------------------------------------------ team sizes
@pytest.mark.parametrize("variant", VARIANTS)
@pytest.mark.parametrize("dmax", _build.WARP_BUCKETS)
def test_rwm_library_teams(variant, dmax):
    """RWM's libraries hold G = 32 and 64 in the 2048 bucket, 32, 64 and
    128 in the 4096 bucket, PT's team sizes there; one warp a chain alone
    in the 512 and 1024 buckets, the small teams of the 128 and 256; no
    wide team for SuperFunnel's run-time shape.  ``-DRWM_PT_TEAMS`` is the
    mask of those sizes."""
    for kind in ("mvn_iso", "iid_gamma", "mvn_full", "neal_funnel"):
        name = f"{variant}.{kind}.w{dmax}"
        want = {128: (4, 32), 256: (8, 32), 512: (32,), 1024: (32,),
                2048: (32, 64), 4096: (32, 64, 128)}[dmax]
        assert _build.library_teams(name) == want, name
        assert f"-DRWM_PT_TEAMS={sum(want)}" in _build._flags(name)
        assert _build.wide_teams_ok(name)
    sf = f"{variant}.super_funnel.w{dmax}"
    assert _build.library_teams(sf) == tuple(
        g for g in _build.library_teams(f"{variant}.mvn_iso.w{dmax}")
        if g <= 32)
    if dmax > 1024:
        assert _build.RWM_WARP_TEAMS[dmax] == _build.WARP_TEAMS[dmax]
        assert _build.library_teams(sf) == (32,)


# ------------------------------------------------------ the shared words
def _shared_words(team, pitch, n_params, d, chains, rows, terms, laplace):
    """``csrc/fused_rwm_warp.cu::shared_words`` transcribed: the wide
    teams' words, the rows in shared memory, the staged parameters,
    Laplace's scales, the terms pool's slot."""
    staged = n_params if n_params <= 12288 else 0
    return ((8 * chains if team > 32 else 0) + chains * rows * pitch
            + staged + (d if laplace else 0) + int(terms))


@pytest.mark.parametrize("prop", ["Normal", "Laplace"])
@pytest.mark.parametrize("kind", sorted(KIND_WORDS))
@pytest.mark.parametrize("d,dmax", [(300, 512), (1000, 1024), (2000, 2048),
                                    (4000, 4096)])
def test_rwm_shared_bytes_are_the_kernels_count(d, dmax, kind, prop):
    """``rwm_warp_shared_bytes`` equals the kernel's count for every team
    size of the bucket: two rows in shared memory for every kind in the
    2048 and 4096 buckets, with the pool's slot word for the three-row
    kinds, whose terms row lies in global memory there; three for those
    kinds up to the 1024 bucket, with no slot word; a wide team's 8
    exchange words a chain."""
    n = KIND_WORDS[kind](d)
    terms = kind in _build.TERMS_ROW_KINDS and dmax > 1024
    rows = 3 if kind in _build.TERMS_ROW_KINDS and not terms else 2
    assert _build.global_terms(kind, dmax) == terms
    assert _build.pt_team_rows(kind, dmax) == rows
    for team in _build.RWM_WARP_TEAMS[dmax]:
        pitch = _build.team_pitch(dmax, team)
        for chains in (1, 7, 13):
            got = _build.rwm_warp_shared_bytes(n, d, chains, dmax, prop,
                                               team, kind)
            assert got == 4 * _shared_words(team, pitch, n, d, chains,
                                            rows, terms, prop == "Laplace")
            # rows given (a fixed SuperFunnel shape's two): no slot word
            assert _build.rwm_warp_shared_bytes(
                n, d, chains, dmax, prop, team, kind, rows=2) == 4 * \
                _shared_words(team, pitch, n, d, chains, 2, False,
                              prop == "Laplace")


# ------------------------------------------------------------ the geometry
@pytest.mark.parametrize("kind,d,team,chains,warps", [
    ("mvn_iso", 2000, 32, 13, 13), ("mvn_iso", 2000, 64, 13, 26),
    ("rosenbrock", 2000, 64, 13, 26), ("iid_gamma", 2000, 32, 14, 14),
    ("iid_gamma", 2000, 64, 14, 28), ("mvn_full", 2000, 64, 14, 28),
    ("mvn_iso", 4000, 32, 6, 6), ("mvn_iso", 4000, 64, 6, 12),
    ("mvn_iso", 4000, 128, 6, 24), ("rosenbrock", 4000, 128, 6, 24),
    ("iid_gamma", 4000, 128, 7, 28), ("iid_beta", 4000, 128, 7, 28)])
def test_rwm_wide_blocks(kind, d, team, chains, warps):
    """At 65,536 chains a chain's rows set the chains a block (8 KB a row
    at d = 2000, 16 KB at 4000, the staged parameters beside them): 13
    chains of the iso MVN and FullRosenbrock at d = 2000 at every team
    size, the launch bound (512 threads at G = 32, 896 for the wide teams)
    holding them; 14 of the three-row kinds, whose terms row lies in L2;
    6 at d = 4000, 7 of IIDGamma and IIDBeta; one block an SM, so G
    warps a chain multiply the warps an SM."""
    dmax = _build.warp_bucket(d)
    g = _build.rwm_warp_geometry(72, _build.rwm_team_threads(dmax, team),
                                 d, dmax, 65536, n_params=KIND_WORDS[kind](d),
                                 team=team, kind=kind)
    assert (g.team, g.replicas, g.threads) == (team, chains, team * chains)
    assert g.blocks_per_sm == 1 and _build.resident_warps(g) == warps
    assert g.shared_bytes <= _build.BLOCK_SHARED
    assert _build.barriers_fit(g.threads, team)


def test_rwm_geometry_keeps_the_barrier_cap(monkeypatch):
    """A block of wide teams holds at most 15 of them (named barriers
    1..15): with one row a chain and a bound of 1536 threads, 24 teams of
    64 lanes would fit the threads and 28 the shared memory, and the
    geometry takes 15; the launch bounds hold whole warps of chains."""
    monkeypatch.setattr(_build, "RWM_WIDE_THREADS", 1536)
    g = _build.rwm_warp_geometry(40, 1536, 2000, 2048, 65536, team=64,
                                 kind="mvn_iso", n_params=2001, rows=1)
    assert g.replicas == _build.WIDE_MAX_TEAMS == 15
    assert _build.barriers_fit(g.threads, 64)
    assert not _build.barriers_fit(g.threads + 64, 64)
    monkeypatch.undo()
    for dmax in _build.WARP_BUCKETS:
        for team in _build.RWM_WARP_TEAMS.get(dmax, _build.WARP_TEAMS[dmax]):
            bound = _build.rwm_team_threads(dmax, team)
            assert bound % 32 == 0 and bound % team == 0
            assert bound == (896 if team > 32 else 512 if dmax > 1024
                             else 256)


def _picks(kind, d, C):
    dmax = _build.warp_bucket(d)
    regs = {32: 64, 64: 72, 128: 72}
    return {g: _build.rwm_warp_geometry(
        regs[g], _build.rwm_team_threads(dmax, g), d, dmax, C,
        n_params=KIND_WORDS[kind](d), team=g, kind=kind)
        for g in _build.RWM_WARP_TEAMS[dmax]}


@pytest.mark.parametrize("C", [65536, 4096, 1024, 512])
@pytest.mark.parametrize("kind,d,team", [
    ("mvn_iso", 2000, 64), ("rosenbrock", 2000, 64), ("mvn_full", 2000, 64),
    ("mvn_iso", 4000, 128), ("rosenbrock", 4000, 128),
    ("iid_gamma", 2000, 32), ("iid_beta", 4000, 32)])
def test_choose_team_takes_the_wide_teams(kind, d, team, C):
    """``choose_team`` over the team sizes the geometry weighs
    (``geometry_teams``) at the main shape (65,536 chains), a mid grid
    (4096), the study CLI's 1024 and the campaigns' 512: at d = 2000
    G = 64 (26-28 warps an SM at 65,536, where G = 32 keeps 13-14); at
    d = 4000 G = 128 (24 warps, G = 32 6); where the grid fills no SM (512
    and 1024 chains, a chain or a few a block) the fewest block trips a
    step, the widest team; one warp a chain for the kinds whose every lane
    sums the log-density in index order (``SERIAL_LP_KINDS``), whose wide
    teams repeat that serial sum."""
    dmax = _build.warp_bucket(d)
    weighed = _build.geometry_teams(f"fused_rwm_lax_erfinv.{kind}.w{dmax}")
    assert weighed == (tuple(g for g in _build.RWM_WARP_TEAMS[dmax]
                             if g <= 32)
                       if kind in _build.SERIAL_LP_KINDS
                       else _build.RWM_WARP_TEAMS[dmax])
    geos = {g: x for g, x in _picks(kind, d, C).items() if g in weighed}
    g = _build.choose_team(geos, d)
    assert g.team == team, geos
    assert _build.resident_warps(g) == max(
        _build.resident_warps(o) for o in geos.values())
    if C == 65536 and team > 32:
        assert _build.resident_warps(g) >= _build.MIN_TEAM_WARPS
        assert _build.resident_warps(geos[32]) < _build.MIN_TEAM_WARPS


# ------------------------------------------------------------ pool, mirror
def test_geometry_teams_of_pt_and_the_serial_kinds():
    """PT's geometry weighs every team size of its library and its cluster
    build (the serial kinds' too: PT's IIDGamma takes G = 64); RWM's
    libraries of the serial kinds hold the wide teams (for the holds) but
    its geometry weighs G = 32 alone in the 2048 and 4096 buckets."""
    for kind in _build.SERIAL_LP_KINDS:
        for dmax in (2048, 4096):
            pt = f"fused_pt_lax_erfinv.{kind}.w{dmax}"
            rwm = f"fused_rwm_lax_erfinv.{kind}.w{dmax}"
            assert _build.geometry_teams(pt, 10) == _build.WARP_TEAMS[dmax]
            assert _build.library_teams(rwm) == _build.WARP_TEAMS[dmax]
            assert _build.geometry_teams(rwm) == (32,)
        assert _build.geometry_teams(
            f"fused_rwm_lax_erfinv.{kind}.w256") == (8, 32)
    assert _build.geometry_teams("fused_pt_laplace.iid_gamma.w2048", 10) \
        == (32, 64)   # the cluster build's G = 64


def test_rwm_terms_pool_off_the_card():
    """No pool where the terms row lies in shared memory or nowhere: the
    two-row kinds, the three-row kinds up to the 1024 bucket, a fixed
    SuperFunnel shape; the pool is the three-row kinds' in the 2048 and
    4096 buckets (made on the card).  The C entry point takes the team
    size, the pool's rows, bitmask and slots, and the stream after
    csrc/fused_rwm.cu's arguments."""
    geo = _build.Geometry(13, 832, 0, 1, 10, team=64)
    for name in ("fused_rwm_lax_erfinv.mvn_iso.w2048",
                 "fused_rwm_lax_erfinv.iid_gamma.w1024",
                 "fused_rwm_lax_erfinv.super_funnel.j40k3n20u4.w256"):
        assert _build.terms_pool(name, geo, 1000, 1, 3,
                                 torch.device("cpu")) == (None, None, 0)
    for kind in _build.TERMS_ROW_KINDS:
        assert _build.global_terms(kind, 2048)
        assert _build.global_terms(kind, 4096)
        assert not _build.global_terms(kind, 1024)
    sig = SOURCE[SOURCE.index('extern "C" int rwm_pt_fused_rwm('):]
    sig = sig[:sig.index(")")]
    args = [a.split()[-1].strip("*") for a in sig.split("(")[1].split(",")]
    assert args[-6:] == ["chains", "team", "terms", "claim", "pool",
                         "stream"]
    entry = _build._ENTRIES["fused_rwm_warp"]["rwm_pt_fused_rwm"]
    assert len(entry) == len(args)
    assert entry[len(_build._ENTRIES["fused_rwm"]["rwm_pt_fused_rwm"]) - 2:] \
        == [_build._I, _build._I, _build._P, _build._P, _build._I,
            _build._P]


def test_the_rwm_kernel_constants_match_the_mirror():
    """The Python mirror's constants are the RWM team kernel's: the launch
    bounds (``kBlockThreads``: the wide teams', G = 32's in the 2048 and
    4096 buckets and below), the terms row's rule (``kGlobalTerms``) and
    the team sizes the launcher's switch takes."""
    m = re.search(r"constexpr int kWideThreads = (\d+);", SOURCE)
    assert int(m.group(1)) == _build.RWM_WIDE_THREADS
    rule = SOURCE[SOURCE.index("constexpr int kBlockThreads ="):]
    rule = " ".join(rule[:rule.index(";")].split())
    assert rule == (f"constexpr int kBlockThreads = G > 32 ? kWideThreads : "
                    f"kDmax > 1024 ? {_build.RWM_WIDER_THREADS} : "
                    f"{_build.RWM_WARP_THREADS}")
    terms = SOURCE[SOURCE.index("constexpr bool kGlobalTerms ="):]
    assert " ".join(terms[:terms.index(";")].split()).endswith(
        "kTermsRow<kKind> && !kFixedDim && kDmax > 1024")
    for g in _build.TEAMS + _build.WIDE_TEAMS:
        assert f"case {g}: return team_kernel<{g}>();" in SOURCE
    assert "shared_words(team, pitch(team), n_params, d, chains)" in SOURCE
    assert "!barriers_ok(team, threads)" in SOURCE


# ------------------------------------------- the plain version against JAX
@pytest.mark.parametrize("kind,d", [("mvn_iso", 2000), ("rosenbrock", 2000),
                                    ("iid_gamma", 2000), ("mvn_iso", 4092)])
def test_fused_rwm_plain_matches_pallas_body_at_full_width(monkeypatch, kind,
                                                           d):
    """The plain fused RWM version, which every team size of the ``.w2048``
    and ``.w4096`` kernels is held against, at the full width of the RWM
    rows (d = 2000; the 4096 bucket's largest d, 4092) against the Pallas
    body at T = 1 with no swaps, resumed after its burn-in: counts exact,
    x and the Kahan ESJD to rtol 1e-5, lp beside the sum's rounding
    (``test_torch_wider._lp_atol``)."""
    jt, pt, var = _pair(kind, d)
    C, S = 6, 5
    rng = np.random.default_rng(d + len(kind))
    x0 = _start(kind, jt, (C,), 4)
    acc0 = rng.integers(0, 20, C).astype(np.int32)
    jump0 = (rng.random(C) * 5).astype(np.float32)
    normals, u_mh, _ = make_draws(19, S, 1, d, C)
    betas = np.ones(1, np.float32)
    ref = run_jax_body(monkeypatch, jt, x0[:, None], betas,
                       f32_sigmas(var, betas), (normals, u_mh, u_mh[:, :0]),
                       0, 2, 10 ** 6, acc0[None], None, None, jump0)
    state = rwm_state_from_numpy(dict(
        x=x0, logp=np.asarray(jt.log_density_td(jnp.asarray(x0))),
        accept_count=acc0, sum_sq_jump=jump0, step=0), device=CPU)
    r = run_rwm_fused(pt, 0, base_variance=var, num_chains=C,
                      num_iterations=S, burn_in=2, resume_state=state,
                      device=CPU, draws=(torch.from_numpy(normals[:, 0]),
                                         torch.from_numpy(u_mh[:, 0])))
    st = r.state
    np.testing.assert_array_equal(st.accept_count.numpy(), ref[2][0])
    np.testing.assert_allclose(st.x.numpy(), ref[0][:, 0], rtol=RTOL,
                               atol=ATOL)
    np.testing.assert_allclose(st.logp.numpy(), ref[1][0], rtol=RTOL,
                               atol=_lp_atol(d))
    np.testing.assert_allclose(st.sum_sq_jump.numpy(), ref[5], rtol=RTOL,
                               atol=ATOL)
    assert (st.accept_count.numpy() > acc0).any()
