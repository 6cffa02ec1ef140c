"""Sharded fused runs over a device mesh (port of
``rwm_pt_tpu.kernels.pallas_sharded``).

The fused kernels (``csrc/fused_pt.cu``, ``fused_rwm.cu``, their team
forms ``fused_*_warp.cu`` and SuperFunnel's fixed builds) are one-device
programs.  Chains are communication-free data parallelism (every replica
is independent; swaps happen between rungs of one replica), so
:func:`run_rwm_fused_sharded` and :func:`run_pt_fused_sharded` run one
launch a shard of the mesh's ``chains`` axis, each on its device, and
gather the per-chain outputs into global tensors on the mesh's first
device.  Shard ``s`` runs chains ``[s C_loc, (s + 1) C_loc)`` and adds its
first chain to the Philox counter's replica word (``csrc/philox.cuh``), so
it draws exactly what the unsharded launch draws for those chains: a
sharded run equals ``run_rwm_fused`` / ``run_pt_fused`` bit for bit at any
partition.  Every shard takes the unsharded run's initial states (its
slice of them) and the team size and normal draw that the unsharded launch
resolves for the whole count (``_build.Shard``).

:func:`run_pt_fused_tempsharded` is JAX's temperature-sharded hybrid:
shard (t, c) owns rungs ``[t T_loc, (t + 1) T_loc)`` of chains
``[c C_loc, ..)`` and advances them through segments of ``swap_every`` MH
steps (``run_pt_fused`` resumed, no swap inside: the rung word of its
counter offset by ``t T_loc``), and between segments one swap event
(:func:`_tempsharded_swap_event`, plain PyTorch, as JAX runs it in plain
XLA) exchanges the boundary rows (x, lp, beta) with the neighbouring
shards.  Pair ``g`` of an event draws the word the unsharded kernel's
``even_odd`` sweep reads for it, so every partition of the ladder decides
every pair alike.  The accounting is JAX's: the owner of a pair's lower
rung counts it, the cold-chain jump lives on the shard of rung 0 (its
MH and swap moves summed apart), and the per-replica sums are merged over
``temps``.

One process drives every shard; a launch runs under its device's
``torch.cuda.device`` on that device's current stream, the shards in mesh
order, and boundary rows move with ``Tensor.to``.  On one card a mesh of
k virtual shards runs them one after another.
"""
from __future__ import annotations

import contextlib
import dataclasses
import itertools

import torch

from ..parallel.mesh import ShardedTensor, chain_sharding, pt_sharding
from ..utils.dtypes import as_tensor
from . import _build
from .draws import resolve_normal_impl, resolve_seed, seed_key, swap_uniforms
from .fused_pt import run_pt_fused
from .fused_rwm import run_rwm_fused
from .pt import PTResult, PTState
from .rwm import RWMResult, RWMState, step_generator


def _chain_shards(mesh) -> int:
    if "chains" not in mesh.axis_names:
        raise ValueError(f"mesh {mesh.axis_names} has no 'chains' axis")
    if "temps" in mesh.axis_names and mesh.shape["temps"] != 1:
        raise ValueError(
            "the fused PT kernel keeps each replica's full ladder in one "
            "launch; temperature-sharded meshes take "
            "run_pt_fused_tempsharded")
    return mesh.shape["chains"]


def _local_count(num_chains: int, shards: int, what: str) -> int:
    if num_chains % shards:
        raise ValueError(f"{what}={num_chains} not divisible by "
                         f"{shards} chain shards")
    return num_chains // shards


def _devices(mesh, names) -> dict:
    """``{position: device}`` over the positions of mesh axes ``names`` (an
    axis the mesh lacks has one position), the mesh's other axes at their
    first position."""
    sizes = [mesh.shape.get(a, 1) for a in names]
    out = {}
    for pos in itertools.product(*map(range, sizes)):
        where = dict(zip(names, pos))
        out[pos] = mesh.devices[tuple(where.get(a, 0)
                                      for a in mesh.axis_names)]
    return out


def _on(dev):
    return (torch.cuda.device(dev) if dev.type == "cuda"
            else contextlib.nullcontext())


def _layout(source, target, proposal, num_chains, T, dev):
    """``Shard`` fields of the whole run: the normal draw and, for a team
    library on the card, the team size that the unsharded launch of
    ``num_chains`` replicas (PT: ``T`` rungs) resolves."""
    kind = "Normal" if proposal is None else proposal.name
    draw = resolve_normal_impl(source[len("fused_"):], num_chains,
                               _build.target_kind(target))
    team = None
    if dev.type == "cuda":
        lib, _, params = _build.route(_build.library(source, kind, draw),
                                      target)
        if _build.is_warp(lib):
            team = _build.launch_geometry(lib, target.dim, num_chains, T,
                                          kind, draw, params.numel()).team
    return draw, team


def _same_mesh(a, b) -> bool:
    return a is b or (a.axis_names == b.axis_names
                      and a.devices.shape == b.devices.shape
                      and list(a.devices.flat) == list(b.devices.flat))


def _init(target, seed, init_states, mesh, num_chains, T, c_loc, t_loc,
          first):
    """Initial states by shard: ``piece(c, t)``, chain shard c's (and temps
    shard t's) slice, ``(d, C_loc)`` (RWM, ``T`` 0) or ``(d, T_loc, C_loc)``
    on its device, of the unsharded run's auto-init (``step_generator(seed,
    -1, stream=1)``) or of ``init_states``, ``(d, C)`` or ``(d, T, C)``.
    This mesh's ``shard_init_states`` already holds every shard's piece on
    its device; any other init is sliced from one tensor on ``first``."""
    def at(c, t):   # the mesh position of chain shard c, temps shard t
        where = {"chains": c, "temps": t}
        return tuple(where.get(a, 0) for a in mesh.axis_names)

    if isinstance(init_states, ShardedTensor) and _same_mesh(
            init_states.sharding.mesh, mesh) and init_states.sharding.spec \
            == (pt_sharding(mesh, 3) if T else chain_sharding(mesh, 2)).spec:
        if init_states.shape[-1] != num_chains:
            raise ValueError(f"init_states hold {init_states.shape[-1]} "
                             f"chains, num_chains={num_chains}")
        pieces = init_states.pieces

        return lambda c, t: pieces[at(c, t)].to(torch.float32).contiguous()
    if init_states is None:
        g = step_generator(seed, -1, first, stream=1)
        x0 = target.init_sample(num_chains, g).T
        if T:
            x0 = x0[:, None, :].expand(target.dim, T, num_chains)
    else:
        x0 = as_tensor(init_states, first, torch.float32)
        if x0.shape[-1] != num_chains:
            raise ValueError(f"init_states hold {x0.shape[-1]} chains, "
                             f"num_chains={num_chains}")

    def piece(c, t):
        x = x0[..., c * c_loc:(c + 1) * c_loc]
        if T:
            x = x[:, t * t_loc:(t + 1) * t_loc]
        return x.to(mesh.devices[at(c, t)], torch.float32).contiguous()
    return piece


def _cat(parts, dim, dev):
    return torch.cat([p.to(dev) for p in parts], dim=dim)


def run_rwm_fused_sharded(target, seed, mesh, *, num_chains: int,
                          num_iterations: int, burn_in: int = 0,
                          beta: float = 1.0, base_variance: float = None,
                          proposal=None, init_states=None,
                          _plain: bool = False) -> RWMResult:
    """Mesh-sharded :func:`run_rwm_fused`: the metrics contract of
    ``run_rwm_fused``, the per-chain outputs global ``(C,)`` tensors on the
    mesh's first device, equal bit for bit to the unsharded run's.
    ``init_states``: a global ``(d, C)`` tensor or the mesh's
    ``shard_init_states`` (each shard takes its piece).  ``_plain`` runs every shard's plain version on
    its device (to hold the sharded kernels against it), not a user
    option."""
    shards = _chain_shards(mesh)
    c_loc = _local_count(num_chains, shards, "num_chains")
    devs = _devices(mesh, ("chains",))
    first = devs[(0,)]
    seed = resolve_seed(seed)
    target = target.to(first, torch.float32)
    piece = _init(target, seed, init_states, mesh, num_chains, 0, c_loc, 0,
                  first)
    draw, team = _layout("fused_rwm", target, proposal, num_chains, 0, first)
    parts = []
    for (s,), dev in devs.items():
        with _on(dev):
            parts.append(run_rwm_fused(
                target, seed, base_variance=base_variance, proposal=proposal,
                num_chains=c_loc, num_iterations=num_iterations,
                burn_in=burn_in, beta=beta,
                init_states=piece(s, 0), device=dev,
                _shard=_build.Shard(s * c_loc, 0, team, draw, _plain)))
    state = RWMState(
        x=_cat([p.state.x for p in parts], 1, first),
        logp=_cat([p.state.logp for p in parts], 0, first),
        accept_count=_cat([p.state.accept_count for p in parts], 0, first),
        sum_sq_jump=_cat([p.state.sum_sq_jump for p in parts], 0, first),
        step=parts[0].state.step)
    return RWMResult(
        state=state,
        acceptance_rate=_cat([p.acceptance_rate for p in parts], 0, first),
        esjd=_cat([p.esjd for p in parts], 0, first), chain=None)


def run_pt_fused_sharded(target, seed, betas, mesh, *, num_chains: int,
                         num_iterations: int, burn_in: int = 0,
                         swap_every: int = 100, base_variance: float = None,
                         proposal=None, init_states=None,
                         swap_sweep: str = "sequential",
                         _plain: bool = False) -> PTResult:
    """Mesh-sharded :func:`run_pt_fused`: every shard advances its chain
    slice through the full ladder (``betas`` on every shard); the metrics
    contract of ``run_pt_fused`` with global outputs on the mesh's first
    device, equal bit for bit to the unsharded run's.  ``init_states``: a
    global ``(d, T, C)`` tensor or the mesh's ``shard_init_states``;
    ``swap_sweep`` as ``run_pt_fused``'s; ``_plain`` as
    :func:`run_rwm_fused_sharded`'s."""
    shards = _chain_shards(mesh)
    c_loc = _local_count(num_chains, shards, "num_chains")
    devs = _devices(mesh, ("chains",))
    first = devs[(0,)]
    seed = resolve_seed(seed)
    target = target.to(first, torch.float32)
    betas = as_tensor(betas, first, torch.float32)
    T = betas.shape[0]
    piece = _init(target, seed, init_states, mesh, num_chains, T, c_loc, T,
                  first)
    draw, team = _layout("fused_pt", target, proposal, num_chains, T, first)
    parts = []
    for (s,), dev in devs.items():
        with _on(dev):
            parts.append(run_pt_fused(
                target, seed, betas.to(dev), base_variance=base_variance,
                proposal=proposal, num_chains=c_loc,
                num_iterations=num_iterations, burn_in=burn_in,
                swap_every=swap_every,
                init_states=piece(s, 0), swap_sweep=swap_sweep, device=dev,
                _shard=_build.Shard(s * c_loc, 0, team, draw, _plain)))
    return _pt_result(
        [p.state.x for p in parts], [p.state.logp for p in parts],
        [p.state.accept_count for p in parts],
        [p.state.swap_accept_count for p in parts],
        [p.state.sum_beta_sq_jump for p in parts],
        [p.state.sum_sq_jump_cold for p in parts], first,
        parts[0].state.swap_attempt_count, parts[0].state.step,
        burn_in)


def _pt_result(x, lp, acc, swapacc, bj, cj, dev, attempts, step, burn_in):
    """The global PTResult of per-chain-shard pieces, in chain order."""
    acc = _cat(acc, 1, dev)
    swapacc, bj, cj = (_cat(v, 0, dev) for v in (swapacc, bj, cj))
    n = float(max(step - burn_in, 1))
    state = PTState(x=_cat(x, 2, dev), logp=_cat(lp, 1, dev),
                    accept_count=acc, swap_attempt_count=attempts,
                    swap_accept_count=swapacc, sum_beta_sq_jump=bj,
                    sum_sq_jump_cold=cj, step=step)
    return PTResult(state=state, swap_acceptance_rate=swapacc / attempts,
                    pt_esjd=bj / attempts, cold_esjd=cj / n,
                    acceptance_rate=acc / n, chain=None)


# -------------------------------------------- the temperature-sharded hybrid
def _tempsharded_swap_event(column, betas, T: int, burn_in: int, key,
                            replica0: int, u=None):
    """One swap event on a temps-sharded ladder (JAX's
    ``pallas_sharded.py::_tempsharded_swap_event``): ``column[t]`` is the
    ``PTState`` of temps shard t of one chain column, ``(d, T_loc, C)``,
    ``betas[t]`` its ``(T_loc,)`` rungs, all at one step.  Returns the new
    states.

    The event runs the two half-sweeps, even pairs then odd pairs; before
    each, every shard takes its neighbours' boundary rows (x, lp, beta)
    afresh: the previous shard's last rung and the next shard's first.  The
    uniform of global pair g is slot ``d+1`` of (replica, rung g, step), the
    word the unsharded kernel's ``even_odd`` sweep reads for pair (g, g+1)
    (``draws.swap_uniforms``); ``u`` (CPU only, for tests), ``(T-1, C)``,
    gives the pairs' uniforms in its place.  A pair swaps when
    ``u < exp((beta_g - beta_{g+1}) (lp_{g+1} - lp_g))`` after burn-in;
    the owner of its lower rung counts it and adds ``(dbeta)^2`` to the
    beta-jump sum; shard 0 adds the cold rung's squared jump over the
    event."""
    n_t = len(column)
    d, T_loc, C = column[0].x.shape
    step = int(column[0].step)
    post = step > burn_in
    if u is not None and column[0].x.device.type != "cpu":
        raise ValueError("u= replaces the Philox stream on the CPU only")
    xs = [s.x for s in column]
    lps = [s.logp for s in column]
    if u is None:   # every pair's words, drawn once for the column
        u = swap_uniforms(key, step, d,
                          torch.arange(T - 1, device=xs[0].device),
                          replica0, C)
    ctx = []   # per shard: (global pair index g, valid, own, uniforms)
    for t, x in enumerate(xs):
        r_idx = torch.arange(T_loc + 1, device=x.device)
        g = t * T_loc - 1 + r_idx
        valid = (g >= 0) & (g <= T - 2)
        ctx.append((g, valid, valid & (r_idx >= 1),
                    u[g.clamp(0, T - 2).to(u.device)].to(x.device)))
    acc = [torch.zeros(C, dtype=torch.int32, device=x.device) for x in xs]
    bsq = [torch.zeros(C, dtype=x.dtype, device=x.device) for x in xs]
    cold_before = xs[0][:, 0].clone()
    for parity in (0, 1):
        new = []
        for t in range(n_t):
            dev, x, lp, b = xs[t].device, xs[t], lps[t], betas[t]
            g, valid, own, uu = ctx[t]
            if t > 0:
                x_dn, lp_dn, b_dn = (xs[t - 1][:, -1].to(dev),
                                     lps[t - 1][-1].to(dev),
                                     betas[t - 1][-1].to(dev))
            else:
                x_dn, lp_dn, b_dn = (torch.zeros_like(x[:, 0]),
                                     torch.zeros_like(lp[0]),
                                     torch.zeros_like(b[0]))
            if t < n_t - 1:
                x_up, lp_up, b_up = (xs[t + 1][:, 0].to(dev),
                                     lps[t + 1][0].to(dev),
                                     betas[t + 1][0].to(dev))
            else:
                x_up, lp_up, b_up = (torch.zeros_like(x[:, 0]),
                                     torch.zeros_like(lp[0]),
                                     torch.zeros_like(b[0]))
            x_ext = torch.cat([x_dn[:, None], x, x_up[:, None]], dim=1)
            lp_ext = torch.cat([lp_dn[None], lp, lp_up[None]], dim=0)
            b_ext = torch.cat([b_dn[None], b, b_up[None]])
            dlp = lp_ext[1:] - lp_ext[:-1]                  # (T_loc+1, C)
            dbeta = b_ext[:-1] - b_ext[1:]                  # (T_loc+1,)
            log_swap = dbeta[:, None] * dlp
            enabled = valid & (g % 2 == parity)
            a = (uu < torch.exp(log_swap)) & enabled[:, None] & post
            # local rung r (row r + 1 of ext) takes the row above it when
            # pair r + 1 swaps, the row below it when pair r does (JAX's
            # rolls, on the local rows alone)
            x_sw = torch.where(a[None, 1:], x_ext[:, 2:],
                               torch.where(a[None, :-1], x_ext[:, :-2],
                                           x_ext[:, 1:-1]))
            lp_sw = torch.where(a[1:], lp_ext[2:],
                                torch.where(a[:-1], lp_ext[:-2],
                                            lp_ext[1:-1]))
            a_own = a & own[:, None]
            acc[t] = acc[t] + torch.sum(a_own, dim=0, dtype=torch.int32)
            bsq[t] = bsq[t] + torch.sum(a_own * (dbeta * dbeta)[:, None],
                                        dim=0)
            new.append((x_sw, lp_sw))
        xs = [n[0] for n in new]
        lps = [n[1] for n in new]
    out = []
    for t, s in enumerate(column):
        cold = s.sum_sq_jump_cold
        if post and t == 0:
            cold = cold + torch.sum(torch.square(xs[0][:, 0] - cold_before),
                                    dim=0)
        out.append(dataclasses.replace(
            s, x=xs[t].contiguous(), logp=lps[t].contiguous(),
            swap_accept_count=s.swap_accept_count + acc[t],
            sum_beta_sq_jump=s.sum_beta_sq_jump + bsq[t],
            sum_sq_jump_cold=cold))
    return out


def run_pt_fused_tempsharded(target, seed, betas, mesh, *, num_chains: int,
                             num_iterations: int, burn_in: int = 0,
                             swap_every: int = 100,
                             base_variance: float = None, proposal=None,
                             init_states=None,
                             _plain: bool = False) -> PTResult:
    """Temperature-sharded fused PT, JAX's hybrid (module docstring): MH
    segments of ``swap_every`` steps through ``run_pt_fused``, then one
    swap event between segments.  The mesh needs a ``temps`` axis whose
    size divides T; an optional ``chains`` axis shards the replicas.
    ``init_states``: a global ``(d, T, C)`` tensor or the mesh's
    ``shard_init_states``; by default the unsharded run's auto-init.  The
    metrics contract of ``run_pt_fused``, with JAX's hybrid accounting:
    ``(total // swap_every - burn_in // swap_every) (T - 1)`` swap
    attempts; global outputs on the mesh's first device.  ``_plain`` as
    :func:`run_rwm_fused_sharded`'s."""
    if "temps" not in mesh.axis_names:
        raise ValueError(f"mesh {mesh.axis_names} has no 'temps' axis")
    n_t = mesh.shape["temps"]
    n_c = mesh.shape.get("chains", 1)
    devs = _devices(mesh, ("temps", "chains"))
    first = devs[(0, 0)]
    f32 = torch.float32
    seed = resolve_seed(seed)
    target = target.to(first, f32)
    betas = as_tensor(betas, first, f32)
    T = betas.shape[0]
    if T % n_t:
        raise ValueError(f"T={T} not divisible by {n_t} temp shards")
    t_loc = T // n_t
    c_loc = _local_count(num_chains, n_c, "num_chains")
    total = burn_in + num_iterations
    n_segs, rem = divmod(total, swap_every)
    piece = _init(target, seed, init_states, mesh, num_chains, T, c_loc,
                  t_loc, first)
    draw, team = _layout("fused_pt", target, proposal, num_chains, T, first)
    key = seed_key(seed)
    st, b_loc = {}, {}
    for (t, c), dev in devs.items():
        x = piece(c, t)
        zi = torch.zeros(c_loc, dtype=torch.int32, device=dev)
        zf = torch.zeros(c_loc, dtype=f32, device=dev)
        st[t, c] = PTState(
            x=x, logp=target.to(dev, f32).log_density_td(x),
            accept_count=torch.zeros((t_loc, c_loc), dtype=torch.int32,
                                     device=dev),
            swap_attempt_count=0, swap_accept_count=zi,
            sum_beta_sq_jump=zf, sum_sq_jump_cold=zf.clone(), step=0)
        b_loc[t, c] = betas[t * t_loc:(t + 1) * t_loc].to(dev).contiguous()

    def mh_segment(steps):
        for (t, c), dev in devs.items():
            s = st[t, c]
            with _on(dev):
                res = run_pt_fused(
                    target, seed, b_loc[t, c], base_variance=base_variance,
                    proposal=proposal, num_chains=c_loc,
                    num_iterations=steps, burn_in=burn_in,
                    # no swap step in any segment: the counter carries the
                    # absolute step, so a bound of the segment's own length
                    # would put one inside a later segment
                    swap_every=total + 1, resume_state=s, device=dev,
                    _shard=_build.Shard(c * c_loc, t * t_loc, team, draw,
                                        _plain))
            # run_pt_fused counts no swap attempt here; keep the state's own
            st[t, c] = dataclasses.replace(
                res.state, swap_attempt_count=s.swap_attempt_count)

    for _ in range(n_segs):
        mh_segment(swap_every)
        for c in range(n_c):
            column = _tempsharded_swap_event(
                [st[t, c] for t in range(n_t)],
                [b_loc[t, c] for t in range(n_t)], T, burn_in, key,
                c * c_loc)
            for t in range(n_t):
                st[t, c] = column[t]
    if rem:
        mh_segment(rem)

    # merge each replica's partial sums over temps: a pair is counted by
    # the owner of its lower rung; the cold-chain sum lives on rung 0's
    # shard (its kernel-side accumulator is that rung's)
    cols = [[st[t, c] for t in range(n_t)] for c in range(n_c)]
    n_events = total // swap_every - burn_in // swap_every
    attempts = max(n_events * (T - 1), 1)
    return _pt_result(
        [_cat([s.x for s in col], 1, first) for col in cols],
        [_cat([s.logp for s in col], 0, first) for col in cols],
        [_cat([s.accept_count for s in col], 0, first) for col in cols],
        [sum(s.swap_accept_count.to(first) for s in col) for col in cols],
        [sum(s.sum_beta_sq_jump.to(first) for s in col) for col in cols],
        [col[0].sum_sq_jump_cold for col in cols], first, attempts, total,
        burn_in)
