"""MCMC simulation harness (port of ``rwm_pt_tpu.api.simulation``).

``MCMCSimulation`` keeps the JAX constructor's signature and the order of
its checks: a proposal from ``sigma`` (a Normal proposal) or from
``proposal_config``, RWM or PT dispatch by the algorithm's name, a seeded
run of ``num_chains`` chains or replicas, recording with auto-thinning to
a budget of recorded floats, the rate and ESJD getters, the convergence
diagnostics over the recorded traces, checkpoints in the JAX file format,
and a throughput sweep.

Engines: ``'pallas'`` runs the fused whole-run samplers
(``run_rwm_fused`` / ``run_pt_fused``: the hand-written CUDA kernels on the
card, their plain PyTorch versions on the CPU), ``'scan'`` the eager
engines (``run_rwm`` / ``run_pt``), and ``'auto'`` the fused samplers
whenever they take the run: one of the three library proposals, float32,
and a target the kernels take (``kernels/_build.py::kernel_target``).
Unlike on the TPU, recorded runs go to the fused samplers too: on a card
a snapshot is a store from registers, not a VMEM round trip, and nothing
limits the recorded batch.

``iterative_temp_spacing=True`` builds the ladder, seeded by ``seed``,
with the one-program builder (``ladders.construct_iterative_ladder_device``:
one launch of the ladder kernel on the card, its plain version on the CPU,
the pn exponent and clamp passed through), with room for the fused
kernel's rungs under ``engine='pallas'`` and for
``ladders.EAGER_MAX_RUNGS`` otherwise, so it lands the host loop's
uncapped ladder (``construct_iterative_ladder``); a ladder that needs more
rungs raises ``NotImplementedError``.
``autotune=True`` tunes the proposal scale (per rung for PT)
and ``autotune_ladder=True`` the PT ladder during burn-in, on the eager
adaptive engines (``kernels/adapt.py``).  With ``engine='pallas'`` that is
a two-phase run, as in JAX: the adaptive engine runs exactly the
``burn_in`` steps, then one launch of the fused kernel measures
``num_iterations`` steps from the tuned state, at the frozen per-rung
multipliers (PT), the multiplier folded into the proposal (RWM) or the
tuned ladder; with ``'auto'`` or ``'scan'`` the adaptive engine runs the
whole run.  ``cpu_semantics=True`` and ``symmetric=False`` run on the
eager engines (the fused kernels refuse them, as JAX's Pallas kernels
do), as does float64 (``utils.dtypes.set_x64``); ``progress_bar=True``
prints JAX's progress lines: from inside the eager engines' loops, or
after each of ten segments of a fused run.  ``use_mesh=True`` builds a
mesh over the harness's device (``parallel.make_mesh``: every visible
card, or the CPU under ``device="cpu"``) and, with JAX's rule, runs the
fused samplers sharded over it (``kernels/fused_sharded.py``: a chains
mesh, or the temperature-sharded hybrid where a ``temps`` axis divides
the ladder), with results equal to the unsharded runs' on a chains mesh;
the eager engines, a recorded run and a segmented run (checkpoints,
resume) take the whole batch on the mesh's first device, as JAX's scan
engine gives the unsharded result.
"""
from __future__ import annotations

import json
import os
import time
from typing import Optional, Union

import numpy as np
import torch

from ..convert import (PT_FIELDS, RWM_FIELDS, pt_state_from_numpy,
                       pt_state_to_numpy, rwm_state_from_numpy,
                       rwm_state_to_numpy)
from ..kernels import (_build, run_pt, run_pt_adaptive, run_pt_fused,
                       run_pt_fused_sharded, run_pt_fused_tempsharded,
                       run_pt_ladder_adaptive, run_rwm, run_rwm_adaptive,
                       run_rwm_fused, run_rwm_fused_sharded)
from ..kernels.rwm import step_generator
from ..ladders import (construct_geometric_ladder,
                       construct_iterative_ladder_device)
from ..ladders.ladders import EAGER_MAX_RUNGS, check_room
from ..parallel import make_mesh
from ..proposals import create_proposal_distribution
from ..targets import get_target_distribution
from ..targets.base import TargetMixin
from ..utils.dtypes import default_float, resolve_device

_RECORD_LIMIT = 2_000_000  # max recorded floats per run before auto-thinning
_RNG_IMPLS = ("threefry2x32", "rbg", "unsafe_rbg")


class MCMCSimulation:
    """Run batched RWM or PT-RWM on a target distribution.

    The JAX harness's parameters, plus ``device`` (``"cuda"`` by default;
    raises without a card unless ``"cpu"`` is passed).  ``rng_impl`` takes
    the JAX values and changes nothing: the fused samplers draw
    Philox4x32-10 keyed by the seed and counted by (replica, rung, step),
    the eager engines draw from a ``torch.Generator`` per (seed, step).
    Initial states are ``1e-8 N(0, I)`` from a generator seeded by
    ``seed``, on every rung of a PT replica.
    """

    def __init__(self,
                 dim: int,
                 sigma: float = None,
                 proposal_config: dict = None,
                 num_iterations: int = 1000,
                 algorithm: str = "RWM",
                 target_dist: Union[str, TargetMixin] = None,
                 symmetric: bool = True,
                 seed: Optional[int] = None,
                 beta_ladder: Optional[list] = None,
                 swap_acceptance_rate: Optional[float] = None,
                 burn_in: int = 0,
                 num_chains: int = 1,
                 swap_every: int = 100,
                 swap_sweep: str = "even_odd",
                 cpu_semantics: bool = False,
                 rng_impl: str = "threefry2x32",
                 iterative_temp_spacing: bool = False,
                 geom_temp_spacing: bool = False,
                 beta_min_iterative: float = 0.01,
                 N_samples_swap_est: int = 3000,
                 iterative_tolerance: float = 0.005,
                 iterative_initial_pn: float = 0.5,
                 iterative_pn_update_power: float = -0.25,
                 iterative_max_pn_steps: int = 100,
                 iterative_pn_clamp_min: float = -10.0,
                 iterative_pn_clamp_max: float = 10.0,
                 iterative_fail_tol_factor: float = 3.0,
                 record_chain: Optional[bool] = None,
                 record_every: Optional[int] = None,
                 record_chains: int = 1,
                 use_mesh: bool = False,
                 target_kwargs: Optional[dict] = None,
                 engine: str = "auto",
                 autotune: bool = False,
                 autotune_target: float = 0.234,
                 autotune_every: int = 100,
                 autotune_ladder: bool = False,
                 device="cuda",
                 **kwargs):
        if proposal_config is None and sigma is not None:
            proposal_config = {"name": "Normal",
                               "params": {"base_variance_scalar": sigma}}
        elif proposal_config is None and sigma is None:
            raise ValueError("Either sigma (backward compatibility) or "
                             "proposal_config must be provided")
        self.device = resolve_device(device)

        # PT by 'ParallelTempering' in the name or a "PT" short alias; not a
        # bare substring test ("RandomWalkMH_GPU_OPTimized" is RWM)
        algo = algorithm if isinstance(algorithm, str) else getattr(
            algorithm, "__name__", str(algorithm))
        _up = algo.upper().replace("-", "_")
        is_pt = ("PARALLELTEMPERING" in _up or _up == "PT"
                 or _up.startswith(("PT_", "PTRWM"))
                 or _up.endswith("_PT"))

        if isinstance(target_dist, str):
            tk = dict(target_kwargs or {})
            tk.setdefault("variant", "pt_gpu" if is_pt else "rwm_gpu")
            target_dist = get_target_distribution(target_dist, dim,
                                                  device=self.device, **tk)
        if target_dist is None:
            raise ValueError("target_dist is required")
        target_dist = target_dist.to(self.device)

        self.dim = target_dist.dim
        dim = target_dist.dim
        self.num_iterations = num_iterations
        self.burn_in = max(0, burn_in)
        self.target_dist = target_dist
        self.proposal_config = proposal_config
        self.proposal_dist = create_proposal_distribution(
            dim, proposal_config, device=self.device)
        # per-rung variance multipliers riding in the config: effective
        # variance base * c_t / beta_t; increments only
        self._rung_multipliers = None
        rm = (proposal_config.get("params") or {}).get(
            "rung_scale_multipliers")
        if rm is not None:
            if not is_pt:
                raise ValueError("rung_scale_multipliers in proposal_config "
                                 "requires a PT algorithm (it is per-rung)")
            if use_mesh:
                raise ValueError("rung_scale_multipliers is not supported "
                                 "with use_mesh yet; drop the mesh")
            self._rung_multipliers = np.asarray(rm, float)
        self.num_chains = num_chains
        self.swap_every = swap_every
        if swap_sweep not in ("even_odd", "sequential"):
            raise ValueError("swap_sweep must be 'even_odd' or 'sequential'")
        self.swap_sweep = swap_sweep
        self.cpu_semantics = cpu_semantics
        self.seed = 42 if seed is None else seed
        if rng_impl not in _RNG_IMPLS:
            raise ValueError(f"rng_impl must be one of {_RNG_IMPLS}")
        self.rng_impl = rng_impl
        self.symmetric = symmetric

        self.is_pt = is_pt
        self.algorithm_name = "PT_RWM_GPU" if self.is_pt else "RWM_GPU"
        if self.is_pt:
            if geom_temp_spacing and iterative_temp_spacing:
                raise ValueError("geom_temp_spacing and iterative_temp_spacing"
                                 " are mutually exclusive (geometric is the "
                                 "default when neither is set)")
            if beta_ladder is not None:
                self.beta_ladder = [float(b) for b in beta_ladder]
            elif iterative_temp_spacing:
                kw = dict(
                    target_swap_acceptance_rate=(swap_acceptance_rate
                                                 or 0.234),
                    beta_min=beta_min_iterative,
                    N_samples_swap_est=N_samples_swap_est,
                    tolerance=iterative_tolerance,
                    initial_pn=iterative_initial_pn,
                    max_pn_adjustment_steps=iterative_max_pn_steps,
                    convergence_failure_tolerance_factor=(
                        iterative_fail_tol_factor),
                    seed=self.seed,
                    pn_update_power=iterative_pn_update_power,
                    pn_clamping_range=(iterative_pn_clamp_min,
                                       iterative_pn_clamp_max))
                # room for the fused kernel's rungs under engine='pallas';
                # else the eager engine takes a longer ladder
                fit = (_build.target_rungs_fit(
                    target_dist, proposal_config.get("name"))
                       if engine == "pallas" else
                       _build.RungsFit(EAGER_MAX_RUNGS, "the eager engine"))
                self.beta_ladder = check_room(
                    construct_iterative_ladder_device(
                        target_dist, max_T=fit.rungs + 1, **kw),
                    fit.rungs, beta_min_iterative, fit.layout)
            else:
                self.beta_ladder = construct_geometric_ladder()
            self.algorithm_name = ("PT_RWM_GPU_ITERATIVE_LADDER"
                                   if iterative_temp_spacing
                                   else "PT_RWM_GPU")
            if (self._rung_multipliers is not None
                    and len(self._rung_multipliers) != len(self.beta_ladder)):
                raise ValueError(
                    f"rung_scale_multipliers has {len(self._rung_multipliers)}"
                    f" entries but the ladder has {len(self.beta_ladder)} "
                    f"rungs; pass the beta_ladder the tuning run used "
                    f"(MCMCSimulation(beta_ladder=...))")
        else:
            self.beta_ladder = None

        # burn-in proposal-scale tuning to the optimal acceptance, in
        # place of the reference's scale sweeps (kernels/adapt.py)
        self.autotune = autotune
        self.autotune_target = autotune_target
        self.autotune_every = autotune_every
        self._tuned = None
        # wall seconds of an autotuned run's phases, {"tune", "measure"}
        self._phase_seconds = None
        if autotune and record_chain:
            raise ValueError("autotune=True requires record_chain=False "
                             "(the adaptive kernels record no traces)")
        if autotune and self.burn_in < autotune_every:
            raise ValueError(
                f"autotune=True needs burn_in >= autotune_every "
                f"({autotune_every}) adaptation windows to run; got "
                f"burn_in={self.burn_in}. Use burn_in of at least a few "
                f"thousand steps so the recursion can converge.")
        if autotune and cpu_semantics:
            raise ValueError("autotune is not implemented for the CPU PT "
                             "semantics path (cpu_semantics=True)")
        if autotune and engine == "pallas" and use_mesh:
            raise ValueError("autotune with engine='pallas' does not "
                             "support a mesh (the tuned handoff resumes an "
                             "unsharded scan state); drop use_mesh or use "
                             "engine='scan'")
        if autotune:
            record_chain = False

        # burn-in ladder adaptation from swap acceptance measured on the
        # running chains; needs no direct sampler (kernels/adapt.py)
        self.autotune_ladder = autotune_ladder
        self._tuned_ladder = None
        self._target_swap_accept = swap_acceptance_rate or 0.234
        self._beta_min = beta_min_iterative
        if autotune_ladder:
            if not self.is_pt:
                raise ValueError("autotune_ladder=True requires a PT "
                                 "algorithm (it adapts the beta ladder)")
            if autotune:
                raise ValueError("autotune and autotune_ladder are mutually "
                                 "exclusive (run the ladder tuner first, "
                                 "then feed its beta_ladder to a scale-"
                                 "autotuned run)")
            if iterative_temp_spacing:
                raise ValueError("autotune_ladder replaces "
                                 "iterative_temp_spacing; pick one")
            if cpu_semantics:
                raise ValueError("autotune_ladder runs on the scan engine "
                                 "with GPU swap semantics")
            if engine == "pallas" and use_mesh:
                raise ValueError("autotune_ladder with engine='pallas' does "
                                 "not support a mesh; drop use_mesh or use "
                                 "engine='scan'")
            if record_chain:
                raise ValueError("autotune_ladder=True requires "
                                 "record_chain=False")
            if self.burn_in < autotune_every:
                raise ValueError(
                    f"autotune_ladder=True needs burn_in >= autotune_every "
                    f"({autotune_every}); got burn_in={self.burn_in}")
            record_chain = False

        if not 1 <= record_chains <= num_chains:
            raise ValueError(f"record_chains must be in [1, num_chains"
                             f"={num_chains}], got {record_chains}")
        self.record_chains = record_chains
        # record everything for small runs, auto-thin large ones; the budget
        # counts every recorded float: steps x dim x record_chains
        n_total = self.burn_in + num_iterations
        rec_floats = n_total * dim * record_chains
        if record_chain is None:
            record_chain = rec_floats <= _RECORD_LIMIT
        self.record_chain = record_chain
        if record_chains > 1 and not record_chain:
            raise ValueError(
                "record_chains > 1 requires chain recording, but recording "
                "is off for this run ("
                + ("autotune=True disables it"
                   if autotune else
                   "record_chain=False" if record_chain is False and
                   rec_floats <= _RECORD_LIMIT else
                   f"{rec_floats:,} recorded floats exceed the "
                   f"{_RECORD_LIMIT:,} budget; raise record_every or lower "
                   f"num_iterations/record_chains, or pass record_chain=True "
                   f"to force it") + ")")
        if record_every is None:
            record_every = 1
            if record_chain and rec_floats > _RECORD_LIMIT:
                record_every = max(1, rec_floats // _RECORD_LIMIT)
        self.record_every = record_every

        self.mesh = None
        if use_mesh:
            self.mesh = (make_mesh(devices=[self.device])
                         if self.device.type == "cpu" else make_mesh())
        if engine not in ("auto", "pallas", "scan"):
            raise ValueError("engine must be 'auto', 'pallas', or 'scan'")
        self.engine = engine
        self._engine_used = None
        self._result = None
        self._chain_np = None
        self._elapsed = None

    # ---------------------------------------------------------------- engine
    def _fused_refusal(self) -> Optional[str]:
        """Why the fused samplers cannot take this run, or None."""
        if self.proposal_config.get("name") not in _build.PROPOSALS:
            return "a library proposal (Normal/Laplace/UniformRadius)"
        if default_float() != torch.float32:
            return "float32 (the port's x64 switch is on)"
        if self.cpu_semantics:
            return "GPU swap semantics (cpu_semantics=False)"
        if not self.symmetric:
            return ("symmetric=True (the kernels omit the asymmetric "
                    "correction term)")
        fit = _build.target_rungs_fit(self.target_dist,
                                      self.proposal_config.get("name"))
        if self.is_pt and len(self.beta_ladder) > fit.rungs:
            return f"at most {fit.rungs} rungs ({fit.layout})"
        try:
            _build.kernel_target(self.target_dist)
        except NotImplementedError as e:
            return str(e)
        if self.mesh is not None:
            # JAX's mesh rule: a chains mesh whose size divides the chains,
            # or (PT) a temps axis whose size divides the ladder
            shape = self.mesh.shape
            n_c, n_t = shape.get("chains", 1), shape.get("temps", 1)
            if not (all(n == 1 for a, n in shape.items()
                        if a not in ("chains", "temps"))
                    and self.num_chains % n_c == 0
                    and (n_t == 1 or (self.is_pt and
                                      len(self.beta_ladder) % n_t == 0))):
                return ("a chains-only mesh (or none) with num_chains "
                        "divisible by its size, or a temps axis that "
                        "divides the ladder")
            if self.record_chain:
                return "no mesh when recording (a sharded run records none)"
        return None

    def _use_pallas(self) -> bool:
        if self.engine == "scan":
            return False
        why = self._fused_refusal()
        if self.engine == "pallas" and why is not None:
            raise ValueError(f"engine='pallas' (the fused CUDA kernels) "
                             f"requires {why}")
        return why is None

    def _sampler_seed(self) -> int:
        return self.seed % (1 << 64)

    def _sync(self):
        if self.device.type == "cuda":
            torch.cuda.synchronize(self.device)

    def _run(self, fused: bool, n: int, init_states=None, resume_state=None,
             record_every=None, progress_every=None):
        seed = self._sampler_seed()
        kw = dict(num_chains=self.num_chains, num_iterations=n,
                  burn_in=self.burn_in, init_states=init_states,
                  resume_state=resume_state, record_every=record_every,
                  record_chains=self.record_chains, device=self.device)
        eager = dict(symmetric=self.symmetric, progress_every=progress_every)
        if fused and self.mesh is not None and resume_state is None:
            return self._run_sharded(seed, n, init_states)
        if self.is_pt:
            betas = torch.tensor(self.beta_ladder, dtype=default_float(),
                                 device=self.device)
            if fused:
                return run_pt_fused(
                    self.target_dist, seed, betas,
                    proposal=self.proposal_dist, swap_every=self.swap_every,
                    scale_multipliers=self._rung_multipliers, **kw)
            return run_pt(self.target_dist, self.proposal_dist, seed, betas,
                          swap_every=self.swap_every,
                          swap_sweep=self.swap_sweep,
                          scale_multipliers=self._rung_multipliers,
                          cpu_semantics=self.cpu_semantics, **eager, **kw)
        if fused:
            return run_rwm_fused(self.target_dist, seed,
                                 proposal=self.proposal_dist, **kw)
        return run_rwm(self.target_dist, self.proposal_dist, seed, **eager,
                       **kw)

    def _run_sharded(self, seed: int, n: int, init_states):
        """A fused run sharded over the mesh: a temps-sharded mesh takes the
        hybrid, a chains mesh the chains-sharded runs."""
        kw = dict(proposal=self.proposal_dist, num_chains=self.num_chains,
                  num_iterations=n, burn_in=self.burn_in,
                  init_states=init_states)
        if not self.is_pt:
            return run_rwm_fused_sharded(self.target_dist, seed, self.mesh,
                                         **kw)
        run = (run_pt_fused_tempsharded
               if self.mesh.shape.get("temps", 1) > 1
               else run_pt_fused_sharded)
        betas = torch.tensor(self.beta_ladder, dtype=default_float(),
                             device=self.device)
        return run(self.target_dist, seed, betas, self.mesh,
                   swap_every=self.swap_every, **kw)

    # ------------------------------------------------------------------ run
    def has_run(self) -> bool:
        return self._result is not None

    def reset(self):
        self._result = None
        self._chain_np = None
        self._elapsed = None

    def _init_states(self):
        g = step_generator(self._sampler_seed(), -1, self.device, stream=1)
        x0 = self.target_dist.init_sample(self.num_chains, g).T   # (d, C)
        if self.is_pt:
            T = len(self.beta_ladder)
            x0 = x0[:, None, :].expand(self.dim, T, self.num_chains)
        return x0.contiguous()

    def _report(self, verbose: bool):
        if verbose:
            total_steps = (self.burn_in + self.num_iterations) * self.num_chains
            if self.is_pt:
                total_steps *= len(self.beta_ladder)
            print(f"Drew {self.num_iterations} samples x {self.num_chains} "
                  f"chains in {self._elapsed:.2f} seconds "
                  f"({total_steps / self._elapsed:,.0f} MH steps/s)")

    def generate_samples(self, progress_bar: bool = False, verbose: bool = True,
                         checkpoint_every: Optional[int] = None,
                         checkpoint_path: Optional[str] = None):
        """Run the sampler; returns the (cold-)chain of replica 0 as a
        ``(num_iterations // record_every, dim)`` array when recording is
        on, else ``None``.  The returned chain excludes the initial state
        and the burn-in samples.  Wall time is taken after the card has
        finished (``torch.cuda.synchronize``).

        ``checkpoint_every``/``checkpoint_path``: persist the sampler state
        every ``checkpoint_every`` post-burn-in iterations, so a killed run
        resumes via :meth:`resume`.  Both engines key their randomness on
        the absolute step, so a segmented run draws what an uninterrupted
        one draws (on the fused samplers up to the rounding of the
        log-densities recomputed at each segment start).  Requires
        ``record_chain=False``."""
        if self.has_run():
            raise ValueError("Please reset the algorithm before running it again.")
        if checkpoint_every:
            if checkpoint_path is None:
                raise ValueError("checkpoint_every requires checkpoint_path")
            if self.autotune or self.autotune_ladder:
                raise ValueError("autotune and checkpoint_every cannot be "
                                 "combined (the adaptive kernels are not "
                                 "resumable mid-adaptation)")
            if self.num_iterations <= 0:
                raise ValueError("checkpoint_every requires num_iterations > 0")
            if self.record_chain:
                raise ValueError("periodic checkpointing requires "
                                 "record_chain=False (thinned traces cannot "
                                 "be stitched across segments)")
            if self.engine == "pallas" and self.mesh is not None:
                raise ValueError("periodic checkpointing on the fused "
                                 "engine requires no mesh (the sharded runs "
                                 "are not resumable); drop the mesh or use "
                                 "engine='scan'")
            return self._generate_samples_segmented(
                checkpoint_every, checkpoint_path, verbose,
                progress=progress_bar)
        if self.autotune or self.autotune_ladder:
            return self._generate_tuned(verbose)
        fused = self._use_pallas()
        progress_every = None
        if progress_bar:
            # ~20 lines a run, never more than one a 1000 steps (JAX's rule)
            progress_every = max(1000,
                                 (self.burn_in + self.num_iterations) // 20)
            if fused and self.mesh is None and not self.record_chain:
                # a fused launch reports nothing until it ends: run it in
                # ten segments with a line after each, as JAX's Pallas path
                return self._generate_samples_segmented(
                    max(1, (self.burn_in + self.num_iterations) // 10),
                    None, verbose, progress=True)
            if fused and verbose:
                print("  (in-run progress is unavailable for recorded or "
                      "sharded fused runs; use engine='scan' for live "
                      "progress)")
        self._sync()
        start = time.time()
        rec = self.record_every if self.record_chain else None
        res = self._run(fused, self.num_iterations,
                        init_states=self._init_states(), record_every=rec,
                        progress_every=progress_every)
        self._sync()
        self._elapsed = time.time() - start
        self._engine_used = "pallas" if fused else "scan"
        self._result = res
        if res.chain is not None:
            # replica 0's trace, burn-in-trimmed by _get_chains_3d
            self._chain_np = self._get_chains_3d()[:, :, 0]
        self._report(verbose)
        return self._chain_np

    def _generate_tuned(self, verbose: bool):
        """An ``autotune`` or ``autotune_ladder`` run (module docstring):
        with ``engine='pallas'`` the adaptive engine runs the burn-in alone
        and one fused launch measures from its state; otherwise the
        adaptive engine runs it all.  Records no trace; returns None."""
        two_phase = self.engine == "pallas"
        if two_phase:
            self._check_pallas_measurement()    # before the tuning run
        seed = self._sampler_seed()
        kw = dict(num_chains=self.num_chains,
                  num_iterations=0 if two_phase else self.num_iterations,
                  burn_in=self.burn_in, adapt_every=self.autotune_every,
                  init_states=self._init_states(), device=self.device)
        self._sync()
        start = time.time()
        if self.autotune_ladder:
            tuned = run_pt_ladder_adaptive(
                self.target_dist, self.proposal_dist, seed,
                num_rungs=len(self.beta_ladder), swap_every=self.swap_every,
                target_swap_accept=self._target_swap_accept,
                beta_min=self._beta_min, **kw)
            mult = None
            self._tuned_ladder = tuned.tuned_betas.cpu().numpy()
            # the tuned ladder becomes the run's: diagnostics, JSON output
            # and the measurement phase see it
            self.beta_ladder = [float(b) for b in self._tuned_ladder]
        elif self.is_pt:
            tuned = run_pt_adaptive(
                self.target_dist, self.proposal_dist, seed,
                torch.tensor(self.beta_ladder, dtype=default_float(),
                             device=self.device),
                swap_every=self.swap_every,
                target_accept=self.autotune_target, **kw)
            self._tuned = tuned
            mult = tuned.tuned_scale_multipliers
        else:
            tuned = run_rwm_adaptive(
                self.target_dist, self.proposal_dist, seed,
                target_accept=self.autotune_target, **kw)
            self._tuned = tuned
            mult = tuned.tuned_scale_multiplier
        self._sync()
        t_tune = time.time() - start
        self._result = (self._pallas_measurement(tuned.result.state, mult)
                        if two_phase else tuned.result)
        self._sync()
        self._elapsed = time.time() - start
        self._phase_seconds = {"tune": t_tune,
                               "measure": self._elapsed - t_tune}
        self._engine_used = "pallas" if two_phase else "scan"
        self._chain_np = None
        if verbose:
            tail = " [measurement phase: pallas]" if two_phase else ""
            if self.autotune_ladder:
                print(f"Autotuned beta ladder: "
                      f"{np.array2string(self._tuned_ladder, precision=4)} "
                      f"(target swap acceptance {self._target_swap_accept})"
                      + tail)
            else:
                print(f"Autotuned proposal scale multiplier: "
                      f"{np.array2string(mult.cpu().numpy(), precision=3)} "
                      f"(target acceptance {self.autotune_target})" + tail)
        return None

    def _check_pallas_measurement(self):
        why = self._fused_refusal()
        if why is not None:
            raise ValueError(f"autotune with engine='pallas' (the fused CUDA "
                             f"kernels) requires {why}; use engine='scan' "
                             f"otherwise")

    def _pallas_measurement(self, state, mult):
        """Measurement phase of a two-phase run: one fused launch of
        ``num_iterations`` steps resumed from the tuned ``state``.  PT: the
        full per-rung multiplier vector ``mult`` feeds the kernel's
        per-rung scales (None after ladder tuning: the proposal's own
        scales on the tuned ladder).  RWM: the scalar multiplier folds
        into the proposal's base scale (:meth:`_scaled_config`)."""
        kw = dict(num_chains=self.num_chains,
                  num_iterations=self.num_iterations, burn_in=self.burn_in,
                  resume_state=state, device=self.device)
        seed = self._sampler_seed()
        if self.is_pt:
            return run_pt_fused(
                self.target_dist, seed,
                torch.tensor(self.beta_ladder, dtype=default_float(),
                             device=self.device),
                proposal=self.proposal_dist, swap_every=self.swap_every,
                scale_multipliers=mult, **kw)
        prop = create_proposal_distribution(
            self.dim, self._scaled_config(float(mult)), device=self.device)
        return run_rwm_fused(self.target_dist, seed, proposal=prop, **kw)

    def _scaled_config(self, c: float) -> dict:
        """The proposal config with its base scale rescaled by a variance
        multiplier ``c``: variance times c (Normal, Laplace), radius times
        sqrt(c) (UniformRadius), the reference's laws."""
        name = self.proposal_config["name"]
        params = dict(self.proposal_config.get("params", {}))
        params.pop("rung_scale_multipliers", None)
        if name == "Normal":
            params["base_variance_scalar"] = (
                float(params["base_variance_scalar"]) * c)
        elif name == "Laplace":
            params["base_variance_vector"] = (
                np.asarray(params["base_variance_vector"], float) * c).tolist()
        else:  # UniformRadius
            params["base_radius"] = (
                float(params["base_radius"]) * float(np.sqrt(c)))
        return {"name": name, "params": params}

    def _generate_samples_segmented(self, segment_every: int,
                                    checkpoint_path: Optional[str],
                                    verbose: bool, progress: bool = False):
        """Segmented run: a checkpoint after every segment when
        ``checkpoint_path`` is set, a progress line (JAX's) after every
        segment when ``progress``; the sums and counters carry over
        exactly.  With a mesh it runs on the eager engine (the sharded runs
        are not resumable), as JAX's does."""
        fused = self._use_pallas() and self.mesh is None
        self._engine_used = "pallas" if fused else "scan"
        self._sync()
        start = time.time()
        state, done = None, 0
        T = len(self.beta_ladder) if self.is_pt else 1
        while done < self.num_iterations:
            n = min(segment_every, self.num_iterations - done)
            seg_start = time.time()
            seg_steps = n + (self.burn_in if state is None else 0)
            res = self._run(fused, n,
                            init_states=(self._init_states() if state is None
                                         else None),
                            resume_state=state)
            state = res.state
            done += n
            if checkpoint_path:
                self._write_state(state, checkpoint_path)
                if verbose:
                    print(f"  checkpoint @ {done}/{self.num_iterations} "
                          f"iterations -> {checkpoint_path}")
            if progress and verbose:
                self._sync()
                rate = (seg_steps * self.num_chains * T
                        / max(time.time() - seg_start, 1e-9))
                print(f"  progress: {done:,}/{self.num_iterations:,} "
                      f"iterations ({rate:,.0f} MH steps/s)", flush=True)
        self._sync()
        self._result = res
        self._elapsed = time.time() - start
        self._report(verbose)
        return None

    # ----------------------------------------------------------- diagnostics
    def _require_run(self):
        if not self.has_run():
            raise ValueError("The algorithm has not been run yet.")

    def acceptance_rate(self) -> float:
        """Post-burn-in acceptance rate; for PT the swap acceptance rate."""
        self._require_run()
        if self.is_pt:
            return float(self._result.swap_acceptance_rate.mean())
        return float(self._result.acceptance_rate.mean())

    def acceptance_rate_per_chain(self) -> np.ndarray:
        self._require_run()
        r = (self._result.swap_acceptance_rate if self.is_pt
             else self._result.acceptance_rate)
        return r.cpu().numpy()

    def expected_squared_jump_distance(self) -> float:
        """x-space ESJD (the cold chain for PT), post burn-in."""
        self._require_run()
        esjd = self._result.cold_esjd if self.is_pt else self._result.esjd
        return float(esjd.mean())

    def expected_squared_jump_distance_per_chain(self) -> np.ndarray:
        self._require_run()
        esjd = self._result.cold_esjd if self.is_pt else self._result.esjd
        return esjd.cpu().numpy()

    def pt_expected_squared_jump_distance(self) -> float:
        """beta-space PT ESJD."""
        self._require_run()
        if not self.is_pt:
            raise ValueError("pt_expected_squared_jump_distance requires PT")
        return float(self._result.pt_esjd.mean())

    def swap_acceptance_rate(self) -> float:
        self._require_run()
        return float(self._result.swap_acceptance_rate.mean())

    @property
    def elapsed_time(self) -> Optional[float]:
        return self._elapsed

    @property
    def engine_used(self) -> Optional[str]:
        """Engine of the last run: 'scan' (eager) or 'pallas' (fused); None
        before a run.  A two-phase autotuned run reports 'pallas': its
        measurement phase ran there."""
        return self._engine_used

    def get_diagnostic_info(self) -> dict:
        """The JAX harness's diagnostics dict; ``backend`` is the torch
        device and ``devices`` names the card."""
        self._require_run()
        fused = self._engine_used == "pallas"
        devices = ([torch.cuda.get_device_name(self.device)]
                   if self.device.type == "cuda" else ["cpu"])
        info = {
            "backend": str(self.device),
            "devices": devices,
            "algorithm": self.algorithm_name,
            "num_chains": self.num_chains,
            "num_iterations": self.num_iterations,
            "burn_in": self.burn_in,
            "elapsed_seconds": self._elapsed,
            "engine": self._engine_used,
            "acceptance_rate": self.acceptance_rate(),
            "esjd": self.expected_squared_jump_distance(),
            "optimization_level": ("FUSED_CUDA_KERNEL" if fused
                                   else "EAGER_PYTORCH"),
            "rng": ("Philox4x32-10 counter (replica, rung, step)" if fused
                    else "torch.Generator per (seed, step)"),
        }
        if self.is_pt:
            info.update({
                "beta_ladder": list(map(float, self.beta_ladder)),
                "num_temps": len(self.beta_ladder),
                "swap_every": self.swap_every,
                "swap_acceptance_rate": self.swap_acceptance_rate(),
                "pt_esjd": self.pt_expected_squared_jump_distance(),
            })
        if self._tuned is not None:
            mult = self._tuned[1].cpu().numpy()
            info.update({
                "autotune_target": self.autotune_target,
                "tuned_scale_multiplier": (mult.tolist() if mult.ndim
                                           else float(mult)),
            })
        if self._tuned_ladder is not None:
            info.update({
                "autotune_ladder_target": self._target_swap_accept,
                "tuned_beta_ladder": [float(b) for b in self._tuned_ladder],
            })
        return info

    @property
    def tuned_ladder(self):
        """The burn-in-adapted beta ladder of an ``autotune_ladder=True``
        run, or None."""
        return (None if self._tuned_ladder is None
                else [float(b) for b in self._tuned_ladder])

    def tuned_proposal_config(self) -> dict:
        """The proposal config carrying the autotuned multiplier(s), for a
        fresh ``MCMCSimulation`` at the tuned scale.  RWM: the multiplier
        folds into the base scale.  PT: the full per-rung vector rides
        along as ``params['rung_scale_multipliers']`` (effective variance
        ``base * c_t / beta_t``); pass the fresh simulation this run's
        ``beta_ladder``."""
        if self._tuned is None:
            raise ValueError("run generate_samples with autotune=True first")
        c = self._tuned[1].cpu().numpy()
        if c.ndim == 1:
            params = dict(self.proposal_config.get("params", {}))
            params["rung_scale_multipliers"] = [float(x) for x in c]
            return {"name": self.proposal_config["name"], "params": params}
        return self._scaled_config(float(c))

    # ----------------------------------------------------------- persistence
    def _write_state(self, state, path: str):
        flat = (pt_state_to_numpy(state) if self.is_pt
                else rwm_state_to_numpy(state))
        os.makedirs(os.path.dirname(path) or ".", exist_ok=True)
        if not path.endswith(".npz"):
            path = path + ".npz"
        # atomic replace: a kill mid-write keeps the previous checkpoint
        tmp = path + ".tmp.npz"
        np.savez(tmp, *flat.values(), meta=json.dumps({
            "algorithm": self.algorithm_name,
            "seed": self.seed,
            "num_iterations": self.num_iterations,
            "burn_in": self.burn_in,
            "num_chains": self.num_chains,
            "beta_ladder": (list(map(float, self.beta_ladder))
                            if self.beta_ladder else None),
            "engine": self._engine_used,
        }))
        os.replace(tmp, path)

    def save_checkpoint(self, path: str):
        """Persist the final sampler state in the JAX harness's format:
        ``np.savez`` of the state fields in the JAX dataclass order as
        ``arr_0..`` plus a ``meta`` JSON, so either package resumes it."""
        self._require_run()
        self._write_state(self._result.state, path)

    def load_checkpoint(self, path: str):
        if not os.path.exists(path) and not path.endswith(".npz"):
            path = path + ".npz"
        data = np.load(path, allow_pickle=False)
        meta = json.loads(str(data["meta"]))
        keys = sorted((k for k in data.files if k != "meta"),
                      key=lambda k: int(k.split("_")[1]))
        return [data[k] for k in keys], meta

    def restore_state(self, path: str):
        """The typed sampler state of a checkpoint file (written by this
        package or the JAX one), on this simulation's device."""
        arrays, meta = self.load_checkpoint(path)
        if "PT" in meta["algorithm"]:
            return pt_state_from_numpy(dict(zip(PT_FIELDS, arrays)),
                                       device=self.device), meta
        return rwm_state_from_numpy(dict(zip(RWM_FIELDS, arrays)),
                                    device=self.device), meta

    def resume(self, path: str, num_iterations: Optional[int] = None):
        """Continue a checkpointed run for ``num_iterations`` more steps.
        A checkpoint written by the eager engine (``engine == 'scan'`` in
        its meta) resumes on the eager engine; any other on the fused
        samplers when they take the run and there is no mesh."""
        state, meta = self.restore_state(path)
        n = num_iterations or self.num_iterations
        fused = (self._use_pallas() and self.mesh is None
                 and meta.get("engine") != "scan")
        self._sync()
        start = time.time()
        self._result = self._run(fused, n, resume_state=state)
        self._sync()
        self._engine_used = "pallas" if fused else "scan"
        self._chain_np = None
        self._elapsed = time.time() - start
        return self._result

    # ----------------------------------------------------------------- plots
    def _get_chain(self):
        self._require_run()
        if self._chain_np is None:
            raise ValueError("Chain recording was disabled for this run "
                             "(record_chain=False).")
        return self._chain_np

    def _get_chains_3d(self) -> np.ndarray:
        """Recorded post-burn-in traces as ``(n_rec, dim, record_chains)``;
        entry k holds the state after step (k+1) * record_every, and the
        entries of burn-in steps are dropped."""
        self._require_run()
        chain = getattr(self._result, "chain", None)
        if chain is None:
            raise ValueError("Chain recording was disabled for this run "
                             "(record_chain=False).")
        rec = self.record_every or 1
        return chain.cpu().numpy()[self.burn_in // rec:]

    def effective_sample_size(self) -> np.ndarray:
        """Split-chain ESS per dimension, shape ``(dim,)``."""
        from ..analysis.diagnostics import effective_sample_size
        return effective_sample_size(self._get_chains_3d())

    def split_rhat(self) -> np.ndarray:
        """Split-chain potential scale reduction per dimension, ``(dim,)``."""
        from ..analysis.diagnostics import split_rhat
        return split_rhat(self._get_chains_3d())

    def mcse_mean(self) -> np.ndarray:
        """Monte-Carlo standard error of the mean per dimension, ``(dim,)``."""
        from ..analysis.diagnostics import mcse_mean
        return mcse_mean(self._get_chains_3d())

    def integrated_autocorr_time(self) -> np.ndarray:
        """IACT per dimension in recorded-draw units, shape ``(dim,)``."""
        from ..analysis.diagnostics import integrated_autocorr_time
        return integrated_autocorr_time(self._get_chains_3d())

    def traceplot(self, single_dim: bool = False, show: bool = False,
                  output_dir: str = "images"):
        """Traceplot of the recorded chain (needs matplotlib, imported
        here)."""
        import matplotlib
        matplotlib.use("Agg")
        import matplotlib.pyplot as plt
        chain = self._get_chain()
        plt.figure(figsize=(10, 6))
        for i in range(1 if single_dim else min(5, self.dim)):
            plt.plot(chain[:, i], label=f"Dimension {i + 1}", alpha=0.7,
                     lw=0.5)
        plt.xlabel("Iteration")
        plt.ylabel("Value")
        plt.legend()
        plt.title(f"Traceplot - {self.algorithm_name}")
        os.makedirs(output_dir, exist_ok=True)
        filename = (f"{output_dir}/traceplot_{self.target_dist.get_name()}_"
                    f"{self.algorithm_name}_dim{self.dim}_"
                    f"{self.num_iterations}iters")
        plt.savefig(filename, dpi=150, bbox_inches="tight")
        if show:
            plt.show()
        plt.close()
        return filename

    def samples_histogram(self, num_bins: int = 50, axis: int = 0,
                          show: bool = False, output_dir: str = "images"):
        """Histogram of one coordinate with the target density along that
        coordinate, the others at 0 (needs matplotlib, imported here)."""
        import matplotlib
        matplotlib.use("Agg")
        import matplotlib.pyplot as plt
        samples = self._get_chain()[:, axis]
        plt.figure(figsize=(10, 6))
        plt.hist(samples, bins=num_bins, density=True, alpha=0.5,
                 label="Samples")
        lo = min(-20.0, float(samples.min()) - 2)
        hi = max(20.0, float(samples.max()) + 2)
        xs = np.linspace(lo, hi, 1000)
        pts = torch.zeros((1000, self.dim), dtype=self.target_dist.dtype,
                          device=self.device)
        pts[:, axis] = torch.as_tensor(xs, dtype=pts.dtype, device=pts.device)
        ys = self.target_dist.density(pts).cpu().numpy()
        plt.plot(xs, ys, color="red", linestyle="--", linewidth=2,
                 label="Target density (conditional slice, others=0)")
        plt.xlabel("Value")
        plt.ylabel("Density")
        plt.legend()
        plt.title(f"Sample Histogram - {self.algorithm_name}")
        os.makedirs(output_dir, exist_ok=True)
        filename = (f"{output_dir}/hist_{self.target_dist.get_name()}_"
                    f"{self.algorithm_name}_dim{self.dim}_"
                    f"{self.num_iterations}iters")
        plt.savefig(filename, dpi=150, bbox_inches="tight")
        if show:
            plt.show()
        plt.close()
        return filename

    # ------------------------------------------------------------- benchmark
    def benchmark_performance(self, num_samples_list=(1000, 5000, 10000, 50000)):
        """Throughput sweep over run lengths.  A completed run's results are
        kept across the sweep and restored afterwards."""
        results = {"sample_sizes": list(num_samples_list), "times": [],
                   "samples_per_sec": [], "mh_steps_per_sec": []}
        orig = self.num_iterations
        saved = (self._result, self._chain_np, self._elapsed,
                 self._engine_used)
        try:
            for n in num_samples_list:
                self.reset()
                self.num_iterations = n
                self.generate_samples(verbose=False)
                dt = self._elapsed
                steps = n * self.num_chains * (len(self.beta_ladder)
                                               if self.is_pt else 1)
                results["times"].append(dt)
                results["samples_per_sec"].append(n / dt)
                results["mh_steps_per_sec"].append(steps / dt)
                print(f"  {n} samples: {dt:.3f}s, {steps / dt:,.0f} MH steps/s")
        finally:
            self.num_iterations = orig
            (self._result, self._chain_np, self._elapsed,
             self._engine_used) = saved
        return results
