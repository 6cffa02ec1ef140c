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

Not ported yet, and raised with ``NotImplementedError`` naming the ROADMAP
item: ``iterative_temp_spacing`` (Queue A item 10), ``autotune`` and
``autotune_ladder`` (A11), ``use_mesh`` (A13), ``cpu_semantics=True``,
``symmetric=False`` and ``progress_bar=True`` (A7).
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
from ..kernels import _build, run_pt, run_pt_fused, run_rwm, run_rwm_fused
from ..kernels.rwm import step_generator
from ..ladders import construct_geometric_ladder
from ..proposals import create_proposal_distribution
from ..targets import get_target_distribution
from ..targets.base import TargetMixin
from ..utils.dtypes import default_float, resolve_device

_RECORD_LIMIT = 2_000_000  # max recorded floats per run before auto-thinning
_RNG_IMPLS = ("threefry2x32", "rbg", "unsafe_rbg")


def _not_ported(what: str, item: str) -> NotImplementedError:
    return NotImplementedError(f"{what} is not ported to the PyTorch "
                               f"package yet (ROADMAP Queue {item})")


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
        if cpu_semantics:
            raise _not_ported("cpu_semantics=True (the CPU PT semantics)",
                              "A item 7")
        self.cpu_semantics = cpu_semantics
        self.seed = 42 if seed is None else seed
        if rng_impl not in _RNG_IMPLS:
            raise ValueError(f"rng_impl must be one of {_RNG_IMPLS}")
        self.rng_impl = rng_impl
        if not symmetric:
            raise _not_ported("symmetric=False (the asymmetric MH "
                              "correction)", "A item 7")
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
                raise _not_ported("iterative_temp_spacing (the iterative "
                                  "ladder)", "A item 10")
            else:
                self.beta_ladder = construct_geometric_ladder()
            if (self._rung_multipliers is not None
                    and len(self._rung_multipliers) != len(self.beta_ladder)):
                raise ValueError(
                    f"rung_scale_multipliers has {len(self._rung_multipliers)}"
                    f" entries but the ladder has {len(self.beta_ladder)} "
                    f"rungs; pass the beta_ladder the tuning run used "
                    f"(MCMCSimulation(beta_ladder=...))")
        else:
            self.beta_ladder = None

        if autotune:
            raise _not_ported("autotune (burn-in scale adaptation)",
                              "A item 11")
        if autotune_ladder:
            raise _not_ported("autotune_ladder (burn-in ladder adaptation)",
                              "A item 11")

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
                + ("record_chain=False" if record_chain is False and
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

        if use_mesh:
            raise _not_ported("use_mesh (multi-GPU runs)", "A item 13")
        self.mesh = None
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
        if self.is_pt and len(self.beta_ladder) > _build.MAX_RUNGS:
            return f"at most {_build.MAX_RUNGS} rungs"
        try:
            _build.kernel_target(self.target_dist)
        except NotImplementedError as e:
            return str(e)
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
             record_every=None):
        seed = self._sampler_seed()
        kw = dict(num_chains=self.num_chains, num_iterations=n,
                  burn_in=self.burn_in, init_states=init_states,
                  resume_state=resume_state, record_every=record_every,
                  record_chains=self.record_chains, device=self.device)
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
                          scale_multipliers=self._rung_multipliers, **kw)
        if fused:
            return run_rwm_fused(self.target_dist, seed,
                                 proposal=self.proposal_dist, **kw)
        return run_rwm(self.target_dist, self.proposal_dist, seed, **kw)

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
        if progress_bar:
            raise _not_ported("progress_bar=True (in-run progress lines)",
                              "A item 7")
        if checkpoint_every:
            if checkpoint_path is None:
                raise ValueError("checkpoint_every requires checkpoint_path")
            if self.num_iterations <= 0:
                raise ValueError("checkpoint_every requires num_iterations > 0")
            if self.record_chain:
                raise ValueError("periodic checkpointing requires "
                                 "record_chain=False (thinned traces cannot "
                                 "be stitched across segments)")
            return self._generate_samples_segmented(
                checkpoint_every, checkpoint_path, verbose)
        fused = self._use_pallas()
        self._sync()
        start = time.time()
        rec = self.record_every if self.record_chain else None
        res = self._run(fused, self.num_iterations,
                        init_states=self._init_states(), record_every=rec)
        self._sync()
        self._elapsed = time.time() - start
        self._engine_used = "pallas" if fused else "scan"
        self._result = res
        if res.chain is not None:
            # replica 0's trace, burn-in-trimmed by _get_chains_3d
            self._chain_np = self._get_chains_3d()[:, :, 0]
        self._report(verbose)
        return self._chain_np

    def _generate_samples_segmented(self, segment_every: int,
                                    checkpoint_path: str, verbose: bool):
        """Segmented run with a checkpoint after every segment; the sums
        and counters carry over exactly."""
        fused = self._use_pallas()
        self._engine_used = "pallas" if fused else "scan"
        self._sync()
        start = time.time()
        state, done = None, 0
        while done < self.num_iterations:
            n = min(segment_every, self.num_iterations - done)
            res = self._run(fused, n,
                            init_states=(self._init_states() if state is None
                                         else None),
                            resume_state=state)
            state = res.state
            done += n
            self._write_state(state, checkpoint_path)
            if verbose:
                print(f"  checkpoint @ {done}/{self.num_iterations} "
                      f"iterations -> {checkpoint_path}")
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
        before a run."""
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
        return info

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
        samplers when they take the run."""
        state, meta = self.restore_state(path)
        n = num_iterations or self.num_iterations
        fused = self._use_pallas() and meta.get("engine") != "scan"
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
