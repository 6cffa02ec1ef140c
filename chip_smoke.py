#!/usr/bin/env python3
"""On-card smoke gate and flagship measurement of the PyTorch/CUDA port.

    python3 chip_smoke.py          # one CUDA card; exits non-zero on failure

Drives ``rwm_pt_tpu_torch`` (never JAX) in phases, one line each:

1. device: name, count, ``nvidia-smi`` name and power limit;
2. build: every library the smoke launches, from
   ``rwm_pt_tpu_torch/kernels/csrc``, one per (kernel, proposal, normal
   draw, target kind), one ``nvcc`` each, all in parallel, with ptxas
   registers, stack frame and spills per register bucket, and each
   library's launch geometry and blocks and warps per SM
   (``cudaOccupancyMaxActiveBlocksPerMultiprocessor`` beside
   ``kernels/_build.py``'s count); a stack frame or a spill fails (a
   ladder library's local memory too); the warp libraries (d > 64, phases
   16-22) build in the background of phases 3-15 and are reported and
   gated before phase 16, but the 2048 and 4096 buckets', which build
   last, behind phases 16-21, and are reported and gated before phase 22;
3. kernel vs plain on one Philox stream: PT on FullRosenbrock d=30, T=10,
   C=2048 (200 steps, burn-in 50, swap every 10) and RWM on MVN d=10,
   C=2048: share of replicas whose final x agrees to 1e-3 (rounding can flip
   a rare accept decision, after which that replica diverges), max |diff|
   over them; on them every counter equal and lp and the Kahan sums to
   rtol 1e-4 (``kernels/agreement.py``); counter rates with a z-score;
4. fused PT vs the eager engine ``run_pt(swap_sweep="sequential")`` on MVN
   d=10, T=6, C=1024: swap and per-rung MH acceptance;
5. exact invariance (Geweke) of the fused RWM and PT kernels on MVN d=10,
   C=4096, with a fresh seed that is printed;
6. main paths through the user entry points, launch counters zeroed just
   before and read just after each: the flagship PT run of ``bench.py``
   (30-d FullRosenbrock, 10 rungs 1..0.01, variance 0.5^2/30, swap every
   100, 65,536 replicas, 2000 steps) and the RWM headline run of
   ``scripts/bench_rwm_impl_block.py`` (30-d FullRosenbrock, 65,536 chains,
   2000 steps), each timed through its entry point with CUDA events (best
   of 3).  Each kernel is then timed alone at its main path's size and
   beside its bound, and held against its plain version at the main path's
   shapes over ``HOLD_STEPS`` (100) steps, as in phase 3.
7. every new kernel variant against its plain version at main-path shapes
   over ``HOLD_STEPS`` steps (phase 3's checks; a recorded trace must agree to 1e-3
   on the agreeing replicas): RWM on 30-d FullRosenbrock at 65,536 chains
   and PT at the flagship shape, each with the Laplace and the
   UniformRadius proposal and with recording (Normal, every step; the held
   run records 1024 replicas and PT swaps every 10 steps in it, so a
   snapshot taken before the swap sweep shows); each is also timed alone
   at its main path's size (recording the first 4 replicas).  The RWM
   Laplace and UniformRadius kernels are also held at the study's shape
   (RoughCarpetScaled d=20, 1024 chains) at three scales of its grid;
8. fused vs eager rates (z < 5) and exact invariance (Geweke, max z < 5,
   fresh printed seed) for the Laplace and UniformRadius proposals on MVN
   d=10, RWM and PT;
9. the harness on the card: ``MCMCSimulation`` PT at the flagship shape
   and RWM at 65,536 chains, 2000 iterations, ``record_chain=True``,
   ``record_chains=4``, for each of the three proposals, launch counters
   zeroed just before and read just after each run: one launch of the
   fused kernel per run (and of its recording path), ``engine_used ==
   "pallas"``, a finite ``(2000, 30)`` chain, finite split R-hat and ESS;
10. the RWM proposal study ``experiment_rwm`` at
   ``scripts/launch_rwm_pod.sh``'s shape on its default target
   RoughCarpetScaled (dim 20, 200,000 iterations, burn-in 1000, 1024
   chains, var_max 4.0, seed 1, ``--no_plots``) for Laplace and
   UniformRadius, ``STUDY_CONFIGS`` scale configs each (a cut from the
   CLI's 40 is printed): one launch per config; the ESJD-optimal
   acceptance and steps/s.  The study's JSON and logs go to
   ``smoke_out/study/`` beside this script;
11. every other target kind (full-covariance MVN, scaled MVN,
   ThreeMixture, RoughCarpet, EvenRosenbrock, HybridRosenbrock, Hypercube,
   IIDGamma, IIDBeta, NealFunnel): both kernels timed alone at the
   flagship shape (d=30 or the kind's nearest valid d, T=10, 65,536
   replicas or chains, 2000 steps) beside its bound, held against their
   plain versions at that d and at d=10 (2048 replicas or chains, 200
   steps, burn-in 50, PT T=10 swapping every 10; the full-covariance MVN
   PT at d=30 takes the instantiation with fewer than 32 replicas a
   block), and driven once at the flagship shape through
   ``run_pt_fused`` / ``run_rwm_fused``; the Geweke gate (max z < 5,
   fresh printed seed) on ThreeMixture, RoughCarpet, IIDGamma (six rungs
   1 .. 0.09, exact tempered gamma draws), NealFunnel and the
   full-covariance MVN;
12. the normal draws: every path above takes the draw
   ``resolve_normal_impl`` picks for its kernel, replicas or chains and
   target kind; here the Normal and UniformRadius variants of ICDF and
   Box-Muller, where the rule does not pick them, are held against their
   plain versions at main-path shapes, the Geweke gate runs on MVN d=10
   with each of the two forced, the four exact draws (``icdf``, ``bm``,
   ``icdf_fastlog``, ``lax_erfinv``) are timed through the entry points
   (a warm-up call, then best of 3, interleaved, launch counters zeroed
   just before) at the flagship PT (Normal and UniformRadius), the
   full-covariance MVN at that shape, the PT study's shape, the RWM
   headline and the RWM study's shape, and the ``resolve_normal_impl``
   decision is printed beside the fastest draw at each;
13. the PT swap-rate study ``experiment_pt`` at
   ``scripts/launch_pt_pod.sh``'s shape (ThreeMixture d=10, 200,000
   iterations, burn-in 1000, 1024 replicas, ``swap_accept_max`` 0.5,
   ``N_samples_swap_est`` 1e6, tolerance 1e-4, 1000 pn steps, fail factor
   1, seed 1), ``PT_STUDY["configs"]`` of its 30 configs (10: a cut of
   depth to keep the smoke within its time limit): per config the ladder (one launch of the
   ladder kernel, phase 18), its build and run seconds, the actual
   swap acceptance beside the constructed rate, the beta-ESJD and exactly
   one fused launch; the ESJD-optimal swap acceptance; one
   ``MCMCSimulation(iterative_temp_spacing=True)`` PT run on ThreeMixture
   (one ladder launch, one fused launch);
   the study's library held against its plain version at the study's
   shape (T=7, even/odd, ``HOLD_STEPS`` steps); fused ``even_odd`` against the eager
   engine's ``even_odd`` on MVN d=10.
   The study's JSON and log go to ``smoke_out/pt_study/``;
14. the draw study's normals: (a) the two probe kernels, launches counted:
   ``draw_normals`` of every draw at N = 2^20 (the JAX probe's size) and
   2^24 (the bandwidth shape) held against its plain version on the same
   Philox words and, for the normals, put through
   ``tests/test_pallas_kernels.py:425-440``'s moment, KS and tail gates
   (the tails against ``torch.randn``), and ``fast_log`` on that test's
   8192 inputs, on 2^24 + 3 inputs and on a view of them one float off
   16-byte alignment, within 2 ulp of its plain version and the JAX bound
   of float64 log; then each probe and its library call (``torch.randn``,
   sqrt(2) erfinv(2u - 1 + 2^-24), ``torch.log``) at both shapes, timed
   kernel, library, library, kernel: device us a launch (100 launches in
   one CUDA graph), host us a call (1000 calls on a host clock, then one
   synchronise) and the single-call event time, beside the bound; and the
   launch path's host work piece by piece; (b) the ``icdf_fastlog``,
   ``lax_erfinv`` and ``fake_uniform`` variants of both kernels, Normal
   and UniformRadius, timed at their main path's size and held against
   their plain versions at its shapes over ``HOLD_STEPS`` steps; (c) the Geweke gate
   on MVN d=10 with ``icdf_fastlog`` and ``lax_erfinv`` forced; (d) the
   draw study (``scripts/bench_normal_impl.py``): the five draws timed
   interleaved, best of 3, through ``run_pt_fused`` at the flagship shape
   and ``run_rwm_fused`` at the RWM headline, Normal and UniformRadius,
   ``draws.NORMAL_IMPL`` forced and the launch counters zeroed just
   before each call: MH steps/s, acceptance, swap acceptance, ESJD, ms
   beside the bound, ``draw_cost_share = 1 - rate / rate_fake_uniform``;
15. burn-in autotuning through ``MCMCSimulation(engine="pallas")``, the
   eager tuner for the burn-in and one fused launch after it (counted):
   the scale tuner at the flagship shape from a Normal variance mis-scaled
   by 1/100 (per-rung acceptance, tuning ms/step, measurement seconds),
   RWM at 65,536 chains, the ladder tuner at the flagship shape; the JAX
   tests' rate gates on MVN at 65,536 replicas or chains; Geweke at the
   tuned multipliers and at a tuned ladder; the ``single_run --autotune
   --no_plots`` CLI in a process of its own, its JSON with JAX's keys
   (``smoke_out/single_run/``);
16. the warp kernels above 64 dimensions (``csrc/fused_pt_warp.cu``,
   ``csrc/fused_rwm_warp.cu``, a team of G lanes a replica, each library
   holding the team sizes of ``_build.WARP_TEAMS``): (a) built with the
   rest in phase 2, every target kind in both warp buckets (d = 100 and
   200) and the full-covariance MVN under UniformRadius (no stack frame,
   no spill in any team size; registers, the team size the geometry
   picks and blocks per SM); (b) every warp library held against its
   plain version at every team size it holds (phase 3's checks) at
   d = 100 on every target kind, RWM and PT (T = 10, both sweeps),
   Laplace and UniformRadius and the five draws on the iso MVN,
   recorded, and at the buckets' edges d = 65, 124, 125, 252 (1000
   replicas, ragged; Box-Muller at the odd 65); (c) Geweke at d = 100 on
   the iso MVN and IIDGamma's exact tempered law; (d) the reference's
   d = 100 RWM campaigns (``data/ref_averaged``) through ``run_rwm_fused``
   under the JAX parity protocol, max z <= 4 on the MVN under Laplace and
   UniformRadius and IIDGamma, Hypercube printed, s a point beside the
   JAX run's (a TPU time, ``data/parity_r2``); (e) ``MCMCSimulation``
   RWM and PT (``engine='auto'``), ``experiment_rwm``, ``single_run``
   and an autotuned PT run at d = 100, each launching only ``.w128``
   libraries; (f) each warp kernel at the main shape (d = 100,
   FullRosenbrock and the iso MVN, 65,536 replicas x T = 10 or chains,
   2000 steps) beside its bound and the eager engine, with the team size
   the geometry picks, the exact draws at d = 100, and for the record the
   warp kernels beside the thread kernels at d = 30 and at the RWM study's
   d = 20 (``scripts/bench_torch_warp.py`` times every team size, and an
   earlier tree, at these shapes).  Output under ``smoke_out/warp/``;
17. SuperFunnel (kernel kind 12, the hierarchical logistic regression on
   the reference's synthetic dataset, drawn from JAX's threefry streams
   under seed 42): (a) every SuperFunnel library held against its plain
   version from the default init (most states start at -inf): the thread
   kernels built for the dataset's shape at J = 5, K = 3, n = 20 (d = 26,
   .j5k3n20u2b3.d32 and .j5k3n20u4b1.d32; 2048 replicas or chains, 200
   steps; the run-time-shape
   library .d32 too, Normal) and, Normal only, at d = 8, 14 and 46, the
   team kernels built for the dataset's shape at J = 10, K = 5 (d = 68,
   .j10k5n20u2.w128 and .j10k5n20u4.w128) and J = 40, K = 3 (d = 166, .w256) at every team
   size (50 steps), each beside the run-time-shape team library on the
   same inputs (equal bit for bit), PT on the geometric ladder (T = 8)
   and RWM, the Normal proposal with the rule's draw, Laplace,
   UniformRadius and PT recorded; every fixed-shape build on every
   replica, lp rel diff 0; the MUFU and the instructions an observation
   of the thread and the team forms from ``cuobjdump -sass``; (b) the
   main paths through ``MCMCSimulation(target_dist="SuperFunnel")``, RWM
   at 65,536 chains and PT at 65,536 replicas x T = 8, 2000 steps, swap
   every 100, launch counters zeroed just before and read just after,
   best of 3 through the entry point, routed to the fixed-shape builds;
   the run-time-shape library's entry point at n = 50 (a dataset too
   large for the fixed builds; 4096 replicas x T = 8 or chains, 200
   steps); each kernel alone at its path's size (the thread kernels' main
   path over HOLD_STEPS of its steps), held against its plain
   version there on every replica (counters equal, lp rel diff 0), and
   beside the fixed-shape builds, as a side record, the run-time-shape
   library on their inputs (equal bit for bit); the plain version's run
   counts the
   log-densities with valid taus (the only ones whose likelihood the
   kernels compute) for the bound (float32, int32 or MUFU); the team
   kernels through the entry point at d = 68 and 166 (the fixed-shape
   team builds) at 65,536 chains and 16,384 replicas x T = 8, 50 steps,
   their launches counted there and the kernels timed and held alike at
   that size (with the run-time team library's side record), and as a
   side line outside the kernels record at the full width, 65,536
   replicas x T = 8 or chains, 2000 steps, timed against the bound if
   every log-density were valid; the run-time team library's own entry point at datasets over
   the team kernels' shared memory (J = 10, K = 5, n = 210; J = 40,
   K = 3, n = 80; 4096, 50 steps), timed and held there; fused
   against eager at 4096 (per-rung MH and swap acceptance, z < 5; no
   direct sampler, so no Geweke gate); (c) ``experiment_rwm --target
   SuperFunnel`` at ``launch_rwm_pod.sh``'s shape (Normal, 1024 chains,
   200,000 iterations, burn-in 1000), ``SF_STUDY_CONFIGS`` (2) of the CLI's 40 configs, s a
   config and the JAX study's JSON keys (``smoke_out/super_funnel/``);
   (d) a PT run with ``autotune_ladder=True``: the tuner, then one fused
   launch.

18. the one-launch iterative ladder builder (``csrc/ladder_build.cu``,
   ``construct_iterative_ladder_device``; A10): (a) every kind with a
   direct sampler at d = 10 (the iso MVN at d = 100 too): its main path
   through ``MCMCSimulation(iterative_temp_spacing=True)`` with the launch
   counted (the count of the kernels line), then the kernel against its
   plain version at N = 20,000, tolerance 0.01 and the harness's room
   (the same T and probes, betas to rtol 1e-5, the swap estimates
   non-finite at the same probes and some finite, to rtol 1e-5 up to the
   first that differs), timed beside its bound; (b) the PT
   study's ladders (``PT_STUDY``'s configs) at ``experiment_pt``'s
   defaults and room (N =
   50,000, tolerance 5e-4, 500 pn steps, fail factor 1.5): the host loop
   against the kernel, seconds each, the ladders equal; (c) one
   production build (``launch_pt_pod.sh:27-30``: N = 10^6, tolerance
   1e-4, 1000 pn steps, fail factor 1, phase 13's shape): seconds,
   probes, us a probe against its bound, held against its plain version
   (the host loop's search; the same T and probes, betas to rtol 1e-5),
   whose us a probe are given over all its probes and its first 50; (d)
   the ``demo`` CLI on the card (2000 iterations, no plots), the
   profiling helpers on a fused run, and the eager engines' options
   (CPU semantics, ``symmetric=False``, ``progress_every``, float64).
19. the sharded fused runs (``kernels/fused_sharded.py``, B9) over meshes
   (``parallel/mesh.py``, A13) of virtual shards on ``cuda:0``, launch
   counters zeroed just before and read just after each sharded run: (a)
   chains-sharded on 1, 2 and 4 shards, each equal bit for bit (x, lp,
   every counter and sum) to the unsharded run: the flagship PT, the RWM
   headline, d = 100 PT and RWM (the team kernels, the G the unsharded
   launch picks), d = 500 PT and RWM (the 512 bucket, 4096, 200 steps)
   and SuperFunnel's fixed thread builds (PT T = 8 and RWM, 65,536, 200
   steps); (b) the temps-sharded hybrid at the flagship shape
   on ``temps`` meshes of 2, 5 and 10 shards and a ``chains`` x ``temps``
   mesh of 2 x 5: x, lp, MH and swap counts equal bit for bit across the
   four partitions, held against ``run_pt_fused(swap_sweep="even_odd")``
   by ``kernels/agreement.py``'s gate (its cold-jump sum, whose MH and
   swap moves the hybrid sums apart, printed beside), the swap acceptance
   within 0.05 of it; (c) ``MCMCSimulation(use_mesh=True)`` PT and RWM at
   the flagship and headline shapes and ``experiment_rwm --use_mesh`` at
   the study's shape (2 configs) on the card's mesh, equal to the runs
   without the mesh (the study's JSON under ``smoke_out/mesh/``); each
   sharded run's ms and MH steps/s beside the unsharded run's, with its
   launches and swap events; (d) each sharded entry point (4 shards; the
   hybrid on 5 temps shards) held against its plain version (every
   shard's plain version on the card) over ``HOLD_STEPS`` steps at the main path's
   shapes, as phase 6 holds the kernels, and timed beside its bound: the
   kernel's bound for the same work plus the swap events' bytes.
20. the wide warp buckets (252 < d <= 1020, A15's remainder: ``.w512``,
   d + 4 <= 512 slots, and ``.w1024``, teams of G = 16 and 32 lanes; the
   ladder kernel's ``.d512`` and ``.d1024``): (a) built with the rest in
   phase 2, every kind at d = 500 and the kinds (b) holds at d = 1000 with
   the rule's draw, the full MVN under UniformRadius, the iso MVN under
   Laplace and UniformRadius,
   every draw at d = 500, Box-Muller at the odd edges, SuperFunnel built
   for its dataset's shape at J = 100, K = 3, n = 20 (d = 406), the ladder
   libraries (no stack frame, no spill; the full MVN ladder's local array
   stated); (b) every such library held against its plain version at
   every team size that takes the launch (phase 3's checks): every kind at
   d = 500 and the iso MVN, FullRosenbrock and IIDGamma at d = 1000 (PT
   T = 10 on 256 replicas, RWM 512 chains, 30 steps), the proposals, the
   draws, recorded, PT on the most rungs one block holds (``block_rungs``)
   and an even/odd sweep, the edges d = 253, 508, 509, 1020 (1000, ragged;
   Box-Muller at the odd ones), SuperFunnel at d = 406 equal bit for bit to
   its run-time-shape library; (c) Geweke at d = 500 on the iso MVN; (d)
   the main shapes at full width, FullRosenbrock and the iso MVN at d = 500
   and 1000 through ``run_pt_fused`` (65,536 replicas x T = 10) and
   ``run_rwm_fused`` (65,536 chains), 2000 steps, one call, the
   first's launches counted, beside the bound, the team the geometry picked,
   each kernel held against its plain version at that shape over 5 steps,
   the eager engine's ms a step; (e) ``MCMCSimulation`` RWM and PT at
   d = 1000,
   ``experiment_rwm --dim 1000`` (``smoke_out/wide/``), the ladder kernel's
   main path (``MCMCSimulation(iterative_temp_spacing=True)`` at d = 1000)
   and the kernel against its plain version for every kind with a direct
   sampler at d = 500 (N = 3000; NealFunnel at sigma_v^2 = 0.01, whose
   swap estimates stay finite, and shown at its default 9, where they are
   NaN) and the iso MVN at d = 1000 (N = 20,000), the swap estimates
   finite at the same probes (the refusal above the last bucket is
   phase 22e's);
   (f) the RWM acceptance on the iso MVN at d = 1000, from the target's
   init and from exact draws, beside 0.234.
21. ladders of more than 32 rungs (A17): the thread kernel's runtime-R
   instantiation up to its one-block fit, the team kernels in one block
   where it holds the ladder, else their cluster build (``.c512``,
   ``.c1024``: a replica's rung-teams over a thread-block cluster, built
   in phase 2); (a) the iso MVN at T = 33, 50 and 64 at d = 30, 100, 500
   and 1000 (1024 replicas, 30 steps, a swap every 3) in both sweep
   orders, Laplace and UniformRadius at d = 500, and the 128 and 256
   buckets' cluster builds at 256 replicas, each against its plain
   version (agreement.py: at least 99.6 % of replicas, counters exact),
   launches under the library the geometry picks; (b) the cluster build
   forced over 2 and 4 blocks equal bit for bit to the one-block build
   (d = 500, T = 32 and d = 1000, T = 26 at G = 16, recorded, both
   orders), and ``run_pt_fused_sharded`` at d = 500, T = 50 on 1, 2 and 4
   virtual shards equal bit for bit to the unsharded run; (c) Geweke at
   T = 40 on the iso MVN at d = 10 (the thread kernel) and d = 300 (the
   cluster build); (d) ``run_pt_fused`` at 65,536 replicas, T = 50 at
   d = 30 and 100 (2000 steps), T = 36 at d = 500 and 50 at d = 1000 (200
   steps), beside the bound, its launches counted, and G = 16 against
   G = 32 forced in turns at d = 1000 (T = 50, 20); (e)
   ``MCMCSimulation(iterative_temp_spacing=True)`` on the iso MVN at
   d = 500 and 1000 down to beta_min 0.01 at 65,536 replicas, 100
   iterations, engine ``pallas``, the rungs its ladder took, its ms a step
   beside the eager engine's on the same ladder (16,384 replicas, 30
   steps).

22. the widest warp buckets (1020 < d <= 4092, A15's remainder:
   ``.w2048``, ``.w4096``, teams of one, two and four warps a state, and
   PT's cluster builds ``.c2048``, ``.c4096``; the ladder kernel's ``.d2048`` and ``.d4096``,
   the full MVN's ladder in its warp form above the 16 bucket), built in
   phase 2 with the ladder libraries' gate on every bucket: (a) each
   library held against its plain version with the layout the geometry
   takes (at least 99.6 % of replicas agree, counters exact): every kind
   but SuperFunnel at d = 2000, the iso MVN, FullRosenbrock, IIDGamma and
   the full MVN at d = 4092 (PT T = 10 on 128 replicas, RWM 256 chains,
   20 steps), the proposals, every normal draw, recording and the
   even/odd sweep at d = 2000, each bucket's most rungs by
   ``rungs_fit`` over the cluster build, the edges d = 1021, 2044, 2045,
   4092 (Box-Muller at the odd ones), SuperFunnel at J = 300, K = 3,
   n = 20 (d = 1206, the run-time-shape library), and the chains-sharded
   runs at d = 2000 on 1, 2 and 4 virtual shards bit for bit, at the
   team the unsharded run takes; (b) Geweke
   at d = 2000 on the iso MVN (the cold and the hottest of six rungs);
   (c) the main shapes, FullRosenbrock and the
   iso MVN at d = 2000 and 4000 through ``run_pt_fused`` (65,536 replicas
   x T = 10) and ``run_rwm_fused`` (65,536 chains), 200 steps, and
   IIDGamma's PT and RWM at d = 2000 (its terms row in L2: PT one block
   at G = 64, RWM 14 chains a block at G = 32, ``_build.SERIAL_LP_KINDS``),
   each once
   with its launches counted, beside the bound, the team, blocks a
   cluster and warps an SM, each record held against its plain version at
   4096 replicas (512 for IIDGamma's) over 20 steps; (d) ``MCMCSimulation``
   RWM and PT at d = 2000 and PT at 4000, recorded, ``experiment_rwm
   --dim 2000`` (``smoke_out/wider/``) and
   ``MCMCSimulation(iterative_temp_spacing=True)`` at d = 2000 down to
   beta_min 0.01 on the fused path; (e) the ladder kernel, one build each
   through ``construct_iterative_ladder_device`` (its launch counted), then
   held against its plain version: the full MVN at d = 500 (phase 20e's
   case, 6,583.497 ms in the earlier one-lane form) and 2000, the iso MVN at d = 2000
   and 4000 (N = 3000, beta_min 0.3, tolerance 0.05), no local memory, and
   d = 4093 refused with ``NotImplementedError``; (f) the RWM acceptance
   on the iso MVN at d = 2000 and 4000 from exact draws, within
   ``WIDER_RATE_TOL`` of the limit 0.234; (g) PT's and RWM's wide teams
   (G = 64 at d = 2000, 64 and 128 at 4000) and G = 32 forced in turn,
   each against its plain version and twice bit for bit, and IIDGamma,
   IIDBeta and NealFunnel (index-order sums) bit for bit G = 32's under
   the Normal and Laplace proposals (RWM on 1000 chains: blocks of
   several teams and a ragged edge).  Phase 21d adds the
   cluster build's swap step split by its measuring build's stamps
   (``fused_pt.swap_split``).

The line before the last holds the kernels' JSON record (every variant),
the last line ``{"ok": true, "device": {...}}``.
"""
import json
import math
import os
import re
import subprocess
import sys
import threading
import time
from collections import Counter

HERE = os.path.dirname(os.path.abspath(__file__))

# H100 SXM published peaks: f32 outside the tensor cores and HBM bandwidth
# (NVIDIA's data sheet), and int32: 64 INT32 results a clock an SM (the
# Hopper architecture white paper) x 132 SMs x 1.98 GHz, the clock the data
# sheet's 67 TFLOP/s f32 implies (128 FP32 lanes an SM, 2 flops an FMA)
PEAK_F32_FLOPS = 67e12
PEAK_HBM_BYTES = 3.35e12
PEAK_INT32_OPS = 64 * 132 * 1.98e9
# the special-function units (MUFU: ex2, lg2, rcp, rsqrt, sin, cos): 16
# results a clock an SM (the Hopper architecture white paper) at that clock
PEAK_MUFU_OPS = 16 * 132 * 1.98e9
AGREE_MIN = 0.95       # share of replicas whose final x must agree
# nvcc processes at a time building the warp libraries behind phases 3-15
# (of the card machine's 8 cores; all 208 at once doubled phases 7-10's
# time)
BACKGROUND_NVCC = 6
Z_RATE_MAX = 5.0       # counters' rates, kernel vs plain
Z_INV_MAX = 5.0        # Geweke invariance bound (scripts/tpu_smoke.py)
HOLD_STEPS = 100       # steps of the kernel-vs-plain run at main-path shapes

# bench.py:63-95, the flagship PT workload
FLAG = dict(dim=30, T=10, C=65536, iters=2000, swap_every=100,
            base_variance=0.5 ** 2 / 30)
# scripts/bench_rwm_impl_block.py, the headline RWM workload
RWM_MAIN = dict(dim=30, C=65536, iters=2000, base_variance=0.5 ** 2 / 30)
# scripts/launch_rwm_pod.sh:29-34, the RWM proposal study on its default
# target
STUDY = dict(target="RoughCarpetScaled", dim=20, iters=200000, burn_in=1000,
             C=1024, var_max=4.0, seed=1)
# of the CLI's 40 scale configs per proposal: a config's time does not
# depend on its scale, and a quarter of them keeps the smoke's time
STUDY_CONFIGS = 5
REC_CHAINS = 4         # replicas recorded by the harness runs (phase 9)
REC_HOLD_CHAINS = 1024  # replicas recorded by the held runs (phase 7)
NEW_PROPOSALS = ("Laplace", "UniformRadius")
# scripts/launch_pt_pod.sh, the PT swap-rate study
PT_STUDY = dict(target="ThreeMixture", dim=10, iters=200000, burn_in=1000,
                C=1024, swap_accept_max=0.5, N=1000000, tol=1e-4, pn=1000,
                fail=1.0, seed=1, configs=10)   # 10 of the pod's 30
BM_STUDY_STEPS = 20000  # steps of the ICDF vs Box-Muller timing at the
#                         RWM study's shape (a config runs 201,000)
# phase 11: target kind -> (registry name, kwargs at the held d=10, kwargs
# at the flagship d=30, Normal variance times d)
KINDS = {
    "mvn_full": ("MultivariateNormal", "cov", "cov", 1.5 * 2.38 ** 2),
    "scaled_mvn": ("MultivariateNormalScaled", {}, {}, 0.25 * 2.38 ** 2),
    "three_mixture": ("ThreeMixtureScaled", {}, {}, 2.38 ** 2),
    "rough_carpet": ("RoughCarpetScaled", {}, {}, 0.25 * 2.38 ** 2),
    "even_rosenbrock": ("EvenRosenbrock", {}, {}, 0.5 ** 2),
    "hybrid_rosenbrock": ("HybridRosenbrock", {"n1": 4, "n2": 3},
                          {"n1": 3, "n2": 14}, 0.03),
    "hypercube": ("Hypercube", {}, {}, 2.38 ** 2 / 3),
    "iid_gamma": ("IIDGamma", {}, {}, 18 * 2.38 ** 2),
    "iid_beta": ("IIDBeta", {}, {}, 0.04 * 2.38 ** 2),
    "neal_funnel": ("NealFunnel", {}, {}, 2.38 ** 2),
}
GEWEKE_KINDS = {"three_mixture": "ThreeMixture", "rough_carpet": "RoughCarpet",
                "iid_gamma": "IIDGamma", "neal_funnel": "NealFunnel",
                "mvn_full": "MultivariateNormal"}
# kinds whose tempered direct sampler (the JAX package's) is exact at
# beta = 1 only: a mixture of tempered components is not the tempered
# mixture (IIDGamma's Gamma(shape beta, scale) is not Gamma^beta either; its
# gate draws the exact law, tempered_gamma)
INEXACT_TEMPERED = ("three_mixture", "rough_carpet")
# phase 12: the exact normal draws the rule chooses among, and their times
# at each shape of draw_shapes (ms, best of 3)
EXACT_DRAWS = ("icdf", "bm", "icdf_fastlog", "lax_erfinv")
DRAW_TIMES = {}
# phase 14, the draw study (scripts/bench_normal_impl.py on the card)
STUDY_DRAWS = ("icdf_fastlog", "lax_erfinv", "fake_uniform")
DRAW_SITES = {"icdf_fastlog": "rwm_pt_tpu/kernels/pallas_rwm.py:119",
              "lax_erfinv": "rwm_pt_tpu/kernels/pallas_rwm.py:146",
              "fake_uniform": "rwm_pt_tpu/kernels/pallas_rwm.py:152"}
PROBE_N = 1 << 20      # tests/test_pallas_kernels.py:395
PROBE_BW_N = 1 << 24   # the probes' bandwidth shape: 64 MiB of normals
#                        written, 128 MiB through fast_log, above the 50 MB L2
GRAPH_LAUNCHES = 100   # launches a CUDA graph holds for device us a launch
HOST_CALLS = 1000      # calls a host-clock loop times for host us a call
PROBE_SOURCE = "rwm_pt_tpu_torch/kernels/csrc/draw_probes.cu"
# phase 15, autotuning: burn-in, window, measured steps, the mis-scale of
# the Normal variance, and tests/test_adaptive.py's near-optimal MVN d=10
# variance
TUNE = dict(burn_in=3000, every=100, iters=2000, mis=1 / 100)
OPT_VAR = 2.38 ** 2 / 10
# phase 16, the warp kernels above 64 dimensions: the d of the reference's
# campaigns, the buckets' edges, HybridRosenbrock's blocks at d = 100
# (d = 1 + n2 (n1 - 1)), the holds' shape, the main shape's held steps (its
# plain version takes ~0.1 s a step), the eager engine's timed steps
WARP_D = 100
WARP_D_256 = 200   # a d of the 256 bucket, whose libraries phase 2 builds
WARP_EDGES = (65, 124, 125, 252)
WARP_KW = {"hybrid_rosenbrock": {"n1": 4, "n2": 33}}
WARP_HOLD = dict(steps=100, burn_in=20, swap_every=10, T=10, C_pt=512,
                 C_rwm=1024)
WARP_MAIN_HOLD_STEPS = 50
EAGER_STEPS = 20
# the reference's d = 100 RWM campaigns (scripts/run_parity_matrix.sh:32,
# 36-37, 39-40; data/ref_averaged/) under the JAX parity protocol
# (scripts/parity_vs_reference.py:38-53, 95-140): every second scale of the
# reference's grid, 512 chains, burn-in 1000, the reference's iterations;
# gated: max z <= 4 of |acc - ref| / the reference's single-seed spread
# (:398-405); Hypercube printed only (the JAX run's own z is 6.0)
CAMPAIGNS = (("MultivariateNormal", "Laplace", 100000, True),
             ("MultivariateNormal", "UniformRadius", 100000, True),
             ("IIDGamma", "Normal", 100000, True),
             ("Hypercube", "Normal", 200000, False))
CAMPAIGN = dict(chains=512, burn_in=1000, stride=2, z_max=4.0)
# phase 17, SuperFunnel (kind 12): the reference's dataset (J, K, n; seed
# 42: d = 26, the .d32 bucket), a shape in each other thread bucket (d = 8,
# 14, 46) and the team kernels' two shapes (d = 68 in .w128, 166 in .w256),
# the holds' sizes, the main paths (the RWM headline's and the flagship's
# sizes on the geometric ladder, T = 8; the kernels alone are held there
# too, their plain version taking ~9-13 ms a step), the team kernels'
# entry-point shape (where they are timed and held), fused against eager, the study's configs (of the CLI's 40)
# and the ladder tuner's run; a Normal variance of 0.01 (the RWM
# headline's acceptance on it is ~0.1)
SF = dict(J=5, K=3, n=20)
# observations a group of the dataset that the run-time-shape library
# takes at the reference's J and K (1010 packed words, over the fixed-shape
# builds' 896): phase 17b drives it through the entry point at
# SF_RUN_TIME_PATH's size, where its kernels are timed and held
SF_RUN_TIME_N = 50
SF_RUN_TIME_PATH = dict(C=4096, iters=200)
# the team kernels' likewise: datasets of the team shapes' J and K whose
# padded words (12,632 and 12,972) exceed the shared memory's 12,288 take
# the run-time team library, driven and held at SF_TEAM_RUN_TIME_PATH
SF_TEAM_RUN_TIME = ((10, 5, 210), (40, 3, 80))
SF_TEAM_RUN_TIME_PATH = dict(C=4096, iters=50)
SF_THREAD_EDGES = ((2, 1), (3, 2), (10, 3))
SF_WARP = ((10, 5), (40, 3))
SF_HOLD = dict(C=2048, steps=200, edge_steps=50, warp_steps=50,
               warp_C_pt=512, warp_C_rwm=1024, burn_in=20, swap_every=10)
SF_VAR = 0.01
SF_MAIN = dict(C=65536, iters=2000, swap_every=100)
SF_TEAM_TIME = dict(C_pt=16384, C_rwm=65536, steps=50)
SF_EAGER = dict(C=4096, iters=1000, burn_in=500, swap_every=100)
SF_STUDY_CONFIGS = 2
SF_TUNE = dict(C=4096, burn_in=1000, iters=2000)
# the keys of the JAX study's JSON (rwm_pt_tpu/cli/experiment_rwm.py:99-115)
SF_STUDY_KEYS = {"target_distribution", "proposal_distribution", "dimension",
                 "num_iterations", "seed", "total_time", "max_esjd",
                 "max_acceptance_rate", "max_scale_param",
                 "expected_squared_jump_distances", "acceptance_rates",
                 "scale_param_range", "times", "num_chains", "backend",
                 "mh_steps_per_sec"}
# the keys of the JAX single_run's JSON for an autotuned RWM run
# (rwm_pt_tpu/cli/single_run.py:55-84)
SINGLE_RUN_KEYS = {"target_distribution", "proposal_distribution",
                   "algorithm", "dimension", "num_iterations", "scale_param",
                   "seed", "total_time", "acceptance_rate", "esjd",
                   "num_chains", "autotune_target", "tuned_scale_multiplier",
                   "tuned_proposal_config"}


# phase 18, the ladder builder: the kinds with a direct sampler at the held
# d = 10 (registry name, kwargs; "cov": phase 11's covariance), the study's
# ThreeMixture (pt_gpu) for its kind, the d of the wide bucket's hold, the
# held build, the study's defaults (rwm_pt_tpu_torch/cli/experiment_pt.py
# run_study) and the production build (scripts/launch_pt_pod.sh:27-30)
LADDER_KINDS = {
    "mvn_iso": ("MultivariateNormal", {}),
    "mvn_full": ("MultivariateNormal", "cov"),
    "scaled_mvn": ("MultivariateNormalScaled", {}),
    "three_mixture": ("ThreeMixture", {"variant": "pt_gpu"}),
    "rough_carpet": ("RoughCarpetScaled", {}),
    "even_rosenbrock": ("EvenRosenbrock", {}),
    "hybrid_rosenbrock": ("HybridRosenbrock", {"n1": 4, "n2": 3}),
    "hypercube": ("Hypercube", {}),
    "iid_gamma": ("IIDGamma", {}),
    "iid_beta": ("IIDBeta", {}),
    "neal_funnel": ("NealFunnel", {}),
}
LADDER_D, LADDER_WIDE_D = 10, 100
LADDER_HOLD = dict(N_samples_swap_est=20000, tolerance=0.01, seed=1)
LADDER_STUDY = dict(N_samples_swap_est=50000, tolerance=0.0005,
                    max_pn_adjustment_steps=500,
                    convergence_failure_tolerance_factor=1.5)
LADDER_PROD = dict(N_samples_swap_est=1000000, tolerance=1e-4,
                   max_pn_adjustment_steps=1000,
                   convergence_failure_tolerance_factor=1.0, seed=1)
LADDER_HOST_PROBES = 50   # the host loop's first probes, timed alone
LADDER_HARNESS_N = 3000   # MCMCSimulation's N_samples_swap_est
# phase 19, the sharded runs: the chains meshes' shard counts, the temps
# meshes (axis sizes, names), SuperFunnel's steps, the held runs' shards
# and swap interval, the RWM study's configs with and without the mesh
SHARD_COUNTS = (1, 2, 4)
TEMP_MESHES = (((2,), ("temps",)), ((5,), ("temps",)), ((10,), ("temps",)),
               ((2, 5), ("chains", "temps")))
SHARD_SF_STEPS = 200
SHARD_HOLD = dict(shards=4, temps=5, swap_every=10)
# the hybrid at d = WARP_D (the team kernels): its temps meshes, steps and
# swap interval
SHARD_WIDE_TEMPS = (5, 10)
SHARD_WIDE = dict(steps=200, swap_every=20)
SHARD_STUDY_CONFIGS = 2


# phase 20, the wide warp buckets (252 < d <= 1020, A15's remainder): a d
# of each (the 512 bucket's 500, the 1024 bucket's 1000), the buckets'
# edges, HybridRosenbrock's blocks at those d (d = 1 + n2 (n1 - 1)), the
# kinds held at d = 1000, the holds' shape, SuperFunnel's shape in the 512
# bucket (d = 406), the main shapes' held steps (the plain version's step
# at 65,536 x 10 x 1000 floats is the slow part), the study's configs, the
# ladder's holds (samples a side: the harness's N at d = 500, at a
# beta_min and tolerance that keep the rungs and probes (and the plain
# version's time) few, and N = 20,000 at phase 18's tolerance for the iso
# MVN at d = 1000, down to a beta_min of 0.2, so that its ladder fits the
# fused kernel's 26 rungs, which down to 0.01 it does not; NealFunnel at
# sigma_v^2 = 0.01: the tempered funnel's v has mean (1 - beta)(d - 1)
# sigma_v^2 / (2 beta), ~3700 at d = 500, sigma_v^2 = 9 and the search's
# first probe beta* = 0.378, where exp(v) overflows float32 and every swap
# estimate is NaN, in JAX's builder too; at 0.01 it is ~4) and the
# chains-sharded runs' shape
WIDE_D = (500, 1000)
WIDE_EDGES = (253, 508, 509, 1020)
WIDE_HYBRID = {500: {"n1": 2, "n2": 499}, 1000: {"n1": 4, "n2": 333},
               2000: {"n1": 2, "n2": 1999}}   # (2000: phase 22's)
WIDE_KINDS_1000 = ("mvn_iso", "rosenbrock", "iid_gamma")
WIDE_HOLD = dict(steps=30, burn_in=10, swap_every=10, T=10, C_pt=256,
                 C_rwm=512)
WIDE_SF = dict(J=100, K=3, n=20)
WIDE_MAIN_HOLD_STEPS = 5
WIDE_STUDY_CONFIGS = 3
WIDE_LADDER = dict(N=LADDER_HARNESS_N, N_wide=20000, beta_min=0.2,
                   held=dict(beta_min=0.3, tolerance=0.05),
                   kw={"neal_funnel": {"sigma_v_sq": 0.01}})
WIDE_SHARD = dict(C=4096, iters=200)


# phase 21, ladders of more than 32 rungs (A17): the rungs held and the d's
# they are held at (the thread kernel's 30, the 128 bucket's 100, the wide
# buckets' 500 and 1000), the holds' shape and gate (agreement.py: four
# replicas of 1024 may part ways by rounding; at T = 64 one of 256 did),
# the small grids' holds (d, T at 256 replicas: the 128 bucket's cluster
# build, which G = 32 takes at T = 50 where the grid fills no SM, and the
# 256 bucket's, which T = 80 needs at G = 8), the
# cluster build's bit-for-bit cases (d,
# T, team, blocks a cluster: ladders one block of that team holds), the
# chains-sharded case, Geweke's rungs (d, beta_min: swaps accepted; the
# rungs held, the cold one and every 13th: 4 x (2d + 1) statistics keep a
# true z of 5 rare at d = 300), the main shapes (d, T, steps at 65,536
# replicas: T = 36 and 50 are the iso MVN's iterative ladders down to 0.01
# at d = 500 and 1000, as phase 20e finds them), the team sizes forced (d, T),
# and the harness's iterations and the eager comparison's replicas and
# steps
RUNGS_T = (33, 50, 64)
RUNGS_D = (30, 100, 500, 1000)
RUNGS_HOLD = dict(C=1024, steps=30, burn_in=10, swap_every=3)
RUNGS_SMALL = ((100, 50), (200, 80))
RUNGS_AGREE_MIN = 0.996
RUNGS_SAME = ((500, 32, 16, (2, 4)), (1000, 26, 16, (2,)))
RUNGS_SHARD = dict(d=500, T=50, C=4096, iters=200)
RUNGS_GEWEKE = dict(T=40, d=((10, 0.01), (300, 0.5)), rungs=(0, 13, 26, 39))
RUNGS_MAIN = ((30, 50, 2000), (100, 50, 2000), (500, 36, 200),
              (1000, 50, 200))
RUNGS_TEAMS = ((1000, 50), (1000, 20))
RUNGS_TEAM_ITERS = 50
# the cluster build's swap-step split (its measuring build): d, T, the
# replicas, steps and swaps
RUNGS_SPLIT = dict(d=1000, T=50, C=16384, steps=100, swap_every=10)
RUNGS_HARNESS = dict(iters=100, eager_C=16384, eager_steps=30)


# phase 22, the widest warp buckets (1020 < d <= 4092, A15's remainder:
# ``.w2048``, ``.w4096`` and PT's ``.c2048``, ``.c4096``, G = 32; the
# ladder kernel's ``.d2048``, ``.d4096`` and the full MVN's warp form): the
# d of each bucket's main shape, the kinds held at d = 4092 (the full MVN
# among them; every kind but SuperFunnel at d = 2000; HybridRosenbrock's
# blocks at d = 2000 in WIDE_HYBRID), the edges, the holds' shape
# (PT T = 10 on 128 replicas, RWM 256 chains, 20 steps; the gate
# RUNGS_AGREE_MIN), SuperFunnel's dataset (d = 1206: the run-time-shape
# library, its dataset over the shared-memory budget), the main shapes'
# replicas, rungs and steps, the records' holds (4096 replicas, 20 steps:
# the plain version at the main shape would hold 10.5 GB of state at
# d = 4000 beside its copies), Geweke's rungs, the chains-sharded runs,
# the ladders' builds (N = 3000, beta_min 0.3 and tolerance 0.05: phase
# 20e's full-MVN case at d = 500), the study's configs, the harness's replicas
WIDER_D = (2000, 4000)
WIDER_KINDS_4092 = ("mvn_iso", "rosenbrock", "iid_gamma", "mvn_full")
WIDER_EDGES = (1021, 2044, 2045, 4092)
WIDER_HOLD = dict(steps=20, burn_in=5, swap_every=5, T=10, C_pt=128,
                  C_rwm=256)
# kinds held at AGREE_MIN, not RUNGS_AGREE_MIN: RoughCarpet's d logsumexp
# terms, summed in the butterfly's order, round ~1e-4 apart from the plain
# version's sum at d = 2000, so about one accept decision in 10^4 flips
# and its replica parts ways (2 of 128 PT replicas over 20 steps at
# T = 10 on an H100)
WIDER_AGREE = {"rough_carpet": AGREE_MIN}
WIDER_SF = dict(J=300, K=3, n=20)
WIDER_MAIN = dict(C=65536, T=10, iters=200)
WIDER_RECORD_HOLD = dict(C=4096, steps=20)
WIDER_GEWEKE = [0.9 ** (t / 5) for t in range(6)]
# the rungs Geweke holds at d = 2000, the cold and the hottest: 2 (2d + 1)
# statistics, so that a true z of 5 stays rare (all six gave 24,006, whose
# max reached 4.92 in one run)
WIDER_GEWEKE_RUNGS = (0, 5)
WIDER_SHARD = dict(d=2000, C=4096, iters=100)
WIDER_LADDER = dict(N_samples_swap_est=LADDER_HARNESS_N, beta_min=0.3,
                    tolerance=0.05, seed=1)
WIDER_STUDY_CONFIGS = 3
WIDER_HARNESS = dict(C=4096, iters=100)
# phase 22g: (d, kind, proposals) held at each team size of the library,
# and the kinds that sum their log-density in index order (bit for bit
# G = 32's at the wide teams)
WIDE_TEAMS_HELD = (
    (2000, "mvn_iso", ("Normal", "UniformRadius")),
    (2000, "rosenbrock", ("Normal",)),
    (2000, "iid_gamma", ("Normal", "Laplace")),
    (2000, "neal_funnel", ("Normal",)),
    (4000, "mvn_iso", ("Normal",)), (4000, "iid_beta", ("Normal",)))
INDEX_ORDER_KINDS = ("iid_gamma", "iid_beta", "neal_funnel")
# RWM's chains in 22g: blocks of 7 teams of 64 lanes at d = 2000 and 6 at
# 4000 (the geometry keeps a block a SM), the last one ragged
WIDE_TEAMS_RWM_C = 1000
# phase 22f: the RWM rate from exact draws at 2.38^2 / d against the
# d -> infinity limit 2 Phi(-1.19) (0.2344 +- 0.0002 at d = 2000, 0.2341 +-
# 0.0002 at 4000 on an H100; a wrong accept or jump moves it by far more)
WIDER_RATE_TOL = 0.002


def fail(msg):
    print(f"FAIL: {msg}", flush=True)
    sys.exit(1)


T_START = time.time()


def say(msg):
    print(f"[{time.time() - T_START:7.1f} s] {msg}", flush=True)


def cuda_ms(torch, fn, reps=1):
    """Best of ``reps`` CUDA-event timings of ``fn()`` in ms, and its last
    result."""
    best, out = math.inf, None
    for _ in range(reps):
        a = torch.cuda.Event(enable_timing=True)
        b = torch.cuda.Event(enable_timing=True)
        a.record()
        out = fn()
        b.record()
        torch.cuda.synchronize()
        best = min(best, a.elapsed_time(b))
    return best, out


def graph_us(torch, fn, launches=GRAPH_LAUNCHES, reps=5):
    """Device us per launch of ``fn()``: ``launches`` back-to-back calls
    captured in one CUDA graph (after a warm-up call on the capture's side
    stream), its replay timed with CUDA events, best of ``reps``, over
    ``launches``.  No host work between the launches is timed."""
    side = torch.cuda.Stream()
    side.wait_stream(torch.cuda.current_stream())
    with torch.cuda.stream(side):
        fn()
    torch.cuda.current_stream().wait_stream(side)
    g = torch.cuda.CUDAGraph()
    with torch.cuda.graph(g):
        for _ in range(launches):
            fn()
    g.replay()
    best = cuda_ms(torch, g.replay, reps)[0]
    del g
    return best * 1e3 / launches


def host_us(torch, fn, calls=HOST_CALLS):
    """Host us per call of ``fn()``: ``time.perf_counter_ns`` around
    ``calls`` calls, read before and after one ``torch.cuda.synchronize()``
    (enqueue, and enqueue until the card is done).  Returns both."""
    fn()
    torch.cuda.synchronize()
    t0 = time.perf_counter_ns()
    for _ in range(calls):
        fn()
    t1 = time.perf_counter_ns()
    torch.cuda.synchronize()
    t2 = time.perf_counter_ns()
    return (t1 - t0) / 1e3 / calls, (t2 - t0) / 1e3 / calls


def loop_us(fn, calls=HOST_CALLS):
    """Host us per call of ``fn()`` over ``calls`` calls (no synchronise)."""
    t0 = time.perf_counter_ns()
    for _ in range(calls):
        fn()
    return (time.perf_counter_ns() - t0) / 1e3 / calls


def kernel_and_library(torch, kernel, library, k_fast=None, l_fast=None):
    """(a), (b) and (c) of a probe ``kernel`` and its ``library`` call (or
    None), each measured kernel, library, library, kernel and the better
    of the two kept: device us per launch (:func:`graph_us`, through
    ``k_fast`` / ``l_fast``, the calls into preallocated outputs, where
    given), host us per call (:func:`host_us`: enqueue, and until the card
    is done) and the single-call event time in ms (:func:`cuda_ms`, best
    of 20, as the earlier single-call figures were taken)."""
    measures = (("device_us", lambda f, fast: graph_us(torch, fast or f)),
                ("host_us", lambda f, fast: host_us(torch, f)),
                ("single_ms", lambda f, fast: cuda_ms(torch, f, reps=20)[0]))
    fig = {}
    for key, measure in measures:
        k1 = measure(kernel, k_fast)
        lib = [measure(library, l_fast) for _ in range(2)] if library else []
        k2 = measure(kernel, k_fast)
        fig[key] = min(k1, k2)
        fig["library_" + key] = min(lib) if lib else None
    for who in ("", "library_"):
        h = fig[who + "host_us"]
        fig[who + "host_us"], fig[who + "host_sync_us"] = (
            (h[0], h[1]) if h else (None, None))
    return fig


def probe_work(probe, n, impl=None):
    """(float operations, int32 operations, bytes) of a probe on ``n``
    elements: ``draw_normals`` of draw ``impl`` writes n floats (two
    Philox blocks a column of 8), ``fast_log`` reads and writes n."""
    if probe == "draw_normals":
        return n * NORMAL_FLOPS[impl], n * PROBE_INT_OPS, 4 * n
    return FAST_LOG_FLOPS * n, FAST_LOG_INT_OPS * n, 8 * n


def probe_cases(torch, dp, draws, dev, seed, n, y):
    """Phase 14a's timed cases at one shape: ``draw_normals`` of every draw
    at ``n`` and ``fast_log`` on ``y``: name -> (kernel call, library call
    or None, the kernel into a preallocated output, the library into one,
    library label, work).  The library call is one PyTorch call for the
    same function: ``torch.randn`` for Box-Muller, Phi^-1 of the same
    uniforms for the ICDF-slot normals, ``torch.log``; the uniform probe
    has none."""
    buf = torch.empty((8, n // 8), device=dev)
    lbuf = torch.empty(n, device=dev)
    ybuf = torch.empty_like(y)
    u = draws.uniform_from_bits(draws.slot_words(
        draws.seed_key(seed), 1, 1, 8, n // 8, dev))[0]
    cases = {}
    for impl in draws.NORMAL_IMPLS:
        k = (lambda impl=impl:  # noqa: E731
             dp.draw_normals(impl, seed, n, device=dev))
        k_fast = (lambda impl=impl: dp.draw_normals(  # noqa
            impl, seed, n, device=dev, out=buf))
        if impl == "bm":
            lib = ("torch.randn", lambda: torch.randn(n, device=dev),
                   lambda: torch.randn(n, device=dev, out=lbuf))
        elif impl != "fake_uniform":
            icdf = lambda: draws.SQRT2 * torch.erfinv(  # noqa
                2.0 * u - 1.0 + 2.0 ** -24)
            lib = ("sqrt2*erfinv(2u-1+2^-24)", icdf, None)
        else:
            lib = (None, None, None)
        cases[f"draw_normals.{impl}"] = (k, lib[1], k_fast, lib[2], lib[0],
                                         probe_work("draw_normals", n, impl))
    cases["fast_log"] = (
        lambda: dp.fast_log(y), lambda: torch.log(y),
        lambda: dp.fast_log(y, out=ybuf),
        lambda: torch.log(y, out=ybuf), "torch.log",
        probe_work("fast_log", y.numel()))
    return cases


def probe_timings(torch, dp, draws, dev, seed, n, y, label, phase="14a"):
    """(a), (b), (c) of every probe case at one shape (:func:`probe_cases`),
    each beside its library call and its bound; one line a case.  Returns
    name -> figures."""
    out = {}
    for name, (k, lib, k_fast, l_fast, l_name, work) in probe_cases(
            torch, dp, draws, dev, seed, n, y).items():
        fig = kernel_and_library(torch, k, lib, k_fast, l_fast)
        b_ms, b_by, _ = bound(*work)
        fig.update(bound_us=b_ms * 1e3, bound_by=b_by, library=l_name,
                   n=work[2] // (4 if name.startswith("draw") else 8),
                   bound_share=b_ms * 1e3 / fig["device_us"])

        def pair(key, unit="us", f=fig):
            lv = f["library_" + key]
            return (f"{f[key]:.4f} {unit}" + ("" if lv is None else
                                              f" (library {lv:.4f})"))
        say(f"phase {phase} {label} {name} n={fig['n']}: device "
            f"{pair('device_us')} a launch over {GRAPH_LAUNCHES} in a CUDA "
            f"graph; host {pair('host_us')} a call over {HOST_CALLS} "
            f"(until done {pair('host_sync_us')}); single call "
            f"{pair('single_ms', 'ms')}; bound {fig['bound_us']:.4f} us by "
            f"{b_by}, {100 * fig['bound_share']:.1f} % of the device time"
            + ("" if l_name is None else f"; library {l_name}"))
        out[name] = fig
    torch.cuda.empty_cache()
    return out


def host_breakdown(torch, dp, dev, seed, n, y, phase="14a"):
    """The probes' host work a call, one piece at a time, each in a loop of
    its own (:func:`loop_us`): the pieces of the earlier launch path
    (``resolve_device``, ``_build.entry``,
    ``torch.cuda.current_stream(dev).cuda_stream``) beside those the
    wrapper takes (``draw_probes._device``, ``_cuda_getCurrentRawStream``),
    a whole call into ``out=``, the allocation, the key, the ctypes call
    that launches, ``check_launch``, the counter and the library calls
    whole.  Returns ``[(piece, us)]``."""
    from rwm_pt_tpu_torch.kernels import _build
    from rwm_pt_tpu_torch.kernels.draws import seed_key
    from rwm_pt_tpu_torch.utils.dtypes import resolve_device
    cols = n // 8
    buf = torch.empty((8, cols), device=dev)
    ybuf = torch.empty_like(y)
    k0, k1 = seed_key(seed)
    draw = _build.entry(_build.PROBES, "rwm_pt_draw_normals")
    flog = _build.entry(_build.PROBES, "rwm_pt_fast_log")
    idx = torch.cuda.current_device()
    stream = torch.cuda.current_stream(dev).cuda_stream
    code = _build.DRAWS["bm"][1]
    count = Counter()
    pieces = [
        ("device: resolve_device(dev)", lambda: resolve_device(dev)),
        ("device: resolve_device('cuda')", lambda: resolve_device("cuda")),
        ("device: draw_probes._device(dev)", lambda: dp._device(dev)),
        ("device: draw_probes._device('cuda')", lambda: dp._device("cuda")),
        ("whole call: draw_normals('bm', out=)", lambda: dp.draw_normals(
            "bm", seed, n, device=dev, out=buf)),
        ("whole call: fast_log(y, out=)", lambda: dp.fast_log(y, out=ybuf)),
        ("entry: _build.entry", lambda: _build.entry(
            _build.PROBES, "rwm_pt_draw_normals")),
        ("stream: torch.cuda.current_stream(dev).cuda_stream",
         lambda: torch.cuda.current_stream(dev).cuda_stream),
        ("stream: torch._C._cuda_getCurrentRawStream(index)",
         lambda: torch._C._cuda_getCurrentRawStream(idx)),
        ("torch.empty((8, n/8))", lambda: torch.empty(
            (8, cols), dtype=torch.float32, device=dev)),
        ("torch.empty(8, n/8)", lambda: torch.empty(
            8, cols, dtype=torch.float32, device=dev)),
        ("torch.empty_like(y)", lambda: torch.empty_like(y)),
        ("_build.check_cuda(y)", lambda: _build.check_cuda(
            "fast_log", torch.float32, y=y)),
        ("seed_key(seed)", lambda: seed_key(seed)),
        ("ctypes call: rwm_pt_draw_normals (launches bm)",
         lambda: draw(code, k0, k1, cols, buf.data_ptr(), stream)),
        ("ctypes call: rwm_pt_fast_log (launches)",
         lambda: flog(y.data_ptr(), ybuf.data_ptr(), y.numel(), stream)),
        ("check_launch(name, 0)", lambda: _build.check_launch("probe", 0)),
        ("counter: launches[key] += 1",
         lambda: count.__setitem__("bm", count["bm"] + 1)),
        ("torch.randn(n) (library, whole call)",
         lambda: torch.randn(n, device=dev)),
        ("torch.log(y) (library, whole call)", lambda: torch.log(y)),
    ]
    out = []
    for piece, fn in pieces:
        fn()
        torch.cuda.synchronize()
        us = loop_us(fn)
        torch.cuda.synchronize()
        out.append((piece, us))
    say(f"phase {phase} host breakdown a call (n={n}, y of {y.numel()}; "
        f"each piece alone, {HOST_CALLS} calls): "
        + "; ".join(f"{p} {us:.3f} us" for p, us in out))
    return out


# ---------------------------------------------------------------- op counts
# Float operations the fused kernels' function needs, counted from
# csrc/*.cuh (an FMA counts 2; logf, log1pf, sqrtf, expf, a division 1
# each; selects, sign and integer work 0):
#   ICDF normal: cvt+scale 2, 2u-1+2^-24 3, (1-x)(1+x) 3, fmax 1, logf 1,
#     neg 1, then one branch of Giles' polynomial: w-2.5 1 and 8 FMAs 16
#     (the tail branch, w >= 5, takes sqrtf-3 instead of w-2.5, one more
#     op on about 0.3% of draws, left out), x*p 1, sqrt2* 1 = 30;
#     Normal increment and proposal 2  -> 32 per coordinate.  The kernel
#     evaluates both polynomials and selects; the bound counts one.
#   Laplace per coordinate: cvt+scale 2, u-0.5 1, -2|v| 1, fmax 1,
#     log1pf 1, -scale*sign 1, product 1, proposal 1 -> 9.
#   UniformRadius: per coordinate the normal 30, square-accumulate 2,
#     divide by the norm 1, times the radius 1, proposal 1 -> 35; per step
#     sqrtf 1, fmax 1, radius cvt+scale 2, logf 1, *1/d 1, expf 1, *R 1 -> 8.
#   log-density (per kind, lp_flops; compares count 1, exp/log 1 each)
#   accept: lp' - lp, *beta, expf, cvt+scale of u, 2 compares -> 7
#   squared jump (cold rung / RWM chain) 3 d + Kahan 4
#   swap pair: 2 subs, mul, expf, compare, Kahan 5 -> 10
# Philox4x32-10 integer work: PHILOX_BLOCK_OPS int32 operations a block of
# 4 words, at PEAK_INT32_OPS; the bound is the largest of the float, int32
# and byte times.
#   Box-Muller pair (two normals): cvt+scale 2 x2, fmax 1, logf 1, -2* 1,
#     sqrtf 1, 2 pi u 1, sincosf 2, r cos, r sin 2 = 12 -> 6 a normal
#     (+ the proposal's 2: 8 per Normal coordinate instead of 32).
#   The draw study's normals (csrc/draws.cuh):
#     fast_log: compare 1, m*0.5 1, int->float 1, m-1 1, 8 products and 8
#       sums of the polynomial 16, f*f 1, f2*f 1, *p 1, 0.5*f2 1, three
#       adds 3, e*ln2 1 = 28;
#     icdf_fastlog normal: the ICDF normal's 30 with fast_log's 28 in place
#       of logf's 1, and (sqrt2 x) p as two products: 2+3+3+1+28+1+17+2 = 57;
#     lax_erfinv normal: CUDA's erfinvf counted as Giles' polynomial, as the
#       ICDF normal: 30;
#     fake_uniform: cvt+scale 2, u-0.5 1, *sqrt12 1 = 4 (not a normal).
NORMAL_FLOPS = {"icdf": 30, "bm": 6, "icdf_fastlog": 57, "lax_erfinv": 30,
                "fake_uniform": 4}
FAST_LOG_FLOPS = 28
FAST_LOG_INT_OPS = 6    # exponent shift, mask, -127, mantissa and/or, e + 1
# A Philox round per block: 2 high and 2 low 32-bit products and two
# three-input XORs (hi ^ c ^ k, one LOP3 each); the key schedule's two
# additions depend on the launch's key alone, not on the counter, so the
# compiler does them once a thread, not once a block: 10 rounds x 6
PHILOX_BLOCK_OPS = 60
# a probe normal: two Philox blocks a column of 8
PROBE_INT_OPS = 2 * PHILOX_BLOCK_OPS // 8


# SuperFunnel (kind 12; csrc/targets.cuh::super_funnel_log_density) at J
# groups, K covariates, n observations a group, in this convention:
#   an observation: eta's K products and K adds 2K; -|eta| 1, expf 1,
#     log1pf 1, -eta 1, fmax 1, + log1p 1, the sum's add 1 -> 2K + 7;
#   a group's sum into ll 1; the priors' squares: alpha (sub, mul, add) 3 J,
#     beta 3 J K, mu_beta (mul, add) 2 K; the two taus' validity 2 and the
#     closing formula (2 logf, 2 log1pf, 4 divisions, 9 products, 8
#     adds) 25 + 11 -> 38.
# At the reference's J = 5, K = 3, n = 20: 100 x 13 + 5 + 15 + 45 + 6 + 38
# = 1409 a log-density whose taus both exceed 1e-9; the kernels return -inf
# after the taus' test (2) on the others and compute none of the rest, so
# a run's work counts the likelihood on its valid evaluations alone
# (:func:`sf_counted`), whatever build computes it.  An observation's expf
# is one MUFU.EX2; CUDA's log1pf is a polynomial of FFMAs and takes none:
# SF_MUFU_PER_OBS = 1 (phase 17 reads the likelihood's SASS in the
# fixed-shape and the run-time-shape libraries, :func:`sf_sass`, and fails
# if it differs), which bound() counts for this kind alone at
# PEAK_MUFU_OPS.
SF_MUFU_PER_OBS = 1


def sf_lp_flops(J, K, n):
    return J * n * (2 * K + 7) + J + 3 * J + 3 * J * K + 2 * K + 38


def lp_flops(kind, d):
    """Float operations of one log-density of kind ``kind`` at d
    coordinates (not SuperFunnel's: :func:`lp_work`)."""
    return {
        "rosenbrock": 9 * (d - 1) + 1,
        "mvn_iso": 4 * d + 2,
        "mvn_full": 2 * d * d + 3 * d + 2,       # sub, d^2 FMA, d FMA
        "scaled_mvn": 3 * d + 2,
        "three_mixture": 10 * d + 22,            # s x, 3 (sub, FMA) a dim
        "rough_carpet": 27 * d + 1,              # 3 quadratics, 3 exp, log
        "even_rosenbrock": 9 * (d - 1) + 1,
        "hybrid_rosenbrock": 5 * (d - 1) + 5,
        "hypercube": 2 * d,
        "iid_gamma": 6 * d + 2,
        "iid_beta": 9 * d + 3,
        "neal_funnel": 3 * (d - 1) + 13,
    }[kind]


def lp_work(kind, d, evals, sf=None):
    """``(flops, MUFU instructions or None)`` of a run's ``evals``
    log-densities of kind ``kind``; SuperFunnel's (``sf = (J, K, n,
    valid)``) count the whole formula and its J n MUFU on the ``valid``
    evaluations whose taus both exceed 1e-9, the taus' test alone on the
    others."""
    if kind != "super_funnel":
        return evals * lp_flops(kind, d), None
    J, K, n, valid = sf
    return (valid * sf_lp_flops(J, K, n) + (evals - valid) * 2,
            valid * J * n * SF_MUFU_PER_OBS)


def inc_flops(prop, d, draw="icdf"):
    normal = NORMAL_FLOPS[draw]
    return {"Normal": (normal + 2) * d, "Laplace": 9 * d,
            "UniformRadius": (normal + 5) * d + 8}[prop]


def philox_blocks(prop, d, draw="icdf"):
    """Philox blocks a (replica, rung) draws per step: slots 0..d
    (UniformRadius: 0..d+2; Box-Muller with an odd d: 0..d+3)."""
    last = d + (2 if prop == "UniformRadius" else 0)
    if draw == "bm" and prop != "Laplace" and d % 2:
        last = d + 3
    return last // 4 + 1


def rec_bytes(d, steps, record_every, rec_chains):
    return (steps // record_every) * d * rec_chains * 4 if record_every else 0


def pt_work(kind, d, T, C, steps, burn_in, swap_every, step0=0,
            prop="Normal", record_every=0, rec_chains=0, draw="icdf",
            n_params=0, sf=None):
    """``(flops, Philox int32 ops, bytes, MUFU or None)`` of a fused PT
    run: T C (steps + 1) log-densities (:func:`lp_work`; SuperFunnel's
    ``sf = (J, K, n, valid)``)."""
    n_events = (step0 + steps) // swap_every - max(burn_in, step0) // swap_every
    lp, mufu = lp_work(kind, d, C * T * (steps + 1), sf)
    flops = (C * (steps * ((inc_flops(prop, d, draw) + 7) * T + 3 * d + 4)
                  + n_events * 10 * (T - 1)) + lp)
    blocks = C * T * steps * philox_blocks(prop, d, draw)
    int_ops = PHILOX_BLOCK_OPS * blocks
    nbytes = (C * (2 * d * T * 4 + T * 4 + 2 * T * 4 + 6 * 4)
              + (T * d * 4 if prop == "Laplace" else 0) + 4 * n_params
              + rec_bytes(d, steps, record_every, rec_chains))
    return flops, int_ops, nbytes, mufu


def rwm_work(kind, d, C, steps, prop="Normal", record_every=0, rec_chains=0,
             draw="icdf", n_params=0, sf=None):
    """``(flops, Philox int32 ops, bytes, MUFU or None)`` of a fused RWM
    run: C (steps + 1) log-densities (:func:`lp_work`)."""
    lp, mufu = lp_work(kind, d, C * (steps + 1), sf)
    flops = C * steps * (inc_flops(prop, d, draw) + 7 + 3 * d + 4) + lp
    int_ops = PHILOX_BLOCK_OPS * C * steps * philox_blocks(prop, d, draw)
    nbytes = (C * (2 * d * 4 + 4 + 2 * 4 + 2 * 4)
              + (d * 4 if prop == "Laplace" else 0) + 4 * n_params
              + rec_bytes(d, steps, record_every, rec_chains))
    return flops, int_ops, nbytes, mufu


def bound(flops, int_ops, nbytes, mufu=None):
    """The least time the card could take, in ms: the largest of the float
    operations at PEAK_F32_FLOPS, the int32 operations at PEAK_INT32_OPS,
    the bytes at PEAK_HBM_BYTES and, where given (SuperFunnel), the MUFU
    instructions at PEAK_MUFU_OPS.  Returns ``(ms, "operations" or
    "bytes", which limit: "float32", "int32", "mufu" or "bytes")``."""
    t = {"float32": flops / PEAK_F32_FLOPS * 1e3,
         "int32": int_ops / PEAK_INT32_OPS * 1e3,
         "bytes": nbytes / PEAK_HBM_BYTES * 1e3}
    if mufu is not None:
        t["mufu"] = mufu / PEAK_MUFU_OPS * 1e3
    limit = max(t, key=t.get)
    return t[limit], ("bytes" if limit == "bytes" else "operations"), limit


def rate_z(a, b, n):
    """z of two acceptance proportions over n trials each."""
    p = 0.5 * (a + b)
    se = math.sqrt(max(p * (1 - p), 1e-12) * 2 / n)
    return abs(a - b) / se


def hold_run(torch, what, launch, plain, args, kw, names):
    """Time ``launch(*args, **kw)`` (best of 3) and its plain version (once)
    and hold the two together with phase 3's checks; a disagreement fails
    the smoke.  Returns ``(kernel ms, plain ms, agreement)``."""
    from rwm_pt_tpu_torch.kernels import agreement
    ms, k = cuda_ms(torch, lambda: launch(*args, **kw), reps=3)
    plain_ms, p = cuda_ms(torch, lambda: plain(*args, **kw))
    ag = agreement.hold(k, p, names, lp_of=args[0].log_density_td)
    if ag.frac < AGREE_MIN or ag.mismatched:
        fail(f"{what} disagrees with its plain version: "
             f"{agreement.describe(ag)}")
    return ms, plain_ms, ag


def kernel_record(torch, name, source, replaces, launches, launch, plain,
                  names, case, iters, phase=6, hold_steps=HOLD_STEPS,
                  main=None):
    """Time kernel ``name`` alone at its main path's size (``iters`` steps,
    best of 3; ``main``: that time and its work, where the caller timed
    the main path itself), then over ``hold_steps`` steps at the main
    path's shapes time
    it again, time its plain version once, hold the two together
    (:func:`hold_run`) and set both kernel times beside their bounds.
    ``case(steps, hold)`` gives a launch's ``(args, kw, work)``, ``work``
    being :func:`pt_work`'s or :func:`rwm_work`'s; the held run
    (``hold=True``) may record more replicas or swap more often than the
    main path, so that the hold sees more.  ``ms``, ``plain_ms`` and
    ``bound_ms`` of the record are for the ``hold_steps`` run, the
    ``main_path_*`` keys for the main path's size."""
    from rwm_pt_tpu_torch.kernels import agreement
    if main is None:
        full_args, full_kw, full_work = case(iters, False)
        full_ms, _ = cuda_ms(torch, lambda: launch(*full_args, **full_kw),
                             reps=3)
        del full_args, _
    else:
        full_ms, full_work = main
    hold_args, hold_kw, work = case(hold_steps, True)
    flops, int_ops, nbytes, _ = work
    ms, plain_ms, ag = hold_run(torch, f"{name} at main-path shapes", launch,
                                plain, hold_args, hold_kw, names)
    b_ms, b_by, b_limit = bound(*work)
    full_flops, full_int, full_bytes, _ = full_work
    full_b_ms, _, full_by = bound(*full_work)
    say(f"phase {phase} {name} kernel: {full_ms:.3f} ms at its main path's "
        f"size, bound {full_b_ms:.3f} ms by {full_by} "
        f"({100 * full_b_ms / full_ms:.1f} % of it reached; {full_flops:.4g} "
        f"flops, {full_int:.4g} Philox int ops, {full_bytes:.4g} B); "
        f"{hold_steps} steps at main-path shapes: kernel {ms:.3f} ms, plain "
        f"{plain_ms:.1f} ms ({plain_ms / hold_steps:.3f} ms/step), bound "
        f"{b_ms:.3f} ms; {agreement.describe(ag)}")
    return dict(
        name=name, route="cuda", source=source, replaces=replaces,
        launches=launches, max_abs_err=ag.max_dx, ms=ms, plain_ms=plain_ms,
        bound_ms=b_ms, bound_by=b_by, library_ms=None, steps=hold_steps,
        agree_frac=ag.frac, max_rel_err=ag.max_rel, flops=flops,
        philox_int_ops=int_ops, bytes=nbytes, main_path_steps=iters,
        main_path_ms=full_ms, main_path_bound_ms=full_b_ms,
        bound_limit=b_limit, main_path_bound_limit=full_by,
        main_path_bound_share=full_b_ms / full_ms)


def reset_launches(*wrappers):
    for w in wrappers:
        w.launches.clear()


def read_launches(*wrappers, by_kind=False):
    """Launches per kernel variant (``fused_pt``, ``fused_rwm_laplace``,
    ..), or with ``by_kind`` per ``<variant>.<target kind>``, as the
    wrappers count them."""
    from rwm_pt_tpu_torch.kernels import _build
    out = Counter()
    for w in wrappers:
        out.update(w.launches)
    return out if by_kind else _build.by_variant(out)


def swap_ok(sw, betas):
    """Swap acceptance of an invariance run: above 0.02 on rungs that
    differ; on equal rungs every swap has log a = 0 and is accepted."""
    if betas is not None and len(set(betas)) == 1:
        return sw == 1.0
    return sw > 0.02


def tempered_gamma(tg):
    """Exact draws of an IIDGamma(k, theta) target tempered by beta:
    Gamma(beta (k - 1) + 1, theta / beta) per coordinate, as ``(n, d)``."""
    from rwm_pt_tpu_torch.targets.base import _draw_gamma

    def sample(n, beta, g):
        return _draw_gamma(beta * (tg.shape - 1) + 1, (n, tg.dim), g,
                           tg.device, tg.dtype) * (tg.scale / beta)
    return sample


def per_chain_z(a, b):
    """z of the difference of the means of two per-replica rate tensors
    (replicas independent)."""
    a, b = a.double().flatten(), b.double().flatten()
    se = math.sqrt(a.var().item() / a.numel() + b.var().item() / b.numel())
    return abs(a.mean().item() - b.mean().item()) / (se + 1e-12)


def invariance(torch, mvn, seed, n=4096, betas=None, exact=None, pt_kw=None,
               rungs=None, **sampler_kw):
    """Exact invariance (Geweke) of the fused samplers on the target
    ``mvn`` with a generator seeded ``seed``: RWM starts 4096 chains from
    exact draws and runs 50 steps, PT starts 4096 replicas from exact
    tempered draws on the rungs ``betas`` (default 6 rungs 1 .. 0.09) and
    runs 60 steps with a swap every 5; each ensemble is held against fresh
    exact draws (max z over the coordinates' first and second moments and
    the mean log-density).  ``exact(n, beta, generator)`` draws ``(n, d)``
    from the tempered target (default ``mvn.direct_sample``).
    ``sampler_kw`` is the proposal (``base_variance=`` or ``proposal=``),
    ``pt_kw`` more arguments of the PT run (``scale_multipliers=``),
    ``rungs`` the rungs held (default all).  Returns ``(max z RWM, max z PT
    over the rungs, PT swap acceptance)``."""
    from rwm_pt_tpu_torch.kernels import run_pt_fused, run_rwm_fused
    dev = torch.device("cuda")
    g = torch.Generator(device=dev)
    g.manual_seed(seed)

    def max_z(ev, fresh):
        def stats(x):
            f = torch.cat([x, x * x, mvn.log_density_td(x)[None]], dim=0)
            return f.mean(1), f.var(1, unbiased=False)
        m1, v1 = stats(ev)
        m2, v2 = stats(fresh)
        return ((m1 - m2).abs() / torch.sqrt((v1 + v2) / n + 1e-12)) \
            .max().item()

    draw = exact or mvn.direct_sample
    r = run_rwm_fused(mvn, seed, num_chains=n, num_iterations=50,
                      init_states=draw(n, 1.0, g).T, device=dev,
                      **sampler_kw)
    z_rwm = max_z(r.state.x, draw(n, 1.0, g).T)
    bi = (torch.logspace(0, math.log10(0.09), 6, device=dev) if betas is None
          else torch.tensor(betas, device=dev))
    cube = torch.stack([draw(n, b.item(), g).T for b in bi], dim=1)
    r = run_pt_fused(mvn, seed + 1, bi, num_chains=n, num_iterations=60,
                     swap_every=5, init_states=cube, device=dev,
                     **sampler_kw, **(pt_kw or {}))
    z_pt = max(max_z(r.state.x[:, t], draw(n, bi[t].item(), g).T)
               for t in (range(len(bi)) if rungs is None else rungs))
    return z_rwm, z_pt, r.swap_acceptance_rate.mean().item()


def proposal_params(prop, dim, var):
    """Parameters of proposal ``prop`` matched to a Normal proposal of
    variance ``var``: the same variance per coordinate for Laplace, and for
    UniformRadius a radius of sqrt(dim * var), the Normal increment's RMS
    length."""
    return {"Normal": {"base_variance_scalar": var},
            "Laplace": {"base_variance_vector": var},
            "UniformRadius": {"base_radius": math.sqrt(dim * var)}}[prop]


def phases_7_to_10(torch, gen):
    """Phases 7-10: the Laplace, UniformRadius and recording variants of
    both kernels held against their plain versions (7), against the eager
    engines and for invariance (8), the harness (9) and the study (10).
    Returns the kernels' JSON records of the new variants, with their
    launches on the harness and study runs."""
    import contextlib

    import numpy as np

    from rwm_pt_tpu_torch.api import MCMCSimulation
    from rwm_pt_tpu_torch.cli import experiment_rwm
    from rwm_pt_tpu_torch.cli.common import build_proposal_config
    from rwm_pt_tpu_torch.kernels import (_build, agreement, fused_pt,
                                          fused_rwm, run_pt, run_pt_fused,
                                          run_rwm, run_rwm_fused)
    from rwm_pt_tpu_torch.kernels.draws import resolve_normal_impl, seed_key
    from rwm_pt_tpu_torch.proposals import create_proposal_distribution
    from rwm_pt_tpu_torch.targets import (FullRosenbrock, MultivariateNormal,
                                          get_target_distribution)

    dev = torch.device("cuda")
    zi = lambda *s: torch.zeros(*s, dtype=torch.int32, device=dev)  # noqa
    zf = lambda *s: torch.zeros(*s, dtype=torch.float32, device=dev)  # noqa
    wrappers = (fused_pt.launch_pt_kernel, fused_rwm.launch_rwm_kernel)
    d, T, C, Cr = FLAG["dim"], FLAG["T"], FLAG["C"], RWM_MAIN["C"]
    var = FLAG["base_variance"]
    rb = FullRosenbrock.create(d, device=dev)
    betas = torch.logspace(0, -2, T, device=dev)
    beta1 = torch.tensor(1.0, device=dev)

    def proposal(prop, dim, v):
        return create_proposal_distribution(
            dim, {"name": prop, "params": proposal_params(prop, dim, v)},
            device=dev)

    # ---- 7. every new variant against its plain version, with the normal
    # draw the entry points choose at the main paths' size
    draw = {"PT": resolve_normal_impl("pt", C, "rosenbrock"),
            "RWM": resolve_normal_impl("rwm", Cr, "rosenbrock")}
    variants = [  # (record name, sampler, proposal, recording, replaces)
        ("fused_rwm_laplace", "RWM", "Laplace", False,
         "rwm_pt_tpu/kernels/pallas_rwm.py:204"),
        (_build.library("fused_rwm", "UniformRadius", draw["RWM"]), "RWM",
         "UniformRadius", False, "rwm_pt_tpu/kernels/pallas_rwm.py:213"),
        ("fused_rwm_record", "RWM", "Normal", True,
         "rwm_pt_tpu/kernels/pallas_rwm.py:552"),
        ("fused_pt_laplace", "PT", "Laplace", False,
         "rwm_pt_tpu/kernels/pallas_pt.py:314"),
        (_build.library("fused_pt", "UniformRadius", draw["PT"]), "PT",
         "UniformRadius", False, "rwm_pt_tpu/kernels/pallas_pt.py:311"),
        ("fused_pt_record", "PT", "Normal", True,
         "rwm_pt_tpu/kernels/pallas_pt.py:377"),
    ]
    records = {}
    for name, algo, prop, rec, replaces in variants:
        dr = draw[algo]
        if algo == "PT":
            kind, sig = fused_pt.rung_scales(proposal(prop, d, var), None,
                                             betas, torch.ones_like(betas))

            def case(steps, hold, sig=sig, prop=prop, rec=rec, kind=kind,
                     dr=dr):
                # the held recorded run swaps every 10 steps and records
                # REC_HOLD_CHAINS replicas, so that a snapshot taken before
                # the swap sweep cannot go unseen
                swap_every = 10 if hold and rec else FLAG["swap_every"]
                n_rec = (REC_HOLD_CHAINS if hold else REC_CHAINS) if rec else 0
                x0 = (1e-8 * torch.randn(d, 1, C, generator=gen,
                                         device=dev)).expand(d, T, C)
                args = (rb, x0.contiguous(), zi(T, C), zi(C), zf(C), zf(C),
                        betas, sig, seed_key(0), 0, steps, 0, swap_every)
                kw = dict(kind=kind, record_every=int(rec),
                          record_chains=n_rec, draw=dr)
                return args, kw, pt_work(
                    "rosenbrock", d, T, C, steps, 0, swap_every, prop=prop,
                    record_every=int(rec), rec_chains=n_rec, draw=dr)
            launch, plain = (fused_pt.launch_pt_kernel,
                             fused_pt._run_pt_fused_plain)
            names = agreement.PT_REC_OUTPUTS if rec else agreement.PT_OUTPUTS
            source = "rwm_pt_tpu_torch/kernels/csrc/fused_pt.cu"
        else:
            kind, scale = fused_rwm.proposal_scale(proposal(prop, d, var),
                                                   None, beta1)

            def case(steps, hold, scale=scale, prop=prop, rec=rec,
                     kind=kind, dr=dr):
                n_rec = (REC_HOLD_CHAINS if hold else REC_CHAINS) if rec else 0
                x0 = 1e-8 * torch.randn(d, Cr, generator=gen, device=dev)
                args = (rb, x0, zi(Cr), zf(Cr), beta1, scale, seed_key(0), 0,
                        steps, 0)
                kw = dict(kind=kind, record_every=int(rec),
                          record_chains=n_rec, draw=dr)
                return args, kw, rwm_work(
                    "rosenbrock", d, Cr, steps, prop=prop,
                    record_every=int(rec), rec_chains=n_rec, draw=dr)
            launch, plain = (fused_rwm.launch_rwm_kernel,
                             fused_rwm._run_rwm_fused_plain)
            names = (agreement.RWM_REC_OUTPUTS if rec
                     else agreement.RWM_OUTPUTS)
            source = "rwm_pt_tpu_torch/kernels/csrc/fused_rwm.cu"
        records[name] = kernel_record(
            torch, name, source, replaces, 0, launch, plain, names, case,
            FLAG["iters"], phase=7)
        torch.cuda.empty_cache()

    # The study's instantiations (RoughCarpetScaled, DMAX 32) at its shape:
    # d=20, 1024 chains, HOLD_STEPS steps (burn-in 50), at the first, the
    # 25th and the last scale of its 40-point grid.
    rc_s = get_target_distribution(STUDY["target"], STUDY["dim"], device=dev)
    Ds, Cs = STUDY["dim"], STUDY["C"]
    grid = np.linspace(0.01, STUDY["var_max"], 40)
    study_draw = resolve_normal_impl("rwm", Cs, "rough_carpet")
    for prop in NEW_PROPOSALS:
        name = _build.library("fused_rwm", prop, study_draw)
        holds = []
        for i in (0, 24, 39):
            p = create_proposal_distribution(
                Ds, build_proposal_config(prop, float(grid[i]), Ds),
                device=dev)
            kind, scale = fused_rwm.proposal_scale(p, None, beta1)
            x0 = torch.randn(Ds, Cs, generator=gen, device=dev)
            args = (rc_s, x0, zi(Cs), zf(Cs), beta1, scale, seed_key(i), 0,
                    HOLD_STEPS, 50)
            ms, plain_ms, ag = hold_run(
                torch, f"{name} at the study's shape, scale {grid[i]:.4f}",
                fused_rwm.launch_rwm_kernel, fused_rwm._run_rwm_fused_plain,
                args, dict(kind=kind, draw=study_draw),
                agreement.RWM_OUTPUTS)
            b_ms, b_by, _ = bound(*rwm_work("rough_carpet", Ds, Cs,
                                            HOLD_STEPS, prop=prop,
                                            draw=study_draw))
            holds.append(dict(scale=float(grid[i]), ms=ms, plain_ms=plain_ms,
                              bound_ms=b_ms, bound_by=b_by,
                              agree_frac=ag.frac, max_abs_err=ag.max_dx,
                              max_rel_err=ag.max_rel))
            say(f"phase 7 {name} at the study's shape ({STUDY['target']} "
                f"d={Ds}, {Cs} "
                f"chains, scale {grid[i]:.4f} of the grid, {HOLD_STEPS} "
                f"steps, burn-in 50): kernel {ms:.3f} ms, plain "
                f"{plain_ms:.1f} ms, bound {b_ms:.4f} ms; "
                f"{agreement.describe(ag)}")
        if name not in records:
            # a variant the study runs and no main path does (the study's
            # draw differs from the main paths'): its record is the
            # study-shape hold at the middle scale
            mid = holds[1]
            records[name] = dict(
                name=name, route="cuda",
                source="rwm_pt_tpu_torch/kernels/csrc/fused_rwm.cu",
                replaces="rwm_pt_tpu/kernels/pallas_rwm.py:213", launches=0,
                max_abs_err=0.0, ms=mid["ms"], plain_ms=mid["plain_ms"],
                bound_ms=mid["bound_ms"], bound_by=mid["bound_by"],
                library_ms=None, steps=HOLD_STEPS,
                agree_frac=mid["agree_frac"], max_rel_err=mid["max_rel_err"])
        records[name]["study_shape_holds"] = holds
        records[name]["max_abs_err"] = max(
            [records[name]["max_abs_err"]] + [h["max_abs_err"] for h in holds])

    # ---- 8. fused vs eager rates and invariance, new proposals, MVN d=10
    d2, bv = 10, 2.38 ** 2 / 10
    mvn = MultivariateNormal.create(d2, device=dev)
    betas6 = torch.logspace(0, -2, 6, device=dev)
    seed = int.from_bytes(os.urandom(4), "little")
    run_kw = dict(num_chains=1024, num_iterations=2000, burn_in=200,
                  device=dev)
    for prop in NEW_PROPOSALS:
        p = proposal(prop, d2, bv)
        fr = run_rwm_fused(mvn, 31, proposal=p, **run_kw)
        er = run_rwm(mvn, p, 32, **run_kw)
        z_rwm = max(per_chain_z(fr.acceptance_rate, er.acceptance_rate),
                    per_chain_z(fr.esjd, er.esjd))
        fp = run_pt_fused(mvn, 33, betas6, proposal=p, swap_every=20,
                          **run_kw)
        ep = run_pt(mvn, p, 34, betas6, swap_every=20,
                    swap_sweep="sequential", **run_kw)
        z_pt = max([per_chain_z(fp.acceptance_rate[t], ep.acceptance_rate[t])
                    for t in range(6)]
                   + [per_chain_z(fp.swap_acceptance_rate,
                                  ep.swap_acceptance_rate)])
        zi_rwm, zi_pt, sw = invariance(torch, mvn, seed, proposal=p)
        say(f"phase 8 {prop}: fused vs eager RWM acc "
            f"{fr.acceptance_rate.mean().item():.4f} vs "
            f"{er.acceptance_rate.mean().item():.4f}, ESJD "
            f"{fr.esjd.mean().item():.4f} vs {er.esjd.mean().item():.4f} "
            f"(max z {z_rwm:.2f}); PT swap acc "
            f"{fp.swap_acceptance_rate.mean().item():.4f} vs "
            f"{ep.swap_acceptance_rate.mean().item():.4f}, max z over "
            f"swap and 6 rungs' MH acc {z_pt:.2f} (< {Z_RATE_MAX}); "
            f"invariance (seed {seed}) max z RWM {zi_rwm:.2f}, PT "
            f"{zi_pt:.2f} (< {Z_INV_MAX}), PT swap acc {sw:.3f}")
        if max(z_rwm, z_pt) >= Z_RATE_MAX:
            fail(f"fused and eager samplers disagree for {prop}")
        if max(zi_rwm, zi_pt) >= Z_INV_MAX or sw <= 0.02:
            fail(f"invariance check failed for {prop}")

    # ---- 9. the harness on the card, recorded, one launch per run
    seen_main = Counter()
    for algo in ("PT", "RWM"):
        for prop in ("Normal",) + NEW_PROPOSALS:
            n_chains = C if algo == "PT" else Cr
            sim = MCMCSimulation(
                dim=d, proposal_config={
                    "name": prop, "params": proposal_params(prop, d, var)},
                num_iterations=FLAG["iters"], algorithm=algo,
                target_dist="FullRosenbrock", seed=0,
                beta_ladder=(betas.tolist() if algo == "PT" else None),
                num_chains=n_chains, swap_every=FLAG["swap_every"],
                record_chain=True, record_chains=REC_CHAINS, device=dev)
            reset_launches(*wrappers)
            chain = sim.generate_samples(verbose=False)
            seen = read_launches(*wrappers)
            src = "fused_pt" if algo == "PT" else "fused_rwm"
            want = {_build.library(src, prop, draw[algo]): 1,
                    src + "_record": 1}
            if dict(seen) != want:
                fail(f"harness {algo} {prop} launches {dict(seen)}, "
                     f"want {want}")
            seen_main.update(seen)
            if sim.engine_used != "pallas":
                fail(f"harness {algo} {prop} ran on {sim.engine_used}")
            if (chain is None or chain.shape != (FLAG["iters"], d)
                    or not torch.isfinite(torch.as_tensor(chain)).all()):
                fail(f"harness {algo} {prop} chain is not a finite "
                     f"({FLAG['iters']}, {d}) array")
            rhat, ess = sim.split_rhat(), sim.effective_sample_size()
            if not (math.isfinite(float(rhat.max()))
                    and math.isfinite(float(ess.min()))):
                fail(f"harness {algo} {prop} diagnostics are not finite")
            steps = FLAG["iters"] * n_chains * (T if algo == "PT" else 1)
            say(f"phase 9 harness {algo} {prop}: {steps / sim.elapsed_time:.6g}"
                f" MH steps/s ({sim.elapsed_time * 1e3:.3f} ms wall, "
                f"{n_chains} {'replicas' if algo == 'PT' else 'chains'}, "
                f"recorded {REC_CHAINS}); engine {sim.engine_used}; "
                f"launches {dict(seen)}; acc {sim.acceptance_rate():.4f}, "
                f"ESJD {sim.expected_squared_jump_distance():.5g}; split "
                f"R-hat max {float(rhat.max()):.4f}, ESS min "
                f"{float(ess.min()):.1f}")
            del sim, chain
            torch.cuda.empty_cache()

    # ---- 10. the RWM proposal study at launch_rwm_pod.sh's shape
    out_dir = os.path.join(HERE, "smoke_out", "study")
    os.makedirs(out_dir, exist_ok=True)
    study = {}
    for prop in NEW_PROPOSALS:
        argv = ["--dim", str(STUDY["dim"]), "--target", STUDY["target"],
                "--proposal", prop, "--num_iters", str(STUDY["iters"]),
                "--burn_in", str(STUDY["burn_in"]), "--num_chains",
                str(STUDY["C"]), "--var_max", str(STUDY["var_max"]),
                "--seed", str(STUDY["seed"]), "--num_configs",
                str(STUDY_CONFIGS), "--no_plots", "--output_dir", out_dir]
        reset_launches(*wrappers)
        with open(os.path.join(out_dir, f"{prop}.log"), "w") as log, \
                contextlib.redirect_stdout(log):
            data = experiment_rwm.main(argv)
        seen = read_launches(*wrappers)
        lib = _build.library("fused_rwm", prop, study_draw)
        want = {lib: STUDY_CONFIGS}
        if dict(seen) != want:
            fail(f"study {prop} launches {dict(seen)}, want {want}")
        seen_main.update(seen)
        acc, esjd = data["acceptance_rates"], data["expected_squared_jump_"
                                                   "distances"]
        if (len(acc) != STUDY_CONFIGS or not all(0 < a <= 1 for a in acc)
                or not all(e > 0 and math.isfinite(e) for e in esjd)):
            fail(f"study {prop} results out of range")
        study[lib] = data
        say(f"phase 10 study {prop}: {STUDY['target']} d={STUDY['dim']}, "
            f"{STUDY['iters']} iterations + {STUDY['burn_in']} burn-in, "
            f"{STUDY['C']} chains, {STUDY_CONFIGS} of the CLI's 40 scale "
            f"configs (var_max {STUDY['var_max']}): ESJD-optimal acceptance "
            f"{data['max_acceptance_rate']:.4f} at scale "
            f"{data['max_scale_param']:.4f} (ESJD {data['max_esjd']:.5g}); "
            f"{data['mh_steps_per_sec']:.6g} steps/s, "
            f"{data['total_time']:.2f} s in all, "
            f"{1e3 * min(data['times']):.3f}-{1e3 * max(data['times']):.3f}"
            f" ms a config; launches {dict(seen)}")

    out = []
    for name, r in records.items():
        r["launches"] = seen_main[name]
        if r["launches"] < 1:
            fail(f"{name} was not launched on the harness or study runs")
        if name in study:
            r["study_ms_per_config"] = 1e3 * min(study[name]["times"])
        out.append(r)
    return out


def kind_target(get_target_distribution, kind, d, dev, name=None, kw=None,
                **extra):
    """Phase 11's target of ``kind`` at d=10 (held) or d=30 (flagship; the
    kind's nearest valid d), or with the registry arguments ``kw``, and its
    Normal proposal variance."""
    import numpy as np
    reg, kw10, kw30, var_d = KINDS[kind]
    kw = kw or (kw10 if d == 10 else kw30)
    if kw == "cov":
        a = np.random.default_rng(3).normal(size=(d, d))
        kw = {"cov": a @ a.T / d + np.eye(d)}
    t = get_target_distribution(name or reg, d, device=dev, **kw, **extra)
    return t, var_d / t.dim


def draw_shapes(torch, rb, var, betas, proposal, rc_s, study_prop, tm, mf,
                var_mf, betas7):
    """Phase 12's timed shapes: key -> (label, kernel, replicas or chains,
    target kind, a run through the entry point).  The five of the draw
    rule (the flagship PT, the RWM headline, the two studies' and the
    full-covariance MVN at the flagship's) and the flagship's
    UniformRadius."""
    from rwm_pt_tpu_torch.kernels import run_pt_fused, run_rwm_fused
    dev = torch.device("cuda")
    d, C, Cr, iters = FLAG["dim"], FLAG["C"], RWM_MAIN["C"], FLAG["iters"]
    return {
        "pt": ("flagship PT", "pt", C, "rosenbrock", lambda: run_pt_fused(
            rb, 1, betas, base_variance=var, num_chains=C,
            num_iterations=iters, swap_every=FLAG["swap_every"],
            device=dev)),
        "pt_uniform_radius": (
            "flagship PT, UniformRadius", "pt", C, "rosenbrock",
            lambda: run_pt_fused(
                rb, 1, betas, proposal=proposal("UniformRadius", d, var),
                num_chains=C, num_iterations=iters,
                swap_every=FLAG["swap_every"], device=dev)),
        "pt_mvn_full": (
            f"flagship PT shape on the full-covariance MVN d={d}", "pt", C,
            "mvn_full", lambda: run_pt_fused(
                mf, 1, betas, base_variance=var_mf, num_chains=C,
                num_iterations=iters, swap_every=FLAG["swap_every"],
                device=dev)),
        "pt_study": (
            f"PT study shape ({PT_STUDY['target']} d={PT_STUDY['dim']}, "
            f"{PT_STUDY['C']} replicas, T=7, even/odd, {BM_STUDY_STEPS} "
            f"steps)", "pt", PT_STUDY["C"], "three_mixture",
            lambda: run_pt_fused(
                tm, 1, betas7, base_variance=2.38 ** 2 / PT_STUDY["dim"],
                num_chains=PT_STUDY["C"], num_iterations=BM_STUDY_STEPS,
                swap_every=100, swap_sweep="even_odd", device=dev)),
        "rwm": ("RWM headline", "rwm", Cr, "rosenbrock",
                lambda: run_rwm_fused(rb, 1, base_variance=var,
                                      num_chains=Cr, num_iterations=iters,
                                      device=dev)),
        "rwm_study": (f"RWM study shape ({STUDY['target']} d="
                      f"{STUDY['dim']}, UniformRadius, {STUDY['C']} chains, "
                      f"{BM_STUDY_STEPS} steps)", "rwm", STUDY["C"],
                      "rough_carpet", lambda: run_rwm_fused(
                          rc_s, 1, proposal=study_prop,
                          num_chains=STUDY["C"],
                          num_iterations=BM_STUDY_STEPS, device=dev)),
    }


def phases_11_to_13(torch, gen):
    """Phases 11-13: every other target kind in both kernels (11), the
    Box-Muller draw (12) and the PT swap-rate study (13).  Returns the
    kernels' JSON records of the new libraries and variants, with their
    launches on the entry-point runs and the study."""
    import contextlib

    import numpy as np

    from rwm_pt_tpu_torch.api import MCMCSimulation
    from rwm_pt_tpu_torch.cli import experiment_pt
    from rwm_pt_tpu_torch.kernels import (_build, agreement, draws, fused_pt,
                                          fused_rwm, run_pt, run_pt_fused,
                                          run_rwm_fused)
    from rwm_pt_tpu_torch.kernels.draws import seed_key
    from rwm_pt_tpu_torch.proposals import (NormalProposal,
                                            create_proposal_distribution)
    from rwm_pt_tpu_torch.targets import (FullRosenbrock, MultivariateNormal,
                                          get_target_distribution)

    dev = torch.device("cuda")
    zi = lambda *s: torch.zeros(*s, dtype=torch.int32, device=dev)  # noqa
    zf = lambda *s: torch.zeros(*s, dtype=torch.float32, device=dev)  # noqa
    wrappers = (fused_pt.launch_pt_kernel, fused_rwm.launch_rwm_kernel)
    T, C, Cr, iters = FLAG["T"], FLAG["C"], RWM_MAIN["C"], FLAG["iters"]
    betas = torch.logspace(0, -2, T, device=dev)
    beta1 = torch.tensor(1.0, device=dev)
    src = {"pt": "rwm_pt_tpu_torch/kernels/csrc/fused_pt.cu",
           "rwm": "rwm_pt_tpu_torch/kernels/csrc/fused_rwm.cu"}
    replaces = {"pt": "rwm_pt_tpu/kernels/pallas_pt.py:399",
                "rwm": "rwm_pt_tpu/kernels/pallas_rwm.py:570"}
    out = []

    # ---- 11. every other target kind, both kernels
    for kind in KINDS:
        held, var_h = kind_target(get_target_distribution, kind, 10, dev)
        main, var_m = kind_target(get_target_distribution, kind, 30, dev)
        for algo in ("pt", "rwm"):
            # the draw the entry point takes at the flagship shape (the
            # held runs' 2048 replicas or chains resolve to the same)
            dr = draws.resolve_normal_impl(algo, C if algo == "pt" else Cr,
                                           kind)

            def launch_case(tg, var, cc, steps, hold, algo=algo, kind=kind,
                            dr=dr):
                """A launch on target ``tg`` with ``cc`` replicas or chains:
                ``(args, kw, work)``; a held run has a burn-in of 50 and
                PT swaps every 10 steps in it."""
                n_params = _build.kernel_target(tg)[1].numel()
                dd, burn = tg.dim, (50 if hold else 0)
                if algo == "pt":
                    swap_every = 10 if hold else FLAG["swap_every"]
                    sig = torch.sqrt(torch.tensor(var, device=dev) / betas)
                    x0 = tg.init_sample(cc, gen).T[:, None].expand(
                        dd, T, cc).contiguous()
                    args = (tg, x0, zi(T, cc), zi(cc), zf(cc), zf(cc), betas,
                            sig, seed_key(17), 0, steps, burn, swap_every)
                    return args, dict(draw=dr), pt_work(
                        kind, dd, T, cc, steps, burn, swap_every, draw=dr,
                        n_params=n_params)
                x0 = tg.init_sample(cc, gen).T.contiguous()
                args = (tg, x0, zi(cc), zf(cc), beta1,
                        torch.sqrt(torch.tensor(var, device=dev)),
                        seed_key(17), 0, steps, burn)
                return args, dict(draw=dr), rwm_work(
                    kind, dd, cc, steps, draw=dr, n_params=n_params)

            def case(steps, hold, algo=algo, main=main, var_m=var_m,
                     launch_case=launch_case):
                # held at the main path's d with 2048 replicas or chains
                cc = 2048 if hold else (C if algo == "pt" else Cr)
                return launch_case(main, var_m, cc, steps, hold)
            name = f"{_build.library(f'fused_{algo}', 'Normal', dr)}.{kind}"
            if algo == "pt":
                launch, plain = (fused_pt.launch_pt_kernel,
                                 fused_pt._run_pt_fused_plain)
                names = agreement.PT_OUTPUTS
            else:
                launch, plain = (fused_rwm.launch_rwm_kernel,
                                 fused_rwm._run_rwm_fused_plain)
                names = agreement.RWM_OUTPUTS
            rec = kernel_record(torch, name, src[algo], replaces[algo], 0,
                                launch, plain, names, case, iters, phase=11)
            # and held at d=10, the bucket the PT study runs
            args, kw, _ = launch_case(held, var_h, 2048, HOLD_STEPS, True)
            ms, plain_ms, ag = hold_run(torch, f"{name} at d={held.dim}",
                                        launch, plain, args, kw, names)
            rec["d10_hold"] = dict(dim=held.dim, ms=ms, plain_ms=plain_ms,
                                   agree_frac=ag.frac, max_abs_err=ag.max_dx,
                                   max_rel_err=ag.max_rel)
            rec["max_abs_err"] = max(rec["max_abs_err"], ag.max_dx)
            say(f"phase 11 {name} held at d={held.dim} (2048 "
                f"{'replicas' if algo == 'pt' else 'chains'}, {HOLD_STEPS} "
                f"steps): kernel {ms:.3f} ms, plain {plain_ms:.1f} ms; "
                f"{agreement.describe(ag)}")
            del args
            # the flagship shape through the entry point, counters zeroed
            # just before and read just after
            reset_launches(*wrappers)
            if algo == "pt":
                res = run_pt_fused(main, 0, betas, base_variance=var_m,
                                   num_chains=C, num_iterations=iters,
                                   swap_every=FLAG["swap_every"], device=dev)
                acc = res.acceptance_rate[0].mean().item()
                extra = f", swap acc {res.swap_acceptance_rate.mean():.4f}"
            else:
                res = run_rwm_fused(main, 0, base_variance=var_m,
                                    num_chains=Cr, num_iterations=iters,
                                    device=dev)
                acc = res.acceptance_rate.mean().item()
                extra = ""
            torch.cuda.synchronize()
            seen = read_launches(*wrappers, by_kind=True)
            if dict(seen) != {name: 1}:
                fail(f"{name} entry-point run launched {dict(seen)}")
            if not (torch.isfinite(res.state.x).all() and 0 < acc <= 1):
                fail(f"{name} entry-point run: non-finite state or "
                     f"acceptance {acc}")
            rec["launches"] = seen[name]
            rec["dim"] = main.dim
            say(f"phase 11 {name}: entry point at d={main.dim}, "
                f"{C if algo == 'pt' else Cr} "
                f"{'replicas' if algo == 'pt' else 'chains'}, {iters} steps: "
                f"cold MH acc {acc:.4f}{extra}; launches {dict(seen)}")
            out.append(rec)
            del res
            torch.cuda.empty_cache()

    seed = int.from_bytes(os.urandom(4), "little")
    for kind, reg in GEWEKE_KINDS.items():
        extra = {"sigma_v_sq": 0.5} if kind == "neal_funnel" else {}
        tg, var = kind_target(get_target_distribution, kind, 10, dev,
                              name=reg, **extra)
        # the soft funnel and a mild ladder keep e^v inside float32 at the
        # hot rungs (tests/test_invariance.py:147-160); the mixtures'
        # tempered samplers (the JAX package's) are exact at beta = 1 only,
        # so their PT gate runs four rungs at beta = 1, where every swap is
        # accepted; IIDGamma's tempered law is drawn exactly here
        ladder = ([1.0, 0.75, 0.55, 0.4] if kind == "neal_funnel"
                  else [1.0] * 4 if kind in INEXACT_TEMPERED else None)
        exact = tempered_gamma(tg) if kind == "iid_gamma" else None
        z_rwm, z_pt, sw = invariance(torch, tg, seed, betas=ladder,
                                     exact=exact, base_variance=var)
        say(f"phase 11 invariance {tg.get_name()} d={tg.dim} (seed {seed}): "
            f"max z RWM {z_rwm:.2f}, PT {z_pt:.2f} (< {Z_INV_MAX}) on rungs "
            f"{ladder or '1 .. 0.09 (6)'}; PT swap acc {sw:.3f}")
        if max(z_rwm, z_pt) >= Z_INV_MAX or not swap_ok(sw, ladder):
            fail(f"invariance check failed for {reg}")

    # ---- 12. the normal draws: the rule's other draws held, every exact
    # draw timed
    d = FLAG["dim"]
    rb = FullRosenbrock.create(d, device=dev)
    var = FLAG["base_variance"]

    def proposal(prop, dim, v):
        return create_proposal_distribution(
            dim, {"name": prop, "params": proposal_params(prop, dim, v)},
            device=dev)

    # The main paths (phases 6-9, 11, 13) run the draw resolve_normal_impl
    # picks; here ICDF and Box-Muller, where the rule does not pick them,
    # have their Normal and UniformRadius variants held at the main paths'
    # shapes (RWM UniformRadius at 65,536 chains is left out: that variant
    # is the RWM study's, held in phase 7); phase 14 holds the draw study's.
    other = {k: [dr for dr in ("icdf", "bm")
                 if dr != draws.resolve_normal_impl(k, n, "rosenbrock")]
             for k, n in (("pt", C), ("rwm", Cr))}
    other_recs = {}
    for algo, prop, dr in [(a, p, dr) for a, p in (
            ("pt", "Normal"), ("pt", "UniformRadius"), ("rwm", "Normal"))
            for dr in other[a]]:
        p = proposal(prop, d, var)
        if algo == "pt":
            kind, sig = fused_pt.rung_scales(p, None, betas,
                                             torch.ones_like(betas))

            def case(steps, hold, sig=sig, prop=prop, kind=kind, dr=dr):
                x0 = (1e-8 * torch.randn(d, 1, C, generator=gen,
                                         device=dev)).expand(d, T, C)
                args = (rb, x0.contiguous(), zi(T, C), zi(C), zf(C), zf(C),
                        betas, sig, seed_key(0), 0, steps, 0,
                        FLAG["swap_every"])
                return args, dict(kind=kind, draw=dr), pt_work(
                    "rosenbrock", d, T, C, steps, 0, FLAG["swap_every"],
                    prop=prop, draw=dr)
            launch, plain = (fused_pt.launch_pt_kernel,
                             fused_pt._run_pt_fused_plain)
            names = agreement.PT_OUTPUTS
        else:
            kind, sig = fused_rwm.proposal_scale(p, None, beta1)

            def case(steps, hold, sig=sig, prop=prop, kind=kind, dr=dr):
                x0 = 1e-8 * torch.randn(d, Cr, generator=gen, device=dev)
                args = (rb, x0, zi(Cr), zf(Cr), beta1, sig, seed_key(0), 0,
                        steps, 0)
                return args, dict(kind=kind, draw=dr), rwm_work(
                    "rosenbrock", d, Cr, steps, prop=prop, draw=dr)
            launch, plain = (fused_rwm.launch_rwm_kernel,
                             fused_rwm._run_rwm_fused_plain)
            names = agreement.RWM_OUTPUTS
        name = _build.library(f"fused_{algo}", prop, dr)
        other_recs[name] = kernel_record(
            torch, name, src[algo], (
                "rwm_pt_tpu/kernels/pallas_rwm.py:53" if dr == "bm"
                else replaces[algo]), 0,
            launch, plain, names, case, iters, phase=12)
        torch.cuda.empty_cache()

    # invariance with each draw forced, through the entry points
    d2, bv = 10, 2.38 ** 2 / 10
    mvn = MultivariateNormal.create(d2, device=dev)
    old_impl = draws.NORMAL_IMPL
    try:
        reset_launches(*wrappers)
        for impl in ("bm", "icdf"):
            draws.NORMAL_IMPL = impl
            for prop in ("Normal", "UniformRadius"):
                z_rwm, z_pt, sw = invariance(torch, mvn, seed,
                                             proposal=proposal(prop, d2, bv))
                say(f"phase 12 invariance, NORMAL_IMPL {impl!r}, {prop} MVN "
                    f"d={d2} (seed {seed}): max z RWM {z_rwm:.2f}, PT "
                    f"{z_pt:.2f} (< {Z_INV_MAX}); PT swap acc {sw:.3f}")
                if max(z_rwm, z_pt) >= Z_INV_MAX or sw <= 0.02:
                    fail(f"invariance failed for {prop} with {impl}")
        seen_inv = read_launches(*wrappers, by_kind=True)
        # every exact draw through the entry points, one warm-up call and
        # best of 3, interleaved: the main paths' shapes, the studies' and
        # the full-covariance MVN at the flagship PT's
        rc_s = get_target_distribution(STUDY["target"], STUDY["dim"],
                                       device=dev)
        study_prop = create_proposal_distribution(
            STUDY["dim"], {"name": "UniformRadius",
                           "params": {"base_radius": 2.4654}}, device=dev)
        tm = get_target_distribution(PT_STUDY["target"], PT_STUDY["dim"],
                                     device=dev, variant="pt_gpu")
        mf, var_mf = kind_target(get_target_distribution, "mvn_full", d, dev)
        betas7 = torch.logspace(0, -2, 7, device=dev)
        shapes = draw_shapes(torch, rb, var, betas, proposal, rc_s,
                             study_prop, tm, mf, var_mf, betas7)
        reset_launches(*wrappers)
        for key, (label, _, _, _, fn) in shapes.items():
            t = {}
            for rep in range(4):
                for impl in EXACT_DRAWS:
                    draws.NORMAL_IMPL = impl
                    ms, _ = cuda_ms(torch, fn)
                    if rep:
                        t[impl] = min(t.get(impl, math.inf), ms)
            DRAW_TIMES[key] = t
            say(f"phase 12 exact draws at the {label}: " + ", ".join(
                f"{impl} {t[impl]:.3f} ms" for impl in EXACT_DRAWS)
                + " (best of 3 after a warm-up call, interleaved); fastest "
                f"{min(t, key=t.get)}")
        seen_timed = read_launches(*wrappers, by_kind=True)
    finally:
        draws.NORMAL_IMPL = old_impl
    for key, (label, k, n, tk, _) in shapes.items():
        t = DRAW_TIMES[key]
        rule = draws.resolve_normal_impl(k, n, tk)
        say(f"phase 12 resolve_normal_impl decision at the {label} ({k}, "
            f"{n}, {tk}): fastest exact draw {min(t, key=t.get)} "
            f"({min(t.values()):.3f} ms); the code's rule: {rule!r} "
            f"({t[rule]:.3f} ms, {100 * (t[rule] / min(t.values()) - 1):+.2f}"
            f" %)")
    for name, rec in other_recs.items():
        # launches of the timing runs (all at the main paths' shapes, on
        # FullRosenbrock) apart from those of the invariance runs
        rec["launches"] = seen_timed[f"{name}.rosenbrock"]
        rec["invariance_launches"] = seen_inv[f"{name}.mvn_iso"]
        if rec["launches"] < 1:
            fail(f"{name} was not launched through the entry points")
        out.append(rec)
    timed = {"pt": "fused_pt", "pt_uniform_radius": "fused_pt",
             "rwm": "fused_rwm"}
    for key, source in timed.items():
        prop = "UniformRadius" if key == "pt_uniform_radius" else "Normal"
        for dr in other[source[6:]]:
            other_recs[_build.library(source, prop, dr)]["draw_times_ms"] = (
                DRAW_TIMES[key])

    # ---- 13. the PT swap-rate study at launch_pt_pod.sh's shape
    out_dir = os.path.join(HERE, "smoke_out", "pt_study")
    os.makedirs(out_dir, exist_ok=True)
    per = []
    real_ladder = experiment_pt.construct_iterative_ladder_device
    real_run = experiment_pt.run_pt_fused
    from rwm_pt_tpu_torch.kernels.ladder_build import launch_ladder_kernel

    def ladder_spy(*a, **k):
        t0 = time.perf_counter()
        ladder = real_ladder(*a, **k)
        per.append(dict(ladder=ladder, ladder_s=time.perf_counter() - t0))
        return ladder

    def run_spy(*a, **k):
        reset_launches(*wrappers)
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        res = real_run(*a, **k)
        torch.cuda.synchronize()
        per[-1].update(run_s=time.perf_counter() - t0,
                       launches=read_launches(*wrappers, by_kind=True))
        return res

    n_cfg = PT_STUDY["configs"]
    experiment_pt.construct_iterative_ladder_device = ladder_spy
    experiment_pt.run_pt_fused = run_spy
    launch_ladder_kernel.launches.clear()
    try:
        with open(os.path.join(out_dir, "study.log"), "w") as log, \
                contextlib.redirect_stdout(log):
            data = experiment_pt.run_study(
                PT_STUDY["dim"], PT_STUDY["target"], PT_STUDY["iters"],
                PT_STUDY["swap_accept_max"], PT_STUDY["seed"],
                PT_STUDY["burn_in"], PT_STUDY["N"], PT_STUDY["tol"],
                PT_STUDY["pn"], PT_STUDY["fail"], num_chains=PT_STUDY["C"],
                num_configs=n_cfg, output_dir=out_dir, make_plots=False,
                device=dev)
    finally:
        experiment_pt.construct_iterative_ladder_device = real_ladder
        experiment_pt.run_pt_fused = real_run
    ladder_seen = dict(launch_ladder_kernel.launches)
    if ladder_seen != {"ladder_build.three_mixture": PT_STUDY["configs"]}:
        fail(f"PT study ladder launches {ladder_seen}")
    study_draw = draws.resolve_normal_impl("pt", PT_STUDY["C"],
                                           "three_mixture")
    lib = _build.library("fused_pt", "Normal", study_draw) + ".three_mixture"
    study_launches = 0
    for i, c in enumerate(per):
        say(f"phase 13 config {i}: constructed swap rate "
            f"{data['swap_acceptance_rates_range'][i]:.4f}, actual "
            f"{data['acceptance_rates'][i]:.4f}, beta-ESJD "
            f"{data['expected_squared_jump_distances'][i]:.6f}; T="
            f"{len(c['ladder'])} {[round(b, 5) for b in c['ladder']]}; "
            f"ladder {c['ladder_s']:.2f} s, run {c['run_s']:.3f} s; "
            f"launches {dict(c['launches'])}")
        if dict(c["launches"]) != {lib: 1}:
            fail(f"PT study config {i} launched {dict(c['launches'])}")
        study_launches += 1
    if len(per) != n_cfg or not all(
            0 <= a <= 1 for a in data["acceptance_rates"]):
        fail("PT study results out of range")
    say(f"phase 13 PT study {PT_STUDY['target']} d={PT_STUDY['dim']}, "
        f"{PT_STUDY['iters']} iterations + {PT_STUDY['burn_in']} burn-in, "
        f"{PT_STUDY['C']} replicas, {n_cfg} configs: ESJD-optimal swap "
        f"acceptance {data['max_actual_acceptance_rate']:.4f} (constructed "
        f"{data['max_constr_acceptance_rate']:.4f}, beta-ESJD "
        f"{data['max_esjd']:.6f}); {data['total_time']:.1f} s in all, "
        f"ladders {sum(c['ladder_s'] for c in per):.1f} s (one launch of "
        f"the ladder kernel each: {ladder_seen}), runs "
        f"{sum(c['run_s'] for c in per):.1f} s")

    reset_launches(*wrappers, launch_ladder_kernel)
    sim = MCMCSimulation(dim=PT_STUDY["dim"], sigma=2.38 ** 2 / PT_STUDY["dim"],
                         num_iterations=20000, algorithm="PT",
                         target_dist=PT_STUDY["target"], seed=1,
                         burn_in=1000, num_chains=PT_STUDY["C"],
                         iterative_temp_spacing=True, record_chain=False,
                         device=dev)
    sim.generate_samples(verbose=False)
    seen = read_launches(*wrappers, by_kind=True)
    ladder_seen = dict(launch_ladder_kernel.launches)
    if (dict(seen) != {lib: 1} or sim.engine_used != "pallas"
            or ladder_seen != {"ladder_build.three_mixture": 1}
            or sim.algorithm_name != "PT_RWM_GPU_ITERATIVE_LADDER"):
        fail(f"harness iterative-ladder PT run: launches {dict(seen)}, "
             f"ladder {ladder_seen}, engine {sim.engine_used}, "
             f"{sim.algorithm_name}")
    seen.update(launch_ladder_kernel.launches)
    say(f"phase 13 MCMCSimulation PT {PT_STUDY['target']} iterative ladder "
        f"{[round(b, 5) for b in sim.beta_ladder]}: swap acc "
        f"{sim.acceptance_rate():.4f}, beta-ESJD "
        f"{sim.pt_expected_squared_jump_distance():.6f}, "
        f"{sim.elapsed_time:.3f} s; launches {dict(seen)}")

    # the study's library held at the study's shape: the pt_gpu
    # ThreeMixture d=10, 1024 replicas, a 7-rung ladder, the even/odd order
    tm = get_target_distribution(PT_STUDY["target"], PT_STUDY["dim"],
                                 device=dev, variant="pt_gpu")
    Cs, betas7 = PT_STUDY["C"], torch.logspace(0, -2, 7, device=dev)
    sig = torch.sqrt(torch.tensor(2.38 ** 2 / PT_STUDY["dim"], device=dev)
                     / betas7)
    x0 = tm.init_sample(Cs, gen).T[:, None].expand(
        tm.dim, 7, Cs).contiguous()
    args = (tm, x0, zi(7, Cs), zi(Cs), zf(Cs), zf(Cs), betas7, sig,
            seed_key(19), 0, HOLD_STEPS, 50, 10)
    ms, plain_ms, ag = hold_run(
        torch, f"{lib} at the PT study's shape", fused_pt.launch_pt_kernel,
        fused_pt._run_pt_fused_plain, args,
        dict(draw=study_draw, swap_sweep="even_odd"), agreement.PT_OUTPUTS)
    b_ms, b_by, _ = bound(*pt_work(
        "three_mixture", tm.dim, 7, Cs, HOLD_STEPS, 50, 10, draw=study_draw,
        n_params=_build.kernel_target(tm)[1].numel()))
    say(f"phase 13 {lib} at the PT study's shape (d={tm.dim}, {Cs} "
        f"replicas, T=7, even/odd, {HOLD_STEPS} steps, burn-in 50, swap "
        f"every 10): kernel {ms:.3f} ms, plain {plain_ms:.1f} ms, bound "
        f"{b_ms:.4f} ms; {agreement.describe(ag)}")
    hold = dict(ms=ms, plain_ms=plain_ms, bound_ms=b_ms, bound_by=b_by,
                agree_frac=ag.frac, max_abs_err=ag.max_dx,
                max_rel_err=ag.max_rel)
    rec = next((r for r in out if r["name"] == lib), None)
    if rec is None:
        # the study's draw differs from the flagship's: its record is this
        # hold
        rec = dict(name=lib, route="cuda", source=src["pt"],
                   replaces=replaces["pt"], launches=0, library_ms=None,
                   steps=HOLD_STEPS)
        rec.update(hold)
        out.append(rec)
    rec["launches"] += study_launches + 1
    rec["pt_study_run_s"] = [c["run_s"] for c in per]
    rec["study_shape_hold"] = hold
    rec["max_abs_err"] = max(rec["max_abs_err"], ag.max_dx)

    bv = 2.38 ** 2 / d2
    betas6 = torch.logspace(0, -2, 6, device=dev)
    kw = dict(num_chains=1024, num_iterations=2000, burn_in=200,
              swap_every=20, device=dev)
    fz = run_pt_fused(mvn, 41, betas6, base_variance=bv,
                      swap_sweep="even_odd", **kw)
    ez = run_pt(mvn, NormalProposal.create(d2, bv, device=dev), 42, betas6,
                swap_sweep="even_odd", **kw)
    d_swap = abs(fz.swap_acceptance_rate.mean().item()
                 - ez.swap_acceptance_rate.mean().item())
    z = max([per_chain_z(fz.acceptance_rate[t], ez.acceptance_rate[t])
             for t in range(6)]
            + [per_chain_z(fz.swap_acceptance_rate, ez.swap_acceptance_rate)])
    say(f"phase 13 fused even_odd vs eager even_odd (MVN d={d2}, 6 rungs): "
        f"swap acc {fz.swap_acceptance_rate.mean().item():.4f} vs "
        f"{ez.swap_acceptance_rate.mean().item():.4f} (|d| {d_swap:.4f} < "
        f"0.05), max z over swap and per-rung MH acc {z:.2f} (< "
        f"{Z_RATE_MAX})")
    if d_swap >= 0.05 or z >= Z_RATE_MAX:
        fail("fused even_odd and the eager engine disagree")
    return out


def normal_gates(torch, z, ref):
    """tests/test_pallas_kernels.py:425-440's gates on the normals ``z``:
    |mean| < 5e-3, |std - 1| < 5e-3, |E z^3| < 2e-2, |E z^4 - 3| < 5e-2,
    KS against the exact normal CDF < 3.5e-3, and the shares above 2 and 3
    within 6 standard errors (+ 2e-5) of ``ref``'s (``torch.randn`` on the
    card).  Returns ``(statistics, names of the failed gates)``."""
    n = z.numel()
    zs = torch.sort(z.double().flatten()).values
    q = (torch.arange(n, dtype=torch.float64, device=z.device) + 0.5) / n
    st = dict(mean=zs.mean().item(), std=zs.std(correction=0).item(),
              skew=(zs ** 3).mean().item(), kurt=(zs ** 4).mean().item(),
              ks=(torch.special.ndtr(zs) - q).abs().max().item())
    bad = [k for k, ok in (("mean", abs(st["mean"]) < 5e-3),
                           ("std", abs(st["std"] - 1.0) < 5e-3),
                           ("skew", abs(st["skew"]) < 2e-2),
                           ("kurtosis", abs(st["kurt"] - 3.0) < 5e-2),
                           ("KS", st["ks"] < 3.5e-3)) if not ok]
    for thr in (2.0, 3.0):
        p_z = (zs > thr).double().mean().item()
        p_r = (ref > thr).double().mean().item()
        se = math.sqrt(2 * p_r * (1 - p_r) / n) + 1e-9
        st[f"above_{thr:g}"] = [p_z, p_r]
        if abs(p_z - p_r) >= 6 * se + 2e-5:
            bad.append(f"tail above {thr:g}")
    return st, bad


def fast_log_inputs(torch, dev, n, gen):
    """``n`` finite positive f32 inputs for ``fast_log`` on the card, as
    tests/test_pallas_kernels.py:454-457 makes its 8192: half log-spaced
    over 1e-37 .. 1, half uniform on [1e-7, 1)."""
    k = n // 2
    return torch.cat([
        torch.logspace(-37, 0, k, dtype=torch.float64, device=dev).float(),
        1e-7 + (1 - 1e-7) * torch.rand(n - k, generator=gen, device=dev)])


def hold_fast_log(torch, draws, k, y):
    """The ``fast_log`` kernel's output ``k`` on ``y`` against the plain
    version (within 2 f32 ulp, rtol 2.4e-7) and float64 log (the JAX
    test's bound 1e-6 + 1e-7 |log y|).  Returns ``(max |diff| to the
    plain version, within 2 ulp, worst error over the bound)``."""
    p = draws.fast_log(y)
    exact = torch.log(y.double())
    worst = ((k.double() - exact).abs()
             / (1e-6 + 1e-7 * exact.abs())).max().item()
    return ((k - p).abs().max().item(),
            bool(((k - p).abs() <= 2.4e-7 * p.abs()).all()), worst)


def probe_inputs(torch, dev, gen):
    """``fast_log``'s inputs on the card: tests/test_pallas_kernels.py:
    454-457's 8192 and the bandwidth shape's 2^24 + 3."""
    import numpy as np
    y = np.concatenate([
        np.logspace(-37, 0, 4096).astype(np.float32),
        np.random.default_rng(0).uniform(1e-7, 1.0, 4096).astype(np.float32),
    ]).reshape(8, 1024)
    return (torch.from_numpy(y).to(dev),
            fast_log_inputs(torch, dev, PROBE_BW_N + 3, gen))


def hold_probes(torch, dev, seed, gen, yt, ybw, phase="14a"):
    """Launch each probe once and hold it against its plain version:
    ``draw_normals`` of every draw at N = 2^20 and 2^24 (>= 99.9 % of
    elements to 1e-5 relative, max |diff| < ``agreement.X_ATOL``, and the
    exact draws through :func:`normal_gates` against ``torch.randn``), and
    ``fast_log`` on ``yt``, ``ybw`` and the view ``ybw[1:]``, one float off
    16-byte alignment (:func:`hold_fast_log`: 2 ulp, the JAX bound).
    Fails on any disagreement.  Returns ``{(draw, N) or ("fast_log",
    n): figures}``."""
    from rwm_pt_tpu_torch.kernels import agreement, draw_probes, draws
    held = {}
    for n in (PROBE_N, PROBE_BW_N):
        ref = torch.randn(n, generator=gen, device=dev)
        for impl in draws.NORMAL_IMPLS:
            zk = draw_probes.draw_normals(impl, seed, n, device=dev)
            p = draw_probes._draw_normals_plain(impl, seed, n, dev)
            diff = (zk - p).abs()
            share = (diff <= 1e-5 * p.abs()).double().mean().item()
            max_d = diff.max().item()
            st, bad = ({}, []) if impl == "fake_uniform" else normal_gates(
                torch, zk, ref)
            say(f"phase {phase} probe draw_normals {impl} (seed {seed}, "
                f"N={n}): {100 * share:.4f} % of elements agree with the "
                f"plain version to 1e-5 relative, max |diff| {max_d:.3g}"
                + ("; not a normal, no gates" if impl == "fake_uniform" else
                   f"; mean {st['mean']:.2e}, std {st['std']:.6f}, E z^3 "
                   f"{st['skew']:.2e}, E z^4 {st['kurt']:.5f}, KS "
                   f"{st['ks']:.2e}, above 2 {st['above_2'][0]:.6f} vs randn "
                   f"{st['above_2'][1]:.6f}, above 3 {st['above_3'][0]:.6f} "
                   f"vs {st['above_3'][1]:.6f}"))
            if max_d >= agreement.X_ATOL or share < 0.999 or bad:
                fail(f"draw_normals {impl} at N={n}: max |diff| {max_d}, "
                     f"share {share}, failed gates {bad}")
            held[impl, n] = dict(max_abs_err=max_d, agree_share_1e5_rel=share,
                                 gates=st)
            del zk, p, diff
        del ref
    for label, v in (("8192 inputs", yt), (f"{ybw.numel()} inputs", ybw),
                     (f"view [1:] of {ybw.numel()}", ybw[1:])):
        max_d, rel_ok, worst = hold_fast_log(torch, draws,
                                             draw_probes.fast_log(v), v)
        say(f"phase {phase} probe fast_log ({label}): max |diff| to the "
            f"plain version {max_d:.3g} (within 2 ulp: {rel_ok}); worst "
            f"error / (1e-6 + 1e-7 |log y|) against float64 log "
            f"{worst:.4f} (< 1)")
        if not rel_ok or worst >= 1.0:
            fail(f"fast_log probe on {label} disagrees with its plain "
                 "version or float64 log")
        held["fast_log", v.numel()] = dict(max_abs_err=max_d,
                                           worst_error_over_bound=worst)
    torch.cuda.empty_cache()
    return held


def phase_14(torch, gen, recorded):
    """Phase 14, the draw study's normals (B10): (a) the two probe kernels
    at the JAX probe's size, (b) the fused variants of the three new draws
    held at the main paths' shapes (but those an earlier phase recorded,
    ``recorded``: the main paths' where the rule picks one of these draws),
    (c) the Geweke gate with each new exact draw forced, (d) the draw study
    (``scripts/bench_normal_impl.py``) through the entry points.  Returns
    the kernels' JSON records of the probe kernels and the new variants,
    with their launches on (a) and (d)."""
    from rwm_pt_tpu_torch.kernels import (_build, agreement, draw_probes,
                                          draws, fused_pt, fused_rwm,
                                          run_pt_fused, run_rwm_fused)
    from rwm_pt_tpu_torch.kernels.draws import seed_key
    from rwm_pt_tpu_torch.proposals import create_proposal_distribution
    from rwm_pt_tpu_torch.targets import FullRosenbrock, MultivariateNormal

    t_phase = time.time()
    dev = torch.device("cuda")
    zi = lambda *s: torch.zeros(*s, dtype=torch.int32, device=dev)  # noqa
    zf = lambda *s: torch.zeros(*s, dtype=torch.float32, device=dev)  # noqa
    wrappers = (fused_pt.launch_pt_kernel, fused_rwm.launch_rwm_kernel)
    d, T, C, Cr = FLAG["dim"], FLAG["T"], FLAG["C"], RWM_MAIN["C"]
    iters, var = FLAG["iters"], FLAG["base_variance"]
    rb = FullRosenbrock.create(d, device=dev)
    betas = torch.logspace(0, -2, T, device=dev)
    beta1 = torch.tensor(1.0, device=dev)
    out = []

    def proposal(prop, dim, v):
        return create_proposal_distribution(
            dim, {"name": prop, "params": proposal_params(prop, dim, v)},
            device=dev)

    # ---- (a) the probe kernels, launches counted: every draw's normals at
    # N = 2^20 (the JAX probe's size) and 2^24 (the bandwidth shape), the
    # bit-trick log on tests/test_pallas_kernels.py:454-457's 8192 inputs,
    # on 2^24 + 3 inputs and on a view of them one float off 16-byte
    # alignment, each held against its plain version; then timed
    seed = int.from_bytes(os.urandom(4), "little")
    probes = (draw_probes.draw_normals, draw_probes.fast_log)
    yt, ybw = probe_inputs(torch, dev, gen)
    reset_launches(*probes)
    held = hold_probes(torch, dev, seed, gen, yt, ybw)
    torch.cuda.synchronize()
    seen = read_launches(*probes, by_kind=True)
    want = Counter({impl: 2 for impl in draws.NORMAL_IMPLS})
    want["fast_log"] = 3
    if seen != want:
        fail(f"probe launches {dict(seen)}, want {dict(want)}")
    figs = {n: probe_timings(torch, draw_probes, draws, dev, seed, n, yy,
                             label)
            for n, yy, label in ((PROBE_N, yt, "test shape"),
                                 (PROBE_BW_N, ybw[:PROBE_BW_N],
                                  "bandwidth shape"))}
    host_breakdown(torch, draw_probes, dev, seed, PROBE_N, yt)
    for name, fig in figs[PROBE_N].items():
        if name == "fast_log":
            plain_ms = cuda_ms(torch, lambda: draws.fast_log(yt), reps=3)[0]
            hk, bk = ("fast_log", yt.numel()), ("fast_log", PROBE_BW_N + 3)
            replaces = "tests/test_pallas_kernels.py:462"
        else:
            impl = name.split(".")[1]
            plain_ms = cuda_ms(torch, lambda: draw_probes._draw_normals_plain(
                impl, seed, PROBE_N, dev), reps=3)[0]
            hk, bk = (impl, PROBE_N), (impl, PROBE_BW_N)
            replaces = "tests/test_pallas_kernels.py:403"
        lib_us = fig["library_device_us"]
        rec = dict(fig, **held[hk])
        rec.update(
            name=name, route="cuda", source=PROBE_SOURCE, replaces=replaces,
            launches=seen[hk[0]], ms=fig["device_us"] / 1e3,
            plain_ms=plain_ms, bound_ms=fig["bound_us"] / 1e3,
            library_ms=None if lib_us is None else lib_us / 1e3,
            timing=f"device us a launch in a CUDA graph of {GRAPH_LAUNCHES}",
            bandwidth=dict(figs[PROBE_BW_N][name], **held[bk]))
        if name == "fast_log":
            rec["view"] = held["fast_log", PROBE_BW_N + 2]
        out.append(rec)
    say(f"phase 14a {time.time() - t_phase:.1f} s")

    # ---- (b) each new draw's Normal and UniformRadius variants of both
    # kernels held at the main paths' shapes
    recs = {}
    src = {"pt": "rwm_pt_tpu_torch/kernels/csrc/fused_pt.cu",
           "rwm": "rwm_pt_tpu_torch/kernels/csrc/fused_rwm.cu"}
    for impl in STUDY_DRAWS:
        for algo in ("pt", "rwm"):
            for prop in ("Normal", "UniformRadius"):
                p = proposal(prop, d, var)
                if algo == "pt":
                    kind, sig = fused_pt.rung_scales(p, None, betas,
                                                     torch.ones_like(betas))

                    def case(steps, hold, sig=sig, prop=prop, kind=kind,
                             impl=impl):
                        x0 = (1e-8 * torch.randn(d, 1, C, generator=gen,
                                                 device=dev)).expand(d, T, C)
                        args = (rb, x0.contiguous(), zi(T, C), zi(C), zf(C),
                                zf(C), betas, sig, seed_key(0), 0, steps, 0,
                                FLAG["swap_every"])
                        return args, dict(kind=kind, draw=impl), pt_work(
                            "rosenbrock", d, T, C, steps, 0,
                            FLAG["swap_every"], prop=prop, draw=impl)
                    launch, plain = (fused_pt.launch_pt_kernel,
                                     fused_pt._run_pt_fused_plain)
                    names = agreement.PT_OUTPUTS
                else:
                    kind, sig = fused_rwm.proposal_scale(p, None, beta1)

                    def case(steps, hold, sig=sig, prop=prop, kind=kind,
                             impl=impl):
                        x0 = 1e-8 * torch.randn(d, Cr, generator=gen,
                                                device=dev)
                        args = (rb, x0, zi(Cr), zf(Cr), beta1, sig,
                                seed_key(0), 0, steps, 0)
                        return args, dict(kind=kind, draw=impl), rwm_work(
                            "rosenbrock", d, Cr, steps, prop=prop, draw=impl)
                    launch, plain = (fused_rwm.launch_rwm_kernel,
                                     fused_rwm._run_rwm_fused_plain)
                    names = agreement.RWM_OUTPUTS
                name = _build.library(f"fused_{algo}", prop, impl)
                if name in recorded:
                    continue
                recs[name] = kernel_record(
                    torch, name, src[algo], DRAW_SITES[impl], 0, launch,
                    plain, names, case, iters, phase=14)
                torch.cuda.empty_cache()
    say(f"phase 14b {time.time() - t_phase:.1f} s")

    # ---- (c) Geweke with each new exact draw forced, (d) the draw study
    d2 = 10
    mvn = MultivariateNormal.create(d2, device=dev)
    gseed = int.from_bytes(os.urandom(4), "little")
    old = draws.NORMAL_IMPL
    study = {}
    launches = Counter()
    try:
        for impl in ("icdf_fastlog", "lax_erfinv"):
            draws.NORMAL_IMPL = impl
            for prop in ("Normal", "UniformRadius"):
                reset_launches(*wrappers)
                z_rwm, z_pt, sw = invariance(torch, mvn, gseed,
                                             proposal=proposal(prop, d2,
                                                               OPT_VAR))
                seen = read_launches(*wrappers)
                want = {_build.library("fused_pt", prop, impl): 1,
                        _build.library("fused_rwm", prop, impl): 1}
                say(f"phase 14 invariance, NORMAL_IMPL {impl!r}, {prop} MVN "
                    f"d={d2} (seed {gseed}): max z RWM {z_rwm:.2f}, PT "
                    f"{z_pt:.2f} (< {Z_INV_MAX}); PT swap acc {sw:.3f}; "
                    f"launches {dict(seen)}")
                if dict(seen) != want:
                    fail(f"invariance runs launched {dict(seen)}, want {want}")
                if max(z_rwm, z_pt) >= Z_INV_MAX or sw <= 0.02:
                    fail(f"invariance failed for {prop} with {impl}")
        runs = {  # (kernel, proposal) -> run(seed)
            ("pt", "Normal"): lambda r: run_pt_fused(
                rb, r, betas, base_variance=var, num_chains=C,
                num_iterations=iters, swap_every=FLAG["swap_every"],
                device=dev),
            ("pt", "UniformRadius"): lambda r: run_pt_fused(
                rb, r, betas, proposal=proposal("UniformRadius", d, var),
                num_chains=C, num_iterations=iters,
                swap_every=FLAG["swap_every"], device=dev),
            ("rwm", "Normal"): lambda r: run_rwm_fused(
                rb, r, base_variance=var, num_chains=Cr,
                num_iterations=iters, device=dev),
            ("rwm", "UniformRadius"): lambda r: run_rwm_fused(
                rb, r, proposal=proposal("UniformRadius", d, var),
                num_chains=Cr, num_iterations=iters, device=dev),
        }
        for (algo, prop), run in runs.items():
            best = {}
            for rep in (1, 2, 3):
                for impl in draws.NORMAL_IMPLS:      # interleaved
                    draws.NORMAL_IMPL = impl
                    reset_launches(*wrappers)
                    ms, res = cuda_ms(torch, lambda: run(rep))
                    seen = read_launches(*wrappers)
                    lib = _build.library(f"fused_{algo}", prop, impl)
                    if dict(seen) != {lib: 1}:
                        fail(f"draw study {algo} {prop} {impl} launched "
                             f"{dict(seen)}")
                    launches[lib] += 1
                    if impl in best and best[impl]["ms"] <= ms:
                        continue
                    m = dict(ms=ms, mh_acc=res.acceptance_rate.mean().item())
                    if algo == "pt":
                        m.update(cold_mh_acc=res.acceptance_rate[0].mean()
                                 .item(),
                                 swap_acc=res.swap_acceptance_rate.mean()
                                 .item(),
                                 cold_esjd=res.cold_esjd.mean().item())
                    else:
                        m.update(esjd=res.esjd.mean().item())
                    best[impl] = m
                    del res
            study[(algo, prop)] = best
    finally:
        draws.NORMAL_IMPL = old
    for (algo, prop), best in study.items():
        n_steps = iters * (T * C if algo == "pt" else Cr)
        fake_rate = n_steps / (best["fake_uniform"]["ms"] / 1e3)
        for impl, m in best.items():
            rate = n_steps / (m["ms"] / 1e3)
            work = (pt_work("rosenbrock", d, T, C, iters, 0,
                            FLAG["swap_every"], prop=prop, draw=impl)
                    if algo == "pt" else
                    rwm_work("rosenbrock", d, Cr, iters, prop=prop,
                             draw=impl))
            b_ms, b_by, _ = bound(*work)
            m.update(mh_steps_per_s=rate, bound_ms=b_ms, bound_by=b_by,
                     draw_cost_share=1.0 - rate / fake_rate)
            extra = (f"swap acc {m['swap_acc']:.4f}, cold MH acc "
                     f"{m['cold_mh_acc']:.4f}, cold ESJD {m['cold_esjd']:.5g}"
                     if algo == "pt" else f"ESJD {m['esjd']:.5g}")
            say(f"phase 14 draw study {algo.upper()} {prop} {impl}: "
                f"{rate:.6g} MH steps/s, {m['ms']:.3f} ms (best of 3, "
                f"interleaved; bound {b_ms:.3f} ms by {b_by}); MH acc "
                f"{m['mh_acc']:.4f}, {extra}; draw_cost_share "
                f"{m['draw_cost_share']:+.4f}")
            name = _build.library(f"fused_{algo}", prop, impl)
            if name in recs:
                recs[name]["draw_study"] = m
    for name, rec in recs.items():
        rec["launches"] = launches[name]
        if rec["launches"] < 1:
            fail(f"{name} was not launched by the draw study")
        out.append(rec)
    say(f"phase 14 {time.time() - t_phase:.1f} s")
    return out


def phase_15(torch):
    """Phase 15, burn-in autotuning (A11): two-phase ``MCMCSimulation``
    runs (the eager tuner for the burn-in, then one fused launch) at the
    flagship shape (scale tuner and ladder tuner) and the RWM headline,
    the JAX tests' rate gates on MVN at 65,536 replicas or chains, Geweke
    at the tuned multipliers and at a tuned ladder, and the single_run
    CLI."""
    import numpy as np

    from rwm_pt_tpu_torch.api import MCMCSimulation
    from rwm_pt_tpu_torch.kernels import (_build, draws, fused_pt, fused_rwm,
                                          run_pt_adaptive,
                                          run_pt_ladder_adaptive)
    from rwm_pt_tpu_torch.proposals import NormalProposal
    from rwm_pt_tpu_torch.targets import FullRosenbrock, MultivariateNormal

    t_phase = time.time()
    dev = torch.device("cuda")
    wrappers = (fused_pt.launch_pt_kernel, fused_rwm.launch_rwm_kernel)
    d, T, C, Cr = FLAG["dim"], FLAG["T"], FLAG["C"], RWM_MAIN["C"]
    flag_betas = torch.logspace(0, -2, T, device=dev).tolist()
    geom6 = np.geomspace(1.0, 0.01, 6).tolist()
    mis_var = FLAG["base_variance"] * TUNE["mis"]

    def lib(algo, n, kind):
        return _build.library(f"fused_{algo}", "Normal",
                              draws.resolve_normal_impl(algo, n, kind))

    def tuned_run(label, want, **kw):
        """A two-phase autotuned harness run with the launch counters
        zeroed just before and read just after: exactly one launch, of
        library ``want``, and engine_used 'pallas'."""
        kw = dict(dict(num_iterations=TUNE["iters"],
                       burn_in=TUNE["burn_in"],
                       autotune_every=TUNE["every"], seed=0,
                       record_chain=False, engine="pallas", device=dev),
                  **kw)
        sim = MCMCSimulation(**kw)
        reset_launches(*wrappers)
        sim.generate_samples(verbose=False)
        seen = read_launches(*wrappers)
        if dict(seen) != {want: 1} or sim.engine_used != "pallas":
            fail(f"{label}: launches {dict(seen)} (want {want}: 1), engine "
                 f"{sim.engine_used}")
        return sim

    def fmt(v, k=4):
        return [round(float(a), k) for a in v]

    # ---- (a) PT at the flagship shape, Normal variance mis-scaled 1/100
    sim = tuned_run("PT flagship autotune", lib("pt", C, "rosenbrock"),
                    dim=d, sigma=mis_var, algorithm="PT",
                    target_dist="FullRosenbrock", beta_ladder=flag_betas,
                    num_chains=C, swap_every=FLAG["swap_every"],
                    autotune=True)
    mult = np.asarray(sim.get_diagnostic_info()["tuned_scale_multiplier"])
    if mult.shape != (T,) or not (np.isfinite(mult).all()
                                  and (mult > 0).all()):
        fail(f"PT flagship tuned multipliers {mult}")
    acc = sim._result.acceptance_rate.mean(1).tolist()
    off = [t for t, a in enumerate(acc) if abs(a - 0.234) >= 0.05]
    measure_s = sim._phase_seconds["measure"]
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    run_pt_adaptive(FullRosenbrock.create(d, device=dev),
                    NormalProposal.create(d, mis_var, device=dev), 1,
                    flag_betas, num_chains=C, num_iterations=0,
                    burn_in=TUNE["burn_in"], swap_every=FLAG["swap_every"],
                    adapt_every=TUNE["every"], device=dev)
    torch.cuda.synchronize()
    tune_s = time.perf_counter() - t0
    say(f"phase 15 PT flagship autotune (FullRosenbrock d={d}, T={T}, {C} "
        f"replicas, variance (0.5^2/30)/100, burn-in {TUNE['burn_in']} in "
        f"windows of {TUNE['every']}, {TUNE['iters']} measured): tuned "
        f"multipliers {fmt(mult, 3)}; per-rung MH acc {fmt(acc)} (rungs "
        f"outside 0.234 +- 0.05: {off}); swap acc {sim.acceptance_rate():.4f},"
        f" cold ESJD {sim.expected_squared_jump_distance():.5g}; tune "
        f"(run_pt_adaptive alone) {tune_s:.3f} s = "
        f"{1e3 * tune_s / TUNE['burn_in']:.3f} ms/step, measure "
        f"{measure_s:.3f} s")
    del sim
    torch.cuda.empty_cache()

    # ---- (b) RWM at 65,536 chains, the multiplier folded into the proposal
    sim = tuned_run("RWM autotune", lib("rwm", Cr, "rosenbrock"), dim=d,
                    sigma=mis_var, algorithm="RWM",
                    target_dist="FullRosenbrock", num_chains=Cr,
                    autotune=True)
    c = sim.get_diagnostic_info()["tuned_scale_multiplier"]
    folded = sim.tuned_proposal_config()["params"]["base_variance_scalar"]
    if not (math.isfinite(c) and c > 0
            and abs(folded - mis_var * c) <= 1e-6 * folded):
        fail(f"RWM tuned multiplier {c}, folded variance {folded}")
    ps = sim._phase_seconds
    say(f"phase 15 RWM autotune (FullRosenbrock d={d}, {Cr} chains, same "
        f"mis-scale): tuned multiplier {c:.4f}, folded variance "
        f"{folded:.6g}; acc {sim.acceptance_rate():.4f}, ESJD "
        f"{sim.expected_squared_jump_distance():.5g}; tune {ps['tune']:.3f} "
        f"s ({1e3 * ps['tune'] / TUNE['burn_in']:.3f} ms/step), measure "
        f"{ps['measure']:.3f} s")
    del sim

    # ---- (c) the ladder tuner at the flagship shape
    sim = tuned_run("ladder flagship autotune", lib("pt", C, "rosenbrock"),
                    dim=d, sigma=FLAG["base_variance"], algorithm="PT",
                    target_dist="FullRosenbrock", beta_ladder=flag_betas,
                    num_chains=C, swap_every=FLAG["swap_every"],
                    autotune_ladder=True)
    lad = sim.tuned_ladder
    if not (len(lad) == T and lad[0] == 1.0 and lad[-1] > 0
            and all(b < a for a, b in zip(lad, lad[1:]))):
        fail(f"tuned flagship ladder {lad}")
    ps = sim._phase_seconds
    say(f"phase 15 ladder autotune (FullRosenbrock d={d}, T={T}, {C} "
        f"replicas, target swap acc 0.234): ladder {fmt(lad, 5)}; measured "
        f"swap acc {sim.acceptance_rate():.4f}, per-rung MH acc "
        f"{fmt(sim._result.acceptance_rate.mean(1))}; tune {ps['tune']:.3f} s"
        f" ({1e3 * ps['tune'] / TUNE['burn_in']:.3f} ms/step), measure "
        f"{ps['measure']:.3f} s")
    del sim
    torch.cuda.empty_cache()

    # ---- (d) the JAX tests' rate gates on MVN, at 65,536 replicas/chains
    gates = []
    pt = tuned_run("MVN PT autotune", lib("pt", C, "mvn_iso"), dim=10,
                   sigma=OPT_VAR * TUNE["mis"], algorithm="PT",
                   target_dist="MultivariateNormal", beta_ladder=geom6,
                   num_chains=C, swap_every=20, autotune=True)
    acc = pt._result.acceptance_rate.mean(1).tolist()
    gates.append(("PT per-rung MH acc", max(abs(a - 0.234) for a in acc),
                  0.05, fmt(acc)))
    pt_mult = pt.get_diagnostic_info()["tuned_scale_multiplier"]
    rwm = tuned_run("MVN RWM autotune", lib("rwm", Cr, "mvn_iso"), dim=10,
                    sigma=OPT_VAR * TUNE["mis"], algorithm="RWM",
                    target_dist="MultivariateNormal", num_chains=Cr,
                    autotune=True)
    gates.append(("RWM acc", abs(rwm.acceptance_rate() - 0.234), 0.04,
                  round(rwm.acceptance_rate(), 4)))
    lad = tuned_run("MVN ladder autotune", lib("pt", C, "mvn_iso"), dim=5,
                    sigma=2.38 ** 2 / 5, algorithm="PT",
                    target_dist="MultivariateNormal", beta_ladder=geom6,
                    num_chains=C, swap_every=10, burn_in=4000,
                    num_iterations=4000, autotune_every=200,
                    swap_acceptance_rate=0.234, autotune_ladder=True)
    gates.append(("ladder swap acc", abs(lad.acceptance_rate() - 0.234),
                  0.06, round(lad.acceptance_rate(), 4)))
    for what, dev_, lim, val in gates:
        say(f"phase 15 rate gate {what}: {val} (|acc - 0.234| "
            f"{dev_:.4f} < {lim})")
        if dev_ >= lim:
            fail(f"autotune rate gate failed: {what} {val}")
    say(f"phase 15 MVN d=5 tuned ladder {fmt(lad.tuned_ladder, 5)}")
    del pt, rwm, lad
    torch.cuda.empty_cache()

    # ---- (e) Geweke at the tuned multipliers and at a tuned ladder
    mvn = MultivariateNormal.create(10, device=dev)
    seed = int.from_bytes(os.urandom(4), "little")
    z_rwm, z_pt, sw = invariance(
        torch, mvn, seed, betas=geom6, base_variance=OPT_VAR * TUNE["mis"],
        pt_kw={"scale_multipliers": pt_mult})
    say(f"phase 15 invariance at the tuned multipliers {fmt(pt_mult, 3)} "
        f"(MVN d=10, rungs 1 .. 0.01 (6), seed {seed}): max z PT "
        f"{z_pt:.2f}, RWM {z_rwm:.2f} (< {Z_INV_MAX}); swap acc {sw:.3f}")
    if max(z_rwm, z_pt) >= Z_INV_MAX or sw <= 0.02:
        fail("invariance failed at the tuned multipliers")
    tuned = run_pt_ladder_adaptive(
        mvn, NormalProposal.create(10, OPT_VAR, device=dev), seed,
        num_rungs=6, num_chains=4096, num_iterations=0, burn_in=1500,
        swap_every=5, adapt_every=50, target_swap_accept=0.4, beta_min=0.09,
        device=dev)
    ladder = tuned.tuned_betas.tolist()
    z_rwm, z_pt, sw = invariance(torch, mvn, seed, betas=ladder,
                                 base_variance=OPT_VAR)
    say(f"phase 15 invariance at a tuned ladder {fmt(ladder, 5)} (MVN d=10,"
        f" seed {seed}): max z PT {z_pt:.2f}, RWM {z_rwm:.2f} (< "
        f"{Z_INV_MAX}); swap acc {sw:.3f}")
    if max(z_rwm, z_pt) >= Z_INV_MAX or sw <= 0.02:
        fail("invariance failed at the tuned ladder")

    # ---- (f) the single_run CLI, autotuned, in a process of its own
    out_dir = os.path.join(HERE, "smoke_out", "single_run")
    cmd = [sys.executable, "-m", "rwm_pt_tpu_torch.cli.single_run",
           "--dim", "5", "--target", "MultivariateNormal", "--num_chains",
           "1024", "--burn_in", "1000", "--num_iters", "1000", "--seed", "3",
           "--autotune", "--no_plots", "--output_dir", out_dir]
    t0 = time.time()
    r = subprocess.run(cmd, cwd=HERE, capture_output=True, text=True,
                       timeout=600)
    if r.returncode:
        fail(f"single_run exited {r.returncode}: {r.stderr[-2000:]}")
    path = os.path.join(out_dir, "MultivariateNormal_single_run_RWM_GPU_"
                                 "dim5_1000iters_seed3.json")
    with open(path) as f:
        data = json.load(f)
    say(f"phase 15 single_run --autotune --no_plots: {time.time() - t0:.1f} "
        f"s; acc {data['acceptance_rate']:.4f}, tuned multiplier "
        f"{data['tuned_scale_multiplier']:.4f}, tuned config "
        f"{data['tuned_proposal_config']}; JSON keys are JAX's: "
        f"{set(data) == SINGLE_RUN_KEYS}")
    if set(data) != SINGLE_RUN_KEYS:
        fail(f"single_run JSON keys {sorted(data)}")
    say(f"phase 15 {time.time() - t_phase:.1f} s")


def warp_target(get_target_distribution, kind, d, dev):
    """Phase 16's target of kernel kind ``kind`` at d coordinates (phase
    11's kinds with their d=30 arguments, HybridRosenbrock's blocks for
    d = 100; the iso MVN and FullRosenbrock besides), and its Normal
    variance."""
    if kind == "mvn_iso":
        return (get_target_distribution("MultivariateNormal", d, device=dev),
                2.38 ** 2 / d)
    if kind == "rosenbrock":
        return (get_target_distribution("FullRosenbrock", d, device=dev),
                FLAG["base_variance"] * FLAG["dim"] / d)
    return kind_target(get_target_distribution, kind, d, dev,
                       kw=WARP_KW.get(kind))


def warp_case(torch, gen, algo, tg, var, steps, C, T=10, prop="Normal",
              draw="lax_erfinv", burn_in=0, swap_every=100, seed=61):
    """(launch, plain, output names, args, kw, work) of a launch of fused
    kernel ``algo`` ("pt" or "rwm") on ``tg``: C replicas x T rungs 1 ..
    0.01 (PT) or C chains from the target's init (``gen``), ``steps``
    steps, proposal ``prop`` of Normal variance ``var``
    (:func:`proposal_params`), normal draw ``draw``; ``work`` is
    :func:`pt_work`'s or :func:`rwm_work`'s (None for SuperFunnel, whose
    bound counts the valid log-densities a run meets: phase 17)."""
    from rwm_pt_tpu_torch.kernels import _build, agreement, fused_pt, fused_rwm
    from rwm_pt_tpu_torch.kernels.draws import seed_key
    from rwm_pt_tpu_torch.proposals import create_proposal_distribution
    dev = torch.device("cuda")
    zi = lambda *s: torch.zeros(*s, dtype=torch.int32, device=dev)  # noqa
    zf = lambda *s: torch.zeros(*s, dtype=torch.float32, device=dev)  # noqa
    n_params = _build.kernel_target(tg)[1].numel()
    tkind = _build.target_kind(tg)
    pr = None if prop == "Normal" else create_proposal_distribution(
        tg.dim, {"name": prop, "params": proposal_params(prop, tg.dim, var)},
        device=dev)
    if algo == "pt":
        betas = torch.logspace(0, -2, T, device=dev)
        kind, sig = fused_pt.rung_scales(pr, var, betas,
                                         torch.ones_like(betas))
        x0 = tg.init_sample(C, gen).T[:, None].expand(
            tg.dim, T, C).contiguous()
        args = (tg, x0, zi(T, C), zi(C), zf(C), zf(C), betas, sig,
                seed_key(seed), 0, steps, burn_in, swap_every)
        work = None if tkind == "super_funnel" else pt_work(
            tkind, tg.dim, T, C, steps, burn_in, swap_every, prop=kind,
            draw=draw, n_params=n_params)
        return (fused_pt.launch_pt_kernel, fused_pt._run_pt_fused_plain,
                agreement.PT_OUTPUTS, args, dict(kind=kind, draw=draw),
                work)
    beta = torch.tensor(1.0, device=dev)
    kind, scale = fused_rwm.proposal_scale(pr, var, beta)
    x0 = tg.init_sample(C, gen).T.contiguous()
    args = (tg, x0, zi(C), zf(C), beta, scale, seed_key(seed), 0, steps,
            burn_in)
    work = None if tkind == "super_funnel" else rwm_work(
        tkind, tg.dim, C, steps, prop=kind, draw=draw, n_params=n_params)
    return (fused_rwm.launch_rwm_kernel, fused_rwm._run_rwm_fused_plain,
            agreement.RWM_OUTPUTS, args, dict(kind=kind, draw=draw), work)


def warp_hold(torch, gen, phase, label, algo, tg, var, C, steps,
              record=False, sweep=None, **kw):
    """One hold of a warp library (phases 16b, 20b): the launch of
    :func:`warp_case` (``kw`` its options) against its plain version, at
    every team size the library holds whose block takes the launch, its
    launches counted under the library's ``.w<D>`` key and nowhere else;
    ``record`` records every step of every replica, ``sweep`` the PT pair
    order.  A disagreement fails the smoke.  Returns the least agreeing
    team's ``Agreement``."""
    from rwm_pt_tpu_torch.kernels import _build, agreement, fused_pt, fused_rwm
    wrappers = (fused_pt.launch_pt_kernel, fused_rwm.launch_rwm_kernel)
    launch, plain, names, args, lkw, work = warp_case(torch, gen, algo, tg,
                                                      var, steps, C, **kw)
    if sweep:
        lkw["swap_sweep"] = sweep
    if record:
        lkw.update(record_every=1, record_chains=C)
        names = names + ("chain",)
        work = (work[0], work[1], work[2] + rec_bytes(tg.dim, steps, 1, C),
                work[3])
    b_ms, _, b_lim = bound(*work)
    lib = _build.lib_name(_build.library(f"fused_{algo}", lkw["kind"],
                                         lkw["draw"]),
                          _build.target_kind(tg), tg.dim)
    want = {_build.launch_key(lib)} | (
        {f"fused_{algo}_record"} if record else set())
    plain_ms, p = cuda_ms(torch, lambda: plain(*args, **lkw))
    worst = None
    rungs = kw.get("T", 10) if algo == "pt" else 0
    n_params = _build.kernel_target(tg)[1].numel()
    for team in _build.library_teams(lib):
        try:   # G = 32 takes 16 rungs above the 128 bucket
            if _build.launch_geometry(lib, tg.dim, C, rungs, lkw["kind"],
                                      lkw["draw"], n_params,
                                      team=team).cluster:
                continue   # more than one block of G holds: phase 21
        except ValueError:
            continue
        reset_launches(*wrappers)
        ms, k = cuda_ms(torch, lambda: launch(*args, team=team, **lkw),
                        reps=3)
        seen = read_launches(*wrappers, by_kind=True)
        ag = agreement.hold(k, p, names, lp_of=tg.log_density_td)
        if not _build.is_warp(lib) or set(seen) != want:
            fail(f"phase {phase} {label} G={team}: launches {dict(seen)}, "
                 f"want {want}")
        say(f"phase {phase} {label}: {lib} G={team} kernel {ms:.3f} ms, "
            f"plain {plain_ms:.1f} ms, bound {b_ms:.4f} ms by {b_lim}; "
            f"{agreement.describe(ag)}")
        if ag.frac < AGREE_MIN or ag.mismatched:
            fail(f"phase {phase} {label} G={team} disagrees with its plain "
                 f"version: {agreement.describe(ag)}")
        worst = ag if worst is None or ag.frac < worst.frac else worst
    if worst is None:
        fail(f"phase {phase} {label}: no team size of {lib} takes it")
    return worst


def harness_entry(torch, phase, suffix, algo, d, steps, **kw):
    """``MCMCSimulation`` ``algo`` ("RWM" or "PT"), ``steps`` iterations
    at d coordinates on 4096 chains recording every step of REC_CHAINS
    (``kw``: its target, variance and other options), its launches
    counted from 0: the engine "pallas", a finite (steps, d) chain and one
    launch of a library whose name ends in ``suffix`` (besides the
    recording path's), else the smoke fails.  Returns the launches."""
    from rwm_pt_tpu_torch.api import MCMCSimulation
    from rwm_pt_tpu_torch.kernels import fused_pt, fused_rwm
    wrappers = (fused_pt.launch_pt_kernel, fused_rwm.launch_rwm_kernel)
    sim = MCMCSimulation(dim=d, num_iterations=steps, algorithm=algo,
                         seed=0, num_chains=4096, swap_every=100,
                         record_chain=True, record_chains=REC_CHAINS,
                         device=torch.device("cuda"), **kw)
    reset_launches(*wrappers)
    chain = sim.generate_samples(verbose=False)
    seen = read_launches(*wrappers)
    keys = [k for k in seen if not k.endswith("_record")]
    if (sim.engine_used != "pallas" or chain.shape != (steps, d)
            or not torch.isfinite(torch.as_tensor(chain)).all()
            or not keys or not all(k.endswith(suffix) for k in keys)
            or sum(seen[k] for k in keys) != 1):
        fail(f"phase {phase} MCMCSimulation {algo} d={d}: engine "
             f"{sim.engine_used}, chain {getattr(chain, 'shape', None)}, "
             f"launches {dict(seen)}")
    say(f"phase {phase} MCMCSimulation {algo} d={d} (4096 chains, "
        f"{len(sim.beta_ladder or [])} rungs): engine {sim.engine_used}, "
        f"{sim.elapsed_time * 1e3:.3f} ms wall, acc "
        f"{sim.acceptance_rate():.4f}; launches {dict(seen)}")
    return seen


def study_entry(torch, phase, suffix, d, configs, chains, out_dir):
    """``experiment_rwm`` on the MVN at d coordinates, ``configs`` configs
    of ``chains`` chains (2000 iterations after 200, JSON under
    ``out_dir``), its launches counted from 0: one launch a config, each
    of a library whose name ends in ``suffix``, else the smoke fails.
    Returns the launches."""
    import contextlib
    from rwm_pt_tpu_torch.cli import experiment_rwm
    from rwm_pt_tpu_torch.kernels import fused_pt, fused_rwm
    wrappers = (fused_pt.launch_pt_kernel, fused_rwm.launch_rwm_kernel)
    reset_launches(*wrappers)
    with contextlib.redirect_stdout(sys.stderr):
        data = experiment_rwm.main([
            "--dim", str(d), "--target", "MultivariateNormal",
            "--num_iters", "2000", "--burn_in", "200", "--num_configs",
            str(configs), "--num_chains", str(chains), "--no_plots",
            "--output_dir", out_dir])
    seen = read_launches(*wrappers)
    if (not seen or not all(k.endswith(suffix) for k in seen)
            or sum(seen.values()) != configs):
        fail(f"phase {phase} experiment_rwm --dim {d}: launches "
             f"{dict(seen)}")
    say(f"phase {phase} experiment_rwm --dim {d}, {chains} chains, "
        f"{configs} configs: acc "
        f"{[round(a, 4) for a in data['acceptance_rates']]}; launches "
        f"{dict(seen)}")
    return seen


def phase_16(torch, gen):
    """Phase 16, the warp kernels above 64 dimensions (A15): (b) every warp
    library held against its plain version, (c) Geweke at d = 100, (d) the
    reference's d = 100 RWM campaigns, (e) the entry points at d = 100,
    (f) timing at the main shape beside the bound and the eager engine,
    the normal draws at d = 100, and (for the record) the warp kernels
    beside the thread kernels at d = 30 and the RWM study's d = 20.
    Returns the warp kernels' JSON records, with their launches on the
    runs of (d) and (e)."""
    import contextlib
    import glob

    from rwm_pt_tpu_torch.api import MCMCSimulation
    from rwm_pt_tpu_torch.cli import single_run
    from rwm_pt_tpu_torch.kernels import (_build, agreement, draws, fused_pt,
                                          fused_rwm, run_pt, run_rwm,
                                          run_rwm_fused)
    from rwm_pt_tpu_torch.proposals import (NormalProposal,
                                            create_proposal_distribution)
    from rwm_pt_tpu_torch.targets import get_target_distribution

    t_phase = time.time()
    dev = torch.device("cuda")
    wrappers = (fused_pt.launch_pt_kernel, fused_rwm.launch_rwm_kernel)
    D = WARP_D
    h = WARP_HOLD
    rule = {a: draws.resolve_normal_impl(a, 65536) for a in ("pt", "rwm")}

    def case(algo, tg, var, steps, C, T=h["T"], burn_in=h["burn_in"],
             swap_every=h["swap_every"], **kw):
        return warp_case(torch, gen, algo, tg, var, steps, C, T=T,
                         burn_in=burn_in, swap_every=swap_every,
                         draw=kw.pop("draw", None) or rule[algo], **kw)

    def hold(label, algo, tg, var, C=None, **kw):
        """One 16b hold (:func:`warp_hold`)."""
        return warp_hold(torch, gen, "16b", label, algo, tg, var,
                         C or (h["C_pt"] if algo == "pt" else h["C_rwm"]),
                         h["steps"], **dict(dict(
                             T=h["T"], burn_in=h["burn_in"],
                             swap_every=h["swap_every"],
                             draw=rule[algo]), **kw))

    # ---- (b) holds
    worst = 1.0
    for kind in _build.TARGET_KINDS:
        if kind == "super_funnel":
            continue   # phase 17 holds it at its structure's d
        tg, var = warp_target(get_target_distribution, kind, D, dev)
        worst = min(worst, hold(f"{kind} d={tg.dim} RWM", "rwm", tg,
                                var).frac)
        for sweep in ("sequential", "even_odd"):
            worst = min(worst, hold(f"{kind} d={tg.dim} PT T={h['T']} "
                                    f"{sweep}", "pt", tg, var,
                                    sweep=sweep).frac)
    mvn, var = warp_target(get_target_distribution, "mvn_iso", D, dev)
    for algo in ("rwm", "pt"):
        for prop in NEW_PROPOSALS:
            hold(f"{prop} MVN d={D} {algo.upper()}", algo, mvn, var,
                 prop=prop)
        for dr in draws.NORMAL_IMPLS:
            if dr != rule[algo]:
                hold(f"draw {dr} MVN d={D} {algo.upper()}", algo, mvn, var,
                     draw=dr)
        hold(f"recorded MVN d={D} {algo.upper()}", algo, mvn, var,
             record=True)
        for d_e in WARP_EDGES:
            te, ve = warp_target(get_target_distribution, "mvn_iso", d_e,
                                 dev)
            hold(f"edge d={d_e} {algo.upper()} (1000, ragged)", algo, te, ve,
                 C=1000, T=4)
        te, ve = warp_target(get_target_distribution, "mvn_iso",
                             WARP_EDGES[0], dev)
        hold(f"edge d={WARP_EDGES[0]} {algo.upper()} Box-Muller (odd d)",
             algo, te, ve, C=1000, T=4, draw="bm")
    # odd ladders that fill no whole warp below G = 32: blocks padded with
    # idle teams (and the 256 bucket's only way past 16 rungs)
    for d_o, T_o in ((D, 17), (200, 17), (200, 31)):
        te, ve = warp_target(get_target_distribution, "rosenbrock", d_o, dev)
        hold(f"odd ladder d={d_o} PT T={T_o} (1000, idle teams)", "pt", te,
             ve, C=1000, T=T_o)
    say(f"phase 16b {time.time() - t_phase:.1f} s; least share of replicas "
        f"that agree over the kinds {worst:.5f}")

    # ---- (c) Geweke at d = 100: the iso MVN and IIDGamma's exact
    # tempered law, RWM and PT on six rungs 1 .. 0.3
    seed = int.from_bytes(os.urandom(4), "little")
    ladder = [0.3 ** (t / 5) for t in range(6)]
    gamma, var_g = warp_target(get_target_distribution, "iid_gamma", D, dev)
    for tg, v, exact in ((mvn, var, None),
                         (gamma, var_g, tempered_gamma(gamma))):
        reset_launches(*wrappers)
        z_rwm, z_pt, sw = invariance(torch, tg, seed, betas=ladder,
                                     exact=exact, base_variance=v)
        seen = read_launches(*wrappers, by_kind=True)
        say(f"phase 16c invariance {tg.get_name()} d={tg.dim} (seed {seed}): "
            f"max z RWM {z_rwm:.2f}, PT {z_pt:.2f} (< {Z_INV_MAX}) on rungs "
            f"1 .. 0.3 (6); PT swap acc {sw:.3f}; launches {dict(seen)}")
        if (max(z_rwm, z_pt) >= Z_INV_MAX or not swap_ok(sw, ladder)
                or not all(k.endswith(".w128") for k in seen)):
            fail(f"phase 16c invariance failed for {tg.get_name()}")

    # ---- (d) the reference's d = 100 campaigns through run_rwm_fused
    t0 = time.time()
    reset_launches(*wrappers)
    main_seen = Counter()
    n_runs = 0
    for name, prop, iters, gated in CAMPAIGNS:
        (path,) = glob.glob(os.path.join(
            HERE, "data", "ref_averaged", f"{name}_{prop}_RWM_GPU_dim{D}_"
            f"{iters}iters_seeds*_averaged.json"))
        with open(path) as f:
            ref = json.load(f)
        st = CAMPAIGN["stride"]
        grid = ref["scale_param_range"][::st]
        ref_acc = ref["acceptance_rates"][::st]
        spread = ref["acceptance_rates_seed_std"][::st]
        tg = get_target_distribution(name, D, device=dev)
        zs, accs, secs = [], [], []
        for i, sc in enumerate(grid):
            var_i = float(sc) ** 2 / D
            params = ({"base_radius": float(sc)} if prop == "UniformRadius"
                      else {"base_variance_vector": var_i}
                      if prop == "Laplace" else
                      {"base_variance_scalar": var_i})
            pr = create_proposal_distribution(
                D, {"name": prop, "params": params}, device=dev)
            torch.cuda.synchronize()
            t1 = time.perf_counter()
            res = run_rwm_fused(tg, 1000 + i, proposal=pr,
                                num_chains=CAMPAIGN["chains"],
                                num_iterations=iters,
                                burn_in=CAMPAIGN["burn_in"], device=dev)
            acc = res.acceptance_rate.mean().item()
            secs.append(time.perf_counter() - t1)
            accs.append(acc)
            zs.append(abs(acc - ref_acc[i]) / spread[i])
            n_runs += 1
        jax_file = os.path.join(HERE, "data", "parity_r2",
                                f"{name}_{prop}_RWM_GPU_dim{D}_{iters}"
                                "iters.json")
        with open(jax_file) as f:
            jax_s = json.load(f)["elapsed_s"] / len(grid)
        z_max = max(zs)
        say(f"phase 16d campaign {name} {prop} d={D} {iters} iterations "
            f"({len(grid)} scales, {CAMPAIGN['chains']} chains, burn-in "
            f"{CAMPAIGN['burn_in']}): max z {z_max:.3f} "
            f"({'gate <= ' + str(CAMPAIGN['z_max']) if gated else 'printed'}"
            f"), points beyond 2 sd {sum(z > 2 for z in zs)}; acc "
            f"{[round(a, 4) for a in accs]}; {sum(secs) / len(secs):.3f} s a "
            f"point on this card (the JAX run on its TPU: "
            f"{jax_s:.3f} s a point, data/parity_r2)")
        if gated and z_max > CAMPAIGN["z_max"]:
            fail(f"campaign {name} {prop} d={D}: max z {z_max:.3f}")
    main_seen.update(read_launches(*wrappers))
    if (not all(k.endswith(".w128") for k in main_seen)
            or sum(main_seen.values()) != n_runs):
        fail(f"phase 16d launches {dict(main_seen)}")
    say(f"phase 16d {time.time() - t0:.1f} s; launches {dict(main_seen)}")

    # ---- (e) the entry points at d = 100
    def want_warp(label, seen, n=None):
        keys = [k for k in seen if not k.endswith("_record")]
        if not keys or not all(k.endswith(".w128") for k in keys) or (
                n is not None and sum(seen[k] for k in keys) != n):
            fail(f"phase 16e {label}: launches {dict(seen)}")
        main_seen.update(seen)

    betas4 = [1.0, 0.7, 0.5, 0.35]
    for algo in ("RWM", "PT"):
        main_seen.update(harness_entry(
            torch, "16e", ".w128", algo, D, 2000, sigma=var,
            target_dist="MultivariateNormal",
            beta_ladder=betas4 if algo == "PT" else None, engine="auto"))
    out_dir = os.path.join(HERE, "smoke_out", "warp")
    main_seen.update(study_entry(torch, "16e", ".w128", D, 4, 512,
                                 os.path.join(out_dir, "study")))
    reset_launches(*wrappers)
    with contextlib.redirect_stdout(sys.stderr):
        data = single_run.main([
            "--dim", str(D), "--target", "MultivariateNormal",
            "--num_chains", "1024", "--burn_in", "200", "--num_iters",
            "1000", "--seed", "3", "--no_plots", "--output_dir",
            os.path.join(out_dir, "single_run")])
    seen = read_launches(*wrappers)
    want_warp("single_run", seen)
    say(f"phase 16e single_run --dim {D}: acc {data['acceptance_rate']:.4f};"
        f" launches {dict(seen)}")
    sim = MCMCSimulation(
        dim=D, sigma=var * TUNE["mis"] * 10, num_iterations=1000,
        algorithm="PT", target_dist="MultivariateNormal", seed=0,
        beta_ladder=betas4, num_chains=1024, swap_every=100, burn_in=1000,
        autotune=True, autotune_every=TUNE["every"], record_chain=False,
        engine="pallas", device=dev)
    reset_launches(*wrappers)
    sim.generate_samples(verbose=False)
    seen = read_launches(*wrappers)
    want_warp("autotuned PT", seen, 1)
    mult = sim.get_diagnostic_info()["tuned_scale_multiplier"]
    accs = sim._result.acceptance_rate.mean(1).tolist()
    say(f"phase 16e autotuned PT d={D} (1024 x 4 rungs, variance /10, "
        f"burn-in 1000): tuned multipliers "
        f"{[round(float(m), 3) for m in mult]}, per-rung acc "
        f"{[round(a, 4) for a in accs]}; engine {sim.engine_used}; "
        f"launches {dict(seen)}")
    del sim

    # ---- (f) timing at the main shape, d = 100
    C, Cr, T, iters = FLAG["C"], RWM_MAIN["C"], FLAG["T"], FLAG["iters"]
    kernels = []
    for algo, src, site in (
            ("pt", "fused_pt_warp.cu", "rwm_pt_tpu/kernels/pallas_pt.py:399"),
            ("rwm", "fused_rwm_warp.cu",
             "rwm_pt_tpu/kernels/pallas_rwm.py:570")):
        rb, var_rb = warp_target(get_target_distribution, "rosenbrock", D,
                                 dev)
        name = f"{_build.library(f'fused_{algo}', 'Normal', rule[algo])}.w128"
        cc = C if algo == "pt" else Cr

        def rb_case(steps, hold_, algo=algo, rb=rb, var_rb=var_rb, cc=cc):
            _, _, _, args, kw, work = case(
                algo, rb, var_rb, steps, cc, burn_in=0,
                swap_every=10 if hold_ else FLAG["swap_every"])
            return args, kw, work
        launch, plain, names = (
            (fused_pt.launch_pt_kernel, fused_pt._run_pt_fused_plain,
             agreement.PT_OUTPUTS) if algo == "pt" else
            (fused_rwm.launch_rwm_kernel, fused_rwm._run_rwm_fused_plain,
             agreement.RWM_OUTPUTS))
        rec = kernel_record(torch, name, "rwm_pt_tpu_torch/kernels/csrc/"
                            + src, site, main_seen[name], launch, plain,
                            names, rb_case, iters, phase=16,
                            hold_steps=WARP_MAIN_HOLD_STEPS)
        rec["dim"] = D
        rec["record_launches"] = main_seen[f"fused_{algo}_record"]
        geo = _build.launch_geometry(
            _build.lib_name(_build.library(f"fused_{algo}", "Normal",
                                           rule[algo]), "rosenbrock", D),
            D, cc, T if algo == "pt" else 0, "Normal", rule[algo], D + 1)
        rec["team"], rec["replicas_a_block"] = geo.team, geo.replicas
        say(f"phase 16f {name} FullRosenbrock d={D} at the main shape: the "
            f"geometry's team G={geo.team} ({geo.replicas} "
            f"{'replicas' if algo == 'pt' else 'chains'} a block, "
            f"{geo.threads} threads); {rec['main_path_ms']:.3f} ms against "
            f"its {rec['main_path_bound_ms']:.3f} ms bound "
            f"({100 * rec['main_path_bound_share']:.1f} %)")
        # the iso MVN at the same shape, kernel alone
        _, _, _, args, kw, work = case(algo, mvn, var, iters, cc, burn_in=0,
                                       swap_every=FLAG["swap_every"])
        ms, _ = cuda_ms(torch, lambda: launch(*args, **kw), reps=3)
        b_ms, _, b_lim = bound(*work)
        rec["mvn_iso_ms"], rec["mvn_iso_bound_ms"] = ms, b_ms
        del args
        # the eager engine the harness took before this slice, EAGER_STEPS
        # steps at the same shape, scaled to the main path's steps
        pr = NormalProposal.create(D, var, device=dev)
        if algo == "pt":
            betas = torch.logspace(0, -2, T, device=dev)
            eager = lambda: run_pt(mvn, pr, 5, betas, num_chains=C,  # noqa
                                   num_iterations=EAGER_STEPS,
                                   swap_every=FLAG["swap_every"],
                                   swap_sweep="sequential", device=dev)
        else:
            eager = lambda: run_rwm(mvn, pr, 5, num_chains=Cr,  # noqa
                                    num_iterations=EAGER_STEPS, device=dev)
        eager()
        e_ms, _ = cuda_ms(torch, eager)
        e_step = e_ms / EAGER_STEPS
        say(f"phase 16f {name} MVN d={D} at the main shape ({cc} "
            f"{'replicas x T=10' if algo == 'pt' else 'chains'}, {iters} "
            f"steps): kernel {ms:.3f} ms, bound {b_ms:.3f} ms by {b_lim} "
            f"({100 * b_ms / ms:.1f} %); the eager engine {e_step:.3f} ms a "
            f"step ({EAGER_STEPS} steps), {e_step * iters:.1f} ms for "
            f"{iters} steps")
        rec["eager_ms_per_step"] = e_step
        kernels.append(rec)
        torch.cuda.empty_cache()

    # the exact draws at d = 100 (interleaved, best of 3): the warp rule
    for algo, steps, cc in (("rwm", iters, Cr), ("pt", 200, C)):
        times = {dr: math.inf for dr in EXACT_DRAWS}
        for rep in range(3):
            for dr in (EXACT_DRAWS if rep % 2 == 0 else EXACT_DRAWS[::-1]):
                launch, _, _, args, kw, _ = case(algo, mvn, var, steps, cc,
                                                 draw=dr, burn_in=0,
                                                 swap_every=100)
                ms, _ = cuda_ms(torch, lambda: launch(*args, **kw))
                times[dr] = min(times[dr], ms)
                del args
        best = min(times, key=times.get)
        say(f"phase 16f exact draws, {algo.upper()} MVN d={D}, {cc} "
            f"{'replicas x T=10' if algo == 'pt' else 'chains'}, {steps} "
            f"steps: " + ", ".join(f"{k} {v:.3f} ms" for k, v in
                                   times.items())
            + f"; fastest {best}, the rule takes {rule[algo]}")

    # for the record: the warp kernels beside the thread kernels at d = 30
    # (the flagship and the RWM headline) and the RWM study's d = 20
    study = get_target_distribution(STUDY["target"], STUDY["dim"],
                                    device=dev)
    rb30, var30 = warp_target(get_target_distribution, "rosenbrock",
                              FLAG["dim"], dev)
    for label, algo, tg, v, cc, steps, prop in (
            (f"flagship PT d={FLAG['dim']}", "pt", rb30, var30, C, iters,
             "Normal"),
            (f"RWM headline d={FLAG['dim']}", "rwm", rb30, var30, Cr, iters,
             "Normal"),
            (f"RWM study {STUDY['target']} d={STUDY['dim']}, UniformRadius",
             "rwm", study, 2.4654 ** 2 / STUDY["dim"], STUDY["C"],
             BM_STUDY_STEPS, "UniformRadius")):
        launch, _, _, args, kw, _ = case(algo, tg, v, steps, cc, prop=prop,
                                         draw=draws.resolve_normal_impl(
                                             algo, cc, None), burn_in=0,
                                         swap_every=FLAG["swap_every"])
        t = {False: math.inf, True: math.inf}
        for w in (False, True, True, False):
            ms, _ = cuda_ms(torch, lambda: launch(*args, warp=w, **kw))
            t[w] = min(t[w], ms)
        geo = _build.launch_geometry(
            _build.lib_name(_build.library(f"fused_{algo}", kw["kind"],
                                           kw["draw"]),
                            _build.target_kind(tg), tg.dim, True),
            tg.dim, cc, FLAG["T"] if algo == "pt" else 0, kw["kind"],
            kw["draw"], _build.kernel_target(tg)[1].numel())
        say(f"phase 16f (record only) {label}, {cc} "
            f"{'replicas x T=10' if algo == 'pt' else 'chains'}, {steps} "
            f"steps: thread kernel {t[False]:.3f} ms, warp kernel "
            f"(G={geo.team}) {t[True]:.3f} ms ({t[True] / t[False]:.2f}x)")
        del args
    say(f"phase 16 {time.time() - t_phase:.1f} s")
    return kernels


def sf_target(get_target_distribution, J, K, dev):
    """Phase 17's SuperFunnel: the reference's dataset generator at J
    groups, K covariates, SF["n"] observations a group, seed 42."""
    return get_target_distribution("SuperFunnel", 0, J=J, K=K,
                                   n_per_group=SF["n"], device=dev)


# SASS opcode -> the class phase 17 counts an observation's instructions in
SASS_CLASSES = (("MUFU", ("MUFU",)), ("FFMA", ("FFMA",)),
                ("FMUL/FADD", ("FMUL", "FADD")),
                ("compare/select", ("FSETP", "FSEL", "FMNMX", "FCHK")),
                ("LDS", ("LDS",)), ("LDC", ("LDC", "ULDC")),
                ("integer/index", ("IMAD", "IADD3", "LEA", "SHF", "LOP3",
                                   "ISETP", "SEL", "IABS", "I2F", "F2I",
                                   "MOV", "UMOV", "UIADD3", "ULEA", "USHF",
                                   "UIMAD", "PRMT", "P2R", "R2P", "PLOP3")),
                ("branch", ("BRA", "BSSY", "BSYNC", "CALL", "RET", "WARPSYNC",
                            "EXIT", "BREAK", "NOP")))


def sass_class(line):
    """The class (:data:`SASS_CLASSES`) of a SASS instruction line."""
    m = re.search(r"\*/\s+(?:@!?U?P[T\d]+\s+)?([A-Z][A-Z0-9_]*)", line)
    op = m.group(1) if m else ""
    return next((c for c, ops in SASS_CLASSES if op in ops), "other")


def sf_sass(_build, name):
    """The SuperFunnel likelihood's code in library ``name``'s kernels
    (``cuobjdump -sass``, written to ``smoke_out/super_funnel/``), per
    kernel function ``{function: (MUFU an observation, instructions an
    observation, {class: instructions an observation})}``, static counts:
    the run-time-shape library's observation loop, thread or team (of the
    loops between a backward branch's target and the branch, the innermost
    that holds a MUFU and a loop of its own, the covariates'; one
    observation a trip); a fixed-shape thread build's (``_build.
    fixed_shape``) loop that reads the observations' words with LDC at a
    register index, ``unroll`` of them a trip; a fixed-shape team build's
    innermost loop that holds a MUFU and an LDS (the dataset's words in
    shared memory) and no SHFL (the Philox block loop's broadcasts),
    ``unroll`` a trip, the smallest of its lane's rounds of groups (a build
    unrolled whole has no such loop: its counts are 0).  Fails where the
    toolkit lacks cuobjdump."""
    exe = os.path.join(os.path.dirname(_build._nvcc()), "cuobjdump")
    if not os.path.exists(exe):
        fail(f"no cuobjdump beside nvcc ({exe}): phase 17 cannot read the "
             f"MUFU instructions its bound counts")
    sass = subprocess.run([exe, "-sass", str(_build._lib_path(name))],
                          capture_output=True, text=True, timeout=300).stdout
    out_dir = os.path.join(HERE, "smoke_out", "super_funnel")
    os.makedirs(out_dir, exist_ok=True)
    with open(os.path.join(out_dir, f"{name}.sass"), "w") as f:
        f.write(sass)
    sf = _build.fixed_shape(name)
    out = {}
    for part in sass.split("Function : ")[1:]:
        # the kernel's template arguments: <kind, bucket[, replicas]>
        m = re.search(r"_kernelI((?:Li-?\d+E)+)E", part.split()[0])
        fn = "<" + ",".join(re.findall(r"Li(-?\d+)E", m.group(1) if m
                                       else "")) + ">"
        code = [(int(m.group(1), 16), ln) for ln in part.splitlines()
                for m in [re.search(r"/\*([0-9a-f]{4,})\*/", ln)] if m]
        loops = []
        for a, ln in code:
            br = re.search(r"\bBRA\b[^;]*?0x([0-9a-f]+)", ln)
            if br and int(br.group(1), 16) < a:
                t = int(br.group(1), 16)
                loops.append((t, a, [x for b, x in code if t <= b <= a]))
        if sf is None:
            per = 1
            runs = [lp for t, a, lp in loops
                    if any("MUFU" in x for x in lp)
                    and any(t <= t2 and a2 < a for t2, a2, _ in loops)]
        elif _build.is_warp(name):
            per = sf["unroll"]
            runs = [lp for t, a, lp in loops
                    if any("MUFU" in x for x in lp)
                    and any(re.search(r"\bLDS", x) for x in lp)
                    and not any("SHFL" in x for x in lp)
                    and not any(t <= t2 and a2 < a and (t2, a2) != (t, a)
                                for t2, a2, _ in loops)]
        else:
            per = sf["unroll"]
            runs = [lp for _, _, lp in loops
                    if any("MUFU" in x for x in lp) and any(
                        re.search(r"LDC[^;]*c\[0x0\]\[R", x) for x in lp)]
        runs = [min(runs, key=len)] if runs else []
        n_ins = sum(len(r) for r in runs)
        if not runs:
            out[fn] = (0.0, 0.0, {})
            continue
        classes = Counter(sass_class(x) for r in runs for x in r)
        out[fn] = (classes["MUFU"] / per, n_ins / per,
                   {c: round(v / per, 2) for c, v in classes.items()})
    return out


def sf_counted(plain, args, kw):
    """``plain(*args, **kw)`` with its SuperFunnel target ``args[0]``
    counting the log-densities whose taus both exceed 1e-9, the only ones
    whose likelihood the kernels compute (the others return -inf after
    the taus' test): ``(outputs, count)``.  The count adds a compare and
    a sum to each of the plain version's log-densities."""
    tg, total = args[0], [0]

    class Counted:
        def __getattr__(self, name):
            return getattr(tg, name)

        def log_density_td(self, x):
            total[0] = total[0] + ((x[-2] > 1e-9) & (x[-1] > 1e-9)).sum()
            return tg.log_density_td(x)

    out = plain(Counted(), *args[1:], **kw)
    return out, int(total[0])


def phase_17(torch, gen):
    """Phase 17, SuperFunnel (kernel kind 12, A9): (a) every SuperFunnel
    kernel held against its plain version from the default init's -inf
    starts: the thread kernels at the reference's J = 5, K = 3, n = 20
    (d = 26) and the team kernels at J = 10, K = 5 (d = 68, .w128) and
    J = 40, K = 3 (d = 166, .w256) at every team size, PT and RWM, the
    Normal proposal with the rule's draw, Laplace, UniformRadius and PT
    recorded, the fixed-shape builds beside the run-time-shape ones; (b)
    the main paths through MCMCSimulation, RWM at 65,536 chains and PT on
    the geometric ladder (T = 8) at 65,536 replicas, 2000 steps, launches
    counted, best of 3 beside the kernel alone and its bound, the team
    kernels' entry points at d = 68 and 166 (4096 and the full width)
    and the run-time team library's at datasets over the shared memory,
    fused against eager at 4096 replicas (no direct sampler: no Geweke
    gate); (c) the
    RWM study at launch_rwm_pod.sh's shape, 4 configs; (d) a PT run with
    autotune_ladder=True.  Returns the kernels' JSON records."""
    import contextlib

    from rwm_pt_tpu_torch.api import MCMCSimulation
    from rwm_pt_tpu_torch.cli import experiment_rwm
    from rwm_pt_tpu_torch.kernels import (_build, agreement, draws, fused_pt,
                                          fused_rwm, run_pt, run_pt_fused,
                                          run_rwm, run_rwm_fused)
    from rwm_pt_tpu_torch.kernels.draws import seed_key
    from rwm_pt_tpu_torch.ladders import construct_geometric_ladder
    from rwm_pt_tpu_torch.proposals import (NormalProposal,
                                            create_proposal_distribution)
    from rwm_pt_tpu_torch.targets import get_target_distribution

    t_phase = time.time()
    dev = torch.device("cuda")
    zi = lambda *s: torch.zeros(*s, dtype=torch.int32, device=dev)  # noqa
    zf = lambda *s: torch.zeros(*s, dtype=torch.float32, device=dev)  # noqa
    wrappers = (fused_pt.launch_pt_kernel, fused_rwm.launch_rwm_kernel)
    h = SF_HOLD
    var = SF_VAR
    ladder = construct_geometric_ladder()          # 1 .. 0.01, T = 8
    T = len(ladder)
    rule = {a: draws.resolve_normal_impl(a, 65536, "super_funnel")
            for a in ("pt", "rwm")}

    def case(algo, tg, steps, C, prop="Normal", draw=None, record=False,
             burn_in=h["burn_in"], swap_every=h["swap_every"], seed=71):
        """(launch, plain, names, args, kw, work_of) of a kernel launch on
        SuperFunnel ``tg`` from the default init (most states at -inf);
        ``work_of(valid)`` is its work with ``valid`` log-densities whose
        taus are valid (:func:`sf_counted`)."""
        sf = (tg.J, tg.K, tg.Y.shape[1])
        draw = draw or rule[algo]
        n_params = _build.kernel_target(tg)[1].numel()
        pr = None if prop == "Normal" else create_proposal_distribution(
            tg.dim, {"name": prop, "params": proposal_params(
                prop, tg.dim, var)}, device=dev)
        rec = dict(record_every=1, record_chains=C) if record else {}
        if algo == "pt":
            betas = torch.tensor(ladder, device=dev)
            kind, sig = fused_pt.rung_scales(pr, var, betas,
                                             torch.ones_like(betas))
            x0 = tg.init_sample(C, gen).T[:, None].expand(
                tg.dim, T, C).contiguous()
            args = (tg, x0, zi(T, C), zi(C), zf(C), zf(C), betas, sig,
                    seed_key(seed), 0, steps, burn_in, swap_every)
            work = lambda valid: pt_work(  # noqa: E731
                "super_funnel", tg.dim, T, C, steps, burn_in, swap_every,
                prop=kind, draw=draw, n_params=n_params, sf=sf + (valid,),
                record_every=1 if record else 0,
                rec_chains=C if record else 0)
            names = agreement.PT_REC_OUTPUTS if record else \
                agreement.PT_OUTPUTS
            return (fused_pt.launch_pt_kernel, fused_pt._run_pt_fused_plain,
                    names, args, dict(kind=kind, draw=draw, **rec), work)
        beta = torch.tensor(1.0, device=dev)
        kind, scale = fused_rwm.proposal_scale(pr, var, beta)
        x0 = tg.init_sample(C, gen).T.contiguous()
        args = (tg, x0, zi(C), zf(C), beta, scale, seed_key(seed), 0, steps,
                burn_in)
        work = lambda valid: rwm_work(  # noqa: E731
            "super_funnel", tg.dim, C, steps, prop=kind, draw=draw,
            n_params=n_params, sf=sf + (valid,),
            record_every=1 if record else 0, rec_chains=C if record else 0)
        names = agreement.RWM_REC_OUTPUTS if record else agreement.RWM_OUTPUTS
        return (fused_rwm.launch_rwm_kernel, fused_rwm._run_rwm_fused_plain,
                names, args, dict(kind=kind, draw=draw, **rec), work)

    # ---- (a) holds, every variant, every team size, from -inf starts
    thread_tg = sf_target(get_target_distribution, SF["J"], SF["K"], dev)
    every = [("Normal", False), ("Laplace", False), ("UniformRadius", False)]
    shapes = [(thread_tg, h["steps"], h["C"], h["C"], every)]
    shapes += [(sf_target(get_target_distribution, J, K, dev),
                h["edge_steps"], h["C"], h["C"], [("Normal", False)])
               for J, K in SF_THREAD_EDGES]
    shapes += [(sf_target(get_target_distribution, J, K, dev),
                h["warp_steps"], h["warp_C_pt"], h["warp_C_rwm"], every)
               for J, K in SF_WARP]
    worst, n_holds = 1.0, 0
    for tg, steps, c_pt, c_rwm, props in shapes:
        for algo in ("pt", "rwm"):
            C = c_pt if algo == "pt" else c_rwm
            warp_shape = tg.dim > _build.BUCKETS[-1]
            variants = props + ([("Normal", True)]
                                if algo == "pt" and len(props) > 1 else [])
            for prop, record in variants:
                launch, plain, names, args, kw, _ = case(
                    algo, tg, steps, C, prop=prop, record=record)
                variant = _build.library(f"fused_{algo}", kw["kind"],
                                         kw["draw"])
                # the fixed-shape build the route takes, and on the same
                # inputs the run-time-shape library: the team shapes' at
                # every variant, the reference's dataset's at its Normal
                specs = ((True, False) if warp_shape or (
                    tg is thread_tg and prop == "Normal" and not record)
                    else (True,))
                starts = torch.isinf(tg.log_density_td(args[1])).float() \
                    .mean().item()
                plain_ms, p = cuda_ms(torch, lambda: plain(*args, **kw))
                lib = _build.route(variant, tg)[0]
                teams = (_build.library_teams(lib) if _build.is_warp(lib)
                         else (None,))
                for team in teams:
                    if algo == "pt" and team is not None and \
                            T * team > _build.pt_team_threads(
                                _build.warp_bucket(tg.dim), team):
                        continue
                    outs = {}
                    for spec in specs:
                        lib = _build.route(variant, tg, specialize=spec)[0]
                        reset_launches(*wrappers)
                        tkw = dict(kw, specialize=spec, **(
                            {} if team is None else {"team": team}))
                        ms, k = cuda_ms(torch, lambda: launch(*args, **tkw))
                        seen = read_launches(*wrappers, by_kind=True)
                        ag = agreement.hold(k, p, names,
                                            lp_of=tg.log_density_td)
                        g_txt = "" if team is None else f" G={team}"
                        what = (f"replicas x T={T}" if algo == "pt"
                                else "chains")
                        label = (f"phase 17a {lib}{g_txt}"
                                 f" {'recorded ' if record else ''}"
                                 f"d={tg.dim} (J={tg.J}, K={tg.K}) {C} "
                                 f"{what}, {steps} steps, "
                                 f"{100 * starts:.1f} % of the states "
                                 f"start at -inf")
                        if _build.launch_key(lib) not in seen:
                            fail(f"{label}: launches {dict(seen)}")
                        say(f"{label}: kernel {ms:.3f} ms, plain "
                            f"{plain_ms:.1f} ms; {agreement.describe(ag)}")
                        # a fixed-shape build holds on every replica with
                        # lp bit-equal to the plain version's
                        strict = spec and (ag.frac < 1.0 or ag.max_rel.get(
                            "lp", 0.0) != 0.0)
                        if ag.frac < AGREE_MIN or ag.mismatched or strict:
                            fail(f"{label} disagrees with its plain version")
                        worst = min(worst, ag.frac)
                        n_holds += 1
                        outs[spec] = k
                    if len(outs) == 2:
                        same = {n: torch.equal(x, y) for n, x, y in zip(
                            names, outs[True], outs[False])}
                        say(f"phase 17a {variant} d={tg.dim}{g_txt}: the "
                            f"fixed-shape and the run-time-shape libraries' "
                            f"outputs equal bit for bit: {same}")
                        if not all(same.values()):
                            fail(f"phase 17a {variant} d={tg.dim}{g_txt}: "
                                 f"the fixed-shape and the run-time-shape "
                                 f"libraries part ways")
                    del outs, k
                del args, p
    say(f"phase 17a {time.time() - t_phase:.1f} s: {n_holds} holds; least "
        f"share of replicas that agree {worst:.5f}")

    # the likelihood's MUFU and instructions an observation, from the SASS
    # of the fixed-shape and the run-time-shape libraries, thread and team
    sass = {}
    team_tgs = [sf_target(get_target_distribution, J, K, dev)
                for J, K in SF_WARP]
    for algo, sass_tg, spec in [(a, t, s) for a in ("pt", "rwm")
                                for t in [thread_tg] + team_tgs
                                for s in (True, False)]:
        sass_lib = _build.route(_build.library(
            f"fused_{algo}", "Normal", rule[algo]), sass_tg,
            specialize=spec)[0]
        per_fn = sf_sass(_build, sass_lib)
        sass[sass_lib] = per_fn
        say(f"phase 17 SASS {sass_lib} (static, per kernel "
            f"instantiation <kind, bucket[, replicas]>): MUFU, "
            f"instructions and their classes an observation "
            + "; ".join(f"{fn} {m:.3f} MUFU, {i:.2f} instructions "
                        f"{cls}" for fn, (m, i, cls) in per_fn.items())
            + f"; the bound counts SF_MUFU_PER_OBS = {SF_MUFU_PER_OBS}")
        # exact: both are loops, a whole number of observations a trip
        if not per_fn or any(m != SF_MUFU_PER_OBS
                             for m, _, _ in per_fn.values()):
            fail(f"phase 17: {sass_lib}'s likelihood holds "
                 f"{[m for m, _, _ in per_fn.values()]} MUFU an "
                 f"observation, the bound counts {SF_MUFU_PER_OBS}")

    # ---- (b) the main paths through MCMCSimulation
    main_seen = Counter()
    kernels = []
    C = SF_MAIN["C"]
    iters = SF_MAIN["iters"]
    for algo in ("RWM", "PT"):
        def make(seed, algo=algo):
            return MCMCSimulation(
                dim=None, sigma=var, num_iterations=iters, algorithm=algo,
                target_dist="SuperFunnel", seed=seed,
                beta_ladder=ladder if algo == "PT" else None,
                num_chains=C, swap_every=SF_MAIN["swap_every"],
                record_chain=False, device=dev)
        sim = make(0)
        reset_launches(*wrappers)
        sim.generate_samples(verbose=False)
        torch.cuda.synchronize()
        seen = read_launches(*wrappers, by_kind=True)
        main_seen.update(seen)
        key = _build.launch_key(_build.route(_build.library(
            f"fused_{algo.lower()}", "Normal", rule[algo.lower()]),
            thread_tg)[0])
        if dict(seen) != {key: 1} or sim.engine_used != "pallas" or \
                _build.fixed_shape(key + ".d32") is None:
            fail(f"phase 17b {algo}: launches {dict(seen)}, engine "
                 f"{sim.engine_used}")
        res = sim._result
        acc = res.acceptance_rate.float()
        lp = res.state.logp
        if not (torch.isfinite(res.state.x).all() and sim.dim == 26
                and 0 < acc.mean().item() < 1):
            fail(f"phase 17b {algo}: state or acceptance out of range")
        wall = []
        for rep in (1, 2, 3):
            s2 = make(rep)
            ms, _ = cuda_ms(torch, lambda: s2.generate_samples(verbose=False))
            wall.append(ms)
            del s2
        per_rung = acc.mean(-1).tolist() if algo == "PT" else [
            acc.mean().item()]
        extra = (f", swap acc {res.swap_acceptance_rate.mean().item():.4f}"
                 if algo == "PT" else "")
        steps_mh = iters * C * (T if algo == "PT" else 1)
        say(f"phase 17b MCMCSimulation SuperFunnel {algo} (d=26, {C} "
            f"{'replicas x T=%d' % T if algo == 'PT' else 'chains'}, {iters} "
            f"steps, variance {var}): engine {sim.engine_used}, launches "
            f"{dict(seen)}; {steps_mh / (min(wall) / 1e3):.6g} MH steps/s "
            f"(best of 3 through the entry point: "
            f"{[round(t, 3) for t in wall]} ms); acc "
            f"{[round(a, 4) for a in per_rung]}{extra}; final -inf share "
            f"{torch.isinf(lp).float().mean().item():.5f}")
        del sim, res
        torch.cuda.empty_cache()

    # the run-time-shape library's entry point: a dataset of the reference's
    # J and K too large for the fixed-shape builds (SF_RUN_TIME_N a group)
    run_time_tg = get_target_distribution(
        "SuperFunnel", 0, J=SF["J"], K=SF["K"], n_per_group=SF_RUN_TIME_N,
        device=dev)
    for algo in ("RWM", "PT"):
        sim = MCMCSimulation(
            dim=None, sigma=var, num_iterations=SF_RUN_TIME_PATH["iters"],
            algorithm=algo, target_dist="SuperFunnel",
            target_kwargs={"n_per_group": SF_RUN_TIME_N},
            beta_ladder=ladder if algo == "PT" else None,
            num_chains=SF_RUN_TIME_PATH["C"],
            swap_every=SF_MAIN["swap_every"], record_chain=False, device=dev)
        reset_launches(*wrappers)
        sim.generate_samples(verbose=False)
        seen = read_launches(*wrappers, by_kind=True)
        main_seen.update(seen)
        key = _build.launch_key(_build.lib_name(_build.library(
            f"fused_{algo.lower()}", "Normal", rule[algo.lower()]),
            "super_funnel", sim.dim))
        if dict(seen) != {key: 1} or sim.engine_used != "pallas" or \
                not torch.isfinite(sim._result.state.x).all():
            fail(f"phase 17b run-time shape {algo}: launches {dict(seen)}, "
                 f"engine {sim.engine_used}")
        say(f"phase 17b MCMCSimulation SuperFunnel {algo} n_per_group="
            f"{SF_RUN_TIME_N} (d={sim.dim}, {SF_RUN_TIME_PATH['C']}, "
            f"{SF_RUN_TIME_PATH['iters']} steps; the run-time-shape "
            f"library): launches {dict(seen)}, acc "
            f"{sim._result.acceptance_rate.float().mean().item():.4f}")
        del sim

    # the run-time team library's entry points: datasets over the team
    # kernels' shared-memory budget
    for J, K, n in SF_TEAM_RUN_TIME:
        for algo in ("RWM", "PT"):
            sim = MCMCSimulation(
                dim=None, sigma=var,
                num_iterations=SF_TEAM_RUN_TIME_PATH["iters"],
                algorithm=algo, target_dist="SuperFunnel",
                target_kwargs={"J": J, "K": K, "n_per_group": n},
                beta_ladder=ladder if algo == "PT" else None,
                num_chains=SF_TEAM_RUN_TIME_PATH["C"],
                swap_every=SF_MAIN["swap_every"], record_chain=False,
                device=dev)
            reset_launches(*wrappers)
            sim.generate_samples(verbose=False)
            seen = read_launches(*wrappers, by_kind=True)
            main_seen.update(seen)
            key = _build.launch_key(_build.lib_name(_build.library(
                f"fused_{algo.lower()}", "Normal", rule[algo.lower()]),
                "super_funnel", sim.dim))
            if dict(seen) != {key: 1} or sim.engine_used != "pallas" or \
                    not torch.isfinite(sim._result.state.x).all():
                fail(f"phase 17b run-time team {algo} J={J} K={K} n={n}: "
                     f"launches {dict(seen)}, engine {sim.engine_used}")
            say(f"phase 17b MCMCSimulation SuperFunnel {algo} J={J} K={K} "
                f"n_per_group={n} (d={sim.dim}, {SF_TEAM_RUN_TIME_PATH['C']}"
                f", {SF_TEAM_RUN_TIME_PATH['iters']} steps; the run-time "
                f"team library): launches {dict(seen)}, acc "
                f"{sim._result.acceptance_rate.float().mean().item():.4f}")
            del sim

    # the team kernels' entry points: RWM and PT at d = 68 and 166, each
    # through the fixed-shape team build, at SF_TEAM_TIME's size (the main
    # path of these builds: its launches are the records' below, which
    # hold the kernels at this size) and, as a side line outside the
    # records, at the main paths' full width, timed best of 2 through the
    # entry point against the bound if every log-density were valid (no
    # plain run at this size counts them: the share is at most the one
    # printed)
    for J, K in SF_WARP:
        team_tg = sf_target(get_target_distribution, J, K, dev)
        for algo in ("RWM", "PT"):
            key = _build.launch_key(_build.route(_build.library(
                f"fused_{algo.lower()}", "Normal", rule[algo.lower()]),
                team_tg)[0])
            entry = SF_TEAM_TIME["C_pt" if algo == "PT" else "C_rwm"]
            for cc, n_it in ((entry, SF_TEAM_TIME["steps"]), (C, iters)):
                def make(seed, algo=algo, cc=cc, n_it=n_it):
                    return MCMCSimulation(
                        dim=None, sigma=var, num_iterations=n_it,
                        algorithm=algo, target_dist="SuperFunnel",
                        target_kwargs={"J": J, "K": K}, seed=seed,
                        beta_ladder=ladder if algo == "PT" else None,
                        num_chains=cc, swap_every=SF_MAIN["swap_every"],
                        record_chain=False, device=dev)
                side = n_it == iters
                sim = make(0)
                reset_launches(*wrappers)
                sim.generate_samples(verbose=False)
                torch.cuda.synchronize()
                seen = read_launches(*wrappers, by_kind=True)
                if not side:
                    main_seen.update(seen)
                if (dict(seen) != {key: 1} or not _build.is_warp(key)
                        or _build.fixed_shape(key) is None
                        or sim.engine_used != "pallas"
                        or not torch.isfinite(sim._result.state.x).all()):
                    fail(f"phase 17b team {algo} J={J} K={K} ({cc}): "
                         f"launches {dict(seen)}, engine {sim.engine_used}")
                acc = sim._result.acceptance_rate.float().mean().item()
                timing = ""
                if side:
                    wall = []
                    for rep in (1, 2):
                        s2 = make(rep)
                        ms, _ = cuda_ms(torch, lambda: s2.generate_samples(
                            verbose=False))
                        wall.append(ms)
                        del s2
                    rungs = T if algo == "PT" else 1
                    evals = cc * rungs * (n_it + 1)
                    sf = (J, K, SF["n"], evals)
                    work = (pt_work("super_funnel", team_tg.dim, T, cc, n_it,
                                    0, SF_MAIN["swap_every"],
                                    draw=rule["pt"], sf=sf)
                            if algo == "PT" else
                            rwm_work("super_funnel", team_tg.dim, cc, n_it,
                                     draw=rule["rwm"], sf=sf))
                    b_ms, _, b_lim = bound(*work)
                    timing = (f"; {n_it * cc * rungs / (min(wall) / 1e3):.6g}"
                              f" MH steps/s (best of 2 through the entry "
                              f"point: {[round(t, 3) for t in wall]} ms); "
                              f"bound at most {b_ms:.3f} ms by {b_lim} "
                              f"(every log-density counted valid): at most "
                              f"{100 * b_ms / min(wall):.1f} % of it reached")
                label = "side line, not in the kernels record: " \
                    if side else ""
                say(f"phase 17b {label}MCMCSimulation SuperFunnel {algo} "
                    f"J={J} K={K} (d={sim.dim}, {cc}"
                    f"{' x T=%d' % T if algo == 'PT' else ''}, {n_it} "
                    f"steps): engine {sim.engine_used}, launches "
                    f"{dict(seen)}, acc {acc:.4f}{timing}")
                del sim
                torch.cuda.empty_cache()

    # fused against eager at 4096 replicas: per-rung MH and swap acceptance
    Ce = SF_EAGER["C"]
    kw = dict(num_chains=Ce, num_iterations=SF_EAGER["iters"],
              burn_in=SF_EAGER["burn_in"], swap_every=SF_EAGER["swap_every"],
              device=dev)
    fz = run_pt_fused(thread_tg, 31, ladder, base_variance=var, **kw)
    ez = run_pt(thread_tg, NormalProposal.create(thread_tg.dim, var,
                                                 device=dev), 32, ladder,
                swap_sweep="sequential", **kw)
    zs = [per_chain_z(fz.acceptance_rate[t], ez.acceptance_rate[t])
          for t in range(T)]
    z_sw = per_chain_z(fz.swap_acceptance_rate, ez.swap_acceptance_rate)
    fr = run_rwm_fused(thread_tg, 33, base_variance=var, num_chains=Ce,
                       num_iterations=SF_EAGER["iters"],
                       burn_in=SF_EAGER["burn_in"], device=dev)
    er = run_rwm(thread_tg, NormalProposal.create(thread_tg.dim, var,
                                                  device=dev), 34,
                 num_chains=Ce, num_iterations=SF_EAGER["iters"],
                 burn_in=SF_EAGER["burn_in"], device=dev)
    z_r = per_chain_z(fr.acceptance_rate, er.acceptance_rate)
    say(f"phase 17b fused vs eager (SuperFunnel d=26, {Ce} replicas x T={T}"
        f", {SF_EAGER['iters']} steps after {SF_EAGER['burn_in']}): per-rung "
        f"MH acc {[round(a, 4) for a in fz.acceptance_rate.mean(1).tolist()]}"
        f" vs {[round(a, 4) for a in ez.acceptance_rate.mean(1).tolist()]} "
        f"(max z {max(zs):.2f}), swap acc "
        f"{fz.swap_acceptance_rate.mean().item():.4f} vs "
        f"{ez.swap_acceptance_rate.mean().item():.4f} (z {z_sw:.2f}); RWM "
        f"acc {fr.acceptance_rate.mean().item():.4f} vs "
        f"{er.acceptance_rate.mean().item():.4f} (z {z_r:.2f}); z < "
        f"{Z_RATE_MAX}.  No Geweke gate: SuperFunnel has no direct sampler")
    if max(zs + [z_sw, z_r]) >= Z_RATE_MAX:
        fail("phase 17b fused and eager rates disagree on SuperFunnel")
    del fz, ez, fr, er

    # each kernel alone, best of 3, at its entry point's size: the thread
    # kernels at the main path's (the fixed-shape builds) and at the n = 50
    # entry point's (the run-time-shape library), the team kernels at
    # SF_TEAM_TIME's (the fixed-shape builds) and at SF_TEAM_RUN_TIME_PATH's
    # (the run-time team library) at the team size the geometry picks;
    # each held against its plain version there, whose run counts the
    # valid log-densities that the bound's work counts
    records = [(thread_tg, algo, C, HOLD_STEPS) for algo in ("pt", "rwm")]
    records += [(run_time_tg, algo, SF_RUN_TIME_PATH["C"],
                 SF_RUN_TIME_PATH["iters"]) for algo in ("pt", "rwm")]
    records += [(sf_target(get_target_distribution, J, K, dev), algo,
                 SF_TEAM_TIME["C_pt" if algo == "pt" else "C_rwm"],
                 SF_TEAM_TIME["steps"])
                for J, K in SF_WARP for algo in ("pt", "rwm")]
    records += [(get_target_distribution(
        "SuperFunnel", 0, J=J, K=K, n_per_group=n, device=dev), algo,
        SF_TEAM_RUN_TIME_PATH["C"], SF_TEAM_RUN_TIME_PATH["iters"])
        for J, K, n in SF_TEAM_RUN_TIME for algo in ("pt", "rwm")]
    for tg, algo, cc, steps in records:
        variant = _build.library(f"fused_{algo}", "Normal", rule[algo])
        launch, plain, names, args, kw, work_of = case(
            algo, tg, steps, cc, burn_in=0, swap_every=SF_MAIN["swap_every"])
        plain_ms, (p, valid) = cuda_ms(
            torch, lambda: sf_counted(plain, args, kw))
        flops, int_ops, nbytes, mufu_n = work = work_of(valid)
        b_ms, b_by, b_lim = bound(*work)
        evals = cc * (T if algo == "pt" else 1) * (steps + 1)
        n_obs = tg.Y.shape[1]
        lib = _build.route(variant, tg)[0]
        key = _build.launch_key(lib)
        warp = _build.is_warp(lib)
        what = (f"at {cc} "
                f"{'replicas x T=%d' % T if algo == 'pt' else 'chains'}, "
                f"{steps} steps")

        def held(spec, lib):
            """(ms, outputs, agreement) of ``lib`` launched as the route
            takes it (``spec``: specialize=), held against the plain
            version: every replica, lp rel diff 0, in a thread kernel and
            in a fixed-shape team build."""
            ms, k = cuda_ms(torch, lambda: launch(*args, **kw, **(
                {} if spec else {"specialize": False})), reps=3)
            ag = agreement.hold(k, p, names, lp_of=tg.log_density_td)
            strict = (not _build.is_warp(lib) or _build.fixed_shape(lib)) \
                and (ag.frac < 1.0 or ag.max_rel.get("lp", 0.0) != 0.0)
            if ag.frac < AGREE_MIN or ag.mismatched or strict:
                fail(f"phase 17 {lib} disagrees with its plain version "
                     f"{what}: {agreement.describe(ag)}")
            return ms, k, ag

        ms, k, ag = held(True, lib)
        team = (_build.launch_geometry(
            lib, tg.dim, cc, T if algo == "pt" else 0, "Normal",
            rule[algo], _build.kernel_target(tg)[1].numel()).team
            if warp else None)
        say(f"phase 17 {lib} (J={tg.J}, K={tg.K}, n={n_obs}, d={tg.dim}"
            f"{f', G={team}' if warp else ''}) {what}: kernel {ms:.3f} ms, "
            f"plain {plain_ms:.1f} ms; {valid} of {evals} log-densities "
            f"valid ({100 * valid / evals:.2f} %); bound {b_ms:.3f} ms by "
            f"{b_lim} ({100 * b_ms / ms:.1f} % of it reached; "
            f"{flops:.4g} flops, {int_ops:.4g} Philox int ops, "
            f"{mufu_n:.4g} MUFU, {nbytes:.4g} B); {agreement.describe(ag)}")
        rec = dict(
            name=key, route="cuda",
            source=f"rwm_pt_tpu_torch/kernels/csrc/fused_{algo}"
                   f"{'_warp' if warp else ''}.cu",
            replaces=("rwm_pt_tpu/kernels/pallas_pt.py:399"
                      if algo == "pt" else
                      "rwm_pt_tpu/kernels/pallas_rwm.py:570"),
            launches=main_seen[key], max_abs_err=ag.max_dx, ms=ms,
            plain_ms=plain_ms, bound_ms=b_ms, bound_by=b_by,
            library_ms=None, steps=steps, chains=cc, agree_frac=ag.frac,
            max_rel_err=ag.max_rel, flops=flops, philox_int_ops=int_ops,
            mufu=mufu_n, bytes=nbytes, bound_limit=b_lim,
            bound_share=b_ms / ms, valid_share=valid / evals, dim=tg.dim,
            J=tg.J, K=tg.K, n=n_obs, team=team,
            fixed_shape=_build.fixed_shape(lib) is not None,
            sass_per_obs={fn: dict(mufu=m, instructions=i)
                          for fn, (m, i, _) in sass.get(lib, {}).items()})
        if rec["fixed_shape"]:
            # a side record: the run-time-shape library on the same inputs,
            # held alike and equal to the fixed-shape build bit for bit
            rt_lib = _build.route(variant, tg, specialize=False)[0]
            rt_ms, rt, rt_ag = held(False, rt_lib)
            same = [torch.equal(x, y) for x, y in zip(k, rt)]
            say(f"phase 17 side record {rt_lib} on {lib}'s inputs {what}: "
                f"kernel {rt_ms:.3f} ms ({100 * b_ms / rt_ms:.1f} % of the "
                f"bound); {agreement.describe(rt_ag)}; outputs equal to the "
                f"fixed-shape build's bit for bit: "
                f"{dict(zip(names, same))}")
            if not all(same):
                fail(f"phase 17 {variant}: the fixed-shape and the run-time "
                     f"libraries part ways")
            rec["run_time_on_these_inputs"] = dict(
                name=_build.launch_key(rt_lib), ms=rt_ms,
                bound_share=b_ms / rt_ms, agree_frac=rt_ag.frac,
                max_abs_err=rt_ag.max_dx, equal_bit_for_bit=True,
                sass_per_obs={fn: dict(mufu=m, instructions=i)
                              for fn, (m, i, _) in
                              sass.get(rt_lib, {}).items()})
            del rt
        if rec["launches"] < 1:
            fail(f"phase 17: {key} was not launched on its entry point")
        kernels.append(rec)
        del args, p, k
        torch.cuda.empty_cache()

    # ---- (c) the RWM study at launch_rwm_pod.sh's shape, 4 configs
    out_dir = os.path.join(HERE, "smoke_out", "super_funnel")
    reset_launches(*wrappers)
    with contextlib.redirect_stdout(sys.stderr):
        data = experiment_rwm.main([
            "--target", "SuperFunnel", "--proposal", "Normal",
            "--num_iters", str(STUDY["iters"]), "--burn_in",
            str(STUDY["burn_in"]), "--num_chains", str(STUDY["C"]),
            "--var_max", str(STUDY["var_max"]), "--seed", str(STUDY["seed"]),
            "--num_configs", str(SF_STUDY_CONFIGS), "--no_plots",
            "--output_dir", os.path.join(out_dir, "study")])
    seen = read_launches(*wrappers, by_kind=True)
    key = _build.launch_key(_build.route(
        _build.library("fused_rwm", "Normal", rule["rwm"]), thread_tg)[0])
    if dict(seen) != {key: SF_STUDY_CONFIGS}:
        fail(f"phase 17c study launches {dict(seen)}")
    missing = SF_STUDY_KEYS - set(data)
    if missing or len(data["acceptance_rates"]) != SF_STUDY_CONFIGS:
        fail(f"phase 17c study JSON lacks the JAX keys {missing}")
    say(f"phase 17c experiment_rwm --target SuperFunnel (d=26, Normal, "
        f"{STUDY['C']} chains, {STUDY['iters']} iterations, burn-in "
        f"{STUDY['burn_in']}, {SF_STUDY_CONFIGS} of the CLI's 40 configs): "
        f"{[round(t, 3) for t in data['times']]} s a config; acc "
        f"{[round(a, 4) for a in data['acceptance_rates']]}; ESJD-optimal "
        f"acc {data['max_acceptance_rate']:.4f} at scale "
        f"{data['max_scale_param']:.4f}; launches {dict(seen)}; JSON keys as "
        f"JAX's")

    # ---- (d) a PT run with the ladder tuner, then one fused launch
    sim = MCMCSimulation(
        dim=None, sigma=var, num_iterations=SF_TUNE["iters"], algorithm="PT",
        target_dist="SuperFunnel", beta_ladder=ladder,
        num_chains=SF_TUNE["C"], swap_every=SF_MAIN["swap_every"],
        burn_in=SF_TUNE["burn_in"], autotune_ladder=True,
        autotune_every=TUNE["every"], record_chain=False, engine="pallas",
        seed=0, device=dev)
    reset_launches(*wrappers)
    sim.generate_samples(verbose=False)
    seen = read_launches(*wrappers, by_kind=True)
    lad = sim.tuned_ladder
    if (dict(seen) != {_build.launch_key(_build.route(_build.library(
            "fused_pt", "Normal", rule["pt"]), thread_tg)[0]): 1}
            or sim.engine_used != "pallas"
            or not (lad[0] == 1.0 and all(b < a for a, b in
                                          zip(lad, lad[1:])))):
        fail(f"phase 17d: launches {dict(seen)}, ladder {lad}")
    ps = sim._phase_seconds
    say(f"phase 17d autotune_ladder PT SuperFunnel ({SF_TUNE['C']} x T={T}, "
        f"burn-in {SF_TUNE['burn_in']}): ladder "
        f"{[round(float(b), 5) for b in lad]}; swap acc "
        f"{sim.acceptance_rate():.4f}; tune {ps['tune']:.3f} s, measure "
        f"{ps['measure']:.3f} s; launches {dict(seen)}")
    del sim
    say(f"phase 17 {time.time() - t_phase:.1f} s")
    return kernels


# ---------------------------------------------------------- the ladder kernel
# Work of a ladder build (csrc/ladder_build.cu), per probe: 2N samples (N at
# beta*, N at beta), each drawn from Philox blocks of 4 words and evaluated
# by the target's log-density (lp_flops), then the term min(1, exp((b -
# b*)(lp* - lp))) (2 subs, mul, min, exp, the double add: 6 per sample).
# A side's draw, in this convention: a lax_erfinv normal 30 (NORMAL_FLOPS)
# a coordinate (NealFunnel, the MVNs, the mixtures, the Rosenbrocks) and
# the sampler's own arithmetic a coordinate: 2 (iso MVN: product, add;
# Hypercube: product, add), 3 (scaled MVN, the mixtures, the Rosenbrocks,
# NealFunnel's z: quotient or product, add, quotient), the full MVN's
# quotient and FMA a pair (3 d^2) and its add (d), the mixtures' compares
# (2 a categorical draw, 1 word); a gamma variate's accepted attempt
# (Marsaglia-Tsang: the bit-exact normal 57, fast_log twice 56, 10 more
# products and sums, 125; the boost below shape 1, where beta* < 1/shape,
# left out, and rejections, 2-5 % of attempts, not counted) and its
# scale (IIDGamma 1; IIDBeta two gammas, then an add and a quotient).
# Philox: ceil(words / 4) blocks a side (a gamma variate: one block an
# attempt), PHILOX_BLOCK_OPS int32 operations each.  Bytes: the tile sums
# (8 B a 256 samples, written and read) and the parameters, negligible.
def ladder_side(kind, d):
    """(float operations, Philox blocks) of one sample on one side."""
    if kind in ("iid_gamma", "iid_beta"):
        g = 2 if kind == "iid_beta" else 1
        return d * (125 * g + (2 if g == 2 else 1)), d * g
    words = d + {"three_mixture": 1, "rough_carpet": d}.get(kind, 0)
    per = {"mvn_iso": 32, "hypercube": 2}.get(kind, 33)
    flops = d * (per if kind != "hypercube" else 2)
    if kind == "mvn_full":
        flops = 30 * d + 3 * d * d + d
    if kind in ("three_mixture", "rough_carpet"):
        flops += 2 * (words - d)
    return flops + lp_flops(kind, d), -(-words // 4)


def ladder_work(kind, d, n, probes):
    """``(flops, Philox int32 ops, bytes)`` of a build of ``probes``
    probes of ``n`` samples a side."""
    f, blocks = ladder_side(kind, d)
    samples = probes * n
    return (samples * (2 * f + 6), samples * 2 * blocks * PHILOX_BLOCK_OPS,
            probes * 16 * -(-n // 256))


def ladder_target(get_target_distribution, kind, d, dev, kw=None):
    """Phase 18's target of ``kind`` at ``d`` coordinates (``kw``: other
    arguments than :data:`LADDER_KINDS`')."""
    import numpy as np
    name, kw = LADDER_KINDS[kind][0], kw or LADDER_KINDS[kind][1]
    if kw == "cov":
        a = np.random.default_rng(3).normal(size=(d, d))
        kw = {"cov": a @ a.T / d + np.eye(d)}
    if kind == "hybrid_rosenbrock":
        d = 0    # the registry's d comes from n1, n2
    return get_target_distribution(name, d, device=dev, **kw)


def first_difference(a, b, rtol=1e-5):
    """Index of the first pair of swap estimates that differ beyond
    ``rtol``, or None."""
    return next((i for i, (x, y) in enumerate(zip(a, b))
                 if abs(x - y) > rtol * abs(y)), None)


def ladder_hold(torch, phase, tg, kind, label, kw, reps=3):
    """The ladder kernel (best of ``reps``) against its plain version
    (once) with the builder's options ``kw``: the same T and probes, the
    betas to rtol 1e-5, the swap estimates non-finite at the same probes
    and some of them finite; else the smoke fails.  (A NaN estimate, as
    the tempered funnel's float32 overflow gives on both sides alike,
    runs a rung's search to its cap and ends the ladder at beta_min: a
    build of NaN estimates alone would agree with any kernel.)  Returns
    the kernels line's numbers of the build."""
    from rwm_pt_tpu_torch.kernels import ladder_build
    from rwm_pt_tpu_torch.ladders import ladders as L
    launch = ladder_build.launch_ladder_kernel
    ms, k = cuda_ms(torch, lambda: launch(tg, **kw), reps=reps)
    plain_ms, p = cuda_ms(
        torch, lambda: L._construct_iterative_ladder_device_plain(tg, **kw))
    first = first_difference(k.a_hats, p.a_hats)
    fin_k = [math.isfinite(a) for a in k.a_hats]
    finite = sum(fin_k)
    ok_finite = finite > 0 and fin_k == [math.isfinite(a) for a in p.a_hats]
    err = max([abs(a - b) for a, b in zip(k.a_hats, p.a_hats)
               if math.isfinite(a) and math.isfinite(b)] or [0])
    same = (len(k.betas) == len(p.betas) and k.probes == p.probes
            and all(abs(a - b) <= 1e-5 * abs(b)
                    for a, b in zip(k.betas, p.betas)))
    n = kw["N_samples_swap_est"]
    flops, ints, nbytes = ladder_work(kind, tg.dim, n, k.probes)
    b_ms, b_by, b_limit = bound(flops, ints, nbytes)
    us = 1e3 * ms / max(k.probes, 1)
    say(f"phase {phase} {label} N={n}, beta_min {kw.get('beta_min', 0.01)},"
        f" tolerance {kw['tolerance']}: T {len(k.betas)} / {len(p.betas)}, "
        f"probes {k.probes} / {p.probes}, betas equal to 1e-5: {same}; swap "
        f"estimates finite {finite} of {k.probes} (at the same probes: "
        f"{ok_finite}), max |diff| over them {err:.3g}, first beyond rtol "
        f"1e-5 at probe {first}; kernel {ms:.3f} ms ({us:.1f} us a "
        f"probe), plain {plain_ms:.1f} ms, bound {b_ms:.4f} ms by {b_limit} "
        f"({100 * b_ms / ms:.1f} %); {[round(b, 5) for b in k.betas]}")
    if not same or not ok_finite:
        fail(f"phase {phase} {label}: the ladder kernel disagrees with its "
             f"plain version: {k.betas} ({k.probes}) vs {p.betas} "
             f"({p.probes}), {finite} finite swap estimates")
    return dict(ms=ms, plain_ms=plain_ms, bound_ms=b_ms, bound_by=b_by,
                bound_limit=b_limit, max_abs_err=err, probes=k.probes,
                finite_estimates=finite,
                T=len(k.betas), first_difference=first, flops=flops,
                philox_int_ops=ints, bytes=nbytes, us_a_probe=us)


def ladder_record(name, launches, tg, kind, held):
    """A ladder library's record in the kernels line: ``launches`` on its
    main path, the numbers of :func:`ladder_hold` (``held``) and the
    kernel's registers, local memory and residency at ``tg``'s d."""
    from rwm_pt_tpu_torch.kernels import _build, ladder_build
    info = ladder_build.info(kind, tg.dim,
                             _build.kernel_target(tg)[1].numel())
    return dict(name=name, route="cuda",
                source="rwm_pt_tpu_torch/kernels/csrc/ladder_build.cu",
                replaces="rwm_pt_tpu/ladders/ladders.py:148",
                launches=launches, library_ms=None, dim=tg.dim, **held,
                registers=info["registers"], local_bytes=info["local_bytes"],
                blocks_per_sm=info["blocks_per_sm"],
                warps_per_sm=info["blocks_per_sm"] * info["max_threads"]
                // 32)


def phase_18(torch, gen):
    """Phase 18, the one-launch ladder builder (A10; module docstring).
    Returns the kernels' JSON records, one a kind."""
    import contextlib
    import io

    from rwm_pt_tpu_torch.api import MCMCSimulation
    from rwm_pt_tpu_torch.cli import demo
    from rwm_pt_tpu_torch.kernels import (_build, fused_pt, fused_rwm,
                                          ladder_build, run_pt, run_pt_fused,
                                          run_rwm)
    from rwm_pt_tpu_torch.ladders import ladders as L
    from rwm_pt_tpu_torch.proposals import NormalProposal
    from rwm_pt_tpu_torch.targets import get_target_distribution
    from rwm_pt_tpu_torch.utils import profiling, set_x64

    t_phase = time.time()
    dev = torch.device("cuda")
    launch = ladder_build.launch_ladder_kernel
    wrappers = (fused_pt.launch_pt_kernel, fused_rwm.launch_rwm_kernel)
    kernels = []

    # the room MCMCSimulation's default engine gives the ladder (its main
    # path below), so the hold is at the shape the main path launches
    held = dict(LADDER_HOLD, max_T=L.EAGER_MAX_RUNGS + 1)

    def hold(tg, kind, label, n=LADDER_HOLD["N_samples_swap_est"]):
        """:func:`ladder_hold` at LADDER_HOLD, ``n`` samples a side."""
        return ladder_hold(torch, "18a", tg, kind, label,
                           dict(held, N_samples_swap_est=n))

    # ---- (a) every kind: its main path, then the kernel against plain
    for kind in LADDER_KINDS:
        tg = ladder_target(get_target_distribution, kind, LADDER_D, dev)
        name = f"{_build.LADDER}.{kind}"
        reset_launches(launch, *wrappers)
        sim = MCMCSimulation(
            dim=tg.dim, sigma=2.38 ** 2 / tg.dim, num_iterations=200,
            algorithm="PT", target_dist=tg, num_chains=1024, seed=1,
            iterative_temp_spacing=True, record_chain=False,
            N_samples_swap_est=LADDER_HOLD["N_samples_swap_est"],
            iterative_tolerance=LADDER_HOLD["tolerance"], device=dev)
        sim.generate_samples(verbose=False)
        torch.cuda.synchronize()
        seen = dict(launch.launches)
        if seen != {name: 1} or sim.engine_used != "pallas":
            fail(f"phase 18a {kind}: ladder launches {seen}, engine "
                 f"{sim.engine_used}")
        launches = seen[name]     # this main path's run alone
        say(f"phase 18a {kind} main path: MCMCSimulation(iterative_temp_"
            f"spacing=True) d={tg.dim}, ladder "
            f"{[round(b, 5) for b in sim.beta_ladder]}, swap acc "
            f"{sim.acceptance_rate():.4f}; launches {seen}, fused "
            f"{dict(read_launches(*wrappers))}")
        del sim
        rec = ladder_record(name, launches, tg, kind,
                            hold(tg, kind, f"{kind} d={tg.dim}"))
        if kind == "three_mixture":
            # the harness's N (MCMCSimulation's default), a few tiles a probe
            rec["harness"] = hold(tg, kind, f"{kind} d={tg.dim}",
                                  n=LADDER_HARNESS_N)
        if kind == "mvn_iso":
            wide = ladder_target(get_target_distribution, kind,
                                 LADDER_WIDE_D, dev)
            rec["wide"] = hold(wide, kind, f"{kind} d={LADDER_WIDE_D}")
            rec["wide"].update(ladder_build.info(kind, LADDER_WIDE_D))
        kernels.append(rec)
    say(f"phase 18a {time.time() - t_phase:.1f} s")

    # ---- (b) the PT study's ladders (PT_STUDY's configs), host loop
    # against the kernel, in
    # the room experiment_pt gives them (the fused kernel's rungs)
    room = _build.max_rungs(PT_STUDY["dim"]) + 1
    tm = get_target_distribution(PT_STUDY["target"], PT_STUDY["dim"],
                                 device=dev, variant="pt_gpu")
    rates = [0.01 + (PT_STUDY["swap_accept_max"] - 0.01) * i
             / (PT_STUDY["configs"] - 1) for i in range(PT_STUDY["configs"])]
    host_s, dev_s, unequal = [], [], []
    for i, rate in enumerate(rates):
        kw = dict(LADDER_STUDY, target_swap_acceptance_rate=rate,
                  seed=PT_STUDY["seed"] + i)
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        host = L.construct_iterative_ladder(tm, **kw)
        host_s.append(time.perf_counter() - t0)
        t0 = time.perf_counter()
        devl = L.construct_iterative_ladder_device(tm, max_T=room, **kw)
        torch.cuda.synchronize()
        dev_s.append(time.perf_counter() - t0)
        if len(host) != len(devl) or any(
                abs(a - b) > 1e-5 * abs(b) for a, b in zip(devl, host)):
            unequal.append((i, host, devl))
        say(f"phase 18b config {i} (rate {rate:.4f}): host {host_s[-1]:.3f} "
            f"s, device {dev_s[-1]:.4f} s, T={len(devl)} "
            f"{[round(b, 5) for b in devl]}")
    say(f"phase 18b PT study ladders ({PT_STUDY['target']} d="
        f"{PT_STUDY['dim']}, N={LADDER_STUDY['N_samples_swap_est']}, tol "
        f"{LADDER_STUDY['tolerance']}, {PT_STUDY['configs']} configs): host "
        f"{sum(host_s):.2f} s, device {sum(dev_s):.3f} s "
        f"({sum(host_s) / sum(dev_s):.1f}x); ladders equal: {not unequal}")
    if unequal:
        fail(f"phase 18b: host and device ladders differ: {unequal}")
    tm_rec = next(r for r in kernels if r["name"].endswith("three_mixture"))
    tm_rec.update(study_host_s=host_s, study_device_s=dev_s)

    # ---- (c) one production build, held against its plain version (the
    # host loop's search under the same cap), each of whose probes is timed
    kw = dict(LADDER_PROD, target_swap_acceptance_rate=0.234, max_T=room)
    best, prod = math.inf, None
    for _ in range(2):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        prod = launch(tm, **kw)
        torch.cuda.synchronize()
        best = min(best, time.perf_counter() - t0)
    flops, ints, nbytes = ladder_work("three_mixture", tm.dim,
                                      kw["N_samples_swap_est"], prod.probes)
    b_ms, _, b_limit = bound(flops, ints, nbytes)
    timed, real = [], L._estimate_swap_prob

    def timed_probe(*a, **k):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        out = real(*a, **k)
        timed.append(time.perf_counter() - t0)
        return out

    L._estimate_swap_prob = timed_probe
    try:
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        plain = L._construct_iterative_ladder_device_plain(tm, **kw)
        plain_s = time.perf_counter() - t0
    finally:
        L._estimate_swap_prob = real
    first = first_difference(prod.a_hats, plain.a_hats)
    same = (len(prod.betas) == len(plain.betas)
            and prod.probes == plain.probes == len(timed)
            and all(abs(a - b) <= 1e-5 * abs(b)
                    for a, b in zip(prod.betas, plain.betas)))
    host_us = 1e6 * sum(timed[:LADDER_HOST_PROBES]) / min(
        len(timed), LADDER_HOST_PROBES)
    plain_us = 1e6 * plain_s / plain.probes
    us = 1e6 * best / prod.probes
    say(f"phase 18c production build ({PT_STUDY['target']} d={tm.dim}, "
        f"N={kw['N_samples_swap_est']}, tol {kw['tolerance']}, "
        f"{kw['max_pn_adjustment_steps']} pn steps, fail "
        f"{kw['convergence_failure_tolerance_factor']}): {best:.4f} s, "
        f"{prod.probes} probes, {us:.1f} us a probe against a bound of "
        f"{1e3 * b_ms / prod.probes:.2f} us by {b_limit} ("
        f"{100 * b_ms / (1e3 * best):.1f} %); T={len(prod.betas)} "
        f"{[round(b, 5) for b in prod.betas]}; its plain version (the host "
        f"loop's search) {plain_s:.3f} s, T={len(plain.betas)}, "
        f"{plain.probes} probes, betas equal to 1e-5: {same}, swap "
        f"estimates first beyond rtol 1e-5 at probe {first}; "
        f"{plain_us:.1f} us a probe ({plain_us / us:.1f}x), "
        f"{host_us:.1f} us over its first "
        f"{min(len(timed), LADDER_HOST_PROBES)}")
    if not same:
        fail(f"phase 18c: the production build disagrees with its plain "
             f"version: {prod.betas} ({prod.probes}) vs {plain.betas} "
             f"({plain.probes})")
    tm_rec.update(production_s=best, production_probes=prod.probes,
                  production_us_a_probe=us,
                  production_bound_us_a_probe=1e3 * b_ms / prod.probes,
                  production_plain_s=plain_s,
                  production_plain_us_a_probe=plain_us,
                  production_host_us_a_probe=host_us,
                  production_first_difference=first)

    # the per-probe split of the harness's build and the production build
    # (the measuring build's stamps, phase 2 built it; µs a probe)
    split = {f"N={c['N_samples_swap_est']}": ladder_build.probe_split(tm, **c)
             for c in (dict(held, N_samples_swap_est=LADDER_HARNESS_N), kw)}
    say("phase 18c per-probe split (ThreeMixture d=10, us a probe, the "
        "parts in their order): " + "; ".join(
            f"{n}: " + ", ".join(f"{k} {v:.2f}" for k, v in parts.items())
            for n, parts in split.items()))
    tm_rec.update(split_us_a_probe=split)

    # ---- (d) the demo, the profiling helpers, the eager engines' options
    reset_launches(launch, *wrappers)
    buf = io.StringIO()
    t0 = time.perf_counter()
    with contextlib.redirect_stdout(buf):
        demo.main(["--num_iters", "2000", "--no_plots"])
    seen = dict(read_launches(*wrappers))
    seen.update(launch.launches)
    if (launch.launches.get(f"{_build.LADDER}.mvn_iso") != 1
            or "swap acceptance" not in buf.getvalue()):
        fail(f"phase 18d demo: launches {seen}")
    say(f"phase 18d demo --num_iters 2000 --no_plots: "
        f"{time.perf_counter() - t0:.2f} s, launches {seen}; "
        + "; ".join(ln.strip() for ln in buf.getvalue().splitlines()
                    if "acceptance" in ln))

    rb = get_target_distribution("FullRosenbrock", FLAG["dim"], device=dev)
    betas = torch.logspace(0, -2, FLAG["T"], device=dev)

    def fused(seed):
        return run_pt_fused(rb, seed, betas,
                            base_variance=FLAG["base_variance"],
                            num_chains=FLAG["C"], num_iterations=200,
                            swap_every=FLAG["swap_every"], device=dev)

    timer = profiling.DeviceTimer()
    timer.run(fused, 1)
    mem = profiling.memory_stats()
    prof_dir = os.path.join(HERE, "smoke_out", "profile")
    with profiling.profile_trace(prof_dir) as prof:
        fused(2)
        torch.cuda.synchronize()
    dev_us = sum(getattr(e, "self_device_time_total",
                         getattr(e, "self_cuda_time_total", 0))
                 for e in prof.key_averages())
    report = profiling.throughput_forensics(fused, 3, num_chunks=3,
                                            verbose=False)
    keys = set(next(iter(mem.values()))) if mem else set()
    if (keys != {"bytes_in_use", "peak_bytes_in_use", "bytes_limit"}
            or not timer.elapsed > 0
            or not os.path.exists(os.path.join(prof_dir, "trace.json"))):
        fail(f"phase 18d profiling: memory {mem}, timer {timer.elapsed}")
    say(f"phase 18d profiling (flagship shape, 200 steps): DeviceTimer "
        f"{1e3 * timer.elapsed:.3f} ms on the card, {1e3 * timer.wall:.3f}"
        f" ms wall; memory_stats {mem}; profile_trace device time "
        f"{dev_us / 1e3:.3f} ms in {len(prof.key_averages())} ops "
        f"(smoke_out/profile/trace.json); throughput_forensics chunks "
        f"{[round(t * 1e3, 3) for t in report['chunk_times']]} ms, "
        f"degradation {report['rate_degradation']:.3f}")

    mvn = get_target_distribution("MultivariateNormal", 5, device=dev)
    prop = NormalProposal.create(5, 2.38 ** 2 / 5, device=dev)
    kw = dict(num_chains=1024, num_iterations=400, burn_in=100, device=dev)
    cpu_sem = run_pt(mvn, prop, 5, [1.0, 0.5, 0.25, 0.1], swap_every=10,
                     cpu_semantics=True, **kw)
    a = run_rwm(mvn, prop, 6, symmetric=False, **kw)
    b = run_rwm(mvn, prop, 6, **kw)
    out = io.StringIO()
    with contextlib.redirect_stdout(out):
        c = run_rwm(mvn, prop, 6, progress_every=250, unroll=8, **kw)
    set_x64(True)
    try:
        mvn64 = get_target_distribution("MultivariateNormal", 5, device=dev)
        r64 = run_rwm(mvn64, NormalProposal.create(5, 2.38 ** 2 / 5,
                                                   device=dev), 7, **kw)
    finally:
        set_x64(False)
    lines = out.getvalue().count("progress: step")
    if (not torch.equal(a.state.x, b.state.x)
            or not torch.equal(b.state.x, c.state.x) or lines != 2
            or r64.state.x.dtype != torch.float64
            or cpu_sem.state.swap_attempt_count != 50 * 3
            or float(cpu_sem.acceptance_rate.max()) > 1.0):
        fail("phase 18d: an eager engine option misbehaves on the card")
    say(f"phase 18d eager options on the card (MVN d=5, 1024 chains): "
        f"cpu_semantics per-rung acc "
        f"{[round(x, 4) for x in cpu_sem.acceptance_rate.mean(1).tolist()]}"
        f", swap acc {cpu_sem.swap_acceptance_rate.mean().item():.4f}; "
        f"symmetric=False equal to True: True; progress_every 250: {lines} "
        f"lines, run unchanged; float64 RWM acc "
        f"{r64.acceptance_rate.mean().item():.4f} ({r64.state.x.dtype})")
    say(f"phase 18 {time.time() - t_phase:.1f} s")
    return kernels


# ------------------------------------------------------- the sharded runs
def same(torch, a, b):
    """Whether two tensors are equal bit for bit (NaN where both are)."""
    if a.shape != b.shape or a.dtype != b.dtype:
        return False
    if a.dtype.is_floating_point:
        return bool(((a == b) | (a.isnan() & b.isnan())).all())
    return torch.equal(a, b)


PT_STATE = ("x", "logp", "accept_count", "swap_accept_count",
            "sum_beta_sq_jump", "sum_sq_jump_cold")
RWM_STATE = ("x", "logp", "accept_count", "sum_sq_jump")


def differ(torch, a, b, fields):
    """The state fields in which results ``a`` and ``b`` differ."""
    return [f for f in fields
            if not same(torch, getattr(a.state, f), getattr(b.state, f))]


def event_bytes(d, T, C, n_events, n_t):
    """Bytes the hybrid's swap events must move: each event reads and
    writes every rung's x and lp, and each half-sweep passes each of the
    n_t - 1 shard edges two boundary rows (x, lp, beta) each way."""
    return n_events * 4 * C * (2 * (d + 1) * T + 2 * 2 * (n_t - 1) * (d + 2))


def phase_19(torch, card, dev=None):
    """Phase 19, the sharded fused runs (B9) over meshes of virtual shards
    of ``cuda:0`` (A13; module docstring; ``dev``: the card, or the CPU
    for a dry run of the phase's code at small sizes).  Returns the kernels
    line's records of the three sharded entry points; each record's
    launches are those of its one main path (the flagship PT and the RWM
    headline on the largest chains mesh, the hybrid on SHARD_HOLD's temps
    mesh), counted from 0 just before that run.  The earlier records keep
    their own main paths' launches: the launches of all of this phase's
    runs are printed on a line of their own."""
    import contextlib
    from rwm_pt_tpu_torch.api import MCMCSimulation
    from rwm_pt_tpu_torch.cli import experiment_rwm
    from rwm_pt_tpu_torch.kernels import (_build, agreement, fused_pt,
                                          fused_rwm, fused_sharded,
                                          run_pt_fused, run_pt_fused_sharded,
                                          run_pt_fused_tempsharded,
                                          run_rwm_fused,
                                          run_rwm_fused_sharded)
    from rwm_pt_tpu_torch.ladders import construct_geometric_ladder
    from rwm_pt_tpu_torch.parallel import make_mesh
    from rwm_pt_tpu_torch.targets import (FullRosenbrock,
                                          get_target_distribution)
    t_phase = time.time()
    dev = dev or torch.device("cuda", 0)
    wrappers = (fused_pt.launch_pt_kernel, fused_rwm.launch_rwm_kernel)
    path = Counter()        # every counted run's launches, by library
    main_launches = {}      # each sharded entry point's main-path launches

    def mesh(sizes, names=("chains",)):
        return make_mesh(sizes, names, devices=[dev] * math.prod(sizes))

    def counted(fn, main=None):
        """``fn()`` timed once with its launches counted from 0: (ms,
        result, launches by library); ``main`` names the sharded entry
        point whose main path this run is."""
        reset_launches(*wrappers)
        ms, out = cuda_ms(torch, fn)
        seen = read_launches(*wrappers, by_kind=True)
        path.update(seen)
        if main:
            main_launches[main] = sum(seen.values())
        return ms, out, seen

    def rate(steps, ms):
        return f"{steps / ms * 1e3:.6g}"

    # ---- 19a chains-sharded, bit for bit against the unsharded runs
    def chains_case(label, fields, steps, unsharded, sharded, best_of=1,
                    main=False, suffix=""):
        """``main``: the run on the largest mesh is its entry point's main
        path; ``suffix``: that of the libraries every launch must be of."""
        who = ("run_pt_fused_sharded" if fields == PT_STATE
               else "run_rwm_fused_sharded")
        ref = unsharded()           # the reference, and a warm-up
        ms0 = cuda_ms(torch, unsharded, best_of)[0]
        line = [f"unsharded {ms0:.3f} ms ({rate(steps, ms0)} MH steps/s)"]
        times = {}
        for k in SHARD_COUNTS:
            m = mesh((k,))
            _, res, seen = counted(lambda: sharded(m), who if main and k ==
                                   max(SHARD_COUNTS) else None)
            ms = cuda_ms(torch, lambda: sharded(m), best_of)[0]
            bad = differ(torch, res, ref, fields)
            if bad or sum(seen.values()) != k or not all(
                    key.endswith(suffix) for key in seen):
                fail(f"phase 19a {label} on {k} shards: differs from the "
                     f"unsharded run in {bad}; launches {dict(seen)}")
            times[k] = ms
            line.append(f"{k} shards {ms:.3f} ms ({rate(steps, ms)} MH "
                        f"steps/s, {sum(seen.values())} launches)")
            del res
        say(f"phase 19a {label}: equal bit for bit ({', '.join(fields)}) to "
            f"the unsharded run on {SHARD_COUNTS} shards; " + "; ".join(line))
        return times

    d, T, C = FLAG["dim"], FLAG["T"], FLAG["C"]
    rb = FullRosenbrock.create(d, device=dev)
    betas = torch.logspace(0, -2, T, device=dev)
    pt_kw = dict(base_variance=FLAG["base_variance"], num_chains=C,
                 num_iterations=FLAG["iters"], swap_every=FLAG["swap_every"])
    pt_steps = FLAG["iters"] * T * C
    flag_times = chains_case(
        f"flagship PT (d={d}, T={T}, {C} replicas, {FLAG['iters']} steps)",
        PT_STATE, pt_steps,
        lambda: run_pt_fused(rb, 0, betas, device=dev, **pt_kw),
        lambda m: run_pt_fused_sharded(rb, 0, betas, m, **pt_kw), 3, True)
    rwm_kw = dict(base_variance=RWM_MAIN["base_variance"],
                  num_chains=RWM_MAIN["C"], num_iterations=RWM_MAIN["iters"])
    rwm_steps = RWM_MAIN["iters"] * RWM_MAIN["C"]
    rwm_times = chains_case(
        f"RWM headline ({RWM_MAIN['C']} chains)", RWM_STATE, rwm_steps,
        lambda: run_rwm_fused(rb, 0, device=dev, **rwm_kw),
        lambda m: run_rwm_fused_sharded(rb, 0, m, **rwm_kw), 3, True)
    wide = FullRosenbrock.create(WARP_D, device=dev)
    wide_var = 0.5 ** 2 / WARP_D
    team = fused_sharded._layout("fused_pt", wide, None, C, T, dev)[1]
    chains_case(
        f"d={WARP_D} PT (the team kernels, G={team}; T={T}, {C} replicas, "
        f"{FLAG['iters']} steps)", PT_STATE, pt_steps,
        lambda: run_pt_fused(wide, 0, betas, base_variance=wide_var,
                             num_chains=C, num_iterations=FLAG["iters"],
                             swap_every=FLAG["swap_every"], device=dev),
        lambda m: run_pt_fused_sharded(
            wide, 0, betas, m, base_variance=wide_var, num_chains=C,
            num_iterations=FLAG["iters"], swap_every=FLAG["swap_every"]))
    team = fused_sharded._layout("fused_rwm", wide, None, C, 0, dev)[1]
    chains_case(
        f"d={WARP_D} RWM (G={team}; {C} chains)", RWM_STATE, rwm_steps,
        lambda: run_rwm_fused(wide, 0, base_variance=wide_var, num_chains=C,
                              num_iterations=RWM_MAIN["iters"], device=dev),
        lambda m: run_rwm_fused_sharded(
            wide, 0, m, base_variance=wide_var, num_chains=C,
            num_iterations=RWM_MAIN["iters"]))
    # the 512 bucket's team kernels (d = 500)
    d5 = WIDE_D[0]
    mvn5 = get_target_distribution("MultivariateNormal", d5, device=dev)
    w_kw = dict(base_variance=2.38 ** 2 / d5, num_chains=WIDE_SHARD["C"],
                num_iterations=WIDE_SHARD["iters"])
    chains_case(
        f"d={d5} PT (the 512 bucket; T={T}, {WIDE_SHARD['C']} replicas, "
        f"{WIDE_SHARD['iters']} steps)", PT_STATE,
        WIDE_SHARD["iters"] * T * WIDE_SHARD["C"],
        lambda: run_pt_fused(mvn5, 3, betas, swap_every=10, device=dev,
                             **w_kw),
        lambda m: run_pt_fused_sharded(mvn5, 3, betas, m, swap_every=10,
                                       **w_kw), suffix=".w512")
    chains_case(
        f"d={d5} RWM (the 512 bucket; {WIDE_SHARD['C']} chains, "
        f"{WIDE_SHARD['iters']} steps)", RWM_STATE,
        WIDE_SHARD["iters"] * WIDE_SHARD["C"],
        lambda: run_rwm_fused(mvn5, 3, device=dev, **w_kw),
        lambda m: run_rwm_fused_sharded(mvn5, 3, m, **w_kw), suffix=".w512")
    del mvn5
    sf = sf_target(get_target_distribution, SF["J"], SF["K"], dev)
    ladder = torch.tensor(construct_geometric_ladder(), dtype=torch.float32,
                          device=dev)
    sf_kw = dict(base_variance=SF_VAR, num_chains=SF_MAIN["C"],
                 num_iterations=SHARD_SF_STEPS)
    lib = _build.route(_build.library("fused_pt", "Normal",
                                      fused_sharded._layout(
                                          "fused_pt", sf, None, SF_MAIN["C"],
                                          len(ladder), dev)[0]),
                       sf)[0]
    chains_case(
        f"SuperFunnel PT ({lib}, T={len(ladder)}, {SF_MAIN['C']} replicas, "
        f"{SHARD_SF_STEPS} steps)", PT_STATE,
        SHARD_SF_STEPS * len(ladder) * SF_MAIN["C"],
        lambda: run_pt_fused(sf, 0, ladder, swap_every=SF_MAIN["swap_every"],
                             device=dev, **sf_kw),
        lambda m: run_pt_fused_sharded(sf, 0, ladder, m,
                                       swap_every=SF_MAIN["swap_every"],
                                       **sf_kw))
    chains_case(
        f"SuperFunnel RWM ({SF_MAIN['C']} chains, {SHARD_SF_STEPS} steps)",
        RWM_STATE, SHARD_SF_STEPS * SF_MAIN["C"],
        lambda: run_rwm_fused(sf, 0, device=dev, **sf_kw),
        lambda m: run_rwm_fused_sharded(sf, 0, m, **sf_kw))
    torch.cuda.empty_cache()

    # ---- 19b the temps-sharded hybrid across partitions
    def hybrid_case(label, tg, kw, meshes, steps):
        """The hybrid of ``tg`` with ``kw`` on each of ``meshes``: x, lp, MH
        and swap counts equal bit for bit across them, and held by the
        agreement gate and the swap-acceptance gate against the unsharded
        even/odd run.  The run on SHARD_HOLD's temps mesh is the main path
        of ``run_pt_fused_tempsharded``.  Returns the ms by mesh label."""
        ms_eo, eo = cuda_ms(torch, lambda: run_pt_fused(
            tg, 0, betas, swap_sweep="even_odd", device=dev, **kw), 2)
        n_events = kw["num_iterations"] // kw["swap_every"]
        line = [f"run_pt_fused(even_odd) {ms_eo:.3f} ms "
                f"({rate(steps, ms_eo)} MH steps/s)"]
        first, times = None, {}
        for sizes, names in meshes:
            m = mesh(sizes, names)
            main = ("run_pt_fused_tempsharded" if tg is rb and (sizes, names)
                    == ((SHARD_HOLD["temps"],), ("temps",)) else None)
            ms, res, seen = counted(lambda: run_pt_fused_tempsharded(
                tg, 0, betas, m, **kw), main)
            ms = min(ms, cuda_ms(torch, lambda: run_pt_fused_tempsharded(
                tg, 0, betas, m, **kw))[0])
            shards = math.prod(sizes)
            if sum(seen.values()) != shards * n_events:
                fail(f"phase 19b {label} on {m}: launches {dict(seen)}, want "
                     f"{shards * n_events}")
            if first is None:
                first = res
            else:
                bad = differ(torch, res, first, PT_STATE[:4])
                if bad:
                    fail(f"phase 19b {label} on {m} differs from the "
                         f"{meshes[0]} partition in {bad}")
            mlabel = " x ".join(f"{n} {a}" for a, n in zip(names, sizes))
            times[mlabel] = ms
            line.append(f"{mlabel}: {ms:.3f} ms ({rate(steps, ms)} MH "
                        f"steps/s, {sum(seen.values())} launches, {n_events} "
                        f"swap events of {shards} shards)")
        ag = agreement.hold(
            tuple(getattr(first.state, f) for f in PT_STATE[:5]),
            tuple(getattr(eo.state, f) for f in PT_STATE[:5]),
            ("x", "lp", "acc", "swapacc", "betajump"))
        sw_h = first.swap_acceptance_rate.mean().item()
        sw_e = eo.swap_acceptance_rate.mean().item()
        cj_h, cj_e = first.state.sum_sq_jump_cold, eo.state.sum_sq_jump_cold
        cold_rel = ((cj_h - cj_e).abs()
                    / cj_e.abs().clamp_min(1e-6)).max().item()
        say(f"phase 19b {label}: x, lp, MH and swap counts equal bit for bit "
            f"across {[s for s, _ in meshes]}; against run_pt_fused("
            f"even_odd): {agreement.describe(ag)}; swap acc {sw_h:.5f} vs "
            f"{sw_e:.5f} (|d| {abs(sw_h - sw_e):.5f} < 0.05); cold-jump sum "
            f"(MH and swap moves summed apart) max rel diff {cold_rel:.4g}, "
            f"cold ESJD {first.cold_esjd.mean().item():.6g} vs "
            f"{eo.cold_esjd.mean().item():.6g}; " + "; ".join(line))
        if ag.frac < AGREE_MIN or ag.mismatched or abs(sw_h - sw_e) >= 0.05:
            fail(f"the temps-sharded {label} disagrees with "
                 f"run_pt_fused(even_odd)")
        del first, eo, res
        torch.cuda.empty_cache()
        return times

    n_events = FLAG["iters"] // FLAG["swap_every"]
    hyb_times = hybrid_case(
        f"hybrid (flagship shape, swap every {FLAG['swap_every']})", rb,
        pt_kw, TEMP_MESHES, pt_steps)
    team = fused_sharded._layout("fused_pt", wide, None, C, T, dev)[1]
    hybrid_case(
        f"hybrid d={WARP_D} (the team kernels, G={team} for every segment; "
        f"{SHARD_WIDE['steps']} steps, swap every {SHARD_WIDE['swap_every']})",
        wide, dict(base_variance=wide_var, num_chains=C,
                   num_iterations=SHARD_WIDE["steps"],
                   swap_every=SHARD_WIDE["swap_every"]),
        [((n,), ("temps",)) for n in SHARD_WIDE_TEMPS],
        SHARD_WIDE["steps"] * T * C)

    # ---- 19c the entry points on the card's mesh
    for algo, kw in (("PT", dict(beta_ladder=betas.tolist(),
                                 swap_every=FLAG["swap_every"],
                                 num_chains=C)),
                     ("RWM", dict(num_chains=RWM_MAIN["C"]))):
        sims = []
        for use_mesh in (False, True):
            sim = MCMCSimulation(
                dim=d, sigma=FLAG["base_variance"], algorithm=algo,
                target_dist="FullRosenbrock", num_iterations=FLAG["iters"],
                record_chain=False, seed=0, use_mesh=use_mesh,
                device=dev, **kw)
            run = lambda: sim.generate_samples(verbose=False)  # noqa
            if use_mesh:
                ms, _, seen = counted(run)
            else:
                ms, _ = cuda_ms(torch, run)
                seen = None
            sims.append((sim, ms, seen))
        (a, ms_a, _), (b, ms_b, seen) = sims
        bad = differ(torch, a._result, b._result,
                     PT_STATE if algo == "PT" else RWM_STATE)
        if bad or b.engine_used != "pallas" or not seen:
            fail(f"phase 19c MCMCSimulation {algo} with the mesh differs in "
                 f"{bad}; engine {b.engine_used}, launches {dict(seen)}")
        say(f"phase 19c MCMCSimulation {algo} use_mesh=True on {b.mesh}: "
            f"equal bit for bit to the run without; {ms_b:.3f} ms vs "
            f"{ms_a:.3f}; launches {dict(seen)}")
    out_dir = os.path.join(HERE, "smoke_out", "mesh")
    os.makedirs(out_dir, exist_ok=True)
    runs = {}
    for flag in ((), ("--use_mesh",)):
        argv = ["--dim", str(STUDY["dim"]), "--target", STUDY["target"],
                "--proposal", "UniformRadius", "--num_iters",
                str(STUDY["iters"]), "--burn_in", str(STUDY["burn_in"]),
                "--num_chains", str(STUDY["C"]), "--var_max",
                str(STUDY["var_max"]), "--seed", str(STUDY["seed"]),
                "--num_configs", str(SHARD_STUDY_CONFIGS), "--no_plots",
                "--output_dir", os.path.join(out_dir, "mesh" if flag
                                             else "plain")] + list(flag)
        if dev.type == "cpu":
            argv.append("--cpu")
        log = os.path.join(out_dir, ("mesh" if flag else "plain") + ".log")
        with open(log, "w") as f, contextlib.redirect_stdout(f):
            if flag:
                t0 = time.time()
                _, runs["mesh"], seen = counted(
                    lambda: experiment_rwm.main(argv))
                study_s = time.time() - t0
            else:
                runs["plain"] = experiment_rwm.main(argv)
    timing = ("total_time", "times", "mh_steps_per_sec")
    keep = [{k: v for k, v in r.items() if k not in timing}
            for r in (runs["plain"], runs["mesh"])]
    if keep[0] != keep[1] or sum(seen.values()) != SHARD_STUDY_CONFIGS:
        fail(f"phase 19c experiment_rwm --use_mesh differs from the run "
             f"without it (launches {dict(seen)})")
    say(f"phase 19c experiment_rwm --use_mesh ({STUDY['target']} d="
        f"{STUDY['dim']}, {STUDY['C']} chains, {STUDY['iters']} iterations, "
        f"{SHARD_STUDY_CONFIGS} configs): the JSON equals the run without "
        f"the mesh but for its times; {study_s:.2f} s, "
        f"{runs['mesh']['mh_steps_per_sec']:.6g} MH steps/s "
        f"(without: {runs['plain']['mh_steps_per_sec']:.6g}); launches "
        f"{dict(seen)}")

    # ---- 19d each sharded entry point against its plain version
    k, n_t, se = SHARD_HOLD["shards"], SHARD_HOLD["temps"], \
        SHARD_HOLD["swap_every"]
    hold_kw = dict(base_variance=FLAG["base_variance"], num_chains=C,
                   num_iterations=HOLD_STEPS, swap_every=se)
    pt_draw = fused_sharded._layout("fused_pt", rb, None, C, T, dev)[0]
    rwm_draw = fused_sharded._layout("fused_rwm", rb, None, C, 0, dev)[0]
    cases = (
        ("run_pt_fused_sharded", ":107", (k,), ("chains",),
         lambda m, plain: run_pt_fused_sharded(rb, 0, betas, m, _plain=plain,
                                               **hold_kw),
         agreement.PT_OUTPUTS, PT_STATE,
         pt_work("rosenbrock", d, T, C, HOLD_STEPS, 0, se, draw=pt_draw),
         0, pt_work("rosenbrock", d, T, C, FLAG["iters"], 0,
                    FLAG["swap_every"], draw=pt_draw), 0,
         flag_times[max(SHARD_COUNTS)]),
        ("run_rwm_fused_sharded", ":71", (k,), ("chains",),
         lambda m, plain: run_rwm_fused_sharded(
             rb, 0, m, base_variance=RWM_MAIN["base_variance"],
             num_chains=RWM_MAIN["C"], num_iterations=HOLD_STEPS,
             _plain=plain),
         agreement.RWM_OUTPUTS, RWM_STATE,
         rwm_work("rosenbrock", d, RWM_MAIN["C"], HOLD_STEPS, draw=rwm_draw),
         0, rwm_work("rosenbrock", d, RWM_MAIN["C"], RWM_MAIN["iters"],
                     draw=rwm_draw), 0, rwm_times[max(SHARD_COUNTS)]),
        ("run_pt_fused_tempsharded", ":226", (n_t,), ("temps",),
         lambda m, plain: run_pt_fused_tempsharded(rb, 0, betas, m,
                                                   _plain=plain, **hold_kw),
         agreement.PT_OUTPUTS, PT_STATE,
         pt_work("rosenbrock", d, T, C, HOLD_STEPS, 0, se, draw=pt_draw),
         event_bytes(d, T, C, HOLD_STEPS // se, n_t),
         pt_work("rosenbrock", d, T, C, FLAG["iters"], 0,
                 FLAG["swap_every"], draw=pt_draw),
         event_bytes(d, T, C, n_events, n_t), hyb_times[f"{n_t} temps"]))
    records = []
    for (name, line_no, sizes, names, run, outs, fields, work, ev, full_work,
         full_ev, main_ms) in cases:
        if main_launches.get(name, 0) < 1:
            fail(f"phase 19 {name}: its main path launched no kernel")
        m = mesh(sizes, names)
        ms, kern = cuda_ms(torch, lambda: run(m, False), 3)
        plain_ms, plain = cuda_ms(torch, lambda: run(m, True))
        ag = agreement.hold(tuple(getattr(kern.state, f) for f in fields),
                            tuple(getattr(plain.state, f) for f in fields),
                            outs, lp_of=rb.log_density_td)
        if ag.frac < AGREE_MIN or ag.mismatched:
            fail(f"phase 19d {name} disagrees with its plain version: "
                 f"{agreement.describe(ag)}")
        b_ms, b_by, b_limit = bound(*work)
        b_ms += ev / PEAK_HBM_BYTES * 1e3
        full_b = bound(*full_work)[0] + full_ev / PEAK_HBM_BYTES * 1e3
        say(f"phase 19d {name} on {m}: {HOLD_STEPS} steps at main-path "
            f"shapes: kernels {ms:.3f} ms, plain {plain_ms:.1f} ms, bound "
            f"{b_ms:.3f} ms (the kernel's by {b_limit}, plus "
            f"{ev:.4g} B of swap events); main path {main_ms:.3f} ms against "
            f"{full_b:.3f} ({100 * full_b / main_ms:.1f} %); "
            f"{agreement.describe(ag)}")
        records.append(dict(
            name=f"fused_sharded.{name}", route="cuda",
            source="rwm_pt_tpu_torch/kernels/fused_sharded.py",
            replaces=f"rwm_pt_tpu/kernels/pallas_sharded.py{line_no}",
            launches=main_launches[name], max_abs_err=ag.max_dx, ms=ms, plain_ms=plain_ms,
            bound_ms=b_ms, bound_by=b_by, library_ms=None, steps=HOLD_STEPS,
            agree_frac=ag.frac, max_rel_err=ag.max_rel,
            swap_event_bytes=ev, main_path_ms=main_ms,
            main_path_bound_ms=full_b, main_path_bound_share=full_b / main_ms))
        del kern, plain
        torch.cuda.empty_cache()
    say(f"phase 19 launches of all its counted runs, by library (not in the "
        f"kernels line, whose records count their own main paths): "
        f"{dict(path)}")
    say(f"phase 19 {time.time() - t_phase:.1f} s; card {card}")
    return records


def wide_target(get_target_distribution, kind, d, dev):
    """Phase 20's (and 22's) target of kernel kind ``kind`` at d
    coordinates and its Normal variance: phase 16's (:func:`warp_target`),
    with
    HybridRosenbrock's blocks for d (:data:`WIDE_HYBRID`)."""
    if kind == "hybrid_rosenbrock":
        return kind_target(get_target_distribution, kind, d, dev,
                           kw=WIDE_HYBRID[d])
    return warp_target(get_target_distribution, kind, d, dev)


def block_rungs(_build, d, n_params, kind="mvn_iso"):
    """The most rungs one block of a team library's team sizes holds at d
    coordinates (``_build.pt_warp_geometry``; more run over a cluster of
    blocks, phase 21): phase 20b's hold."""
    dmax = _build.warp_bucket(d)

    def fits(T):
        for g in _build.WARP_TEAMS[dmax]:
            try:
                _build.pt_warp_geometry(
                    0, _build.pt_team_threads(dmax, g), d, dmax, T, 1,
                    n_params=n_params, team=g, kind=kind)
                return True
            except ValueError:
                pass
        return False
    return max(T for T in range(1, 129) if fits(T))


def phase_20(torch, gen):
    """Phase 20, the wide warp buckets (252 < d <= 1020, A15's remainder;
    module docstring): (b) the holds, (c) Geweke at d = 500, (d) the main
    shapes at d = 500 and 1000, (e) the entry points and the ladder
    kernel, (f) the RWM rate at d = 1000 (phase 19 holds the
    chains-sharded runs at d = 500).  Returns
    the kernels' JSON records: PT and RWM of each new bucket, with the
    launches of their main paths in (d), and the ladder at d = 1000, with
    the launch of its main path in (e)."""
    from rwm_pt_tpu_torch.api import MCMCSimulation
    from rwm_pt_tpu_torch.kernels import (_build, agreement, draws, fused_pt,
                                          fused_rwm, ladder_build, run_pt,
                                          run_pt_fused, run_rwm,
                                          run_rwm_fused)
    from rwm_pt_tpu_torch.ladders import ladders as L
    from rwm_pt_tpu_torch.proposals import NormalProposal
    from rwm_pt_tpu_torch.targets import get_target_distribution

    t_phase = time.time()
    dev = torch.device("cuda")
    wrappers = (fused_pt.launch_pt_kernel, fused_rwm.launch_rwm_kernel)
    h = WIDE_HOLD
    rule = {a: draws.resolve_normal_impl(a, 65536) for a in ("pt", "rwm")}
    D5, D10 = WIDE_D

    def target(kind, d):
        return wide_target(get_target_distribution, kind, d, dev)

    def hold(label, algo, tg, var, C=None, **kw):
        """One 20b hold (:func:`warp_hold`)."""
        return warp_hold(torch, gen, "20b", label, algo, tg, var,
                         C or (h["C_pt"] if algo == "pt" else h["C_rwm"]),
                         h["steps"], **dict(dict(
                             T=h["T"], burn_in=h["burn_in"],
                             swap_every=h["swap_every"],
                             draw=rule[algo]), **kw))

    # ---- (b) holds: every kind at d = 500, three at d = 1000, the
    # proposals, draws and recording, each bucket's most rungs, the edges
    worst = 1.0
    for d in WIDE_D:
        kinds = ([k for k in _build.TARGET_KINDS if k != "super_funnel"]
                 if d == D5 else WIDE_KINDS_1000)
        for kind in kinds:
            tg, var = target(kind, d)
            for algo in ("rwm", "pt"):
                worst = min(worst, hold(f"{kind} d={tg.dim} "
                                        f"{algo.upper()}", algo, tg,
                                        var).frac)
        mvn, var = target("mvn_iso", d)
        full, var_f = target("mvn_full", d)
        for algo in ("rwm", "pt"):
            for prop in NEW_PROPOSALS:
                hold(f"{prop} MVN d={d} {algo.upper()}", algo, mvn, var,
                     prop=prop)
            hold(f"UniformRadius full MVN d={d} {algo.upper()}", algo, full,
                 var_f, prop="UniformRadius")
            hold(f"recorded MVN d={d} {algo.upper()}", algo, mvn, var,
                 record=True)
            if d == D5:
                for dr in draws.NORMAL_IMPLS:
                    if dr != rule[algo]:
                        hold(f"draw {dr} MVN d={d} {algo.upper()}", algo,
                             mvn, var, draw=dr)
        T_max = block_rungs(_build, d, mvn.dim + 1)
        hold(f"MVN d={d} PT at one block's most rungs T={T_max}", "pt",
             mvn, var, T=T_max, C=64)
        rb, var_rb = target("rosenbrock", d)
        hold(f"FullRosenbrock d={d} PT even_odd", "pt", rb, var_rb,
             sweep="even_odd")
        del full
    for d_e in WIDE_EDGES:
        te, ve = target("mvn_iso", d_e)
        for algo in ("rwm", "pt"):
            hold(f"edge d={d_e} {algo.upper()} (1000, ragged)", algo, te, ve,
                 C=1000, T=4)
            if d_e % 2:
                hold(f"edge d={d_e} {algo.upper()} Box-Muller (odd d)", algo,
                     te, ve, C=1000, T=4, draw="bm")
    # SuperFunnel built for its dataset's shape in the 512 bucket, against
    # its run-time-shape library bit for bit and its plain version
    sf = get_target_distribution("SuperFunnel", 0, J=WIDE_SF["J"],
                                 K=WIDE_SF["K"], n_per_group=WIDE_SF["n"],
                                 device=dev)
    for algo in ("rwm", "pt"):
        sf_draw = draws.resolve_normal_impl(algo, 65536, "super_funnel")
        launch, plain, names, args, lkw, _ = warp_case(
            torch, gen, algo, sf, SF_VAR, h["steps"],
            h["C_pt"] if algo == "pt" else h["C_rwm"], T=8,
            burn_in=h["burn_in"], swap_every=h["swap_every"], draw=sf_draw)
        lib = _build.route(_build.library(f"fused_{algo}", "Normal",
                                          sf_draw), sf)[0]
        if _build.fixed_shape(lib) is None or not lib.endswith(".w512"):
            fail(f"phase 20b SuperFunnel d={sf.dim} routes to {lib}")
        p = plain(*args, **lkw)
        for team in _build.library_teams(lib):
            reset_launches(*wrappers)
            k = launch(*args, team=team, **lkw)
            seen = read_launches(*wrappers, by_kind=True)
            r = launch(*args, team=team, specialize=False, **lkw)
            ag = agreement.hold(k, p, names, lp_of=sf.log_density_td)
            equal = all(same(torch, a, b) for a, b in zip(k, r))
            say(f"phase 20b SuperFunnel d={sf.dim} {algo.upper()} {lib} "
                f"G={team}: equal to the run-time-shape library bit for "
                f"bit: {equal}; {agreement.describe(ag)}; launches "
                f"{dict(seen)}")
            if (not equal or set(seen) != {lib} or ag.frac < AGREE_MIN
                    or ag.mismatched):
                fail(f"phase 20b SuperFunnel d={sf.dim} {algo} G={team}")
    say(f"phase 20b {time.time() - t_phase:.1f} s; least share of replicas "
        f"that agree over the kinds {worst:.5f}")

    # ---- (c) Geweke at d = 500: the iso MVN, RWM and PT on six rungs
    # 1 .. 0.8
    seed = int.from_bytes(os.urandom(4), "little")
    ladder = [0.8 ** (t / 5) for t in range(6)]   # swaps accepted at d = 500
    mvn5, var5 = target("mvn_iso", D5)
    reset_launches(*wrappers)
    z_rwm, z_pt, sw = invariance(torch, mvn5, seed, betas=ladder,
                                 base_variance=var5)
    seen = read_launches(*wrappers, by_kind=True)
    say(f"phase 20c invariance MVN d={D5} (seed {seed}): max z RWM "
        f"{z_rwm:.2f}, PT {z_pt:.2f} (< {Z_INV_MAX}) on rungs 1 .. 0.8 (6); "
        f"PT swap acc {sw:.3f}; launches {dict(seen)}")
    if (max(z_rwm, z_pt) >= Z_INV_MAX or not swap_ok(sw, ladder)
            or not all(k.endswith(".w512") for k in seen)):
        fail("phase 20c invariance failed")

    # ---- (d) the main shapes at full width through the entry points, best
    # of 2 calls, the first's launches counted (the main path), then each
    # kernel held against its plain version at the main shape over
    # WIDE_MAIN_HOLD_STEPS steps
    C, T, iters = FLAG["C"], FLAG["T"], FLAG["iters"]
    betas = torch.logspace(0, -2, T, device=dev)
    kernels = []
    for d in WIDE_D:
        for algo, src, site in (
                ("pt", "fused_pt_warp.cu",
                 "rwm_pt_tpu/kernels/pallas_pt.py:399"),
                ("rwm", "fused_rwm_warp.cu",
                 "rwm_pt_tpu/kernels/pallas_rwm.py:570")):
            name = (f"{_build.library(f'fused_{algo}', 'Normal', rule[algo])}"
                    f".w{_build.warp_bucket(d)}")
            launch, plain, names = (
                (fused_pt.launch_pt_kernel, fused_pt._run_pt_fused_plain,
                 agreement.PT_OUTPUTS) if algo == "pt" else
                (fused_rwm.launch_rwm_kernel, fused_rwm._run_rwm_fused_plain,
                 agreement.RWM_OUTPUTS))
            main = {}
            for kind in ("rosenbrock", "mvn_iso"):
                tg, v = target(kind, d)

                def run(rep, tg=tg, v=v):
                    return (run_pt_fused(tg, rep, betas, base_variance=v,
                                         num_chains=C, num_iterations=iters,
                                         swap_every=FLAG["swap_every"],
                                         device=dev) if algo == "pt" else
                            run_rwm_fused(tg, rep, base_variance=v,
                                          num_chains=C, num_iterations=iters,
                                          device=dev))
                # the main path's run with its launches counted, then two
                # more for the best of 3
                reset_launches(*wrappers)
                ms, res = cuda_ms(torch, lambda: run(0))
                seen = read_launches(*wrappers)
                st = res.state
                acc = res.acceptance_rate.mean().item()
                if (set(seen) != {name} or seen[name] != 1
                        or not torch.isfinite(st.x).all()
                        or not torch.isfinite(st.logp).all()
                        or not 0 < acc < 1):
                    fail(f"phase 20d {kind} d={d} {algo}: launches "
                         f"{dict(seen)}, acc {acc}")
                del st, res
                times = [ms]
                n_params = _build.kernel_target(tg)[1].numel()
                work = (pt_work(kind, d, T, C, iters, 0, FLAG["swap_every"],
                                draw=rule[algo], n_params=n_params)
                        if algo == "pt" else
                        rwm_work(kind, d, C, iters, draw=rule[algo],
                                 n_params=n_params))
                main[kind] = (min(times), work, seen[name], acc)
                torch.cuda.empty_cache()
            rb, var_rb = target("rosenbrock", d)
            geo = _build.launch_geometry(
                _build.route(_build.library(f"fused_{algo}", "Normal",
                                            rule[algo]), rb)[0],
                d, C, T if algo == "pt" else 0, "Normal", rule[algo],
                _build.kernel_target(rb)[1].numel())

            def rb_case(steps, hold_, algo=algo, rb=rb, var_rb=var_rb):
                _, _, _, args, kw, work = warp_case(
                    torch, gen, algo, rb, var_rb, steps, C, T=T,
                    draw=rule[algo], burn_in=0,
                    swap_every=10 if hold_ else FLAG["swap_every"])
                return args, kw, work
            full_ms, full_work, launches, acc = main["rosenbrock"]
            rec = kernel_record(torch, name, "rwm_pt_tpu_torch/kernels/csrc/"
                                + src, site, launches, launch, plain, names,
                                rb_case, iters, phase="20d",
                                hold_steps=WIDE_MAIN_HOLD_STEPS,
                                main=(full_ms, full_work))
            mvn_ms, mvn_work, _, mvn_acc = main["mvn_iso"]
            mb_ms, _, mb_lim = bound(*mvn_work)
            # the eager engine, EAGER_STEPS steps on the iso MVN
            mvn, var = target("mvn_iso", d)
            pr = NormalProposal.create(d, var, device=dev)
            e_ms, _ = cuda_ms(torch, lambda: (
                run_pt(mvn, pr, 5, betas, num_chains=C,
                       num_iterations=EAGER_STEPS,
                       swap_every=FLAG["swap_every"],
                       swap_sweep="sequential", device=dev)
                if algo == "pt" else
                run_rwm(mvn, pr, 5, num_chains=C,
                        num_iterations=EAGER_STEPS, device=dev)))
            del _
            rec.update(dim=d, team=geo.team, replicas_a_block=geo.replicas,
                       blocks_per_sm=geo.blocks_per_sm, acceptance=acc,
                       mvn_iso_ms=mvn_ms, mvn_iso_bound_ms=mb_ms,
                       mvn_iso_acceptance=mvn_acc,
                       eager_ms_per_step=e_ms / EAGER_STEPS)
            say(f"phase 20d {name} d={d} at the main shape ({C} "
                f"{'replicas x T=10' if algo == 'pt' else 'chains'}, {iters} "
                f"steps, through run_{algo}_fused, one call; team "
                f"G={geo.team}, {geo.replicas} "
                f"{'replicas' if algo == 'pt' else 'chains'} a block, "
                f"{geo.blocks_per_sm} blocks an SM): FullRosenbrock "
                f"{full_ms:.3f} ms against its {rec['main_path_bound_ms']:.3f}"
                f" ms bound by {rec['main_path_bound_limit']} "
                f"({100 * rec['main_path_bound_share']:.1f} %), the iso MVN "
                f"{mvn_ms:.3f} ms against {mb_ms:.3f} ms by {mb_lim} "
                f"({100 * mb_ms / mvn_ms:.1f} %); acceptance {acc:.4f}, "
                f"{mvn_acc:.4f}; the eager engine "
                f"{e_ms / EAGER_STEPS:.3f} ms a step ({EAGER_STEPS} steps); "
                f"launches {launches}")
            kernels.append(rec)
            torch.cuda.empty_cache()
    # ---- (f) the RWM rate on the iso MVN at d = 1000, sigma^2 = 2.38^2/d:
    # (d)'s run from the target's init, and a run from exact draws
    mvn10, var10 = target("mvn_iso", D10)
    g = torch.Generator(device=dev).manual_seed(20)
    stat = run_rwm_fused(mvn10, 20, base_variance=var10, num_chains=4096,
                         num_iterations=iters, device=dev,
                         init_states=mvn10.direct_sample(4096, 1.0, g).T)
    say(f"phase 20f RWM acceptance on the iso MVN d={D10} at sigma^2 = "
        f"2.38^2/d, {iters} steps: {kernels[-1]['mvn_iso_acceptance']:.4f} "
        f"from the target's init ({C} chains), "
        f"{stat.acceptance_rate.mean().item():.4f} from exact draws (4096 "
        f"chains); the d -> infinity limit 2 Phi(-2.38/2) = "
        f"{math.erfc(2.38 / 2 / math.sqrt(2)):.4f}")
    say(f"phase 20d {time.time() - t_phase:.1f} s")

    # ---- (e) the entry points
    # (400 steps x 1000 x 4 recorded floats: within the harness's budget,
    # so every step is recorded)
    for algo in ("RWM", "PT"):
        harness_entry(torch, "20e", ".w1024", algo, D10, 400, sigma=var10,
                      target_dist=mvn10)
    study_entry(torch, "20e", ".w1024", D10, WIDE_STUDY_CONFIGS, 1024,
                os.path.join(HERE, "smoke_out", "wide", "study"))
    # the ladder kernel: its main path at d = 1000, then every kind with a
    # direct sampler at d = 500 and the iso MVN at d = 1000 against its
    # plain version
    launch_l = ladder_build.launch_ladder_kernel
    name_l = f"{_build.LADDER}.mvn_iso"
    reset_launches(launch_l, *wrappers)
    sim = MCMCSimulation(
        dim=D10, sigma=var10, num_iterations=200, algorithm="PT",
        target_dist=mvn10, num_chains=1024, seed=1,
        iterative_temp_spacing=True, record_chain=False,
        beta_min_iterative=WIDE_LADDER["beta_min"],
        N_samples_swap_est=WIDE_LADDER["N_wide"],
        iterative_tolerance=LADDER_HOLD["tolerance"], device=dev)
    sim.generate_samples(verbose=False)
    torch.cuda.synchronize()
    seen_l, seen = dict(launch_l.launches), read_launches(*wrappers)
    if (seen_l != {name_l: 1} or sim.engine_used != "pallas"
            or not all(k.endswith(".w1024") for k in seen)):
        fail(f"phase 20e ladder main path d={D10}: ladder {seen_l}, fused "
             f"{dict(seen)}, engine {sim.engine_used}")
    say(f"phase 20e ladder main path: MCMCSimulation(iterative_temp_"
        f"spacing=True) MVN d={D10}, beta_min {WIDE_LADDER['beta_min']}: "
        f"{len(sim.beta_ladder)} rungs, swap acc {sim.acceptance_rate():.4f};"
        f" launches {seen_l}, fused {dict(seen)}")
    del sim
    # the rungs the iso MVN's ladder takes down to the harness's default
    # beta_min 0.01 (N = 3000), beside the fused kernel's room (A17)
    default_probes = {}
    for d in WIDE_D:
        tg, _ = target("mvn_iso", d)
        full_ladder = launch_l(tg, N_samples_swap_est=LADDER_HARNESS_N,
                               tolerance=LADDER_HOLD["tolerance"], seed=1,
                               max_T=L.EAGER_MAX_RUNGS + 1)
        default_probes[d] = full_ladder.probes
        say(f"phase 20e the iso MVN's ladder at d={d} down to beta_min 0.01:"
            f" {len(full_ladder.betas)} rungs, {full_ladder.probes} probes;"
            f" the fused kernel takes {_build.target_max_rungs(tg)}")
    ladder_rec = None
    for kind, d in [(k, D5) for k in LADDER_KINDS] + [("mvn_iso", D10)]:
        tg = ladder_target(get_target_distribution, kind, d, dev,
                           kw=WIDE_HYBRID[d] if kind == "hybrid_rosenbrock"
                           else WIDE_LADDER["kw"].get(kind))
        held = dict(LADDER_HOLD, N_samples_swap_est=WIDE_LADDER[
            "N_wide" if d == D10 else "N"],
            beta_min=WIDE_LADDER["beta_min"], max_T=L.EAGER_MAX_RUNGS + 1)
        if d == D5:
            held.update(WIDE_LADDER["held"])
        # the record's kernel best of 3, the others' once
        got = ladder_hold(torch, "20e", tg, kind, f"ladder {kind} d={tg.dim}",
                          held, reps=3 if d == D10 else 1)
        if kind == "mvn_full":
            say(f"phase 20e the full MVN's ladder at d={d}: "
                f"{got['us_a_probe'] / 1e3:.1f} ms a probe at N="
                f"{held['N_samples_swap_est']}, "
                f"{got['ms'] / got['plain_ms']:.1f}x its plain version's "
                f"time; a build down to beta_min 0.01 of as many probes as "
                f"the iso MVN's above ({default_probes[D5]}) would take ~"
                f"{default_probes[D5] * got['us_a_probe'] / 1e6:.0f} s of "
                f"this kernel (an estimate, not timed: ROADMAP B17)")
        if d == D10:
            ladder_rec = ladder_record(_build.ladder_lib(kind, d),
                                       seen_l[name_l], tg, kind, got)
    # the funnel at its default sigma_v^2 = 9, shown and not held: its
    # tempered v overflows float32 at the search's first probe (WIDE_LADDER)
    nf = ladder_target(get_target_distribution, "neal_funnel", D5, dev)
    k = launch_l(nf, **dict(LADDER_HOLD, N_samples_swap_est=WIDE_LADDER["N"],
                            max_T=L.EAGER_MAX_RUNGS + 1,
                            **WIDE_LADDER["held"]))
    say(f"phase 20e ladder neal_funnel d={D5} at sigma_v^2 = 9 (shown, not "
        f"held): {k.betas}, {k.probes} probes, "
        f"{sum(not math.isfinite(a) for a in k.a_hats)} of them NaN")
    kernels.append(ladder_rec)
    say(f"phase 20 {time.time() - t_phase:.1f} s")
    return kernels


def rungs_layout(geo):
    """A launch's layout in a few words (phase 21)."""
    if geo.cluster:
        return (f"G={geo.team}, clusters of {geo.cluster} blocks of "
                f"{geo.slots} slots, {geo.replicas} replicas a cluster")
    if geo.runtime_r:
        return f"runtime-R, {geo.replicas} replicas a block"
    return f"G={geo.team}, one block of {geo.replicas} replicas"


def rungs_record(name, source, launches, held, main):
    """A kernels-line record of a build that takes more than 32 rungs:
    ``held`` = (kernel ms, plain ms, Agreement, work) of its 21a hold (of
    the same library),
    ``main`` = (ms, work) of its 21d main path at 65,536 replicas."""
    ms, plain_ms, ag, work = held
    b_ms, b_by, b_lim = bound(*work)
    m_ms, m_work = main
    mb_ms, _, mb_lim = bound(*m_work)
    return dict(
        name=name, route="cuda", source=source,
        replaces="rwm_pt_tpu/kernels/pallas_pt.py:399", launches=launches,
        max_abs_err=ag.max_dx, ms=ms, plain_ms=plain_ms, bound_ms=b_ms,
        bound_by=b_by, library_ms=None, steps=RUNGS_HOLD["steps"],
        replicas=RUNGS_HOLD["C"], agree_frac=ag.frac,
        max_rel_err=ag.max_rel, bound_limit=b_lim, main_path_ms=m_ms,
        main_path_bound_ms=mb_ms, main_path_bound_limit=mb_lim,
        main_path_bound_share=mb_ms / m_ms)


def phase_21(torch, gen):
    """Phase 21, ladders of more than 32 rungs (A17; module docstring):
    (a) the holds, (b) the cluster build bit for bit against the one-block
    build, and the chains-sharded runs, (c) Geweke, (d) the main shapes at
    65,536 replicas and the team sizes forced, (e) the harness's iterative
    ladders at d = 500 and 1000.  Returns the kernels line's records of the
    T > 32 builds: the thread kernel's runtime-R instantiation (d = 30),
    the one-block team kernel (d = 100) and the cluster build (d = 500 and
    1000), each with the launches of its main path in (d)."""
    from rwm_pt_tpu_torch.api import MCMCSimulation
    from rwm_pt_tpu_torch.kernels import (_build, agreement, draws, fused_pt,
                                          run_pt, run_pt_fused,
                                          run_pt_fused_sharded)
    from rwm_pt_tpu_torch.kernels.fused_pt import SWEEPS
    from rwm_pt_tpu_torch.parallel import make_mesh
    from rwm_pt_tpu_torch.proposals import NormalProposal
    from rwm_pt_tpu_torch.targets import get_target_distribution

    t_phase = time.time()
    dev = torch.device("cuda")
    launch = fused_pt.launch_pt_kernel
    rule = draws.resolve_normal_impl("pt", 65536, "mvn_iso")
    h = RUNGS_HOLD
    C = FLAG["C"]
    mvn = {}

    def target(d):
        if d not in mvn:
            mvn[d] = get_target_distribution("MultivariateNormal", d,
                                             device=dev)
        return mvn[d], 2.38 ** 2 / d

    def geometry(d, T, C, prop="Normal", team=None, cluster=None):
        """(library, geometry) of a launch of T rungs at d on C replicas."""
        tg, _ = target(d)
        lib = _build.route(_build.library("fused_pt", prop, rule), tg)[0]
        geo = _build.launch_geometry(lib, d, C, T, prop, rule,
                                     _build.kernel_target(tg)[1].numel(),
                                     team, cluster)
        return (_build.cluster_lib(lib) if geo.cluster else lib), geo

    say(f"phase 21 the draw rule (phase 12, measured at T <= 32, not "
        f"retuned) picks {rule} for the iso MVN's PT at {C} replicas and "
        f"{draws.resolve_normal_impl('pt', h['C'], 'mvn_iso')} at {h['C']}; "
        f"phase 21 runs {rule}")

    # ---- (a) every T > 32 build against its plain version: T = 33, 50
    # and 64 at each d in both sweep orders, the proposals at d = 500
    cases = [(d, T, sweep, prop, h["C"]) for d in RUNGS_D for T in RUNGS_T
             for sweep in SWEEPS for prop in ("Normal",) + (
                 NEW_PROPOSALS if d == 500 and sweep == SWEEPS[0] else ())]
    cases += [(d, T, SWEEPS[0], "Normal", 256) for d, T in RUNGS_SMALL]
    held, worst = {}, 1.0
    for d, T, sweep, prop, Ch in cases:
        tg, var = target(d)
        _, plain, names, args, lkw, work = warp_case(
            torch, gen, "pt", tg, var, h["steps"], Ch, T=T, prop=prop,
            draw=rule, burn_in=h["burn_in"], swap_every=h["swap_every"])
        lkw["swap_sweep"] = sweep
        lib, geo = geometry(d, T, Ch, prop)
        reset_launches(launch)
        ms, k = cuda_ms(torch, lambda: launch(*args, **lkw))
        seen = read_launches(launch, by_kind=True)
        plain_ms, p = cuda_ms(torch, lambda: plain(*args, **lkw))
        ag = agreement.hold(k, p, names, lp_of=tg.log_density_td)
        b_ms, _, b_lim = bound(*work)
        say(f"phase 21a d={d} T={T} {prop} {sweep} ({Ch} replicas): {lib} "
            f"({rungs_layout(geo)}) kernel {ms:.3f} ms, plain "
            f"{plain_ms:.1f} ms, bound {b_ms:.4f} ms by {b_lim}; "
            f"{int(k[3].sum())} swaps; {agreement.describe(ag)}")
        if (dict(seen) != {_build.launch_key(lib): 1}
                or ag.frac < RUNGS_AGREE_MIN or ag.mismatched
                or not (k[3] > 0).any()):
            fail(f"phase 21a d={d} T={T} {prop} {sweep}: launches "
                 f"{dict(seen)}, {agreement.describe(ag)}")
        worst = min(worst, ag.frac)
        if prop == "Normal" and sweep == SWEEPS[0] and Ch == h["C"]:
            held[d, T] = (ms, plain_ms, ag, work, lib)
        del k, p
    say(f"phase 21a {time.time() - t_phase:.1f} s; least share of replicas "
        f"that agree {worst:.5f} (>= {RUNGS_AGREE_MIN})")

    # ---- (b) the cluster build forced against the one-block build, bit for
    # bit, where one block holds the ladder; the chains-sharded runs
    for d, T, team, ks in RUNGS_SAME:
        tg, var = target(d)
        _, _, names, args, lkw, _ = warp_case(
            torch, gen, "pt", tg, var, h["steps"], h["C"], T=T, draw=rule,
            burn_in=h["burn_in"], swap_every=h["swap_every"])
        lkw.update(team=team, record_every=3, record_chains=h["C"])
        one_lib = geometry(d, T, h["C"], team=team)[0]
        for sweep in SWEEPS:
            lkw["swap_sweep"] = sweep
            one = launch(*args, **lkw)
            for k in ks:
                reset_launches(launch)
                out = launch(*args, cluster=k, **lkw)
                seen = read_launches(launch, by_kind=True)
                bad = [n for n, a, b in zip(agreement.PT_REC_OUTPUTS, one,
                                            out) if not same(torch, a, b)]
                if bad or set(seen) != {_build.cluster_lib(one_lib),
                                        "fused_pt_record"}:
                    fail(f"phase 21b d={d} T={T} G={team} {sweep} over {k} "
                         f"blocks: differs from one block in {bad}; "
                         f"launches {dict(seen)}")
        say(f"phase 21b d={d} T={T} G={team}: {one_lib}'s cluster build over "
            f"{ks} blocks equals its one-block build bit for bit (x, lp, "
            f"counts, both sums, the cold trace) in both sweep orders")
    d, T = RUNGS_SHARD["d"], RUNGS_SHARD["T"]
    tg, var = target(d)
    betas = torch.logspace(0, -2, T, device=dev)
    kw = dict(base_variance=var, num_chains=RUNGS_SHARD["C"],
              num_iterations=RUNGS_SHARD["iters"], swap_every=10)
    lib, geo = geometry(d, T, RUNGS_SHARD["C"])
    ref = run_pt_fused(tg, 7, betas, device=dev, **kw)
    line = []
    for n in SHARD_COUNTS:
        reset_launches(launch)
        ms, res = cuda_ms(torch, lambda: run_pt_fused_sharded(
            tg, 7, betas, make_mesh((n,), ("chains",), devices=[dev] * n),
            **kw))
        seen = read_launches(launch, by_kind=True)
        bad = differ(torch, res, ref, PT_STATE)
        if bad or sum(seen.values()) != n:
            fail(f"phase 21b d={d} T={T} on {n} shards: differs in {bad}; "
                 f"launches {dict(seen)}")
        line.append(f"{n} shards {ms:.3f} ms ({dict(seen)})")
    say(f"phase 21b chains-sharded d={d} T={T} ({RUNGS_SHARD['C']} "
        f"replicas, {RUNGS_SHARD['iters']} steps; unsharded {lib}, "
        f"{rungs_layout(geo)}): equal bit for bit ({', '.join(PT_STATE)}) "
        f"to the unsharded run on {SHARD_COUNTS} shards; " + "; ".join(line))
    del ref, res

    # ---- (c) Geweke at T = 40: the thread kernel and the cluster build
    g = RUNGS_GEWEKE
    for d, beta_min in g["d"]:
        tg, var = target(d)
        seed = int.from_bytes(os.urandom(4), "little")
        ladder = [beta_min ** (t / (g["T"] - 1)) for t in range(g["T"])]
        lib, geo = geometry(d, g["T"], 4096)
        reset_launches(launch)
        z_rwm, z_pt, sw = invariance(torch, tg, seed, betas=ladder,
                                     rungs=g["rungs"], base_variance=var)
        seen = read_launches(launch, by_kind=True)
        say(f"phase 21c invariance MVN d={d}, T={g['T']} rungs 1 .. "
            f"{beta_min} (seed {seed}; {lib}, {rungs_layout(geo)}): max z "
            f"RWM {z_rwm:.2f}, PT {z_pt:.2f} at rungs {g['rungs']} (< "
            f"{Z_INV_MAX}); PT swap acc {sw:.3f}; launches {dict(seen)}")
        if (max(z_rwm, z_pt) >= Z_INV_MAX or not swap_ok(sw, ladder)
                or _build.launch_key(lib) not in seen):
            fail(f"phase 21c invariance failed at d={d}")

    # ---- (d) the main shapes at 65,536 replicas through run_pt_fused, one
    # call, its launches counted (the main path)
    records = []
    for (d, T, iters), src in zip(RUNGS_MAIN, (
            "fused_pt.cu", "fused_pt_warp.cu", "fused_pt_warp.cu",
            "fused_pt_warp.cu")):
        tg, var = target(d)
        betas = torch.logspace(0, -2, T, device=dev)
        lib, geo = geometry(d, T, C)

        def run(rep):
            return run_pt_fused(tg, rep, betas, base_variance=var,
                                num_chains=C, num_iterations=iters,
                                swap_every=FLAG["swap_every"], device=dev)
        reset_launches(launch)
        ms, res = cuda_ms(torch, lambda: run(0))
        seen = read_launches(launch, by_kind=True)
        acc = res.acceptance_rate.mean().item()
        if (dict(seen) != {_build.launch_key(lib): 1}
                or not torch.isfinite(res.state.x).all()
                or not torch.isfinite(res.state.logp).all()
                or not 0 < acc < 1):
            fail(f"phase 21d d={d} T={T}: launches {dict(seen)}, acc {acc}")
        swap = res.swap_acceptance_rate.mean().item()
        del res
        work = pt_work("mvn_iso", d, T, C, iters, 0, FLAG["swap_every"],
                       draw=rule, n_params=d + 1)
        b_ms, _, b_lim = bound(*work)
        say(f"phase 21d d={d} T={T} ({C} replicas, {iters} steps, through "
            f"run_pt_fused): {lib} ({rungs_layout(geo)}, "
            f"{geo.blocks_per_sm} blocks, {_build.resident_warps(geo)} warps "
            f"an SM) {ms:.3f} ms against its {b_ms:.3f} ms bound by {b_lim} "
            f"({100 * b_ms / ms:.1f} %), {ms / iters:.4f} ms a step; "
            f"acceptance {acc:.4f}, swap {swap:.4f}; launches {dict(seen)}")
        key = _build.launch_key(lib)
        name = (f"{lib} (runtime-R, T={T})" if geo.runtime_r else
                f"{key} (T={T})")
        if held[d, 50][4] != lib:   # the record's hold is of its library
            fail(f"phase 21d d={d}: held {held[d, 50][4]}, ran {lib}")
        records.append(rungs_record(
            name, "rwm_pt_tpu_torch/kernels/csrc/" + src, seen[key],
            held[d, 50][:4], (ms, work)))
        torch.cuda.empty_cache()
    for d, T in RUNGS_TEAMS:   # each team size forced, in turns
        tg, var = target(d)
        betas = torch.logspace(0, -2, T, device=dev)
        line = []
        for team in (16, 32, 32, 16):
            lib, geo = geometry(d, T, C, team=team)
            ms, _ = cuda_ms(torch, lambda: run_pt_fused(
                tg, 2, betas, base_variance=var, num_chains=C,
                num_iterations=RUNGS_TEAM_ITERS,
                swap_every=FLAG["swap_every"], device=dev,
                _shard=_build.Shard(team=team)))
            line.append(f"G={team} {ms:.3f} ms ({rungs_layout(geo)}, "
                        f"{geo.blocks_per_sm} blocks, "
                        f"{_build.resident_warps(geo)} warps an SM)")
            del _
            torch.cuda.empty_cache()
        say(f"phase 21d teams forced in turns at d={d} T={T} ({C} replicas,"
            f" {RUNGS_TEAM_ITERS} steps; the geometry takes "
            f"G={geometry(d, T, C)[1].team}): " + "; ".join(line))
    # the cluster build's swap step split by its measuring build's
    # %globaltimer stamps (uncounted), at the geometry's team
    d, T = RUNGS_SPLIT["d"], RUNGS_SPLIT["T"]
    tg, var = target(d)
    for team in (None, 16):
        launch, _, _, args, lkw, _ = warp_case(
            torch, gen, "pt", tg, var, RUNGS_SPLIT["steps"],
            RUNGS_SPLIT["C"], T=T, swap_every=RUNGS_SPLIT["swap_every"])
        sp = fused_pt.swap_split(*args, team=team, **lkw)
        if not sp["swap_steps"] or sp["cluster"] < 2:
            fail(f"phase 21d swap split: {sp}")
        parts = ", ".join(f"{k} {sp[k]:.2f}" for k in fused_pt.SWAP_SPLIT)
        bars = sum(sp[k] for k in ("barrier1", "barrier2", "barrier3"))
        say(f"phase 21d the cluster build's swap step at d={d} T={T} "
            f"(G={sp['team']}, clusters of {sp['cluster']}; block thread 0's "
            f"%globaltimer stamps, us a swap step over the blocks): {parts}; "
            f"the step {sp['swap_step']:.2f} us, its three cluster barriers "
            f"{bars:.2f} us ({100 * bars / sp['swap_step']:.1f} %); a step "
            f"with no swap {sp['step']:.2f} us")
        del args
        torch.cuda.empty_cache()

    # ---- (e) the harness's iterative ladders down to beta_min 0.01 at
    # d = 500 and 1000 on the fused kernels, beside the eager engine on the
    # same ladder
    for d in WIDE_D:
        tg, var = target(d)
        reset_launches(launch)
        t0 = time.time()
        sim = MCMCSimulation(
            dim=d, sigma=var, num_iterations=RUNGS_HARNESS["iters"],
            algorithm="PT", target_dist=tg, num_chains=C, seed=1,
            iterative_temp_spacing=True, beta_min_iterative=0.01,
            record_chain=False, device=dev)
        ladder_s = time.time() - t0
        sim.generate_samples(verbose=False)
        torch.cuda.synchronize()
        seen = read_launches(launch, by_kind=True)
        ladder = list(sim.beta_ladder)
        T = len(ladder)
        if (sim._engine_used != "pallas" or T <= 32
                or abs(ladder[-1] - 0.01) > 1e-6
                or sum(seen.values()) != 1):
            fail(f"phase 21e MCMCSimulation d={d}: engine "
                 f"{sim._engine_used}, {T} rungs, launches {dict(seen)}")
        run_ms = sim.elapsed_time * 1e3
        swap = sim.acceptance_rate()
        del sim
        torch.cuda.empty_cache()
        betas = torch.tensor(ladder, dtype=torch.float32, device=dev)
        Ce, steps = RUNGS_HARNESS["eager_C"], RUNGS_HARNESS["eager_steps"]
        kw = dict(num_chains=Ce, num_iterations=steps,
                  swap_every=FLAG["swap_every"], device=dev)
        f_ms = cuda_ms(torch, lambda: run_pt_fused(
            tg, 3, betas, base_variance=var, **kw), 2)[0]
        e_ms = cuda_ms(torch, lambda: run_pt(
            tg, NormalProposal.create(d, var, device=dev), 3, betas,
            swap_sweep="sequential", **kw))[0]
        say(f"phase 21e MCMCSimulation(iterative_temp_spacing=True) MVN "
            f"d={d} down to beta_min 0.01: {T} rungs (ladder {ladder_s:.2f} "
            f"s), engine pallas, {C} replicas x {RUNGS_HARNESS['iters']} "
            f"iterations in {run_ms:.1f} ms "
            f"({run_ms / RUNGS_HARNESS['iters']:.3f} ms a step), swap acc "
            f"{swap:.4f}; launches {dict(seen)}; on the same ladder at {Ce} "
            f"replicas, {steps} steps: fused {f_ms / steps:.3f} ms a step, "
            f"the eager engine {e_ms / steps:.3f} ms a step "
            f"({e_ms / f_ms:.1f}x)")
        torch.cuda.empty_cache()
    say(f"phase 21 {time.time() - t_phase:.1f} s")
    return records


def wider_hold(torch, gen, label, algo, tg, var, C, steps, record=False,
               sweep=None, **kw):
    """One phase 22a hold: the launch of :func:`warp_case` (``kw`` its
    options) with the layout the wrapper's geometry takes (one block, or
    PT's cluster build where one block does not hold the ladder) against
    its plain version, its launches counted under that library and nowhere
    else; at least :data:`RUNGS_AGREE_MIN` of the replicas agree
    (:data:`WIDER_AGREE`'s gate for its kinds), counters exact, else the
    smoke fails.  ``record`` records every step of every
    replica, ``sweep`` the PT pair order.  Returns ``(Agreement, kernel
    ms, plain ms, work, library)``."""
    from rwm_pt_tpu_torch.kernels import _build, agreement, fused_pt, fused_rwm
    wrappers = (fused_pt.launch_pt_kernel, fused_rwm.launch_rwm_kernel)
    launch, plain, names, args, lkw, work = warp_case(torch, gen, algo, tg,
                                                      var, steps, C, **kw)
    if sweep:
        lkw["swap_sweep"] = sweep
    if record:
        lkw.update(record_every=1, record_chains=C)
        names = names + ("chain",)
        work = (work[0], work[1], work[2] + rec_bytes(tg.dim, steps, 1, C),
                work[3])
    lib, _, words = _build.route(_build.library(
        f"fused_{algo}", lkw["kind"], lkw["draw"]), tg)
    geo = _build.launch_geometry(lib, tg.dim, C, kw.get("T", 10)
                                 if algo == "pt" else 0, lkw["kind"],
                                 lkw["draw"], words.numel())
    if geo.cluster:
        lib = _build.cluster_lib(lib)
    want = {_build.launch_key(lib)} | (
        {f"fused_{algo}_record"} if record else set())
    reset_launches(*wrappers)
    ms, k = cuda_ms(torch, lambda: launch(*args, **lkw))
    seen = read_launches(*wrappers, by_kind=True)
    plain_ms, p = cuda_ms(torch, lambda: plain(*args, **lkw))
    ag = agreement.hold(k, p, names, lp_of=tg.log_density_td)
    b_ms = (f"{bound(*work)[0]:.4f} ms by {bound(*work)[2]}"
            if work is not None else "(SuperFunnel: phase 17's count)")
    say(f"phase 22a {label}: {lib} (G={geo.team}, "
        + (f"clusters of {geo.cluster} blocks of {geo.slots} slots"
           if geo.cluster else f"{geo.replicas} a block")
        + f") kernel {ms:.3f} ms, plain {plain_ms:.1f} ms, bound {b_ms}; "
        f"{agreement.describe(ag)}")
    gate = WIDER_AGREE.get(_build.target_kind(tg), RUNGS_AGREE_MIN)
    if set(seen) != want or ag.frac < gate or ag.mismatched:
        fail(f"phase 22a {label}: launches {dict(seen)} (want {want}), "
             f"{agreement.describe(ag)}")
    return ag, ms, plain_ms, work, lib


def wide_teams_22g(torch, gen, target):
    """Phase 22g, the wide teams (G = 64, 128) of PT and RWM and G = 32
    forced in turn at d = 2000 (PT: one block at G = 32 and 64, a cluster
    at 128; RWM: one block at every G) and 4000 (PT: clusters): each
    against its plain version (:data:`WIDER_AGREE` or
    :data:`RUNGS_AGREE_MIN`, counters exact) and again bit for bit (no race
    between a team's warps); the kinds that sum in index order (IIDGamma,
    IIDBeta, NealFunnel) bit for bit G = 32's at every wide team under the
    Normal and Laplace proposals (UniformRadius's norm is a butterfly sum
    at every team size)."""
    from rwm_pt_tpu_torch.kernels import _build, agreement, fused_pt, fused_rwm
    t0 = time.time()
    h = WIDER_HOLD
    for algo, launch in (("pt", fused_pt.launch_pt_kernel),
                         ("rwm", fused_rwm.launch_rwm_kernel)):
        shape = (f"PT {h['C_pt']} x T={h['T']}" if algo == "pt" else
                 f"RWM {WIDE_TEAMS_RWM_C} chains")
        for d, kind, props in WIDE_TEAMS_HELD:
            tg, var = target(kind, d)
            for prop in props:
                _, plain, names, args, lkw, _ = warp_case(
                    torch, gen, algo, tg, var, h["steps"],
                    h["C_pt"] if algo == "pt" else WIDE_TEAMS_RWM_C,
                    T=h["T"], prop=prop, burn_in=h["burn_in"],
                    swap_every=h["swap_every"])
                p = plain(*args, **lkw)
                lib = _build.route(_build.library(
                    f"fused_{algo}", lkw["kind"], lkw["draw"]), tg)[0]
                ref, line = None, []
                for team in _build.library_teams(lib):
                    reset_launches(launch)
                    k = launch(*args, team=team, **lkw)
                    again = launch(*args, team=team, **lkw)
                    seen = read_launches(launch, by_kind=True)
                    ag = agreement.hold(k, p, names,
                                        lp_of=tg.log_density_td)
                    gate = WIDER_AGREE.get(kind, RUNGS_AGREE_MIN)
                    race = [n for n, a, b in zip(names, k, again)
                            if not torch.equal(a, b)]
                    if ag.frac < gate or ag.mismatched or race or sum(
                            seen.values()) != 2:
                        fail(f"phase 22g {algo} {kind} d={d} {prop} "
                             f"G={team}: {agreement.describe(ag)}; repeat "
                             f"differs in {race}; launches {dict(seen)}")
                    same_g32 = (team > 32 and kind in INDEX_ORDER_KINDS
                                and prop != "UniformRadius")
                    if team == 32:
                        ref = k
                    elif same_g32:
                        bad = [n for n, a, b in zip(names, k, ref)
                               if not torch.equal(a, b)]
                        if bad:
                            fail(f"phase 22g {algo} {kind} d={d} {prop} "
                                 f"G={team} differs from G=32 in {bad}")
                    line.append(f"G={team} {next(iter(seen))} agree "
                                f"{ag.frac:.5f}" + (
                                    ", = G=32 bit for bit" if same_g32
                                    else ""))
                say(f"phase 22g {kind} d={d} {prop} ({shape}, "
                    f"{h['steps']} steps; each run twice, bit for bit): "
                    + "; ".join(line))
                del p, args
            del tg
            torch.cuda.empty_cache()
    say(f"phase 22g {time.time() - t0:.1f} s")


def phase_22(torch, gen):
    """Phase 22, the widest warp buckets (1020 < d <= 4092, A15's
    remainder; module docstring): (a) the holds, the chains-sharded runs
    bit for bit, (b) Geweke at d = 2000, (c) the main shapes at d = 2000
    and 4000, (d) the entry points, (e) the ladder kernel, (f) the RWM
    rate from exact draws.  Returns the kernels line's records: PT and RWM
    of each new bucket, with the launches of their main paths in (c), and
    the ladder kernel's full MVN at d = 500 and 2000 and iso MVN at
    d = 2000 and 4000, with the launches of their main paths in (d) and
    (e)."""
    from rwm_pt_tpu_torch.api import MCMCSimulation
    from rwm_pt_tpu_torch.kernels import (_build, agreement, draws, fused_pt,
                                          fused_rwm, fused_sharded,
                                          ladder_build, run_pt_fused,
                                          run_pt_fused_sharded,
                                          run_rwm_fused,
                                          run_rwm_fused_sharded)
    from rwm_pt_tpu_torch.kernels.fused_pt import SWEEPS
    from rwm_pt_tpu_torch.ladders import ladders as L
    from rwm_pt_tpu_torch.ladders import construct_iterative_ladder_device
    from rwm_pt_tpu_torch.parallel import make_mesh
    from rwm_pt_tpu_torch.targets import get_target_distribution

    t_phase = time.time()
    dev = torch.device("cuda")
    wrappers = (fused_pt.launch_pt_kernel, fused_rwm.launch_rwm_kernel)
    h = WIDER_HOLD
    rule = {a: draws.resolve_normal_impl(a, 65536) for a in ("pt", "rwm")}
    D2, D4 = WIDER_D

    def target(kind, d):
        return wide_target(get_target_distribution, kind, d, dev)

    def hold(label, algo, tg, var, C=None, **kw):
        return wider_hold(torch, gen, label, algo, tg, var,
                          C or (h["C_pt"] if algo == "pt" else h["C_rwm"]),
                          h["steps"], **dict(dict(
                              T=h["T"], burn_in=h["burn_in"],
                              swap_every=h["swap_every"],
                              draw=rule[algo]), **kw))

    # ---- (a) holds: every kind at d = 2000, four at d = 4092, the
    # proposals, draws, recording and both sweeps at d = 2000, each
    # bucket's most rungs, the edges, SuperFunnel, the sharded runs
    worst = 1.0
    for d, kinds in ((D2, [k for k in _build.TARGET_KINDS
                           if k != "super_funnel"]),
                     (WIDER_EDGES[-1], WIDER_KINDS_4092)):
        for kind in kinds:
            tg, var = target(kind, d)
            for algo in ("rwm", "pt"):
                worst = min(worst, hold(f"{kind} d={tg.dim} "
                                        f"{algo.upper()}", algo, tg,
                                        var)[0].frac)
            del tg
            torch.cuda.empty_cache()
    mvn, var = target("mvn_iso", D2)
    for algo in ("rwm", "pt"):
        for prop in NEW_PROPOSALS:
            hold(f"{prop} MVN d={D2} {algo.upper()}", algo, mvn, var,
                 prop=prop)
        hold(f"recorded MVN d={D2} {algo.upper()}", algo, mvn, var,
             record=True)
        for dr in draws.NORMAL_IMPLS:
            if dr != rule[algo]:
                hold(f"draw {dr} MVN d={D2} {algo.upper()}", algo, mvn, var,
                     draw=dr)
    rb, var_rb = target("rosenbrock", D2)
    hold(f"FullRosenbrock d={D2} PT {SWEEPS[1]}", "pt", rb, var_rb,
         sweep=SWEEPS[1])
    for d in (D2, WIDER_EDGES[-1]):
        tg, v = target("mvn_iso", d)
        fit = _build.target_rungs_fit(tg)
        hold(f"MVN d={d} PT at the fit's most rungs T={fit.rungs} "
             f"({fit.layout})", "pt", tg, v, T=fit.rungs, C=64)
    for d_e in WIDER_EDGES:
        te, ve = target("mvn_iso", d_e)
        for algo in ("rwm", "pt"):
            hold(f"edge d={d_e} {algo.upper()} (1000, ragged)", algo, te, ve,
                 C=1000, T=4)
            if d_e % 2:
                hold(f"edge d={d_e} {algo.upper()} Box-Muller (odd d)", algo,
                     te, ve, C=1000, T=4, draw="bm")
    sf = get_target_distribution("SuperFunnel", 0, J=WIDER_SF["J"],
                                 K=WIDER_SF["K"], n_per_group=WIDER_SF["n"],
                                 device=dev)
    for algo in ("rwm", "pt"):
        lib = hold(f"SuperFunnel d={sf.dim} {algo.upper()}", algo, sf,
                   SF_VAR, T=8, draw=draws.resolve_normal_impl(
                       algo, 65536, "super_funnel"))[4]
        if _build.fixed_shape(lib) is not None or not (
                lib.endswith(".w2048") or lib.endswith(".c2048")):
            fail(f"phase 22a SuperFunnel d={sf.dim} routes to {lib}")
    del sf
    # chains-sharded on 1, 2 and 4 virtual shards of the card, bit for bit
    sh = WIDER_SHARD
    mvn2, v2 = target("mvn_iso", sh["d"])
    betas = torch.logspace(0, -2, h["T"], device=dev)
    for algo, fused, sharded, fields in (
            ("pt", run_pt_fused, run_pt_fused_sharded, PT_STATE),
            ("rwm", run_rwm_fused, run_rwm_fused_sharded, RWM_STATE)):
        pre = (betas,) if algo == "pt" else ()
        kw = dict(base_variance=v2, num_chains=sh["C"],
                  num_iterations=sh["iters"],
                  **({"swap_every": 10} if algo == "pt" else {}))
        ref = fused(mvn2, 7, *pre, device=dev, **kw)
        team = fused_sharded._layout(f"fused_{algo}", mvn2, None, sh["C"],
                                     h["T"] if algo == "pt" else 0,
                                     dev)[1]
        line = []
        for n in SHARD_COUNTS:
            reset_launches(*wrappers)
            ms, res = cuda_ms(torch, lambda: sharded(
                mvn2, 7, *pre, make_mesh((n,), ("chains",),
                                         devices=[dev] * n), **kw))
            seen = read_launches(*wrappers, by_kind=True)
            bad = differ(torch, res, ref, fields)
            if bad or sum(seen.values()) != n:
                fail(f"phase 22a chains-sharded {algo} d={sh['d']} on {n} "
                     f"shards: differs in {bad}; launches {dict(seen)}")
            line.append(f"{n} shards {ms:.3f} ms ({dict(seen)})")
        say(f"phase 22a chains-sharded {algo.upper()} d={sh['d']} "
            f"({sh['C']} chains, {sh['iters']} steps, G={team}): equal bit "
            f"for bit "
            f"({', '.join(fields)}) to the unsharded run; " + "; ".join(line))
        del ref, res
    say(f"phase 22a {time.time() - t_phase:.1f} s; least share of replicas "
        f"that agree over the kinds {worst:.5f} (>= {RUNGS_AGREE_MIN}; "
        f"{WIDER_AGREE} apart)")

    # ---- (b) Geweke at d = 2000: the iso MVN, RWM and PT on six rungs
    seed = int.from_bytes(os.urandom(4), "little")
    reset_launches(*wrappers)
    z_rwm, z_pt, sw = invariance(torch, mvn, seed, betas=WIDER_GEWEKE,
                                 rungs=WIDER_GEWEKE_RUNGS, base_variance=var)
    seen = read_launches(*wrappers, by_kind=True)
    say(f"phase 22b invariance MVN d={D2} (seed {seed}): max z RWM "
        f"{z_rwm:.2f}, PT {z_pt:.2f} (< {Z_INV_MAX}) at rungs "
        f"{WIDER_GEWEKE_RUNGS} of 1 .. {WIDER_GEWEKE[-1]:.2f} (6); PT swap "
        f"acc {sw:.3f}; launches "
        f"{dict(seen)}")
    if (max(z_rwm, z_pt) >= Z_INV_MAX or not swap_ok(sw, WIDER_GEWEKE)
            or not all(k.endswith(".w2048") for k in seen)):
        fail("phase 22b invariance failed")

    # ---- (c) the main shapes at full width through the entry points, one
    # call each, its launches counted (the main path); each library's
    # record held against its plain version at WIDER_RECORD_HOLD
    C, T, iters = WIDER_MAIN["C"], WIDER_MAIN["T"], WIDER_MAIN["iters"]
    betas = torch.logspace(0, -2, T, device=dev)
    records = []
    for d in WIDER_D:
        for algo, src, site in (
                ("pt", "fused_pt_warp.cu",
                 "rwm_pt_tpu/kernels/pallas_pt.py:399"),
                ("rwm", "fused_rwm_warp.cu",
                 "rwm_pt_tpu/kernels/pallas_rwm.py:570")):
            variant = _build.library(f"fused_{algo}", "Normal", rule[algo])
            launch, plain, names = (
                (fused_pt.launch_pt_kernel, fused_pt._run_pt_fused_plain,
                 agreement.PT_OUTPUTS) if algo == "pt" else
                (fused_rwm.launch_rwm_kernel, fused_rwm._run_rwm_fused_plain,
                 agreement.RWM_OUTPUTS))
            main = {}
            for kind in ("rosenbrock", "mvn_iso"):
                tg, v = target(kind, d)
                n_params = _build.kernel_target(tg)[1].numel()
                lib = _build.route(variant, tg)[0]
                geo = _build.launch_geometry(lib, d, C, T if algo == "pt"
                                             else 0, "Normal", rule[algo],
                                             n_params)
                name = _build.by_variant({_build.launch_key(
                    _build.cluster_lib(lib) if geo.cluster else lib): 1})
                name = next(iter(name))
                reset_launches(*wrappers)
                ms, res = cuda_ms(torch, lambda: (
                    run_pt_fused(tg, 0, betas, base_variance=v,
                                 num_chains=C, num_iterations=iters,
                                 swap_every=FLAG["swap_every"], device=dev)
                    if algo == "pt" else
                    run_rwm_fused(tg, 0, base_variance=v, num_chains=C,
                                  num_iterations=iters, device=dev)))
                seen = read_launches(*wrappers)
                acc = res.acceptance_rate.mean().item()
                if (dict(seen) != {name: 1}
                        or not torch.isfinite(res.state.x).all()
                        or not torch.isfinite(res.state.logp).all()
                        or not 0 < acc < 1):
                    fail(f"phase 22c {kind} d={d} {algo}: launches "
                         f"{dict(seen)} (want {name}), acc {acc}")
                del res
                torch.cuda.empty_cache()
                work = (pt_work(kind, d, T, C, iters, 0, FLAG["swap_every"],
                                draw=rule[algo], n_params=n_params)
                        if algo == "pt" else
                        rwm_work(kind, d, C, iters, draw=rule[algo],
                                 n_params=n_params))
                b_ms, _, b_lim = bound(*work)
                say(f"phase 22c {kind} d={d} {algo.upper()} at the main "
                    f"shape ({C} {'replicas x T=10' if algo == 'pt' else 'chains'}"
                    f", {iters} steps, through run_{algo}_fused): {name} "
                    f"(G={geo.team}, "
                    + (f"clusters of {geo.cluster} blocks of {geo.slots} "
                       f"slots" if geo.cluster else
                       f"{geo.replicas} a block")
                    + f", {geo.blocks_per_sm} blocks, "
                    f"{_build.resident_warps(geo)} warps an SM) {ms:.3f} ms "
                    f"against its {b_ms:.3f} ms bound by {b_lim} "
                    f"({100 * b_ms / ms:.1f} %); acceptance {acc:.4f}; "
                    f"launches {dict(seen)}")
                main[kind] = (ms, work, seen[name], acc, name, geo)
            rb_ms, rb_work, launches, acc, name, geo = main["rosenbrock"]
            rb, var_rb = target("rosenbrock", d)

            def rb_case(steps, hold_, algo=algo, rb=rb, var_rb=var_rb):
                _, _, _, args, kw, work = warp_case(
                    torch, gen, algo, rb, var_rb, steps,
                    WIDER_RECORD_HOLD["C"], T=T, draw=rule[algo], burn_in=0,
                    swap_every=10)
                return args, kw, work
            rec = kernel_record(torch, name, "rwm_pt_tpu_torch/kernels/csrc/"
                                + src, site, launches, launch, plain, names,
                                rb_case, iters, phase="22c",
                                hold_steps=WIDER_RECORD_HOLD["steps"],
                                main=(rb_ms, rb_work))
            if rec["agree_frac"] < RUNGS_AGREE_MIN:
                fail(f"phase 22c {name}: {rec['agree_frac']} agree")
            mvn_ms, mvn_work, _, mvn_acc, _, _ = main["mvn_iso"]
            mb_ms, _, mb_lim = bound(*mvn_work)
            rec.update(dim=d, team=geo.team, cluster=geo.cluster,
                       replicas_a_block=geo.replicas,
                       blocks_per_sm=geo.blocks_per_sm,
                       warps_per_sm=_build.resident_warps(geo),
                       acceptance=acc, hold_replicas=WIDER_RECORD_HOLD["C"],
                       mvn_iso_ms=mvn_ms, mvn_iso_bound_ms=mb_ms,
                       mvn_iso_bound_share=mb_ms / mvn_ms,
                       mvn_iso_acceptance=mvn_acc)
            records.append(rec)
            torch.cuda.empty_cache()
    # a three-row kind (IIDGamma, its 3 words staged) in the 2048 bucket:
    # its terms row in L2, PT in one block of ten rung-teams of 64 lanes at
    # T = 10 (with its terms row in shared memory it took the cluster
    # build), RWM in blocks of 14 chains (8 with it there) of one warp
    # (_build.SERIAL_LP_KINDS); held at 512 replicas (its plain version's
    # logs are the slow part)
    tg, v = target("iid_gamma", D2)
    n_params = _build.kernel_target(tg)[1].numel()
    for algo, src, site, launch, plain, outputs in (
            ("pt", "fused_pt_warp.cu", "rwm_pt_tpu/kernels/pallas_pt.py:399",
             fused_pt.launch_pt_kernel, fused_pt._run_pt_fused_plain,
             agreement.PT_OUTPUTS),
            ("rwm", "fused_rwm_warp.cu",
             "rwm_pt_tpu/kernels/pallas_rwm.py:570",
             fused_rwm.launch_rwm_kernel, fused_rwm._run_rwm_fused_plain,
             agreement.RWM_OUTPUTS)):
        variant = _build.library(f"fused_{algo}", "Normal", rule[algo])
        lib = _build.route(variant, tg)[0]
        geo = _build.launch_geometry(lib, D2, C, T if algo == "pt" else 0,
                                     "Normal", rule[algo], n_params)
        name = next(iter(_build.by_variant({_build.launch_key(
            _build.cluster_lib(lib) if geo.cluster else lib): 1})))
        reset_launches(*wrappers)
        ms, res = cuda_ms(torch, lambda: (
            run_pt_fused(tg, 0, betas, base_variance=v, num_chains=C,
                         num_iterations=iters, swap_every=FLAG["swap_every"],
                         device=dev) if algo == "pt" else
            run_rwm_fused(tg, 0, base_variance=v, num_chains=C,
                          num_iterations=iters, device=dev)))
        seen = read_launches(*wrappers)
        acc = res.acceptance_rate.mean().item()
        if (dict(seen) != {name: 1} or not torch.isfinite(res.state.x).all()
                or not 0 < acc < 1):
            fail(f"phase 22c iid_gamma d={D2} {algo}: launches "
                 f"{dict(seen)}, acc {acc}")
        del res
        work = (pt_work("iid_gamma", D2, T, C, iters, 0, FLAG["swap_every"],
                        draw=rule[algo], n_params=n_params)
                if algo == "pt" else
                rwm_work("iid_gamma", D2, C, iters, draw=rule[algo],
                         n_params=n_params))

        def gamma_case(steps, hold_, algo=algo):
            _, _, _, args, kw, w = warp_case(
                torch, gen, algo, tg, v, steps, 512, T=T, draw=rule[algo],
                burn_in=0, swap_every=10)
            return args, kw, w
        rec = kernel_record(torch, name, "rwm_pt_tpu_torch/kernels/csrc/"
                            + src, site, seen[name], launch, plain, outputs,
                            gamma_case, iters, phase="22c",
                            hold_steps=WIDER_RECORD_HOLD["steps"],
                            main=(ms, work))
        if (rec["agree_frac"] < RUNGS_AGREE_MIN or geo.cluster
                or geo.team != (64 if algo == "pt" else 32)):
            fail(f"phase 22c {name}: {rec['agree_frac']} agree, {geo}")
        rec["name"] = f"{name} (IIDGamma)"
        rec.update(dim=D2, kind="iid_gamma", team=geo.team,
                   cluster=geo.cluster, replicas_a_block=geo.replicas,
                   hold_replicas=512, blocks_per_sm=geo.blocks_per_sm,
                   warps_per_sm=_build.resident_warps(geo), acceptance=acc)
        say(f"phase 22c iid_gamma d={D2} {algo.upper()} at the main shape: "
            f"{name} (G={geo.team}, one block of {geo.replicas} "
            f"{'replicas' if algo == 'pt' else 'chains'}, "
            f"{_build.resident_warps(geo)} warps an SM) {ms:.3f} ms "
            f"against its {rec['main_path_bound_ms']:.3f} ms bound by "
            f"{rec['main_path_bound_limit']} "
            f"({100 * rec['main_path_bound_share']:.1f} %); acceptance "
            f"{acc:.4f}; launches {dict(seen)}")
        records.append(rec)
    del tg
    torch.cuda.empty_cache()
    say(f"phase 22c {time.time() - t_phase:.1f} s")

    # ---- (d) the entry points at d = 2000 (and the harness's PT at 4000)
    for algo in ("RWM", "PT"):
        harness_entry(torch, "22d", ".w2048", algo, D2, 200, sigma=var,
                      target_dist=mvn)
    mvn4, var4 = target("mvn_iso", D4)
    harness_entry(torch, "22d", ".c4096", "PT", D4, 100, sigma=var4,
                  target_dist=mvn4)
    study_entry(torch, "22d", ".w2048", D2, WIDER_STUDY_CONFIGS, 1024,
                os.path.join(HERE, "smoke_out", "wider", "study"))
    launch_l = ladder_build.launch_ladder_kernel
    reset_launches(launch_l, *wrappers)
    sim = MCMCSimulation(
        dim=D2, sigma=var, num_iterations=WIDER_HARNESS["iters"],
        algorithm="PT", target_dist=mvn, num_chains=WIDER_HARNESS["C"],
        seed=1, iterative_temp_spacing=True, record_chain=False,
        device=dev)
    sim.generate_samples(verbose=False)
    torch.cuda.synchronize()
    seen_l, seen = dict(launch_l.launches), read_launches(*wrappers)
    n_rungs = len(sim.beta_ladder)
    if (seen_l != {f"{_build.LADDER}.mvn_iso": 1}
            or sim.engine_used != "pallas"
            or abs(sim.beta_ladder[-1] - 0.01) > 1e-6
            or sum(seen.values()) != 1
            or not all(k[-6:] in (".w2048", ".c2048") for k in seen)):
        fail(f"phase 22d ladder main path d={D2}: ladder {seen_l}, fused "
             f"{dict(seen)}, engine {sim.engine_used}, {n_rungs} rungs")
    say(f"phase 22d MCMCSimulation(iterative_temp_spacing=True) MVN d={D2} "
        f"down to beta_min 0.01: {n_rungs} rungs (the fit takes "
        f"{_build.target_max_rungs(mvn)}), {WIDER_HARNESS['C']} replicas x "
        f"{WIDER_HARNESS['iters']} iterations, swap acc "
        f"{sim.acceptance_rate():.4f}; launches {seen_l}, fused {dict(seen)}")
    harness_launches = seen_l[f"{_build.LADDER}.mvn_iso"]
    del sim
    torch.cuda.empty_cache()

    # ---- (e) the ladder kernel: the full MVN's warp form at d = 500 (PR
    # 15's case: 6,583.497 ms, 143.1 ms a probe) and 2000, the iso MVN at
    # d = 2000 and 4000; each one build through
    # construct_iterative_ladder_device (its launch counted: the main path;
    # the iso MVN at d = 2000's is the harness's in (d)), then held
    held = dict(WIDER_LADDER, max_T=L.EAGER_MAX_RUNGS + 1)
    for kind, d in (("mvn_full", 500), ("mvn_full", D2), ("mvn_iso", D2),
                    ("mvn_iso", D4)):
        tg = ladder_target(get_target_distribution, kind, d, dev)
        launches = harness_launches
        if (kind, d) != ("mvn_iso", D2):
            reset_launches(launch_l)
            construct_iterative_ladder_device(tg, **held)
            launches = launch_l.launches[f"{_build.LADDER}.{kind}"]
        got = ladder_hold(torch, "22e", tg, kind, f"ladder {kind} d={d}",
                          held, reps=1)
        rec = ladder_record(_build.ladder_lib(kind, d), launches, tg, kind,
                            got)
        if rec["local_bytes"]:
            fail(f"phase 22e {rec['name']}: {rec['local_bytes']} B of local "
                 f"memory")
        say(f"phase 22e {rec['name']}: {got['us_a_probe']:.1f} us a probe "
            f"({got['probes']} probes, N={held['N_samples_swap_est']}), "
            f"{rec['registers']} registers, {rec['local_bytes']} B local, "
            f"{rec['warps_per_sm']} warps an SM"
            + (f"; the earlier one-lane form took 6,583.497 ms (143.1 ms "
               f"a probe) for this build" if (kind, d) == ("mvn_full", 500)
               else ""))
        records.append(rec)
        del tg
        torch.cuda.empty_cache()
    # above the last bucket: no launch, NotImplementedError naming it
    big, vb = target("mvn_iso", WIDER_EDGES[-1] + 1)
    for fn in (lambda: run_pt_fused(big, 0, betas, base_variance=vb,
                                    num_chains=4, num_iterations=2,
                                    device=dev),
               lambda: run_rwm_fused(big, 0, base_variance=vb, num_chains=4,
                                     num_iterations=2, device=dev),
               lambda: ladder_build.launch_ladder_kernel(big)):
        reset_launches(launch_l, *wrappers)
        try:
            fn()
        except NotImplementedError as e:
            if "Queue A item 15" not in str(e) or read_launches(
                    launch_l, *wrappers):
                fail(f"phase 22e d={big.dim}: {e}")
        else:
            fail(f"phase 22e d={big.dim} ran")
    say(f"phase 22e d={big.dim} raises NotImplementedError naming ROADMAP "
        f"Queue A item 15 (run_pt_fused, run_rwm_fused, the ladder kernel)")

    wide_teams_22g(torch, gen, target)

    # ---- (f) the RWM acceptance on the iso MVN at sigma^2 = 2.38^2 / d
    # from exact draws, beside the d -> infinity limit
    line, rates = [], []
    for d in WIDER_D:
        tg, v = target("mvn_iso", d)
        g = torch.Generator(device=dev).manual_seed(22)
        stat = run_rwm_fused(tg, 22, base_variance=v, num_chains=4096,
                             num_iterations=2000, device=dev,
                             init_states=tg.direct_sample(4096, 1.0, g).T)
        a = stat.acceptance_rate
        rates.append(a.mean().item())
        line.append(f"d={d} {rates[-1]:.4f} (+- "
                    f"{a.std().item() / math.sqrt(a.numel()):.4f})")
    limit = math.erfc(2.38 / 2 / math.sqrt(2))
    say(f"phase 22f RWM acceptance on the iso MVN at sigma^2 = 2.38^2/d from "
        f"exact draws (4096 chains, 2000 steps, the team the geometry "
        f"takes): {'; '.join(line)}; the d -> infinity limit 2 Phi(-2.38/2) "
        f"= {limit:.4f} (within {WIDER_RATE_TOL})")
    if max(abs(r - limit) for r in rates) > WIDER_RATE_TOL:
        fail(f"phase 22f RWM acceptance {rates} is not {limit:.4f}")
    say(f"phase 22 {time.time() - t_phase:.1f} s")
    return records


def occupancy(torch, _build, name, d=None, T=10, n_params=0):
    """Phase 2's line for library ``name``: the launch geometry of a launch
    at d coordinates (default: the bucket's largest d) and T = 10 rungs
    (PT), with the blocks and warps per SM that
    cudaOccupancyMaxActiveBlocksPerMultiprocessor gives beside the count of
    ``_build.pt_block_geometry`` / ``rwm_block_geometry`` (a warp
    library: the team size G the geometry picks for 65,536 replicas)."""
    src, pc, dc, _, dmax, blocks = _build._parts(name)
    prop = next(p for p, (_, c) in _build.PROPOSALS.items() if c == pc)
    draw = next(k for k, (_, c) in _build.DRAWS.items() if c == dc)
    sf = _build.fixed_shape(name)
    d = d or (sf["dim"] if sf else dmax - 4 if _build.is_warp(name)
              else dmax)
    if sf and _build.is_warp(name):   # its padded dataset in shared memory
        n_params = _build.sf_team_words(sf["J"], sf["K"], sf["n"])
    pt = src.startswith("fused_pt")
    if pt and _build.is_cluster(name):   # at most the rungs the fit takes
        T = min(T, _build.max_rungs(d, name.split(".")[1], prop, n_params))
    geo = _build.launch_geometry(name, d, 65536, T if pt else 0, prop, draw,
                                 n_params)
    info = _build.kernel_info(
        _build.cluster_lib(name) if geo.cluster else name, d,
        T if pt else 1, geo.replicas, n_params, runtime_r=geo.runtime_r,
        team=geo.team, cluster=geo.cluster)
    warps = -(-geo.threads // 32)
    team = f" G={geo.team}," if _build.is_warp(name) else ""
    if geo.cluster:
        team += (f" {geo.cluster} blocks a cluster of {geo.slots} slots, "
                 f"{info['clusters']} clusters the card holds,")
    return (f"min blocks {blocks}; {info['registers']} regs, "
            f"{info['local_bytes']} B local at d={d}"
            + (f", T={T}:{team} R={geo.replicas}" if pt else
               f":{team} {geo.replicas} chains a block")
            + f", {info['shared_bytes']} B shared (calculated "
            f"{geo.shared_bytes}); {info['blocks_per_sm']} blocks, "
            f"{info['blocks_per_sm'] * warps} warps per SM (calculated "
            f"{geo.blocks_per_sm} blocks)")


def report_build(torch, _build, ptxas_report, logs):
    """Phase 2's lines for the built libraries ``logs`` ({name: ptxas
    report}): registers, stack frame and spills per instantiation, and the
    launch geometry and occupancy (a ladder library: its registers, local
    bytes and cooperative grid); a stack frame, a spill or a ladder
    library's local memory fails the smoke."""
    from rwm_pt_tpu_torch.kernels import ladder_build
    frames = []
    for kname, log in logs.items():
        entries = sorted(ptxas_report.parse(log))
        line = "; ".join(f"{n} {r} regs, {f} B stack, {sp} B spill"
                         for n, r, f, sp in entries)
        if kname.startswith(_build.LADDER + "."):
            # a ladder library's loops are unrolled up to the 64 bucket,
            # rolled above it; the gate holds every bucket (stack frame,
            # spill, local memory)
            kind, tag, *stamps = kname.split(".")[1:]
            if stamps:
                # phase 18c's measuring build: no entry point launches it,
                # and its stamps cost registers (no gate)
                say(f"phase 2 build {kname} (measuring build): {line}")
                continue
            dmax = int(tag[1:])
            frames += [f"{kname} {n}" for n, _, f, sp in entries if f or sp]
            info = ladder_build.info(   # a d of this library's bucket
                kind, dmax if dmax <= _build.BUCKETS[-1] else dmax - 4)
            if info["local_bytes"]:
                frames.append(f"{kname}: {info['local_bytes']} B local")
            say(f"phase 2 build {kname}: {line}; {info['registers']} regs, "
                f"{info['local_bytes']} B local; {info['blocks_per_sm']} "
                f"blocks of {info['max_threads']} threads an SM at "
                f"{info['shared_bytes']} B of dynamic shared memory, "
                f"{info['sms']} SMs (a cooperative grid of "
                f"{info['blocks_per_sm'] * info['sms']})")
            continue
        frames += [f"{kname} {n}" for n, _, f, sp in entries if f or sp]
        if kname != _build.PROBES:
            line += "; " + occupancy(   # SuperFunnel: its ladder's T = 8
                torch, _build, kname,
                T=8 if ".super_funnel." in kname else
                50 if _build.is_cluster(kname) else 10)
        say(f"phase 2 build {kname}: {line}")
    if frames:
        fail(f"a kernel has a stack frame or spills: {frames}")


def smoke_libraries(_build):
    """Every library the smoke launches: (variant, target kind, bucket)."""
    lib = _build.lib_name
    base = ("fused_pt", "fused_rwm", "fused_pt_laplace", "fused_rwm_laplace",
            "fused_pt_uniform_radius", "fused_rwm_uniform_radius")
    bm = ("fused_pt_bm", "fused_rwm_bm", "fused_pt_uniform_radius_bm",
          "fused_rwm_uniform_radius_bm")
    names = [lib(v, "rosenbrock", 30) for v in base + bm]      # 6, 7, 9, 12
    names += [lib(v, "mvn_iso", 10) for v in base + bm]        # 3-5, 8, 12
    names += [lib(v, "rough_carpet", STUDY["dim"])             # 7, 10, 12
              for v in ["fused_rwm_laplace"] + [_build.library(
                  "fused_rwm", "UniformRadius", dr) for dr in EXACT_DRAWS]]
    from rwm_pt_tpu_torch.kernels.draws import resolve_normal_impl
    for k in KINDS:                                              # 11
        for algo, n in (("pt", FLAG["C"]), ("rwm", RWM_MAIN["C"])):
            v = _build.library(f"fused_{algo}", "Normal",
                               resolve_normal_impl(algo, n, k))
            names += [lib(v, k, 10), lib(v, k, 30)]
    names += [lib(_build.library("fused_pt", "Normal", dr), k, dim)  # 12, 13
              for dr in EXACT_DRAWS for k, dim in (
                  ("three_mixture", PT_STUDY["dim"]),
                  ("mvn_full", FLAG["dim"]))]
    names += [lib(_build.library(f"fused_{a}", p, impl), "rosenbrock", 30)
              for a in ("pt", "rwm") for p in ("Normal", "UniformRadius")
              for impl in STUDY_DRAWS]                           # 14
    names += [lib(_build.library(f"fused_{a}", p, impl), "mvn_iso", 10)
              for a in ("pt", "rwm") for p in ("Normal", "UniformRadius")
              for impl in ("icdf_fastlog", "lax_erfinv")]        # 14
    names.append(_build.PROBES)                                  # 14
    names += [lib(_build.library("fused_pt", "Normal", resolve_normal_impl(
        "pt", FLAG["C"], "mvn_iso")), "mvn_iso", 5),             # 15
              lib(_build.library("fused_rwm", "Normal", resolve_normal_impl(
                  "rwm", 1024, "mvn_iso")), "mvn_iso", 5)]
    for a in ("pt", "rwm"):                                      # 16
        rule = resolve_normal_impl(a, 65536)
        v = _build.library(f"fused_{a}", "Normal", rule)
        names += [lib(v, k, d) for k in _build.TARGET_KINDS
                  for d in (WARP_D, WARP_D_256)]
        names += [lib(_build.library(f"fused_{a}", "UniformRadius", rule),
                      "mvn_full", d) for d in (WARP_D, WARP_D_256)]
        names += [lib(_build.library(f"fused_{a}", p, rule), "mvn_iso",
                      WARP_D) for p in NEW_PROPOSALS]
        names += [lib(_build.library(f"fused_{a}", "Normal", dr), "mvn_iso",
                      WARP_D) for dr in _build.DRAWS]
        names += [lib(v, "mvn_iso", d) for d in WARP_EDGES]
        names.append(lib(v, "rosenbrock", FLAG["dim"], warp=True))
    names.append(lib(_build.library("fused_rwm", "UniformRadius",
                                    resolve_normal_impl("rwm", STUDY["C"])),
                     "rough_carpet", STUDY["dim"], warp=True))
    from rwm_pt_tpu_torch.targets import get_target_distribution
    sf = {(J, K, n): get_target_distribution(
        "SuperFunnel", 0, J=J, K=K, n_per_group=n, device="cpu")
        for J, K, n in ((SF["J"], SF["K"], SF["n"]),
                        (SF["J"], SF["K"], SF_RUN_TIME_N))
        + tuple((J, K, SF["n"]) for J, K in SF_WARP + SF_THREAD_EDGES)
        + SF_TEAM_RUN_TIME}
    for a in ("pt", "rwm"):                                      # 17
        rule = resolve_normal_impl(a, 65536, "super_funnel")
        names += [_build.route(_build.library(f"fused_{a}", p, rule),
                               sf[J, K, SF["n"]])[0]
                  for p in _build.PROPOSALS
                  for J, K in ((SF["J"], SF["K"]),) + SF_WARP]
        names += [_build.route(_build.library(f"fused_{a}", p, rule),
                               sf[J, K, SF["n"]], specialize=False)[0]
                  for p in _build.PROPOSALS for J, K in SF_WARP]
        v = _build.library(f"fused_{a}", "Normal", rule)
        names += [_build.route(v, sf[J, K, SF["n"]])[0]
                  for J, K in SF_THREAD_EDGES]
        names.append(_build.route(v, sf[SF["J"], SF["K"], SF_RUN_TIME_N])[0])
        names += [_build.route(v, sf[shape])[0] for shape in SF_TEAM_RUN_TIME]
    names += [_build.ladder_lib(k, LADDER_D) for k in LADDER_KINDS]  # 18
    names += [_build.ladder_lib("three_mixture", LADDER_D, stamps=True)]
    names += [_build.ladder_lib("mvn_iso", d) for d in (LADDER_WIDE_D, 5)]
    names.append(lib(_build.library("fused_pt", "Normal", resolve_normal_impl(
        "pt", 8, "three_mixture")), "three_mixture", 2))       # 18d's demo
    sf_wide = get_target_distribution(
        "SuperFunnel", 0, J=WIDE_SF["J"], K=WIDE_SF["K"],
        n_per_group=WIDE_SF["n"], device="cpu")
    for a in ("pt", "rwm"):                                      # 20
        rule = resolve_normal_impl(a, 65536)
        v = _build.library(f"fused_{a}", "Normal", rule)
        for d in WIDE_D:
            names += [lib(v, k, d) for k in (
                _build.TARGET_KINDS if d == WIDE_D[0] else WIDE_KINDS_1000)]
            names.append(lib(_build.library(f"fused_{a}", "UniformRadius",
                                            rule), "mvn_full", d))
            names += [lib(_build.library(f"fused_{a}", p, rule), "mvn_iso",
                          d) for p in NEW_PROPOSALS]
        names += [lib(_build.library(f"fused_{a}", "Normal", dr), "mvn_iso",
                      d) for dr in _build.DRAWS for d in WIDE_D[:1]]
        names += [lib(_build.library(f"fused_{a}", "Normal", "bm"),
                      "mvn_iso", d) for d in WIDE_EDGES if d % 2]
        names.append(_build.route(_build.library(
            f"fused_{a}", "Normal", resolve_normal_impl(a, 65536,
                                                        "super_funnel")),
            sf_wide)[0])
    names += [_build.ladder_lib(k, WIDE_D[0]) for k in LADDER_KINDS]
    names.append(_build.ladder_lib("mvn_iso", WIDE_D[1]))
    rule = resolve_normal_impl("pt", 65536, "mvn_iso")            # 21
    names += [_build.cluster_lib(lib(_build.library("fused_pt", p, rule),
                                     "mvn_iso", d))
              for d in WIDE_D for p in (
                  _build.PROPOSALS if d == WIDE_D[0] else ("Normal",))]
    names += [_build.cluster_lib(lib(_build.library("fused_pt", "Normal",
                                                    rule), "mvn_iso", d))
              for d, _ in RUNGS_SMALL]
    names.append(_build.cluster_lib(lib(_build.library(   # 21d's split
        "fused_pt", "Normal", rule), "mvn_iso", RUNGS_SPLIT["d"]),
        stamps=True))
    sf_wider = get_target_distribution(
        "SuperFunnel", 0, J=WIDER_SF["J"], K=WIDER_SF["K"],
        n_per_group=WIDER_SF["n"], device="cpu")
    D2, D4 = WIDER_D
    for a in ("pt", "rwm"):                                      # 22
        rule = resolve_normal_impl(a, 65536)
        v = _build.library(f"fused_{a}", "Normal", rule)
        team = [lib(v, k, D2) for k in _build.TARGET_KINDS
                if k != "super_funnel"]
        team += [lib(v, k, d) for k in WIDER_KINDS_4092
                 for d in (WIDER_EDGES[-1], D4)]
        team += [lib(_build.library(f"fused_{a}", p, rule), "mvn_iso", D2)
                 for p in NEW_PROPOSALS]
        team += [lib(_build.library(f"fused_{a}", "Normal", dr), "mvn_iso",
                     D2) for dr in _build.DRAWS]
        team += [lib(v, "mvn_iso", d) for d in WIDER_EDGES]
        team += [lib(_build.library(f"fused_{a}", "Normal", "bm"), "mvn_iso",
                     d) for d in WIDER_EDGES if d % 2]
        team.append(_build.route(_build.library(
            f"fused_{a}", "Normal", resolve_normal_impl(a, 65536,
                                                        "super_funnel")),
            sf_wider)[0])
        names += team
        if a == "pt":   # the cluster builds the geometry takes
            names += [_build.cluster_lib(lib(v, k, D2)) for k in (
                "mvn_iso", "mvn_full", "iid_gamma", "iid_beta")]
            names += [_build.cluster_lib(lib(v, k, D4))
                      for k in WIDER_KINDS_4092]
            names.append(_build.cluster_lib(lib(_build.library(
                "fused_pt", "Laplace", rule), "mvn_iso", D2)))
        # 22g: every team size of the held kinds and proposals (PT's over a
        # cluster at d = 4000)
        for d, k, props in WIDE_TEAMS_HELD:
            for p in props:
                w = lib(_build.library(f"fused_{a}", p, rule), k, d)
                names += [w] + ([_build.cluster_lib(w)]
                                if a == "pt" and d == D4 else [])
    names += [_build.ladder_lib(k, d) for k, d in (
        ("mvn_full", D2), ("mvn_iso", D2), ("mvn_iso", D4))]
    return list(dict.fromkeys(names))


def main():
    import torch
    if not torch.cuda.is_available():
        fail("torch.cuda.is_available() is False: chip_smoke needs a CUDA card")
    sys.path.insert(0, HERE)
    try:
        from rwm_pt_tpu_torch.api import MCMCSimulation  # noqa: F401
        from rwm_pt_tpu_torch.kernels import (_build, agreement, draws,
                                              fused_pt, fused_rwm,
                                              ptxas_report, run_pt,
                                              run_pt_fused, run_rwm,
                                              run_rwm_fused)
        from rwm_pt_tpu_torch.kernels.draws import seed_key
        from rwm_pt_tpu_torch.proposals import NormalProposal
        from rwm_pt_tpu_torch.targets import FullRosenbrock, MultivariateNormal
    except ImportError as e:
        fail(f"the port is not importable next to chip_smoke.py: {e}")
    bad = [m for m in sys.modules if m.split(".")[0] in ("jax", "rwm_pt_tpu")]
    if bad:
        fail(f"JAX modules loaded: {bad[:5]}")
    t_start = time.time()
    dev = torch.device("cuda")

    # ---- 1. device
    name = torch.cuda.get_device_name(0)
    count = torch.cuda.device_count()
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        timeout=60).stdout.strip().splitlines()
    card = smi[0] if smi else "nvidia-smi unavailable"
    say(f"phase 1 device: {name} x{count}; torch {torch.__version__} cuda "
        f"{torch.version.cuda}; nvidia-smi name, power.limit:")
    print(card, flush=True)

    # ---- 2. build: the thread-per-state, ladder and probe libraries first,
    # all at once; the warp libraries (d > 64, phases 16-22) in the
    # background of phases 3-15, BACKGROUND_NVCC at a time (the host's
    # other cores run those phases), reported and gated before phase 16,
    # but the 2048 and 4096 buckets' (phase 22's, the most team sizes),
    # which build last, behind phases 16-21, and are gated before phase 22
    t_build = time.time()
    names = smoke_libraries(_build)
    # the warp libraries, those of the most team sizes first (the longest
    # builds start first, so that the last to finish is short)
    late = sorted((n for n in names if _build.is_warp(n)),
                  key=lambda n: -len(_build.library_teams(n)))
    widest = [n for n in late if _build._parts(n)[4] > 1024]
    late = [n for n in late if n not in widest]
    logs = _build.build([n for n in names if not _build.is_warp(n)])
    build_s = time.time() - t_build
    background = {"logs": {}, "widest": {}}
    late_built = threading.Event()

    def build_late():
        from concurrent.futures import ThreadPoolExecutor
        try:   # one library a worker, BACKGROUND_NVCC in flight, in order
            with ThreadPoolExecutor(BACKGROUND_NVCC) as pool:
                jobs = {n: pool.submit(_build.build, [n])
                        for n in late + widest}
                for n in late:
                    background["logs"].update(jobs[n].result())
                background["s"] = time.time() - t_build
                late_built.set()
                for n in widest:
                    background["widest"].update(jobs[n].result())
        except Exception as e:   # reported at the joins, before phase 16
            background["error"] = e   # or 22
        late_built.set()
        background["widest_s"] = time.time() - t_build
    warp_build = threading.Thread(target=build_late)
    warp_build.start()
    report_build(torch, _build, ptxas_report, logs)
    say(f"phase 2 build: {len(logs)} libraries (one per kernel variant, "
        f"target kind and register bucket) in {build_s:.1f} s; "
        f"{len(late)} warp libraries building in the background of phases "
        f"3-15, then the {len(widest)} of the 2048 and 4096 buckets behind "
        f"phases 16-21")
    flag_lib = _build.lib_name(_build.library(
        "fused_pt", "Normal", draws.resolve_normal_impl(
            "pt", FLAG["C"], "rosenbrock")), "rosenbrock", FLAG["dim"])
    say(f"phase 2 flagship {flag_lib} at its shape (d={FLAG['dim']}, "
        f"T={FLAG['T']}, {FLAG['C']} replicas): " + occupancy(
            torch, _build, flag_lib, FLAG["dim"], FLAG["T"],
            n_params=FLAG["dim"] + 1))

    zi = lambda *s: torch.zeros(*s, dtype=torch.int32, device=dev)  # noqa
    zf = lambda *s: torch.zeros(*s, dtype=torch.float32, device=dev)  # noqa
    gen = torch.Generator(device=dev)
    gen.manual_seed(1234)

    # ---- 3. kernel vs plain on one stream
    d, T, C = 30, 10, 2048
    rb = FullRosenbrock.create(d, device=dev)
    betas = torch.logspace(0, -2, T, device=dev)
    sig = torch.sqrt(torch.tensor(FLAG["base_variance"], device=dev) / betas)
    x0 = (0.5 * torch.randn(d, 1, C, generator=gen, device=dev)).expand(
        d, T, C).contiguous()
    args = (rb, x0, zi(T, C), zi(C), zf(C), zf(C), betas, sig, seed_key(11),
            0, 200, 50, 10)
    k = fused_pt.launch_pt_kernel(*args)
    p = fused_pt._run_pt_fused_plain(*args)
    torch.cuda.synchronize()
    ag = agreement.hold(k, p, agreement.PT_OUTPUTS,
                        lp_of=rb.log_density_td)
    n_mh, n_sw = 150 * T * C, 15 * (T - 1) * C
    z_mh = rate_z(k[2].sum().item() / n_mh, p[2].sum().item() / n_mh, n_mh)
    z_sw = rate_z(k[3].sum().item() / n_sw, p[3].sum().item() / n_sw, n_sw)
    say(f"phase 3 PT kernel vs plain: {agreement.describe(ag)}; MH acc "
        f"{k[2].sum().item() / n_mh:.5f} vs {p[2].sum().item() / n_mh:.5f} "
        f"(z {z_mh:.2f}); swap acc {k[3].sum().item() / n_sw:.5f} vs "
        f"{p[3].sum().item() / n_sw:.5f} (z {z_sw:.2f})")
    if ag.frac < AGREE_MIN or ag.mismatched or max(z_mh, z_sw) >= Z_RATE_MAX:
        fail("PT kernel disagrees with its plain version")
    d2 = 10
    mvn = MultivariateNormal.create(d2, device=dev)
    x0 = torch.randn(d2, C, generator=gen, device=dev)
    args = (mvn, x0, zi(C), zf(C), torch.tensor(1.0, device=dev),
            torch.sqrt(torch.tensor(2.38 ** 2 / d2, device=dev)),
            seed_key(12), 0, 200, 20)
    k = fused_rwm.launch_rwm_kernel(*args)
    p = fused_rwm._run_rwm_fused_plain(*args)
    torch.cuda.synchronize()
    ag = agreement.hold(k, p, agreement.RWM_OUTPUTS,
                        lp_of=mvn.log_density_td)
    n_r = 180 * C
    z_r = rate_z(k[2].sum().item() / n_r, p[2].sum().item() / n_r, n_r)
    say(f"phase 3 RWM kernel vs plain: {agreement.describe(ag)}; acc "
        f"{k[2].sum().item() / n_r:.5f} vs {p[2].sum().item() / n_r:.5f} "
        f"(z {z_r:.2f})")
    if ag.frac < AGREE_MIN or ag.mismatched or z_r >= Z_RATE_MAX:
        fail("RWM kernel disagrees with its plain version")

    # ---- 4. fused PT vs the eager engine (sequential sweep)
    bv = 2.38 ** 2 / d2
    betas6 = torch.logspace(0, -2, 6, device=dev)
    kw = dict(num_chains=1024, num_iterations=2000, burn_in=200,
              swap_every=20, device=dev)
    fz = run_pt_fused(mvn, 21, betas6, base_variance=bv, **kw)
    ez = run_pt(mvn, NormalProposal.create(d2, bv, device=dev), 22, betas6,
                swap_sweep="sequential", **kw)
    d_swap = abs(fz.swap_acceptance_rate.mean().item()
                 - ez.swap_acceptance_rate.mean().item())
    d_rung = (fz.acceptance_rate.mean(1) - ez.acceptance_rate.mean(1)).abs() \
        .max().item()
    say(f"phase 4 fused PT vs eager: swap acc "
        f"{fz.swap_acceptance_rate.mean().item():.4f} vs "
        f"{ez.swap_acceptance_rate.mean().item():.4f} (|d| {d_swap:.4f} < "
        f"0.05), max per-rung MH |d| {d_rung:.4f} (< 0.03)")
    if d_swap >= 0.05 or d_rung >= 0.03:
        fail("fused PT and the eager engine disagree")

    # ---- 5. exact invariance, fresh seed
    seed = int.from_bytes(os.urandom(4), "little")
    z_rwm, z_pt, sw = invariance(torch, mvn, seed, base_variance=bv)
    say(f"phase 5 invariance (seed {seed}): max z RWM {z_rwm:.2f}, PT "
        f"{z_pt:.2f} over 6 rungs (< {Z_INV_MAX}); PT swap acc {sw:.3f}")
    if max(z_rwm, z_pt) >= Z_INV_MAX or sw <= 0.02:
        fail("invariance check failed")

    # ---- 6. main paths through the entry points, then kernel vs plain
    kernels = []
    d, T, C = FLAG["dim"], FLAG["T"], FLAG["C"]
    rb = FullRosenbrock.create(d, device=dev)
    betas = torch.logspace(0, -2, T, device=dev)
    wrappers = (fused_pt.launch_pt_kernel, fused_rwm.launch_rwm_kernel)
    reset_launches(*wrappers)
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    res = run_pt_fused(rb, 0, betas, base_variance=FLAG["base_variance"],
                       num_chains=C, num_iterations=FLAG["iters"],
                       swap_every=FLAG["swap_every"], device=dev)
    torch.cuda.synchronize()
    first_s = time.perf_counter() - t0
    seen = read_launches(*wrappers)
    pt_draw = draws.resolve_normal_impl("pt", C, "rosenbrock")
    pt_main = _build.library("fused_pt", "Normal", pt_draw)
    pt_launches = seen[pt_main]
    if pt_launches < 1 or set(seen) != {pt_main}:
        fail(f"flagship path launches: {dict(seen)}")
    st = res.state
    if (tuple(st.x.shape) != (d, T, C) or not torch.isfinite(st.x).all()
            or not torch.isfinite(st.logp).all()):
        fail("flagship state is not finite or has the wrong shape")
    swap_acc = res.swap_acceptance_rate.mean().item()
    cold = res.cold_esjd.mean().item()
    rung_acc = res.acceptance_rate.mean(1).tolist()
    if not (0.05 < swap_acc < 0.95 and cold > 0 and 0 < rung_acc[0] < 1):
        fail(f"flagship metrics out of range: swap {swap_acc}, cold {cold}")
    e2e_ms = [cuda_ms(torch, lambda: run_pt_fused(
        rb, rep, betas, base_variance=FLAG["base_variance"], num_chains=C,
        num_iterations=FLAG["iters"], swap_every=FLAG["swap_every"],
        device=dev))[0] for rep in (1, 2, 3)]
    mh_steps = FLAG["iters"] * T * C
    say(f"phase 6 flagship PT: {mh_steps / (min(e2e_ms) / 1e3):.6g} MH "
        f"steps/s (best of 3: {[round(t, 3) for t in e2e_ms]} ms; first call "
        f"{first_s:.3f} s incl. build load); swap acc {swap_acc:.4f}, cold "
        f"ESJD {cold:.5g}, per-rung MH acc "
        f"{[round(a, 4) for a in rung_acc]}; launches {dict(seen)}; card "
        f"{card}")

    def pt_args(steps):
        x0 = (1e-8 * torch.randn(d, 1, C, generator=gen, device=dev)).expand(
            d, T, C).contiguous()
        sig = torch.sqrt(torch.tensor(FLAG["base_variance"], device=dev)
                         / betas)
        return (rb, x0, zi(T, C), zi(C), zf(C), zf(C), betas, sig,
                seed_key(0), 0, steps, 0, FLAG["swap_every"])

    kernels.append(kernel_record(
        torch, pt_main, "rwm_pt_tpu_torch/kernels/csrc/fused_pt.cu",
        "rwm_pt_tpu/kernels/pallas_pt.py:399", pt_launches,
        fused_pt.launch_pt_kernel, fused_pt._run_pt_fused_plain,
        agreement.PT_OUTPUTS,
        lambda steps, hold: (pt_args(steps), dict(draw=pt_draw), pt_work(
            "rosenbrock", d, T, C, steps, 0, FLAG["swap_every"],
            draw=pt_draw)),
        FLAG["iters"]))
    del res, st

    # RWM main path: the headline RWM workload
    Cr = RWM_MAIN["C"]
    rwm_kw = dict(base_variance=RWM_MAIN["base_variance"], num_chains=Cr,
                  num_iterations=RWM_MAIN["iters"], device=dev)
    reset_launches(*wrappers)
    rr = run_rwm_fused(rb, 0, **rwm_kw)
    torch.cuda.synchronize()
    seen = read_launches(*wrappers)
    rwm_draw = draws.resolve_normal_impl("rwm", Cr, "rosenbrock")
    rwm_main = _build.library("fused_rwm", "Normal", rwm_draw)
    rwm_launches = seen[rwm_main]
    if rwm_launches < 1 or set(seen) != {rwm_main}:
        fail(f"RWM path launches: {dict(seen)}")
    if not torch.isfinite(rr.state.x).all():
        fail("RWM main-path state is not finite")
    acc_r = rr.acceptance_rate.mean().item()
    esjd_r = rr.esjd.mean().item()
    if not (0 < acc_r < 1 and esjd_r > 0):
        fail(f"RWM metrics out of range: acc {acc_r}, esjd {esjd_r}")
    e2e_r = [cuda_ms(torch, lambda: run_rwm_fused(rb, rep, **rwm_kw))[0]
             for rep in (1, 2, 3)]
    say(f"phase 6 RWM path: {RWM_MAIN['iters'] * Cr / (min(e2e_r) / 1e3):.6g}"
        f" MH steps/s (best of 3: {[round(t, 3) for t in e2e_r]} ms); acc "
        f"{acc_r:.4f}, ESJD {esjd_r:.5g}; launches {dict(seen)}")

    def rwm_args(steps):
        x0 = 1e-8 * torch.randn(d, Cr, generator=gen, device=dev)
        return (rb, x0, zi(Cr), zf(Cr), torch.tensor(1.0, device=dev),
                torch.sqrt(torch.tensor(RWM_MAIN["base_variance"],
                                        device=dev)),
                seed_key(0), 0, steps, 0)

    kernels.append(kernel_record(
        torch, rwm_main, "rwm_pt_tpu_torch/kernels/csrc/fused_rwm.cu",
        "rwm_pt_tpu/kernels/pallas_rwm.py:570", rwm_launches,
        fused_rwm.launch_rwm_kernel, fused_rwm._run_rwm_fused_plain,
        agreement.RWM_OUTPUTS,
        lambda steps, hold: (rwm_args(steps), dict(draw=rwm_draw),
                             rwm_work("rosenbrock", d, Cr, steps,
                                      draw=rwm_draw)),
        RWM_MAIN["iters"]))

    say(f"phases 1-6 {time.time() - t_start:.1f} s")
    t0 = time.time()
    kernels.extend(phases_7_to_10(torch, gen))
    say(f"phases 7-10 {time.time() - t0:.1f} s")
    t0 = time.time()
    kernels.extend(phases_11_to_13(torch, gen))
    say(f"phases 11-13 {time.time() - t0:.1f} s")
    kernels.extend(phase_14(torch, gen, {r["name"] for r in kernels}))
    phase_15(torch)
    t0 = time.time()
    late_built.wait()
    if "error" in background:
        fail(f"phase 2 background build: {background['error']}")
    say(f"phase 2 build, the warp libraries: {len(late)} in "
        f"{background['s']:.1f} s from the start of phase 2, "
        f"{BACKGROUND_NVCC} nvcc at a time (waited {time.time() - t0:.1f} s "
        f"for them after phase 15)")
    warp_logs = background["logs"]
    report_build(torch, _build, ptxas_report, warp_logs)
    regs = [r for k in warp_logs for _, r, _, _ in ptxas_report.parse(
        warp_logs[k])]
    warp_main = _build.lib_name(_build.library(
        "fused_pt", "Normal", draws.resolve_normal_impl(
            "pt", FLAG["C"], "rosenbrock")), "rosenbrock", WARP_D)
    say(f"phase 16a build: {len(warp_logs)} warp libraries (a team of G "
        f"lanes a replica, d > 64; team sizes {_build.WARP_TEAMS}, RWM's "
        f"{_build.RWM_WARP_TEAMS}), "
        f"{min(regs)}-{max(regs)} registers; {warp_main} "
        f"at d={WARP_D}, T={FLAG['T']}: " + occupancy(
            torch, _build, warp_main, WARP_D, FLAG["T"], n_params=WARP_D + 1))
    kernels.extend(phase_16(torch, gen))
    kernels.extend(phase_17(torch, gen))
    kernels.extend(phase_18(torch, gen))
    kernels.extend(phase_19(torch, card))
    kernels.extend(phase_20(torch, gen))
    kernels.extend(phase_21(torch, gen))
    t0 = time.time()
    warp_build.join()
    if "error" in background:
        fail(f"phase 2 background build: {background['error']}")
    say(f"phase 2 build, the 2048 and 4096 buckets' warp libraries: "
        f"{len(widest)} in {background['widest_s']:.1f} s from the start of "
        f"phase 2 (waited {time.time() - t0:.1f} s for them after phase 21)")
    report_build(torch, _build, ptxas_report, background["widest"])
    kernels.extend(phase_22(torch, gen))

    say(f"total {time.time() - t_start:.1f} s; nvidia-smi name, power.limit:")
    print(card, flush=True)
    print(json.dumps({"kernels": kernels}), flush=True)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": name, "count": count}}), flush=True)


if __name__ == "__main__":
    main()
