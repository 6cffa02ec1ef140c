"""Samplers: the eager RWM and PT engines (with JAX's options: the CPU PT
semantics, ``symmetric=False``, ``progress_every``), their burn-in
adaptive variants, and the fused whole-run RWM and PT kernels (CUDA, with
plain PyTorch versions), for the Normal, Laplace and UniformRadius
proposals, with trace recording; their sharded runs over a device mesh
(``fused_sharded``: chains-sharded, and the temperature-sharded hybrid);
and the one-launch iterative ladder kernel (``ladder_build``, driven by
``ladders.construct_iterative_ladder_device``)."""
from .adapt import (AdaptiveLadderPTResult, AdaptivePTResult,
                    AdaptiveRWMResult, run_pt_adaptive,
                    run_pt_ladder_adaptive, run_rwm_adaptive)
from .fused_pt import run_pt_fused
from .fused_rwm import run_rwm_fused
from .fused_sharded import (run_pt_fused_sharded, run_pt_fused_tempsharded,
                            run_rwm_fused_sharded)
from .pt import PTResult, PTState, pt_init, pt_step, run_pt
from .rwm import RWMResult, RWMState, run_rwm, rwm_init, rwm_step

__all__ = ["RWMState", "RWMResult", "rwm_init", "rwm_step", "run_rwm",
           "PTState", "PTResult", "pt_init", "pt_step", "run_pt",
           "run_rwm_fused", "run_pt_fused", "run_rwm_fused_sharded",
           "run_pt_fused_sharded", "run_pt_fused_tempsharded",
           "AdaptiveRWMResult",
           "AdaptivePTResult", "AdaptiveLadderPTResult", "run_rwm_adaptive",
           "run_pt_adaptive", "run_pt_ladder_adaptive"]
