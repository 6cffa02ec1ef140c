"""Samplers ported so far: the eager RWM and PT engines and the fused
whole-run RWM and PT kernels (CUDA, with plain PyTorch versions), for the
Normal, Laplace and UniformRadius proposals, with trace recording."""
from .fused_pt import run_pt_fused
from .fused_rwm import run_rwm_fused
from .pt import PTResult, PTState, pt_init, pt_step, run_pt
from .rwm import RWMResult, RWMState, run_rwm, rwm_init, rwm_step

__all__ = ["RWMState", "RWMResult", "rwm_init", "rwm_step", "run_rwm",
           "PTState", "PTResult", "pt_init", "pt_step", "run_pt",
           "run_rwm_fused", "run_pt_fused"]
