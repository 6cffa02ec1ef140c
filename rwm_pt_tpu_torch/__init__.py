"""rwm_pt_tpu_torch — the PyTorch / CUDA (NVIDIA H100) port of rwm_pt_tpu.

Random Walk Metropolis and Parallel Tempering over analytic targets, with
the whole-run samplers as hand-written CUDA kernels for Hopper (``sm_90a``,
``kernels/csrc``) beside plain PyTorch versions of the same functions, the
``MCMCSimulation`` harness (``api``; burn-in autotuning of the proposal or
the ladder), the iterative ladder built in one launch of a CUDA kernel
(``ladders.construct_iterative_ladder_device``) or by the host loop, the
four CLIs: the RWM proposal study (``python -m
rwm_pt_tpu_torch.cli.experiment_rwm``), the PT swap-rate study
(``python -m rwm_pt_tpu_torch.cli.experiment_pt``), one autotuned run
(``python -m rwm_pt_tpu_torch.cli.single_run``) and the walkthrough
(``python -m rwm_pt_tpu_torch.cli.demo``), the analysis tools
(``analysis``: seed averaging, ``batch_average_seeds``, ``combine_data``,
plots, diagnostics), the profiling utilities (``utils.profiling``) and
runs sharded over a mesh of devices (``parallel``,
``kernels.fused_sharded``).
Imports ``torch`` and numpy only; the JAX package ``rwm_pt_tpu`` is the
reference it is tested against.  Entry points run on ``device="cuda"``
unless the caller passes ``device="cpu"``.
"""

__version__ = "0.1.0"

from . import (analysis, api, kernels, ladders, parallel,  # noqa: F401
               proposals, targets)
from .convert import (proposal_from_numpy, pt_state_from_numpy,  # noqa: F401
                      pt_state_to_numpy, rwm_state_from_numpy,
                      rwm_state_to_numpy, target_from_numpy)
