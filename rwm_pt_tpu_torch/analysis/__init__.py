"""Analysis ported so far: the convergence diagnostics (numpy only)."""
from .diagnostics import (autocorrelation, effective_sample_size,
                          integrated_autocorr_time, mcse_mean, split_rhat)

__all__ = ["autocorrelation", "effective_sample_size",
           "integrated_autocorr_time", "mcse_mean", "split_rhat"]
