"""Post-processing tools, numpy and json only: the seed averaging of sweep
files (``average_seeds``, ``batch_average_seeds``, ``combine_data``), the
averaged curves' plots (``plotting``) and the convergence diagnostics."""
from .average_seeds import (average_experiment_data, find_matching_files,
                            generate_output_filename)
from .diagnostics import (autocorrelation, effective_sample_size,
                          integrated_autocorr_time, mcse_mean, split_rhat)

__all__ = ["average_experiment_data", "find_matching_files",
           "generate_output_filename", "autocorrelation",
           "effective_sample_size", "integrated_autocorr_time", "mcse_mean",
           "split_rhat"]
