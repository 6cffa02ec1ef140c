"""Command-line entry points ported so far: the RWM proposal study
(``python -m rwm_pt_tpu_torch.cli.experiment_rwm``)."""
