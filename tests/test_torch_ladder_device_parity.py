"""The port's one-program ladder builder
(``construct_iterative_ladder_device``) against JAX's with their own
draws: the two packages' streams differ, so the ladders agree in
distribution (the same rungs, each beta within 5 %)."""
import numpy as np
import pytest
import torch

from rwm_pt_tpu.ladders.ladders import \
    construct_iterative_ladder_device as jdevice
from rwm_pt_tpu.targets import get_target_distribution as jget
from rwm_pt_tpu_torch.ladders import construct_iterative_ladder_device
from rwm_pt_tpu_torch.targets import get_target_distribution as tget

torch.set_num_threads(1)
CPU = "cpu"


@pytest.mark.parametrize("name,d", [("MultivariateNormal", 5),
                                    ("ThreeMixture", 10)])
def test_device_builder_matches_jax_statistically(name, d):
    """Against JAX's one-program builder with its own draws: the same
    number of rungs, each beta within 5 %."""
    kw = dict(target_swap_acceptance_rate=0.3, N_samples_swap_est=20000,
              tolerance=0.01, max_pn_adjustment_steps=50, seed=4)
    j = jdevice(jget(name, d, variant="pt_gpu"), **kw)
    t = construct_iterative_ladder_device(
        tget(name, d, variant="pt_gpu", device=CPU), **kw)
    assert len(t) == len(j)
    np.testing.assert_allclose(t, j, rtol=0.05)
