"""Full Rosenbrock target (port of ``rwm_pt_tpu.targets.rosenbrock``).

Default coefficients a = 1/20, b = 100/20, mu = 1 (the JAX package's
``DEFAULT_*`` constants, copied here so the port imports nothing of it).
"""
from __future__ import annotations

import dataclasses

import torch

from ..utils.dtypes import as_tensor, default_float, resolve_device
from .base import TargetMixin, bdim

DEFAULT_A_COEFF = 1.0 / 20.0
DEFAULT_B_COEFF = 100.0 / 20.0
DEFAULT_MU = 1.0


@dataclasses.dataclass(frozen=True)
class FullRosenbrock(TargetMixin):
    """log p(x) = -sum_{i=1}^{n-1} [ b (x_{i+1} - x_i^2)^2 + a (x_i - mu_i)^2 ].
    No tractable direct sampler."""

    dim: int
    a_coeff: torch.Tensor    # ()
    b_coeff: torch.Tensor    # ()
    mu: torch.Tensor         # (d-1,)
    name: str = "FullRosenbrock"

    @classmethod
    def create(cls, dim: int, a_coeff: float = DEFAULT_A_COEFF,
               b_coeff: float = DEFAULT_B_COEFF, mu=DEFAULT_MU, *,
               device="cuda") -> "FullRosenbrock":
        if dim < 2:
            raise ValueError("Dimension for FullRosenbrock must be at least 2.")
        dev = resolve_device(device)
        f = default_float()
        mu_arr = as_tensor(mu, dev, f).broadcast_to(
            (dim - 1,)).clone()
        return cls(dim=dim,
                   a_coeff=torch.tensor(a_coeff, dtype=f, device=dev),
                   b_coeff=torch.tensor(b_coeff, dtype=f, device=dev),
                   mu=mu_arr)

    def log_density_td(self, x: torch.Tensor) -> torch.Tensor:
        x_i = x[:-1]
        x_ip1 = x[1:]
        t1 = self.b_coeff * (x_ip1 - x_i * x_i) ** 2
        t2 = self.a_coeff * (x_i - bdim(self.mu, x_i)) ** 2
        return -(torch.sum(t1, dim=0) + torch.sum(t2, dim=0))
