"""Neal's funnel (port of ``rwm_pt_tpu.targets.funnel.NealFunnel``).

``SuperFunnel`` is not ported: the JAX package draws its synthetic dataset
from JAX's threefry normal and bernoulli streams, which the port would have
to reproduce first (ROADMAP Queue A item 9).
"""
from __future__ import annotations

import dataclasses
import math

import numpy as np
import torch

from ..utils.dtypes import default_float, resolve_device
from .base import TargetMixin, _draw_normal, sum0

_LOG_2PI = math.log(2.0 * math.pi)


@dataclasses.dataclass(frozen=True)
class NealFunnel(TargetMixin):
    """v ~ N(mu_v, sigma_v^2), z_k | v ~ N(mu_z, e^v):
    log p = -0.5 log 2 pi - 0.5 log sigma_v^2 - 0.5 (v - mu_v)^2 / sigma_v^2
            - 0.5 (d-1) log 2 pi - 0.5 (d-1) v - 0.5 e^{-v} sum (z_k - mu_z)^2.
    """

    dim: int
    mu_v: torch.Tensor        # ()
    sigma_v_sq: torch.Tensor  # ()
    mu_z: torch.Tensor        # ()
    name: str = "NealFunnel"

    @classmethod
    def create(cls, dim: int, mu_v: float = 0.0, sigma_v_sq: float = 9.0,
               mu_z: float = 0.0, *, device="cuda") -> "NealFunnel":
        if dim < 1:
            raise ValueError("dim must be at least 1 for Neal's Funnel.")
        if sigma_v_sq <= 0:
            raise ValueError("sigma_v_sq must be positive.")
        dev = resolve_device(device)
        f = default_float()
        return cls(dim=dim, mu_v=torch.tensor(mu_v, dtype=f, device=dev),
                   sigma_v_sq=torch.tensor(sigma_v_sq, dtype=f, device=dev),
                   mu_z=torch.tensor(mu_z, dtype=f, device=dev))

    def log_density_td(self, x: torch.Tensor) -> torch.Tensor:
        v = x[0]
        log_prior_v = (-0.5 * _LOG_2PI - 0.5 * torch.log(self.sigma_v_sq)
                       - 0.5 * (v - self.mu_v) ** 2 / self.sigma_v_sq)
        if self.dim == 1:
            return log_prior_v
        sum_sq = sum0((x[1:] - self.mu_z) ** 2)     # in the kernels' order
        d1 = self.dim - 1
        log_lik = (-0.5 * d1 * _LOG_2PI - 0.5 * d1 * v
                   - 0.5 * torch.exp(-v) * sum_sq)
        return log_prior_v + log_lik

    def get_name(self) -> str:
        return f"{self.name}_D{self.dim}"

    def direct_sample(self, n: int, beta: float = 1.0,
                      generator: torch.Generator | None = None):
        """Exact sampler of the beta-tempered funnel: integrating the z's out
        of pi^beta leaves a Gaussian v,
        v ~ N(mu_v + (1 - beta)(d-1) sigma_v^2 / (2 beta), sigma_v^2 / beta),
        then z_k | v ~ N(mu_z, e^v / beta)."""
        beta = float(beta)
        d1 = self.dim - 1
        mean_v = self.mu_v + (1.0 - beta) * d1 * self.sigma_v_sq / (2.0 * beta)
        v = mean_v + torch.sqrt(self.sigma_v_sq / beta) * _draw_normal(
            (n,), generator, self.device, self.dtype)
        if self.dim == 1:
            return v[:, None]
        z = (self.mu_z + torch.exp(v[:, None] / 2.0) / math.sqrt(beta)
             * _draw_normal((n, d1), generator, self.device, self.dtype))
        return torch.cat([v[:, None], z], dim=1)

    def marginal_density(self, axis: int, xs):
        """v's marginal is N(mu_v, sigma_v^2); a z coordinate's is the 1-D
        integral E_v[N(z | mu_z, e^v)], by 64-node Gauss-Hermite
        quadrature over v."""
        xs = torch.as_tensor(xs, dtype=self.dtype, device=self.device)
        if axis == 0:
            xc = xs - self.mu_v
            return (torch.exp(-0.5 * xc * xc / self.sigma_v_sq)
                    / torch.sqrt(2.0 * math.pi * self.sigma_v_sq))
        t, w = np.polynomial.hermite.hermgauss(64)
        t = torch.as_tensor(t, dtype=self.dtype, device=self.device)
        w = torch.as_tensor(w, dtype=self.dtype, device=self.device)
        v = self.mu_v + torch.sqrt(2.0 * self.sigma_v_sq) * t
        var_z = torch.exp(v)[:, None]
        zc = xs[None, :] - self.mu_z
        comp = torch.exp(-0.5 * zc * zc / var_z) / torch.sqrt(
            2.0 * math.pi * var_z)
        return torch.sum(w[:, None] * comp, dim=0) / math.sqrt(math.pi)
