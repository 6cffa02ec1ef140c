"""Rosenbrock targets (port of ``rwm_pt_tpu.targets.rosenbrock``):
``FullRosenbrock``, ``EvenRosenbrock`` and ``HybridRosenbrock``.

Default coefficients a = 1/20, b = 100/20, mu = 1 (the JAX package's
``DEFAULT_*`` constants, copied here so the port imports nothing of it).
"""
from __future__ import annotations

import dataclasses
import math

import torch

from ..utils.dtypes import as_tensor, default_float, resolve_device
from .base import TargetMixin, _draw_normal, bdim

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


@dataclasses.dataclass(frozen=True)
class EvenRosenbrock(TargetMixin):
    """Product of d/2 independent 2-d Rosenbrock kernels:
    log p(x) = -sum_i [a (x_{2i} - mu)^2 + b (x_{2i+1} - x_{2i}^2)^2]
    (0-indexed).  The pair structure is folded into ``(d-1,)`` vectors, as
    in the JAX package: ``mu``, ``a_vec`` and ``b_vec`` hold mu, a and b at
    the pair starts (even slots) and 0 at odd slots, so the density sums
    over contiguous ``x[:-1]`` / ``x[1:]``."""

    dim: int
    a_coeff: torch.Tensor   # ()
    b_coeff: torch.Tensor   # ()
    mu: torch.Tensor        # (d-1,)
    a_vec: torch.Tensor     # (d-1,)
    b_vec: torch.Tensor     # (d-1,)
    name: str = "EvenRosenbrock"

    @classmethod
    def create(cls, dim: int, a_coeff: float = DEFAULT_A_COEFF,
               b_coeff: float = DEFAULT_B_COEFF, mu=DEFAULT_MU, *,
               device="cuda") -> "EvenRosenbrock":
        if dim < 2 or dim % 2 != 0:
            raise ValueError("Dimension for EvenRosenbrock must be >= 2 and "
                             "even.")
        dev = resolve_device(device)
        f = default_float()
        mu_pairs = as_tensor(mu, dev, f).broadcast_to((dim // 2,))
        mu_arr = torch.zeros(dim - 1, dtype=f, device=dev)
        mu_arr[0::2] = mu_pairs
        even = torch.zeros(dim - 1, dtype=f, device=dev)
        even[0::2] = 1.0
        a = torch.tensor(a_coeff, dtype=f, device=dev)
        b = torch.tensor(b_coeff, dtype=f, device=dev)
        return cls(dim=dim, a_coeff=a, b_coeff=b, mu=mu_arr, a_vec=a * even,
                   b_vec=b * even)

    def log_density_td(self, x: torch.Tensor) -> torch.Tensor:
        x_i = x[:-1]
        x_ip1 = x[1:]
        t1 = bdim(self.a_vec, x_i) * torch.square(x_i - bdim(self.mu, x_i))
        t2 = bdim(self.b_vec, x_i) * torch.square(x_ip1 - x_i * x_i)
        return -torch.sum(t1 + t2, dim=0)

    def direct_sample(self, n: int, beta: float = 1.0,
                      generator: torch.Generator | None = None):
        """Exact conditional-Gaussian sampler: x_{2i} ~ N(mu, 1/(2 a beta)),
        x_{2i+1} | x_{2i} ~ N(x_{2i}^2, 1/(2 b beta))."""
        pairs = self.dim // 2
        eff_a = self.a_coeff * float(beta)
        eff_b = self.b_coeff * float(beta)
        z1 = _draw_normal((n, pairs), generator, self.device, self.dtype)
        z2 = _draw_normal((n, pairs), generator, self.device, self.dtype)
        x_odd = self.mu[0::2] + z1 * torch.sqrt(1.0 / (2 * eff_a))
        x_even = x_odd ** 2 + z2 * torch.sqrt(1.0 / (2 * eff_b))
        out = torch.zeros((n, self.dim), dtype=self.dtype, device=self.device)
        out[:, 0::2] = x_odd
        out[:, 1::2] = x_even
        return out


@dataclasses.dataclass(frozen=True)
class HybridRosenbrock(TargetMixin):
    """DAG of n2 blocks of length n1, dim = 1 + n2 (n1 - 1):
    log p(x) = -a (x_0 - mu)^2 - b sum_j (x_{j,1} - x_0^2)^2
               - b sum_j sum_{i>=2} (x_{j,i} - x_{j,i-1}^2)^2."""

    dim: int
    n1: int
    n2: int
    a_coeff: torch.Tensor   # ()
    b_coeff: torch.Tensor   # ()
    mu: torch.Tensor        # ()
    name: str = "HybridRosenbrock"

    @classmethod
    def create(cls, n1: int, n2: int, a_coeff: float = DEFAULT_A_COEFF,
               b_coeff: float = DEFAULT_B_COEFF, mu: float = DEFAULT_MU, *,
               device="cuda") -> "HybridRosenbrock":
        if n1 < 2:
            raise ValueError("n1 (block length parameter) must be at least "
                             "2.")
        if n2 < 1:
            raise ValueError("n2 (number of blocks) must be at least 1.")
        dev = resolve_device(device)
        f = default_float()
        return cls(dim=1 + n2 * (n1 - 1), n1=n1, n2=n2,
                   a_coeff=torch.tensor(a_coeff, dtype=f, device=dev),
                   b_coeff=torch.tensor(b_coeff, dtype=f, device=dev),
                   mu=torch.tensor(mu, dtype=f, device=dev))

    def log_density_td(self, x: torch.Tensor) -> torch.Tensor:
        x_g1 = x[0]
        log_prob = -self.a_coeff * (x_g1 - self.mu) ** 2
        blocks = x[1:].reshape((self.n2, self.n1 - 1) + tuple(x.shape[1:]))
        t_first = self.b_coeff * (blocks[:, 0] - x_g1 * x_g1) ** 2
        log_prob = log_prob - torch.sum(t_first, dim=0)
        if self.n1 > 2:
            prev_sq = blocks[:, :-1] ** 2
            t_in = self.b_coeff * (blocks[:, 1:] - prev_sq) ** 2
            log_prob = log_prob - torch.sum(t_in, dim=(0, 1))
        return log_prob

    def direct_sample(self, n: int, beta: float = 1.0,
                      generator: torch.Generator | None = None):
        """Ancestral sampling down the DAG: x_0 ~ N(mu, 1/(2 a beta)), each
        block's first variable ~ N(x_0^2, 1/(2 b beta)), then each next one
        ~ N(previous^2, 1/(2 b beta))."""
        std_g1 = math.sqrt(1.0 / (2 * float(self.a_coeff) * float(beta)))
        std_blk = math.sqrt(1.0 / (2 * float(self.b_coeff) * float(beta)))
        x_g1 = self.mu + _draw_normal((n,), generator, self.device,
                                      self.dtype) * std_g1
        noise = _draw_normal((self.n2, self.n1 - 1, n), generator,
                             self.device, self.dtype) * std_blk
        cols = [x_g1[None] ** 2 + noise[:, 0]]             # (n2, n)
        for i in range(1, self.n1 - 1):
            cols.append(cols[-1] ** 2 + noise[:, i])
        blocks = torch.stack(cols, dim=1)                  # (n2, n1-1, n)
        out = torch.cat([x_g1[None],
                         blocks.reshape(self.n2 * (self.n1 - 1), n)], dim=0)
        return out.T
