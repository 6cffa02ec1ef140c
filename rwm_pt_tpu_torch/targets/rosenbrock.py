"""Rosenbrock targets (port of ``rwm_pt_tpu.targets.rosenbrock``):
``FullRosenbrock``, ``EvenRosenbrock`` and ``HybridRosenbrock``.

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

    def stream_sample(self, stream, n: int, beta: torch.Tensor,
                      matmul_precision: str = "float32"):
        """The conditional-Gaussian sampler from the normals z of slots 0
        .. d-1: x_{2i} = mu + z_{2i} sqrt(1 / (2 a beta)), x_{2i+1} =
        x_{2i}^2 + z_{2i+1} sqrt(1 / (2 b beta))."""
        z = stream.normals(self.dim)
        sa = torch.sqrt(1.0 / (2.0 * (self.a_coeff * beta)))
        sb = torch.sqrt(1.0 / (2.0 * (self.b_coeff * beta)))
        first = self.mu[0::2] + z[:, 0::2] * sa
        out = torch.empty_like(z)
        out[:, 0::2] = first
        out[:, 1::2] = first * first + z[:, 1::2] * sb
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

    def stream_sample(self, stream, n: int, beta: torch.Tensor,
                      matmul_precision: str = "float32"):
        """Ancestral sampling from the normals z of slots 0 .. d-1: x_0 =
        mu + z_0 sqrt(1 / (2 a beta)), then coordinate k (block by block)
        parent^2 + z_k sqrt(1 / (2 b beta)), the parent x_0 for a block's
        first variable and x_{k-1} after it."""
        z = stream.normals(self.dim)
        sg = torch.sqrt(1.0 / (2.0 * (self.a_coeff * beta)))
        sk = torch.sqrt(1.0 / (2.0 * (self.b_coeff * beta)))
        x0 = self.mu + z[:, 0] * sg
        cols = [x0]
        for k in range(1, self.dim):
            par = x0 if (k - 1) % (self.n1 - 1) == 0 else cols[-1]
            cols.append(par * par + z[:, k] * sk)
        return torch.stack(cols, dim=1)
