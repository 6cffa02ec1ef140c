"""IID product targets (port of ``rwm_pt_tpu.targets.iid``): ``IIDGamma``
and ``IIDBeta``.  A coordinate outside the support makes the log-density
``-inf``; the log of every coordinate is taken on a safe value there
(``where``), so the batch never meets a NaN.  The terms are summed in
index order (``base.sum0``), as the fused kernels sum them.  The log
normalisers come from ``math.lgamma`` on the host."""
from __future__ import annotations

import dataclasses
import math

import torch

from ..utils.dtypes import default_float, resolve_device
from .base import TargetMixin, _draw_normal, _draw_uniform, sum0


@dataclasses.dataclass(frozen=True)
class IIDGamma(TargetMixin):
    """Product of d iid Gamma(shape, scale) densities (defaults 2, 3)."""

    dim: int
    shape: torch.Tensor            # ()
    scale: torch.Tensor            # ()
    log_norm_const: torch.Tensor   # () d (lgamma(shape) + shape log scale)
    name: str = "IIDGamma"

    @classmethod
    def create(cls, dim: int, shape: float = 2.0, scale: float = 3.0, *,
               device="cuda") -> "IIDGamma":
        dev = resolve_device(device)
        f = default_float()
        lnc = dim * (math.lgamma(shape) + shape * math.log(scale))
        return cls(dim=dim, shape=torch.tensor(shape, dtype=f, device=dev),
                   scale=torch.tensor(scale, dtype=f, device=dev),
                   log_norm_const=torch.tensor(lnc, dtype=f, device=dev))

    def log_density_td(self, x: torch.Tensor) -> torch.Tensor:
        pos = x > 0
        valid = torch.all(pos, dim=0)
        safe_x = torch.where(pos, x, torch.ones_like(x))
        ld = sum0((self.shape - 1) * torch.log(safe_x)
                  - safe_x / self.scale) - self.log_norm_const
        return torch.where(valid, ld, torch.full_like(ld, -torch.inf))

    def stream_sample(self, stream, n: int, beta: torch.Tensor,
                      matmul_precision: str = "float32"):
        """Gamma(shape beta) variates (``ProbeStream.gamma``) times the
        scale."""
        return stream.gamma(self.shape * beta, self.dim) * self.scale

    def init_sample(self, n: int, generator: torch.Generator | None = None):
        """Gamma targets start at 5 + 0.01 N(0, I)."""
        return 5.0 + 0.01 * _draw_normal((n, self.dim), generator,
                                         self.device, self.dtype)

    def marginal_density(self, axis: int, xs):
        x = torch.as_tensor(xs, dtype=self.dtype, device=self.device)
        safe = torch.where(x > 0, x, torch.ones_like(x))
        ld = ((self.shape - 1) * torch.log(safe) - safe / self.scale
              - torch.lgamma(self.shape) - self.shape * torch.log(self.scale))
        return torch.where(x > 0, torch.exp(ld), torch.zeros_like(x))


@dataclasses.dataclass(frozen=True)
class IIDBeta(TargetMixin):
    """Product of d iid Beta(alpha, beta) densities (defaults 2, 3)."""

    dim: int
    alpha: torch.Tensor            # ()
    beta: torch.Tensor             # ()
    log_norm_const: torch.Tensor   # () d log(1 / B(alpha, beta))
    name: str = "IIDBeta"

    @classmethod
    def create(cls, dim: int, alpha: float = 2.0, beta: float = 3.0, *,
               device="cuda") -> "IIDBeta":
        dev = resolve_device(device)
        f = default_float()
        lnc = dim * (math.lgamma(alpha + beta) - math.lgamma(alpha)
                     - math.lgamma(beta))
        return cls(dim=dim, alpha=torch.tensor(alpha, dtype=f, device=dev),
                   beta=torch.tensor(beta, dtype=f, device=dev),
                   log_norm_const=torch.tensor(lnc, dtype=f, device=dev))

    def log_density_td(self, x: torch.Tensor) -> torch.Tensor:
        in_dom = (x > 0) & (x < 1)
        valid = torch.all(in_dom, dim=0)
        safe_x = torch.where(in_dom, x, torch.full_like(x, 0.5))
        ld = sum0((self.alpha - 1) * torch.log(safe_x)
                  + (self.beta - 1) * torch.log1p(-safe_x))
        return torch.where(valid, ld + self.log_norm_const,
                           torch.full_like(ld, -torch.inf))

    def stream_sample(self, stream, n: int, beta: torch.Tensor,
                      matmul_precision: str = "float32"):
        """G1 / (G1 + G2) of the stream's gammas 0 and 1, of shapes alpha
        beta and beta_param beta."""
        g1 = stream.gamma(self.alpha * beta, self.dim, 0)
        g2 = stream.gamma(self.beta * beta, self.dim, 1)
        return g1 / (g1 + g2)

    def init_sample(self, n: int, generator: torch.Generator | None = None):
        """Beta targets start in U(0.2, 0.8), away from the boundaries."""
        return _draw_uniform((n, self.dim), generator, self.device,
                             self.dtype, 0.2, 0.8)

    def marginal_density(self, axis: int, xs):
        x = torch.as_tensor(xs, dtype=self.dtype, device=self.device)
        in_dom = (x > 0) & (x < 1)
        safe = torch.where(in_dom, x, torch.full_like(x, 0.5))
        ld = ((self.alpha - 1) * torch.log(safe)
              + (self.beta - 1) * torch.log1p(-safe)
              + torch.lgamma(self.alpha + self.beta)
              - torch.lgamma(self.alpha) - torch.lgamma(self.beta))
        return torch.where(in_dom, torch.exp(ld), torch.zeros_like(x))
