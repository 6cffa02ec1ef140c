"""Multivariate normal target (port of
``rwm_pt_tpu.targets.gaussian.MultivariateNormal``)."""
from __future__ import annotations

import dataclasses
import math

import torch

from ..utils.dtypes import as_tensor, default_float, resolve_device
from .base import TargetMixin, _draw_normal, bdim

_LOG_2PI = math.log(2.0 * math.pi)


@dataclasses.dataclass(frozen=True)
class MultivariateNormal(TargetMixin):
    """N(mean, cov); defaults to (0, I).

    ``iso`` marks the identity-covariance fast path (a plain reduction, and
    the only covariance the fused CUDA kernels take).  The full-covariance
    path's ``(d, d) @ (d, B)`` product is ``torch.matmul``, which runs in
    full float32 on the card unless the caller has turned TF32 on
    (``torch.backends.cuda.matmul.allow_tf32``, False by default)."""

    dim: int
    iso: bool
    mean: torch.Tensor            # (d,)
    cov: torch.Tensor             # (d, d)
    cov_inv: torch.Tensor         # (d, d)
    chol: torch.Tensor            # (d, d) Cholesky factor of cov
    log_norm_const: torch.Tensor  # ()
    name: str = "MultivariateNormal"

    @classmethod
    def create(cls, dim: int, mean=None, cov=None, *,
               device="cuda") -> "MultivariateNormal":
        dev = resolve_device(device)
        f = default_float()
        iso = cov is None
        mean = (torch.zeros(dim, dtype=f, device=dev) if mean is None
                else as_tensor(mean, dev, f))
        cov = (torch.eye(dim, dtype=f, device=dev) if cov is None
               else as_tensor(cov, dev, f))
        cov_inv = torch.linalg.inv(cov)
        chol = torch.linalg.cholesky(cov)
        _, logdet = torch.linalg.slogdet(cov)
        lnc = -0.5 * (dim * _LOG_2PI + logdet)
        return cls(dim=dim, iso=iso, mean=mean, cov=cov, cov_inv=cov_inv,
                   chol=chol, log_norm_const=lnc)

    def log_density_td(self, x: torch.Tensor) -> torch.Tensor:
        xc = x - bdim(self.mean, x)
        if self.iso:
            quad = torch.sum(xc * xc, dim=0)
        else:
            y = torch.tensordot(self.cov_inv, xc, dims=([1], [0]))
            quad = torch.sum(xc * y, dim=0)
        return -0.5 * quad + self.log_norm_const

    def direct_sample(self, n: int, beta: float = 1.0,
                      generator: torch.Generator | None = None):
        """x = mean + chol(cov / beta) z."""
        z = _draw_normal((n, self.dim), generator, self.device, self.dtype)
        scale = self.chol / math.sqrt(float(beta))
        return self.mean + z @ scale.T
