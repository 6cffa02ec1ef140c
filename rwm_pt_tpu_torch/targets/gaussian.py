"""Gaussian targets (port of ``rwm_pt_tpu.targets.gaussian``):
``MultivariateNormal`` and ``ScaledMultivariateNormal``."""
from __future__ import annotations

import dataclasses
import math

import torch

from ..utils.dtypes import as_tensor, default_float, resolve_device
from ..utils.threefry import uniform
from .base import TargetMixin, bdim, round_operand

_LOG_2PI = math.log(2.0 * math.pi)


@dataclasses.dataclass(frozen=True)
class MultivariateNormal(TargetMixin):
    """N(mean, cov); defaults to (0, I).

    ``iso`` marks the identity-covariance fast path (a plain reduction; the
    fused CUDA kernels build a separate library for each of the two
    paths, the full one reading ``cov_inv`` from shared memory).  The
    full-covariance
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

    def stream_sample(self, stream, n: int, beta: torch.Tensor,
                      matmul_precision: str = "float32"):
        """x = mean + z (chol / sqrt(beta))^T, z the normals of slots
        0 .. d-1, the product's operands at ``matmul_precision``."""
        z = round_operand(stream.normals(self.dim), matmul_precision)
        scale = round_operand(self.chol / torch.sqrt(beta),
                              matmul_precision)
        return self.mean + z @ scale.T

    def log_density_at(self, x: torch.Tensor,
                       matmul_precision: str = "float32") -> torch.Tensor:
        """:meth:`log_density` of ``(..., dim)`` with the full
        covariance's product ``cov_inv @ (x - mean)`` at
        ``matmul_precision`` (JAX's ``tensordot`` under
        ``jax.default_matmul_precision``)."""
        if self.iso or matmul_precision == "float32":
            return self.log_density(x)
        xc = torch.movedim(x, -1, 0) - bdim(self.mean, torch.movedim(x, -1,
                                                                     0))
        y = torch.tensordot(round_operand(self.cov_inv, matmul_precision),
                            round_operand(xc, matmul_precision),
                            dims=([1], [0]))
        return -0.5 * torch.sum(xc * y, dim=0) + self.log_norm_const

    def marginal_density(self, axis: int, xs):
        """Gaussian marginal N(mean[axis], cov[axis, axis])."""
        var = self.cov[axis, axis]
        xc = torch.as_tensor(xs, dtype=self.dtype, device=self.device) \
            - self.mean[axis]
        return torch.exp(-0.5 * xc * xc / var) / torch.sqrt(
            2.0 * math.pi * var)


@dataclasses.dataclass(frozen=True)
class ScaledMultivariateNormal(TargetMixin):
    """pi(x) = prod_i c_i N(c_i x_i | 0, 1), port of
    ``rwm_pt_tpu.targets.gaussian.ScaledMultivariateNormal``:
    log pi(x) = sum log c_i - (d/2) log 2 pi - 0.5 sum (c_i x_i)^2.
    Default ``c ~ U(0.02, 1.98)`` from ``seed``, the JAX package's draw bit
    for bit (:func:`rwm_pt_tpu_torch.utils.threefry.uniform`)."""

    dim: int
    scaling_factors: torch.Tensor   # (d,) c_i
    log_norm_const: torch.Tensor    # ()
    name: str = "ScaledMultivariateNormal"

    @classmethod
    def create(cls, dim: int, scaling_factors=None,
               scaling_range=(0.02, 1.98), seed: int = 0, *,
               device="cuda") -> "ScaledMultivariateNormal":
        dev = resolve_device(device)
        f = default_float()
        if scaling_factors is None:
            c = torch.from_numpy(uniform(seed, dim, *scaling_range)).to(dev, f)
        else:
            c = as_tensor(scaling_factors, dev, f)
        lnc = torch.sum(torch.log(c)) - 0.5 * dim * _LOG_2PI
        return cls(dim=dim, scaling_factors=c, log_norm_const=lnc)

    def log_density_td(self, x: torch.Tensor) -> torch.Tensor:
        sx = bdim(self.scaling_factors, x) * x
        return self.log_norm_const - 0.5 * torch.sum(sx * sx, dim=0)

    def stream_sample(self, stream, n: int, beta: torch.Tensor,
                      matmul_precision: str = "float32"):
        """x_i = z_i / (c_i sqrt(beta)), z the normals of slots 0 .. d-1."""
        z = stream.normals(self.dim)
        return z * (1.0 / (self.scaling_factors * torch.sqrt(beta)))

    def get_variances(self):
        """Equivalent per-dim variances 1/c_i^2."""
        return 1.0 / (self.scaling_factors ** 2)

    def marginal_density(self, axis: int, xs):
        """Product target: the axis factor c N(c x | 0, 1)."""
        c = self.scaling_factors[axis]
        y = c * torch.as_tensor(xs, dtype=self.dtype, device=self.device)
        return c * torch.exp(-0.5 * y * y) / math.sqrt(2.0 * math.pi)
