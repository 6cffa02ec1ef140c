"""Multimodal targets (port of ``rwm_pt_tpu.targets.multimodal``):
``ThreeMixture`` and ``RoughCarpet``, each with the Jacobian-corrected
"scaled" variant ``y = s x``.  Default scalings ``s ~ U(0.02, 1.98)`` from
``seed`` are the JAX package's draw bit for bit
(:func:`rwm_pt_tpu_torch.utils.threefry.uniform`).  Names follow the
JAX package: ``Custom`` when the modes or weights differ from the class
defaults by value, ``Scaled`` for the scaled variant.
"""
from __future__ import annotations

import dataclasses
import math

import numpy as np
import torch

from ..utils.dtypes import as_tensor, default_float, resolve_device
from ..utils.threefry import uniform
from .base import TargetMixin, bdim, categorical_index

_LOG_2PI = math.log(2.0 * math.pi)
_LOG_SQRT_2PI = 0.5 * _LOG_2PI


def _mixture_name(base: str, scaling: bool, is_default: bool) -> str:
    name = base
    if not is_default:
        name += "Custom"
    if scaling:
        name += "Scaled"
    return name


def _scalings(dim, scaling, scaling_factors, seed, dev, f):
    """``(s, log_jacobian)``: ones and 0 without scaling; else the explicit
    ``scaling_factors`` or ``U(0.02, 1.98)`` from ``seed``."""
    if not scaling:
        return (torch.ones(dim, dtype=f, device=dev),
                torch.zeros((), dtype=f, device=dev))
    if scaling_factors is not None:
        s = as_tensor(scaling_factors, dev, f)
        if tuple(s.shape) != (dim,):
            raise ValueError(f"scaling_factors must have shape ({dim},), "
                             f"got {tuple(s.shape)}")
    else:
        s = torch.from_numpy(uniform(seed, dim, 0.02, 1.98)).to(dev, f)
    return s, torch.sum(torch.log(s))


def cum_weights(weights: torch.Tensor, device) -> torch.Tensor:
    """The float32 cumulative weights of a mixture, summed on the CPU
    (the ladder kernel takes these very words), on ``device``."""
    return torch.cumsum(weights.detach().cpu().to(torch.float32),
                        0).to(device)


def _mixture_marginal(s, centers, weights, xs):
    """sum_k w_k N(s x | c_k, 1) s  (the Jacobian of y = s x)."""
    y = s * xs
    diff = y[None, :] - centers[:, None]
    comp = torch.exp(-0.5 * diff * diff) / math.sqrt(2.0 * math.pi)
    return s * torch.sum(weights[:, None] * comp, dim=0)


@dataclasses.dataclass(frozen=True)
class ThreeMixture(TargetMixin):
    """Equal-covariance 3-component Gaussian mixture
    p(x) = sum_k w_k N(x | mu_k, I), or scaled:
    sum_k w_k (prod_j s_j) N(s x | mu_k, I)."""

    dim: int
    scaling: bool
    means: torch.Tensor            # (3, d)
    log_weights: torch.Tensor      # (3,)
    weights: torch.Tensor          # (3,)
    scaling_factors: torch.Tensor  # (d,), ones without scaling
    log_jacobian: torch.Tensor     # (), 0 without scaling
    name: str = "ThreeMixture"

    @classmethod
    def create(cls, dim: int, scaling: bool = False, mode_centers=None,
               mode_weights=None, seed: int = 0, scaling_factors=None, *,
               device="cuda") -> "ThreeMixture":
        dev = resolve_device(device)
        f = default_float()
        def_centers = [[-5.0] + [0.0] * (dim - 1), [0.0] * dim,
                       [5.0] + [0.0] * (dim - 1)]
        def_weights = [1 / 3, 1 / 3, 1 / 3]
        means = as_tensor(def_centers if mode_centers is None
                          else mode_centers, dev, f)
        if tuple(means.shape) != (3, dim):
            raise ValueError(f"mode_centers must have shape (3, {dim}), got "
                             f"{tuple(means.shape)}")
        w = as_tensor(def_weights if mode_weights is None else mode_weights,
                      dev, f)
        if tuple(w.shape) != (3,):
            raise ValueError("mode_weights must contain exactly 3 weights")
        default = bool(np.allclose(means.cpu().numpy(), def_centers)
                       and np.allclose(w.cpu().numpy(), def_weights))
        if abs(float(w.sum()) - 1.0) > 1e-5:
            raise ValueError("mode_weights must sum to 1.0")
        s, log_jac = _scalings(dim, scaling, scaling_factors, seed, dev, f)
        return cls(dim=dim, scaling=scaling, means=means,
                   log_weights=torch.log(w), weights=w, scaling_factors=s,
                   log_jacobian=log_jac,
                   name=_mixture_name("ThreeMixture", scaling, default))

    def log_density_td(self, x: torch.Tensor) -> torch.Tensor:
        y = bdim(self.scaling_factors, x) * x if self.scaling else x
        diff = y[None] - self.means.reshape((3, self.dim)
                                            + (1,) * (x.ndim - 1))
        quad = torch.sum(diff * diff, dim=1)                 # (3, *B)
        lw = self.log_weights.reshape((3,) + (1,) * (x.ndim - 1))
        comp = -0.5 * quad - 0.5 * self.dim * _LOG_2PI + lw
        # jax.nn.logsumexp: shift by the max, or by 0 where it is not finite
        m = torch.amax(comp, dim=0)
        m0 = torch.where(torch.isfinite(m), m, torch.zeros_like(m))
        return (torch.log(torch.sum(torch.exp(comp - m0), dim=0)) + m0
                + self.log_jacobian)

    def stream_sample(self, stream, n: int, beta: torch.Tensor,
                      matmul_precision: str = "float32"):
        """Mode k of the uniform of slot d against the cumulative weights,
        y = mu_k + z / sqrt(beta) (z the normals of slots 0 .. d-1), x = y
        / s."""
        d = self.dim
        idx = categorical_index(stream.uniforms(d, d + 1)[:, 0],
                                cum_weights(self.weights, self.device))
        y = self.means[idx] + stream.normals(d) / torch.sqrt(beta)
        return y / self.scaling_factors

    def init_sample(self, n: int, generator: torch.Generator | None = None):
        """Multimodal targets start at the origin."""
        return torch.zeros((n, self.dim), dtype=self.dtype,
                           device=self.device)

    def marginal_density(self, axis: int, xs):
        xs = torch.as_tensor(xs, dtype=self.dtype, device=self.device)
        return _mixture_marginal(self.scaling_factors[axis],
                                 self.means[:, axis], self.weights, xs)


@dataclasses.dataclass(frozen=True)
class RoughCarpet(TargetMixin):
    """Product over dims of a 1-D three-mode Gaussian mixture; default modes
    (-5, 0, 5), weights (0.5, 0.3, 0.2)."""

    dim: int
    scaling: bool
    modes: torch.Tensor            # (3,)
    log_weights: torch.Tensor      # (3,)
    weights: torch.Tensor          # (3,)
    scaling_factors: torch.Tensor  # (d,)
    log_jacobian: torch.Tensor     # ()
    name: str = "RoughCarpet"

    @classmethod
    def create(cls, dim: int, scaling: bool = False, mode_centers=None,
               mode_weights=None, seed: int = 0, scaling_factors=None, *,
               device="cuda") -> "RoughCarpet":
        dev = resolve_device(device)
        f = default_float()
        modes = as_tensor([-5.0, 0.0, 5.0] if mode_centers is None
                          else mode_centers, dev, f)
        w = as_tensor([0.5, 0.3, 0.2] if mode_weights is None
                      else mode_weights, dev, f)
        if tuple(modes.shape) != (3,):
            raise ValueError("mode_centers must contain exactly 3 scalar "
                             "modes")
        if tuple(w.shape) != (3,):
            raise ValueError("mode_weights must contain exactly 3 weights")
        default = bool(np.allclose(modes.cpu().numpy(), [-5.0, 0.0, 5.0])
                       and np.allclose(w.cpu().numpy(), [0.5, 0.3, 0.2]))
        if abs(float(w.sum()) - 1.0) > 1e-5:
            raise ValueError("mode_weights must sum to 1.0")
        s, log_jac = _scalings(dim, scaling, scaling_factors, seed, dev, f)
        return cls(dim=dim, scaling=scaling, modes=modes,
                   log_weights=torch.log(w), weights=w, scaling_factors=s,
                   log_jacobian=log_jac,
                   name=_mixture_name("RoughCarpet", scaling, default))

    def log_density_td(self, x: torch.Tensor) -> torch.Tensor:
        y = bdim(self.scaling_factors, x) * x if self.scaling else x
        parts = [self.log_weights[k] - 0.5 * torch.square(y - self.modes[k])
                 for k in range(3)]
        m = torch.maximum(torch.maximum(parts[0], parts[1]), parts[2])
        # a max of -inf (every quadratic overflowed) gives -inf, not NaN
        m0 = torch.where(torch.isfinite(m), m, torch.zeros_like(m))
        per_dim = m + torch.log(torch.exp(parts[0] - m0)
                                + torch.exp(parts[1] - m0)
                                + torch.exp(parts[2] - m0)) - _LOG_SQRT_2PI
        return torch.sum(per_dim, dim=0) + self.log_jacobian

    def stream_sample(self, stream, n: int, beta: torch.Tensor,
                      matmul_precision: str = "float32"):
        """Per coordinate j, mode k of the uniform of slot d + j against the
        cumulative weights, y = mode_k + z_j / sqrt(beta) (z the normals of
        slots 0 .. d-1), x = y / s."""
        d = self.dim
        idx = categorical_index(stream.uniforms(d, 2 * d),
                                cum_weights(self.weights, self.device))
        y = self.modes[idx] + stream.normals(d) / torch.sqrt(beta)
        return y / self.scaling_factors

    def init_sample(self, n: int, generator: torch.Generator | None = None):
        """Multimodal targets start at the origin."""
        return torch.zeros((n, self.dim), dtype=self.dtype,
                           device=self.device)

    def marginal_density(self, axis: int, xs):
        xs = torch.as_tensor(xs, dtype=self.dtype, device=self.device)
        return _mixture_marginal(self.scaling_factors[axis], self.modes,
                                 self.weights, xs)
