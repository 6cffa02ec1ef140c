"""Proposal increment distributions (port of
``rwm_pt_tpu.proposals.proposals``: the ``Proposal`` base,
``NormalProposal``, ``LaplaceProposal``, ``UniformRadiusProposal`` and the
``create_proposal_distribution`` factory).

Proposals are symmetric, state-independent increment distributions.
Temperature enters through the reference's laws: variance/beta for Normal
and Laplace, radius/sqrt(beta) for UniformRadius.  ``sample_td`` draws
dim-leading increments ``(dim, *batch_shape)`` for a whole batch, with a
per-rung beta vector broadcast over the rung axis (the first batch axis).
"""
from __future__ import annotations

import dataclasses
import math

import torch

from ..kernels.draws import laplace_increment
from ..utils.dtypes import as_tensor, default_float, resolve_device


def _expand(v: torch.Tensor, batch_ndim: int) -> torch.Tensor:
    """Per-beta scale (T,) -> (1, T, 1, ...) against (d, T, *B)."""
    return v.reshape((1,) + tuple(v.shape) + (1,) * (batch_ndim - v.ndim))


class Proposal:
    """Common surface: ``name``, ``dim``, ``sample`` / ``sample_td``,
    ``log_inc_density`` / ``log_q_ratio``."""

    name: str = "Proposal"

    def get_name(self) -> str:
        return self.name

    def sample(self, n: int, beta: float = 1.0,
               generator: torch.Generator | None = None):
        """``(n, dim)`` increments."""
        return torch.movedim(self.sample_td(generator, beta, (n,)), 0, -1)

    def log_q_ratio(self, inc, betas):
        """``log q(x|y) - log q(y|x)`` for the move ``y = x + inc``: zero for
        every symmetric increment density."""
        return (self.log_inc_density(-inc, betas)
                - self.log_inc_density(inc, betas))


@dataclasses.dataclass(frozen=True)
class NormalProposal(Proposal):
    """Isotropic Gaussian increments; effective variance =
    base_variance / beta."""

    dim: int
    base_variance_scalar: torch.Tensor   # ()
    name: str = "Normal"

    @classmethod
    def create(cls, dim: int, base_variance_scalar: float, *,
               device="cuda") -> "NormalProposal":
        if float(base_variance_scalar) <= 0:
            raise ValueError("base_variance_scalar must be positive")
        return cls(dim=dim, base_variance_scalar=torch.tensor(
            float(base_variance_scalar), dtype=default_float(),
            device=resolve_device(device)))

    def to(self, device=None, dtype=None) -> "NormalProposal":
        return dataclasses.replace(
            self, base_variance_scalar=self.base_variance_scalar.to(
                device=device, dtype=dtype))

    def _betas(self, betas):
        return torch.as_tensor(betas, dtype=self.base_variance_scalar.dtype,
                               device=self.base_variance_scalar.device)

    def sample_td(self, generator, betas, batch_shape):
        betas = self._betas(betas)
        dev = self.base_variance_scalar.device
        gdev = generator.device if generator is not None else dev
        z = torch.randn((self.dim,) + tuple(batch_shape), generator=generator,
                        device=gdev,
                        dtype=self.base_variance_scalar.dtype).to(dev)
        std = torch.sqrt(self.base_variance_scalar / betas)
        if std.ndim > 0:
            std = _expand(std, len(batch_shape))
        return z * std

    def log_inc_density(self, inc, betas):
        """log N(inc; 0, (base_variance/beta) I) reduced over dim."""
        var_eff = self.base_variance_scalar / self._betas(betas)
        sq = torch.sum(inc * inc, dim=0)
        if var_eff.ndim > 0:
            var_eff = var_eff.reshape(tuple(var_eff.shape)
                                      + (1,) * (sq.ndim - 1))
        return (-0.5 * self.dim * torch.log(2.0 * math.pi * var_eff)
                - 0.5 * sq / var_eff)


@dataclasses.dataclass(frozen=True)
class LaplaceProposal(Proposal):
    """Per-dimension Laplace increments by the reference's inverse CDF
    ``-scale * sign(U) * log1p(max(-2|U|, -0.999999))``, U ~ U(-0.5, 0.5);
    ``scale = sqrt((base_variance / beta) / 2)`` per coordinate, so an
    anisotropic variance vector reaches every coordinate."""

    dim: int
    base_variance_vector: torch.Tensor   # (d,)
    name: str = "Laplace"

    @classmethod
    def create(cls, dim: int, base_variance_vector, *,
               device="cuda") -> "LaplaceProposal":
        v = as_tensor(base_variance_vector, resolve_device(device),
                      default_float())
        if v.ndim == 0:
            v = torch.full((dim,), float(v), dtype=v.dtype, device=v.device)
        if tuple(v.shape) != (dim,):
            raise ValueError(f"base_variance_vector must have shape ({dim},),"
                             f" got {tuple(v.shape)}")
        if not bool(torch.all(v > 0)):
            raise ValueError("All elements of base_variance_vector must be "
                             "positive")
        return cls(dim=dim, base_variance_vector=v)

    def to(self, device=None, dtype=None) -> "LaplaceProposal":
        return dataclasses.replace(
            self, base_variance_vector=self.base_variance_vector.to(
                device=device, dtype=dtype))

    def _scale(self, betas, batch_ndim):
        """Laplace scale ``(d,)`` or ``(d, T)``, reshaped to broadcast
        against ``(d, *B)`` with ``batch_ndim`` batch axes."""
        v = self.base_variance_vector
        betas = torch.as_tensor(betas, dtype=v.dtype, device=v.device)
        var_eff = v[:, None] / betas if betas.ndim > 0 else v / betas
        scale = torch.sqrt(var_eff / 2.0)
        return scale.reshape(tuple(scale.shape)
                             + (1,) * (1 + batch_ndim - scale.ndim))

    def sample_td(self, generator, betas, batch_shape):
        v = self.base_variance_vector
        gdev = generator.device if generator is not None else v.device
        u = torch.rand((self.dim,) + tuple(batch_shape), generator=generator,
                       device=gdev, dtype=v.dtype).to(v.device)
        return laplace_increment(u, self._scale(betas, len(batch_shape)))

    def log_inc_density(self, inc, betas):
        """Product-Laplace log density reduced over dim."""
        scale = self._scale(betas, inc.ndim - 1)
        return torch.sum(-torch.log(2.0 * scale) - torch.abs(inc) / scale,
                         dim=0)


@dataclasses.dataclass(frozen=True)
class UniformRadiusProposal(Proposal):
    """Uniform increments in a d-ball: Gaussian direction over its norm,
    radius ``R_eff * U^(1/d)`` with ``R_eff = base_radius / sqrt(beta)``."""

    dim: int
    base_radius: torch.Tensor   # ()
    name: str = "UniformRadius"

    @classmethod
    def create(cls, dim: int, base_radius: float, *,
               device="cuda") -> "UniformRadiusProposal":
        if float(base_radius) <= 0:
            raise ValueError("base_radius must be positive")
        return cls(dim=dim, base_radius=torch.tensor(
            float(base_radius), dtype=default_float(),
            device=resolve_device(device)))

    def to(self, device=None, dtype=None) -> "UniformRadiusProposal":
        return dataclasses.replace(
            self, base_radius=self.base_radius.to(device=device, dtype=dtype))

    def _r_eff(self, betas):
        r = self.base_radius
        return r / torch.sqrt(torch.as_tensor(betas, dtype=r.dtype,
                                              device=r.device))

    def sample_td(self, generator, betas, batch_shape):
        r = self.base_radius
        gdev = generator.device if generator is not None else r.device
        shape = (self.dim,) + tuple(batch_shape)
        dirs = torch.randn(shape, generator=generator, device=gdev,
                           dtype=r.dtype).to(r.device)
        norms = torch.sqrt(torch.sum(dirs * dirs, dim=0, keepdim=True))
        dirs = dirs / torch.clamp_min(norms, 1e-12)
        u = torch.rand((1,) + tuple(batch_shape), generator=generator,
                       device=gdev, dtype=r.dtype).to(r.device)
        r_eff = self._r_eff(betas)
        if r_eff.ndim > 0:
            r_eff = _expand(r_eff, len(batch_shape))
        return dirs * (r_eff * torch.pow(u, 1.0 / self.dim))

    def log_inc_density(self, inc, betas):
        """Uniform-in-ball log density: ``-log Vol_d(R_eff)`` inside,
        ``-inf`` outside; reduced over dim."""
        d = self.dim
        norm = torch.sqrt(torch.sum(inc * inc, dim=0))
        r_eff = self._r_eff(betas)
        if r_eff.ndim > 0:
            r_eff = r_eff.reshape(tuple(r_eff.shape)
                                  + (1,) * (norm.ndim - 1))
        half_d = torch.tensor(0.5 * d + 1.0, dtype=norm.dtype,
                              device=norm.device)
        log_vol = (d * torch.log(r_eff) + 0.5 * d * math.log(math.pi)
                   - torch.lgamma(half_d))
        return torch.where(norm <= r_eff, -log_vol,
                           torch.full_like(log_vol, -math.inf))


def create_proposal_distribution(dim: int, proposal_config: dict, *,
                                 device="cuda") -> Proposal:
    """Proposal from a ``{"name": ..., "params": {...}}`` config, with the
    JAX factory's names, parameters and error messages."""
    name = proposal_config.get("name")
    params = proposal_config.get("params", {})
    if name == "Normal":
        v = params.get("base_variance_scalar")
        if v is None:
            raise ValueError("Normal proposal requires "
                             "'base_variance_scalar' parameter")
        return NormalProposal.create(dim, v, device=device)
    if name == "Laplace":
        v = params.get("base_variance_vector")
        if v is None:
            raise ValueError("Laplace proposal requires "
                             "'base_variance_vector' parameter")
        return LaplaceProposal.create(dim, v, device=device)
    if name == "UniformRadius":
        r = params.get("base_radius")
        if r is None:
            raise ValueError("UniformRadius proposal requires 'base_radius' "
                             "parameter")
        return UniformRadiusProposal.create(dim, r, device=device)
    raise ValueError(f"Unknown proposal distribution name: {name}")
