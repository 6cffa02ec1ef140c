"""Proposal increment distributions (port of
``rwm_pt_tpu.proposals.proposals``: the ``Proposal`` base and
``NormalProposal``).

Proposals are symmetric, state-independent increment distributions.
Temperature enters through the variance/beta law.  ``sample_td`` draws
dim-leading increments ``(dim, *batch_shape)`` for a whole batch, with a
per-rung beta vector broadcast over the rung axis (the first batch axis).
"""
from __future__ import annotations

import dataclasses
import math

import torch

from ..utils.dtypes import default_float, resolve_device


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
