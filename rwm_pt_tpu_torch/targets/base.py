"""Target-distribution surface of the PyTorch port.

Mirrors ``rwm_pt_tpu.targets.base.TargetMixin``.  A target is a plain class
holding its parameters as tensors on one device.  The samplers keep the
state dim-leading, ``(dim, *batch)`` with the chain axis minor-most, so every
target implements :meth:`log_density_td` reducing over axis 0; the
user-facing :meth:`log_density` takes the conventional ``(..., dim)`` layout.
"""
from __future__ import annotations

import dataclasses

import torch


def bdim(p: torch.Tensor, x: torch.Tensor) -> torch.Tensor:
    """Broadcast a per-dimension parameter vector ``(d,)`` against
    ``(d, *batch)``."""
    return p.reshape(p.shape + (1,) * (x.ndim - 1))


def _draw_normal(shape, generator, device, dtype):
    """Standard normals from ``generator`` (on the generator's own device),
    moved to ``device``."""
    gdev = generator.device if generator is not None else device
    return torch.randn(shape, generator=generator, device=gdev,
                       dtype=dtype).to(device)


class TargetMixin:
    """Shared behaviour of the port's targets (``log_density``, ``density``,
    ``init_sample``, ``direct_sample``).  Concrete targets are dataclasses
    whose tensor fields all live on one device."""

    name: str = "Target"

    @property
    def device(self) -> torch.device:
        for f in dataclasses.fields(self):
            v = getattr(self, f.name)
            if isinstance(v, torch.Tensor):
                return v.device
        return torch.device("cpu")

    @property
    def dtype(self) -> torch.dtype:
        for f in dataclasses.fields(self):
            v = getattr(self, f.name)
            if isinstance(v, torch.Tensor) and v.is_floating_point():
                return v.dtype
        return torch.float32

    def to(self, device=None, dtype=None):
        """Copy of the target with every tensor field moved (and floating
        fields cast to ``dtype`` when given)."""
        changes = {}
        for f in dataclasses.fields(self):
            v = getattr(self, f.name)
            if isinstance(v, torch.Tensor):
                changes[f.name] = v.to(
                    device=device,
                    dtype=dtype if (dtype is not None
                                    and v.is_floating_point()) else None)
        return dataclasses.replace(self, **changes)

    def log_density(self, x: torch.Tensor) -> torch.Tensor:
        """Log density at ``x`` of shape ``(dim,)`` or ``(..., dim)``."""
        return self.log_density_td(torch.movedim(x, -1, 0))

    def density(self, x: torch.Tensor) -> torch.Tensor:
        return torch.exp(self.log_density(x))

    def get_name(self) -> str:
        return self.name

    def log_density_td(self, x: torch.Tensor) -> torch.Tensor:  # pragma: no cover
        """Log density with dim-leading layout ``(dim, *batch) -> (*batch)``."""
        raise NotImplementedError

    def direct_sample(self, n: int, beta: float = 1.0,
                      generator: torch.Generator | None = None):
        """``(n, dim)`` exact draws from the beta-tempered target."""
        raise NotImplementedError(
            f"{self.get_name()} has no direct sampler; use a geometric or "
            "manual temperature ladder.")

    def init_sample(self, n: int, generator: torch.Generator | None = None):
        """Initial chain states ``(n, dim)``: ``1e-8 * N(0, I)``."""
        return 1e-8 * _draw_normal((n, self.dim), generator, self.device,
                                   self.dtype)
