"""Uniform hypercube target (port of ``rwm_pt_tpu.targets.hypercube``)."""
from __future__ import annotations

import dataclasses

import torch

from ..utils.dtypes import default_float, resolve_device
from .base import TargetMixin, _draw_uniform


@dataclasses.dataclass(frozen=True)
class Hypercube(TargetMixin):
    """Uniform on ``[left, right]^d``: ``-d log(right - left)`` inside,
    ``-inf`` outside (all or nothing over the coordinates)."""

    dim: int
    left: torch.Tensor                  # ()
    right: torch.Tensor                 # ()
    log_uniform_density: torch.Tensor   # ()
    name: str = "Hypercube"

    @classmethod
    def create(cls, dim: int, left_boundary: float = 0.0,
               right_boundary: float = 1.0, *, device="cuda") -> "Hypercube":
        dev = resolve_device(device)
        f = default_float()
        lo = torch.tensor(left_boundary, dtype=f, device=dev)
        hi = torch.tensor(right_boundary, dtype=f, device=dev)
        return cls(dim=dim, left=lo, right=hi,
                   log_uniform_density=-dim * torch.log(hi - lo))

    def log_density_td(self, x: torch.Tensor) -> torch.Tensor:
        within = torch.all((x >= self.left) & (x <= self.right), dim=0)
        return torch.where(within, self.log_uniform_density,
                           torch.full_like(within, -torch.inf, dtype=x.dtype))

    def stream_sample(self, stream, n: int, beta: torch.Tensor,
                      matmul_precision: str = "float32"):
        """x = u (right - left) + left, u the uniforms of slots 0 .. d-1."""
        return (stream.uniforms(0, self.dim) * (self.right - self.left)
                + self.left)

    def init_sample(self, n: int, generator: torch.Generator | None = None):
        """Start at 20-80 % of the box, inside the support."""
        u = _draw_uniform((n, self.dim), generator, self.device, self.dtype,
                          0.2, 0.8)
        return u * (self.right - self.left) + self.left

    def marginal_density(self, axis: int, xs):
        x = torch.as_tensor(xs, dtype=self.dtype, device=self.device)
        inside = (x >= self.left) & (x <= self.right)
        return torch.where(inside, 1.0 / (self.right - self.left),
                           torch.zeros_like(x))
