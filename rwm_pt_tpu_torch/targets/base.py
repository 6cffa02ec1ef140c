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


def sum0(t: torch.Tensor) -> torch.Tensor:
    """Sum over axis 0 in index order, ((t0 + t1) + t2) + ..: the order in
    which the fused kernels (``csrc/targets.cuh``) add a log-density's
    terms.  The targets whose terms differ in sign (IIDGamma, IIDBeta,
    NealFunnel) sum with it, so that a log-density near 0, where the terms
    cancel, rounds as the kernel's does."""
    acc = t[0]
    for i in range(1, t.shape[0]):
        acc = acc + t[i]
    return acc


def round_operand(t: torch.Tensor, matmul_precision: str) -> torch.Tensor:
    """A matmul operand at ``matmul_precision``: itself under "float32",
    rounded to bfloat16 (and held in float32, so that the products are
    exact and accumulate in float32) under "bfloat16"."""
    if matmul_precision == "float32":
        return t
    if matmul_precision == "bfloat16":
        return t.to(torch.bfloat16).to(t.dtype)
    raise ValueError(f"matmul_precision must be 'float32' or 'bfloat16', "
                     f"not {matmul_precision!r}")


def categorical_index(u: torch.Tensor, cum_weights: torch.Tensor):
    """Index k of each uniform ``u`` against the float32 cumulative
    weights of three categories: the count of ``cum_weights[:2]`` at or
    below ``u``."""
    return ((u >= cum_weights[0]).to(torch.int64)
            + (u >= cum_weights[1]).to(torch.int64))


def _gen_device(generator, device):
    return generator.device if generator is not None else device


def _draw_normal(shape, generator, device, dtype):
    """Standard normals from ``generator`` (on the generator's own device),
    moved to ``device``."""
    return torch.randn(shape, generator=generator,
                       device=_gen_device(generator, device),
                       dtype=dtype).to(device)


def _draw_uniform(shape, generator, device, dtype, lo=0.0, hi=1.0):
    """U[lo, hi) from ``generator``, moved to ``device``."""
    u = torch.rand(shape, generator=generator,
                   device=_gen_device(generator, device), dtype=dtype)
    return (u * (hi - lo) + lo).to(device)


def _draw_gamma(alpha, shape, generator, device, dtype):
    """Gamma(alpha, 1) variates of ``shape`` (``alpha`` a scalar tensor)."""
    a = alpha.to(_gen_device(generator, device), dtype).expand(shape)
    return torch._standard_gamma(a.contiguous(), generator=generator).to(
        device)


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
        """``(n, dim)`` exact draws from the beta-tempered target in the
        target's dtype: :meth:`stream_sample` (in float32) on the words of
        a ladder stream keyed by one draw of ``generator`` (torch's
        default generator when None).  A target without a direct sampler
        raises ``NotImplementedError``."""
        from ..kernels.draws import ProbeStream, resolve_seed, seed_key
        seed = resolve_seed(generator if generator is not None
                            else torch.default_generator)
        f32 = self if self.dtype == torch.float32 else self.to(
            dtype=torch.float32)
        x = f32.stream_sample(ProbeStream(seed_key(seed), 1, 0, n,
                                          self.device), n,
                              torch.tensor(float(beta), dtype=torch.float32,
                                           device=self.device))
        return x.to(self.dtype)

    def stream_sample(self, stream, n: int, beta: torch.Tensor,
                      matmul_precision: str = "float32"):
        """``(n, dim)`` draws from the beta-tempered target from the
        Philox words of one side of an iterative-ladder probe
        (``kernels/draws.py::ProbeStream``) at the float32 0-d ``beta``,
        in the arithmetic ``csrc/ladder_build.cu`` repeats on the card."""
        raise NotImplementedError(
            f"{self.get_name()} has no direct sampler; use a geometric or "
            "manual temperature ladder.")

    def marginal_density(self, axis: int, xs):
        """Exact 1-D marginal density along coordinate ``axis`` at the
        points ``xs`` ``(n,)``, or None where it is intractable."""
        return None

    def init_sample(self, n: int, generator: torch.Generator | None = None):
        """Initial chain states ``(n, dim)``: ``1e-8 * N(0, I)``."""
        return 1e-8 * _draw_normal((n, self.dim), generator, self.device,
                                   self.dtype)
