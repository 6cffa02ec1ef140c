"""Funnel targets (port of ``rwm_pt_tpu.targets.funnel``): Neal's funnel
and ``SuperFunnel``, the hierarchical logistic regression, the one target
conditioned on data.  ``SuperFunnel.create_synthetic`` draws its dataset
from JAX's threefry streams under the seed (``utils/threefry.py``), so one
seed builds the JAX package's dataset.
"""
from __future__ import annotations

import dataclasses
import math

import numpy as np
import torch

from ..utils import threefry
from ..utils.dtypes import default_float, resolve_device
from .base import TargetMixin, bdim, sum0

_LOG_2PI = math.log(2.0 * math.pi)


@dataclasses.dataclass(frozen=True)
class NealFunnel(TargetMixin):
    """v ~ N(mu_v, sigma_v^2), z_k | v ~ N(mu_z, e^v):
    log p = -0.5 log 2 pi - 0.5 log sigma_v^2 - 0.5 (v - mu_v)^2 / sigma_v^2
            - 0.5 (d-1) log 2 pi - 0.5 (d-1) v - 0.5 e^{-v} sum (z_k - mu_z)^2.
    """

    dim: int
    mu_v: torch.Tensor        # ()
    sigma_v_sq: torch.Tensor  # ()
    mu_z: torch.Tensor        # ()
    name: str = "NealFunnel"

    @classmethod
    def create(cls, dim: int, mu_v: float = 0.0, sigma_v_sq: float = 9.0,
               mu_z: float = 0.0, *, device="cuda") -> "NealFunnel":
        if dim < 1:
            raise ValueError("dim must be at least 1 for Neal's Funnel.")
        if sigma_v_sq <= 0:
            raise ValueError("sigma_v_sq must be positive.")
        dev = resolve_device(device)
        f = default_float()
        return cls(dim=dim, mu_v=torch.tensor(mu_v, dtype=f, device=dev),
                   sigma_v_sq=torch.tensor(sigma_v_sq, dtype=f, device=dev),
                   mu_z=torch.tensor(mu_z, dtype=f, device=dev))

    def log_density_td(self, x: torch.Tensor) -> torch.Tensor:
        v = x[0]
        log_prior_v = (-0.5 * _LOG_2PI - 0.5 * torch.log(self.sigma_v_sq)
                       - 0.5 * (v - self.mu_v) ** 2 / self.sigma_v_sq)
        if self.dim == 1:
            return log_prior_v
        sum_sq = sum0((x[1:] - self.mu_z) ** 2)     # in the kernels' order
        d1 = self.dim - 1
        log_lik = (-0.5 * d1 * _LOG_2PI - 0.5 * d1 * v
                   - 0.5 * torch.exp(-v) * sum_sq)
        return log_prior_v + log_lik

    def get_name(self) -> str:
        return f"{self.name}_D{self.dim}"

    def stream_sample(self, stream, n: int, beta: torch.Tensor,
                      matmul_precision: str = "float32"):
        """The exact tempered sampler from the normals z of slots 0 .. d-1:
        v = (mu_v + ((1 - beta)(d-1)) sigma_v^2 / (2 beta)) + sqrt(sigma_v^2
        / beta) z_0, then z_k' = mu_z + (exp(v / 2) / sqrt(beta)) z_k."""
        z = stream.normals(self.dim)
        mean_v = self.mu_v + ((1.0 - beta) * float(self.dim - 1)
                              * self.sigma_v_sq) / (2.0 * beta)
        v = mean_v + torch.sqrt(self.sigma_v_sq / beta) * z[:, 0]
        if self.dim == 1:
            return v[:, None]
        zz = self.mu_z + (torch.exp(v / 2.0) / torch.sqrt(beta))[:, None] \
            * z[:, 1:]
        return torch.cat([v[:, None], zz], dim=1)

    def marginal_density(self, axis: int, xs):
        """v's marginal is N(mu_v, sigma_v^2); a z coordinate's is the 1-D
        integral E_v[N(z | mu_z, e^v)], by 64-node Gauss-Hermite
        quadrature over v."""
        xs = torch.as_tensor(xs, dtype=self.dtype, device=self.device)
        if axis == 0:
            xc = xs - self.mu_v
            return (torch.exp(-0.5 * xc * xc / self.sigma_v_sq)
                    / torch.sqrt(2.0 * math.pi * self.sigma_v_sq))
        t, w = np.polynomial.hermite.hermgauss(64)
        t = torch.as_tensor(t, dtype=self.dtype, device=self.device)
        w = torch.as_tensor(w, dtype=self.dtype, device=self.device)
        v = self.mu_v + torch.sqrt(2.0 * self.sigma_v_sq) * t
        var_z = torch.exp(v)[:, None]
        zc = xs[None, :] - self.mu_z
        comp = torch.exp(-0.5 * zc * zc / var_z) / torch.sqrt(
            2.0 * math.pi * var_z)
        return torch.sum(w[:, None] * comp, dim=0) / math.sqrt(math.pi)


def _softplus(v: torch.Tensor) -> torch.Tensor:
    """``jnp.logaddexp(v, 0)``: max(v, 0) + log1p(exp(-|v|)), v + 0 where
    v is NaN."""
    return torch.where(torch.isnan(v), v + 0.0,
                       torch.clamp_min(v, 0.0)
                       + torch.log1p(torch.exp(-torch.abs(v))))


def log_sigmoid(v: torch.Tensor) -> torch.Tensor:
    """``jax.nn.log_sigmoid``: -softplus(-v)."""
    return -_softplus(-v)


@dataclasses.dataclass(frozen=True)
class SuperFunnel(TargetMixin):
    """Hierarchical logistic-regression posterior.  The state is
    (alphas (J), betas (J K, row j K + k), mu_alpha, mu_beta (K),
    tau_alpha, tau_beta), d = J + J K + 1 + K + 2; alpha_j ~ N(mu_alpha,
    tau_alpha^2), beta_jk ~ N(mu_beta_k, tau_beta^2), the hypermeans
    ~ N(0, prior_hypermean_std^2), the taus ~ HalfCauchy(prior_tau_scale),
    and Y_jn ~ Bernoulli(sigmoid(alpha_j + sum_k X_jnk beta_jk)).  The
    design is kept as ``X_cols`` (J K, n), row j K + k = X[j, :, k], as
    the JAX package keeps it.  There is no direct sampler."""

    dim: int
    J: int
    K: int
    X_cols: torch.Tensor               # (J K, n)
    Y: torch.Tensor                    # (J, n)
    prior_hypermean_std: torch.Tensor  # ()
    prior_tau_scale: torch.Tensor      # ()
    name: str = "SuperFunnel"

    @classmethod
    def create(cls, J: int, K: int, X_data, Y_data,
               prior_hypermean_std: float = 10.0,
               prior_tau_scale: float = 2.5, *,
               device="cuda") -> "SuperFunnel":
        """From the design ``X_data`` (J, n, K) and the labels ``Y_data``
        (J, n)."""
        dev = resolve_device(device)
        f = default_float()
        X = torch.as_tensor(np.array(X_data)).to(dev, f)
        Y = torch.as_tensor(np.array(Y_data)).to(dev, f)
        if X.ndim != 3 or X.shape[0] != J or X.shape[2] != K:
            raise ValueError(f"X_data must have shape (J={J}, n, K={K}), "
                             f"got {tuple(X.shape)}")
        if Y.shape != X.shape[:2]:
            raise ValueError(f"Y_data must have shape {tuple(X.shape[:2])}, "
                             f"got {tuple(Y.shape)}")
        return cls(dim=J + J * K + 1 + K + 1 + 1, J=J, K=K,
                   X_cols=X.permute(0, 2, 1).reshape(J * K, X.shape[1])
                   .contiguous(), Y=Y,
                   prior_hypermean_std=torch.tensor(prior_hypermean_std,
                                                    dtype=f, device=dev),
                   prior_tau_scale=torch.tensor(prior_tau_scale, dtype=f,
                                                device=dev))

    @classmethod
    def create_synthetic(cls, J: int = 5, K: int = 3, n_per_group: int = 20,
                         prior_hypermean_std: float = 10.0,
                         prior_tau_scale: float = 2.5, seed: int = 42, *,
                         device="cuda") -> "SuperFunnel":
        """The JAX package's synthetic dataset: X ~ N(0, 1) of shape
        (J, n, K) and Y ~ Bernoulli(sigmoid(0.5 sum_k X_k)), on the two
        keys split from ``jax.random.key(seed)``."""
        kx, ky = threefry.split(seed)
        X = threefry.normal(kx, (J, n_per_group, K))
        s = X[..., 0]
        for k in range(1, K):        # XLA's order: covariate by covariate
            s = s + X[..., k]
        logits = torch.from_numpy(np.float32(0.5) * s)
        Y = threefry.bernoulli(ky, torch.sigmoid(logits).numpy())
        return cls.create(J, K, X, Y.astype(np.float32), prior_hypermean_std,
                          prior_tau_scale, device=device)

    def _parse_theta(self, x: torch.Tensor):
        """(alphas (J, *B), betas (J K, *B), mu_alpha, mu_beta (K, *B),
        tau_alpha, tau_beta) of the dim-leading state."""
        J, K = self.J, self.K
        i = J + J * K
        return (x[:J], x[J:i], x[i], x[i + 1:i + 1 + K], x[i + 1 + K],
                x[i + 2 + K])

    def log_density_td(self, x: torch.Tensor) -> torch.Tensor:
        """The JAX formula in its order, every sum in index order
        (``sum0``, the kernels' order): the likelihood group by group, the
        priors of the alphas, betas, hypermeans and taus; -inf unless both
        taus exceed 1e-9 (computed with them at 1 there)."""
        alphas, betas, mu_a, mu_b, tau_a, tau_b = self._parse_theta(x)
        J, K = self.J, self.K
        valid = (tau_a > 1e-9) & (tau_b > 1e-9)
        ta = torch.where(valid, tau_a, 1.0)
        tb = torch.where(valid, tau_b, 1.0)
        ll = 0.0
        for j in range(J):
            eta = alphas[j][None]
            for k in range(K):
                jk = j * K + k
                eta = eta + bdim(self.X_cols[jk], x) * betas[jk][None]
            yj = bdim(self.Y[j], x)
            ll = ll + sum0(yj * log_sigmoid(eta)
                           + (1 - yj) * log_sigmoid(-eta))
        da = alphas - mu_a[None]
        lp_alpha = (-0.5 * J * _LOG_2PI - J * torch.log(ta)
                    - 0.5 * sum0(da * da) / (ta * ta))
        db = betas - mu_b.repeat((J,) + (1,) * (mu_b.ndim - 1))
        lp_beta = (-0.5 * J * K * _LOG_2PI - J * K * torch.log(tb)
                   - 0.5 * sum0(db * db) / (tb * tb))
        hv = self.prior_hypermean_std * self.prior_hypermean_std
        lp_mu_a = (-0.5 * _LOG_2PI - 0.5 * torch.log(hv)
                   - 0.5 * (mu_a * mu_a) / hv)
        lp_mu_b = (-0.5 * K * _LOG_2PI - 0.5 * K * torch.log(hv)
                   - 0.5 * sum0(mu_b * mu_b) / hv)
        s = self.prior_tau_scale
        lc = math.log(2.0) - math.log(math.pi) - torch.log(s)
        qa, qb = ta / s, tb / s
        lp_tau = lc - torch.log1p(qa * qa) + lc - torch.log1p(qb * qb)
        total = ll + lp_alpha + lp_beta + lp_mu_a + lp_mu_b + lp_tau
        return torch.where(valid, total, -torch.inf)

    def get_name(self) -> str:
        return f"{self.name}_J{self.J}_K{self.K}"

    def direct_sample(self, n: int, beta: float = 1.0,
                      generator: torch.Generator | None = None):
        raise NotImplementedError(
            f"{self.get_name()} has no direct sampler (nor has the "
            "reference's); use a geometric or manual temperature ladder.")
