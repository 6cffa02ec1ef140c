"""Carry parameters and sampler states between the JAX package and the port.

Everything crosses as numpy arrays under the JAX dataclass field names, so
a JAX checkpoint (``PTState``/``RWMState`` fields) resumes on the port and
a port state resumes on JAX.  Nothing here imports JAX.
"""
from __future__ import annotations

import numpy as np
import torch

from .kernels.pt import PTState
from .kernels.rwm import RWMState
from .proposals import (LaplaceProposal, NormalProposal,
                        UniformRadiusProposal)
from .targets import FullRosenbrock, MultivariateNormal
from .utils.dtypes import resolve_device

# state fields in the JAX dataclasses' order (also the checkpoint's arr_0..)
PT_FIELDS = ("x", "logp", "accept_count", "swap_attempt_count",
              "swap_accept_count", "sum_beta_sq_jump", "sum_sq_jump_cold",
              "step")
RWM_FIELDS = ("x", "logp", "accept_count", "sum_sq_jump", "step")
_INT_FIELDS = ("step", "swap_attempt_count")


def _t(v, dev) -> torch.Tensor:
    return torch.as_tensor(np.array(v)).to(dev)


def target_from_numpy(name: str, fields: dict, *, device="cuda"):
    """``FullRosenbrock`` (``a_coeff``, ``b_coeff``, ``mu``) or
    ``MultivariateNormal`` (``mean``, ``cov``, ``cov_inv``, ``chol``,
    ``log_norm_const``, ``iso``) from the JAX dataclass fields."""
    dev = resolve_device(device)
    if name == "FullRosenbrock":
        mu = _t(fields["mu"], dev).reshape(-1)
        return FullRosenbrock(dim=mu.shape[0] + 1,
                              a_coeff=_t(fields["a_coeff"], dev),
                              b_coeff=_t(fields["b_coeff"], dev), mu=mu)
    if name == "MultivariateNormal":
        mean = _t(fields["mean"], dev)
        return MultivariateNormal(
            dim=mean.shape[0], iso=bool(fields["iso"]), mean=mean,
            cov=_t(fields["cov"], dev), cov_inv=_t(fields["cov_inv"], dev),
            chol=_t(fields["chol"], dev),
            log_norm_const=_t(fields["log_norm_const"], dev))
    raise NotImplementedError(f"target {name!r} is not ported yet")


def proposal_from_numpy(name: str, fields: dict, *, dim: int,
                        device="cuda"):
    """A proposal from its JAX fields: ``NormalProposal``
    (``base_variance_scalar``), ``LaplaceProposal``
    (``base_variance_vector``) or ``UniformRadiusProposal``
    (``base_radius``)."""
    dev = resolve_device(device)
    if name == "Normal":
        return NormalProposal(dim=dim, base_variance_scalar=_t(
            fields["base_variance_scalar"], dev))
    if name == "Laplace":
        return LaplaceProposal(dim=dim, base_variance_vector=_t(
            fields["base_variance_vector"], dev).reshape(dim))
    if name == "UniformRadius":
        return UniformRadiusProposal(dim=dim, base_radius=_t(
            fields["base_radius"], dev))
    raise NotImplementedError(f"proposal {name!r} is not ported yet")


def _state_from_numpy(cls, names, fields, device):
    dev = resolve_device(device)
    kw = {}
    for k in names:
        if k in _INT_FIELDS:
            kw[k] = int(np.asarray(fields[k]))
        else:
            kw[k] = _t(fields[k], dev)
    return cls(**kw)


def _state_to_numpy(state, names) -> dict:
    out = {}
    for k in names:
        v = getattr(state, k)
        out[k] = (np.asarray(v, np.int32) if k in _INT_FIELDS
                  else v.detach().cpu().numpy())
    return out


def pt_state_from_numpy(fields: dict, *, device="cuda") -> PTState:
    """``PTState`` from the JAX ``PTState`` fields as numpy arrays."""
    return _state_from_numpy(PTState, PT_FIELDS, fields, device)


def pt_state_to_numpy(state: PTState) -> dict:
    """JAX ``PTState`` fields of a port state, as numpy arrays (the counters
    ``step`` and ``swap_attempt_count`` as 0-d int32)."""
    return _state_to_numpy(state, PT_FIELDS)


def rwm_state_from_numpy(fields: dict, *, device="cuda") -> RWMState:
    """``RWMState`` from the JAX ``RWMState`` fields as numpy arrays."""
    return _state_from_numpy(RWMState, RWM_FIELDS, fields, device)


def rwm_state_to_numpy(state: RWMState) -> dict:
    """JAX ``RWMState`` fields of a port state, as numpy arrays."""
    return _state_to_numpy(state, RWM_FIELDS)
