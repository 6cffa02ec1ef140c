"""Carry parameters and sampler states between the JAX package and the port.

Everything crosses as numpy arrays under the JAX dataclass field names, so
a JAX checkpoint (``PTState``/``RWMState`` fields) resumes on the port and
a port state resumes on JAX.  Nothing here imports JAX.
"""
from __future__ import annotations

import dataclasses

import numpy as np
import torch

from .kernels.pt import PTState
from .kernels.rwm import RWMState
from .proposals import (LaplaceProposal, NormalProposal,
                        UniformRadiusProposal)
from .targets import (EvenRosenbrock, FullRosenbrock, HybridRosenbrock,
                      Hypercube, IIDBeta, IIDGamma, MultivariateNormal,
                      NealFunnel, RoughCarpet, ScaledMultivariateNormal,
                      SuperFunnel, ThreeMixture)
from .utils.dtypes import resolve_device

# state fields in the JAX dataclasses' order (also the checkpoint's arr_0..)
PT_FIELDS = ("x", "logp", "accept_count", "swap_attempt_count",
              "swap_accept_count", "sum_beta_sq_jump", "sum_sq_jump_cold",
              "step")
RWM_FIELDS = ("x", "logp", "accept_count", "sum_sq_jump", "step")
_INT_FIELDS = ("step", "swap_attempt_count")


def _t(v, dev) -> torch.Tensor:
    return torch.as_tensor(np.array(v)).to(dev)


_TARGETS = {cls.__name__: cls for cls in (
    FullRosenbrock, EvenRosenbrock, HybridRosenbrock, MultivariateNormal,
    ScaledMultivariateNormal, ThreeMixture, RoughCarpet, Hypercube,
    IIDGamma, IIDBeta, NealFunnel, SuperFunnel)}


def target_from_numpy(name: str, fields: dict, *, device="cuda"):
    """The port's target of class ``name`` (the JAX class name, e.g.
    ``"ThreeMixture"``) from the JAX dataclass fields as numpy arrays and
    Python values.  ``dim`` may be left out for ``FullRosenbrock``,
    ``EvenRosenbrock`` (``mu`` has d-1 entries) and ``MultivariateNormal``
    (from ``mean``) and ``SuperFunnel`` (from ``J`` and ``K``); ``name``
    keeps the class default when left out."""
    cls = _TARGETS.get(name)
    if cls is None:
        raise NotImplementedError(f"target {name!r} is not ported yet")
    dev = resolve_device(device)
    kw = {}
    for f in dataclasses.fields(cls):
        if f.name not in fields:
            continue
        v = fields[f.name]
        if f.type in ("int", int):
            kw[f.name] = int(np.asarray(v))
        elif f.type in ("bool", bool):
            kw[f.name] = bool(np.asarray(v))
        elif f.type in ("str", str):
            kw[f.name] = str(v)
        else:
            kw[f.name] = _t(v, dev)
    if "dim" not in kw:
        kw["dim"] = (kw["mean"].shape[0] if name == "MultivariateNormal"
                     else kw["J"] + kw["J"] * kw["K"] + kw["K"] + 3
                     if name == "SuperFunnel"
                     else kw["mu"].reshape(-1).shape[0] + 1)
    if "mu" in kw and name != "HybridRosenbrock":
        kw["mu"] = kw["mu"].reshape(-1)
    return cls(**kw)


def target_to_numpy(target) -> dict:
    """Every dataclass field of a port target, tensors as numpy arrays (the
    JAX dataclass field names, so ``Cls(**fields)`` rebuilds a JAX
    target)."""
    out = {}
    for f in dataclasses.fields(target):
        v = getattr(target, f.name)
        out[f.name] = (v.detach().cpu().numpy()
                       if isinstance(v, torch.Tensor) else v)
    return out


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
