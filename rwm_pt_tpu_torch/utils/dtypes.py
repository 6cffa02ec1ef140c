"""Float precision and device selection for the PyTorch port.

``default_float()`` mirrors ``rwm_pt_tpu.utils.dtypes.default_float``: float32
unless the port-level double-precision switch is on (the JAX package reads
``jax_enable_x64``; here :func:`set_x64` flips the same choice).  The fused
CUDA kernels are float32-only, like the Pallas kernels they replace.

``resolve_device`` is how every entry point turns its ``device=`` argument
into a ``torch.device``: asking for ``"cuda"`` on a machine without a card
raises instead of quietly running on the CPU.
"""
from __future__ import annotations

import numpy as np
import torch

from ..parallel.mesh import ShardedTensor

_X64 = False


def set_x64(enabled: bool = True) -> None:
    """Port-level switch: make :func:`default_float` return float64."""
    global _X64
    _X64 = bool(enabled)


def default_float() -> torch.dtype:
    """torch.float64 when :func:`set_x64` is on, else torch.float32."""
    return torch.float64 if _X64 else torch.float32


def resolve_device(device) -> torch.device:
    """``torch.device`` for ``device``; raises when CUDA is asked for and no
    card is present (entry points never fall back to the CPU)."""
    dev = torch.device(device)
    if dev.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError(
            f"device={str(device)!r} requested but torch.cuda.is_available() "
            "is False; pass device='cpu' to run the plain PyTorch path")
    return dev


def as_tensor(value, device, dtype) -> torch.Tensor:
    """``value`` (tensor, numpy array, list or scalar, or a mesh's
    ``ShardedTensor``, gathered) as a tensor on ``device`` of ``dtype``;
    array inputs are copied, so read-only arrays (JAX exports) are safe to
    hand in."""
    if isinstance(value, ShardedTensor):
        value = value.gather(device)
    elif not isinstance(value, torch.Tensor):
        value = torch.tensor(np.array(value))
    return value.to(device, dtype)
