"""Dtype and device helpers."""
from .dtypes import as_tensor, default_float, resolve_device, set_x64

__all__ = ["as_tensor", "default_float", "resolve_device", "set_x64"]
