"""Dtype and device helpers, and the profiling utilities (``profiling``)."""
from .dtypes import as_tensor, default_float, resolve_device, set_x64
from .profiling import (DeviceTimer, force, memory_stats, profile_trace,
                        throughput_forensics)

__all__ = ["as_tensor", "default_float", "resolve_device", "set_x64",
           "DeviceTimer", "force", "memory_stats", "profile_trace",
           "throughput_forensics"]
