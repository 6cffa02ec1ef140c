"""Targets ported so far: ``FullRosenbrock`` and ``MultivariateNormal``,
and the registry ``get_target_distribution``."""
from .base import TargetMixin
from .gaussian import MultivariateNormal
from .registry import TARGET_NAMES, get_target_distribution
from .rosenbrock import FullRosenbrock

__all__ = ["TargetMixin", "FullRosenbrock", "MultivariateNormal",
           "TARGET_NAMES", "get_target_distribution"]
