"""Targets ported so far: ``FullRosenbrock`` and ``MultivariateNormal``."""
from .base import TargetMixin
from .gaussian import MultivariateNormal
from .rosenbrock import FullRosenbrock

__all__ = ["TargetMixin", "FullRosenbrock", "MultivariateNormal"]
