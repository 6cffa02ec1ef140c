"""Targets of the port (every JAX target but ``SuperFunnel``) and the
registry ``get_target_distribution``."""
from .base import TargetMixin
from .funnel import NealFunnel
from .gaussian import MultivariateNormal, ScaledMultivariateNormal
from .hypercube import Hypercube
from .iid import IIDBeta, IIDGamma
from .multimodal import RoughCarpet, ThreeMixture
from .registry import (PORTED_TARGETS, TARGET_NAMES,
                       calculate_hybrid_rosenbrock_dim,
                       get_target_distribution)
from .rosenbrock import EvenRosenbrock, FullRosenbrock, HybridRosenbrock

__all__ = ["TargetMixin", "FullRosenbrock", "EvenRosenbrock",
           "HybridRosenbrock", "MultivariateNormal",
           "ScaledMultivariateNormal", "ThreeMixture", "RoughCarpet",
           "Hypercube", "IIDGamma", "IIDBeta", "NealFunnel", "TARGET_NAMES",
           "PORTED_TARGETS", "calculate_hybrid_rosenbrock_dim",
           "get_target_distribution"]
