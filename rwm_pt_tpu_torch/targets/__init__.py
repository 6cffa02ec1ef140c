"""Targets of the port (every target of the JAX package) and the registry
``get_target_distribution``."""
from .base import TargetMixin
from .funnel import NealFunnel, SuperFunnel
from .gaussian import MultivariateNormal, ScaledMultivariateNormal
from .hypercube import Hypercube
from .iid import IIDBeta, IIDGamma
from .multimodal import RoughCarpet, ThreeMixture
from .registry import (PORTED_TARGETS, TARGET_NAMES,
                       calculate_hybrid_rosenbrock_dim,
                       calculate_super_funnel_dim, get_target_distribution)
from .rosenbrock import EvenRosenbrock, FullRosenbrock, HybridRosenbrock

__all__ = ["TargetMixin", "FullRosenbrock", "EvenRosenbrock",
           "HybridRosenbrock", "MultivariateNormal",
           "ScaledMultivariateNormal", "ThreeMixture", "RoughCarpet",
           "Hypercube", "IIDGamma", "IIDBeta", "NealFunnel", "SuperFunnel",
           "TARGET_NAMES", "PORTED_TARGETS",
           "calculate_hybrid_rosenbrock_dim", "calculate_super_funnel_dim",
           "get_target_distribution"]
