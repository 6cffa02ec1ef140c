"""Target registry (port of ``rwm_pt_tpu.targets.registry``).

``get_target_distribution(name, dim, variant=..., **kwargs)`` with the JAX
factory's names, defaults and ``variant`` check.  Ported so far:
``MultivariateNormal`` (mean/cov kwargs, identity by default) and
``FullRosenbrock`` (a = 1/20, b = 100/20, mu = 1).  Every other name the
JAX registry knows raises ``NotImplementedError`` (ROADMAP Queue A item 9);
an unknown name raises the JAX ``ValueError``.
"""
from __future__ import annotations

from .gaussian import MultivariateNormal
from .rosenbrock import FullRosenbrock

TARGET_NAMES = (
    "MultivariateNormal", "MultivariateNormalScaled",
    "RoughCarpet", "RoughCarpetScaled",
    "ThreeMixture", "ThreeMixtureScaled",
    "Hypercube", "IIDGamma", "IIDBeta",
    "FullRosenbrock", "EvenRosenbrock", "HybridRosenbrock",
    "NealFunnel", "SuperFunnel",
)
PORTED_TARGETS = ("MultivariateNormal", "FullRosenbrock")
_VARIANTS = ("rwm_gpu", "pt_gpu", "cpu", "class")


def get_target_distribution(name: str, dim: int, variant: str = "rwm_gpu",
                            *, device="cuda", **kwargs):
    """Build a target by CLI name with the reference's factory defaults.
    ``variant`` selects a multimodal constant set in the JAX registry; it is
    checked here and changes nothing for the ported targets."""
    if variant not in _VARIANTS:
        raise ValueError(f"Unknown variant {variant!r}; expected one of "
                         f"{_VARIANTS}")
    if name == "MultivariateNormal":
        return MultivariateNormal.create(dim, mean=kwargs.get("mean"),
                                         cov=kwargs.get("cov"), device=device)
    if name == "FullRosenbrock":
        return FullRosenbrock.create(dim, a_coeff=kwargs.get("a_coeff", 1 / 20),
                                     b_coeff=kwargs.get("b_coeff", 100 / 20),
                                     mu=kwargs.get("mu", 1.0), device=device)
    if name in TARGET_NAMES:
        raise NotImplementedError(
            f"target {name!r} is not ported to the PyTorch package yet "
            f"(ROADMAP Queue A item 9); ported: {PORTED_TARGETS}")
    raise ValueError(f"Unknown target distribution name: {name!r}. "
                     f"Known names: {TARGET_NAMES}")
