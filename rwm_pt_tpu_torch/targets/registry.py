"""Target registry (port of ``rwm_pt_tpu.targets.registry``).

``get_target_distribution(name, dim, variant=..., **kwargs)`` with the JAX
factory's names, defaults and ``variant`` constants: the multimodal
targets' modes differ between the reference's factories, and ``variant``
picks a set (``"rwm_gpu"``: RoughCarpet modes +-4, ThreeMixture offsets
+-5; ``"pt_gpu"`` and ``"cpu"``: +-15 and +-15; ``"class"``: +-5 and
+-5).  Explicit ``mode_centers``/``mode_weights`` always win.  Every JAX
name is ported (:data:`PORTED_TARGETS` is :data:`TARGET_NAMES`);
``SuperFunnel`` takes its structure from ``J``, ``K`` and
``n_per_group`` and ignores ``dim``; an unknown name raises the JAX
``ValueError``.
"""
from __future__ import annotations

from .funnel import NealFunnel, SuperFunnel
from .gaussian import MultivariateNormal, ScaledMultivariateNormal
from .hypercube import Hypercube
from .iid import IIDBeta, IIDGamma
from .multimodal import RoughCarpet, ThreeMixture
from .rosenbrock import EvenRosenbrock, FullRosenbrock, HybridRosenbrock

TARGET_NAMES = (
    "MultivariateNormal", "MultivariateNormalScaled",
    "RoughCarpet", "RoughCarpetScaled",
    "ThreeMixture", "ThreeMixtureScaled",
    "Hypercube", "IIDGamma", "IIDBeta",
    "FullRosenbrock", "EvenRosenbrock", "HybridRosenbrock",
    "NealFunnel", "SuperFunnel",
)
PORTED_TARGETS = TARGET_NAMES
_VARIANTS = ("rwm_gpu", "pt_gpu", "cpu", "class")
# RoughCarpet mode centers per reference factory
_RC_CENTERS = {"rwm_gpu": [-4.0, 0.0, 4.0], "pt_gpu": [-15.0, 0.0, 15.0],
               "cpu": [-15.0, 0.0, 15.0], "class": [-5.0, 0.0, 5.0]}
# ThreeMixture first-coordinate mode offset per reference factory
_TM_OFFSET = {"rwm_gpu": 5.0, "pt_gpu": 15.0, "cpu": 15.0, "class": 5.0}


def calculate_hybrid_rosenbrock_dim(n1: int, n2: int) -> int:
    """dim = 1 + n2 (n1 - 1)."""
    return 1 + n2 * (n1 - 1)


def calculate_super_funnel_dim(J: int, K: int) -> int:
    """dim = J + J K + 1 + K + 1 + 1."""
    return J + J * K + 1 + K + 1 + 1


def get_target_distribution(name: str, dim: int, variant: str = "rwm_gpu",
                            *, device="cuda", **kwargs):
    """Build a target by CLI name with the reference's factory defaults."""
    if variant not in _VARIANTS:
        raise ValueError(f"Unknown variant {variant!r}; expected one of "
                         f"{_VARIANTS}")
    dev = dict(device=device)
    if name == "MultivariateNormal":
        return MultivariateNormal.create(dim, mean=kwargs.get("mean"),
                                         cov=kwargs.get("cov"), **dev)
    if name == "MultivariateNormalScaled":
        return ScaledMultivariateNormal.create(
            dim, scaling_factors=kwargs.get("scaling_factors"),
            seed=kwargs.get("seed", 0), **dev)
    if name in ("RoughCarpet", "RoughCarpetScaled"):
        return RoughCarpet.create(
            dim, scaling=name.endswith("Scaled"),
            mode_centers=kwargs.get("mode_centers", _RC_CENTERS[variant]),
            mode_weights=kwargs.get("mode_weights", [0.5, 0.3, 0.2]),
            seed=kwargs.get("seed", 0),
            scaling_factors=kwargs.get("scaling_factors"), **dev)
    if name in ("ThreeMixture", "ThreeMixtureScaled"):
        off = _TM_OFFSET[variant]
        default_centers = [[-off] + [0.0] * (dim - 1), [0.0] * dim,
                           [off] + [0.0] * (dim - 1)]
        return ThreeMixture.create(
            dim, scaling=name.endswith("Scaled"),
            mode_centers=kwargs.get("mode_centers", default_centers),
            mode_weights=kwargs.get("mode_weights", [1 / 3, 1 / 3, 1 / 3]),
            seed=kwargs.get("seed", 0),
            scaling_factors=kwargs.get("scaling_factors"), **dev)
    if name == "Hypercube":
        return Hypercube.create(
            dim, left_boundary=kwargs.get("left_boundary", -1.0),
            right_boundary=kwargs.get("right_boundary", 1.0), **dev)
    if name == "IIDGamma":
        return IIDGamma.create(dim, shape=kwargs.get("shape", 2.0),
                               scale=kwargs.get("scale", 3.0), **dev)
    if name == "IIDBeta":
        return IIDBeta.create(dim, alpha=kwargs.get("alpha", 2.0),
                              beta=kwargs.get("beta", 3.0), **dev)
    if name in ("FullRosenbrock", "EvenRosenbrock"):
        cls = FullRosenbrock if name == "FullRosenbrock" else EvenRosenbrock
        return cls.create(dim, a_coeff=kwargs.get("a_coeff", 1 / 20),
                          b_coeff=kwargs.get("b_coeff", 100 / 20),
                          mu=kwargs.get("mu", 1.0), **dev)
    if name == "HybridRosenbrock":
        return HybridRosenbrock.create(
            n1=kwargs.get("n1", 3), n2=kwargs.get("n2", 5),
            a_coeff=kwargs.get("a_coeff", 1 / 20),
            b_coeff=kwargs.get("b_coeff", 100 / 20),
            mu=kwargs.get("mu", 1.0), **dev)
    if name == "NealFunnel":
        return NealFunnel.create(dim, mu_v=kwargs.get("mu_v", 0.0),
                                 sigma_v_sq=kwargs.get("sigma_v_sq", 9.0),
                                 mu_z=kwargs.get("mu_z", 0.0), **dev)
    if name == "SuperFunnel":
        return SuperFunnel.create_synthetic(
            J=kwargs.get("J", 5), K=kwargs.get("K", 3),
            n_per_group=kwargs.get("n_per_group", 20),
            prior_hypermean_std=kwargs.get("prior_hypermean_std", 10.0),
            prior_tau_scale=kwargs.get("prior_tau_scale", 2.5), **dev)
    raise ValueError(f"Unknown target distribution name: {name!r}. "
                     f"Known names: {TARGET_NAMES}")
