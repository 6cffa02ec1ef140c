"""Build and load the CUDA kernels (``csrc/*.cu``).

Each fused kernel source ``csrc/<kernel>.cu`` compiles on first use into
one shared library per (proposal, normal draw, target kind, register
bucket), with a plain C interface, loaded with ``ctypes``:

    nvcc -gencode arch=compute_90a,code=sm_90a -std=c++17 -O3 -shared
         -Xcompiler -fPIC -Xptxas -v -DRWM_PT_PROPOSAL=<p>
         -DRWM_PT_NORMAL=<n> -DRWM_PT_TARGET=<k> -DRWM_PT_DMAX=<D>
         -o build/lib<variant>.<kind>.d<D>-<hash>.so csrc/<kernel>.cu

``<variant>`` is the kernel itself for the Normal proposal with the ICDF
draw (``fused_pt``), with ``_laplace`` / ``_uniform_radius`` for the other
proposals and ``_bm``, ``_icdf_fastlog``, ``_lax_erfinv`` or
``_fake_uniform`` for the other normal draws; ``<kind>`` is the target
kind (:data:`TARGET_KINDS`); ``<D>`` the register bucket (:data:`BUCKETS`),
the smallest that holds the state's d coordinates.  Each library holds one
instantiation, so a run builds only what it launches, and :func:`build`
starts one ``nvcc`` per library, all at once.  No
``--use_fast_math``: the kernels keep IEEE ``logf``/``log1pf``/``expf``/
``sqrtf``/``sincosf`` so that they agree with their plain PyTorch versions
to f32 rounding.  The library name carries a hash of the sources and
flags, so an edited source rebuilds.  Each ptxas report (registers,
spills) is kept in :data:`PTXAS_LOG`.  The draw study's probe kernels
(``csrc/draw_probes.cu``) are one library of their own, ``draw_probes``,
with no kind and no bucket.  Nothing here runs at import time: the CPU
tests import every module and have no ``nvcc``.
"""
from __future__ import annotations

import ctypes
import hashlib
import math
import os
import shutil
import subprocess
from collections import Counter
from pathlib import Path

import torch

CSRC = Path(__file__).resolve().parent / "csrc"
BUILD_DIR = Path(__file__).resolve().parent / "build"
NVCC_FLAGS = ["-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17",
              "-O3", "-shared", "-Xcompiler", "-fPIC", "-Xptxas", "-v"]
SOURCES = ("fused_pt", "fused_rwm")
# proposal name -> (variant suffix, -DRWM_PT_PROPOSAL; csrc/draws.cuh)
PROPOSALS = {"Normal": ("", 0), "Laplace": ("_laplace", 1),
             "UniformRadius": ("_uniform_radius", 2)}
# normal draw -> (variant suffix, -DRWM_PT_NORMAL; csrc/draws.cuh); Laplace
# draws no normals
DRAWS = {"icdf": ("", 0), "bm": ("_bm", 1),
         "icdf_fastlog": ("_icdf_fastlog", 2),
         "lax_erfinv": ("_lax_erfinv", 3),
         "fake_uniform": ("_fake_uniform", 4)}
# target kind -> -DRWM_PT_TARGET (csrc/targets.cuh)
TARGET_KINDS = {"rosenbrock": 0, "mvn_iso": 1, "mvn_full": 2,
                "scaled_mvn": 3, "three_mixture": 4, "rough_carpet": 5,
                "even_rosenbrock": 6, "hybrid_rosenbrock": 7,
                "hypercube": 8, "iid_gamma": 9, "iid_beta": 10,
                "neal_funnel": 11}
BUCKETS = (8, 16, 32, 64)    # register buckets: a thread's d <= DMAX floats
PROBES = "draw_probes"       # the probe kernels' library (csrc/draw_probes.cu)
# variant name -> (source, proposal code, draw code)
VARIANTS = {src + ps + ds: (src, pc, dc) for src in SOURCES
            for prop, (ps, pc) in PROPOSALS.items()
            for ds, dc in DRAWS.values()
            if not (prop == "Laplace" and dc)}

PTXAS_LOG: dict[str, str] = {}
_LIBS: dict[str, ctypes.CDLL] = {}

# library source -> {C entry point: argtypes}
_P, _I, _U, _F = ctypes.c_void_p, ctypes.c_int, ctypes.c_uint32, ctypes.c_float
_ENTRIES = {
    # kind, params, n_params, betas, scales, x0, acc0, swapacc0, bj0, cj0,
    # x_out, lp_out, acc_out, swapacc_out, bj_out, cj_out,
    # d, T, C, total, burn_in, swap_every, step0, key0, key1,
    # lap, inv_d, rec, record_every, record_chains, order, stream
    "fused_pt": {"rwm_pt_fused_pt":
                 [_I, _P, _I, _P, _P, _P, _P, _P, _P, _P,
                  _P, _P, _P, _P, _P, _P,
                  _I, _I, _I, _I, _I, _I, _I, _U, _U,
                  _P, _F, _P, _I, _I, _I, _P]},
    # kind, params, n_params, scale, beta, x0, acc0, jump0,
    # x_out, lp_out, acc_out, jump_out,
    # d, C, total, burn_in, step0, key0, key1,
    # lap, inv_d, rec, record_every, record_chains, stream
    "fused_rwm": {"rwm_pt_fused_rwm":
                  [_I, _P, _I, _F, _F, _P, _P, _P,
                   _P, _P, _P, _P,
                   _I, _I, _I, _I, _I, _U, _U,
                   _P, _F, _P, _I, _I, _P]},
    # impl (a DRAWS code), key0, key1, cols, out, stream |
    # y, out, n, stream
    PROBES: {"rwm_pt_draw_normals": [_I, _U, _U, _I, _P, _P],
             "rwm_pt_fast_log": [_P, _P, _I, _P]},
}


def _nvcc() -> str:
    path = shutil.which("nvcc") or "/usr/local/cuda/bin/nvcc"
    if not os.path.exists(path):
        raise RuntimeError("nvcc not found: the fused CUDA kernels are built "
                           "with the CUDA toolkit on the machine with the card")
    return path


def bucket(dim: int) -> int:
    """The smallest register bucket that holds ``dim`` coordinates."""
    for b in BUCKETS:
        if dim <= b:
            return b
    raise NotImplementedError(
        f"fused kernels compile dims up to {BUCKETS[-1]}; dim={dim} needs "
        "another state layout than registers (ROADMAP Queue A item 15)")


def lib_name(variant: str, kind: str, dim: int) -> str:
    """Library of kernel variant ``variant`` for target kind ``kind`` at
    ``dim`` coordinates (its register bucket)."""
    if variant not in VARIANTS or kind not in TARGET_KINDS:
        raise ValueError(f"no library {variant}.{kind}")
    return f"{variant}.{kind}.d{bucket(dim)}"


def _parts(name: str):
    variant, kind, dmax = name.split(".")
    src, pc, dc = VARIANTS[variant]
    return src, pc, dc, TARGET_KINDS[kind], int(dmax[1:])


def _source(name: str) -> str:
    return PROBES if name == PROBES else _parts(name)[0]


def _flags(name: str) -> list[str]:
    if name == PROBES:
        return list(NVCC_FLAGS)
    _, pc, dc, kc, dmax = _parts(name)
    return NVCC_FLAGS + [f"-DRWM_PT_PROPOSAL={pc}", f"-DRWM_PT_NORMAL={dc}",
                         f"-DRWM_PT_TARGET={kc}", f"-DRWM_PT_DMAX={dmax}"]


def _lib_path(name: str) -> Path:
    h = hashlib.sha256(" ".join(_flags(name)).encode())
    src = _source(name)
    for f in sorted(CSRC.glob("*.cu*")):
        if f.suffix == ".cuh" or f.stem == src:
            h.update(f.name.encode())
            h.update(f.read_bytes())
    return BUILD_DIR / f"lib{name}-{h.hexdigest()[:16]}.so"


def library(source: str, proposal: str, draw: str = "icdf") -> str:
    """Name of the variant of kernel ``source`` for ``proposal`` and the
    normal ``draw`` (one of :data:`DRAWS`; Laplace draws no normals)."""
    if proposal not in PROPOSALS:
        raise NotImplementedError(
            f"fused kernels take the Normal, Laplace and UniformRadius "
            f"proposals; {proposal!r} is not one of them")
    if draw not in DRAWS:
        raise ValueError(f"unknown normal draw {draw!r}")
    if proposal == "Laplace":
        draw = "icdf"
    return source + PROPOSALS[proposal][0] + DRAWS[draw][0]


def build(names) -> dict[str, str]:
    """Compile the named libraries (:func:`lib_name`) that are not built
    yet, one ``nvcc`` each, all started together.  Returns ``{name: ptxas report}``; raises with the
    compiler's output if any build fails."""
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    procs = {}
    for name in names:
        out = _lib_path(name)
        log = out.with_suffix(".log")
        if out.exists() and log.exists():
            PTXAS_LOG[name] = log.read_text()
            continue
        tmp = out.with_name(out.name + f".{os.getpid()}.tmp")
        cmd = [_nvcc(), *_flags(name), "-o", str(tmp),
               str(CSRC / f"{_source(name)}.cu")]
        procs[name] = (subprocess.Popen(cmd, stdout=subprocess.PIPE,
                                        stderr=subprocess.STDOUT, text=True),
                       tmp, out, log)
    failed = []
    for name, (proc, tmp, out, log) in procs.items():
        text, _ = proc.communicate()
        if proc.returncode != 0:
            failed.append(f"{name}: nvcc exit {proc.returncode}\n{text}")
            continue
        os.replace(tmp, out)
        log.write_text(text)
        PTXAS_LOG[name] = text
    if failed:
        raise RuntimeError("kernel build failed:\n" + "\n".join(failed))
    return {n: PTXAS_LOG[n] for n in names}


def load(name: str) -> ctypes.CDLL:
    """The loaded library of kernel ``name``, built first if needed."""
    lib = _LIBS.get(name)
    if lib is None:
        build([name])
        lib = ctypes.CDLL(str(_lib_path(name)))
        for fn_name, argtypes in _ENTRIES[_source(name)].items():
            fn = getattr(lib, fn_name)
            fn.argtypes = argtypes
            fn.restype = ctypes.c_int
        _LIBS[name] = lib
    return lib


def entry(name: str, fn: str | None = None):
    """The C entry point ``fn`` of library ``name`` (by default its
    only one)."""
    return getattr(load(name), fn or next(iter(_ENTRIES[_source(name)])))


def check_launch(name: str, rc: int) -> None:
    if rc != 0:
        raise RuntimeError(f"{name} kernel launch failed: cudaError {rc}")


# ---------------------------------------------------------------- targets
MAX_DIM = 64        # largest register bucket compiled (csrc/targets.cuh)
MAX_RUNGS = 32      # one thread per (replica, rung): 32 x T threads a block
_LOG_2PI = math.log(2.0 * math.pi)


def _f32(*parts) -> torch.Tensor:
    return torch.cat([torch.as_tensor(p).to(torch.float32).reshape(-1)
                      .cpu() for p in parts]).contiguous()


_KIND_OF = {"FullRosenbrock": "rosenbrock",
            "ScaledMultivariateNormal": "scaled_mvn",
            "ThreeMixture": "three_mixture", "RoughCarpet": "rough_carpet",
            "EvenRosenbrock": "even_rosenbrock",
            "HybridRosenbrock": "hybrid_rosenbrock", "Hypercube": "hypercube",
            "IIDGamma": "iid_gamma", "IIDBeta": "iid_beta",
            "NealFunnel": "neal_funnel"}


def target_kind(target) -> str | None:
    """The kernel kind (:data:`TARGET_KINDS`) of ``target``, or None for a
    target the kernels do not take."""
    name = type(target).__name__
    if name == "MultivariateNormal":
        return "mvn_iso" if target.iso else "mvn_full"
    return _KIND_OF.get(name)


def kernel_target(target) -> tuple[str, torch.Tensor]:
    """(kind, f32 parameter vector on the CPU) of a target the kernels
    take, laid out as ``csrc/targets.cuh`` reads it.  Any other target,
    and a dim above :data:`MAX_DIM`, raises ``NotImplementedError``: there
    is no fallback."""
    kind = target_kind(target)
    if kind is None:
        raise NotImplementedError(
            f"fused CUDA kernels do not support target "
            f"{type(target).__name__!r} (ROADMAP Queue A item 9)")
    if target.dim > MAX_DIM:
        raise NotImplementedError(
            f"fused kernels compile dims up to {MAX_DIM}; dim={target.dim} "
            "needs another state layout than registers (ROADMAP Queue A "
            "item 15)")
    t, d = target, target.dim
    if kind == "rosenbrock":
        return kind, _f32(t.a_coeff, t.b_coeff, t.mu)
    if kind == "mvn_iso":
        return kind, _f32(t.log_norm_const, t.mean)
    if kind == "mvn_full":
        return kind, _f32(t.log_norm_const, t.mean, t.cov_inv)
    if kind == "scaled_mvn":
        return kind, _f32(t.log_norm_const, t.scaling_factors)
    if kind == "three_mixture":
        s = t.scaling_factors if t.scaling else torch.ones(d)
        return kind, _f32(t.log_jacobian if t.scaling else 0.0,
                          0.5 * d * _LOG_2PI, t.log_weights, s, t.means)
    if kind == "rough_carpet":
        s = t.scaling_factors if t.scaling else torch.ones(d)
        return kind, _f32(t.log_jacobian if t.scaling else 0.0,
                          t.log_weights, t.modes, s)
    if kind == "even_rosenbrock":
        return kind, _f32(t.a_vec, t.b_vec, t.mu)
    if kind == "hybrid_rosenbrock":
        first = [float((k - 1) % (t.n1 - 1) == 0) for k in range(1, d)]
        return kind, _f32(t.a_coeff, t.b_coeff, t.mu, first)
    if kind == "hypercube":
        return kind, _f32(t.left, t.right, t.log_uniform_density)
    if kind == "iid_gamma":
        return kind, _f32(t.shape, t.scale, t.log_norm_const)
    if kind == "iid_beta":
        return kind, _f32(t.alpha, t.beta, t.log_norm_const)
    s = t.sigma_v_sq.to(torch.float32)        # the log on the target's device
    d1 = d - 1
    return kind, _f32(t.mu_v, s, t.mu_z, -0.5 * _LOG_2PI - 0.5 * torch.log(s),
                      -0.5 * d1 * _LOG_2PI, 0.5 * d1)


def by_variant(launches) -> Counter:
    """Launch counts keyed ``<variant>.<target kind>`` (the wrappers'
    ``launches``) summed by variant; the ``*_record`` keys pass through."""
    out = Counter()
    for key, n in launches.items():
        out[key.split(".")[0]] += n
    return out


def check_cuda(name: str, dtype: torch.dtype, **tensors) -> None:
    """Raise unless every tensor is a contiguous CUDA tensor of ``dtype``
    on one card."""
    dev = None
    for k, t in tensors.items():
        if not t.is_cuda or not t.is_contiguous() or t.dtype != dtype:
            raise ValueError(f"{name}: {k} must be a contiguous CUDA "
                             f"tensor of {dtype}")
        if dev is not None and t.device != dev:
            raise ValueError(f"{name}: tensors on different devices")
        dev = t.device
