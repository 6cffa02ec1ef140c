"""Build and load the fused CUDA kernels (``csrc/*.cu``).

Each kernel source ``csrc/<kernel>.cu`` compiles on first use into one
shared library per proposal, with a plain C interface, loaded with
``ctypes``:

    nvcc -gencode arch=compute_90a,code=sm_90a -std=c++17 -O3 -shared
         -Xcompiler -fPIC -Xptxas -v -DRWM_PT_PROPOSAL=<k>
         -o build/lib<name>-<hash>.so csrc/<kernel>.cu

``<name>`` is the kernel itself for the Normal proposal (``fused_pt``) and
``<kernel>_laplace`` / ``<kernel>_uniform_radius`` for the others, so each
library holds 2 targets x 4 register buckets and the six build in parallel.
No ``--use_fast_math``: the kernels keep IEEE ``logf``/``log1pf``/``expf``/
``sqrtf`` so that they agree with their plain PyTorch versions to f32
rounding.  The library name carries a hash of the sources and flags, so an
edited source rebuilds.  ``build()`` starts one ``nvcc`` per library, all
at once, and keeps each ptxas report (registers, spills) in
:data:`PTXAS_LOG`.  Nothing here runs at import time: the CPU tests import
every module and have no ``nvcc``.
"""
from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
from pathlib import Path

import torch

CSRC = Path(__file__).resolve().parent / "csrc"
BUILD_DIR = Path(__file__).resolve().parent / "build"
NVCC_FLAGS = ["-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17",
              "-O3", "-shared", "-Xcompiler", "-fPIC", "-Xptxas", "-v"]
SOURCES = ("fused_pt", "fused_rwm")
# proposal name -> (library suffix, -DRWM_PT_PROPOSAL value; csrc/draws.cuh)
PROPOSALS = {"Normal": ("", 0), "Laplace": ("_laplace", 1),
             "UniformRadius": ("_uniform_radius", 2)}
# library name -> (source, proposal code)
LIBRARIES = {src + suffix: (src, code) for src in SOURCES
             for suffix, code in PROPOSALS.values()}
KERNELS = tuple(LIBRARIES)

PTXAS_LOG: dict[str, str] = {}
_LIBS: dict[str, ctypes.CDLL] = {}

# C signature shared by the entry points' pointer/int arguments
_P, _I, _U, _F = ctypes.c_void_p, ctypes.c_int, ctypes.c_uint32, ctypes.c_float
_ARGTYPES = {
    # kind, params, n_params, betas, scales, x0, acc0, swapacc0, bj0, cj0,
    # x_out, lp_out, acc_out, swapacc_out, bj_out, cj_out,
    # d, T, C, total, burn_in, swap_every, step0, key0, key1,
    # lap, inv_d, rec, record_every, record_chains, stream
    "fused_pt": ("rwm_pt_fused_pt",
                 [_I, _P, _I, _P, _P, _P, _P, _P, _P, _P,
                  _P, _P, _P, _P, _P, _P,
                  _I, _I, _I, _I, _I, _I, _I, _U, _U,
                  _P, _F, _P, _I, _I, _P]),
    # kind, params, n_params, scale, beta, x0, acc0, jump0,
    # x_out, lp_out, acc_out, jump_out,
    # d, C, total, burn_in, step0, key0, key1,
    # lap, inv_d, rec, record_every, record_chains, stream
    "fused_rwm": ("rwm_pt_fused_rwm",
                  [_I, _P, _I, _F, _F, _P, _P, _P,
                   _P, _P, _P, _P,
                   _I, _I, _I, _I, _I, _U, _U,
                   _P, _F, _P, _I, _I, _P]),
}


def _nvcc() -> str:
    path = shutil.which("nvcc") or "/usr/local/cuda/bin/nvcc"
    if not os.path.exists(path):
        raise RuntimeError("nvcc not found: the fused CUDA kernels are built "
                           "with the CUDA toolkit on the machine with the card")
    return path


def _flags(name: str) -> list[str]:
    return NVCC_FLAGS + [f"-DRWM_PT_PROPOSAL={LIBRARIES[name][1]}"]


def _lib_path(name: str) -> Path:
    h = hashlib.sha256(" ".join(_flags(name)).encode())
    for src in sorted(CSRC.glob("*.cu*")):
        if src.suffix == ".cuh" or src.stem == LIBRARIES[name][0]:
            h.update(src.name.encode())
            h.update(src.read_bytes())
    return BUILD_DIR / f"lib{name}-{h.hexdigest()[:16]}.so"


def library(source: str, proposal: str) -> str:
    """Name of the library of kernel ``source`` built for ``proposal``."""
    if proposal not in PROPOSALS:
        raise NotImplementedError(
            f"fused kernels take the Normal, Laplace and UniformRadius "
            f"proposals; {proposal!r} is not one of them")
    return source + PROPOSALS[proposal][0]


def build(names=KERNELS) -> dict[str, str]:
    """Compile the named libraries that are not built yet, one ``nvcc``
    each, all started together.  Returns ``{name: ptxas report}``; raises with the
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
               str(CSRC / f"{LIBRARIES[name][0]}.cu")]
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
        fn_name, argtypes = _ARGTYPES[LIBRARIES[name][0]]
        fn = getattr(lib, fn_name)
        fn.argtypes = argtypes
        fn.restype = ctypes.c_int
        _LIBS[name] = lib
    return lib


def entry(name: str):
    """The C entry point of library ``name``."""
    return getattr(load(name), _ARGTYPES[LIBRARIES[name][0]][0])


def check_launch(name: str, rc: int) -> None:
    if rc != 0:
        raise RuntimeError(f"{name} kernel launch failed: cudaError {rc}")


# ---------------------------------------------------------------- targets
TARGET_ROSENBROCK = 0
TARGET_MVN_ISO = 1
MAX_DIM = 64        # largest register bucket compiled (csrc/targets.cuh)
MAX_RUNGS = 32      # one thread per (replica, rung): 32 x T threads a block


def kernel_target(target) -> tuple[int, torch.Tensor]:
    """(kind, f32 parameter vector) of a target the kernels support:
    FullRosenbrock ``[a, b, mu_0 .. mu_{d-2}]`` or identity-covariance
    MultivariateNormal ``[log_norm_const, mean_0 .. mean_{d-1}]``.  Any
    other target raises ``NotImplementedError``: there is no fallback."""
    name = getattr(target, "name", type(target).__name__)
    if target.dim > MAX_DIM:
        raise NotImplementedError(
            f"fused kernels compile dims up to {MAX_DIM}; dim={target.dim} "
            "waits for a later slice (ROADMAP Queue B)")
    if name == "FullRosenbrock":
        parts = [target.a_coeff.reshape(1), target.b_coeff.reshape(1),
                 target.mu.reshape(-1)]
        kind = TARGET_ROSENBROCK
    elif name == "MultivariateNormal" and target.iso:
        parts = [target.log_norm_const.reshape(1), target.mean.reshape(-1)]
        kind = TARGET_MVN_ISO
    elif name == "MultivariateNormal":
        raise NotImplementedError(
            "fused CUDA kernels take the identity-covariance "
            "MultivariateNormal only; a full covariance waits for "
            "ROADMAP Queue A item 9 (remaining targets in the kernels)")
    else:
        raise NotImplementedError(
            f"fused CUDA kernels do not support target {name!r} yet "
            "(ROADMAP Queue A item 9)")
    return kind, torch.cat([p.to(torch.float32) for p in parts]).contiguous()


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
