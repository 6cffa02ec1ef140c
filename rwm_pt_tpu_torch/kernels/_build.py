"""Build and load the CUDA kernels (``csrc/*.cu``).

Each fused kernel source ``csrc/<kernel>.cu`` compiles on first use into
one shared library per (proposal, normal draw, target kind, register
bucket), with a plain C interface, loaded with ``ctypes``:

    nvcc -gencode arch=compute_90a,code=sm_90a -std=c++17 -O3 -shared
         -Xcompiler -fPIC -Xptxas -v -DRWM_PT_PROPOSAL=<p>
         -DRWM_PT_NORMAL=<n> -DRWM_PT_TARGET=<k> -DRWM_PT_DMAX=<D>
         -DRWM_PT_MINBLOCKS=<b>
         -o build/lib<variant>.<kind>.d<D>-<hash>.so csrc/<kernel>.cu

Above 64 dimensions the same variants build from ``csrc/<kernel>_warp.cu``
(a team of G lanes a replica, ``csrc/warp.cuh``) into
``lib<variant>.<kind>.w<D>``, ``<D>`` the warp bucket
(:data:`WARP_BUCKETS`: d + 4 <= D slots), with ``-DRWM_PT_TEAMS=<mask>``,
the team sizes G the library instantiates (:func:`library_teams`, a mask
of powers of two); the launcher takes one of them (:func:`choose_team`).

SuperFunnel (kind 12) builds with its dataset's shape fixed, as the TPU
kernel fixes it at trace time: ``lib<variant>.super_funnel.
j<J>k<K>n<n>u<u>b<b>.d<D>`` at d <= 64 and ``...j<J>k<K>n<n>u<u>.w<D>``
above (the team kernels) with ``-DRWM_PT_SF_J=<J> -DRWM_PT_SF_K=<K>
-DRWM_PT_SF_N=<n> -DRWM_PT_SF_UNROLL=<u>`` and a thread build's
``-DRWM_PT_MINBLOCKS=<b>`` (:func:`sf_tag`: the build's choices are in
its name), the dataset packed by :func:`sf_pack`
into a kernel parameter (thread kernels) or padded by
:func:`sf_team_pack` into the block's shared memory (team kernels);
:func:`route` takes it wherever the dataset fits (:func:`sf_shape`), the
run-time-shape library ``lib<variant>.super_funnel.d<D>`` (``.w<D>``)
elsewhere.

``<variant>`` is the kernel itself for the Normal proposal with the ICDF
draw (``fused_pt``), with ``_laplace`` / ``_uniform_radius`` for the other
proposals and ``_bm``, ``_icdf_fastlog``, ``_lax_erfinv`` or
``_fake_uniform`` for the other normal draws; ``<kind>`` is the target
kind (:data:`TARGET_KINDS`); ``<D>`` the register bucket (:data:`BUCKETS`),
the smallest that holds the state's d coordinates; ``<b>`` the blocks an SM
must hold (:func:`min_blocks`, the kernels' ``__launch_bounds__``, which
caps the registers; a stated rule, not the outcome of a build).  Each
library holds one
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

Launch geometry (:func:`pt_block_geometry`, :func:`rwm_block_geometry`,
and for the warp kernels :func:`pt_warp_geometry`,
:func:`rwm_warp_geometry`) is plain Python: the replicas (chains) a
block, the dynamic shared memory its state slabs take and the blocks an
SM holds, from the kernel's
registers and ``maxThreadsPerBlock`` (each library exports them,
:func:`kernel_info`) by the CUDA occupancy calculator's rules for Hopper.
The wrappers pass the replicas a block to the launcher, which refuses what
does not fit.

The iterative ladder builder (``csrc/ladder_build.cu``,
``kernels/ladder_build.py``) builds one library per target kind with a
direct sampler and bucket, ``libladder_build.<kind>.d<D>`` with
``-DRWM_PT_TARGET=<k> -DRWM_PT_DMAX=<D>`` (:func:`ladder_lib`: the register
buckets up to 64 coordinates, whose loops it unrolls, the warp buckets'
sizes above, whose loops it rolls); it has no proposal or draw variants
and sizes its own cooperative grid.
"""
from __future__ import annotations

import ctypes
import functools
import hashlib
import math
import os
import re
import shutil
import subprocess
import weakref
from collections import Counter
from pathlib import Path
from typing import NamedTuple

import torch

CSRC = Path(__file__).resolve().parent / "csrc"
BUILD_DIR = Path(__file__).resolve().parent / "build"
NVCC_FLAGS = ["-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17",
              "-O3", "-shared", "-Xcompiler", "-fPIC", "-Xptxas", "-v"]
SOURCES = ("fused_pt", "fused_rwm", "fused_pt_warp", "fused_rwm_warp")
WARP = "_warp"     # the suffix of the warp-per-replica sources
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
                "neal_funnel": 11, "super_funnel": 12}
BUCKETS = (8, 16, 32, 64)    # register buckets: a thread's d <= DMAX floats
WARP_BUCKETS = (128, 256, 512, 1024, 2048, 4096)   # warp buckets: d + 4 <=
#                                                    DMAX slots (warp.cuh)
PROBES = "draw_probes"       # the probe kernels' library (csrc/draw_probes.cu)
LADDER = "ladder_build"      # the ladder builder's source (csrc/ladder_build.cu)
# Blocks of a kernel's launch bound (PT: 320 threads, RWM: 128) that an SM
# must hold, per source, for register buckets up to 32: the register cap
# measured fastest at the flagship and the RWM headline (the cap sweep in
# PERF.md): PT 2 (96 registers, 20 warps), RWM 1 (no cap: at 80-94
# registers it holds 20-24 warps, and caps to 24 or 32 warps were no
# faster).  The 64 bucket's proposal alone takes 64 registers, so it is
# held to one block.
MIN_BLOCKS = {"fused_pt": 2, "fused_rwm": 1}
# (source, target kind, bucket) -> blocks, for the libraries that spill
# under MIN_BLOCKS (ptxas; chip_smoke.py's phase 2 fails on any stack
# frame or spill, so a new one shows there): the full-covariance MVN's
# quadratic form, one block at d16 and no launch bound at all (0: the
# compiler takes the registers it needs and a block holds the threads they
# allow) at d32, and Hypercube's and SuperFunnel's PT at d32, one block
# (SuperFunnel's Normal and Laplace builds spilled 16-40 B at 96 registers;
# its fixed-shape builds, which stage nothing, take SF_MIN_BLOCKS).
FEWER_BLOCKS = {("fused_pt", "mvn_full", 16): 1,
                ("fused_pt", "mvn_full", 32): 0,
                ("fused_pt", "hypercube", 32): 1,
                ("fused_pt", "super_funnel", 32): 1}
# variant name -> (source, proposal code, draw code)
VARIANTS = {src + ps + ds: (src, pc, dc) for src in ("fused_pt", "fused_rwm")
            for prop, (ps, pc) in PROPOSALS.items()
            for ds, dc in DRAWS.values()
            if not (prop == "Laplace" and dc)}

PTXAS_LOG: dict[str, str] = {}
_LIBS: dict[str, ctypes.CDLL] = {}

# library source -> {C entry point: argtypes}
_P, _I, _U, _F = ctypes.c_void_p, ctypes.c_int, ctypes.c_uint32, ctypes.c_float
_D = ctypes.c_double
_ENTRIES = {
    # kind, params, n_params, betas, scales, x0, acc0, swapacc0, bj0, cj0,
    # x_out, lp_out, acc_out, swapacc_out, bj_out, cj_out,
    # d, T, C, total, burn_in, swap_every, step0, key0, key1,
    # replica0, rung0 (csrc/philox.cuh), lap, inv_d, rec, record_every,
    # record_chains, order, R, runtime_r,
    # stream |
    # runtime_r, d, T, R, n_params, out (5 ints)
    "fused_pt": {"rwm_pt_fused_pt":
                 [_I, _P, _I, _P, _P, _P, _P, _P, _P, _P,
                  _P, _P, _P, _P, _P, _P,
                  _I, _I, _I, _I, _I, _I, _I, _U, _U, _I, _I,
                  _P, _F, _P, _I, _I, _I, _I, _I, _P],
                 "rwm_pt_fused_pt_info": [_I, _I, _I, _I, _I, _P]},
    # kind, params, n_params, scale, beta, x0, acc0, jump0,
    # x_out, lp_out, acc_out, jump_out,
    # d, C, total, burn_in, step0, key0, key1, replica0,
    # lap, inv_d, rec, record_every, record_chains, threads, stream |
    # d, threads, n_params, out (5 ints)
    "fused_rwm": {"rwm_pt_fused_rwm":
                  [_I, _P, _I, _F, _F, _P, _P, _P,
                   _P, _P, _P, _P,
                   _I, _I, _I, _I, _I, _U, _U, _I,
                   _P, _F, _P, _I, _I, _I, _P],
                  "rwm_pt_fused_rwm_info": [_I, _I, _I, _P]},
    # impl (a DRAWS code), key0, key1, cols, out, stream |
    # y, out, n (64-bit), stream
    PROBES: {"rwm_pt_draw_normals": [_I, _U, _U, _I, _P, _P],
             "rwm_pt_fast_log": [_P, _P, ctypes.c_int64, _P]},
    # params, n_params, sparams, d, N, key0, key1, rate, beta_min, tol,
    # initial_pn, pn_step, pn_lo, pn_hi, max_pn, fail_tol, max_T, bf16,
    # trace_cap, tile_sums, ctl, full, out, stream | n_params, d, out (6
    # ints)
    LADDER: {"rwm_pt_ladder_build":
             [_P, _I, _P, _I, _I, _U, _U, _D, _D, _D, _D, _P, _D, _D, _I, _D,
              _I, _I, _I, _P, _P, _P, _P, _P],
             "rwm_pt_ladder_build_info": [_I, _I, _P]},
}
# the warp kernels: PT takes the same arguments, the team size G in
# runtime_r's place and the blocks a cluster after it (0: one block a
# replica's ladder; csrc/fused_pt_warp.cu's cluster build), its info
# function the team size and the blocks a cluster first; RWM takes chains
# (teams) a block for threads and the team size after them, and its info
# function the team size first
_ENTRIES["fused_pt_warp"] = {
    # the blocks a cluster after the team size, then the terms pool (rows,
    # claim bitmask, slots; csrc/fused_pt_warp.cu::kGlobalTerms)
    "rwm_pt_fused_pt": _ENTRIES["fused_pt"]["rwm_pt_fused_pt"][:-1]
    + [_I, _P, _P, _I, _P],
    "rwm_pt_fused_pt_info": [_I, _I, _I, _I, _I, _I, _P],
    # out (kStampWords u64), reset: the measuring build's stamps
    "rwm_pt_fused_pt_stamps": [_P, _I]}
_ENTRIES["fused_rwm_warp"] = {
    # the team size, then the terms pool (rows, claim bitmask, slots;
    # csrc/fused_rwm_warp.cu::kGlobalTerms)
    "rwm_pt_fused_rwm": _ENTRIES["fused_rwm"]["rwm_pt_fused_rwm"][:-1]
    + [_I, _P, _P, _I, _P],
    "rwm_pt_fused_rwm_info": [_I, _I, _I, _I, _P]}


def _nvcc() -> str:
    path = shutil.which("nvcc") or "/usr/local/cuda/bin/nvcc"
    if not os.path.exists(path):
        raise RuntimeError("nvcc not found: the fused CUDA kernels are built "
                           "with the CUDA toolkit on the machine with the card")
    return path


def bucket(dim: int) -> int:
    """The smallest register bucket of the thread-per-replica kernels that
    holds ``dim`` coordinates."""
    for b in BUCKETS:
        if dim <= b:
            return b
    raise NotImplementedError(
        f"the thread-per-replica kernels compile dims up to {BUCKETS[-1]}; "
        f"dim={dim} runs a team of lanes a replica (warp_bucket)")


def warp_bucket(dim: int) -> int:
    """The smallest warp bucket whose slots hold ``dim`` coordinates and
    the four slots after them (csrc/warp.cuh)."""
    for b in WARP_BUCKETS:
        if dim + 4 <= b:
            return b
    raise NotImplementedError(
        f"fused kernels compile dims up to {MAX_DIM}, the {WARP_BUCKETS[-1]}"
        f"-slot warp bucket; dim={dim} needs the {2 * WARP_BUCKETS[-1]}-"
        f"slot bucket, whose rows ({8 * WARP_BUCKETS[-1] // 1024} KB each, "
        f"two or three a rung-team) and staged parameters leave a block too "
        f"few rungs for a ladder (ROADMAP Queue A item 15, the remainder "
        f"above d = {MAX_DIM})")


def lib_name(variant: str, kind: str, dim: int, warp: bool | None = None,
             sf: str | None = None) -> str:
    """Library of kernel variant ``variant`` for target kind ``kind`` at
    ``dim`` coordinates: its register bucket ``.d<D>`` up to 64
    coordinates, its warp bucket ``.w<D>`` above (``warp=True`` takes the
    warp kernel at any d, for comparing the two layouts); ``sf``, a
    SuperFunnel dataset shape (:func:`sf_tag`), names the build with that
    shape fixed, ``<variant>.super_funnel.<sf>.d<D>``."""
    if variant not in VARIANTS or kind not in TARGET_KINDS:
        raise ValueError(f"no library {variant}.{kind}")
    if warp is None:
        warp = dim > BUCKETS[-1]
    if sf is not None:
        # a fixed shape takes the layout of its d: no team build at d <= 64
        shape = fixed_shape(f"{variant}.{kind}.{sf}.d0")
        if (shape is None or shape["dim"] != dim
                or warp != (dim > BUCKETS[-1])):
            raise ValueError(f"no fixed-shape library {variant}.{kind}.{sf} "
                             f"at d={dim}")
        return (f"{variant}.{kind}.{sf}."
                + (f"w{warp_bucket(dim)}" if warp else f"d{bucket(dim)}"))
    if warp:
        return f"{variant}.{kind}.w{warp_bucket(dim)}"
    return f"{variant}.{kind}.d{bucket(dim)}"


def is_warp(name: str) -> bool:
    """Whether library ``name`` is a warp-per-replica one (a team of lanes
    a state: ``.w<D>``, or PT's cluster build ``.c<D>``)."""
    return name.split(".")[-1][:1] in ("w", "c")


def is_cluster(name: str) -> bool:
    """Whether library ``name`` is PT's cluster build (``.c<D>``:
    ``csrc/fused_pt_warp.cu`` with ``-DRWM_PT_CLUSTER``, a replica's
    rung-teams spread over the blocks of a thread-block cluster)."""
    return name.split(".")[-1].startswith("c")


def is_stamps(name: str) -> bool:
    """Whether library ``name`` is the cluster build's measuring build
    (``.c<D>s``, ``-DRWM_PT_STAMPS``: ``%globaltimer`` stamps of a swap
    step's parts, ``fused_pt.swap_split``), which no entry point takes."""
    return is_cluster(name) and name.endswith("s")


def cluster_lib(name: str, stamps: bool = False) -> str:
    """The cluster build of PT warp library ``name``: its warp bucket's tag
    ``w<D>`` as ``c<D>`` (``fused_pt_lax_erfinv.mvn_iso.c1024``), with
    ``stamps`` its measuring build ``c<D>s``."""
    head, tag = name.rsplit(".", 1)
    if tag[0] not in "wc" or not name.startswith("fused_pt"):
        raise ValueError(f"{name} has no cluster build: PT's team "
                         f"libraries (d > 64) have one")
    return f"{head}.c{tag[1:].rstrip('s')}" + ("s" if stamps else "")


def launch_key(name: str) -> str:
    """The wrappers' launch-counter key of library ``name``:
    ``<variant>.<kind>`` for a thread-per-replica library (its register
    bucket dropped), the whole name ``<variant>.<kind>.w<D>`` (``.c<D>``)
    for a warp one."""
    return name if is_warp(name) else name.rsplit(".", 1)[0]


def min_blocks(source: str, kind: str, dmax: int) -> int:
    """Blocks of the launch bound an SM must hold (``-DRWM_PT_MINBLOCKS``)
    for kernel ``source`` on target kind ``kind`` at register bucket
    ``dmax``: :data:`MIN_BLOCKS` up to the 32 bucket, one block above it,
    :data:`FEWER_BLOCKS` where the capped build spills (a SuperFunnel
    build of fixed shape names its own, :func:`sf_tag`)."""
    if dmax > 32 or source.endswith(WARP):
        return 1
    return FEWER_BLOCKS.get((source, kind, dmax), MIN_BLOCKS[source])


def _parts(name: str):
    """(source, proposal code, draw code, kind code, bucket, min blocks) of
    a library name ``<variant>.<kind>.d<D>`` or ``<variant>.<kind>.w<D>``
    (a warp bucket: source ``<kernel>_warp``, whose launch bound is fixed
    in its source), or ``<variant>.super_funnel.<sf>.d<D>`` / ``.w<D>``
    (a fixed dataset shape, :func:`fixed_shape`, in the layout and bucket
    of its d)."""
    parts = name.split(".")
    shape = fixed_shape(name)
    if len(parts) == 4 and shape is not None:
        parts = parts[:2] + parts[3:]
    variant, kind, tag = parts
    src, pc, dc = VARIANTS[variant]
    if tag[0] not in "dwc" or (tag[0] == "c" and src != "fused_pt"):
        raise ValueError(f"no library {name}")
    if tag.endswith("s") and (tag[0] != "c" or shape is not None):
        raise ValueError(f"no library {name}: the cluster build has the "
                         f"measuring build")
    dmax = int(tag[1:].rstrip("s"))
    if shape is not None:
        d = shape["dim"]
        team = BUCKETS[-1] < d <= MAX_DIM
        if d > MAX_DIM or team != (shape["blocks"] is None) or (
                tag[0].replace("c", "w"), dmax) != (
                    ("w", warp_bucket(d)) if team else ("d", bucket(d))):
            raise ValueError(f"no library {name}")
    if tag[0] in "wc":
        src += WARP
    blocks = (min_blocks(src, kind, dmax) if shape is None
              or shape["blocks"] is None else shape["blocks"])
    return src, pc, dc, TARGET_KINDS[kind], dmax, blocks


# ------------------------------------------ SuperFunnel of a fixed shape
SF_HEAD = 10    # csrc/targets.cuh::kSuperFunnelHead, the words before X
SF_TEAM_HEAD = 12   # csrc/targets.cuh::SuperFunnelTeamLayout::kHead
# csrc/targets.cuh::kSuperFunnelFixedMaxWords: the packed dataset's words
# that a fixed-shape build may take as a kernel parameter (3,584 of the 4 KB
# of a kernel's parameters; the other arguments take < 512 B)
SF_FIXED_MAX_WORDS = 896
# Per source, a fixed-shape build's observations a trip of its
# observation loop and (thread kernels) blocks of the launch bound an SM,
# the fastest measured with no stack frame or spill
# (scripts/bench_torch_super_funnel.py on an H100, PERF.md §6).  Thread
# kernels (PT's bound 256 threads, csrc/fused_pt.cu::kBlockThreads): PT 2
# at 3 blocks (80 registers, 24 warps an SM at T = 8), RWM 4 with no cap
# (its caps lost, and unrolling 2 lost 21 % at the study's 1024 chains).
# Team kernels (d > 64, whose launch bound is fixed in their source): PT 2,
# RWM 4, the fastest summed over d = 68 and 166.  A comparison sets them
# and names the builds again.
SF_UNROLL = {"fused_pt": 2, "fused_rwm": 4, "fused_pt_warp": 2,
             "fused_rwm_warp": 4}
SF_MIN_BLOCKS = {"fused_pt": 3, "fused_rwm": 1}
_SF_TAG = re.compile(r"j(\d+)k(\d+)n(\d+)u(\d+)(?:b(\d+))?")


def sf_words(J: int, K: int, n: int) -> int:
    """Words of a SuperFunnel dataset of J groups, K covariates and n
    observations a group, packed by :func:`sf_pack` (as many as the
    run-time parameter vector has)."""
    return SF_HEAD + J * n * (K + 1)


def sf_tag(J: int, K: int, n: int, source: str) -> str:
    """The library-name tag of a fixed SuperFunnel shape built from kernel
    ``source`` (``fused_pt`` or ``fused_rwm``): the dataset's shape, then
    the build's observations a trip of its loop (:data:`SF_UNROLL` of the
    source its d takes, ``<source>_warp`` above 64; at most n), and in a
    thread build blocks of its launch bound an SM (:data:`SF_MIN_BLOCKS`
    up to the 32 bucket, one above it): ``j<J>k<K>n<n>u<u>b<b>`` (thread)
    or ``j<J>k<K>n<n>u<u>`` (team)."""
    d = J + J * K + K + 3
    if d > BUCKETS[-1]:
        return f"j{J}k{K}n{n}u{min(SF_UNROLL[source + WARP], n)}"
    blocks = SF_MIN_BLOCKS[source] if bucket(d) <= 32 else 1
    return f"j{J}k{K}n{n}u{min(SF_UNROLL[source], n)}b{blocks}"


def fixed_shape(name: str) -> dict | None:
    """``{J, K, n, dim, unroll, blocks}`` of library ``name`` if it is a
    SuperFunnel build of fixed shape (:func:`sf_tag`; ``blocks`` None in a
    tag without them), else None."""
    parts = name.split(".")
    m = _SF_TAG.fullmatch(parts[2]) if len(parts) == 4 else None
    if m is None or parts[0] not in VARIANTS or parts[1] != "super_funnel":
        return None
    J, K, n, unroll = (int(v) for v in m.groups()[:4])
    blocks = None if m.group(5) is None else int(m.group(5))
    return dict(J=J, K=K, n=n, dim=J + J * K + K + 3, unroll=unroll,
                blocks=blocks)


def sf_shape(kind: str, dim: int, params: torch.Tensor,
             warp: bool | None = None) -> tuple[int, int, int] | None:
    """``(J, K, n)`` of a SuperFunnel launch that a fixed-shape build takes:
    kind 12 in the layout of its d (``warp`` None or that layout's) whose
    dataset fits the build: on the thread kernels (d <= 64) its packed
    words within :data:`SF_FIXED_MAX_WORDS`, on the team kernels (64 < d
    <= :data:`MAX_DIM`) its padded words (:func:`sf_team_words`) within
    the shared memory's :data:`PARAMS_SHARED_MAX`; None for any other
    launch (which
    takes the run-time-shape library; ``warp=True`` at d <= 64 the
    run-time team library)."""
    team = dim > BUCKETS[-1]
    if kind != "super_funnel" or (warp is not None and warp != team):
        return None
    J, K, n = (int(v) for v in params[:3].tolist())
    fits = (sf_team_words(J, K, n) <= PARAMS_SHARED_MAX if team
            else sf_words(J, K, n) <= SF_FIXED_MAX_WORDS)
    return (J, K, n) if fits else None


def sf_pack(params: torch.Tensor) -> torch.Tensor:
    """The fixed-shape builds' dataset (``csrc/targets.cuh::
    SuperFunnelFixed``) from SuperFunnel's run-time parameter vector
    (:func:`kernel_target`: the head, X_cols (J K, n), Y (J, n)): the head,
    then for each group j and observation i the K signed covariates
    X'_jki = sigma_ji X_jki and sigma_ji = -1 where Y_ji != 0, else +1
    (f32, on the CPU; the launcher copies it into a kernel parameter)."""
    J, K, n = (int(v) for v in params[:3].tolist())
    X = params[SF_HEAD:SF_HEAD + J * K * n].reshape(J, K, n)
    Y = params[SF_HEAD + J * K * n:].reshape(J, n)
    sign = torch.where(Y != 0, -1.0, 1.0).to(torch.float32)
    obs = torch.cat([(X * sign[:, None, :]).permute(0, 2, 1),
                     sign[..., None]], dim=2)
    return torch.cat([params[:SF_HEAD], obs.reshape(-1)]).cpu().contiguous()


def sf_team_stride(K: int, n: int) -> tuple[int, int]:
    """(words a load, words a group) of a fixed team build's dataset
    (``csrc/targets.cuh::SuperFunnelTeamLayout``: kAccess, kStride): an
    observation's K + 1 words as 4-, 2- or 1-word loads, a group's n
    observations padded to an odd number of such loads, so that the groups
    a team's lanes read at once start on distinct banks."""
    a = 4 if (K + 1) % 4 == 0 else 2 if (K + 1) % 2 == 0 else 1
    return a, (n * (K + 1) // a | 1) * a


def sf_team_words(J: int, K: int, n: int) -> int:
    """Words of a fixed team build's dataset (:func:`sf_team_pack`): the
    head padded to :data:`SF_TEAM_HEAD`, then J groups of
    :func:`sf_team_stride` words."""
    return SF_TEAM_HEAD + J * sf_team_stride(K, n)[1]


def sf_team_pack(params: torch.Tensor) -> torch.Tensor:
    """A fixed team build's dataset from SuperFunnel's run-time parameter
    vector: :func:`sf_pack`'s words (labels folded into signs) with the
    head padded to 16 bytes and each group's n (K + 1) words padded to
    :func:`sf_team_stride`'s stride, zeros between (f32, on the CPU; the
    launcher copies it to the card and the kernel into shared memory)."""
    J, K, n = (int(v) for v in params[:3].tolist())
    words = sf_pack(params)
    stride = sf_team_stride(K, n)[1]
    out = torch.zeros(sf_team_words(J, K, n), dtype=torch.float32)
    out[:SF_HEAD] = words[:SF_HEAD]
    out[SF_TEAM_HEAD:].view(J, stride)[:, :n * (K + 1)] = \
        words[SF_HEAD:].view(J, n * (K + 1))
    return out


def sf_team_dmax(d: int, team: int) -> int:
    """The words a row's quads span in a fixed team build of d
    coordinates at team size ``team`` (``csrc/warp.cuh::row_dmax``):
    the smallest multiple of 4 G that holds d + 4, in place of the warp
    bucket (80 at d = 68, G = 4; 192 at d = 166, G = 8)."""
    return -(-(d + 4) // (4 * team)) * 4 * team


def ladder_lib(kind: str, dim: int, stamps: bool = False) -> str:
    """The ladder builder's library for target kind ``kind`` at ``dim``
    coordinates, ``ladder_build.<kind>.d<D>``: ``<D>`` the register bucket
    up to 64 coordinates (:func:`bucket`), above it the warp bucket
    (:func:`warp_bucket`; rolled loops), which raises above
    :data:`MAX_DIM`.  ``stamps``: its measuring build, ``...d<D>.stamps``
    (``-DRWM_PT_LADDER_STAMPS``: ``%globaltimer`` stamps a probe;
    ``ladder_build.probe_split``), which no entry point launches."""
    if kind not in TARGET_KINDS:
        raise ValueError(f"no library {LADDER}.{kind}")
    return f"{LADDER}.{kind}.d" + str(
        bucket(dim) if dim <= BUCKETS[-1] else warp_bucket(dim)) + (
            ".stamps" if stamps else "")


def _source(name: str) -> str:
    if name == PROBES:
        return PROBES
    return LADDER if name.startswith(LADDER + ".") else _parts(name)[0]


def _flags(name: str) -> list[str]:
    if name == PROBES:
        return list(NVCC_FLAGS)
    if name.startswith(LADDER + "."):
        _, kind, tag, *stamps = name.split(".")
        return NVCC_FLAGS + [f"-DRWM_PT_TARGET={TARGET_KINDS[kind]}",
                             f"-DRWM_PT_DMAX={int(tag[1:])}"] + (
                                 ["-DRWM_PT_LADDER_STAMPS"] if stamps else [])
    src, pc, dc, kc, dmax, blocks = _parts(name)
    extra = ([f"-DRWM_PT_TEAMS={sum(library_teams(name))}"]
             if src.endswith(WARP) else [])
    if is_cluster(name):
        extra.append("-DRWM_PT_CLUSTER=1")
    if is_stamps(name):
        extra.append("-DRWM_PT_STAMPS=1")
    sf = fixed_shape(name)
    if sf is not None:
        extra += [f"-DRWM_PT_SF_{k.upper()}={sf[k]}"
                  for k in ("J", "K", "n", "unroll")]
    return NVCC_FLAGS + [f"-DRWM_PT_PROPOSAL={pc}", f"-DRWM_PT_NORMAL={dc}",
                         f"-DRWM_PT_TARGET={kc}", f"-DRWM_PT_DMAX={dmax}",
                         f"-DRWM_PT_MINBLOCKS={blocks}"] + extra


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
    yet, one ``nvcc`` each, all started together.  Returns ``{name: ptxas
    report}``; raises with the compiler's output if any build fails."""
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    names = list(dict.fromkeys(names))
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


# ---------------------------------------------------------------- geometry
# One H100 SM, as the CUDA occupancy calculator counts it (cuda_occupancy.h)
SM_REGISTERS = 65536
REG_SUB_PARTITIONS = 4       # the register file's quarters, one a scheduler
REG_ALLOC_UNIT = 256         # registers a warp is given at a time
SM_WARPS, SM_BLOCKS = 64, 32
SM_SHARED = 228 * 1024       # shared memory with the carveout at its most
BLOCK_SHARED = 227 * 1024    # a block's most dynamic shared memory
BLOCK_RESERVED = 1024        # shared memory the system keeps for each block
PT_BLOCK_THREADS = 320       # csrc/fused_pt.cu: kBlockThreads (256 at a
#                              fixed SuperFunnel shape)
# the threads a block of csrc/fused_pt.cu's runtime-R instantiation holds
# for certain, without a build: its launch bound, one block of
# kBlockThreads; in a build with no launch bound (min_blocks 0) 256, since
# ptxas gives a thread at most 255 registers, 8 warps of the register file
PT_UNBOUND_THREADS = 256
PT_MAX_REPLICAS = 32         # csrc/fused_pt.cu: kMaxReplicas
RWM_THREADS = 128            # csrc/fused_rwm.cu: kThreads
# warp bucket -> the warps a block of csrc/fused_pt_warp.cu's one-warp-a-
# state instantiation (G = 32) takes, its launch bound / 32
PT_WARP_MAX_WARPS = {128: 32, 256: 16, 512: 16, 1024: 16, 2048: 16,
                     4096: 16}
PT_TEAM_THREADS = 512        # fused_pt_warp.cu's launch bound below G = 32
# (target kind, proposal, draw) -> the cluster build's launch bound at
# G = 32 where it is not PT_TEAM_THREADS (csrc/fused_pt_warp.cu::
# kClusterThreads): 25 warps for the builds whose step fits the 72
# registers that leaves (d = 1000, T = 50 over two blocks of 25 rung-teams;
# IIDGamma and the uniform ball spilled at 72 on an H100)
CLUSTER_THREADS = {("mvn_iso", "Normal", "lax_erfinv"): 800,
                   ("rosenbrock", "Normal", "lax_erfinv"): 800}
PT_CLUSTER_THREADS = max(CLUSTER_THREADS.values())   # the most of them
PT_WIDE_THREADS = 640        # its bound at G = 64 and 128 (ten rung-teams
#                              of 64 lanes, five of 128; 96 registers)
# csrc/fused_rwm_warp.cu's launch bounds (kBlockThreads): 256 threads up to
# the 1024 bucket; in the 2048 and 4096 buckets 512 at G = 32 (13 chains at
# d = 2000) and 896 for the wide teams (13 chains of two warps at d = 2000,
# 7 of four at d = 4000: at most 72 registers)
RWM_WARP_THREADS = 256
RWM_WIDER_THREADS = 512
RWM_WIDE_THREADS = 896
PARAMS_SHARED_MAX = 12288    # csrc/fused_*_warp.cu: kParamsShared (words)
SM_COUNT = 132               # the H100 SXM's SMs


class Geometry(NamedTuple):
    """A launch: ``replicas`` a block (RWM: chains), ``threads`` a block,
    ``shared_bytes`` of dynamic shared memory, ``blocks_per_sm`` resident
    at once, ``grid`` blocks (the last one ragged unless ``replicas``
    divides C); PT: whether it takes the instantiation that reads R at
    run time (``runtime_r``) or the 32-replica one; a warp kernel's team
    size G, the lanes a state (``team``: 32 is one warp a state); PT's
    cluster build (:func:`pt_cluster_geometry`): the blocks a cluster
    (``cluster``, 0 for a launch of one block a replica's ladder), which
    hold ``slots`` rung-teams of each of its ``replicas`` each (``grid``
    counts blocks, ``cluster`` a cluster)."""
    replicas: int
    threads: int
    shared_bytes: int
    blocks_per_sm: int
    grid: int
    runtime_r: bool = False
    team: int = 32
    cluster: int = 0
    slots: int = 0


def blocks_per_sm(regs: int, threads: int, shared_bytes: int) -> int:
    """Blocks of ``threads`` threads, ``regs`` registers each and
    ``shared_bytes`` of dynamic shared memory that one SM holds at once:
    the least of the register, warp, block and shared-memory limits, the
    registers given a warp at a time in units of 256 from one quarter of
    the register file."""
    warps = -(-threads // 32)
    per_warp = -(-regs * 32 // REG_ALLOC_UNIT) * REG_ALLOC_UNIT
    quarter = SM_REGISTERS // REG_SUB_PARTITIONS
    by_regs = ((quarter // per_warp) * REG_SUB_PARTITIONS // warps
               if per_warp else SM_BLOCKS)
    by_shared = SM_SHARED // (shared_bytes + BLOCK_RESERVED)
    return min(by_regs, SM_WARPS // warps, SM_BLOCKS, by_shared)


# the kinds whose thread-per-replica log-density reads the proposal at
# run-time indices, from a shared-memory stage row (csrc/mh.cuh::kStage)
STAGE_ROW_KINDS = ("super_funnel",)


def row_words(dmax: int, proposal: str = "Normal",
              draw: str = "icdf", kind: str | None = None,
              fixed: bool = False) -> int:
    """Shared-memory words a thread's rows take (``csrc/mh.cuh``): the
    state row, DMAX + 4 words (16-byte accesses, no bank conflicts), for
    Box-Muller normals the sine row, DMAX/2 + 1 (odd), and for
    :data:`STAGE_ROW_KINDS` the stage row, DMAX + 1 (odd), but in a
    SuperFunnel build of ``fixed`` shape (registers, no stage row)."""
    sines = draw == "bm" and proposal != "Laplace"
    stage = kind in STAGE_ROW_KINDS and not fixed
    return (dmax + 4 + (dmax // 2 + 1 if sines else 0)
            + (dmax + 1 if stage else 0))


def pt_shared_bytes(n_params: int, T: int, d: int, R: int, dmax: int,
                    proposal: str = "Normal", draw: str = "icdf",
                    kind: str | None = None, fixed: bool = False) -> int:
    """Dynamic shared memory of a PT block of R replicas x T rungs at d
    coordinates in bucket ``dmax`` (``csrc/fused_pt.cu::shared_words``):
    the R T threads' rows, parameters (none in a SuperFunnel build of
    ``fixed`` shape, which takes them as a kernel parameter), the ladder,
    the sweep's per-(replica, rung) words and Laplace's (T, d) scales."""
    words = (T * R * row_words(dmax, proposal, draw, kind, fixed)
             + (0 if fixed else n_params)
             + 2 * T + 2 * T * R + 2 * R + 3 * T * R + R
             + (T * d if proposal == "Laplace" else 0))
    return 4 * words


def rwm_shared_bytes(n_params: int, d: int, threads: int, dmax: int,
                     proposal: str = "Normal", draw: str = "icdf",
                     kind: str | None = None, fixed: bool = False) -> int:
    """Dynamic shared memory of an RWM block of ``threads`` chains in
    bucket ``dmax`` (``csrc/fused_rwm.cu::shared_words``): the chains'
    rows, parameters (none at a ``fixed`` SuperFunnel shape) and
    Laplace's (d,) scales."""
    words = (threads * row_words(dmax, proposal, draw, kind, fixed)
             + (0 if fixed else n_params)
             + (d if proposal == "Laplace" else 0))
    return 4 * words


def _check_dim(d: int, dmax: int) -> None:
    if not 1 <= d <= dmax:
        raise ValueError(f"d={d} is not in the register bucket 1..{dmax}")


def pt_block_geometry(regs: int, max_threads: int, d: int, dmax: int,
                      T: int, C: int, proposal: str = "Normal",
                      draw: str = "icdf", n_params: int = 0,
                      kind: str | None = None, fixed: bool = False
                      ) -> Geometry:
    """The fused PT launch of C replicas x T rungs at d coordinates
    (bucket ``dmax``) for a kernel of ``regs`` registers and
    ``max_threads`` threads a block.  Of the R that fit (at most 32
    replicas a block, R T threads within ``max_threads``, the slabs within
    a block's shared memory) it takes the one whose blocks let an SM hold
    the most threads, the largest R of those: R = 32 at the flagship,
    fewer where 32 T threads do not fit or where smaller blocks fill the
    register file better (a 105-register kernel at T = 15 holds one block
    of 21 replicas, 315 threads, but two of 17, 510); ``fixed``: a
    SuperFunnel build of fixed shape (:func:`pt_shared_bytes`).  Raises
    ``ValueError`` when not even one replica's ladder fits."""
    _check_dim(d, dmax)
    if T < 1 or C < 1:
        raise ValueError(f"T={T} and C={C} must be >= 1")
    base = pt_shared_bytes(n_params, T, d, 0, dmax, proposal, draw, kind,
                           fixed)
    per_replica = (pt_shared_bytes(n_params, T, d, 1, dmax, proposal, draw,
                                   kind, fixed) - base)
    r_max = min(PT_MAX_REPLICAS, max_threads // T,
                (BLOCK_SHARED - base) // per_replica)
    if r_max < 1:
        raise ValueError(
            f"one replica's ladder does not fit a block: T={T} rungs of "
            f"d={d} need {T} threads ({max_threads} allowed) and "
            f"{base + per_replica} B of shared memory ({BLOCK_SHARED} B), "
            f"{n_params} of its words the target's parameters")

    def launch(R):
        shared = pt_shared_bytes(n_params, T, d, R, dmax, proposal, draw,
                                 kind, fixed)
        return Geometry(R, R * T, shared, blocks_per_sm(regs, R * T, shared),
                        -(-C // R))

    return max((launch(R) for R in range(1, r_max + 1)),
               key=lambda g: (g.blocks_per_sm * g.threads, g.replicas))


def rwm_block_geometry(regs: int, max_threads: int, d: int, dmax: int,
                       C: int, proposal: str = "Normal", draw: str = "icdf",
                       n_params: int = 0, kind: str | None = None,
                       fixed: bool = False) -> Geometry:
    """The fused RWM launch of C chains at d coordinates (bucket ``dmax``)
    for a kernel of ``regs`` registers and ``max_threads`` threads a
    block: 128 chains a block, fewer where the slabs or ``max_threads``
    do not allow them (``fixed``: :func:`rwm_shared_bytes`).  Raises
    ``ValueError`` when not even one chain fits."""
    _check_dim(d, dmax)
    if C < 1:
        raise ValueError(f"C={C} must be >= 1")
    base = rwm_shared_bytes(n_params, d, 0, dmax, proposal, draw, kind,
                            fixed)
    per_chain = rwm_shared_bytes(n_params, d, 1, dmax, proposal, draw,
                                 kind, fixed) - base
    n = min(RWM_THREADS, max_threads, (BLOCK_SHARED - base) // per_chain)
    if n < 1:
        raise ValueError(
            f"one chain does not fit a block: {base + per_chain} B of "
            f"shared memory ({BLOCK_SHARED} B), {n_params} of its words "
            f"the target's parameters, {max_threads} threads")
    shared = rwm_shared_bytes(n_params, d, n, dmax, proposal, draw, kind,
                              fixed)
    return Geometry(n, n, shared, blocks_per_sm(regs, n, shared), -(-C // n))


# ------------------------------------------------ warp layout (csrc/warp.cuh)
TEAMS = (4, 8, 16, 32)       # the team sizes within a warp (csrc/warp.cuh)
WIDE_TEAMS = (64, 128)       # its teams of two and four warps (the 2048
#                              and 4096 buckets)
WIDE_WORDS = 8     # csrc/warp.cuh::kWideWords: a wide team's exchange words
WIDE_MAX_TEAMS = 15   # csrc/warp.cuh::kMaxWideTeams: named barriers 1..15
# warp bucket -> the team sizes G its libraries instantiate (-DRWM_PT_TEAMS;
# the launchers' switch holds no other): the fastest at the main shape
# (d = 100: G = 4; d = 200: G = 8, where G = 4's 13 block trips a step
# lost) and one warp a state for the grids that fill no SM (measured with
# scripts/bench_torch_warp.py); above d = 252, where a state's rows (2 KB a
# row in the 512 bucket, 4 KB in the 1024 one) cap the states an SM holds,
# G = 16 and 32; in the 2048 and 4096 buckets one warp a state and the
# wide teams of two and four warps (csrc/warp.cuh): a state's rows (8 and
# 16 KB a row) cap the states an SM holds, so G = 32 left 5-10 warps an SM
# (G = 16 would leave half that: its pitch, the bucket plus 16 words, holds
# no more rungs) where G = 64 at d = 2000 and G = 128 at 4000 hold 20
# (T = 10).  The 2048 bucket holds no G = 128: at d = 2000, T = 10 it
# needs a cluster and ran 12-24 % slower than G = 64 in one block (on an
# H100, scripts/bench_torch_warp.py).  G = 32 first, so that rungs_fit
# takes it where the wide teams take no more rungs
WARP_TEAMS = {128: (4, 32), 256: (8, 32), 512: (16, 32), 1024: (16, 32),
              2048: (32, 64), 4096: (32, 64, 128)}
# warp bucket -> the RWM libraries' team sizes where they differ from
# WARP_TEAMS: one warp a chain in the 512 and 1024 buckets.  Forced in
# turns on an H100 (scripts/bench_torch_warp.py --rwm-teams), G = 16 ran
# 2-9 % slower than G = 32 at d = 500 from 4096 to 65,536 chains, where
# choose_team's rule would take it, 1.5x at 1024, and 1.6-2x at d = 1000;
# one team size also halves the libraries' build.  In the 2048 and 4096
# buckets G = 32 and the wide teams, as PT's: a chain's rows cap the chains
# a block holds, so one warp a chain left 8 and 6 warps an SM
RWM_WARP_TEAMS = {512: (32,), 1024: (32,), 2048: (32, 64),
                  4096: (32, 64, 128)}


def team_quads(dmax: int, team: int = 32) -> int:
    """Quads (four words) a lane holds in a row of warp bucket ``dmax``
    with teams of ``team`` lanes: dmax / (4 team); the wide teams
    (:data:`WIDE_TEAMS`) in the 2048 and 4096 buckets only (the layout;
    :data:`WARP_TEAMS` says which a library instantiates)."""
    if (team not in TEAMS + WIDE_TEAMS or dmax % (4 * team)
            or (team > 32 and dmax <= 1024)):
        raise ValueError(f"no team of {team} lanes in warp bucket {dmax}")
    return dmax // (4 * team)


def team_pitch(dmax: int, team: int = 32) -> int:
    """Words of a team's state row and of its scratch row
    (``csrc/warp.cuh::kTeamPitch``): dmax, plus G below G = 32, so that the
    teams of a warp start on distinct banks."""
    team_quads(dmax, team)
    return dmax + (team if team < 32 else 0)


def warp_slot_owner(j: int, team: int = 32) -> tuple[int, int, int]:
    """(team lane, trip, word) that holds Philox slot (and coordinate)
    ``j`` in a warp kernel with teams of ``team`` lanes: slot j = 4q + w is
    word w of block q, which team lane q mod G computes in trip q // G of
    its block loop."""
    q = j >> 2
    return q % team, q // team, j & 3


def warp_blocks(d: int, dmax: int, team: int = 32) -> dict[int, list[int]]:
    """The Philox blocks each lane of a team computes a step at d
    coordinates in warp bucket ``dmax``: block G k + t for each trip
    k < :func:`team_quads` with 4 (G k + t) <= d + 3
    (csrc/warp.cuh::team_block)."""
    nq = team_quads(dmax, team)
    return {t: [team * k + t for k in range(nq)
                if 4 * (team * k + t) <= d + 3] for t in range(team)}


def bm_lanes(k: int, d: int, team: int = 32) -> tuple[int, int, int]:
    """Box-Muller pair ``k`` (< ceil(d/2)) in a warp kernel with teams of
    ``team`` lanes: the team lane that computes it (the owner of
    coordinate k and of u1's slot k), the lane whose block holds u2 (slot
    h + k, or d + 3 for the last pair of an odd d) and the lane of
    coordinate k + h, which reads the sine (-1 where k + h = d: no such
    coordinate)."""
    h = (d + 1) // 2
    j2 = h + k if h + k < d else d + 3
    return (warp_slot_owner(k, team)[0], warp_slot_owner(j2, team)[0],
            warp_slot_owner(k + h, team)[0] if k + h < d else -1)


# the kinds whose warp kernels stage a third row a team
# (csrc/warp.cuh::kTermsRow): the IID kinds' terms, SuperFunnel's group
# likelihoods, the full MVN's x - mean
TERMS_ROW_KINDS = ("iid_gamma", "iid_beta", "mvn_full", "super_funnel")


def team_rows(kind: str | None = None, fixed: bool = False) -> int:
    """Rows of :func:`team_pitch` words a team of a warp kernel keeps in
    shared memory for target kind ``kind`` (``csrc/warp.cuh::kTeamRows``):
    the state and the proposal, and for :data:`TERMS_ROW_KINDS` the
    log-density's terms, but in a build of ``fixed`` SuperFunnel shape,
    whose group sums pass by ``__shfl_sync``."""
    return 3 if kind in TERMS_ROW_KINDS and not fixed else 2


def global_terms(kind: str | None, dmax: int, cluster: bool = False) -> bool:
    """Whether a team kernel keeps target kind ``kind``'s terms row
    (:data:`TERMS_ROW_KINDS`) in global memory, a row a team in a pool of
    block slots (``kGlobalTerms`` of ``csrc/fused_pt_warp.cu`` and
    ``csrc/fused_rwm_warp.cu``), not in shared memory: in the 2048 and
    4096 buckets and in every ``cluster`` build (PT's; a SuperFunnel build
    of fixed shape has no terms row: pass kind None)."""
    return kind in TERMS_ROW_KINDS and (cluster or dmax > 1024)


def pt_team_rows(kind: str | None, dmax: int, cluster: bool = False) -> int:
    """Rows of :func:`team_pitch` words a team of a team kernel keeps in
    shared memory: :func:`team_rows`, less the terms row where
    :func:`global_terms` (RWM's kernel has no ``cluster`` build)."""
    return team_rows(kind) - global_terms(kind, dmax, cluster)


def params_shared_words(n_params: int) -> int:
    """Parameter words a warp kernel keeps in shared memory: all of them up
    to :data:`PARAMS_SHARED_MAX` (12,288 words: the full-covariance MVN to
    d = 110), else none (read through L2)."""
    return n_params if n_params <= PARAMS_SHARED_MAX else 0


def pt_block_threads(R: int, T: int, team: int = 32) -> int:
    """Threads of a warp PT block of R replicas x T rung-teams of ``team``
    lanes: R T G, rounded up to whole warps (the idle teams that pad it
    run on zeros in rows of their own and store nothing)."""
    return -(-R * T * team // 32) * 32


def pt_warp_shared_bytes(n_params: int, T: int, d: int, R: int, dmax: int,
                         proposal: str = "Normal", team: int = 32,
                         kind: str | None = None,
                         rows: int | None = None,
                         slots: int | None = None) -> int:
    """Dynamic shared memory of a warp PT block of R replicas x T
    rung-teams whose rows' quads span ``dmax`` words (the warp bucket, or
    :func:`sf_team_dmax`; ``csrc/fused_pt_warp.cu::shared_words``): a wide
    team's :data:`WIDE_WORDS` (G > 32), each team's ``rows`` rows (by
    default :func:`pt_team_rows` of ``kind``; the idle teams of
    :func:`pt_block_threads` too), the parameters that fit, the ladder, the
    sweep's words (its per-replica sums too), the block's slot of the
    terms pool (:func:`global_terms`) and Laplace's (T, d) scales.
    ``slots``: a block of the cluster build, which holds that many
    rung-teams of each replica and reads Laplace's scales through L2 (its
    sweep's words sized by T as in every block)."""
    cluster = slots is not None
    terms = rows is None and global_terms(kind, dmax, cluster)
    rows = pt_team_rows(kind, dmax, cluster) if rows is None else rows
    teams = pt_block_threads(R, T if slots is None else slots, team) // team
    words = ((teams * WIDE_WORDS if team > 32 else 0)
             + teams * rows * team_pitch(dmax, team)
             + params_shared_words(n_params) + 2 * T
             + 2 * T * R + 5 * R + 3 * T * R + R + int(terms)
             + (T * d if proposal == "Laplace" and slots is None else 0))
    return 4 * words


def rwm_warp_shared_bytes(n_params: int, d: int, chains: int, dmax: int,
                          proposal: str = "Normal", team: int = 32,
                          kind: str | None = None,
                          rows: int | None = None) -> int:
    """Dynamic shared memory of a warp RWM block of ``chains`` teams
    (``csrc/fused_rwm_warp.cu::shared_words``; ``dmax`` and ``rows`` as for
    :func:`pt_warp_shared_bytes`): a wide team's :data:`WIDE_WORDS`, the
    rows (by default :func:`pt_team_rows` of ``kind``), the parameters
    that fit, Laplace's (d,) scales and the block's slot of the terms pool
    (:func:`global_terms`)."""
    terms = rows is None and global_terms(kind, dmax)
    rows = pt_team_rows(kind, dmax) if rows is None else rows
    words = ((chains * WIDE_WORDS if team > 32 else 0)
             + chains * rows * team_pitch(dmax, team)
             + params_shared_words(n_params)
             + (d if proposal == "Laplace" else 0) + int(terms))
    return 4 * words


def _check_warp_dim(d: int, dmax: int) -> None:
    if not 1 <= d <= dmax - 4:
        raise ValueError(f"d={d} is not in the warp bucket 1..{dmax - 4}")


def pt_team_threads(dmax: int, team: int = 32, cluster: bool = False,
                    kind: str | None = None, proposal: str = "Normal",
                    draw: str | None = None) -> int:
    """The launch bound of ``csrc/fused_pt_warp.cu``'s team-size-``team``
    instantiation in warp bucket ``dmax``: 32 :data:`PT_WARP_MAX_WARPS`
    threads at G = 32, :data:`PT_TEAM_THREADS` below,
    :data:`PT_WIDE_THREADS` above; in the ``cluster`` build of target kind
    ``kind`` under ``proposal`` and ``draw`` at G = 32 its
    :data:`CLUSTER_THREADS` (``kind`` None: the most a build takes;
    ``draw`` None: the least over the draws, which every draw takes)."""
    if team > 32:
        return PT_WIDE_THREADS
    if team == 32 and cluster:
        if kind is None:
            return PT_CLUSTER_THREADS
        return min(CLUSTER_THREADS.get((kind, proposal, dr), PT_TEAM_THREADS)
                   for dr in ([draw] if draw else DRAWS))
    if team == 32:
        return 32 * PT_WARP_MAX_WARPS[dmax]
    return PT_TEAM_THREADS


def rwm_team_threads(dmax: int, team: int = 32) -> int:
    """The launch bound of ``csrc/fused_rwm_warp.cu``'s team-size-``team``
    instantiation in warp bucket ``dmax`` (``kBlockThreads``):
    :data:`RWM_WIDE_THREADS` for the wide teams, :data:`RWM_WIDER_THREADS`
    at G = 32 in the 2048 and 4096 buckets, else
    :data:`RWM_WARP_THREADS`."""
    if team > 32:
        return RWM_WIDE_THREADS
    return RWM_WIDER_THREADS if dmax > 1024 else RWM_WARP_THREADS


def barriers_fit(threads: int, team: int) -> bool:
    """Whether a block of ``threads`` has a named barrier for each of its
    teams of ``team`` lanes: at most :data:`WIDE_MAX_TEAMS` wide teams
    (G > 32; ``csrc/warp.cuh::barriers_ok``)."""
    return team <= 32 or threads // team <= WIDE_MAX_TEAMS


def pt_warp_geometry(regs: int, max_threads: int, d: int, dmax: int,
                     T: int, C: int, proposal: str = "Normal",
                     draw: str = "icdf", n_params: int = 0,
                     team: int = 32, kind: str | None = None,
                     rows: int | None = None) -> Geometry:
    """The warp PT launch of C replicas x T rungs at d coordinates (``rows``
    rows of ``dmax`` words, :func:`pt_warp_shared_bytes`) with teams of
    ``team`` lanes, for a kernel of ``regs`` registers and ``max_threads``
    threads a block: R replicas of T rung-teams, :func:`pt_block_threads` within :func:`pt_team_threads`
    and ``max_threads``, the rows within a block's shared memory.  Of those
    R, the whole-warp ones (R T G a multiple of 32) where any fits, else
    all (padded with idle teams: an odd T of 17 to 31 at G = 8 makes no
    whole warp within 512 threads); of those the one whose blocks let an
    SM hold the most threads, the largest R of those (3 at T = 10 and
    G = 32).  ``draw`` takes no shared memory of its own here (Box-Muller's
    sines use the scratch row).  Raises ``ValueError`` when not even one
    replica's ladder fits."""
    _check_warp_dim(d, dmax)
    if T < 1 or C < 1:
        raise ValueError(f"T={T} and C={C} must be >= 1")
    cap = min(pt_team_threads(dmax, team), max_threads)

    def shared(R):
        return pt_warp_shared_bytes(n_params, T, d, R, dmax, proposal, team,
                                    kind, rows)

    fits = [R for R in range(1, cap // (team * T) + 1)
            if pt_block_threads(R, T, team) <= cap
            and barriers_fit(pt_block_threads(R, T, team), team)
            and shared(R) <= BLOCK_SHARED]
    if not fits:
        raise ValueError(
            f"one replica's ladder does not fit a block: T={T} rung-teams "
            f"of {team} lanes need {pt_block_threads(1, T, team)} threads "
            f"({cap} allowed) and {shared(1)} B of shared memory "
            f"({BLOCK_SHARED} B)")
    whole = [R for R in fits if R * T * team % 32 == 0]

    def launch(R):
        threads = pt_block_threads(R, T, team)
        return Geometry(R, threads, shared(R),
                        blocks_per_sm(regs, threads, shared(R)), -(-C // R),
                        team=team)

    return max((launch(R) for R in whole or fits),
               key=lambda g: (g.blocks_per_sm * g.threads, g.replicas))


CLUSTER_MAX = 8   # blocks a cluster: the portable cluster size


def pt_cluster_geometry(regs: int, max_threads: int, d: int, dmax: int,
                        T: int, C: int, proposal: str = "Normal",
                        draw: str = "icdf", n_params: int = 0,
                        team: int = 32, kind: str | None = None,
                        rows: int | None = None,
                        cluster: int | None = None) -> Geometry:
    """The launch of PT's cluster build (``csrc/fused_pt_warp.cu`` with
    ``-DRWM_PT_CLUSTER``) of C replicas x T rungs: a cluster of k blocks
    holds R replicas, each block ``slots`` = ceil(T / k) rung-teams of
    each of them (the last block's ragged slots idle teams).  k is
    ``cluster``, else the smallest k <= :data:`CLUSTER_MAX` for which a
    block of one replica fits (:func:`pt_team_threads` of the cluster
    build, ``max_threads``,
    :func:`pt_warp_shared_bytes` with ``slots``); R as
    :func:`pt_warp_geometry` takes it for that block.  ``grid`` counts
    blocks: k a cluster.  Raises ``ValueError`` when no cluster of at
    most :data:`CLUSTER_MAX` blocks (of ``cluster``) fits one replica."""
    _check_warp_dim(d, dmax)
    if T < 1 or C < 1:
        raise ValueError(f"T={T} and C={C} must be >= 1")
    cap = min(pt_team_threads(dmax, team, True, kind, proposal, draw),
              max_threads)

    def shared(R, slots):
        return pt_warp_shared_bytes(n_params, T, d, R, dmax, proposal, team,
                                    kind, rows, slots)

    for k in ([cluster] if cluster else range(1, CLUSTER_MAX + 1)):
        slots = -(-T // k)
        fits = [R for R in range(1, cap // (team * slots) + 1)
                if pt_block_threads(R, slots, team) <= cap
                and barriers_fit(pt_block_threads(R, slots, team), team)
                and shared(R, slots) <= BLOCK_SHARED]
        if fits:
            break
    else:
        k = cluster or CLUSTER_MAX
        slots = -(-T // k)
        raise ValueError(
            f"one replica's ladder does not fit a cluster of {k} blocks: "
            f"T={T} rung-teams of {team} lanes, {slots} a block, need "
            f"{pt_block_threads(1, slots, team)} threads ({cap} allowed) "
            f"and {shared(1, slots)} B of shared memory ({BLOCK_SHARED} B) "
            f"a block")
    whole = [R for R in fits if R * slots * team % 32 == 0]

    def launch(R):
        threads = pt_block_threads(R, slots, team)
        return Geometry(R, threads, shared(R, slots),
                        blocks_per_sm(regs, threads, shared(R, slots)),
                        -(-C // R) * k, team=team, cluster=k, slots=slots)

    return max((launch(R) for R in whole or fits),
               key=lambda g: (g.blocks_per_sm * g.threads, g.replicas))


def rwm_warp_geometry(regs: int, max_threads: int, d: int, dmax: int,
                      C: int, proposal: str = "Normal", draw: str = "icdf",
                      n_params: int = 0, sms: int = SM_COUNT,
                      team: int = 32, kind: str | None = None,
                      rows: int | None = None) -> Geometry:
    """The warp RWM launch of C chains at d coordinates (``rows`` rows of
    ``dmax`` words, :func:`rwm_warp_shared_bytes`; by default those of
    ``kind``) with teams of ``team`` lanes: the most chains a block (G
    chains a multiple of 32, within :func:`rwm_team_threads`,
    ``max_threads``, a block's shared memory and, for a wide team, the
    named barriers, :func:`barriers_fit`) whose grid still gives each of
    the ``sms`` SMs a block (512 chains at G = 32: 3 a block, 171 blocks),
    the fewest a block when none does.  ``replicas`` is the chains (teams)
    a block, ``threads`` G of them.  Raises ``ValueError`` when not even
    one chain fits."""
    _check_warp_dim(d, dmax)
    if C < 1:
        raise ValueError(f"C={C} must be >= 1")
    fixed = rwm_warp_shared_bytes(n_params, d, 0, dmax, proposal, team,
                                  kind, rows)
    per_chain = rwm_warp_shared_bytes(n_params, d, 1, dmax, proposal,
                                      team, kind, rows) - fixed
    step = max(32 // team, 1)             # a warp's teams
    n = min(min(rwm_team_threads(dmax, team), max_threads) // team,
            (BLOCK_SHARED - fixed) // per_chain)
    if team > 32:
        n = min(n, WIDE_MAX_TEAMS)
    n -= n % step
    if n < step:
        raise ValueError(
            f"one chain does not fit a block: {fixed + step * per_chain} B "
            f"of shared memory ({BLOCK_SHARED} B), {max_threads} threads")
    while n > step and -(-C // n) < sms:
        n -= step
    shared = rwm_warp_shared_bytes(n_params, d, n, dmax, proposal, team,
                                   kind, rows)
    return Geometry(n, team * n, shared,
                    blocks_per_sm(regs, team * n, shared), -(-C // n),
                    team=team)


def block_trips(d: int, team: int = 32) -> int:
    """Trips of a warp kernel's block loop a step at d coordinates with
    teams of ``team`` lanes (``csrc/warp.cuh::block_trips``): the Philox
    blocks a lane computes in series, ceil((floor((d + 3) / 4) + 1) / G)."""
    return ((d + 3) // 4) // team + 1


def fills(geo: Geometry, sms: int = SM_COUNT) -> bool:
    """Whether a launch fills the card: its grid is at least half a wave
    of the blocks that ``sms`` SMs hold at once.  Measured on the H100
    with each team size forced (scripts/bench_torch_warp.py's ``GRIDS``):
    the small team lost at up to 0.39 of a wave and won from 0.65."""
    return 2 * geo.grid >= sms * max(geo.blocks_per_sm, 1)


# Warps an SM a team size's launch must keep resident to be taken over a
# larger team's.  Above d = 252 a state's rows cap the states an SM holds,
# so a smaller team holds fewer warps: on an H100 (scripts/
# bench_torch_warp.py) G = 16 at d = 1000 kept 10 warps an SM and ran
# 1.5-1.6x slower than G = 32's 20 (PT), while at d = 500 its 25 ran 7-15 %
# faster than G = 32's 50; every smaller team the buckets up to d = 252
# pick keeps 20-32.
MIN_TEAM_WARPS = 16


def resident_warps(geo: Geometry) -> int:
    """Warps of a launch that an SM holds at once."""
    return geo.blocks_per_sm * -(-geo.threads // 32)


def choose_team(geos: dict[int, Geometry], d: int, sms: int = SM_COUNT
                ) -> Geometry:
    """Of the launches a warp library offers at d coordinates, one per team
    size G that fits (``{G: Geometry}``), the smallest G whose grid still
    fills the ``sms`` SMs (:func:`fills`) and whose blocks keep
    :data:`MIN_TEAM_WARPS` warps an SM resident (:func:`resident_warps`):
    a team's fixed work a step is shared by 32 / G states a warp, but an
    SM short of warps hides no latency (of the filling launches none keeps
    them: the most warps, then the smallest G).  Where none fills, the
    card runs at a step's latency, which grows with the block loop's trips
    (:func:`block_trips`): the smallest G of the fewest trips."""
    if not geos:
        raise ValueError("no team size of the library fits the launch")
    full = [g for g in sorted(geos) if fills(geos[g], sms)]
    if full:
        busy = [g for g in full
                if resident_warps(geos[g]) >= MIN_TEAM_WARPS]
        return geos[busy[0] if busy else max(
            full, key=lambda g: (resident_warps(geos[g]), -g))]
    least = min(block_trips(d, g) for g in geos)
    return geos[min(g for g in geos if block_trips(d, g) == least)]


_INFO: dict[tuple, tuple] = {}


def kernel_info(name: str, d: int, T: int = 1, R: int = 1,
                n_params: int = 0, runtime_r: bool = False,
                team: int = 32, cluster: int = 0) -> dict:
    """What library ``name``'s kernel and the CUDA runtime say of a launch
    at d coordinates (PT: T rungs, R replicas a block, the instantiation
    with a runtime R or the compile-time one; RWM: R chains a block; a warp
    library: the instantiation of team size ``team``; PT's cluster build:
    R replicas a cluster of ``cluster`` blocks): ``registers``,
    ``max_threads`` (``maxThreadsPerBlock``), ``local_bytes`` a thread,
    ``shared_bytes`` (a block's), ``blocks_per_sm``
    (``cudaOccupancyMaxActiveBlocksPerMultiprocessor``; 0 where the launch
    does not fit) and ``clusters`` (the cluster build's
    ``cudaOccupancyMaxActiveClusters``, the clusters the card holds at
    once; else 0).  Needs the card."""
    key = (name, d, T, R, n_params, runtime_r, team, cluster)
    if key not in _INFO:
        out = (ctypes.c_int * 6)()
        warp = is_warp(name)
        if _source(name).startswith("fused_pt") and warp:
            rc = entry(name, "rwm_pt_fused_pt_info")(
                team, cluster, d, T, R, n_params, out)
        elif _source(name).startswith("fused_pt"):
            rc = entry(name, "rwm_pt_fused_pt_info")(
                int(runtime_r), d, T, R, n_params, out)
        elif warp:
            rc = entry(name, "rwm_pt_fused_rwm_info")(team, d, R, n_params,
                                                      out)
        else:
            rc = entry(name, "rwm_pt_fused_rwm_info")(d, R, n_params, out)
        check_launch(name, rc)
        _INFO[key] = tuple(out)
    return dict(zip(("registers", "max_threads", "local_bytes",
                     "shared_bytes", "blocks_per_sm", "clusters"),
                    _INFO[key]))


# the kinds whose libraries hold no wide team: SuperFunnel's run-time
# shape, whose PT step took 119 registers at G = 32 (PERF.md §6), above the
# 96 that PT's wide teams' 640-thread bound leaves and the 72 of RWM's 896
NO_WIDE_KINDS = ("super_funnel",)


def wide_teams_ok(name: str) -> bool:
    """Whether warp library ``name`` holds the wide teams
    (:data:`WIDE_TEAMS`) of its bucket: not for :data:`NO_WIDE_KINDS`, nor
    for PT's one-block Laplace build of a kind with a terms row, which
    stages its (T, d) scales and spilled 12 B at the wide teams' 96
    registers (IIDGamma on an H100; its cluster build, which reads them
    through L2, holds them)."""
    src, pc, _, _, _, _ = _parts(name)
    kind = name.split(".")[1]
    laplace = pc == PROPOSALS["Laplace"][1]
    pt = src.startswith("fused_pt")
    return kind not in NO_WIDE_KINDS and not (
        pt and laplace and kind in TERMS_ROW_KINDS and not is_cluster(name))


# the kinds whose log-density every lane of a team sums over all d words in
# index order (csrc/warp.cuh: IIDGamma's and IIDBeta's terms, NealFunnel's
# squares): a wide team repeats that serial sum in two or four times the
# lanes, and RWM's lost there (IIDGamma at d = 2000, 65,536 chains on an
# H100: G = 64 284.3 ms at 28 warps an SM, G = 32 226.4 ms at 14;
# scripts/bench_torch_warp.py), so RWM's geometry keeps one warp a chain
# for them; the libraries still hold the wide teams, which team= forces
# (the holds that show them bit for bit G = 32's)
SERIAL_LP_KINDS = ("iid_gamma", "iid_beta", "neal_funnel")


def geometry_teams(name: str, T: int = 0) -> tuple[int, ...]:
    """The team sizes :func:`launch_geometry` weighs for warp library
    ``name`` (PT when ``T`` is given): :func:`library_teams`, for PT with
    its cluster build's (which may hold a wide team the one-block build
    does not: :func:`wide_teams_ok`); RWM's of :data:`SERIAL_LP_KINDS`
    no wider than a warp."""
    teams = set(library_teams(name))
    if T:
        teams |= set(library_teams(cluster_lib(name)))
    elif name.split(".")[1] in SERIAL_LP_KINDS:
        teams = {g for g in teams if g <= 32}
    return tuple(sorted(teams))


def library_teams(name: str) -> tuple[int, ...]:
    """The team sizes warp library ``name`` instantiates
    (:data:`WARP_TEAMS`, :data:`RWM_WARP_TEAMS`; the wide teams where
    :func:`wide_teams_ok`)."""
    src, _, _, _, dmax, _ = _parts(name)
    teams = (RWM_WARP_TEAMS.get(dmax, WARP_TEAMS[dmax])
             if src == "fused_rwm" + WARP else WARP_TEAMS[dmax])
    return teams if wide_teams_ok(name) else tuple(g for g in teams
                                                   if g <= 32)


def _cluster_geometry(name: str, d: int, C: int, T: int, proposal: str,
                      draw: str, n_params: int, team: int, words: int,
                      rows: int | None, cluster: int | None) -> Geometry:
    """:func:`pt_cluster_geometry` of library ``name``'s cluster build
    (:func:`cluster_lib`) at team size ``team``: the smallest k whose
    blocks fit and whose cluster the card schedules
    (``cudaOccupancyMaxActiveClusters`` >= 1), or the k of ``cluster``
    (forced, for comparisons: a cluster the card refuses raises at the
    launch)."""
    lib = cluster_lib(name)
    a = kernel_info(lib, d, team=team, cluster=1)
    kind = None if rows is not None else name.split(".")[1]
    for k in ([cluster] if cluster else range(1, CLUSTER_MAX + 1)):
        try:
            geo = pt_cluster_geometry(
                a["registers"], a["max_threads"], d, words, T, C, proposal,
                draw, n_params, team=team, kind=kind, rows=rows, cluster=k)
        except ValueError:
            if cluster:
                raise
            continue
        if cluster or kernel_info(lib, d, T, geo.replicas, n_params,
                                  team=team, cluster=k)["clusters"] >= 1:
            return geo
    raise ValueError(f"no cluster of {lib} at G={team} that the card "
                     f"schedules takes T={T} rungs at d={d}")


def launch_geometry(name: str, d: int, C: int, T: int = 0,
                    proposal: str = "Normal", draw: str = "icdf",
                    n_params: int = 0, team: int | None = None,
                    cluster: int | None = None) -> Geometry:
    """The geometry of a launch of library ``name`` (PT when ``T`` is
    given), from its kernel's registers and ``maxThreadsPerBlock``: the
    compile-time 32-replica PT instantiation where its attributes allow 32
    replicas, else the runtime-R one with its own attributes; a warp
    library's :func:`pt_warp_geometry` / :func:`rwm_warp_geometry` for each
    team size it holds that fits, and for PT, at a team size where one
    block does not hold a replica's ladder, its cluster build's
    (:func:`pt_cluster_geometry`; ``geo.cluster`` > 0: launch
    :func:`cluster_lib`), of which :func:`choose_team` takes one (``team``
    forces one, ``cluster`` the cluster build with that many blocks a
    cluster, as does a cluster library's ``name``; both for
    comparisons)."""
    dmax = _parts(name)[4]
    fixed = fixed_shape(name) is not None
    if is_warp(name):
        kind = name.split(".")[1]
        one = library_teams(name)
        teams = tuple(sorted(set(one) | set(
            library_teams(cluster_lib(name)) if T else ())))
        if team is not None and team not in teams:
            raise ValueError(f"{name} holds teams of {teams} lanes, not "
                             f"{team}")
        forced = cluster is not None or is_cluster(name)
        if forced and not T:
            raise ValueError(f"{name}: the cluster build is PT's")
        geos = {}
        # the rows of the kind (pt_team_rows: the terms row in global
        # memory in the 2048 and 4096 buckets and PT's cluster build), but
        # a fixed shape's two
        rows = team_rows(kind, fixed) if fixed else None
        for g in ([team] if team is not None else geometry_teams(name, T)):
            # a fixed shape's rows are sized by d (csrc/warp.cuh::row_dmax)
            words = sf_team_dmax(d, g) if fixed else dmax
            try:
                if not forced and g in one:
                    a = kernel_info(name, d, team=g)
                    try:
                        geos[g] = (pt_warp_geometry(
                            a["registers"], a["max_threads"], d, words, T,
                            C, proposal, draw, n_params, team=g, kind=kind,
                            rows=rows)
                            if T else rwm_warp_geometry(
                                a["registers"], a["max_threads"], d, words,
                                C, proposal, draw, n_params, team=g,
                                kind=kind, rows=rows))
                        continue
                    except ValueError:
                        if not T:   # RWM has no cluster build
                            raise
                # PT where one block does not hold the ladder, or forced
                geos[g] = _cluster_geometry(name, d, C, T, proposal, draw,
                                            n_params, g, words, rows,
                                            cluster)
            except ValueError:
                if team is not None:
                    raise
        return choose_team(geos, d)
    for opt, val in (("team", team), ("cluster", cluster)):
        if val is not None:
            raise ValueError(f"{name} runs one thread a state: {opt}= is "
                             "for the warp libraries")
    kind = name.split(".")[1]
    if not T:
        a = kernel_info(name, d)
        return rwm_block_geometry(a["registers"], a["max_threads"], d, dmax,
                                  C, proposal, draw, n_params, kind, fixed)
    a = kernel_info(name, d)
    geo = pt_block_geometry(a["registers"], a["max_threads"], d, dmax, T, C,
                            proposal, draw, n_params, kind, fixed)
    if geo.replicas == PT_MAX_REPLICAS:
        return geo
    a = kernel_info(name, d, runtime_r=True)
    return pt_block_geometry(a["registers"], a["max_threads"], d, dmax, T, C,
                             proposal, draw, n_params, kind,
                             fixed)._replace(runtime_r=True)


def terms_pool(name: str, geo: Geometry, d: int, T: int, n_params: int,
               device) -> tuple:
    """``(rows, claim, pool)`` of a launch of warp library ``name`` (PT's
    at T rungs, RWM's at T = 1) at ``geo``: where the kernel keeps its
    terms row in global memory (:func:`global_terms`), ``pool`` block
    slots of a row for each team of a block (f32, uninitialised; the CUDA occupancy calculator's
    resident blocks an SM, plus one, times the card's SMs: a block always
    finds a free slot, since no more blocks run at once) and their claim
    bitmask (int32, zeroed; every block frees its bit when it ends); else
    ``(None, None, 0)``."""
    kind, dmax = name.split(".")[1], _parts(name)[4]
    if (fixed_shape(name) is not None
            or not global_terms(kind, dmax, is_cluster(name))):
        return None, None, 0
    resident = kernel_info(name, d, T, geo.replicas, n_params, team=geo.team,
                           cluster=geo.cluster)["blocks_per_sm"]
    sms = torch.cuda.get_device_properties(device).multi_processor_count
    pool = sms * (max(resident, geo.blocks_per_sm, 1) + 1)
    rows = torch.empty(pool * (geo.threads // geo.team)
                       * team_pitch(dmax, geo.team), dtype=torch.float32,
                       device=device)
    claim = torch.zeros(-(-pool // 32), dtype=torch.int32, device=device)
    return rows, claim, pool


class Shard(NamedTuple):
    """What one shard of a sharded fused run (``fused_sharded.py``) gives
    ``run_pt_fused`` / ``run_rwm_fused``: its first replica and rung (PT
    only: an RWM run draws at rung 0), added to the Philox counter's
    (``csrc/philox.cuh``), and the team size and
    normal draw that the whole run resolved (None: the launch resolves
    them), so that every shard runs the unsharded launch's layout;
    ``plain`` runs the shard's plain version on its device (for holding a
    sharded run against its plain version on the card)."""
    replica0: int = 0
    rung0: int = 0
    team: int | None = None
    draw: str | None = None
    plain: bool = False


# ---------------------------------------------------------------- targets
MAX_DIM = WARP_BUCKETS[-1] - 4   # the largest d a warp bucket holds (4092)
class RungsFit(NamedTuple):
    """The most rungs a fused PT launch takes (``rungs``) and the layout
    that sets them (``layout``, for the refusals' messages)."""
    rungs: int
    layout: str


def _largest(fits, hi: int) -> int:
    """The largest T in 1..hi for which ``fits(T)`` holds (``fits`` holds
    for every T below one for which it holds), 0 if none."""
    lo = 0
    while lo < hi:
        mid = (lo + hi + 1) // 2
        lo, hi = (mid, hi) if fits(mid) else (lo, mid - 1)
    return lo


def pt_runtime_threads(kind: str, dmax: int) -> int:
    """The threads a block of ``csrc/fused_pt.cu``'s runtime-R
    instantiation holds on target kind ``kind`` in register bucket
    ``dmax``, known without a build: its launch bound
    :data:`PT_BLOCK_THREADS`; :data:`PT_UNBOUND_THREADS` in a build with no
    launch bound (:func:`min_blocks` 0) and for SuperFunnel, whose
    fixed-shape builds bind 256 threads (its run-time-shape build, 320,
    is held to the same)."""
    if kind == "super_funnel" or min_blocks("fused_pt", kind, dmax) == 0:
        return PT_UNBOUND_THREADS
    return PT_BLOCK_THREADS


@functools.lru_cache(maxsize=None)
def rungs_fit(dim: int, kind: str | None = None, proposal: str = "Normal",
              n_params: int | None = None) -> RungsFit:
    """The most rungs T a fused PT launch takes at ``dim`` coordinates on
    target kind ``kind`` under ``proposal`` (``n_params`` parameter words;
    None: the most a block stages, :data:`PARAMS_SHARED_MAX`; ``kind``
    None: the least over the kinds), for every normal draw, computed
    without a build:

    * up to 64 dimensions, one replica of T threads in one block of the
      thread kernel's runtime-R instantiation: T within
      :func:`pt_runtime_threads` (320, or 256) and its rows (Box-Muller's
      sine row, the most a draw takes) within a block's shared memory
      (0 where the parameters alone fill it: a SuperFunnel dataset that
      no block holds, which :func:`pt_block_geometry` refuses);
    * above, the team kernels: one replica's T rung-teams over a cluster
      of at most :data:`CLUSTER_MAX` blocks (:func:`pt_cluster_geometry`,
      which one block's launch never beats), at the warp bucket's team
      size that takes the most.

    At least 64 rungs at every d <= 1020 and at least 24 at every d <=
    :data:`MAX_DIM` (4092: three 16 KB rows a rung-team and up to 48 KB of
    staged parameters leave a block of the 4096 bucket three rung-teams)
    for every kind and proposal (tests/test_torch_rungs.py,
    tests/test_torch_wider.py)."""
    if kind is None:
        return min((rungs_fit(dim, k, proposal, n_params)
                    for k in TARGET_KINDS), key=lambda f: f.rungs)
    words = PARAMS_SHARED_MAX if n_params is None else n_params
    if dim <= BUCKETS[-1]:
        dmax = bucket(dim)
        cap = pt_runtime_threads(kind, dmax)
        T = _largest(lambda T: pt_shared_bytes(
            words, T, dim, 1, dmax, proposal, "bm", kind) <= BLOCK_SHARED,
            cap)
        if not T:   # the launch's geometry refuses it, naming the words
            return RungsFit(0, f"no rung: {words} parameter words fill a "
                               f"block's shared memory")
        return RungsFit(T, f"one thread a rung: one replica's ladder in one "
                           f"block of the runtime-R instantiation, "
                           + (f"{cap} threads" if T == cap else
                              f"{BLOCK_SHARED} B of shared memory"))
    dmax = warp_bucket(dim)
    best = None
    for g in WARP_TEAMS[dmax]:
        cap = pt_team_threads(dmax, g, True, kind, proposal)

        def fits(T, cap=cap, g=g):
            try:
                pt_cluster_geometry(0, cap, dim, dmax, T, 1, proposal,
                                    n_params=words, team=g, kind=kind)
                return True
            except ValueError:
                return False

        T = _largest(fits, CLUSTER_MAX * (cap // g))
        if best is None or T > best[0]:
            slots = -(-T // CLUSTER_MAX)
            by = ("threads" if pt_block_threads(1, slots + 1, g) > cap
                  else "shared memory")
            best = (T, f"teams of {g} lanes over a cluster of {CLUSTER_MAX}"
                       f" blocks, {slots} rung-teams a block by its {by}")
    return RungsFit(*best)


def max_rungs(dim: int, kind: str | None = None, proposal: str = "Normal",
              n_params: int | None = None) -> int:
    """Rungs a fused PT launch takes: :func:`rungs_fit`'s."""
    return rungs_fit(dim, kind, proposal, n_params).rungs


def target_rungs_fit(target, proposal: str = "Normal") -> RungsFit:
    """:func:`rungs_fit` of a fused PT run on ``target`` under
    ``proposal``: its kind and its parameter words
    (:func:`kernel_target`); for a target the kernels do not take (which
    the fused samplers refuse) the defaults' at its d, or above
    :data:`MAX_DIM` at MAX_DIM: room for the ladder of a run that another
    engine may take."""
    try:
        kind, params = kernel_target(target)
    except NotImplementedError:
        return rungs_fit(min(target.dim, MAX_DIM), proposal=proposal)
    return rungs_fit(target.dim, kind, proposal, params.numel())


def target_max_rungs(target, proposal: str = "Normal") -> int:
    """:func:`max_rungs` of a fused PT run on ``target`` under
    ``proposal`` (:func:`target_rungs_fit`)."""
    return target_rungs_fit(target, proposal).rungs


_LOG_2PI = math.log(2.0 * math.pi)


# id(target) -> (a weak reference to it, {key: what per_target made})
_PER_TARGET: dict = {}


def _f32(*parts) -> torch.Tensor:
    return torch.cat([torch.as_tensor(p).to(torch.float32).reshape(-1)
                      .cpu() for p in parts]).contiguous()


_KIND_OF = {"FullRosenbrock": "rosenbrock",
            "ScaledMultivariateNormal": "scaled_mvn",
            "ThreeMixture": "three_mixture", "RoughCarpet": "rough_carpet",
            "EvenRosenbrock": "even_rosenbrock",
            "HybridRosenbrock": "hybrid_rosenbrock", "Hypercube": "hypercube",
            "IIDGamma": "iid_gamma", "IIDBeta": "iid_beta",
            "NealFunnel": "neal_funnel", "SuperFunnel": "super_funnel"}


def target_kind(target) -> str | None:
    """The kernel kind (:data:`TARGET_KINDS`) of ``target``, or None for a
    target the kernels do not take."""
    name = type(target).__name__
    if name == "MultivariateNormal":
        return "mvn_iso" if target.iso else "mvn_full"
    return _KIND_OF.get(name)


def per_target(target, key, make):
    """``make()``, made once for ``target`` under ``key`` and kept while
    the target lives (the targets are frozen dataclasses): its words, their
    copies on a device.  Nothing is kept where ``make`` raises."""
    hit = _PER_TARGET.get(id(target))
    if hit is not None and hit[0]() is target and key in hit[1]:
        return hit[1][key]
    value = make()   # which may keep words of its own (kernel_target)
    hit = _PER_TARGET.get(id(target))
    if hit is None or hit[0]() is not target:
        hit = (weakref.ref(target), {})
        _PER_TARGET[id(target)] = hit
        weakref.finalize(target, _PER_TARGET.pop, id(target), None)
    hit[1][key] = value
    return value


def kernel_target(target) -> tuple[str, torch.Tensor]:
    """(kind, f32 parameter vector on the CPU) of a target the kernels
    take, laid out as ``csrc/targets.cuh`` (and ``csrc/warp.cuh``) reads
    it, made once a target (:func:`per_target`: the copies from the
    target's device are made once).  A target of no kind (a class outside
    the registry's), and a dim above :data:`MAX_DIM`, raises
    ``NotImplementedError``: there is no fallback."""
    return per_target(target, "kernel_target",
                      lambda: _kernel_target(target))


def _kernel_target(target) -> tuple[str, torch.Tensor]:
    kind = target_kind(target)
    if kind is None:
        raise NotImplementedError(
            f"fused CUDA kernels take the registry's targets, each a kind "
            f"of csrc/targets.cuh; {type(target).__name__!r} is not one of "
            f"them (run it on the eager engine, engine='scan')")
    if target.dim > MAX_DIM:
        warp_bucket(target.dim)          # raises, naming the warp layout
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
    if kind == "super_funnel":
        # the constants as the plain version rounds them, on its device
        J, K = t.J, t.K
        hv = t.prior_hypermean_std * t.prior_hypermean_std
        s = t.prior_tau_scale
        f = torch.float32
        return kind, _f32(
            J, K, t.Y.shape[1], torch.tensor(-0.5 * J * _LOG_2PI, dtype=f),
            torch.tensor(-0.5 * J * K * _LOG_2PI, dtype=f), hv,
            -0.5 * _LOG_2PI - 0.5 * torch.log(hv),
            -0.5 * K * _LOG_2PI - 0.5 * K * torch.log(hv),
            math.log(2.0) - math.log(math.pi) - torch.log(s), s,
            t.X_cols, t.Y)
    s = t.sigma_v_sq.to(torch.float32)        # the log on the target's device
    d1 = d - 1
    return kind, _f32(t.mu_v, s, t.mu_z, -0.5 * _LOG_2PI - 0.5 * torch.log(s),
                      -0.5 * d1 * _LOG_2PI, 0.5 * d1)


def route(variant: str, target, warp: bool | None = None,
          specialize: bool = True) -> tuple[str, str, torch.Tensor]:
    """``(library, kind, parameter words on the CPU)`` of a launch of
    kernel variant ``variant`` on ``target`` (:func:`lib_name`; ``warp`` as
    there).  A SuperFunnel whose dataset fits a fixed-shape build
    (:func:`sf_shape`) takes one (:func:`sf_tag`), with the dataset packed
    by :func:`sf_pack` (a thread build) or :func:`sf_team_pack` (a team
    build, d > 64); every other launch the library of its kind and
    bucket, with :func:`kernel_target`'s words.  ``specialize=False``
    forces the run-time-shape library, for comparisons only."""
    kind, params = kernel_target(target)
    shape = sf_shape(kind, target.dim, params, warp) if specialize else None
    if shape is None:
        return lib_name(variant, kind, target.dim, warp), kind, params
    lib = lib_name(variant, kind, target.dim, warp,
                   sf=sf_tag(*shape, VARIANTS[variant][0]))
    return lib, kind, (sf_team_pack if is_warp(lib) else sf_pack)(params)


def by_variant(launches) -> Counter:
    """Launch counts keyed ``<variant>.<target kind>`` (the wrappers'
    ``launches``; :func:`launch_key`) summed by variant, a warp library's
    under ``<variant>.w<D>`` and a fixed SuperFunnel shape's under
    ``<variant>.<sf>``; the ``*_record`` keys pass through."""
    out = Counter()
    for key, n in launches.items():
        parts = key.split(".")
        out[parts[0] + (f".{parts[2]}" if len(parts) > 2 else "")] += n
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
