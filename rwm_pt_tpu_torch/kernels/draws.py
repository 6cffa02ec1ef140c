"""Counter-based random draws of the fused samplers, in plain PyTorch.

Replaces the TPU hardware PRNG helpers of ``rwm_pt_tpu.kernels.pallas_rwm``
(``_uniform``, ``_erfinv_giles``, ``_normal_icdf``, ``_normal_bm``, the
draw study's ``_fast_log``, ``_normal_icdf_fastlog``, ``_normal_laxerfinv``
and ``_normal_fake_uniform``, the draw decision ``resolve_normal_impl`` and
the increments ``_laplace`` and ``_uniform_ball``) with Philox4x32-10
(Salmon et al.,
SC'11, "Parallel random numbers: as easy as 1, 2, 3").  The CUDA kernels
(``csrc/philox.cuh``, ``csrc/draws.cuh``) compute the same words, so on the
card a plain run and a kernel run of one seed consume one stream.

Slot layout (the one definition; the kernels match it)
------------------------------------------------------
* key     = (seed & 0xFFFFFFFF, (seed >> 32) & 0xFFFFFFFF)
* counter = (k, replica, rung, abs_step) as four 32-bit words, where
  ``abs_step = step0 + s + 1`` is the 1-based absolute step (``step0`` the
  state's step count when the launch starts, ``s`` the step within it), so
  a resumed segment continues the stream an uninterrupted run would draw;
  ``replica`` and ``rung`` are the whole run's: a launch that runs one shard
  of it (``fused_sharded.py``) adds the shard's first replica and rung
  (``replica0``, ``rung0``), so every partition draws the same words;
* one Philox call gives the four words of block ``k``; word ``w`` of block
  ``k`` is slot ``j = 4k + w`` of that (replica, rung, step);
* slots ``0 .. d-1``: the increment words, one per coordinate: standard
  normals for ``Normal`` and ``UniformRadius`` (the ball's direction),
  uniforms for ``Laplace``;
* slot ``d``: the MH accept uniform;
* slot ``d+1``: the swap uniform of pair (rung, rung+1), PT only, rungs
  ``0 .. T-2``, read on swap steps only;
* slot ``d+2``: the radius uniform of ``UniformRadius``, read by that
  proposal only;
* slot ``d+3``: with the Box-Muller draw and an odd ``d``, the angle
  uniform of the last pair.

The normals come from one of five draws (:data:`NORMAL_IMPLS`,
:func:`resolve_normal_impl`).  Four read the ICDF slot layout, normal
``i`` from the uniform of slot ``i`` and no slot ``d+3``
(:data:`ICDF_LAYOUT`): ``"icdf"`` (``normal_icdf``) and the draw study's
``"icdf_fastlog"``, ``"lax_erfinv"`` and ``"fake_uniform"`` (not a
normal).  The fifth, ``"bm"``, is
Box-Muller in ``pallas_rwm.py::_normal_bm``'s coordinate map: with
``h = ceil(d/2)``, pair ``k < h`` takes ``u1`` from slot ``k`` and ``u2``
from slot :func:`bm_slots` ``[1][k]`` (``h + k``, or ``d+3`` for the last
pair of an odd ``d``) and gives ``r cos(theta)`` to coordinate ``k`` and
``r sin(theta)`` to coordinate ``k + h``.

RWM uses the same layout at ``rung = 0`` and never reads slot ``d+1``.  An
ICDF ``Normal`` run reads exactly the words it read before slots ``d+2``
and ``d+3`` existed.

Uniforms are the top 24 bits of a word times 2^-24 -- a *logical* shift
(``pallas_rwm.py:44-46``: a sign-extending shift of an int32 view makes
half of the "uniforms" negative and auto-accepts every proposal).  Words are
held here as non-negative int64, so ``>>`` is logical; the kernels use
``uint32``.
"""
from __future__ import annotations

import math

import torch

PHILOX_M0 = 0xD2511F53
PHILOX_M1 = 0xCD9E8D57
PHILOX_W0 = 0x9E3779B9
PHILOX_W1 = 0xBB67AE85
_MASK32 = 0xFFFFFFFF

# Giles (2010), "Approximating the erfinv function": single-precision
# polynomials, central branch (w < 5) and tail branch (pallas_rwm.py:70-75).
GILES_P1 = (2.81022636e-08, 3.43273939e-07, -3.5233877e-06,
            -4.39150654e-06, 0.00021858087, -0.00125372503,
            -0.00417768164, 0.246640727, 1.50140941)
GILES_P2 = (-0.000200214257, 0.000100950558, 0.00134934322,
            -0.00367342844, 0.00573950773, -0.0076224613,
            0.00943887047, 1.00167406, 2.83297682)
SQRT2 = math.sqrt(2.0)
_TWO_M24 = 1.0 / (1 << 24)


def _mulhilo(a: int, b: torch.Tensor):
    """High and low 32-bit words of ``a * b`` for a 32-bit constant ``a``
    and 32-bit words ``b`` held in int64.  The full product can exceed
    2^63 (0xD2511F53 * 0xFFFFFFFF), so it is formed from 16-bit limbs of
    ``b``: p = a * (b >> 16) and q = a * (b & 0xFFFF) are both < 2^48."""
    p = a * (b >> 16)
    q = a * (b & 0xFFFF)
    hi = (p + (q >> 16)) >> 16
    lo = (((p & 0xFFFF) << 16) + q) & _MASK32
    return hi, lo


def philox4x32(c0, c1, c2, c3, k0: int, k1: int, rounds: int = 10):
    """Philox4x32-``rounds`` of counter words ``c0..c3`` (int64 tensors of
    32-bit values, broadcastable) under key ``(k0, k1)``.  Returns the four
    output words as int64 tensors."""
    c0, c1, c2, c3 = torch.broadcast_tensors(c0, c1, c2, c3)
    for r in range(rounds):
        if r:
            k0 = (k0 + PHILOX_W0) & _MASK32
            k1 = (k1 + PHILOX_W1) & _MASK32
        hi0, lo0 = _mulhilo(PHILOX_M0, c0)
        hi1, lo1 = _mulhilo(PHILOX_M1, c2)
        c0, c1, c2, c3 = hi1 ^ c1 ^ k0, lo1, hi0 ^ c3 ^ k1, lo0
    return c0, c1, c2, c3


def seed_key(seed: int) -> tuple[int, int]:
    """Philox key words of a non-negative integer seed."""
    seed = int(seed)
    if seed < 0:
        raise ValueError("seed must be non-negative")
    return seed & _MASK32, (seed >> 32) & _MASK32


def resolve_seed(seed) -> int:
    """Integer seed from an ``int`` or a ``torch.Generator`` (one draw)."""
    if isinstance(seed, torch.Generator):
        return int(torch.randint(0, 2 ** 62, (1,), generator=seed,
                                 device=seed.device).item())
    return int(seed)


def uniform_from_bits(words: torch.Tensor) -> torch.Tensor:
    """U[0,1) in float32: top 24 bits of each 32-bit word times 2^-24."""
    return (words >> 8).to(torch.float32) * _TWO_M24


def _giles_poly(w: torch.Tensor) -> torch.Tensor:
    """Giles' polynomial of ``w = -log((1-x)(1+x))``: erfinv(x) / x."""
    wc = w - 2.5
    wt = torch.sqrt(w) - 3.0
    pc = torch.full_like(w, GILES_P1[0])
    pt = torch.full_like(w, GILES_P2[0])
    for c1, c2 in zip(GILES_P1[1:], GILES_P2[1:]):
        pc = pc * wc + c1
        pt = pt * wt + c2
    return torch.where(w < 5.0, pc, pt)


def erfinv_giles(x: torch.Tensor) -> torch.Tensor:
    """Giles' single-precision erfinv, with the log argument clamped at
    1e-37 (pallas_rwm.py:78-87)."""
    return x * _giles_poly(-torch.log(torch.clamp_min((1.0 - x) * (1.0 + x),
                                                      1e-37)))


def normal_icdf(u: torch.Tensor) -> torch.Tensor:
    """N(0,1) from U[0,1): sqrt(2) erfinv(2u - 1 + 2^-24)."""
    return SQRT2 * erfinv_giles(2.0 * u - 1.0 + _TWO_M24)


# Cephes logf minimax polynomial for log(1+f), f in [sqrt(1/2)-1,
# sqrt(2)-1] (pallas_rwm.py:94-97), highest power first
LOGF_P = (7.0376836292e-2, -1.1514610310e-1, 1.1676998740e-1,
          -1.2420140846e-1, 1.4249322787e-1, -1.6668057665e-1,
          2.0000714765e-1, -2.4999993993e-1, 3.3333331174e-1)
LN2 = 0.6931471805599453


def fast_log(y: torch.Tensor) -> torch.Tensor:
    """log(y) of finite f32 ``y > 0`` by exponent extraction and a mantissa
    polynomial, ``pallas_rwm.py::_fast_log``'s arithmetic: ``y = m 2^e``
    with ``m`` in [sqrt(1/2), sqrt(2)), ``log y = e ln2 + log m``, the bits
    read through ``Tensor.view(torch.int32)``."""
    bits = y.contiguous().view(torch.int32)
    e = ((bits >> 23) & 0xFF) - 127
    m = ((bits & 0x007FFFFF) | 0x3F800000).view(torch.float32)
    big = m > 1.41421356
    m = torch.where(big, m * 0.5, m)
    e = (e + big.to(torch.int32)).to(torch.float32)
    f = m - 1.0
    p = torch.full_like(f, LOGF_P[0])
    for c in LOGF_P[1:]:
        p = p * f + c
    f2 = f * f
    return (f2 * f) * p - 0.5 * f2 + f + e * LN2


def normal_icdf_fastlog(u: torch.Tensor) -> torch.Tensor:
    """The ICDF normal with :func:`fast_log` in place of the log in Giles'
    erfinv, ``pallas_rwm.py::_normal_icdf_fastlog``'s arithmetic (its
    ``sqrt(2) x p`` product order too)."""
    x = 2.0 * u - 1.0 + _TWO_M24
    w = -fast_log(torch.clamp_min((1.0 - x) * (1.0 + x), 1e-37))
    return SQRT2 * x * _giles_poly(w)


def normal_laxerfinv(u: torch.Tensor) -> torch.Tensor:
    """sqrt(2) erfinv(2u - 1 + 2^-24) with the library erfinv
    (``torch.erfinv``; ``pallas_rwm.py::_normal_laxerfinv`` takes
    ``lax.erf_inv``, the kernels CUDA's ``erfinvf``)."""
    return SQRT2 * torch.erfinv(2.0 * u - 1.0 + _TWO_M24)


_SQRT12_F32 = 3.464101552963257    # float32(sqrt(12)), pallas_rwm.py:157


def normal_fake_uniform(u: torch.Tensor) -> torch.Tensor:
    """NOT a normal: the variance-matched uniform ``(u - 0.5) sqrt(12)``
    (``pallas_rwm.py::_normal_fake_uniform``), only for timing a sampler
    with a near-free draw; never valid for sampling."""
    return (u - 0.5) * _SQRT12_F32


def slot_words(key: tuple[int, int], abs_step: int, n_rungs: int,
               n_slots: int, n_chains: int, device, replica0: int = 0,
               rung0: int = 0) -> torch.Tensor:
    """Random words of slots ``0 .. n_slots-1`` for every (rung, replica)
    at one absolute step: int64 ``(n_rungs, n_slots, n_chains)``, of
    replicas ``replica0 ..`` and rungs ``rung0 ..``."""
    n_blk = -(-n_slots // 4)
    kk = torch.arange(n_blk, dtype=torch.int64, device=device)
    k_ctr = kk.reshape(1, n_blk, 1)
    c_ctr = torch.arange(replica0, replica0 + n_chains, dtype=torch.int64,
                         device=device).reshape(1, 1, n_chains)
    t_ctr = torch.arange(rung0, rung0 + n_rungs, dtype=torch.int64,
                         device=device).reshape(n_rungs, 1, 1)
    s_ctr = torch.tensor(abs_step & _MASK32, dtype=torch.int64,
                         device=device)
    words = torch.stack(philox4x32(k_ctr, c_ctr, t_ctr, s_ctr, *key),
                        dim=2)                       # (T, n_blk, 4, C)
    return words.reshape(n_rungs, n_blk * 4, n_chains)[:, :n_slots]


_TWO_PI_F32 = 6.2831854820251465   # float32(2 pi), pallas_rwm.py:38


def bm_slots(dim: int):
    """Box-Muller slots: ``(u1 slots, u2 slots)`` of the ``ceil(d/2)``
    pairs (module docstring)."""
    h = (dim + 1) // 2
    return (list(range(h)),
            [h + k if h + k < dim else dim + 3 for k in range(h)])


def normal_bm(u1: torch.Tensor, u2: torch.Tensor, dim: int) -> torch.Tensor:
    """``(d, *B)`` normals from ``(ceil(d/2), *B)`` uniforms, exactly
    ``pallas_rwm.py::_normal_bm``'s arithmetic: ``u1`` clamped at 1e-7,
    ``r = sqrt(-2 log u1)``, ``theta = 2 pi u2`` rounded to float32, then
    ``concat(r cos theta, r sin theta)[:d]``."""
    r = torch.sqrt(-2.0 * torch.log(torch.clamp_min(u1, 1e-7)))
    theta = _TWO_PI_F32 * u2
    return torch.cat([r * torch.cos(theta), r * torch.sin(theta)],
                     dim=0)[:dim]


NORMAL_IMPLS = ("icdf", "bm", "icdf_fastlog", "lax_erfinv", "fake_uniform")
# the draws of the ICDF slot layout (normal i from slot i) -> the map from
# the uniform of slot i to normal i
ICDF_LAYOUT = {"icdf": normal_icdf, "icdf_fastlog": normal_icdf_fastlog,
               "lax_erfinv": normal_laxerfinv,
               "fake_uniform": normal_fake_uniform}
# Module-level override of the normal draw, read at each launch; "auto"
# takes the measured decision (resolve_normal_impl).  The draw study (chip_smoke.py phase 14) forces
# each of NORMAL_IMPLS in turn.
NORMAL_IMPL = "auto"
# The draw of resolve_normal_impl's measured rule, for both kernels
RULE_DRAW = "lax_erfinv"


def resolve_normal_impl(kernel: str, block: int,
                        target_kind: str | None = None) -> str:
    """The (kernel, block) -> normal-draw decision, with the JAX signature
    (``pallas_rwm.py:184-195``; ``block``: the launch's replicas or
    chains) and the target's kernel kind (``_build.target_kind``)
    besides.  A non-"auto" :data:`NORMAL_IMPL` wins.  Otherwise
    the rule measured on one H100 (NVIDIA H100 80GB HBM3 at 700 W;
    PERF.md section 6).  Up to 64 dimensions (the thread-per-replica
    kernels; ``chip_smoke.py`` phase 12: the four exact
    draws through the entry points, best of 3, interleaved) CUDA's
    ``erfinvf`` draw (``lax_erfinv``) is the fastest exact draw at every
    shape timed, for both kernels, so neither ``block`` nor the kind
    changes the pick: 122.516 ms at the flagship PT, 65,536 replicas
    (Box-Muller 169.530, ICDF 192.856), 13.129 ms at the RWM headline,
    65,536 chains (Box-Muller 18.176), 49.220 ms at the PT study's 1024
    replicas (ICDF 59.651) and 151.280 ms at the RWM study's 1024 chains
    (ICDF 168.222).  The full-covariance MVN at the flagship's shape is
    the exception: ``lax_erfinv`` took 373.770 ms there when the rule was
    measured (Box-Muller 442.222), but 523.0-523.2 ms since the Philox
    counter took its replica and rung offsets (Box-Muller 445.7-447.2),
    so Box-Muller is the faster draw there now
    (``scripts/bench_torch_pt_rungs.py --tree DIR --only mvn_full`` over
    earlier trees, ROADMAP B4); the rule still takes ``lax_erfinv`` on
    it.  Above 64 dimensions the warp
    kernels rank the draws the same (``chip_smoke.py`` phase 16f, the
    iso MVN at d = 100): 45.493 ms at 65,536 chains over 2000 steps (ICDF
    66.542, Box-Muller 86.642) and 72.122 ms at 65,536 replicas x 10
    rungs over 200 (ICDF 94.132, Box-Muller 124.778), so d does not
    change the pick either.  The rule never picks ``fake_uniform``
    (not a normal); the override takes all five draws of
    :data:`NORMAL_IMPLS`, and any other name raises ``ValueError``."""
    if NORMAL_IMPL != "auto":
        if NORMAL_IMPL not in NORMAL_IMPLS:
            raise ValueError(f"unknown normal draw {NORMAL_IMPL!r}; "
                             f"NORMAL_IMPL takes 'auto' or one of "
                             f"{NORMAL_IMPLS}")
        return NORMAL_IMPL
    if kernel not in ("pt", "rwm"):
        raise ValueError(f"kernel must be 'pt' or 'rwm', not {kernel!r}")
    return RULE_DRAW


PROPOSAL_KINDS = ("Normal", "Laplace", "UniformRadius")
LAPLACE_CLAMP = -0.999999    # laplace.py:64-67 of the reference


def laplace_increment(u: torch.Tensor, scale) -> torch.Tensor:
    """Laplace increments from U[0,1) words ``u`` by the reference's inverse
    CDF, exactly ``pallas_rwm.py::_laplace``'s arithmetic: ``v = u - 0.5``,
    ``-scale * sign(v) * log1p(max(-2|v|, -0.999999))``.  ``sign(0) = 0``,
    so ``u = 0.5`` gives a zero increment; ``u = 0`` hits the clamp."""
    v = u - 0.5
    clamped = torch.clamp_min(-2.0 * torch.abs(v), LAPLACE_CLAMP)
    return -scale * torch.sign(v) * torch.log1p(clamped)


def uniform_ball_increment(normals: torch.Tensor, u_radius: torch.Tensor,
                           radius) -> torch.Tensor:
    """Uniform increments in the ``radius``-ball, exactly
    ``pallas_rwm.py::_uniform_ball``'s arithmetic: the direction
    ``normals / max(||normals||, 1e-12)`` (norm over axis 0) times
    ``radius * exp(log(U) / d)``, so ``U = 0`` gives 0.  ``normals``
    ``(d, *B)``, ``u_radius`` ``(*B)``, ``radius`` broadcastable to
    ``(*B)``."""
    d = normals.shape[0]
    norms = torch.sqrt(torch.sum(normals * normals, dim=0, keepdim=True))
    dirs = normals / torch.clamp_min(norms, 1e-12)
    return dirs * (radius * torch.exp(torch.log(u_radius) * (1.0 / d)))


def increment(kind: str, inc, u_rad, scale):
    """Proposal increment of ``kind`` from one step's draws (``inc`` and
    ``u_rad`` of :func:`step_draws`) and its effective scale: the Normal
    std, the UniformRadius radius (both broadcastable to the batch axes) or
    the Laplace scale ``(d, ...)``, broadcastable to ``inc``."""
    if kind == "Normal":
        return inc * scale
    if kind == "Laplace":
        return laplace_increment(inc, scale)
    return uniform_ball_increment(inc, u_rad, scale)


def n_records(total: int, record_every) -> int:
    """Trace entries of a recorded launch of ``total`` steps: one after
    every ``record_every``-th step; trailing steps are run, not recorded."""
    if not record_every:
        return 0
    if record_every < 1 or record_every > total:
        raise ValueError("record_every exceeds the total step count")
    return total // record_every


def step_draws(key: tuple[int, int], abs_step: int, n_rungs: int, dim: int,
               n_chains: int, device, swap: bool = True,
               kind: str = "Normal", draw: str = "icdf", replica0: int = 0,
               rung0: int = 0):
    """One step's draws: ``(inc, u_mh, u_swap, u_radius)``.  ``inc`` is
    ``(T, d, C)``: normals of ``draw`` (any of :data:`NORMAL_IMPLS`) for
    ``Normal`` and
    ``UniformRadius``, uniforms for ``Laplace``; MH uniforms ``(T, C)``;
    with ``swap``, swap uniforms ``(T, C)`` (row ``t`` serves pair
    ``(t, t+1)``; the last row is unused), else None; for ``UniformRadius``
    the radius uniforms ``(T, C)`` (slot ``d+2``), else None.  Of replicas
    ``replica0 ..`` and rungs ``rung0 ..`` (:func:`slot_words`)."""
    if kind not in PROPOSAL_KINDS:
        raise ValueError(f"unknown proposal kind {kind!r}")
    if draw not in NORMAL_IMPLS:
        raise ValueError(f"unknown normal draw {draw!r}")
    bm = draw == "bm" and kind != "Laplace"
    n_slots = (dim + 4 if bm and dim % 2 else
               dim + 3 if kind == "UniformRadius" else
               dim + 2 if swap else dim + 1)
    words = slot_words(key, abs_step, n_rungs, n_slots, n_chains, device,
                       replica0, rung0)
    if bm:
        s1, s2 = bm_slots(dim)
        inc = normal_bm(uniform_from_bits(words[:, s1]).transpose(0, 1),
                        uniform_from_bits(words[:, s2]).transpose(0, 1),
                        dim).transpose(0, 1)
    else:
        inc = uniform_from_bits(words[:, :dim])
        if kind != "Laplace":
            inc = ICDF_LAYOUT[draw](inc)
    u_mh = uniform_from_bits(words[:, dim])
    u_swap = uniform_from_bits(words[:, dim + 1]) if swap else None
    u_rad = (uniform_from_bits(words[:, dim + 2])
             if kind == "UniformRadius" else None)
    return inc, u_mh, u_swap, u_rad


def swap_uniforms(key: tuple[int, int], abs_step: int, dim: int,
                  rungs: torch.Tensor, replica0: int, n_chains: int
                  ) -> torch.Tensor:
    """The swap uniforms (slot ``d+1``) of pairs ``(g, g+1)``, ``g`` in the
    int64 tensor ``rungs`` (on the device to draw on), of replicas
    ``replica0 ..`` at one absolute step: ``(len(rungs), n_chains)``, the
    words the fused kernel's sweep reads for those pairs."""
    dev = rungs.device
    c_ctr = torch.arange(replica0, replica0 + n_chains, dtype=torch.int64,
                         device=dev)[None]
    words = philox4x32(torch.tensor((dim + 1) // 4, device=dev), c_ctr,
                       (rungs & _MASK32)[:, None],
                       torch.tensor(abs_step & _MASK32, device=dev), *key)
    return uniform_from_bits(words[(dim + 1) % 4])


# ------------------------------------------------- the ladder probes' stream
# The iterative ladder's swap-rate probes (ladders/ladders.py) draw from the
# same Philox4x32-10 under ``seed_key(seed)``, with counters no fused run
# uses: the fused layout's third word is a rung (any rung a fused launch
# takes, up to 320 on the thread kernel, plus a shard's rung0: far below
# 2^31), whose top bit is clear, and a probe's carries LADDER_TAG, that
# top bit, which alone keeps the two streams apart.  Coordinate j of a
# gamma variate takes the word's low 16 bits (d <= 4092 < 2^16).  Block ``k`` of sample ``n`` on side ``side`` (0: the samples
# at beta*, 1: those at the current beta) of probe ``i`` (counted from 1 over
# a build) is Philox of
#     (k, n, LADDER_TAG | side << 20, i);
# its word ``w`` is slot ``4k + w`` of the sample, read by the target's
# stream sampler (``targets/*.py::stream_sample``).  A gamma variate
# (IIDGamma; IIDBeta's two, g = 0 and 1) of coordinate ``j`` draws its
# rejection attempt ``a`` from
#     (a, n, LADDER_TAG | GAMMA_TAG | side << 20 | g << 16 | j, i):
# word 0 the attempt's normal (normal_icdf_fastlog), word 1 its accept
# uniform, and word 2 of attempt 0 the shape < 1 boost's uniform.
# csrc/ladder_build.cu computes the same words.
LADDER_TAG = 0x80000000
GAMMA_TAG = 0x40000000
_THIRD_F32 = 0.3333333432674408    # float32(1/3)


def ladder_words(key: tuple[int, int], probe: int, side: int, n: int,
                 n_slots: int, device) -> torch.Tensor:
    """Slots ``0 .. n_slots-1`` of samples ``0 .. n-1`` of one side of a
    ladder probe: int64 ``(n, n_slots)``."""
    n_blk = -(-n_slots // 4)
    k_ctr = torch.arange(n_blk, dtype=torch.int64, device=device)[None]
    n_ctr = torch.arange(n, dtype=torch.int64, device=device)[:, None]
    words = torch.stack(philox4x32(
        k_ctr, n_ctr, torch.tensor(LADDER_TAG | side << 20, device=device),
        torch.tensor(probe & _MASK32, device=device), *key), dim=2)
    return words.reshape(n, 4 * n_blk)[:, :n_slots]


def ladder_gamma(key: tuple[int, int], probe: int, side: int, g: int,
                 alpha: torch.Tensor, n: int, d: int,
                 device) -> torch.Tensor:
    """``(n, d)`` Gamma(alpha, 1) variates of one side of a ladder probe
    (gamma ``g`` of the sample; ``alpha`` a float32 0-d tensor), by
    Marsaglia and Tsang (2000) in float32, each operation rounded on its own
    as csrc/ladder_build.cu rounds it: with a = alpha (alpha + 1 below 1),
    dd = a - 1/3, c = 1 / sqrt(9 dd), attempt t = 1 + c x of a normal x is
    taken where t > 0 and log u < ((0.5 x^2 + dd) - dd v) + dd log v, v =
    t^3, giving dd v; below 1 the boost u0^(1/alpha) = exp(log u0 / alpha)
    multiplies it.  The normal and both logs are the bit-exact
    ``normal_icdf_fastlog`` and ``fast_log``, so the card takes the same
    attempts; every element loops until it is accepted.  A NaN ``alpha``
    (a probe at a NaN beta*) gives NaN variates and no attempt."""
    alpha = alpha.to(device=device, dtype=torch.float32)
    if bool(torch.isnan(alpha)):
        return torch.full((n, d), math.nan, device=device)
    boost = bool(alpha < 1.0)
    a = alpha + 1.0 if boost else alpha
    dd = a - _THIRD_F32
    c = 1.0 / torch.sqrt(9.0 * dd)
    out = torch.empty(n * d, dtype=torch.float32, device=device)
    pending = torch.arange(n * d, dtype=torch.int64, device=device)
    base = LADDER_TAG | GAMMA_TAG | side << 20 | g << 16
    p_ctr = torch.tensor(probe & _MASK32, device=device)
    attempt, u0 = 0, None
    while pending.numel():
        w = philox4x32(torch.tensor(attempt, device=device), pending // d,
                       base | pending % d, p_ctr, *key)
        if attempt == 0 and boost:
            u0 = uniform_from_bits(w[2])
        x = normal_icdf_fastlog(uniform_from_bits(w[0]))
        t = 1.0 + c * x
        pos = t > 0
        v = torch.where(pos, t, torch.ones_like(t))
        v = v * v * v
        rhs = ((0.5 * (x * x) + dd) - dd * v) + dd * fast_log(v)
        ok = pos & (fast_log(uniform_from_bits(w[1])) < rhs)
        out[pending[ok]] = (dd * v)[ok]
        pending = pending[~ok]
        attempt += 1
    if boost:
        out = out * torch.exp(fast_log(u0) / alpha)
    return out.reshape(n, d)


class ProbeStream:
    """The draws of one side of one ladder probe, for a target's
    ``stream_sample``: ``uniforms(lo, hi)`` the U[0,1) of slots ``lo ..
    hi-1``, ``normals(k)`` the ``lax_erfinv`` normals of slots ``0 ..
    k-1``, ``gamma(alpha, g)`` gamma ``g``'s ``(n, d)`` variates; each
    ``(n, .)`` float32 on ``device``."""

    def __init__(self, key, probe: int, side: int, n: int, device):
        self.key, self.probe, self.side = key, probe, side
        self.n, self.device = n, device
        self._words = None

    def _slots(self, hi: int) -> torch.Tensor:
        if self._words is None or self._words.shape[1] < hi:
            self._words = ladder_words(self.key, self.probe, self.side,
                                       self.n, hi, self.device)
        return self._words

    def uniforms(self, lo: int, hi: int) -> torch.Tensor:
        return uniform_from_bits(self._slots(hi)[:, lo:hi])

    def normals(self, k: int) -> torch.Tensor:
        return normal_laxerfinv(self.uniforms(0, k))

    def gamma(self, alpha: torch.Tensor, d: int, g: int = 0):
        return ladder_gamma(self.key, self.probe, self.side, g, alpha,
                            self.n, d, self.device)
