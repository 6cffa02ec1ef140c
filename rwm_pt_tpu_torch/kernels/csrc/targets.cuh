// Log-densities of the targets the fused kernels take, on one replica's
// state held in registers: x[i] for i < d, with d <= DMAX (the compiled
// register bucket).  Loops run over the compile-time DMAX and test i < d,
// so x[] is indexed with constants only and stays in registers; parameters
// are read from shared memory (p), where a warp reading one element is a
// broadcast.  Each library is built for one kind (-DRWM_PT_TARGET=k) and
// one register bucket DMAX (-DRWM_PT_DMAX: 8, 16, 32 or 64), with the
// parameter vector kernels/_build.py::kernel_target lays out for it:
//
//   0 ROSENBROCK       [a, b, mu_0 .. mu_{d-2}]
//     -( sum_i b (x_{i+1} - x_i^2)^2 + sum_i a (x_i - mu_i)^2 )
//   1 MVN_ISO          [log_norm_const, mean_0 .. mean_{d-1}]
//     -0.5 sum_i (x_i - mean_i)^2 + log_norm_const
//   2 MVN_FULL         [log_norm_const, mean (d), cov_inv (d x d, rows)]
//     -0.5 sum_i xc_i (sum_j cov_inv_ij xc_j) + log_norm_const
//   3 SCALED_MVN       [log_norm_const, c_0 .. c_{d-1}]
//     log_norm_const - 0.5 sum_i (c_i x_i)^2
//   4 THREE_MIXTURE    [log_jacobian, 0.5 d log 2pi, lw_0..2, s (d),
//                       means (3 x d, rows)]
//     logsumexp_k(-0.5 |s x - mu_k|^2 - 0.5 d log 2pi + lw_k) + log_jacobian
//     (jax.nn.logsumexp: shift by the max, by 0 where it is not finite)
//   5 ROUGH_CARPET     [log_jacobian, lw_0..2, mode_0..2, s (d)]
//     sum_i (m + log sum_k exp(p_k - m0) - log sqrt(2pi)) + log_jacobian,
//     p_k = lw_k - 0.5 (s_i x_i - mode_k)^2, m = max_k p_k,
//     m0 = m if finite else 0
//   6 EVEN_ROSENBROCK  [a_vec (d-1), b_vec (d-1), mu (d-1)] (pairs folded)
//     -sum_i (a_i (x_i - mu_i)^2 + b_i (x_{i+1} - x_i^2)^2)
//   7 HYBRID_ROSENBROCK [a, b, mu, first_1 .. first_{d-1}]
//     -a (x_0 - mu)^2 - sum_k b (x_k - parent_k^2)^2, parent_k = x_0 where
//     first_k = 1 (the first variable of a block), else x_{k-1}
//   8 HYPERCUBE        [left, right, log_uniform_density]
//     log_uniform_density if every left <= x_i <= right, else -inf
//   9 IID_GAMMA        [shape, scale, log_norm_const]
//     sum_i ((shape-1) log x_i - x_i / scale) - log_norm_const, -inf unless
//     every x_i > 0 (the logs read 1 there)
//  10 IID_BETA         [alpha, beta, log_norm_const]
//     sum_i ((alpha-1) log x_i + (beta-1) log1p(-x_i)) + log_norm_const,
//     -inf unless every 0 < x_i < 1 (the logs read 0.5 there)
//  11 NEAL_FUNNEL      [mu_v, sigma_v^2, mu_z, A, B, C]  (A, B, C float32
//                       constants of the JAX formula: A = -0.5 log 2pi -
//                       0.5 log sigma_v^2, B = -0.5 (d-1) log 2pi,
//                       C = 0.5 (d-1))
//     A - 0.5 (v - mu_v)^2 / sigma_v^2 + (B - C v)
//       - 0.5 exp(-v) sum_k (z_k - mu_z)^2
//  12 SUPER_FUNNEL     [J, K, n, c_a, c_b, h, c_ma, c_mb, c_t, s,
//                       X_cols (J K x n, row j K + k), Y (J x n)]
//     (float32 constants of the JAX formula: c_a = -0.5 J log 2pi,
//     c_b = -0.5 J K log 2pi, h = hypermean std^2, c_ma = -0.5 log 2pi -
//     0.5 log h, c_mb = -0.5 K log 2pi - 0.5 K log h, c_t = log 2 -
//     log pi - log s, s = the tau scale; the state is alpha (J),
//     beta (J K), mu_alpha, mu_beta (K), tau_a, tau_b)
//     sum_j sum_i ls_ji + (c_a - J log tau_a) - 0.5 sum_j (alpha_j -
//       mu_alpha)^2 / tau_a^2 + (c_b - J K log tau_b) - 0.5 sum_jk
//       (beta_jk - mu_beta_k)^2 / tau_b^2 + c_ma - 0.5 mu_alpha^2 / h +
//       c_mb - 0.5 sum_k mu_beta_k^2 / h + (c_t - log1p((tau_a / s)^2)
//       + c_t) - log1p((tau_b / s)^2), -inf unless both taus exceed
//       1e-9; eta = alpha_j + sum_k X_jki beta_jk, ls = log_sigmoid(eta)
//       if Y_ji = 1, else log_sigmoid(-eta), -(max(-+eta, 0) + log1p(
//       exp(-|eta|))): JAX's y ls(eta) + (1 - y) ls(-eta) with y in {0,
//       1} equals the selected term exactly (0 times a finite term is 0).
//     Its alphas and betas are read at run-time indices (group j,
//     covariate k), so the run-time-shape build reads the state from a
//     shared-memory row (super_funnel_log_density; csrc/mh.cuh stages the
//     proposal there) and not from the register array of the other kinds.
//     A build with the dataset's shape fixed (-DRWM_PT_SF_J, _K, _N; see
//     SuperFunnelFixed below) reads it from the registers instead and
//     takes the dataset, signs folded in, as a kernel parameter.
// The JAX formulas are in rwm_pt_tpu/targets/*.py (log_density_td); each
// kind computes them in the same order with the same masking, summing the
// coordinates' terms in index order.  The products that the JAX formula
// rounds before an add are rounded on their own here (__fmul_rn) where
// nvcc would otherwise contract them.  The kinds whose terms differ in
// sign (IID_GAMMA, IID_BETA, NEAL_FUNNEL, SUPER_FUNNEL) then round as the
// plain version does (targets/base.py::sum0), which matters where their
// log-density is near 0.
#pragma once
#include <math.h>

#define TARGET_ROSENBROCK 0
#define TARGET_MVN_ISO 1
#define TARGET_MVN_FULL 2
#define TARGET_SCALED_MVN 3
#define TARGET_THREE_MIXTURE 4
#define TARGET_ROUGH_CARPET 5
#define TARGET_EVEN_ROSENBROCK 6
#define TARGET_HYBRID_ROSENBROCK 7
#define TARGET_HYPERCUBE 8
#define TARGET_IID_GAMMA 9
#define TARGET_IID_BETA 10
#define TARGET_NEAL_FUNNEL 11
#define TARGET_SUPER_FUNNEL 12

__device__ __forceinline__ float sq(float v) { return v * v; }
// v * v rounded on its own, never contracted into the add it feeds
__device__ __forceinline__ float sq_rn(float v) { return __fmul_rn(v, v); }

// SuperFunnel's parameter words before X_cols
constexpr int kSuperFunnelHead = 10;

// One observation's term of SuperFunnel's likelihood at linear predictor
// eta and label y (0 or 1): log_sigmoid(eta) if y = 1, else
// log_sigmoid(-eta), as -softplus(-+eta) (jnp.logaddexp(v, 0) = max(v, 0)
// + log1p(exp(-|v|))), one exp and one log1p
__device__ __forceinline__ float super_funnel_term(float eta, float y) {
  const float l = log1pf(expf(-fabsf(eta)));
  return -(fmaxf(y != 0.0f ? -eta : eta, 0.0f) + l);
}

// Group j's likelihood, its n observations summed in order, from the
// state's coordinates x(i) (read at run-time indices: the alphas and the
// betas of group j).  A warp's threads read one X and one Y word at a
// time (a broadcast).
template <class Coord>
__device__ __forceinline__ float super_funnel_group(
    Coord x, int j, const float* __restrict__ p) {
  const int J = (int)p[0], K = (int)p[1], n = (int)p[2];
  const float* X = p + kSuperFunnelHead + j * K * n;
  const float* Y = p + kSuperFunnelHead + J * K * n + j * n;
  const int b = J + j * K;   // beta_j0
  const float alpha = x(j);
  float s = 0.0f;
  for (int i = 0; i < n; ++i) {
    float eta = alpha;
    for (int k = 0; k < K; ++k) eta += __fmul_rn(X[k * n + i], x(b + k));
    s += super_funnel_term(eta, Y[i]);
  }
  return s;
}

// The closing formula of SuperFunnel's log-density, in the JAX formula's
// order: the likelihood ll, the priors' sums of squares sa (alphas), sb
// (betas) and smb (mu_beta), mu_alpha, the taus, J and J K as floats and
// the parameter vector's head p (its words 3..9)
__device__ __forceinline__ float super_funnel_close(
    float ll, float sa, float sb, float smb, float mu_a, float tau_a,
    float tau_b, float fJ, float fJK, const float* __restrict__ p) {
  const float lp_alpha = (p[3] - __fmul_rn(fJ, logf(tau_a))) -
                         (0.5f * sa) / __fmul_rn(tau_a, tau_a);
  const float lp_beta = (p[4] - __fmul_rn(fJK, logf(tau_b))) -
                        (0.5f * sb) / __fmul_rn(tau_b, tau_b);
  const float lp_mu_a = p[6] - (0.5f * __fmul_rn(mu_a, mu_a)) / p[5];
  const float lp_mu_b = p[7] - (0.5f * smb) / p[5];
  const float qa = tau_a / p[9], qb = tau_b / p[9];
  const float lp_tau = ((p[8] - log1pf(__fmul_rn(qa, qa))) + p[8]) -
                       log1pf(__fmul_rn(qb, qb));
  return ((((ll + lp_alpha) + lp_beta) + lp_mu_a) + lp_mu_b) + lp_tau;
}

// SuperFunnel's log-density of a state whose taus both exceed 1e-9, from
// its coordinates x(i) and its groups' likelihoods group(j): the groups
// and the priors' squares summed in index order (the plain version's
// sum0), then the JAX formula in its order.
template <class Coord, class Group>
__device__ __forceinline__ float super_funnel_valid(
    Coord x, Group group, int d, const float* __restrict__ p) {
  const int J = (int)p[0], K = (int)p[1];
  const int m = J + J * K;   // mu_alpha; mu_beta from m + 1
  const float mu_a = x(m), tau_a = x(d - 2), tau_b = x(d - 1);
  float ll = 0.0f, sa = 0.0f, sb = 0.0f, smb = 0.0f;
  for (int j = 0; j < J; ++j) ll += group(j);
  for (int j = 0; j < J; ++j) sa += sq_rn(x(j) - mu_a);
  for (int j = 0; j < J; ++j)
    for (int k = 0; k < K; ++k) sb += sq_rn(x(J + j * K + k) - x(m + 1 + k));
  for (int k = 0; k < K; ++k) smb += sq_rn(x(m + 1 + k));
  return super_funnel_close(ll, sa, sb, smb, mu_a, tau_a, tau_b, p[0],
                            p[0] * p[1], p);
}

// Whether SuperFunnel's state is valid: both taus above 1e-9
__device__ __forceinline__ bool super_funnel_taus_valid(float tau_a,
                                                        float tau_b) {
  return (tau_a > 1e-9f) & (tau_b > 1e-9f);
}

// SuperFunnel's log-density of the state whose coordinate i is x(i) (a
// shared-memory row read at run-time indices), the groups one after
// another; -inf where a tau is at most 1e-9.
template <class Coord>
__device__ __forceinline__ float super_funnel_log_density(
    Coord x, int d, const float* __restrict__ p) {
  if (!super_funnel_taus_valid(x(d - 2), x(d - 1))) return -INFINITY;
  return super_funnel_valid(
      x, [&](int j) { return super_funnel_group(x, j, p); }, d, p);
}

// ---- SuperFunnel with the dataset's shape fixed at build time.
// The TPU kernel unrolls the groups and the covariates at trace time
// (rwm_pt_tpu/targets/funnel.py:188-211); this form fixes J, K and N
// (-DRWM_PT_SF_J, -DRWM_PT_SF_K, -DRWM_PT_SF_N; the library
// <variant>.super_funnel.j<J>k<K>n<N>u<U>b<b>.d<D>, kernels/_build.py::
// sf_tag) and
// so d, and the likelihood reads the proposal from registers at
// compile-time indices: no stage row, no index arithmetic, a group's
// alpha and K betas held in registers across its N observations.
// The dataset is a kernel parameter passed by value (SuperFunnelFixed,
// __grid_constant__): it sits in the constant bank, where an unrolled
// observation's words are constant operands of its FMULs, and a loop over
// the observations reads them with LDC at a register index.  Not a
// __constant__ symbol set before each launch: two launches with different
// datasets would race for it.  Kernel parameters take at most 4 KB; the
// dataset may take kSuperFunnelFixedMaxWords words of them (the other
// arguments need < 512 B), a larger one takes the run-time-shape build
// (kernels/_build.py::SF_FIXED_MAX_WORDS, sf_shape).
// The labels are folded into signs (kernels/_build.py::sf_pack): sigma_ji
// = -1 where Y_ji != 0, else +1, and X'_jki = sigma_ji X_jki, so eta' =
// sigma alpha + sum_k X'_k beta_k is sigma eta exactly (negation commutes
// with rounding to nearest; sigma alpha is exact, so an FFMA adds it to
// the first product) and its term -(max(eta', 0) + log1p(exp(-|eta'|)))
// is super_funnel_term(eta, y) bit for bit.
constexpr int kSuperFunnelFixedMaxWords = 896;   // 3,584 B

// The dataset of a build with J groups, K covariates and N observations a
// group; U: observations a trip of the observation loop (N: unrolled
// whole)
template <int J, int K, int N, int U>
struct SuperFunnelFixed {
  static constexpr int kDim = J + J * K + K + 3;
  float head[kSuperFunnelHead];   // the parameter vector's first words
  float obs[J * N * (K + 1)];     // (j, i): X'_ji0 .. X'_ji(K-1), sigma_ji
};

// The dataset of a team build (csrc/warp.cuh::team_super_funnel_fixed, d >
// 64) with J groups, K covariates and N observations a group fixed, in the
// block's shared memory (kernels/_build.py::sf_team_pack): the head padded
// to kHead words (16 bytes), then group j's N observations of K + 1 words
// (X'_0 .. X'_{K-1}, sigma, signs folded in as above) from word kHead +
// j kStride.  An observation is read as (K + 1) / kAccess loads of kAccess
// words (16 bytes at K = 3, 8 at K = 5).  kStride pads a group to an odd
// number of such loads, so that the groups a team's lanes read at once
// (j = t + G r, lane t) start on distinct banks (n (K + 1) = 80 words at
// K = 3, n = 20 put lanes t and t + 2 on the same banks).
template <int J, int K, int N>
struct SuperFunnelTeamLayout {
  static constexpr int kDim = J + J * K + K + 3;
  static constexpr int kAccess = (K + 1) % 4 == 0 ? 4 : (K + 1) % 2 == 0 ? 2
                                                                          : 1;
  static constexpr int kHead = 12;
  static constexpr int kStride = (N * (K + 1) / kAccess | 1) * kAccess;
  static constexpr int kWords = kHead + J * kStride;
};

// An observation's term at its signed linear predictor e = sigma eta
__device__ __forceinline__ float super_funnel_signed_term(float e) {
  const float l = log1pf(expf(-fabsf(e)));
  return -(fmaxf(e, 0.0f) + l);
}

// SuperFunnel's log-density of the state y (registers) from the fixed
// dataset p, in super_funnel_log_density's order
template <int J, int K, int N, int U, int DMAX>
__device__ __forceinline__ float super_funnel_log_density_fixed(
    const float (&y)[DMAX], const SuperFunnelFixed<J, K, N, U>* p) {
  constexpr int d = J + J * K + K + 3;
  constexpr int m = J + J * K;   // mu_alpha; mu_beta from m + 1
  static_assert(d <= DMAX && sizeof(SuperFunnelFixed<J, K, N, U>) <=
                                 4 * kSuperFunnelFixedMaxWords,
                "the dataset does not fit the kernel's parameters");
  static_assert(U >= 1 && U <= N, "unroll by 1 .. N observations");
  if (!super_funnel_taus_valid(y[d - 2], y[d - 1])) return -INFINITY;
  float ll = 0.0f;
#pragma unroll
  for (int j = 0; j < J; ++j) {
    const float* o = p->obs + j * N * (K + 1);
    float s = 0.0f;
#pragma unroll (U)
    for (int i = 0; i < N; ++i) {
      const float* w = o + i * (K + 1);
      float eta = fmaf(w[K], y[j], __fmul_rn(w[0], y[J + j * K]));
#pragma unroll
      for (int k = 1; k < K; ++k) eta += __fmul_rn(w[k], y[J + j * K + k]);
      s += super_funnel_signed_term(eta);
    }
    ll += s;
  }
  const float mu_a = y[m];
  float sa = 0.0f, sb = 0.0f, smb = 0.0f;
#pragma unroll
  for (int j = 0; j < J; ++j) sa += sq_rn(y[j] - mu_a);
#pragma unroll
  for (int j = 0; j < J; ++j)
#pragma unroll
    for (int k = 0; k < K; ++k) sb += sq_rn(y[J + j * K + k] - y[m + 1 + k]);
#pragma unroll
  for (int k = 0; k < K; ++k) smb += sq_rn(y[m + 1 + k]);
  return super_funnel_close(ll, sa, sb, smb, mu_a, y[d - 2], y[d - 1],
                            (float)J, (float)(J * K), p->head);
}

template <int KIND, int DMAX>
__device__ __forceinline__ float log_density(const float (&x)[DMAX], int d,
                                             const float* __restrict__ p) {
  static_assert(KIND != TARGET_SUPER_FUNNEL,
                "SuperFunnel reads its state from a shared-memory row: "
                "super_funnel_log_density");
  if constexpr (KIND == TARGET_ROSENBROCK) {
    const float a = p[0], b = p[1];
    float s1 = 0.0f, s2 = 0.0f;
#pragma unroll
    for (int i = 0; i < DMAX - 1; ++i) {
      if (i < d - 1) {
        const float t = x[i + 1] - x[i] * x[i];
        s1 += b * (t * t);
        const float u = x[i] - p[2 + i];
        s2 += a * (u * u);
      }
    }
    return -(s1 + s2);
  } else if constexpr (KIND == TARGET_MVN_ISO) {
    float quad = 0.0f;
#pragma unroll
    for (int i = 0; i < DMAX; ++i) {
      if (i < d) {
        const float xc = x[i] - p[1 + i];
        quad += xc * xc;
      }
    }
    return -0.5f * quad + p[0];
  } else if constexpr (KIND == TARGET_MVN_FULL) {
    const float* cinv = p + 1 + d;
    float xc[DMAX];
#pragma unroll
    for (int i = 0; i < DMAX; ++i) xc[i] = i < d ? x[i] - p[1 + i] : 0.0f;
    float quad = 0.0f;
#pragma unroll
    for (int i = 0; i < DMAX; ++i) {
      if (i < d) {
        float y = 0.0f;
#pragma unroll
        for (int j = 0; j < DMAX; ++j)
          if (j < d) y = fmaf(cinv[i * d + j], xc[j], y);
        quad = fmaf(xc[i], y, quad);
      }
    }
    return -0.5f * quad + p[0];
  } else if constexpr (KIND == TARGET_SCALED_MVN) {
    float s = 0.0f;
#pragma unroll
    for (int i = 0; i < DMAX; ++i) {
      if (i < d) {
        const float sx = p[1 + i] * x[i];
        s += sx * sx;
      }
    }
    return p[0] - __fmul_rn(0.5f, s);
  } else if constexpr (KIND == TARGET_THREE_MIXTURE) {
    const float* s = p + 5;
    const float* mu = p + 5 + d;
    float q0 = 0.0f, q1 = 0.0f, q2 = 0.0f;
#pragma unroll
    for (int i = 0; i < DMAX; ++i) {
      if (i < d) {
        const float y = s[i] * x[i];
        const float e0 = y - mu[i], e1 = y - mu[d + i], e2 = y - mu[2 * d + i];
        q0 += e0 * e0;
        q1 += e1 * e1;
        q2 += e2 * e2;
      }
    }
    const float c0 = (__fmul_rn(-0.5f, q0) - p[1]) + p[2];
    const float c1 = (__fmul_rn(-0.5f, q1) - p[1]) + p[3];
    const float c2 = (__fmul_rn(-0.5f, q2) - p[1]) + p[4];
    const float m = fmaxf(fmaxf(c0, c1), c2);
    const float m0 = isfinite(m) ? m : 0.0f;
    return (logf(expf(c0 - m0) + expf(c1 - m0) + expf(c2 - m0)) + m0) + p[0];
  } else if constexpr (KIND == TARGET_ROUGH_CARPET) {
    const float* s = p + 7;
    float total = 0.0f;
#pragma unroll
    for (int i = 0; i < DMAX; ++i) {
      if (i < d) {
        const float y = s[i] * x[i];
        const float a0 = p[1] - __fmul_rn(0.5f, sq(y - p[4]));
        const float a1 = p[2] - __fmul_rn(0.5f, sq(y - p[5]));
        const float a2 = p[3] - __fmul_rn(0.5f, sq(y - p[6]));
        const float m = fmaxf(fmaxf(a0, a1), a2);
        const float m0 = isfinite(m) ? m : 0.0f;
        total += (m + logf(expf(a0 - m0) + expf(a1 - m0) + expf(a2 - m0))) -
                 0.918938533204672742f;   // log sqrt(2 pi)
      }
    }
    return total + p[0];
  } else if constexpr (KIND == TARGET_EVEN_ROSENBROCK) {
    const int n = d - 1;
    float s = 0.0f;
#pragma unroll
    for (int i = 0; i < DMAX - 1; ++i) {
      if (i < n) {
        const float t1 = __fmul_rn(p[i], sq(x[i] - p[2 * n + i]));
        const float t2 = __fmul_rn(p[n + i], sq(x[i + 1] - x[i] * x[i]));
        s += t1 + t2;
      }
    }
    return -s;
  } else if constexpr (KIND == TARGET_HYBRID_ROSENBROCK) {
    const float a = p[0], b = p[1];
    const float x0 = x[0];
    const float x0sq = x0 * x0;
    float s_first = 0.0f, s_in = 0.0f;
#pragma unroll
    for (int k = 1; k < DMAX; ++k) {
      if (k < d) {
        const bool first = p[2 + k] != 0.0f;
        const float par = first ? x0sq : x[k - 1] * x[k - 1];
        const float t = __fmul_rn(b, sq(x[k] - par));
        if (first) s_first += t; else s_in += t;
      }
    }
    return (__fmul_rn(-a, sq(x0 - p[2])) - s_first) - s_in;
  } else if constexpr (KIND == TARGET_HYPERCUBE) {
    bool inside = true;   // & (no short circuit): no branch a coordinate
#pragma unroll
    for (int i = 0; i < DMAX; ++i)
      if (i < d) inside &= (x[i] >= p[0]) & (x[i] <= p[1]);
    return inside ? p[2] : -INFINITY;
  } else if constexpr (KIND == TARGET_IID_GAMMA) {
    const float sh1 = p[0] - 1.0f;
    bool valid = true;
    float s = 0.0f;
#pragma unroll
    for (int i = 0; i < DMAX; ++i) {
      if (i < d) {
        const bool pos = x[i] > 0.0f;
        valid &= pos;
        const float sx = pos ? x[i] : 1.0f;
        s += __fmul_rn(sh1, logf(sx)) - sx / p[1];
      }
    }
    return valid ? s - p[2] : -INFINITY;
  } else if constexpr (KIND == TARGET_IID_BETA) {
    const float a1 = p[0] - 1.0f, b1 = p[1] - 1.0f;
    bool valid = true;
    float s = 0.0f;
#pragma unroll
    for (int i = 0; i < DMAX; ++i) {
      if (i < d) {
        const bool in = (x[i] > 0.0f) & (x[i] < 1.0f);
        valid &= in;
        const float sx = in ? x[i] : 0.5f;
        s += __fmul_rn(a1, logf(sx)) + __fmul_rn(b1, log1pf(-sx));
      }
    }
    return valid ? s + p[2] : -INFINITY;
  } else {   // TARGET_NEAL_FUNNEL
    const float v = x[0];
    const float prior = p[3] - __fmul_rn(0.5f, sq(v - p[0])) / p[1];
    if (d == 1) return prior;
    float ss = 0.0f;
#pragma unroll
    for (int k = 1; k < DMAX; ++k) {
      if (k < d) {
        const float z = x[k] - p[2];
        ss += __fmul_rn(z, z);
      }
    }
    const float lik = (p[4] - __fmul_rn(p[5], v)) -
                      __fmul_rn(__fmul_rn(0.5f, expf(-v)), ss);
    return prior + lik;
  }
}

