// Log-densities of the targets the fused kernels take, on one replica's
// state held in registers: x[i] for i < d, with d <= DMAX (the compiled
// register bucket).  Loops run over the compile-time DMAX and test i < d,
// so x[] is indexed with constants only and stays in registers.
//   TARGET_ROSENBROCK  params = [a, b, mu_0 .. mu_{d-2}]
//     log p = -( sum_i b (x_{i+1} - x_i^2)^2 + sum_i a (x_i - mu_i)^2 )
//     (rwm_pt_tpu/targets/rosenbrock.py::FullRosenbrock.log_density_td)
//   TARGET_MVN_ISO     params = [log_norm_const, mean_0 .. mean_{d-1}]
//     log p = -0.5 sum_i (x_i - mean_i)^2 + log_norm_const
//     (rwm_pt_tpu/targets/gaussian.py::MultivariateNormal, iso path)
#pragma once

#define TARGET_ROSENBROCK 0
#define TARGET_MVN_ISO 1

template <int KIND, int DMAX>
__device__ __forceinline__ float log_density(const float (&x)[DMAX], int d,
                                             const float* __restrict__ p) {
  if (KIND == TARGET_ROSENBROCK) {
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
  } else {
    float quad = 0.0f;
#pragma unroll
    for (int i = 0; i < DMAX; ++i) {
      if (i < d) {
        const float xc = x[i] - p[1 + i];
        quad += xc * xc;
      }
    }
    return -0.5f * quad + p[0];
  }
}

// Dispatch a templated launcher on (target kind, register bucket).
#define RWM_PT_DISPATCH(KIND_VAR, D_VAR, LAUNCH, ...)                        \
  do {                                                                      \
    if (KIND_VAR == TARGET_ROSENBROCK) {                                    \
      if (D_VAR <= 8) return LAUNCH<TARGET_ROSENBROCK, 8>(__VA_ARGS__);      \
      if (D_VAR <= 16) return LAUNCH<TARGET_ROSENBROCK, 16>(__VA_ARGS__);    \
      if (D_VAR <= 32) return LAUNCH<TARGET_ROSENBROCK, 32>(__VA_ARGS__);    \
      return LAUNCH<TARGET_ROSENBROCK, 64>(__VA_ARGS__);                     \
    }                                                                       \
    if (D_VAR <= 8) return LAUNCH<TARGET_MVN_ISO, 8>(__VA_ARGS__);           \
    if (D_VAR <= 16) return LAUNCH<TARGET_MVN_ISO, 16>(__VA_ARGS__);         \
    if (D_VAR <= 32) return LAUNCH<TARGET_MVN_ISO, 32>(__VA_ARGS__);         \
    return LAUNCH<TARGET_MVN_ISO, 64>(__VA_ARGS__);                          \
  } while (0)
