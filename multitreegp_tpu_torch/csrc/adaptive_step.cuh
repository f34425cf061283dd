// The adaptive controller's step, shared by the adaptive SR kernels
// (sr_adaptive.cu, TPU kernels #5 and #4) and the adaptive closed-loop policy
// kernel (policy.cu, #7): one embedded Runge-Kutta step (Bogacki-Shampine
// 3(2) or Dormand-Prince 5(4), first-same-as-last) of a drift given as a
// functor, its error norm, and the I controller's step factor.
//
// Numerics: the JAX kernels' float32 expressions in their order (the same as
// the plain versions in core/cuda_adaptive.py): stage inputs x + (0.5*dt)*k,
// Python-style tableau sums from 0.0 that keep their literal 0.0*k terms
// (0*inf is NaN), tableau entries rounded once from double to float32, and
// constants such as 1e-12 or 1.5e-3 as float32 values (a double literal would
// promote the expression to double). min/max/clip propagate NaN as JAX's do.
#pragma once

#include "tree_eval.cuh"

namespace {

enum AdaptiveMethod { kBosh3 = 0, kDopri5 = 1 };

// sum(c[j] * ks[j] for j < nk), from 0.0, left to right (Python's sum); the
// fixed trip count lets the loops unroll, so ks stays in registers
template <int D>
MTGP_HD inline float tableau_sum(const float* c, int nk, const float (*ks)[D], int q) {
  float s = 0.0f;
#pragma unroll
  for (int j = 0; j < 7; ++j)
    if (j < nk) s = s + c[j] * ks[j][q];
  return s;
}

// One embedded step of size dt from x with k1 = f(x) (the FSAL carry), where
// `f(x, k)` writes the drift k at x. Writes the higher-order solution x_hi
// and the last stage k_last (= f(x_hi)); returns err_norm = sqrt(acc *
// (1/D)), acc summed component by component.
template <int D, class Drift>
MTGP_HD float rk_step(const Drift& f, int method, const float (&x)[D], const float (&k1)[D],
                      float dt, float rtol, float atol, float (&x_hi)[D], float (&k_last)[D]) {
  float x_lo[D], xs[D];
  if (method == kBosh3) {
    const float a2[3] = {f32(2.0 / 9.0), f32(1.0 / 3.0), f32(4.0 / 9.0)};
    const float bl[4] = {f32(7.0 / 24.0), f32(0.25), f32(1.0 / 3.0), f32(0.125)};
    float k2[D], k3[D];
    const float h2 = 0.5f * dt;
#pragma unroll
    for (int q = 0; q < D; ++q) xs[q] = x[q] + h2 * k1[q];
    f(xs, k2);
    const float h3 = 0.75f * dt;
#pragma unroll
    for (int q = 0; q < D; ++q) xs[q] = x[q] + h3 * k2[q];
    f(xs, k3);
#pragma unroll
    for (int q = 0; q < D; ++q)
      x_hi[q] = x[q] + dt * ((a2[0] * k1[q] + a2[1] * k2[q]) + a2[2] * k3[q]);
    f(x_hi, k_last);
#pragma unroll
    for (int q = 0; q < D; ++q)
      x_lo[q] = x[q] + dt * (((bl[0] * k1[q] + bl[1] * k2[q]) + bl[2] * k3[q]) +
                             bl[3] * k_last[q]);
  } else {
    // multitreegp_tpu/models/integrators.py _DP_A, _DP_B5, _DP_B4
    const float a[6][6] = {
        {f32(0.2)},
        {f32(3.0 / 40.0), f32(9.0 / 40.0)},
        {f32(44.0 / 45.0), f32(-56.0 / 15.0), f32(32.0 / 9.0)},
        {f32(19372.0 / 6561.0), f32(-25360.0 / 2187.0), f32(64448.0 / 6561.0),
         f32(-212.0 / 729.0)},
        {f32(9017.0 / 3168.0), f32(-355.0 / 33.0), f32(46732.0 / 5247.0), f32(49.0 / 176.0),
         f32(-5103.0 / 18656.0)},
        {f32(35.0 / 384.0), 0.0f, f32(500.0 / 1113.0), f32(125.0 / 192.0),
         f32(-2187.0 / 6784.0), f32(11.0 / 84.0)},
    };
    const float b5[7] = {f32(35.0 / 384.0), 0.0f, f32(500.0 / 1113.0), f32(125.0 / 192.0),
                         f32(-2187.0 / 6784.0), f32(11.0 / 84.0), 0.0f};
    const float b4[7] = {f32(5179.0 / 57600.0), 0.0f, f32(7571.0 / 16695.0),
                         f32(393.0 / 640.0), f32(-92097.0 / 339200.0), f32(187.0 / 2100.0),
                         f32(1.0 / 40.0)};
    float ks[7][D];
#pragma unroll
    for (int q = 0; q < D; ++q) ks[0][q] = k1[q];
#pragma unroll
    for (int r = 0; r < 6; ++r) {
#pragma unroll
      for (int q = 0; q < D; ++q) xs[q] = x[q] + dt * tableau_sum<D>(a[r], r + 1, ks, q);
      f(xs, ks[r + 1]);
    }
#pragma unroll
    for (int q = 0; q < D; ++q) {
      x_hi[q] = x[q] + dt * tableau_sum<D>(b5, 7, ks, q);
      x_lo[q] = x[q] + dt * tableau_sum<D>(b4, 7, ks, q);
      k_last[q] = ks[6][q];
    }
  }
  float acc = 0.0f;
#pragma unroll
  for (int q = 0; q < D; ++q) {
    const float scale = atol + rtol * nan_max(fabsf(x[q]), fabsf(x_hi[q]));
    const float r = (x_hi[q] - x_lo[q]) / scale;
    acc = acc + r * r;
  }
  return sqrtf(acc * f32(1.0 / D));
}

// tableau_sum over stage vectors in memory
template <class Vec>
MTGP_HD inline float tableau_sum_n(const float* c, int nk, const Vec* ks, int q) {
  float s = 0.0f;
  for (int j = 0; j < nk; ++j) s = s + c[j] * ks[j][q];
  return s;
}

// The run-time-d form of rk_step for state vectors in memory (the wide SR
// kernels, tree_prog_wide.cuh): the same expressions in the same order over
// any vector type with operator[]. ks[0] holds k1 (the FSAL carry) on entry;
// ks[1..5] are the stages' scratch; the last stage (= f(x_hi)) is written to
// ks[6] (bosh3 uses ks[1], ks[2] and ks[6]); xs is the stage inputs'
// scratch. x_lo is formed per component where the error norm reads it.
template <class Vec, class Drift>
MTGP_HD float rk_step_n(const Drift& f, int method, int d, const Vec& x, const Vec* ks, float dt,
                        float rtol, float atol, const Vec& x_hi, const Vec& xs) {
  float acc = 0.0f;
  if (method == kBosh3) {
    const float a2[3] = {f32(2.0 / 9.0), f32(1.0 / 3.0), f32(4.0 / 9.0)};
    const float bl[4] = {f32(7.0 / 24.0), f32(0.25), f32(1.0 / 3.0), f32(0.125)};
    const Vec &k1 = ks[0], &k2 = ks[1], &k3 = ks[2], &k_last = ks[6];
    const float h2 = 0.5f * dt;
    for (int q = 0; q < d; ++q) xs[q] = x[q] + h2 * k1[q];
    f(xs, k2);
    const float h3 = 0.75f * dt;
    for (int q = 0; q < d; ++q) xs[q] = x[q] + h3 * k2[q];
    f(xs, k3);
    for (int q = 0; q < d; ++q)
      x_hi[q] = x[q] + dt * ((a2[0] * k1[q] + a2[1] * k2[q]) + a2[2] * k3[q]);
    f(x_hi, k_last);
    for (int q = 0; q < d; ++q) {
      const float x_lo = x[q] + dt * (((bl[0] * k1[q] + bl[1] * k2[q]) + bl[2] * k3[q]) +
                                      bl[3] * k_last[q]);
      const float scale = atol + rtol * nan_max(fabsf(x[q]), fabsf(x_hi[q]));
      const float r = (x_hi[q] - x_lo) / scale;
      acc = acc + r * r;
    }
  } else {
    // multitreegp_tpu/models/integrators.py _DP_A, _DP_B5, _DP_B4
    const float a[6][6] = {
        {f32(0.2)},
        {f32(3.0 / 40.0), f32(9.0 / 40.0)},
        {f32(44.0 / 45.0), f32(-56.0 / 15.0), f32(32.0 / 9.0)},
        {f32(19372.0 / 6561.0), f32(-25360.0 / 2187.0), f32(64448.0 / 6561.0),
         f32(-212.0 / 729.0)},
        {f32(9017.0 / 3168.0), f32(-355.0 / 33.0), f32(46732.0 / 5247.0), f32(49.0 / 176.0),
         f32(-5103.0 / 18656.0)},
        {f32(35.0 / 384.0), 0.0f, f32(500.0 / 1113.0), f32(125.0 / 192.0),
         f32(-2187.0 / 6784.0), f32(11.0 / 84.0)},
    };
    const float b5[7] = {f32(35.0 / 384.0), 0.0f, f32(500.0 / 1113.0), f32(125.0 / 192.0),
                         f32(-2187.0 / 6784.0), f32(11.0 / 84.0), 0.0f};
    const float b4[7] = {f32(5179.0 / 57600.0), 0.0f, f32(7571.0 / 16695.0),
                         f32(393.0 / 640.0), f32(-92097.0 / 339200.0), f32(187.0 / 2100.0),
                         f32(1.0 / 40.0)};
    for (int r = 0; r < 6; ++r) {
      for (int q = 0; q < d; ++q) xs[q] = x[q] + dt * tableau_sum_n(a[r], r + 1, ks, q);
      f(xs, ks[r + 1]);
    }
    for (int q = 0; q < d; ++q) {
      x_hi[q] = x[q] + dt * tableau_sum_n(b5, 7, ks, q);
      const float x_lo = x[q] + dt * tableau_sum_n(b4, 7, ks, q);
      const float scale = atol + rtol * nan_max(fabsf(x[q]), fabsf(x_hi[q]));
      const float r = (x_hi[q] - x_lo) / scale;
      acc = acc + r * r;
    }
  }
  return sqrtf(acc * f32(1.0 / d));
}

// The I controller's step factor.
MTGP_HD inline float step_factor(float err, bool ok, float safety, float expo) {
  if (isfinite(err) && err > 0.0f) return clip(safety * powf(err, expo), f32(0.2), f32(5.0));
  return ok ? f32(5.0) : f32(0.2);
}

MTGP_HD inline float error_exponent(int method) {
  return method == kBosh3 ? f32(-1.0 / 3.0) : f32(-0.2);
}

// Controller constants, float32 as JAX rounds the Python doubles.
constexpr float kCross = f32(1e-12);    // t < t1 - 1e-12: still inside the interval
constexpr float kDtMin = f32(1e-3);     // dt >= span * 1e-3
constexpr float kDtDead = f32(1.5e-3);  // NaN at dt_c <= span * 1.5e-3 kills the lane
constexpr float kReach = f32(1e-9);     // reached: t >= t1 - 1e-9 * max(|t1|, 1)

}  // namespace
