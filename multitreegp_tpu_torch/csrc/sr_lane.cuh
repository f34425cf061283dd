// Per-lane code shared by the SR rollout kernels (sr_fitness.cu, sr_adaptive.cu,
// sr_rollout.cu): the liveness test and the squared error of one state.
//
// A lane is one candidate on one trajectory; its D trees (one per state
// component) are decoded and run by tree_prog.cuh. The wide-state instance
// (tree_prog_wide.cuh) keeps its state in memory and its d at run time:
// finite_vec and sq_err_vec are the same tests and sums over any vector
// type with operator[].
#pragma once

#include "tree_eval.cuh"

namespace {

template <int D>
MTGP_HD inline bool finite_state(const float (&x)[D]) {
  bool ok = true;
#pragma unroll
  for (int q = 0; q < D; ++q) ok = ok && isfinite(x[q]) && fabsf(x[q]) < kBound;
  return ok;
}

// sum_q (x_q - y_q)^2, left to right
template <int D>
MTGP_HD inline float sq_err(const float (&x)[D], const float* y) {
  float e = (x[0] - y[0]) * (x[0] - y[0]);
#pragma unroll
  for (int q = 1; q < D; ++q) {
    const float dl = x[q] - y[q];
    e = e + dl * dl;
  }
  return e;
}

// finite_state over the d components of x
template <class Vec>
MTGP_HD inline bool finite_vec(const Vec& x, int d) {
  bool ok = true;
  for (int q = 0; q < d && ok; ++q) ok = isfinite(x[q]) && fabsf(x[q]) < kBound;
  return ok;
}

// sq_err over the d components of x, left to right
template <class Vec>
MTGP_HD inline float sq_err_vec(const Vec& x, const float* y, int d) {
  float e = (x[0] - y[0]) * (x[0] - y[0]);
  for (int q = 1; q < d; ++q) {
    const float dl = x[q] - y[q];
    e = e + dl * dl;
  }
  return e;
}

}  // namespace
