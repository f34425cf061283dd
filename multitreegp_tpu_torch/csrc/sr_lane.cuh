// Per-lane code shared by the SR rollout kernels (sr_fitness.cu, sr_adaptive.cu,
// sr_rollout.cu): the liveness test and the squared error of one state.
//
// A lane is one candidate on one trajectory; its D trees (one per state
// component) are decoded and run by tree_prog.cuh.
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

}  // namespace
