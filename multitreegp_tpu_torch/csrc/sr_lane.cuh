// Per-lane code shared by the SR rollout kernels: the liveness test and the
// squared error of one state (sr_fitness.cu, sr_adaptive.cu, sr_rollout.cu);
// the candidate's drift by the stack machine of tree_eval.cuh and, on the
// card, the staging of a block's trees in shared memory (sr_rollout.cu;
// sr_fitness.cu and sr_adaptive.cu decode their trees with tree_prog.cuh).
//
// A lane is one candidate on one trajectory. Its D trees (one per state
// component) are evaluated by the stack machine of tree_eval.cuh on the
// state x.
#pragma once

#include "tree_eval.cuh"

namespace {

// k = trees(x): tree q of the candidate gives component q. U: the function
// set has unary operators (tree_eval.cuh).
template <int D, int S, bool U>
MTGP_HD inline void drift(const int* ops, const float* cst, int n,
                          const int* __restrict__ devop, int var_start,
                          const float (&x)[D], float (&k)[D], float* stack) {
#pragma unroll
  for (int mi = 0; mi < D; ++mi)
    k[mi] = eval_tree<D, S, U>(ops + mi * n, cst + mi * n, n, devop, var_start, x, stack);
}

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

#ifdef __CUDACC__
// A block holds `cpb` candidates x B trajectories, one thread per lane,
// candidate-major. Stages the block's candidates' trees (ops and const,
// `tree_words` each) once into shared memory and gives this thread its
// candidate's staged trees, its global lane index and its trajectory b;
// false for the threads past the block's last candidate.
__device__ inline bool stage_block(const int* __restrict__ ops, const float* __restrict__ cst,
                                   int P, int B, int tree_words, int cpb, const int** t_ops,
                                   const float** t_cst, size_t* lane, int* b) {
  extern __shared__ unsigned char smem[];
  int* s_ops = reinterpret_cast<int*>(smem);
  float* s_cst = reinterpret_cast<float*>(s_ops + cpb * tree_words);
  const int c0 = blockIdx.x * cpb;
  const int ncand = min(cpb, P - c0);
  const size_t base = static_cast<size_t>(c0) * tree_words;
  for (int i = threadIdx.x; i < ncand * tree_words; i += blockDim.x) {
    s_ops[i] = ops[base + i];
    s_cst[i] = cst[base + i];
  }
  __syncthreads();
  const int lc = threadIdx.x / B;
  if (lc >= ncand) return false;
  *b = threadIdx.x - lc * B;
  *lane = static_cast<size_t>(c0 + lc) * B + *b;
  *t_ops = s_ops + lc * tree_words;
  *t_cst = s_cst + lc * tree_words;
  return true;
}

// Shared memory of a block of `cpb` candidates with D trees of n rows each.
inline size_t block_smem(int cpb, int D, int n) {
  return static_cast<size_t>(cpb) * D * n * (sizeof(int) + sizeof(float));
}
#endif

}  // namespace
