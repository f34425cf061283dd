// Per-lane code shared by the SR rollout kernels (sr_fitness.cu,
// sr_adaptive.cu, sr_rollout.cu): the postorder tree stack machine, the
// candidate's drift, the liveness test and the squared error of one state;
// and, on the card, the staging of a block's trees in shared memory.
//
// A lane is one candidate on one trajectory. Its D trees (one per state
// component) are evaluated as a postorder stack machine: in the root-last
// layout a binary row's first operand is the top of the stack and its second
// the entry below, so no child pointers are read. The stack bound S is a
// template parameter, so a kernel instance for N <= 32 reserves 32 floats of
// local memory, not 256.
//
// Numerics: the float32 operations of the plain PyTorch versions, in their
// order. The files that include this are built with -fmad=false (no FMA
// contraction) and IEEE division, and for the host with -ffp-contract=off.
//
// Everything here is plain C++ under MTGP_HD, so each including file also
// compiles for the host (without __CUDACC__) into a lane loop that tests run
// against the plain versions on machines without a card.
#pragma once

#include <math.h>
#include <stddef.h>
#include <stdint.h>

#ifdef __CUDACC__
#include <cuda_runtime.h>
#define MTGP_HD __host__ __device__
#else
#define MTGP_HD
#endif

namespace {

constexpr int kEmpty = 0;
constexpr int kConst = 1;
constexpr int kOpStart = 2;
constexpr int kMaxNodes = 256;
constexpr float kBound = 1e8f;  // models/integrators.py DIVERGENCE_BOUND

// device op ids: multitreegp_tpu_torch/core/registry.py DEVICE_OPS
constexpr int kAdd = 0;
constexpr int kSub = 1;
constexpr int kMul = 2;
constexpr int kDiv = 3;

// read-only cached load on the card, a plain load on the host
MTGP_HD inline int load_ro(const int* p) {
#ifdef __CUDA_ARCH__
  return __ldg(p);
#else
  return *p;
#endif
}

MTGP_HD inline float apply_binary(int id, float a, float b) {
  switch (id) {
    case kAdd: return a + b;
    case kSub: return a - b;
    case kMul: return a * b;
    default: return a / b;  // kDiv
  }
}

template <int D>
MTGP_HD inline float leaf_value(int var, const float (&x)[D]) {
  float v = 0.0f;  // a variable past the state width reads 0, as in JAX
#pragma unroll
  for (int q = 0; q < D; ++q)
    if (q == var) v = x[q];
  return v;
}

// Root value of one tree (rows `ops[0..n)`, padding first) at state x, with a
// stack of S floats (S >= n, so the guard below never drops a value of a
// well-formed tree).
template <int D, int S>
MTGP_HD float eval_tree(const int* ops, const float* cst, int n,
                        const int* __restrict__ devop, int var_start,
                        const float (&x)[D], float* stack) {
  int sp = 0;
  int i = 0;
  while (i < n && ops[i] == kEmpty) ++i;
  for (; i < n; ++i) {
    const int op = ops[i];
    float v;
    if (op == kConst) {
      v = cst[i];
    } else if (op >= var_start) {
      v = leaf_value<D>(op - var_start, x);
    } else {
      // first operand: the row directly below; second: the subtree below it
      // (the guards only keep a malformed tree inside the stack)
      const float a = sp > 0 ? stack[--sp] : 0.0f;
      const float b = sp > 0 ? stack[--sp] : 0.0f;
      v = apply_binary(load_ro(devop + (op - kOpStart)), a, b);
    }
    if (sp < S) stack[sp++] = v;
  }
  return sp ? stack[sp - 1] : 0.0f;
}

// k = trees(x): tree q of the candidate gives component q.
template <int D, int S>
MTGP_HD inline void drift(const int* ops, const float* cst, int n,
                          const int* __restrict__ devop, int var_start,
                          const float (&x)[D], float (&k)[D], float* stack) {
#pragma unroll
  for (int mi = 0; mi < D; ++mi)
    k[mi] = eval_tree<D, S>(ops + mi * n, cst + mi * n, n, devop, var_start, x, stack);
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
