// The tree layout and the operators, leaf lookup and constants of every tree
// kernel: the decoded programs of the SR kernels #1, #3, #4/#5 and the policy
// kernels #6/#7 (tree_prog.cuh), the interpreter kernels (interpreter.cu)
// and the plants (control_envs.cuh).
//
// A tree is `n` rows in the root-last, padding-first layout of
// core/trees.py, a postorder stack machine: a binary row's first operand is
// the top of the stack and its second the entry below; a unary row rewrites
// the top; leaves push; a missing operand, and an empty tree, read 0. No
// child pointers are read. tree_prog.cuh decodes a tree into rows that
// compute this machine's value; the data vector's width V is a template
// parameter, so a leaf's lookup is a chain of selects over registers.
//
// Numerics: the plain PyTorch versions' float32 operations, in their order;
// `sinf` and `cosf` are the C library's on the host and CUDA's on the card
// (PyTorch's CUDA `torch.sin`/`torch.cos` call the same functions; never the
// `__sinf` intrinsics). Files that include this are built with -fmad=false
// and IEEE division, and for the host with -ffp-contract=off.
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

// device op ids: multitreegp_tpu_torch/core/registry.py DEVICE_OPS; the ids
// from kSin on are unary
constexpr int kAdd = 0;
constexpr int kSub = 1;
constexpr int kMul = 2;
constexpr int kDiv = 3;
constexpr int kSin = 4;
constexpr int kCos = 5;

MTGP_HD constexpr float f32(double v) { return static_cast<float>(v); }

// read-only cached load on the card, a plain load on the host
MTGP_HD inline int load_ro(const int* p) {
#ifdef __CUDA_ARCH__
  return __ldg(p);
#else
  return *p;
#endif
}

// jnp.minimum / jnp.maximum / jnp.clip: NaN in, NaN out
MTGP_HD inline float nan_min(float a, float b) {
  if (isnan(a)) return a;
  if (isnan(b)) return b;
  return a < b ? a : b;
}
MTGP_HD inline float nan_max(float a, float b) {
  if (isnan(a)) return a;
  if (isnan(b)) return b;
  return a > b ? a : b;
}
MTGP_HD inline float clip(float v, float lo, float hi) { return nan_min(nan_max(v, lo), hi); }

MTGP_HD inline bool is_unary(int id) { return id >= kSin; }

MTGP_HD inline float apply_unary(int id, float a) {
  return id == kSin ? sinf(a) : cosf(a);
}

template <int V>
MTGP_HD inline float leaf_value(int var, const float (&data)[V]) {
  float v = 0.0f;  // a variable past the data's width reads 0, as in JAX
#pragma unroll
  for (int q = 0; q < V; ++q)
    if (q == var) v = data[q];
  return v;
}

}  // namespace
