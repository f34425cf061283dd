// The tree stack machine of the trajectory kernel #3 (through sr_lane.cuh),
// and the operators, leaf lookup and constants of every tree kernel: the
// decoded programs of #1, the adaptive SR kernels #4/#5 and the policy
// kernels #6/#7 (tree_prog.cuh, whose rows compute what eval_tree computes),
// the interpreter kernels (interpreter.cu) and the plants (control_envs.cuh).
//
// A tree is `n` rows in the root-last, padding-first layout of
// core/trees.py. Evaluated as a postorder stack machine: a binary row's first
// operand is the top of the stack and its second the entry below; a unary row
// rewrites the top; leaves push. No child pointers are read. The stack bound
// S is a template parameter, so a kernel instance for N <= 32 reserves 32
// floats of local memory, not 256; the data vector's width V is one too, so
// a leaf's lookup is a chain of selects over registers.
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

MTGP_HD inline float apply_binary(int id, float a, float b) {
  switch (id) {
    case kAdd: return a + b;
    case kSub: return a - b;
    case kMul: return a * b;
    default: return a / b;  // kDiv
  }
}

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

// Root value of one tree (rows `ops[0..n)`, padding first) on the data vector
// `data`, with a stack of S floats (S >= n, so the guard below never drops a
// value of a well-formed tree). U = false compiles the unary rows out, so a
// function set without them runs the binary-only loop (with them compiled
// in, never taken, the SR kernels ran 12-19% slower on the card).
template <int V, int S, bool U = true>
MTGP_HD float eval_tree(const int* ops, const float* cst, int n,
                        const int* __restrict__ devop, int var_start,
                        const float (&data)[V], float* stack) {
  int sp = 0;
  int i = 0;
  while (i < n && ops[i] == kEmpty) ++i;
  for (; i < n; ++i) {
    const int op = ops[i];
    float v;
    if (op == kConst) {
      v = cst[i];
    } else if (op >= var_start) {
      v = leaf_value<V>(op - var_start, data);
    } else if (U && is_unary(load_ro(devop + (op - kOpStart)))) {
      // a unary row rewrites the top of the stack
      const float a = sp > 0 ? stack[--sp] : 0.0f;
      v = apply_unary(load_ro(devop + (op - kOpStart)), a);
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

}  // namespace
