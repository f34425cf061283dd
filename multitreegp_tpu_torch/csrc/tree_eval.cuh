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
// Two builds. The default one knows `+ - * / sin cos` (ids 0-5). Built with
// MTGP_EXT_OPS (the `_ext` libraries of _build.py), the tree kernels also
// compute the unary exp, log, sqrt, tanh, tan, abs, neg, square (ids 6-13)
// and the binary pow, max, min (ids 14-16), with the functions PyTorch's
// CUDA kernels call for them: `expf`, `logf`, `sqrtf` (IEEE), `tanhf`,
// `tanf`, `fabsf`, `x * x`, `powf`, and `torch.maximum`/`torch.minimum`'s
// NaN-first `fmaxf`/`fminf`. Without the macro none of that is compiled, so
// the six-operator sets run exactly the code they ran before it existed.
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

// device op ids: multitreegp_tpu_torch/core/registry.py DEVICE_OPS; kSin ..
// kSquare are unary, kPow .. kMin binary (the extended build's, from kExp on)
constexpr int kAdd = 0;
constexpr int kSub = 1;
constexpr int kMul = 2;
constexpr int kDiv = 3;
constexpr int kSin = 4;
constexpr int kCos = 5;
constexpr int kExp = 6;
constexpr int kLog = 7;
constexpr int kSqrt = 8;
constexpr int kTanh = 9;
constexpr int kTan = 10;
constexpr int kAbs = 11;
constexpr int kNeg = 12;
constexpr int kSquare = 13;
constexpr int kPow = 14;
constexpr int kMax = 15;
constexpr int kMin = 16;
#ifdef MTGP_EXT_OPS
constexpr int kLastOp = kMin;  // the largest device op id this build computes
#else
constexpr int kLastOp = kCos;
#endif

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

#ifndef MTGP_EXT_OPS
MTGP_HD inline bool is_unary(int id) { return id >= kSin; }

MTGP_HD inline float apply_unary(int id, float a) {
  return id == kSin ? sinf(a) : cosf(a);
}
#else
MTGP_HD inline bool is_unary(int id) { return id >= kSin && id < kPow; }

MTGP_HD inline float apply_unary(int id, float a) {
  switch (id) {
    case kSin: return sinf(a);
    case kCos: return cosf(a);
    case kExp: return expf(a);
    case kLog: return logf(a);
    case kSqrt: return sqrtf(a);
    case kTanh: return tanhf(a);
    case kTan: return tanf(a);
    case kAbs: return fabsf(a);
    case kNeg: return -a;
    default: return a * a;  // kSquare: torch.square is pow(x, 2), computed x * x
  }
}

// kPow, kMax, kMin. torch.maximum / torch.minimum on the card: the first NaN
// operand, else fmaxf / fminf.
MTGP_HD inline float apply_binary(int id, float a, float b) {
  if (id == kPow) return powf(a, b);
  if (isnan(a)) return a;
  if (isnan(b)) return b;
  return id == kMax ? fmaxf(a, b) : fminf(a, b);
}
#endif

template <int V>
MTGP_HD inline float leaf_value(int var, const float (&data)[V]) {
  float v = 0.0f;  // a variable past the data's width reads 0, as in JAX
#pragma unroll
  for (int q = 0; q < V; ++q)
    if (q == var) v = data[q];
  return v;
}

}  // namespace
