// The wide-state instance of the tree machine: the fused SR fitness
// (sr_fitness.cu, #1), the SR trajectory (sr_rollout.cu, #3), the adaptive
// SR fitness (sr_adaptive.cu, #4 and #5) for any state dimension d and any
// number of trajectories, and the closed-loop policy kernels (policy.cu, #6
// and #7) for any hidden state, number of targets and trajectories, compiled
// only in their `_wide` builds (-DMTGP_WIDE_STATE, _build.py).
//
// What differs from tree_prog.cuh's fixed instances, whose state dim is a
// template parameter and whose state and stages live in registers:
// * A lane's vectors (the state, the stage inputs, the stages, the stage
//   sums; a policy's data vector) have a run-time length and live in a
//   scratch buffer that the wrapper allocates, laid out
//   [vector][component][lane] (LaneVec), so the lanes of a warp touch one
//   component's entries side by side. A tree's leaf reads its variable there.
// * A decoded row is two words (WideRow): the kind, the stack flag and, in
//   29 bits, the data slot or device op id (a constant leaf: its stack
//   slot), then the constant's bits (a constant leaf) or the stack slot. So
//   no field caps the variables: tree_prog.cuh's 6-bit slot reads variable 63
//   for any variable past it.
// * A candidate's trees run in groups of kGroup (WideTrees): kGroup
//   accumulators and kGroup x N/2 stack slots live at once, whatever the
//   number of trees.
// * A block holds `cpb` candidates x at most kWideLanes of their
//   trajectories (a candidate with more spans gridDim.y blocks); the
//   candidates' decoded rows are staged in shared memory, past 48 KB by
//   opting in, up to the block's 227 KB: the one limit on the trees a
//   candidate (the wrappers' gates, core/cuda_rollout.py lanes_refusal,
//   core/cuda_policy.py policy_lanes_refusal).
//
// Numerics: each tree's value and each component's stage sum are the fixed
// instances' float32 expressions in their order, so where a fixed instance
// runs a wide lane is bit-equal to it, and at any size to the plain versions.
//
// Plain C++ under MTGP_HD, so the including files' host builds run it.
#pragma once

#include <string.h>

#include <vector>

#include "tree_prog.cuh"

namespace {

// Trees evaluated together (K independent chains of one row loop).
constexpr int kGroup = 4;
// The most trajectories of one candidate a block holds (core/cuda_rollout.py
// WIDE_LANES).
constexpr int kWideLanes = 128;
// WideRow.a: a leaf stores the old top to its slot; a binary row reads its
// second operand from its slot
constexpr int kWideFlag = 4;

// One decoded row: `a` = kind (bits 0-1) | kWideFlag | field << 3, the field
// the data slot (a variable leaf), the device op id (an operator row) or the
// stack slot (a constant leaf); `b` the constant's bits (a constant leaf; 0
// for padding rows, which so keep the accumulator at 0), else the stack slot
// (0 on a unary row).
struct alignas(8) WideRow {
  int a;
  int b;
};

MTGP_HD inline float bits_float(int b) {
#ifdef __CUDA_ARCH__
  return __int_as_float(b);
#else
  float f;
  memcpy(&f, &b, sizeof f);
  return f;
#endif
}

MTGP_HD inline int float_bits(float f) {
#ifdef __CUDA_ARCH__
  return __float_as_int(f);
#else
  int b;
  memcpy(&b, &f, sizeof b);
  return b;
#endif
}

// A lane's vector of run-time length in the scratch buffer: component q at
// p[q * s] (s: the launch's lanes).
struct LaneVec {
  float* p;
  size_t s;
  MTGP_HD float& operator[](int q) const { return p[static_cast<size_t>(q) * s]; }
};

// decode_tree of tree_prog.cuh into WideRows: rows[i] holds {opcode, the
// constant's bits} on entry and the decoded row on exit; returns the first
// live row. The same stack simulation, slot clamp and padding.
template <int N>
MTGP_HD int decode_tree_wide(WideRow* rows, int n, const int* __restrict__ devop, int var_start) {
  constexpr int kSlots = stack_slots<N>();
  int start = 0;
  while (start < n && rows[start].a == kEmpty) rows[start++].b = 0;
  int sp = 0;  // values on the stack: the top in the accumulator, the rest in slots 0..sp-2
  for (int i = start; i < n; ++i) {
    const int op = rows[i].a;
    if (op == kConst || op >= var_start) {
      const int flag = sp > 0 ? kWideFlag : 0;
      const int slot = sp > 0 ? (sp - 1 < kSlots ? sp - 1 : kSlots - 1) : 0;
      if (op == kConst) {
        rows[i].a = kLeafConst | flag | slot << 3;
      } else {
        rows[i].a = kLeafVar | flag | (op - var_start) << 3;
        rows[i].b = slot;
      }
      ++sp;
    } else {
      const int id = load_ro(devop + (op - kOpStart));
      if (is_unary(id)) {
        rows[i] = WideRow{kUnary | id << 3, 0};
        if (sp == 0) sp = 1;
      } else {
        const int slot = sp >= 2 ? (sp - 2 < kSlots ? sp - 2 : kSlots - 1) : 0;
        rows[i] = WideRow{kBinary | (sp >= 2 ? kWideFlag : 0) | id << 3, slot};
        sp = (sp >= 2 ? sp - 2 : 0) + 1;
      }
    }
  }
  return start;
}

// row_step of tree_prog.cuh on a WideRow: the same operands, operators and
// selects; a variable leaf reads component `field` of x (0 past its `width`
// components, as in JAX).
template <bool U>
MTGP_HD inline void wide_row_step(const WideRow w, const LaneVec& x, int width, float& acc,
                                  float* stk) {
  const int kind = w.a & 3;
  const int arg = w.a >> 3;
  const bool op_row = kind & 2;
  const bool flag = w.a & kWideFlag;
  float* slot = stk + (kind == kLeafConst ? arg : w.b);
  const float b = flag ? *slot : 0.0f;
  float r = arg == kAdd ? acc + b : arg == kSub ? acc - b : acc * b;
  if (op_row && arg == kDiv) r = acc / b;
#ifdef MTGP_EXT_OPS
  if (op_row && arg >= kPow) r = apply_binary(arg, acc, b);  // unary ids lie below kPow
#endif
  if (U && kind == kUnary) r = apply_unary(arg, acc);
  const float v = kind == kLeafVar ? (arg < width ? x[arg] : 0.0f) : bits_float(w.b);
  if (!op_row && flag) *slot = acc;
  acc = op_row ? r : v;
}

// out[k] = tree k of the K decoded trees at prog (tree k's rows at prog + k
// * n, its first live row start[k]) on the data x of `width` components, row
// by row in one loop from the first live row of any of them; tree k's stack
// slots at stk + k * stride.
template <int K, bool U>
MTGP_HD inline void run_tree_group(const WideRow* prog, const int* start, int n, int width,
                                   const LaneVec& x, float (&out)[K], float* stk, int stride) {
  int first = n;
#pragma unroll
  for (int k = 0; k < K; ++k) first = start[k] < first ? start[k] : first;
  float acc[K];
#pragma unroll
  for (int k = 0; k < K; ++k) acc[k] = 0.0f;
  for (int i = first; i < n; ++i) {
#pragma unroll
    for (int k = 0; k < K; ++k) wide_row_step<U>(prog[k * n + i], x, width, acc[k], stk + k * stride);
  }
#pragma unroll
  for (int k = 0; k < K; ++k) out[k] = acc[k];
}

// A candidate's d decoded trees (tree q's rows at prog + q * n, its first
// live row start[q]), kGroup at a time; the stack slots of a group's tree k
// at stk + k * stride. As the SR drift, out = trees(in) on the data `in` of d
// components; `out` is never `in`.
template <bool U>
struct WideTrees {
  const WideRow* prog;
  const int* start;
  int n, d;
  float* stk;
  int stride;

  // out[k] = tree t + k on the data x of `width` components, for k < K
  template <int K>
  MTGP_HD void group(int t, const LaneVec& x, int width, float (&out)[K]) const {
    run_tree_group<K, U>(prog + t * n, start + t, n, width, x, out, stk, stride);
  }

  // out[j] = tree t0 + j on the data x of `width` components, for j < count
  MTGP_HD void run(int t0, int count, const LaneVec& x, int width, const LaneVec& out) const {
    int j = 0;
    for (; j + kGroup <= count; j += kGroup) put<kGroup>(t0 + j, x, width, out, j);
    const int rest = count - j;
    if (rest == 3)
      put<3>(t0 + j, x, width, out, j);
    else if (rest == 2)
      put<2>(t0 + j, x, width, out, j);
    else if (rest == 1)
      put<1>(t0 + j, x, width, out, j);
  }

  MTGP_HD void operator()(const LaneVec& in, const LaneVec& out) const { run(0, d, in, d, out); }

 private:
  template <int K>
  MTGP_HD void put(int t, const LaneVec& x, int width, const LaneVec& out, int j) const {
    float v[K];
    group<K>(t, x, width, v);
#pragma unroll
    for (int k = 0; k < K; ++k) out[j + k] = v[k];
  }
};

// The vectors of an adaptive wide lane (#4/#5, #7): the state, x_hi, the
// stage input, then the seven stages (ks[0] the FSAL k1, ks[6] the last
// stage).
struct WideVectors {
  LaneVec x, x_hi, xs;
  LaneVec ks[7];
  // an accepted step: x_hi becomes the state, the last stage k1
  MTGP_HD void accept() {
    const LaneVec x0 = x, k0 = ks[0];
    x = x_hi;
    x_hi = x0;
    ks[0] = ks[6];
    ks[6] = k0;
  }
};

// What every wide launch shares: the trees ((P, d, n) opcodes and
// constants: d trees a candidate), the launch's candidates c0 .. c0 + count
// - 1 of B trajectories each, and its scratch, [vector][component][lane],
// lane (c - c0) * B + b. The SR kernels' lane vectors have d floats each.
struct WideSpan {
  const int* ops;
  const float* cst;
  const int* devop;
  int var_start, d, n, B, c0, count;
  float* scratch;
};

// The launch's lane li's vector whose first component is component q0 of
// the scratch.
MTGP_HD inline LaneVec scratch_vec(const WideSpan& s, size_t q0, size_t li) {
  const size_t lanes = static_cast<size_t>(s.count) * s.B;
  return LaneVec{s.scratch + q0 * lanes + li, lanes};
}

// Vector v of the launch's lane li, of d floats.
MTGP_HD inline LaneVec lane_vec(const WideSpan& s, int v, size_t li) {
  return scratch_vec(s, static_cast<size_t>(v) * s.d, li);
}

inline bool bad_span(const WideSpan& s) {
  return s.d <= 0 || s.n <= 0 || s.n > kMaxNodes || s.B <= 0 || s.c0 < 0 || s.count <= 0 ||
         s.scratch == nullptr;
}

#ifdef __CUDACC__
// Shared memory of a block of `cpb` candidates: their decoded rows, then the
// first live row of each tree.
inline size_t wide_program_smem(int cpb, int d, int n) {
  return static_cast<size_t>(cpb) * d * (n * sizeof(WideRow) + sizeof(int));
}

// A block: stages and decodes the trees of its candidates c0 + blockIdx.x *
// cpb ... into shared memory (every thread takes part), then runs
// lane(trees, c, b, li) on its thread's lane, candidate c, trajectory
// blockIdx.y * bpb + the thread's rank among its candidate's.
template <bool U, int N, class Lane>
__device__ inline void wide_block(const WideSpan& s, int cpb, int bpb, Lane lane) {
  extern __shared__ unsigned char smem[];
  WideRow* s_prog = reinterpret_cast<WideRow*>(smem);  // cpb * d trees of n rows
  int* s_start = reinterpret_cast<int*>(s_prog + static_cast<size_t>(cpb) * s.d * s.n);
  const int first = blockIdx.x * cpb;  // relative to c0
  const int ncand = min(cpb, s.count - first);
  const size_t words = static_cast<size_t>(s.d) * s.n;
  const size_t base = static_cast<size_t>(s.c0 + first) * words;
  for (size_t i = threadIdx.x; i < ncand * words; i += blockDim.x)
    s_prog[i] = WideRow{s.ops[base + i], float_bits(s.cst[base + i])};
  __syncthreads();
  for (int t = threadIdx.x; t < ncand * s.d; t += blockDim.x)
    s_start[t] = decode_tree_wide<N>(s_prog + static_cast<size_t>(t) * s.n, s.n, s.devop,
                                     s.var_start);
  __syncthreads();
  const int lc = threadIdx.x / bpb;
  const int b = blockIdx.y * bpb + threadIdx.x - lc * bpb;
  if (lc >= ncand || b >= s.B) return;
  float stk[kGroup * stack_slots<N>()];  // a group's tree k's slots at k * stack_slots<N>()
  const WideTrees<U> f{s_prog + static_cast<size_t>(lc) * words, s_start + lc * s.d, s.n, s.d,
                       stk, stack_slots<N>()};
  lane(f, s.c0 + first + lc, b, static_cast<size_t>(first + lc) * s.B + b);
}

// Launches kernel(s, io, cpb, bpb) on the span's blocks: a candidate's
// trajectories at most kWideLanes a block; shared memory above 48 KB opted
// in (the wrapper sizes cpb by the rows).
template <class IO>
cudaError_t launch_wide(void (*kernel)(WideSpan, IO, int, int), const WideSpan& s, const IO& io,
                        int cpb, cudaStream_t stream) {
  const int bpb = s.B < kWideLanes ? s.B : kWideLanes;
  if (cpb <= 0 || cpb * bpb > 1024) return cudaErrorInvalidValue;
  const dim3 grid((s.count + cpb - 1) / cpb, (s.B + bpb - 1) / bpb);
  const size_t smem = wide_program_smem(cpb, s.d, s.n);
  if (smem > 48 * 1024) {
    const cudaError_t e = cudaFuncSetAttribute(
        kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, static_cast<int>(smem));
    if (e != cudaSuccess) return e;
  }
  kernel<<<grid, cpb * bpb, smem, stream>>>(s, io, cpb, bpb);
  return cudaGetLastError();
}
#else
// The host build's lane loop: decodes every candidate of the span as a block
// does, then runs lane(trees, c, b, li) on each of its trajectories.
template <bool U, int N, class Lane>
void wide_host(const WideSpan& s, Lane lane) {
  const size_t words = static_cast<size_t>(s.d) * s.n;
  std::vector<WideRow> prog(words);
  std::vector<int> start(s.d);
  float stk[kGroup * stack_slots<N>()];
  const WideTrees<U> f{prog.data(), start.data(), s.n, s.d, stk, stack_slots<N>()};
  for (int c = s.c0; c < s.c0 + s.count; ++c) {
    const size_t base = static_cast<size_t>(c) * words;
    for (size_t i = 0; i < words; ++i) prog[i] = WideRow{s.ops[base + i], float_bits(s.cst[base + i])};
    for (int q = 0; q < s.d; ++q)
      start[q] = decode_tree_wide<N>(prog.data() + static_cast<size_t>(q) * s.n, s.n, s.devop,
                                     s.var_start);
    for (int b = 0; b < s.B; ++b) lane(f, c, b, static_cast<size_t>(c - s.c0) * s.B + b);
  }
}
#endif

// The instance for the span's trees: U (unary rows) and N (32, or kMaxNodes
// = 256) from the run's values; CALL(U, N) is the launch.
#define MTGP_WIDE_INSTANCE(CALL, n, unary)                                  \
  ((n) <= 32 ? ((unary) ? CALL(true, 32) : CALL(false, 32))                  \
             : ((unary) ? CALL(true, kMaxNodes) : CALL(false, kMaxNodes)))

}  // namespace
