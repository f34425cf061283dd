// Decoded tree programs: the tree machine of the kernels that evaluate a
// candidate's trees at every stage of a rollout, the fused SR fitness
// (sr_fitness.cu, #1), the SR trajectory (sr_rollout.cu, #3), the adaptive
// SR fitness (sr_adaptive.cu, #4 and #5) and the closed-loop policy kernels
// (policy.cu, #6 and #7).
//
// A block decodes its candidates' trees once, when it stages them into
// shared memory (stage_programs), into programs of 8-byte rows
// (decode_tree): the row's kind, its device op id or data slot folded into
// one word beside its constant, and the first live row of each tree
// recorded, so the per-row loop makes no global load and never re-scans the
// padding. In the root-last layout of core/trees.py a binary row's first
// operand is the top of the stack and its second the entry below; postorder
// fixes the stack depth at every row, so the decode also assigns each row
// its stack slot. The top of the stack lives in a register (the
// accumulator): a leaf stores the old top to its slot and becomes the top, a
// binary row reads its second operand from its slot, so a row makes at most
// one stack access, whose address does not wait for the data. A well-formed
// tree of n rows holds at most (n + 1) / 2 values, so the instance for N
// rows keeps N / 2 slots a tree besides the register, in local memory. The
// K trees evaluated together run row by row in one loop (run_trees), K
// independent chains for the card to overlap, and every row runs the same
// branch-free instructions whatever its kind, so the candidates that share
// a warp do not take their rows' branches one after the other.
//
// Numerics: each row applies the operator of tree_eval.cuh to the operands
// that file's postorder stack machine would pop, so a decoded program
// computes that machine's value bit for bit on a well-formed tree.
//
// Plain C++ under MTGP_HD, so the including files' host builds run it.
#pragma once

#include "tree_eval.cuh"

namespace {

// One decoded tree row: `meta` holds the kind (bits 0-1), the data slot or
// device op id (bits 2-7), a flag (bit 8: a leaf stores the old top to its
// slot; a binary row reads its second operand from its slot) and the slot
// (bits 16-30); `c` is the constant of a constant leaf (0 for padding rows,
// which so keep the accumulator at 0).
struct alignas(8) Row {
  int meta;
  float c;
};

constexpr int kLeafConst = 0;
constexpr int kLeafVar = 1;
constexpr int kBinary = 2;
constexpr int kUnary = 3;
constexpr int kFlag = 1 << 8;

// Stack slots of one tree besides the accumulator in the instance for trees
// of up to N rows (a well-formed tree holds at most (N + 1) / 2 values).
template <int N>
MTGP_HD constexpr int stack_slots() { return N / 2; }

// Decode one tree in place: rows[i].meta holds the opcode on entry and the
// decoded word on exit (rows before the first live row become constant-0
// leaves); returns the first live row. The simulated stack depth `sp`
// follows the stack machine's pops and pushes, so a row reads and writes the
// values that machine would. A malformed tree deeper than the instance's slots (never
// made by the system) is clamped into them and evaluates to an unspecified
// value. A data slot past 63 would read slot 63: the SR wrappers refuse sets
// of more than 63 variables (core/cuda_rollout.py kernel_operands), which
// run the wide instance's 29-bit slot (tree_prog_wide.cuh); the policy
// kernels' data vector is a plant's few observations and targets.
template <int N>
MTGP_HD int decode_tree(Row* rows, int n, const int* __restrict__ devop, int var_start) {
  constexpr int kSlots = stack_slots<N>();
  int start = 0;
  while (start < n && rows[start].meta == kEmpty) rows[start++].c = 0.0f;
  int sp = 0;  // values on the stack: the top in the accumulator, the rest in slots 0..sp-2
  for (int i = start; i < n; ++i) {
    const int op = rows[i].meta;
    int meta;
    if (op == kConst || op >= var_start) {
      meta = op == kConst ? kLeafConst : kLeafVar | (op - var_start < 63 ? op - var_start : 63) << 2;
      if (sp > 0) meta |= kFlag | (sp - 1 < kSlots ? sp - 1 : kSlots - 1) << 16;
      ++sp;
    } else {
      const int id = load_ro(devop + (op - kOpStart));
      if (is_unary(id)) {
        meta = kUnary | id << 2;
        if (sp == 0) sp = 1;
      } else {
        meta = kBinary | id << 2;
        if (sp >= 2) meta |= kFlag | (sp - 2 < kSlots ? sp - 2 : kSlots - 1) << 16;
        sp = (sp >= 2 ? sp - 2 : 0) + 1;
      }
    }
    rows[i].meta = meta;
  }
  return start;
}

// One decoded row of a tree whose value so far is `acc` (the stack machine's
// missing operand and empty tree read 0), its stack slots at `stk`, on the
// data vector x; U = false compiles the unary rows out (compiled in and
// never taken, they slowed the SR kernels 12-19% on + - * / sets). A row's
// work is the same instructions whatever its kind (the leaf value, the
// second operand and +, -, * are all formed, one is kept): the candidates of
// a warp run different trees, and their rows would otherwise take different
// branches one after the other. Division and the unary operators, whose
// code is long, keep a branch, as do the extended build's pow, max and min:
// a row's value is selected, never masked by a multiply (an exp or log not
// kept can be inf or NaN, and 0 * inf is NaN).
template <int V, bool U>
MTGP_HD inline void row_step(const Row w, const float (&x)[V], float& acc, float* stk) {
  const int arg = (w.meta >> 2) & 63;
  const bool op_row = w.meta & 2;
  const bool flag = w.meta & kFlag;
  float* slot = stk + (w.meta >> 16);
  const float b = flag ? *slot : 0.0f;
  float r = arg == kAdd ? acc + b : arg == kSub ? acc - b : acc * b;
  if (op_row && arg == kDiv) r = acc / b;
#ifdef MTGP_EXT_OPS
  if (op_row && arg >= kPow) r = apply_binary(arg, acc, b);  // unary ids lie below kPow
#endif
  if (U && (w.meta & 3) == kUnary) r = apply_unary(arg, acc);
  const float v = (w.meta & 1) ? leaf_value<V>(arg, x) : w.c;
  if (!op_row && flag) *slot = acc;
  acc = op_row ? r : v;
}

// out[k] = tree k of the K decoded trees at prog (tree k's rows at prog + k
// * n) on the data vector x, row by row in one loop from `first`, the first
// live row of any of them (padding rows are constant-0 leaves, so a tree's
// value stays 0 until its first live row): K independent chains. Tree k's
// stack slots are at stk + k * tree_stride.
template <int K, int V, bool U>
MTGP_HD inline void run_trees(const Row* prog, int first, int n, const float (&x)[V],
                              float (&out)[K], float* stk, int tree_stride) {
  float acc[K];
#pragma unroll
  for (int q = 0; q < K; ++q) acc[q] = 0.0f;
  for (int i = first; i < n; ++i) {
#pragma unroll
    for (int q = 0; q < K; ++q) row_step<V, U>(prog[q * n + i], x, acc[q], stk + q * tree_stride);
  }
#pragma unroll
  for (int q = 0; q < K; ++q) out[q] = acc[q];
}

#ifdef __CUDACC__
// Shared memory of a block of `cpb` candidates with m trees of n rows: the
// decoded rows, then the first live row of each tree.
inline size_t program_smem(int cpb, int m, int n) {
  return static_cast<size_t>(cpb) * m * (n * sizeof(Row) + sizeof(int));
}

// Stages the trees (`ops`, `cst`: (P, m, n)) of this block's candidates
// c0 = blockIdx.x * cpb ... into shared memory and decodes them: s_prog
// holds the block's ncand * m programs of n rows, s_start each one's first
// live row. Returns ncand; every thread of the block must call it.
template <int N>
__device__ inline int stage_programs(const int* __restrict__ ops, const float* __restrict__ cst,
                                     const int* __restrict__ devop, int var_start, int P, int m,
                                     int n, int cpb, Row* s_prog, int* s_start) {
  const int c0 = blockIdx.x * cpb;
  const int ncand = min(cpb, P - c0);
  const int words = m * n;
  const size_t base = static_cast<size_t>(c0) * words;
  for (int i = threadIdx.x; i < ncand * words; i += blockDim.x) {
    s_prog[i].meta = ops[base + i];
    s_prog[i].c = cst[base + i];
  }
  __syncthreads();
  for (int t = threadIdx.x; t < ncand * m; t += blockDim.x)
    s_start[t] = decode_tree<N>(s_prog + t * n, n, devop, var_start);
  __syncthreads();
  return ncand;
}
#endif

}  // namespace
