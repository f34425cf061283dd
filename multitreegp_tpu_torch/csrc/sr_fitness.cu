// Fused symbolic-regression fitness: fixed-step rollout + squared error.
//
// Replaces the TPU kernel `_make_fitness_kernel` of
// multitreegp_tpu/core/pallas_rollout.py (reached through
// `rollout_sr_fitness_pallas` -> `_fitness_prepare` -> `pl.pallas_call`).
// It computes what that kernel computes, per lane (candidate x trajectory):
// the euler/heun/rk4 rollout of dx = trees(x) over the save grid `ts`, the
// alive freeze (a lane whose state is non-finite or reaches |x| >= 1e8 keeps
// its frozen state) and err = sum_t sum_d (x_t - y_t)^2, the x0 row included.
// No trajectory is written; the outputs are err and alive per lane.
//
// The SDE variant (the SR evaluator with process noise) passes kick rows
// (T, B, substeps * d), the Euler-Maruyama increments of integrate_sde drawn
// up front (models/evaluators/noise.py): substep s of interval t adds
// kicks[t, b, s*d + q] to the update of component q before the liveness
// test, as the TPU kernel adds its streamed kick rows. Without kick rows
// (a null pointer) the lane computes exactly what it did before.
//
// What bounds it on this card: the latency of each tree row's dependent
// chain (the row's shared-memory load, its stack slot's load, the operator,
// the select), then instruction issue. Each lane evaluates m trees of up to
// N rows at every RK stage of every step (4 x 49 x 2 tree evaluations per
// lane on the main path) and reads only a few KB: the trees once per block
// and its own ground-truth row. Bytes are negligible.
//
// Design: one thread per lane. Lanes are candidate-major, so the B
// trajectories of one candidate are B neighbouring threads that run the
// same tree program on different states. A block holds `cpb` candidates.
// Their trees are decoded once, when the block stages them into shared
// memory, into programs of 8-byte rows (decode_tree): the row's kind, its
// device op id or variable folded into one word beside its constant, and the
// first live row of each tree recorded, so the per-row loop makes no global
// load and never re-scans the padding. In the root-last layout a binary
// row's first operand is the top of the stack and its second the entry
// below; postorder fixes the stack depth at every row, so the decode also
// assigns each row its stack slot. The top of the stack lives in a register
// (the accumulator): a leaf stores the old top to its slot and becomes the
// top, a binary row reads its second operand from its slot, so a row makes
// at most one stack access, whose address does not wait for the data. A
// well-formed tree of n rows holds at most (n + 1) / 2 values, so the
// instance for N rows keeps N / 2 slots a tree besides the register, in
// local memory (16 floats a tree at N <= 32, 128 at N <= 256). The d trees
// of a candidate run row by row in one loop, d independent chains for the
// card to overlap, and every row runs the same branch-free instructions
// whatever its kind, so the two candidates of a warp (B = 16) do not take
// their rows' branches one after the other. State, RK stages and the stage
// sums live in registers (the state dim is a template parameter). The TPU
// kernel's size sort and lane layout existed for Mosaic's `pl.when` row
// skip; here the loop starts at the candidate's first live row. The
// variants measured with kernel_ab are in PERF.md (section 6).
//
// Numerics copy the JAX integrator (multitreegp_tpu/models/integrators.py):
// stage inputs x + (0.5*dt)*k, final x + (dt/6)*(((k1 + 2k2) + 2k3) + k4),
// dt = (ts[t+1] - ts[t]) / substeps per interval from the float32 grid; each
// tree row applies the operator of tree_eval.cuh to the same operands. Built
// with -fmad=false and IEEE division, so x/0 -> inf kills the lane as in JAX.
//
// The per-lane code (here and in sr_lane.cuh) is plain C++ under MTGP_HD, so
// the same file also compiles for the host (without __CUDACC__) into a lane
// loop that decodes every candidate as a block does and that tests run
// against the plain version on machines without a card.
#include "sr_lane.cuh"

namespace {

enum Method { kEuler = 0, kHeun = 1, kRk4 = 2 };

// One decoded tree row: `meta` holds the kind (bits 0-1), the variable or
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
// follows eval_tree's pops and pushes, so a row reads and writes the values
// eval_tree would. A malformed tree deeper than the instance's slots (never
// made by the system) is clamped into them and evaluates to an unspecified
// value.
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

// One decoded row of a tree whose value so far is `acc` (eval_tree's missing
// operand and empty tree read 0), its stack slots at `stk`, on the data
// vector x; U = false compiles the unary rows out (tree_eval.cuh). A row's
// work is the same instructions whatever its kind (the leaf value, the
// second operand and +, -, * are all formed, one is kept): the two
// candidates of a warp run different trees, and their rows would otherwise
// take different branches one after the other. Division and the unary
// operators, whose code is long, keep a branch.
template <int V, bool U>
MTGP_HD inline void row_step(const Row w, const float (&x)[V], float& acc, float* stk) {
  const int arg = (w.meta >> 2) & 63;
  const bool op_row = w.meta & 2;
  const bool flag = w.meta & kFlag;
  float* slot = stk + (w.meta >> 16);
  const float b = flag ? *slot : 0.0f;
  float r = arg == kAdd ? acc + b : arg == kSub ? acc - b : acc * b;
  if (op_row && arg == kDiv) r = acc / b;
  if (U && (w.meta & 3) == kUnary) r = apply_unary(arg, acc);
  const float v = (w.meta & 1) ? leaf_value<V>(arg, x) : w.c;
  if (!op_row && flag) *slot = acc;
  acc = op_row ? r : v;
}

// k = trees(x): the candidate's D trees row by row in one loop from the
// first live row of any of them (padding rows are constant-0 leaves, so a
// tree's value stays 0 until its first live row), D independent chains.
template <int D, bool U>
MTGP_HD inline void drift(const Row* prog, int first, int n, const float (&x)[D],
                          float (&k)[D], float* stk, int tree_stride) {
  float acc[D];
#pragma unroll
  for (int q = 0; q < D; ++q) acc[q] = 0.0f;
  for (int i = first; i < n; ++i) {
#pragma unroll
    for (int q = 0; q < D; ++q) row_step<D, U>(prog[q * n + i], x, acc[q], stk + q * tree_stride);
  }
#pragma unroll
  for (int q = 0; q < D; ++q) k[q] = acc[q];
}

// One lane: trajectory b of a candidate whose d decoded trees are `prog`
// (the first live row of any is `first`), tree q's stack slots at
// stk + q * tree_stride.
template <int D, bool U>
MTGP_HD void fitness_lane(const Row* prog, int first, float* stk, int tree_stride,
                          const float* __restrict__ x0s, const float* __restrict__ ts,
                          const float* __restrict__ ys, const float* __restrict__ kicks, int n,
                          int b, int B, int T, int method, int substeps, float* err,
                          uint8_t* alive_out) {
  float x[D];
#pragma unroll
  for (int q = 0; q < D; ++q) x[q] = x0s[b * D + q];
  bool alive = finite_state<D>(x);
  const float* y = ys + static_cast<size_t>(b) * T * D;
  float e_sum = sq_err<D>(x, y);

  for (int t = 0; t + 1 < T; ++t) {
    if (alive) {
      const float h = (ts[t + 1] - ts[t]) / static_cast<float>(substeps);
      for (int s = 0; s < substeps && alive; ++s) {
        float k1[D], xn[D];
        drift<D, U>(prog, first, n, x, k1, stk, tree_stride);
        if (method == kEuler) {
#pragma unroll
          for (int q = 0; q < D; ++q) xn[q] = x[q] + h * k1[q];
        } else if (method == kHeun) {
          float xs[D], k2[D];
#pragma unroll
          for (int q = 0; q < D; ++q) xs[q] = x[q] + h * k1[q];
          drift<D, U>(prog, first, n, xs, k2, stk, tree_stride);
          const float hh = 0.5f * h;
#pragma unroll
          for (int q = 0; q < D; ++q) xn[q] = x[q] + hh * (k1[q] + k2[q]);
        } else {
          float xs[D], k2[D], k3[D], k4[D];
          const float hh = 0.5f * h;
#pragma unroll
          for (int q = 0; q < D; ++q) xs[q] = x[q] + hh * k1[q];
          drift<D, U>(prog, first, n, xs, k2, stk, tree_stride);
#pragma unroll
          for (int q = 0; q < D; ++q) xs[q] = x[q] + hh * k2[q];
          drift<D, U>(prog, first, n, xs, k3, stk, tree_stride);
#pragma unroll
          for (int q = 0; q < D; ++q) xs[q] = x[q] + h * k3[q];
          drift<D, U>(prog, first, n, xs, k4, stk, tree_stride);
          const float h6 = h / 6.0f;
#pragma unroll
          for (int q = 0; q < D; ++q)
            xn[q] = x[q] + h6 * (((k1[q] + 2.0f * k2[q]) + 2.0f * k3[q]) + k4[q]);
        }
        if (kicks != nullptr) {
          const float* kick = kicks + ((static_cast<size_t>(t) * B + b) * substeps + s) * D;
#pragma unroll
          for (int q = 0; q < D; ++q) xn[q] = xn[q] + kick[q];
        }
        alive = finite_state<D>(xn);
        if (alive) {
#pragma unroll
          for (int q = 0; q < D; ++q) x[q] = xn[q];
        }
      }
    }
    e_sum = e_sum + sq_err<D>(x, y + (t + 1) * D);
  }
  *err = e_sum;
  *alive_out = alive ? 1 : 0;
}

#ifdef __CUDACC__
// Shared memory of a block of `cpb` candidates: the decoded rows and the
// first live rows.
template <int D>
size_t fitness_smem(int cpb, int n) {
  return static_cast<size_t>(cpb) * D * (n * sizeof(Row) + sizeof(int));
}

template <int D, bool U, int N>
__global__ void sr_fitness_kernel(const int* __restrict__ ops, const float* __restrict__ cst,
                                  const int* __restrict__ devop, const float* __restrict__ x0s,
                                  const float* __restrict__ ts, const float* __restrict__ ys,
                                  const float* __restrict__ kicks,
                                  float* __restrict__ err, uint8_t* __restrict__ alive_out,
                                  int P, int n, int B, int T, int var_start, int method,
                                  int substeps, int cpb) {
  extern __shared__ unsigned char smem[];
  Row* s_prog = reinterpret_cast<Row*>(smem);  // cpb * D trees of n rows
  int* s_start = reinterpret_cast<int*>(s_prog + static_cast<size_t>(cpb) * D * n);
  const int c0 = blockIdx.x * cpb;
  const int ncand = min(cpb, P - c0);
  const int words = D * n;
  const size_t base = static_cast<size_t>(c0) * words;
  for (int i = threadIdx.x; i < ncand * words; i += blockDim.x) {
    s_prog[i].meta = ops[base + i];
    s_prog[i].c = cst[base + i];
  }
  __syncthreads();
  for (int t = threadIdx.x; t < ncand * D; t += blockDim.x)
    s_start[t] = decode_tree<N>(s_prog + t * n, n, devop, var_start);
  __syncthreads();
  const int lc = threadIdx.x / B;
  if (lc >= ncand) return;
  const int b = threadIdx.x - lc * B;
  const size_t lane = static_cast<size_t>(c0 + lc) * B + b;
  float stack[D * stack_slots<N>()];  // tree q's slots at q * stack_slots<N>()
  int first = n;
#pragma unroll
  for (int q = 0; q < D; ++q) first = min(first, s_start[lc * D + q]);
  fitness_lane<D, U>(s_prog + lc * words, first, stack, stack_slots<N>(), x0s, ts, ys, kicks, n,
                     b, B, T, method, substeps, err + lane, alive_out + lane);
}

template <int D, bool U, int N>
cudaError_t launch(const int* ops, const float* cst, const int* devop, const float* x0s,
                   const float* ts, const float* ys, const float* kicks, float* err,
                   uint8_t* alive, int P, int n, int B, int T, int var_start, int method,
                   int substeps, int cpb, cudaStream_t stream) {
  const int grid = (P + cpb - 1) / cpb;
  const size_t smem = fitness_smem<D>(cpb, n);
  if (smem > 48 * 1024) {
    const cudaError_t e = cudaFuncSetAttribute(
        sr_fitness_kernel<D, U, N>, cudaFuncAttributeMaxDynamicSharedMemorySize,
        static_cast<int>(smem));
    if (e != cudaSuccess) return e;
  }
  sr_fitness_kernel<D, U, N><<<grid, cpb * B, smem, stream>>>(
      ops, cst, devop, x0s, ts, ys, kicks, err, alive, P, n, B, T, var_start, method, substeps,
      cpb);
  return cudaGetLastError();
}
#else
template <int D, bool U, int N>
void launch(const int* ops, const float* cst, const int* devop, const float* x0s,
            const float* ts, const float* ys, const float* kicks, float* err, uint8_t* alive,
            int P, int n, int B, int T, int var_start, int method, int substeps) {
  Row prog[D * N];
  float stk[D * stack_slots<N>()];
  for (int p = 0; p < P; ++p) {
    const size_t tree = static_cast<size_t>(p) * D * n;
    for (int i = 0; i < D * n; ++i) prog[i] = Row{ops[tree + i], cst[tree + i]};
    int first = n;
    for (int q = 0; q < D; ++q) {
      const int start = decode_tree<N>(prog + q * n, n, devop, var_start);
      first = start < first ? start : first;
    }
    for (int b = 0; b < B; ++b) {
      const size_t lane = static_cast<size_t>(p) * B + b;
      fitness_lane<D, U>(prog, first, stk, stack_slots<N>(), x0s, ts, ys, kicks, n, b, B, T,
                         method, substeps, err + lane, alive + lane);
    }
  }
}
#endif

bool bad_args(int P, int n, int B, int T, int method, int substeps) {
  return P <= 0 || n <= 0 || n > kMaxNodes || B <= 0 || T <= 0 || substeps <= 0 ||
         method < kEuler || method > kRk4;
}

}  // namespace

#define MTGP_FITNESS_ARGS                                                                     \
  const int *ops, const float *cst, const int *devop, const float *x0s, const float *ts,     \
      const float *ys, const float *kicks, float *err, uint8_t *alive, int P, int d, int n,   \
      int B, int T, int var_start, int unary, int method, int substeps
#define MTGP_FITNESS_INPUTS \
  ops, cst, devop, x0s, ts, ys, kicks, err, alive, P, n, B, T, var_start, method, substeps

extern "C" {

// ops/cst (P, d, n) with d trees per candidate; x0s (B, d); ts (T,);
// ys (B, T, d); kicks (T, B, substeps * d) or null; err/alive (P, B); unary:
// the function set has unary operators.
#ifdef __CUDACC__
const char* mtgp_error_string(int status) {
  return cudaGetErrorString(static_cast<cudaError_t>(status));
}

// Launches on `stream`; returns cudaGetLastError() of the launch.
int sr_fitness_launch(MTGP_FITNESS_ARGS, int cpb, void* stream) {
  if (bad_args(P, n, B, T, method, substeps) || cpb <= 0 || cpb * B > 1024)
    return static_cast<int>(cudaErrorInvalidValue);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
#define MTGP_CALL(D)                                                              \
  (n <= 32 ? (unary ? launch<D, true, 32>(MTGP_FITNESS_INPUTS, cpb, s)            \
                    : launch<D, false, 32>(MTGP_FITNESS_INPUTS, cpb, s))          \
           : (unary ? launch<D, true, kMaxNodes>(MTGP_FITNESS_INPUTS, cpb, s)     \
                    : launch<D, false, kMaxNodes>(MTGP_FITNESS_INPUTS, cpb, s)))
  switch (d) {
    case 1: return MTGP_CALL(1);
    case 2: return MTGP_CALL(2);
    case 3: return MTGP_CALL(3);
    case 4: return MTGP_CALL(4);
    default: return static_cast<int>(cudaErrorInvalidValue);
  }
#undef MTGP_CALL
}
#else
// host build of the same per-lane code (tests without a card)
int sr_fitness_host(MTGP_FITNESS_ARGS) {
  if (bad_args(P, n, B, T, method, substeps)) return 1;
#define MTGP_CALL(D)                                                                   \
  (n <= 32 ? (unary ? launch<D, true, 32>(MTGP_FITNESS_INPUTS)                         \
                    : launch<D, false, 32>(MTGP_FITNESS_INPUTS))                       \
           : (unary ? launch<D, true, kMaxNodes>(MTGP_FITNESS_INPUTS)                  \
                    : launch<D, false, kMaxNodes>(MTGP_FITNESS_INPUTS)),               \
   0)
  switch (d) {
    case 1: return MTGP_CALL(1);
    case 2: return MTGP_CALL(2);
    case 3: return MTGP_CALL(3);
    case 4: return MTGP_CALL(4);
    default: return 1;
  }
#undef MTGP_CALL
}
#endif

}  // extern "C"
