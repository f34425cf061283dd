// Fixed-step SR rollout that writes the trajectory.
//
// Replaces the TPU kernel `_make_rollout_kernel` of
// multitreegp_tpu/core/pallas_rollout.py (reached through `rollout_sr_pallas`
// -> `_rollout_impl` -> `pl.pallas_call`). Per lane (candidate x trajectory)
// it integrates dx = trees(x) with euler, heun or rk4, `substeps` steps of
// one size h = (ts[1] - ts[0]) / substeps over the whole grid (not the
// per-interval step of the fitness kernel, sr_fitness.cu), freezes a lane
// whose state turns non-finite or reaches |x| >= 1e8, and writes the state at
// every save point, xs (T, P, B, d), and the final liveness per lane.
//
// What bounds it on this card: as in sr_fitness.cu, the latency of each tree
// row's dependent chain, then instruction issue. Each lane evaluates its D
// trees at every RK stage of every step; the only sizeable traffic is the
// trajectory, T * D floats a lane (26 MB for a population of 4096 x 16 lanes
// at T = 50, d = 2), written once.
//
// Design: the decoded-program machine of tree_prog.cuh, as in sr_fitness.cu
// (#1). One thread per lane, candidate-major; a block holds `cpb` candidates
// x at most 128 of their trajectories (a candidate with more spans several
// blocks, gridDim.y), so no block exceeds 128 threads whatever the
// instance's registers. The block decodes its candidates' trees once, when
// it stages them into shared memory: 8-byte rows with the device op id or
// data slot folded in, the first live row of each tree, a static stack slot
// per row. The candidate's D trees run row by row in one loop (D independent
// chains, each row branch-free), the top of each stack in a register and
// N / 2 slots a tree in local memory (16 floats at N <= 32, 128 at
// N <= 256). State, RK stages and the stage sums live in registers.
// Neighbouring threads hold neighbouring lanes, so a warp writes one
// contiguous run of each save row. The stores are plain: streaming stores
// (`__stcs`) ran in the same time (PERF.md, section 6). The TPU kernel's
// (8, 128) tiles and double-buffered DMA of the save rows are not carried
// over.
//
// Numerics: the TPU kernel's stage table (`_RK_TABLES`): acc = 0 + w1*k1 +
// w2*k2 + ..., stage inputs x + (h*c)*k, the update x + (h*final_scale)*acc,
// with the scalars h*c and h*final_scale formed in double on the host and
// rounded once to float32 (the wrapper passes them); each tree row applies
// the operator of tree_eval.cuh to the operands of the postorder stack
// machine. Built with -fmad=false.
//
// The wide-state instance (built with -DMTGP_WIDE_STATE, the `_wide`
// libraries, and only there) takes any state dim and any number of
// trajectories: state, stage input, stage and stage sum are lane vectors of
// d floats in a scratch buffer the wrapper allocates, the trees run four at
// a time (tree_prog_wide.cuh); the same expressions, so at d <= 4 it is
// bit-equal to the fixed instance.
//
// The per-lane code is plain C++ under MTGP_HD, so the same file also
// compiles for the host (without __CUDACC__) into a lane loop that decodes
// every candidate as a block does and that tests run against the plain
// version on machines without a card.
#include "sr_lane.cuh"
#include "tree_prog.cuh"
#ifdef MTGP_WIDE_STATE
#include "tree_prog_wide.cuh"
#endif

namespace {

enum Method { kEuler = 0, kHeun = 1, kRk4 = 2 };

// h*0.5, h*1.0 (stage inputs) and h*final_scale (the update), in float32
struct StepScalars {
  float half, full, final_scale;
};

// One lane: a trajectory of the candidate whose D decoded trees are `prog`
// (the first live row of any is `first`), tree q's stack slots at
// stk + q * tree_stride; its states at xs + t * row_stride.
template <int D, bool U>
MTGP_HD void rollout_lane(const Row* prog, int first, float* stk, int tree_stride,
                          const float* __restrict__ x0, int n, int T, int method, int substeps,
                          StepScalars h, float* xs, size_t row_stride, uint8_t* alive_out) {
  float x[D];
#pragma unroll
  for (int q = 0; q < D; ++q) x[q] = x0[q];
  bool alive = finite_state<D>(x);
#pragma unroll
  for (int q = 0; q < D; ++q) xs[q] = x[q];
  for (int t = 1; t < T; ++t) {
    for (int s = 0; s < substeps && alive; ++s) {
      float k[D], xst[D], acc[D], xn[D];
      run_trees<D, D, U>(prog, first, n, x, k, stk, tree_stride);
#pragma unroll
      for (int q = 0; q < D; ++q) acc[q] = 0.0f + 1.0f * k[q];
      if (method == kHeun) {
#pragma unroll
        for (int q = 0; q < D; ++q) xst[q] = x[q] + h.full * k[q];
        run_trees<D, D, U>(prog, first, n, xst, k, stk, tree_stride);
#pragma unroll
        for (int q = 0; q < D; ++q) acc[q] = acc[q] + 1.0f * k[q];
      } else if (method == kRk4) {
        const float c[3] = {h.half, h.half, h.full};
        const float w[3] = {2.0f, 2.0f, 1.0f};
#pragma unroll
        for (int st = 0; st < 3; ++st) {
#pragma unroll
          for (int q = 0; q < D; ++q) xst[q] = x[q] + c[st] * k[q];
          run_trees<D, D, U>(prog, first, n, xst, k, stk, tree_stride);
#pragma unroll
          for (int q = 0; q < D; ++q) acc[q] = acc[q] + w[st] * k[q];
        }
      }
#pragma unroll
      for (int q = 0; q < D; ++q) xn[q] = x[q] + h.final_scale * acc[q];
      alive = finite_state<D>(xn);
      if (alive) {
#pragma unroll
        for (int q = 0; q < D; ++q) x[q] = xn[q];
      }
    }
    float* row = xs + t * row_stride;
#pragma unroll
    for (int q = 0; q < D; ++q) row[q] = x[q];
  }
  *alive_out = alive ? 1 : 0;
}

struct Operands {
  const int* ops;
  const float* cst;
  const int* devop;
  const float* x0s;
  float* xs;
  uint8_t* alive;
  int P, n, B, T, var_start, method, substeps;
  StepScalars h;
};

#ifdef __CUDACC__
// The most trajectories of one candidate a block holds (the wrapper's
// THREADS_PER_BLOCK, core/cuda_rollout.py).
constexpr int kBlockLanes = 128;

// A block: `cpb` candidates x `bpb` of their trajectories (blockIdx.y picks
// which), one thread per lane, candidate-major; the block's candidates'
// trees decoded in shared memory.
template <int D, bool U, int N>
__global__ void sr_rollout_kernel(Operands a, int cpb, int bpb) {
  extern __shared__ unsigned char smem[];
  Row* s_prog = reinterpret_cast<Row*>(smem);  // cpb * D trees of n rows
  int* s_start = reinterpret_cast<int*>(s_prog + static_cast<size_t>(cpb) * D * a.n);
  const int ncand =
      stage_programs<N>(a.ops, a.cst, a.devop, a.var_start, a.P, D, a.n, cpb, s_prog, s_start);
  const int lc = threadIdx.x / bpb;
  const int b = blockIdx.y * bpb + threadIdx.x - lc * bpb;
  if (lc >= ncand || b >= a.B) return;
  float stk[D * stack_slots<N>()];  // tree q's slots at q * stack_slots<N>()
  int first = a.n;
#pragma unroll
  for (int q = 0; q < D; ++q) first = min(first, s_start[lc * D + q]);
  const size_t lane = static_cast<size_t>(blockIdx.x * cpb + lc) * a.B + b;
  rollout_lane<D, U>(s_prog + static_cast<size_t>(lc) * D * a.n, first, stk, stack_slots<N>(),
                     a.x0s + b * D, a.n, a.T, a.method, a.substeps, a.h, a.xs + lane * D,
                     static_cast<size_t>(a.P) * a.B * D, a.alive + lane);
}

template <int D, bool U, int N>
cudaError_t launch(const Operands& a, int cpb, cudaStream_t stream) {
  const int bpb = a.B < kBlockLanes ? a.B : kBlockLanes;
  if (cpb * bpb > 1024) return cudaErrorInvalidValue;
  const dim3 grid((a.P + cpb - 1) / cpb, (a.B + bpb - 1) / bpb);
  const size_t smem = program_smem(cpb, D, a.n);
  if (smem > 48 * 1024) {  // the wrapper sizes cpb by the rows alone
    const cudaError_t e = cudaFuncSetAttribute(
        sr_rollout_kernel<D, U, N>, cudaFuncAttributeMaxDynamicSharedMemorySize,
        static_cast<int>(smem));
    if (e != cudaSuccess) return e;
  }
  sr_rollout_kernel<D, U, N><<<grid, cpb * bpb, smem, stream>>>(a, cpb, bpb);
  return cudaGetLastError();
}
#else
template <int D, bool U, int N>
void launch(const Operands& a) {
  Row prog[D * N];
  float stk[D * stack_slots<N>()];
  for (int p = 0; p < a.P; ++p) {
    const size_t tree = static_cast<size_t>(p) * D * a.n;
    for (int i = 0; i < D * a.n; ++i) prog[i] = Row{a.ops[tree + i], a.cst[tree + i]};
    int first = a.n;
    for (int q = 0; q < D; ++q) {
      const int start = decode_tree<N>(prog + q * a.n, a.n, a.devop, a.var_start);
      first = start < first ? start : first;
    }
    for (int b = 0; b < a.B; ++b) {
      const size_t lane = static_cast<size_t>(p) * a.B + b;
      rollout_lane<D, U>(prog, first, stk, stack_slots<N>(), a.x0s + b * D, a.n, a.T, a.method,
                         a.substeps, a.h, a.xs + lane * D, static_cast<size_t>(a.P) * a.B * D,
                         a.alive + lane);
    }
  }
}
#endif

bool bad_args(const Operands& a) {
  return a.P <= 0 || a.n <= 0 || a.n > kMaxNodes || a.B <= 0 || a.T <= 0 || a.substeps <= 0 ||
         a.method < kEuler || a.method > kRk4;
}

#ifdef MTGP_WIDE_STATE
// rollout_lane on the wide instance: trajectory b of candidate c, whose d
// trees are f, its vectors x (the state), st (the stage input; the next
// state once formed), k (the stage) and acc (the stage sum); its states at
// a.xs + t * P * B * d + (c * B + b) * d.
template <bool U>
MTGP_HD void rollout_lane_wide(const WideTrees<U>& f, const Operands& a, int c, int b, LaneVec x,
                               LaneVec st, const LaneVec& k, const LaneVec& acc) {
  const int d = f.d;
  const float* x0 = a.x0s + static_cast<size_t>(b) * d;
  for (int q = 0; q < d; ++q) x[q] = x0[q];
  bool alive = finite_vec(x, d);
  const size_t lane = static_cast<size_t>(c) * a.B + b;
  float* xs = a.xs + lane * d;
  const size_t row_stride = static_cast<size_t>(a.P) * a.B * d;
  for (int q = 0; q < d; ++q) xs[q] = x[q];
  for (int t = 1; t < a.T; ++t) {
    for (int s = 0; s < a.substeps && alive; ++s) {
      f(x, k);
      for (int q = 0; q < d; ++q) acc[q] = 0.0f + 1.0f * k[q];
      if (a.method == kHeun) {
        for (int q = 0; q < d; ++q) st[q] = x[q] + a.h.full * k[q];
        f(st, k);
        for (int q = 0; q < d; ++q) acc[q] = acc[q] + 1.0f * k[q];
      } else if (a.method == kRk4) {
        const float cs[3] = {a.h.half, a.h.half, a.h.full};
        const float w[3] = {2.0f, 2.0f, 1.0f};
        for (int stage = 0; stage < 3; ++stage) {
          for (int q = 0; q < d; ++q) st[q] = x[q] + cs[stage] * k[q];
          f(st, k);
          for (int q = 0; q < d; ++q) acc[q] = acc[q] + w[stage] * k[q];
        }
      }
      for (int q = 0; q < d; ++q) st[q] = x[q] + a.h.final_scale * acc[q];
      alive = finite_vec(st, d);
      if (alive) {  // the next state becomes the state
        const LaneVec old = x;
        x = st;
        st = old;
      }
    }
    float* row = xs + t * row_stride;
    for (int q = 0; q < d; ++q) row[q] = x[q];
  }
  a.alive[lane] = alive ? 1 : 0;
}

constexpr int kRolloutVectors = 4;  // x, st, k, acc: the wrapper's scratch per lane and component

template <bool U>
MTGP_HD void run_rollout_lane(const WideSpan& s, const Operands& a, const WideTrees<U>& f, int c,
                              int b, size_t li) {
  rollout_lane_wide<U>(f, a, c, b, lane_vec(s, 0, li), lane_vec(s, 1, li), lane_vec(s, 2, li),
                       lane_vec(s, 3, li));
}

#ifdef __CUDACC__
template <bool U, int N>
__global__ void sr_rollout_wide_kernel(WideSpan s, Operands a, int cpb, int bpb) {
  wide_block<U, N>(s, cpb, bpb, [&](const WideTrees<U>& f, int c, int b, size_t li) {
    run_rollout_lane<U>(s, a, f, c, b, li);
  });
}
#endif
#endif  // MTGP_WIDE_STATE

}  // namespace

#define MTGP_ROLLOUT_ARGS                                                                   \
  const int *ops, const float *cst, const int *devop, const float *x0s, float *xs,        \
      uint8_t *alive, int P, int d, int n, int B, int T, int var_start, int unary,         \
      int method, int substeps, float h_half, float h_full, float h_final
#define MTGP_OPERANDS                                                                     \
  const Operands a{ops, cst, devop, x0s, xs, alive, P, n, B, T, var_start, method, substeps, \
                   StepScalars{h_half, h_full, h_final}}

// One instance per state dim D, unary operators or none, and tree bound N
// (32, or kMaxNodes = 256).
#define MTGP_BY_NODES(CALL, D)                                                   \
  (n <= 32 ? (unary ? CALL(D, true, 32) : CALL(D, false, 32))                    \
           : (unary ? CALL(D, true, kMaxNodes) : CALL(D, false, kMaxNodes)))
#define MTGP_ROLLOUT_SWITCH(CALL)                \
  switch (d) {                                   \
    case 1: return MTGP_BY_NODES(CALL, 1);       \
    case 2: return MTGP_BY_NODES(CALL, 2);       \
    case 3: return MTGP_BY_NODES(CALL, 3);       \
    case 4: return MTGP_BY_NODES(CALL, 4);       \
    default: break;                              \
  }

extern "C" {

// ops/cst (P, d, n) with d trees per candidate; x0s (B, d); xs (T, P, B, d);
// alive (P, B), the final liveness; unary: the function set has unary
// operators.
#ifdef __CUDACC__
const char* mtgp_error_string(int status) {
  return cudaGetErrorString(static_cast<cudaError_t>(status));
}
#endif

#ifdef MTGP_WIDE_STATE
// The wide instance on candidates c0 .. c0 + count - 1, its scratch
// kRolloutVectors * d * count * B floats (tree_prog_wide.cuh WideSpan).
#define MTGP_WIDE_OPERANDS                                                      \
  MTGP_OPERANDS;                                                                \
  const WideSpan span{ops, cst, devop, var_start, d, n, B, c0, count, scratch}; \
  const bool bad = bad_args(a) || bad_span(span) || c0 + count > P

#ifdef __CUDACC__
// Launches on `stream` with `cpb` candidates per block; returns
// cudaGetLastError() of the launch.
int sr_rollout_wide_launch(MTGP_ROLLOUT_ARGS, float* scratch, int c0, int count, int cpb,
                           void* stream) {
  MTGP_WIDE_OPERANDS;
  if (bad) return static_cast<int>(cudaErrorInvalidValue);
  cudaStream_t st = static_cast<cudaStream_t>(stream);
#define MTGP_CALL(U, N) static_cast<int>(launch_wide(&sr_rollout_wide_kernel<U, N>, span, a, cpb, st))
  return MTGP_WIDE_INSTANCE(MTGP_CALL, n, unary);
#undef MTGP_CALL
}
#else
int sr_rollout_wide_host(MTGP_ROLLOUT_ARGS, float* scratch, int c0, int count) {
  MTGP_WIDE_OPERANDS;
  if (bad) return 1;
#define MTGP_CALL(U, N)                                                                       \
  (wide_host<U, N>(span, [&](const WideTrees<U>& f, int c, int b, size_t li) {                \
     run_rollout_lane<U>(span, a, f, c, b, li);                                               \
   }),                                                                                        \
   0)
  return MTGP_WIDE_INSTANCE(MTGP_CALL, n, unary);
#undef MTGP_CALL
}
#endif
#else  // the fixed instances
#ifdef __CUDACC__
// Launches on `stream` with `cpb` candidates per block; returns
// cudaGetLastError() of the launch.
int sr_rollout_launch(MTGP_ROLLOUT_ARGS, int cpb, void* stream) {
  MTGP_OPERANDS;
  if (bad_args(a) || cpb <= 0) return static_cast<int>(cudaErrorInvalidValue);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
#define MTGP_CALL(D, U, N) static_cast<int>(launch<D, U, N>(a, cpb, s))
  MTGP_ROLLOUT_SWITCH(MTGP_CALL)
#undef MTGP_CALL
  return static_cast<int>(cudaErrorInvalidValue);
}
#else
// host build of the same per-lane code (tests without a card)
int sr_rollout_host(MTGP_ROLLOUT_ARGS) {
  MTGP_OPERANDS;
  if (bad_args(a)) return 1;
#define MTGP_CALL(D, U, N) (launch<D, U, N>(a), 0)
  MTGP_ROLLOUT_SWITCH(MTGP_CALL)
#undef MTGP_CALL
  return 1;
}
#endif
#endif  // MTGP_WIDE_STATE

}  // extern "C"
