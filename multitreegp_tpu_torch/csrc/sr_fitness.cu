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
// memory, into the programs of tree_prog.cuh: 8-byte rows with the device
// op id folded in, the first live row of each tree, a static stack slot per
// row, the top of the stack in a register and the rest in local memory (16
// floats a tree at N <= 32, 128 at N <= 256). The d trees of a candidate run
// row by row in one loop, d independent chains for the card to overlap, and
// every row is branch-free, so the two candidates of a warp (B = 16) do not
// take their rows' branches one after the other. State, RK stages and the
// stage sums live in registers (the state dim is a template parameter). The
// TPU kernel's size sort and lane layout existed for Mosaic's `pl.when` row
// skip; here the loop starts at the candidate's first live row. The
// variants measured with kernel_ab are in PERF.md (section 6).
//
// Numerics copy the JAX integrator (multitreegp_tpu/models/integrators.py):
// stage inputs x + (0.5*dt)*k, final x + (dt/6)*(((k1 + 2k2) + 2k3) + k4),
// dt = (ts[t+1] - ts[t]) / substeps per interval from the float32 grid; each
// tree row applies the operator of tree_eval.cuh to the same operands. Built
// with -fmad=false and IEEE division, so x/0 -> inf kills the lane as in JAX.
//
// The wide-state instance (built with -DMTGP_WIDE_STATE, the `_wide`
// libraries of _build.py, and only there): any state dim d and any number of
// trajectories, for what the fixed instances (d <= 4, B <= 1024, 63
// variables) do not take. State, stage input, stage and stage sum are lane
// vectors of d floats in a scratch buffer the wrapper allocates; the d trees
// run in groups of four; a block holds at most 128 trajectories of a
// candidate (tree_prog_wide.cuh). The stage sums are the same expressions in
// the same order, accumulated stage by stage, so a wide lane is bit-equal to
// the fixed one at d <= 4.
//
// The per-lane code (here, in sr_lane.cuh and in tree_prog.cuh) is plain C++
// under MTGP_HD, so the same file also compiles for the host (without
// __CUDACC__) into a lane loop that decodes every candidate as a block does
// and that tests run against the plain version on machines without a card.
#include "sr_lane.cuh"
#include "tree_prog.cuh"
#ifdef MTGP_WIDE_STATE
#include "tree_prog_wide.cuh"
#endif

namespace {

enum Method { kEuler = 0, kHeun = 1, kRk4 = 2 };

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
        run_trees<D, D, U>(prog, first, n, x, k1, stk, tree_stride);
        if (method == kEuler) {
#pragma unroll
          for (int q = 0; q < D; ++q) xn[q] = x[q] + h * k1[q];
        } else if (method == kHeun) {
          float xs[D], k2[D];
#pragma unroll
          for (int q = 0; q < D; ++q) xs[q] = x[q] + h * k1[q];
          run_trees<D, D, U>(prog, first, n, xs, k2, stk, tree_stride);
          const float hh = 0.5f * h;
#pragma unroll
          for (int q = 0; q < D; ++q) xn[q] = x[q] + hh * (k1[q] + k2[q]);
        } else {
          float xs[D], k2[D], k3[D], k4[D];
          const float hh = 0.5f * h;
#pragma unroll
          for (int q = 0; q < D; ++q) xs[q] = x[q] + hh * k1[q];
          run_trees<D, D, U>(prog, first, n, xs, k2, stk, tree_stride);
#pragma unroll
          for (int q = 0; q < D; ++q) xs[q] = x[q] + hh * k2[q];
          run_trees<D, D, U>(prog, first, n, xs, k3, stk, tree_stride);
#pragma unroll
          for (int q = 0; q < D; ++q) xs[q] = x[q] + h * k3[q];
          run_trees<D, D, U>(prog, first, n, xs, k4, stk, tree_stride);
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
  const int ncand = stage_programs<N>(ops, cst, devop, var_start, P, D, n, cpb, s_prog, s_start);
  const int lc = threadIdx.x / B;
  if (lc >= ncand) return;
  const int b = threadIdx.x - lc * B;
  const size_t lane = static_cast<size_t>(blockIdx.x * cpb + lc) * B + b;
  const int words = D * n;
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
  const size_t smem = program_smem(cpb, D, n);
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

#ifdef MTGP_WIDE_STATE
// What a wide lane reads and writes besides its trees.
struct FitnessIO {
  const float* x0s;    // (B, d)
  const float* ts;     // (T,)
  const float* ys;     // (B, T, d)
  const float* kicks;  // (T, B, substeps * d) or null
  float* err;          // (P, B)
  uint8_t* alive;      // (P, B)
  int T, method, substeps;
};

// fitness_lane on the wide instance: trajectory b of candidate c, whose d
// trees are f, its vectors x (the state), xs (the stage input; the next
// state once formed), k (the stage) and acc (the stage sum: k1, k1 + 2k2,
// ... as the fixed lane's expression adds them).
template <bool U>
MTGP_HD void fitness_lane_wide(const WideTrees<U>& f, const FitnessIO& io, int c, int b, int B,
                               LaneVec x, LaneVec xs, const LaneVec& k, const LaneVec& acc) {
  const int d = f.d;
  const float* x0 = io.x0s + static_cast<size_t>(b) * d;
  for (int q = 0; q < d; ++q) x[q] = x0[q];
  bool alive = finite_vec(x, d);
  const float* y = io.ys + static_cast<size_t>(b) * io.T * d;
  float e_sum = sq_err_vec(x, y, d);

  for (int t = 0; t + 1 < io.T; ++t) {
    if (alive) {
      const float h = (io.ts[t + 1] - io.ts[t]) / static_cast<float>(io.substeps);
      for (int s = 0; s < io.substeps && alive; ++s) {
        f(x, k);  // k1
        if (io.method == kEuler) {
          for (int q = 0; q < d; ++q) xs[q] = x[q] + h * k[q];
        } else if (io.method == kHeun) {
          for (int q = 0; q < d; ++q) {
            acc[q] = k[q];
            xs[q] = x[q] + h * k[q];
          }
          f(xs, k);  // k2
          const float hh = 0.5f * h;
          for (int q = 0; q < d; ++q) xs[q] = x[q] + hh * (acc[q] + k[q]);
        } else {
          const float hh = 0.5f * h;
          for (int q = 0; q < d; ++q) {
            acc[q] = k[q];
            xs[q] = x[q] + hh * k[q];
          }
          f(xs, k);  // k2
          for (int q = 0; q < d; ++q) {
            acc[q] = acc[q] + 2.0f * k[q];
            xs[q] = x[q] + hh * k[q];
          }
          f(xs, k);  // k3
          for (int q = 0; q < d; ++q) {
            acc[q] = acc[q] + 2.0f * k[q];
            xs[q] = x[q] + h * k[q];
          }
          f(xs, k);  // k4
          const float h6 = h / 6.0f;
          for (int q = 0; q < d; ++q) xs[q] = x[q] + h6 * (acc[q] + k[q]);
        }
        if (io.kicks != nullptr) {
          const float* kick =
              io.kicks + ((static_cast<size_t>(t) * B + b) * io.substeps + s) * d;
          for (int q = 0; q < d; ++q) xs[q] = xs[q] + kick[q];
        }
        alive = finite_vec(xs, d);
        if (alive) {  // the next state becomes the state
          const LaneVec old = x;
          x = xs;
          xs = old;
        }
      }
    }
    e_sum = e_sum + sq_err_vec(x, y + static_cast<size_t>(t + 1) * d, d);
  }
  const size_t lane = static_cast<size_t>(c) * B + b;
  io.err[lane] = e_sum;
  io.alive[lane] = alive ? 1 : 0;
}

constexpr int kFitnessVectors = 4;  // x, xs, k, acc: the wrapper's scratch per lane and component

template <bool U>
MTGP_HD void run_fitness_lane(const WideSpan& s, const FitnessIO& io, const WideTrees<U>& f, int c,
                              int b, size_t li) {
  fitness_lane_wide<U>(f, io, c, b, s.B, lane_vec(s, 0, li), lane_vec(s, 1, li),
                       lane_vec(s, 2, li), lane_vec(s, 3, li));
}

#ifdef __CUDACC__
template <bool U, int N>
__global__ void sr_fitness_wide_kernel(WideSpan s, FitnessIO io, int cpb, int bpb) {
  wide_block<U, N>(s, cpb, bpb, [&](const WideTrees<U>& f, int c, int b, size_t li) {
    run_fitness_lane<U>(s, io, f, c, b, li);
  });
}
#endif
#endif  // MTGP_WIDE_STATE

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
#endif

#ifdef MTGP_WIDE_STATE
// The wide instance on candidates c0 .. c0 + count - 1, its scratch
// kFitnessVectors * d * count * B floats (tree_prog_wide.cuh WideSpan).
#define MTGP_WIDE_OPERANDS                                                        \
  const WideSpan span{ops, cst, devop, var_start, d, n, B, c0, count, scratch};   \
  const FitnessIO io{x0s, ts, ys, kicks, err, alive, T, method, substeps};       \
  const bool bad = bad_args(P, n, B, T, method, substeps) || bad_span(span) || c0 + count > P

#ifdef __CUDACC__
// Launches on `stream` with `cpb` candidates per block; returns
// cudaGetLastError() of the launch.
int sr_fitness_wide_launch(MTGP_FITNESS_ARGS, float* scratch, int c0, int count, int cpb,
                           void* stream) {
  MTGP_WIDE_OPERANDS;
  if (bad) return static_cast<int>(cudaErrorInvalidValue);
  cudaStream_t st = static_cast<cudaStream_t>(stream);
#define MTGP_CALL(U, N) static_cast<int>(launch_wide(&sr_fitness_wide_kernel<U, N>, span, io, cpb, st))
  return MTGP_WIDE_INSTANCE(MTGP_CALL, n, unary);
#undef MTGP_CALL
}
#else
int sr_fitness_wide_host(MTGP_FITNESS_ARGS, float* scratch, int c0, int count) {
  MTGP_WIDE_OPERANDS;
  if (bad) return 1;
#define MTGP_CALL(U, N)                                                                       \
  (wide_host<U, N>(span, [&](const WideTrees<U>& f, int c, int b, size_t li) {                \
     run_fitness_lane<U>(span, io, f, c, b, li);                                              \
   }),                                                                                        \
   0)
  return MTGP_WIDE_INSTANCE(MTGP_CALL, n, unary);
#undef MTGP_CALL
}
#endif
#else  // the fixed instances
#ifdef __CUDACC__
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
#endif  // MTGP_WIDE_STATE

}  // extern "C"
