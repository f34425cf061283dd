// Adaptive SR fitness: embedded Runge-Kutta pair + per-lane step control +
// squared error, one thread per lane.
//
// Replaces two TPU kernels of multitreegp_tpu/core/pallas_rollout.py:
//   * `_make_adaptive_global_kernel` (reached through
//     `rollout_sr_fitness_adaptive_global_pallas` -> `pl.pallas_call`): one
//     step budget for the whole solve (diffrax `max_steps`), a per-lane save
//     index, lanes crossing save points out of step: `adaptive_global_kernel`;
//   * `_make_adaptive_fitness_kernel` (`rollout_sr_fitness_adaptive_pallas` /
//     `adaptive_solver_stats` -> `_adaptive_fitness_impl` -> `pl.pallas_call`):
//     the same controller with a step budget per save interval:
//     `adaptive_interval_kernel`.
// Per lane (candidate x trajectory) both integrate dx = trees(x) with
// Bogacki-Shampine 3(2) or Dormand-Prince 5(4), first-same-as-last (the
// accepted step's last stage is the next step's k1), the I controller
// clip(safety * err^e, 0.2, 5) with e = -1/3 (bosh3) or -0.2 (dopri5), the
// integrator's death rules (NaN at the minimum step, steps running out), and
// return the squared-error sum over the save points, liveness and the number
// of attempted steps.
//
// What bounds it on this card: the latency of each tree row's dependent
// chain (the row's shared-memory load, its stack slot, the operator, the
// select), then warp divergence. A lane reads its trees (staged once per
// block in shared memory), its ground-truth rows and the save grid, a few KB;
// it does 3 (bosh3) or 6 (dopri5) evaluations of its D trees per attempted
// step, and the number of attempts is data-dependent (tens to the whole
// budget). A warp holds the B trajectories of 32 / B candidates and runs
// until its slowest lane is done.
//
// Design: one thread per lane, candidate-major (the B lanes of a candidate are
// neighbouring threads running the same tree program). A block decodes its
// candidates' trees once, when it stages them into shared memory, into the
// programs of tree_prog.cuh (the tree machine of #1, #6 and #7): 8-byte rows
// with the device op id or data slot folded in, the first live row of each
// tree, a static stack slot per row; the top of each tree's stack in a
// register, the rest in local memory (N / 2 slots a tree: 16 floats at
// N <= 32, 128 at N <= 256); the candidate's D trees run row by row in one
// loop, D independent chains, every row branch-free. The drift is inlined at
// rk_step's stage call sites: one out-of-line call per stage, as policy.cu's
// adaptive kernel makes, ran #5 and #4 1.4x slower (H100 80GB HBM3, 700 W).
// State, stages, t, dt, the save index and the FSAL k1 live in registers.
// The per-interval lane is one flat loop: an iteration attempts a step of
// the open interval or, once the interval is finished (budget spent, dead,
// or t >= t1 - 1e-12), closes it (the reach test, the squared error at the
// save point, the next interval's clamp of dt), so a warp runs as many
// iterations as its slowest lane's steps and saves, not the sum over
// intervals of each interval's slowest lane. A block holds at most 128 trajectories of a candidate (a
// candidate with more spans several blocks, gridDim.y), so a block never
// exceeds 128 threads whatever the instance's registers. Unlike the TPU
// kernels, which spin for the whole budget with every update predicated
// (Mosaic never skips), a thread stops once its lane is done: a finished or
// dead lane's remaining iterations are no-ops there, so per lane the result
// is the same. The TPU kernels' (8, 128) tiles, `ts_ladder` select ladder,
// resident ys block and ysel ladder, size sort and lane layout, and `go_scr`
// early exit existed because Mosaic cannot index per lane or skip; a thread
// reads `ts[idx]` and `ys[b, idx]` directly. The variants measured with
// kernel_ab are in PERF.md (section 6).
//
// Numerics: the kernels' float32 expressions in their order (the same as the
// plain versions in core/cuda_adaptive.py); the step and the controller are
// adaptive_step.cuh's, shared with the adaptive policy kernel (policy.cu);
// each tree row applies the operator of tree_eval.cuh to the operands of
// its stack machine. Built with -fmad=false and IEEE division and square
// root.
//
// The wide-state instance (built with -DMTGP_WIDE_STATE, the `_wide`
// libraries, and only there) takes any state dim and any number of
// trajectories: the state, x_hi, the stage input and the seven stages are
// lane vectors of d floats in a scratch buffer the wrapper allocates, an
// accepted step swaps x with x_hi and k1 with the last stage, the trees run
// four at a time (tree_prog_wide.cuh), and the step is adaptive_step.cuh's
// run-time-d form (rk_step_n): the same expressions, so at d <= 4 it is
// bit-equal to the fixed instance.
//
// The per-lane code is plain C++ under MTGP_HD, so the same file also
// compiles for the host (without __CUDACC__) into a lane loop that decodes
// every candidate as a block does and that tests run against the plain
// versions on machines without a card.
#include "adaptive_step.cuh"
#include "sr_lane.cuh"
#include "tree_prog.cuh"
#ifdef MTGP_WIDE_STATE
#include "tree_prog_wide.cuh"
#endif

namespace {

// The drift functor of rk_step: k = the candidate's D decoded trees at x, as
// D independent chains of one row loop.
template <int D, bool U>
struct TreeDrift {
  const Row* prog;  // tree q's rows at prog + q * n
  int first;        // the first live row of any of the D trees
  int n;
  float* stk;  // tree q's stack slots at stk + q * stride
  int stride;
  MTGP_HD void operator()(const float (&x)[D], float (&k)[D]) const {
    run_trees<D, D, U>(prog, first, n, x, k, stk, stride);
  }
};

// Everything a lane reads besides its trees.
struct LaneIO {
  const float* x0;  // (D,) initial state
  const float* ts;  // (T,) save grid
  const float* y;   // (T, D) ground truth of this trajectory
  int T;
};

struct Control {
  int method;
  int budget;  // whole-solve budget (global) or steps per interval
  float rtol, atol, safety;
};

// Global budget: one loop over the whole solve; the lane's save index idx
// advances when t crosses ts[idx + 1], where t snaps to that save time, the
// step is clamped to the new interval's span and the squared error at the
// save is added. At the end a lane that has not reached the last save is dead.
template <int D, bool U>
MTGP_HD void adaptive_global_lane(const TreeDrift<D, U>& f, const LaneIO& io, const Control& c,
                                  float* err_out, uint8_t* alive_out, int* steps_out) {
  float x[D], k1[D];
#pragma unroll
  for (int q = 0; q < D; ++q) x[q] = io.x0[q];
  bool alive = finite_state<D>(x);
  float e_sum = sq_err<D>(x, io.y);
  const int last = io.T - 1;
  int idx = 0;
  int steps = 0;
  if (io.T > 1) {
    const float expo = error_exponent(c.method);
    f(x, k1);  // the one up-front evaluation FSAL amortises
    float t = io.ts[0];
    float dt = (io.ts[1] - io.ts[0]) / 4.0f;
    for (int s = 0; s < c.budget && alive && idx < last; ++s) {
      const float t0 = io.ts[idx];
      const float t1 = io.ts[idx + 1];
      const float span = t1 - t0;
      const float dt_c = nan_min(dt, t1 - t);
      float x_hi[D], k_last[D];
      const float err = rk_step<D>(f, c.method, x, k1, dt_c, c.rtol, c.atol, x_hi, k_last);
      const bool ok = finite_state<D>(x_hi) && isfinite(err);
      const bool accept = ok && err <= 1.0f;
      if (accept) {
#pragma unroll
        for (int q = 0; q < D; ++q) {
          x[q] = x_hi[q];
          k1[q] = k_last[q];
        }
      }
      const float t_new = accept ? t + dt_c : t;
      const bool crossed = accept && t_new >= t1 - kCross;
      t = crossed ? t1 : t_new;
      float dt_n = clip(dt_c * step_factor(err, ok, c.safety, expo), span * kDtMin, span);
      const int idx_n = idx + (crossed ? 1 : 0);
      if (crossed && idx_n < last) {  // entry clamp with the new interval's span
        const float n_span = io.ts[idx_n + 1] - t1;
        dt_n = clip(dt_n, n_span * kDtMin, n_span);
      }
      dt = dt_n;
      alive = alive && (ok || dt_c > span * kDtDead);
      ++steps;
      if (crossed) e_sum = e_sum + sq_err<D>(x, io.y + idx_n * D);
      idx = idx_n;
    }
  }
  *err_out = e_sum;
  *alive_out = (alive && idx >= last) ? 1 : 0;
  *steps_out = steps;
}

// Per-interval budget: at most `budget` attempts inside each save interval;
// t restarts at the interval's start, the carried dt is clamped to its span,
// and a lane that has not reached the save point by then is dead. The squared
// error is added at every save point, for dead (frozen) lanes too. One flat
// loop: an iteration attempts a step of the open interval ti while the lane
// has budget, lives and has not crossed t1; otherwise it closes the interval
// and opens the next. The same steps, in the same order, as a loop over
// intervals with a step loop inside each.
template <int D, bool U>
MTGP_HD void adaptive_interval_lane(const TreeDrift<D, U>& f, const LaneIO& io, const Control& c,
                                    float* err_out, uint8_t* alive_out, int* steps_out) {
  float x[D], k1[D];
#pragma unroll
  for (int q = 0; q < D; ++q) x[q] = io.x0[q];
  bool alive = finite_state<D>(x);
  float e_sum = sq_err<D>(x, io.y);
  int steps = 0;
  if (io.T > 1) {
    const float expo = error_exponent(c.method);
    f(x, k1);
    float dt = (io.ts[1] - io.ts[0]) / 4.0f;
    // the open interval [t0, t1) = [ts[ti], ts[ti + 1]), t in it, s its steps so far
    int ti = 0, s = 0;
    float t1 = io.ts[1];
    float span = t1 - io.ts[0];
    float t = io.ts[0];
    dt = clip(dt, span * kDtMin, span);
    while (true) {
      if (s < c.budget && alive && t < t1 - kCross) {
        const float dt_c = nan_min(dt, t1 - t);
        float x_hi[D], k_last[D];
        const float err = rk_step<D>(f, c.method, x, k1, dt_c, c.rtol, c.atol, x_hi, k_last);
        const bool ok = finite_state<D>(x_hi) && isfinite(err);
        if (ok && err <= 1.0f) {
#pragma unroll
          for (int q = 0; q < D; ++q) {
            x[q] = x_hi[q];
            k1[q] = k_last[q];
          }
          t = t + dt_c;
        }
        dt = clip(dt_c * step_factor(err, ok, c.safety, expo), span * kDtMin, span);
        alive = alive && (ok || dt_c > span * kDtDead);
        ++s;
        ++steps;
      } else {
        alive = alive && t >= t1 - kReach * nan_max(fabsf(t1), 1.0f);
        e_sum = e_sum + sq_err<D>(x, io.y + (ti + 1) * D);
        if (++ti + 1 >= io.T) break;
        const float t0 = io.ts[ti];
        t1 = io.ts[ti + 1];
        span = t1 - t0;
        t = t0;
        dt = clip(dt, span * kDtMin, span);
        s = 0;
      }
    }
  }
  *err_out = e_sum;
  *alive_out = alive ? 1 : 0;
  *steps_out = steps;
}

enum Budget { kGlobal = 0, kInterval = 1 };

// Everything a launch reads and writes.
struct Operands {
  const int* ops;      // (P, D, n)
  const float* cst;    // (P, D, n)
  const int* devop;    // (num operators,) device op ids
  const float* x0s;    // (B, D)
  const float* ts;     // (T,)
  const float* ys;     // (B, T, D)
  float* err;          // (P, B)
  uint8_t* alive;      // (P, B)
  int* steps;          // (P, B)
  int P, n, B, T, var_start;
  Control c;
};

// Trajectory b of the candidate whose drift is f, at output index `lane`.
template <int D, bool U>
MTGP_HD void run_lane(int kind, const TreeDrift<D, U>& f, const Operands& a, int b, size_t lane) {
  const LaneIO io{a.x0s + b * D, a.ts, a.ys + static_cast<size_t>(b) * a.T * D, a.T};
  if (kind == kGlobal)
    adaptive_global_lane<D, U>(f, io, a.c, a.err + lane, a.alive + lane, a.steps + lane);
  else
    adaptive_interval_lane<D, U>(f, io, a.c, a.err + lane, a.alive + lane, a.steps + lane);
}

#ifdef __CUDACC__
// The most trajectories of one candidate a block holds (the wrapper's
// THREADS_PER_BLOCK, core/cuda_rollout.py).
constexpr int kBlockLanes = 128;

// A block: `cpb` candidates x `bpb` of their trajectories (blockIdx.y picks
// which), one thread per lane, candidate-major; the block's candidates'
// trees decoded in shared memory.
template <int D, bool U, int N>
__device__ void block_lanes(int kind, const Operands& a, int cpb, int bpb) {
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
  const TreeDrift<D, U> f{s_prog + static_cast<size_t>(lc) * D * a.n, first, a.n, stk,
                          stack_slots<N>()};
  run_lane<D, U>(kind, f, a, b, static_cast<size_t>(blockIdx.x * cpb + lc) * a.B + b);
}

template <int D, bool U, int N>
__global__ void adaptive_global_kernel(Operands a, int cpb, int bpb) {
  block_lanes<D, U, N>(kGlobal, a, cpb, bpb);
}

template <int D, bool U, int N>
__global__ void adaptive_interval_kernel(Operands a, int cpb, int bpb) {
  block_lanes<D, U, N>(kInterval, a, cpb, bpb);
}

template <int D, bool U, int N>
cudaError_t launch(int kind, const Operands& a, int cpb, cudaStream_t stream) {
  const int bpb = a.B < kBlockLanes ? a.B : kBlockLanes;
  if (cpb * bpb > 1024) return cudaErrorInvalidValue;
  const dim3 grid((a.P + cpb - 1) / cpb, (a.B + bpb - 1) / bpb);
  const size_t smem = program_smem(cpb, D, a.n);
  void (*kernel)(Operands, int, int) =
      kind == kGlobal ? &adaptive_global_kernel<D, U, N> : &adaptive_interval_kernel<D, U, N>;
  if (smem > 48 * 1024) {  // the wrapper sizes cpb by the rows alone
    const cudaError_t e = cudaFuncSetAttribute(
        kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, static_cast<int>(smem));
    if (e != cudaSuccess) return e;
  }
  kernel<<<grid, cpb * bpb, smem, stream>>>(a, cpb, bpb);
  return cudaGetLastError();
}
#else
template <int D, bool U, int N>
void launch(int kind, const Operands& a) {
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
    const TreeDrift<D, U> f{prog, first, a.n, stk, stack_slots<N>()};
    for (int b = 0; b < a.B; ++b) run_lane<D, U>(kind, f, a, b, static_cast<size_t>(p) * a.B + b);
  }
}
#endif

bool bad_args(int kind, const Operands& a) {
  return (kind != kGlobal && kind != kInterval) || a.P <= 0 || a.n <= 0 || a.n > kMaxNodes ||
         a.B <= 0 || a.T <= 0 || a.c.budget < 0 ||
         (a.c.method != kBosh3 && a.c.method != kDopri5);
}

#ifdef MTGP_WIDE_STATE
// A wide lane's vectors (tree_prog_wide.cuh WideVectors): the state, x_hi,
// the stage input, then the seven stages; the wrapper's scratch per lane and
// component.
constexpr int kAdaptiveVectors = 10;

// adaptive_global_lane on the wide instance (the same loop, vectors in v)
template <bool U>
MTGP_HD void adaptive_global_lane_wide(const WideTrees<U>& f, const LaneIO& io, const Control& c,
                                       WideVectors v, float* err_out, uint8_t* alive_out,
                                       int* steps_out) {
  const int d = f.d;
  for (int q = 0; q < d; ++q) v.x[q] = io.x0[q];
  bool alive = finite_vec(v.x, d);
  float e_sum = sq_err_vec(v.x, io.y, d);
  const int last = io.T - 1;
  int idx = 0;
  int steps = 0;
  if (io.T > 1) {
    const float expo = error_exponent(c.method);
    f(v.x, v.ks[0]);  // the one up-front evaluation FSAL amortises
    float t = io.ts[0];
    float dt = (io.ts[1] - io.ts[0]) / 4.0f;
    for (int s = 0; s < c.budget && alive && idx < last; ++s) {
      const float t0 = io.ts[idx];
      const float t1 = io.ts[idx + 1];
      const float span = t1 - t0;
      const float dt_c = nan_min(dt, t1 - t);
      const float err = rk_step_n(f, c.method, d, v.x, v.ks, dt_c, c.rtol, c.atol, v.x_hi, v.xs);
      const bool ok = finite_vec(v.x_hi, d) && isfinite(err);
      const bool accept = ok && err <= 1.0f;
      if (accept) v.accept();
      const float t_new = accept ? t + dt_c : t;
      const bool crossed = accept && t_new >= t1 - kCross;
      t = crossed ? t1 : t_new;
      float dt_n = clip(dt_c * step_factor(err, ok, c.safety, expo), span * kDtMin, span);
      const int idx_n = idx + (crossed ? 1 : 0);
      if (crossed && idx_n < last) {  // entry clamp with the new interval's span
        const float n_span = io.ts[idx_n + 1] - t1;
        dt_n = clip(dt_n, n_span * kDtMin, n_span);
      }
      dt = dt_n;
      alive = alive && (ok || dt_c > span * kDtDead);
      ++steps;
      if (crossed) e_sum = e_sum + sq_err_vec(v.x, io.y + static_cast<size_t>(idx_n) * d, d);
      idx = idx_n;
    }
  }
  *err_out = e_sum;
  *alive_out = (alive && idx >= last) ? 1 : 0;
  *steps_out = steps;
}

// adaptive_interval_lane on the wide instance (the same flat loop)
template <bool U>
MTGP_HD void adaptive_interval_lane_wide(const WideTrees<U>& f, const LaneIO& io, const Control& c,
                                         WideVectors v, float* err_out, uint8_t* alive_out,
                                         int* steps_out) {
  const int d = f.d;
  for (int q = 0; q < d; ++q) v.x[q] = io.x0[q];
  bool alive = finite_vec(v.x, d);
  float e_sum = sq_err_vec(v.x, io.y, d);
  int steps = 0;
  if (io.T > 1) {
    const float expo = error_exponent(c.method);
    f(v.x, v.ks[0]);
    float dt = (io.ts[1] - io.ts[0]) / 4.0f;
    int ti = 0, s = 0;
    float t1 = io.ts[1];
    float span = t1 - io.ts[0];
    float t = io.ts[0];
    dt = clip(dt, span * kDtMin, span);
    while (true) {
      if (s < c.budget && alive && t < t1 - kCross) {
        const float dt_c = nan_min(dt, t1 - t);
        const float err = rk_step_n(f, c.method, d, v.x, v.ks, dt_c, c.rtol, c.atol, v.x_hi, v.xs);
        const bool ok = finite_vec(v.x_hi, d) && isfinite(err);
        if (ok && err <= 1.0f) {
          v.accept();
          t = t + dt_c;
        }
        dt = clip(dt_c * step_factor(err, ok, c.safety, expo), span * kDtMin, span);
        alive = alive && (ok || dt_c > span * kDtDead);
        ++s;
        ++steps;
      } else {
        alive = alive && t >= t1 - kReach * nan_max(fabsf(t1), 1.0f);
        e_sum = e_sum + sq_err_vec(v.x, io.y + static_cast<size_t>(ti + 1) * d, d);
        if (++ti + 1 >= io.T) break;
        const float t0 = io.ts[ti];
        t1 = io.ts[ti + 1];
        span = t1 - t0;
        t = t0;
        dt = clip(dt, span * kDtMin, span);
        s = 0;
      }
    }
  }
  *err_out = e_sum;
  *alive_out = alive ? 1 : 0;
  *steps_out = steps;
}

// Trajectory b of candidate c on the wide instance, its vectors at the
// launch's lane li.
template <bool U>
MTGP_HD void run_lane_wide(int kind, const WideSpan& s, const Operands& a, const WideTrees<U>& f,
                           int c, int b, size_t li) {
  const int d = s.d;
  const LaneIO io{a.x0s + static_cast<size_t>(b) * d, a.ts,
                  a.ys + static_cast<size_t>(b) * a.T * d, a.T};
  WideVectors v{lane_vec(s, 0, li), lane_vec(s, 1, li), lane_vec(s, 2, li), {}};
  for (int j = 0; j < 7; ++j) v.ks[j] = lane_vec(s, 3 + j, li);
  const size_t lane = static_cast<size_t>(c) * a.B + b;
  if (kind == kGlobal)
    adaptive_global_lane_wide<U>(f, io, a.c, v, a.err + lane, a.alive + lane, a.steps + lane);
  else
    adaptive_interval_lane_wide<U>(f, io, a.c, v, a.err + lane, a.alive + lane, a.steps + lane);
}

#ifdef __CUDACC__
template <bool U, int N>
__global__ void adaptive_global_wide_kernel(WideSpan s, Operands a, int cpb, int bpb) {
  wide_block<U, N>(s, cpb, bpb, [&](const WideTrees<U>& f, int c, int b, size_t li) {
    run_lane_wide<U>(kGlobal, s, a, f, c, b, li);
  });
}

template <bool U, int N>
__global__ void adaptive_interval_wide_kernel(WideSpan s, Operands a, int cpb, int bpb) {
  wide_block<U, N>(s, cpb, bpb, [&](const WideTrees<U>& f, int c, int b, size_t li) {
    run_lane_wide<U>(kInterval, s, a, f, c, b, li);
  });
}
#endif
#endif  // MTGP_WIDE_STATE

}  // namespace

#define MTGP_ADAPTIVE_ARGS                                                                  \
  int kind, const int *ops, const float *cst, const int *devop, const float *x0s,          \
      const float *ts, const float *ys, float *err, uint8_t *alive, int *steps, int P,     \
      int d, int n, int B, int T, int var_start, int unary, int method, int budget,      \
      float rtol, float atol, float safety
#define MTGP_OPERANDS                                                                   \
  const Operands a{ops, cst, devop, x0s, ts, ys, err, alive, steps, P, n, B, T, var_start, \
                   Control{method, budget, rtol, atol, safety}}

// One instance per state dim D, unary operators or none, and tree bound N
// (32, or kMaxNodes = 256).
#define MTGP_BY_NODES(CALL, D)                                                   \
  (n <= 32 ? (unary ? CALL(D, true, 32) : CALL(D, false, 32))                    \
           : (unary ? CALL(D, true, kMaxNodes) : CALL(D, false, kMaxNodes)))
#define MTGP_ADAPTIVE_SWITCH(CALL)               \
  switch (d) {                                   \
    case 1: return MTGP_BY_NODES(CALL, 1);       \
    case 2: return MTGP_BY_NODES(CALL, 2);       \
    case 3: return MTGP_BY_NODES(CALL, 3);       \
    case 4: return MTGP_BY_NODES(CALL, 4);       \
    default: break;                              \
  }

extern "C" {

// kind 0 = global budget (`budget` steps for the whole solve), 1 = per
// interval (`budget` steps per save interval); method 0 = bosh3, 1 = dopri5.
// ops/cst (P, d, n) with d trees per candidate; x0s (B, d); ts (T,);
// ys (B, T, d); err/alive/steps (P, B): squared-error sum, liveness,
// attempted steps; unary: the function set has unary operators.
#ifdef __CUDACC__
const char* mtgp_error_string(int status) {
  return cudaGetErrorString(static_cast<cudaError_t>(status));
}
#endif

#ifdef MTGP_WIDE_STATE
// The wide instance on candidates c0 .. c0 + count - 1, its scratch
// kAdaptiveVectors * d * count * B floats (tree_prog_wide.cuh WideSpan).
#define MTGP_WIDE_OPERANDS                                                      \
  MTGP_OPERANDS;                                                                \
  const WideSpan span{ops, cst, devop, var_start, d, n, B, c0, count, scratch}; \
  const bool bad = bad_args(kind, a) || bad_span(span) || c0 + count > P

#ifdef __CUDACC__
// Launches on `stream` with `cpb` candidates per block; returns
// cudaGetLastError() of the launch.
int sr_adaptive_wide_launch(MTGP_ADAPTIVE_ARGS, float* scratch, int c0, int count, int cpb,
                            void* stream) {
  MTGP_WIDE_OPERANDS;
  if (bad) return static_cast<int>(cudaErrorInvalidValue);
  cudaStream_t st = static_cast<cudaStream_t>(stream);
#define MTGP_CALL(U, N)                                                                  \
  static_cast<int>(kind == kGlobal                                                      \
                       ? launch_wide(&adaptive_global_wide_kernel<U, N>, span, a, cpb, st) \
                       : launch_wide(&adaptive_interval_wide_kernel<U, N>, span, a, cpb, st))
  return MTGP_WIDE_INSTANCE(MTGP_CALL, n, unary);
#undef MTGP_CALL
}
#else
int sr_adaptive_wide_host(MTGP_ADAPTIVE_ARGS, float* scratch, int c0, int count) {
  MTGP_WIDE_OPERANDS;
  if (bad) return 1;
#define MTGP_CALL(U, N)                                                                       \
  (wide_host<U, N>(span, [&](const WideTrees<U>& f, int c, int b, size_t li) {                \
     run_lane_wide<U>(kind, span, a, f, c, b, li);                                            \
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
int sr_adaptive_launch(MTGP_ADAPTIVE_ARGS, int cpb, void* stream) {
  MTGP_OPERANDS;
  if (bad_args(kind, a) || cpb <= 0) return static_cast<int>(cudaErrorInvalidValue);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
#define MTGP_CALL(D, U, N) static_cast<int>(launch<D, U, N>(kind, a, cpb, s))
  MTGP_ADAPTIVE_SWITCH(MTGP_CALL)
#undef MTGP_CALL
  return static_cast<int>(cudaErrorInvalidValue);
}
#else
// host build of the same per-lane code (tests without a card)
int sr_adaptive_host(MTGP_ADAPTIVE_ARGS) {
  MTGP_OPERANDS;
  if (bad_args(kind, a)) return 1;
#define MTGP_CALL(D, U, N) (launch<D, U, N>(kind, a), 0)
  MTGP_ADAPTIVE_SWITCH(MTGP_CALL)
#undef MTGP_CALL
  return 1;
}
#endif
#endif  // MTGP_WIDE_STATE

}  // extern "C"
