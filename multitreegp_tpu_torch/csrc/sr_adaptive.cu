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
// What bounds it on this card: instruction issue, and warp divergence. A lane
// reads its trees (staged once per block in shared memory), its ground-truth
// rows and the save grid, a few KB; it does 3 (bosh3) or 6 (dopri5) tree
// evaluations of its D trees per attempted step, and the number of attempts
// is data-dependent (tens to the whole budget). A warp holds the B
// trajectories of 32 / B candidates and runs until its slowest lane is done.
//
// Design: one thread per lane, candidate-major (the B lanes of a candidate are
// neighbouring threads running the same tree program). State, stages, t, dt,
// the save index and the FSAL k1 live in registers; the tree stack (S floats)
// in local memory. Unlike the TPU kernels, which spin for the whole budget
// with every update predicated (Mosaic never skips), a thread stops once its
// lane is done: a finished or dead lane's remaining iterations are no-ops
// there, so per lane the result is the same. The TPU kernels' (8, 128) tiles,
// `ts_ladder` select ladder, resident ys block and ysel ladder, size sort and
// lane layout, and `go_scr` early exit existed because Mosaic cannot index per
// lane or skip; a thread reads `ts[idx]` and `ys[b, idx]` directly.
//
// Numerics: the kernels' float32 expressions in their order (the same as the
// plain versions in core/cuda_adaptive.py); the step and the controller are
// adaptive_step.cuh's, shared with the adaptive policy kernel (policy.cu).
// Built with -fmad=false and IEEE division and square root.
#include "adaptive_step.cuh"
#include "sr_lane.cuh"

namespace {

// A lane's trees: D trees of n rows, and the opcode table.
struct Trees {
  const int* ops;
  const float* cst;
  int n;
  const int* devop;
  int var_start;
};

// The drift functor of rk_step: k = trees(x), on this lane's stack.
template <int D, int S, bool U>
struct TreeDrift {
  const Trees& tr;
  float* stack;
  MTGP_HD void operator()(const float (&x)[D], float (&k)[D]) const {
    drift<D, S, U>(tr.ops, tr.cst, tr.n, tr.devop, tr.var_start, x, k, stack);
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
template <int D, int S, bool U>
MTGP_HD void adaptive_global_lane(const Trees& tr, const LaneIO& io, const Control& c,
                                  float* err_out, uint8_t* alive_out, int* steps_out) {
  float stack[S];
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
    const TreeDrift<D, S, U> f{tr, stack};
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
// error is added at every save point, for dead (frozen) lanes too.
template <int D, int S, bool U>
MTGP_HD void adaptive_interval_lane(const Trees& tr, const LaneIO& io, const Control& c,
                                    float* err_out, uint8_t* alive_out, int* steps_out) {
  float stack[S];
  float x[D], k1[D];
#pragma unroll
  for (int q = 0; q < D; ++q) x[q] = io.x0[q];
  bool alive = finite_state<D>(x);
  float e_sum = sq_err<D>(x, io.y);
  int steps = 0;
  if (io.T > 1) {
    const float expo = error_exponent(c.method);
    const TreeDrift<D, S, U> f{tr, stack};
    f(x, k1);
    float dt = (io.ts[1] - io.ts[0]) / 4.0f;
    for (int ti = 0; ti + 1 < io.T; ++ti) {
      const float t0 = io.ts[ti];
      const float t1 = io.ts[ti + 1];
      const float span = t1 - t0;
      float t = t0;
      dt = clip(dt, span * kDtMin, span);
      for (int s = 0; s < c.budget && alive && t < t1 - kCross; ++s) {
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
        ++steps;
      }
      alive = alive && t >= t1 - kReach * nan_max(fabsf(t1), 1.0f);
      e_sum = e_sum + sq_err<D>(x, io.y + (ti + 1) * D);
    }
  }
  *err_out = e_sum;
  *alive_out = alive ? 1 : 0;
  *steps_out = steps;
}

enum Budget { kGlobal = 0, kInterval = 1 };

#ifdef __CUDACC__
// This thread's trees and inputs, after staging the block's trees.
template <int D>
__device__ bool block_lane(const int* __restrict__ ops, const float* __restrict__ cst,
                           const int* __restrict__ devop, const float* __restrict__ x0s,
                           const float* __restrict__ ts, const float* __restrict__ ys, int P,
                           int n, int B, int T, int var_start, int cpb, Trees* tr, LaneIO* io,
                           size_t* lane) {
  const int* t_ops;
  const float* t_cst;
  int b;
  if (!stage_block(ops, cst, P, B, D * n, cpb, &t_ops, &t_cst, lane, &b)) return false;
  *tr = Trees{t_ops, t_cst, n, devop, var_start};
  *io = LaneIO{x0s + b * D, ts, ys + static_cast<size_t>(b) * T * D, T};
  return true;
}

#define MTGP_KERNEL_PARAMS                                                                 \
  const int *__restrict__ ops, const float *__restrict__ cst, const int *__restrict__ devop, \
      const float *__restrict__ x0s, const float *__restrict__ ts,                        \
      const float *__restrict__ ys, float *__restrict__ err, uint8_t *__restrict__ alive,  \
      int *__restrict__ steps, int P, int n, int B, int T, int var_start, Control c, int cpb

template <int D, int S, bool U>
__global__ void adaptive_global_kernel(MTGP_KERNEL_PARAMS) {
  Trees tr;
  LaneIO io;
  size_t lane;
  if (block_lane<D>(ops, cst, devop, x0s, ts, ys, P, n, B, T, var_start, cpb, &tr, &io, &lane))
    adaptive_global_lane<D, S, U>(tr, io, c, err + lane, alive + lane, steps + lane);
}

template <int D, int S, bool U>
__global__ void adaptive_interval_kernel(MTGP_KERNEL_PARAMS) {
  Trees tr;
  LaneIO io;
  size_t lane;
  if (block_lane<D>(ops, cst, devop, x0s, ts, ys, P, n, B, T, var_start, cpb, &tr, &io, &lane))
    adaptive_interval_lane<D, S, U>(tr, io, c, err + lane, alive + lane, steps + lane);
}

template <int D, int S, bool U>
cudaError_t launch(int kind, const int* ops, const float* cst, const int* devop,
                   const float* x0s, const float* ts, const float* ys, float* err,
                   uint8_t* alive, int* steps, int P, int n, int B, int T, int var_start,
                   Control c, int cpb, cudaStream_t stream) {
  const int grid = (P + cpb - 1) / cpb;
  const size_t smem = block_smem(cpb, D, n);
  if (kind == kGlobal)
    adaptive_global_kernel<D, S, U><<<grid, cpb * B, smem, stream>>>(
        ops, cst, devop, x0s, ts, ys, err, alive, steps, P, n, B, T, var_start, c, cpb);
  else
    adaptive_interval_kernel<D, S, U><<<grid, cpb * B, smem, stream>>>(
        ops, cst, devop, x0s, ts, ys, err, alive, steps, P, n, B, T, var_start, c, cpb);
  return cudaGetLastError();
}
#else
template <int D, int S, bool U>
void launch(int kind, const int* ops, const float* cst, const int* devop, const float* x0s,
            const float* ts, const float* ys, float* err, uint8_t* alive, int* steps, int P,
            int n, int B, int T, int var_start, Control c) {
  for (int p = 0; p < P; ++p)
    for (int b = 0; b < B; ++b) {
      const size_t lane = static_cast<size_t>(p) * B + b;
      const size_t tree = static_cast<size_t>(p) * D * n;
      const Trees tr{ops + tree, cst + tree, n, devop, var_start};
      const LaneIO io{x0s + b * D, ts, ys + static_cast<size_t>(b) * T * D, T};
      if (kind == kGlobal)
        adaptive_global_lane<D, S, U>(tr, io, c, err + lane, alive + lane, steps + lane);
      else
        adaptive_interval_lane<D, S, U>(tr, io, c, err + lane, alive + lane, steps + lane);
    }
}
#endif

bool bad_args(int kind, int P, int n, int B, int T, int method, int budget) {
  return (kind != kGlobal && kind != kInterval) || P <= 0 || n <= 0 || n > kMaxNodes ||
         B <= 0 || T <= 0 || budget < 0 || (method != kBosh3 && method != kDopri5);
}

}  // namespace

#define MTGP_ADAPTIVE_ARGS                                                                  \
  int kind, const int *ops, const float *cst, const int *devop, const float *x0s,          \
      const float *ts, const float *ys, float *err, uint8_t *alive, int *steps, int P,     \
      int d, int n, int B, int T, int var_start, int unary, int method, int budget,      \
      float rtol, float atol, float safety
#define MTGP_ADAPTIVE_INPUTS \
  kind, ops, cst, devop, x0s, ts, ys, err, alive, steps, P, n, B, T, var_start, ctl

// One instance per state dim D, stack bound S (32 covers N <= 32) and
// unary operators or none.
#define MTGP_BY_UNARY(CALL, D, S) (unary ? CALL(D, S, true) : CALL(D, S, false))
#define MTGP_ADAPTIVE_SWITCH(CALL)                                                       \
  switch (d) {                                                                           \
    case 1: return n <= 32 ? MTGP_BY_UNARY(CALL, 1, 32) : MTGP_BY_UNARY(CALL, 1, kMaxNodes); \
    case 2: return n <= 32 ? MTGP_BY_UNARY(CALL, 2, 32) : MTGP_BY_UNARY(CALL, 2, kMaxNodes); \
    case 3: return n <= 32 ? MTGP_BY_UNARY(CALL, 3, 32) : MTGP_BY_UNARY(CALL, 3, kMaxNodes); \
    case 4: return n <= 32 ? MTGP_BY_UNARY(CALL, 4, 32) : MTGP_BY_UNARY(CALL, 4, kMaxNodes); \
    default: break;                                                                      \
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

// Launches on `stream`; returns cudaGetLastError() of the launch.
int sr_adaptive_launch(MTGP_ADAPTIVE_ARGS, int cpb, void* stream) {
  if (bad_args(kind, P, n, B, T, method, budget) || cpb <= 0 || cpb * B > 1024)
    return static_cast<int>(cudaErrorInvalidValue);
  const Control ctl{method, budget, rtol, atol, safety};
  cudaStream_t s = static_cast<cudaStream_t>(stream);
#define MTGP_CALL(D, S, U) static_cast<int>(launch<D, S, U>(MTGP_ADAPTIVE_INPUTS, cpb, s))
  MTGP_ADAPTIVE_SWITCH(MTGP_CALL)
#undef MTGP_CALL
  return static_cast<int>(cudaErrorInvalidValue);
}
#else
// host build of the same per-lane code (tests without a card)
int sr_adaptive_host(MTGP_ADAPTIVE_ARGS) {
  if (bad_args(kind, P, n, B, T, method, budget)) return 1;
  const Control ctl{method, budget, rtol, atol, safety};
#define MTGP_CALL(D, S, U) (launch<D, S, U>(MTGP_ADAPTIVE_INPUTS), 0)
  MTGP_ADAPTIVE_SWITCH(MTGP_CALL)
#undef MTGP_CALL
  return 1;
}
#endif

}  // extern "C"
