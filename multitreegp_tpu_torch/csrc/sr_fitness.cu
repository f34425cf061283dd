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
// What bounds it on this card: instruction issue. Each lane evaluates m
// trees of up to N rows at every RK stage of every step (4 x 49 x 2 tree
// evaluations per lane on the main path) and reads only a few KB: the trees
// once per block and its own ground-truth row. Bytes are negligible; the
// per-row opcode dispatch is the work.
//
// Design: one thread per lane. Lanes are candidate-major, so the B
// trajectories of one candidate are B neighbouring threads that run the
// same tree program on different states (uniform branches across them). A
// block holds `cpb` candidates; their trees (ops and const only) are staged
// once into shared memory. Trees are evaluated as a postorder stack machine:
// in the root-last layout a binary row's first operand is the top of the
// stack and its second the entry below, so no child pointers are read.
// State, RK stages and the stage sums live in registers (the state dim is a
// template parameter). The TPU kernel's size sort and lane layout existed for
// Mosaic's `pl.when` row skip; here the padding prefix is skipped per lane.
//
// Numerics copy the JAX integrator (multitreegp_tpu/models/integrators.py):
// stage inputs x + (0.5*dt)*k, final x + (dt/6)*(((k1 + 2k2) + 2k3) + k4),
// dt = (ts[t+1] - ts[t]) / substeps per interval from the float32 grid. Built
// with -fmad=false and IEEE division, so x/0 -> inf kills the lane as in JAX.
//
// The per-lane code (here and in sr_lane.cuh, shared with the adaptive and
// trajectory kernels) is plain C++ under MTGP_HD, so the same file also
// compiles for the host (without __CUDACC__) into a lane loop that tests can
// run against the plain version on machines without a card.
#include "sr_lane.cuh"

namespace {

enum Method { kEuler = 0, kHeun = 1, kRk4 = 2 };

// One lane: trajectory b of a candidate whose d trees are t_ops/t_cst.
template <int D, bool U>
MTGP_HD void fitness_lane(const int* t_ops, const float* t_cst, const int* __restrict__ devop,
                          const float* __restrict__ x0s, const float* __restrict__ ts,
                          const float* __restrict__ ys, const float* __restrict__ kicks, int n,
                          int b, int B, int T, int var_start, int method, int substeps,
                          float* err, uint8_t* alive_out) {
  float stack[kMaxNodes];
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
        drift<D, kMaxNodes, U>(t_ops, t_cst, n, devop, var_start, x, k1, stack);
        if (method == kEuler) {
#pragma unroll
          for (int q = 0; q < D; ++q) xn[q] = x[q] + h * k1[q];
        } else if (method == kHeun) {
          float xs[D], k2[D];
#pragma unroll
          for (int q = 0; q < D; ++q) xs[q] = x[q] + h * k1[q];
          drift<D, kMaxNodes, U>(t_ops, t_cst, n, devop, var_start, xs, k2, stack);
          const float hh = 0.5f * h;
#pragma unroll
          for (int q = 0; q < D; ++q) xn[q] = x[q] + hh * (k1[q] + k2[q]);
        } else {
          float xs[D], k2[D], k3[D], k4[D];
          const float hh = 0.5f * h;
#pragma unroll
          for (int q = 0; q < D; ++q) xs[q] = x[q] + hh * k1[q];
          drift<D, kMaxNodes, U>(t_ops, t_cst, n, devop, var_start, xs, k2, stack);
#pragma unroll
          for (int q = 0; q < D; ++q) xs[q] = x[q] + hh * k2[q];
          drift<D, kMaxNodes, U>(t_ops, t_cst, n, devop, var_start, xs, k3, stack);
#pragma unroll
          for (int q = 0; q < D; ++q) xs[q] = x[q] + h * k3[q];
          drift<D, kMaxNodes, U>(t_ops, t_cst, n, devop, var_start, xs, k4, stack);
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
template <int D, bool U>
__global__ void sr_fitness_kernel(const int* __restrict__ ops, const float* __restrict__ cst,
                                  const int* __restrict__ devop, const float* __restrict__ x0s,
                                  const float* __restrict__ ts, const float* __restrict__ ys,
                                  const float* __restrict__ kicks,
                                  float* __restrict__ err, uint8_t* __restrict__ alive_out,
                                  int P, int n, int B, int T, int var_start, int method,
                                  int substeps, int cpb) {
  const int* t_ops;
  const float* t_cst;
  size_t lane;
  int b;
  if (!stage_block(ops, cst, P, B, D * n, cpb, &t_ops, &t_cst, &lane, &b)) return;
  fitness_lane<D, U>(t_ops, t_cst, devop, x0s, ts, ys, kicks, n, b, B, T, var_start, method,
                     substeps, err + lane, alive_out + lane);
}

template <int D, bool U>
cudaError_t launch(const int* ops, const float* cst, const int* devop, const float* x0s,
                   const float* ts, const float* ys, const float* kicks, float* err,
                   uint8_t* alive, int P, int n, int B, int T, int var_start, int method,
                   int substeps, int cpb, cudaStream_t stream) {
  const int grid = (P + cpb - 1) / cpb;
  sr_fitness_kernel<D, U><<<grid, cpb * B, block_smem(cpb, D, n), stream>>>(
      ops, cst, devop, x0s, ts, ys, kicks, err, alive, P, n, B, T, var_start, method, substeps,
      cpb);
  return cudaGetLastError();
}
#else
template <int D, bool U>
void launch(const int* ops, const float* cst, const int* devop, const float* x0s,
            const float* ts, const float* ys, const float* kicks, float* err, uint8_t* alive,
            int P, int n, int B, int T, int var_start, int method, int substeps) {
  for (int p = 0; p < P; ++p)
    for (int b = 0; b < B; ++b) {
      const size_t lane = static_cast<size_t>(p) * B + b;
      const size_t tree = static_cast<size_t>(p) * D * n;
      fitness_lane<D, U>(ops + tree, cst + tree, devop, x0s, ts, ys, kicks, n, b, B, T,
                         var_start, method, substeps, err + lane, alive + lane);
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
#define MTGP_CALL(D) (unary ? launch<D, true>(MTGP_FITNESS_INPUTS, cpb, s) \
                         : launch<D, false>(MTGP_FITNESS_INPUTS, cpb, s))
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
#define MTGP_CALL(D) \
  (unary ? launch<D, true>(MTGP_FITNESS_INPUTS) : launch<D, false>(MTGP_FITNESS_INPUTS), 0)
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
