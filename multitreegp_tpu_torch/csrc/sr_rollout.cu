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
// What bounds it on this card: instruction issue, as in sr_fitness.cu. Each
// lane evaluates its D trees at every RK stage of every step and writes
// T * D floats; at the trajectory shapes the path uses (one candidate,
// or a population at N <= 64) the writes are a few MB.
//
// Design: one thread per lane, candidate-major; a block stages its
// candidates' trees in shared memory; state and stage sums live in registers,
// the tree stack (S floats) in local memory. Neighbouring lanes write
// neighbouring states of a save row. The TPU kernel's (8, 128) tiles and
// double-buffered DMA of the save rows are not carried over.
//
// Numerics: the TPU kernel's stage table (`_RK_TABLES`): acc = 0 + w1*k1 +
// w2*k2 + ..., stage inputs x + (h*c)*k, the update x + (h*final_scale)*acc,
// with the scalars h*c and h*final_scale formed in double on the host and
// rounded once to float32 (the wrapper passes them). Built with -fmad=false.
#include "sr_lane.cuh"

namespace {

enum Method { kEuler = 0, kHeun = 1, kRk4 = 2 };

// h*0.5, h*1.0 (stage inputs) and h*final_scale (the update), in float32
struct StepScalars {
  float half, full, final_scale;
};

template <int D, int S, bool U>
MTGP_HD void rollout_lane(const int* t_ops, const float* t_cst, const int* __restrict__ devop,
                          const float* __restrict__ x0, int n, int var_start, int T, int method,
                          int substeps, StepScalars h, float* xs, size_t row_stride,
                          uint8_t* alive_out) {
  float stack[S];
  float x[D];
#pragma unroll
  for (int q = 0; q < D; ++q) x[q] = x0[q];
  bool alive = finite_state<D>(x);
#pragma unroll
  for (int q = 0; q < D; ++q) xs[q] = x[q];
  for (int t = 1; t < T; ++t) {
    for (int s = 0; s < substeps && alive; ++s) {
      float k[D], xst[D], acc[D], xn[D];
      drift<D, S, U>(t_ops, t_cst, n, devop, var_start, x, k, stack);
#pragma unroll
      for (int q = 0; q < D; ++q) acc[q] = 0.0f + 1.0f * k[q];
      if (method == kHeun) {
#pragma unroll
        for (int q = 0; q < D; ++q) xst[q] = x[q] + h.full * k[q];
        drift<D, S, U>(t_ops, t_cst, n, devop, var_start, xst, k, stack);
#pragma unroll
        for (int q = 0; q < D; ++q) acc[q] = acc[q] + 1.0f * k[q];
      } else if (method == kRk4) {
        const float c[3] = {h.half, h.half, h.full};
        const float w[3] = {2.0f, 2.0f, 1.0f};
#pragma unroll
        for (int st = 0; st < 3; ++st) {
#pragma unroll
          for (int q = 0; q < D; ++q) xst[q] = x[q] + c[st] * k[q];
          drift<D, S, U>(t_ops, t_cst, n, devop, var_start, xst, k, stack);
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

#ifdef __CUDACC__
template <int D, int S, bool U>
__global__ void sr_rollout_kernel(const int* __restrict__ ops, const float* __restrict__ cst,
                                  const int* __restrict__ devop, const float* __restrict__ x0s,
                                  float* __restrict__ xs, uint8_t* __restrict__ alive, int P,
                                  int n, int B, int T, int var_start, int method, int substeps,
                                  StepScalars h, int cpb) {
  const int* t_ops;
  const float* t_cst;
  size_t lane;
  int b;
  if (!stage_block(ops, cst, P, B, D * n, cpb, &t_ops, &t_cst, &lane, &b)) return;
  rollout_lane<D, S, U>(t_ops, t_cst, devop, x0s + b * D, n, var_start, T, method, substeps, h,
                     xs + lane * D, static_cast<size_t>(P) * B * D, alive + lane);
}

template <int D, int S, bool U>
cudaError_t launch(const int* ops, const float* cst, const int* devop, const float* x0s,
                   float* xs, uint8_t* alive, int P, int n, int B, int T, int var_start,
                   int method, int substeps, StepScalars h, int cpb, cudaStream_t stream) {
  const int grid = (P + cpb - 1) / cpb;
  sr_rollout_kernel<D, S, U><<<grid, cpb * B, block_smem(cpb, D, n), stream>>>(
      ops, cst, devop, x0s, xs, alive, P, n, B, T, var_start, method, substeps, h, cpb);
  return cudaGetLastError();
}
#else
template <int D, int S, bool U>
void launch(const int* ops, const float* cst, const int* devop, const float* x0s, float* xs,
            uint8_t* alive, int P, int n, int B, int T, int var_start, int method, int substeps,
            StepScalars h) {
  for (int p = 0; p < P; ++p)
    for (int b = 0; b < B; ++b) {
      const size_t lane = static_cast<size_t>(p) * B + b;
      const size_t tree = static_cast<size_t>(p) * D * n;
      rollout_lane<D, S, U>(ops + tree, cst + tree, devop, x0s + b * D, n, var_start, T, method,
                         substeps, h, xs + lane * D, static_cast<size_t>(P) * B * D,
                         alive + lane);
    }
}
#endif

bool bad_args(int P, int n, int B, int T, int method, int substeps) {
  return P <= 0 || n <= 0 || n > kMaxNodes || B <= 0 || T <= 0 || substeps <= 0 ||
         method < kEuler || method > kRk4;
}

}  // namespace

#define MTGP_ROLLOUT_ARGS                                                                   \
  const int *ops, const float *cst, const int *devop, const float *x0s, float *xs,        \
      uint8_t *alive, int P, int d, int n, int B, int T, int var_start, int unary,         \
      int method, int substeps, float h_half, float h_full, float h_final
#define MTGP_ROLLOUT_INPUTS \
  ops, cst, devop, x0s, xs, alive, P, n, B, T, var_start, method, substeps, h

// One instance per state dim D, stack bound S (32 covers N <= 32) and
// unary operators or none.
#define MTGP_BY_UNARY(CALL, D, S) (unary ? CALL(D, S, true) : CALL(D, S, false))
#define MTGP_ROLLOUT_SWITCH(CALL)                                                        \
  switch (d) {                                                                           \
    case 1: return n <= 32 ? MTGP_BY_UNARY(CALL, 1, 32) : MTGP_BY_UNARY(CALL, 1, kMaxNodes); \
    case 2: return n <= 32 ? MTGP_BY_UNARY(CALL, 2, 32) : MTGP_BY_UNARY(CALL, 2, kMaxNodes); \
    case 3: return n <= 32 ? MTGP_BY_UNARY(CALL, 3, 32) : MTGP_BY_UNARY(CALL, 3, kMaxNodes); \
    case 4: return n <= 32 ? MTGP_BY_UNARY(CALL, 4, 32) : MTGP_BY_UNARY(CALL, 4, kMaxNodes); \
    default: break;                                                                      \
  }

extern "C" {

// ops/cst (P, d, n) with d trees per candidate; x0s (B, d); xs (T, P, B, d);
// alive (P, B), the final liveness; unary: the function set has unary
// operators.
#ifdef __CUDACC__
const char* mtgp_error_string(int status) {
  return cudaGetErrorString(static_cast<cudaError_t>(status));
}

// Launches on `stream`; returns cudaGetLastError() of the launch.
int sr_rollout_launch(MTGP_ROLLOUT_ARGS, int cpb, void* stream) {
  if (bad_args(P, n, B, T, method, substeps) || cpb <= 0 || cpb * B > 1024)
    return static_cast<int>(cudaErrorInvalidValue);
  const StepScalars h{h_half, h_full, h_final};
  cudaStream_t s = static_cast<cudaStream_t>(stream);
#define MTGP_CALL(D, S, U) static_cast<int>(launch<D, S, U>(MTGP_ROLLOUT_INPUTS, cpb, s))
  MTGP_ROLLOUT_SWITCH(MTGP_CALL)
#undef MTGP_CALL
  return static_cast<int>(cudaErrorInvalidValue);
}
#else
// host build of the same per-lane code (tests without a card)
int sr_rollout_host(MTGP_ROLLOUT_ARGS) {
  if (bad_args(P, n, B, T, method, substeps)) return 1;
  const StepScalars h{h_half, h_full, h_final};
#define MTGP_CALL(D, S, U) (launch<D, S, U>(MTGP_ROLLOUT_INPUTS), 0)
  MTGP_ROLLOUT_SWITCH(MTGP_CALL)
#undef MTGP_CALL
  return 1;
}
#endif

}  // extern "C"
