// Skip-mechanism timing probe: which data-dependent skips does the card
// honour, and what does one slow lane cost its warp?
//
// Replaces the TPU kernel `make_kernel` of tools/mosaic_branch_probe.py
// (the inline probe kernel, `pl.pallas_call` in its `run`). That probe asks
// whether a predicate computed mid-loop really skips work under Mosaic. Its
// shapes and constants are kept: REPS tiles of 8 x 128 float32, a body of 64
// dependent `x * 1.001f + 0.001f` (built with -fmad=false, so a multiply and
// an add, no FMA), TOTAL = 64 iterations, a flag that drops once the tile's
// sum passes THRESH (after FLIP = 8 iterations from ones), chunks of CH = 4.
//
// One block is one tile, one thread per element (1024 threads). Each TPU
// mode maps to its nearest CUDA mechanism:
//   always  - no skip: TOTAL iterations, the roofline of "executes everything";
//   when    - `pl.when` on an SMEM flag: a block-uniform flag in shared memory,
//             written by thread 0 from a block reduction of the tile's sum;
//   dynfori - a chunked loop whose inner trip count (CH or 0) is read from
//             that flag;
//   dynval  - the same, the trip count computed straight from the reduction
//             by `__syncthreads_or` (no flag in shared memory).
// And the GPU's own form of the question:
//   lane    - each thread tests its own value against the per-element
//             threshold; the input puts one slow element in every 32 (one per
//             warp), which never crosses it within TOTAL iterations. A warp
//             runs until its slowest lane is done: the divergence that sets
//             the adaptive kernels' time.
//
// Every mode is `rounds` rounds; a round runs the body `trip_count` times on
// an element whose flag is up, then `next_go` sets the flag from the tile's
// sum (or, in `lane`, the element). Those three and the body are plain C++
// under PROBE_HD, shared by the kernel and, without __CUDACC__, a host loop
// over tiles (sums in element order) that tests check against the plain
// PyTorch version where there is no card. The mechanisms that carry the flag
// (shared memory, barriers, __syncthreads_or, the block reduction) run only
// on the card.
#include <stddef.h>

#ifdef __CUDACC__
#include <cuda_runtime.h>
#define PROBE_HD __host__ __device__
#else
#define PROBE_HD
#endif

namespace {

constexpr int kTile = 8 * 128;
constexpr int kTotal = 64;
constexpr int kCh = 4;
constexpr int kBody = 64;

enum Mode { kAlways = 0, kWhen = 1, kDynFori = 2, kDynVal = 3, kLane = 4 };

PROBE_HD inline float body_work(float x) {
  for (int i = 0; i < kBody; ++i) x = x * 1.001f + 0.001f;
  return x;
}

PROBE_HD constexpr bool chunked(int mode) { return mode == kDynFori || mode == kDynVal; }

PROBE_HD constexpr int rounds(int mode) {
  return mode == kAlways ? 1 : chunked(mode) ? kTotal / kCh : kTotal;
}

// Iterations of the body in one round, for the element's flag `go`.
PROBE_HD constexpr int trip_count(int mode, int go) {
  return !go ? 0 : mode == kAlways ? kTotal : chunked(mode) ? kCh : 1;
}

// The flag for the next round from `value` (the tile's sum, or the element
// in `lane`): `when` and `lane` stay down once down, the chunked modes test
// the tile after every chunk, `always` never drops.
PROBE_HD inline int next_go(int mode, int go, float value, float thresh) {
  if (mode == kAlways) return 1;
  if (chunked(mode)) return value < thresh;
  return go && value < thresh;
}

#ifdef __CUDACC__
// Sum of the block's values; valid in every thread of warp 0. Ends with a
// barrier, so `scratch` can be reused at once.
__device__ inline float block_sum(float v, float* scratch) {
  for (int o = 16; o > 0; o >>= 1) v += __shfl_xor_sync(0xffffffffu, v, o);
  if ((threadIdx.x & 31) == 0) scratch[threadIdx.x >> 5] = v;
  __syncthreads();
  float s = 0.0f;
  if (threadIdx.x < 32) {
    s = scratch[threadIdx.x];
    for (int o = 16; o > 0; o >>= 1) s += __shfl_xor_sync(0xffffffffu, s, o);
  }
  __syncthreads();
  return s;
}

template <int M>
__global__ void __launch_bounds__(kTile) probe_kernel(const float* __restrict__ x,
                                                      float* __restrict__ out, float thresh,
                                                      float lane_thresh) {
  __shared__ float scratch[32];
  __shared__ int go_flag;  // when, dynfori: the block's flag
  constexpr bool in_smem = M == kWhen || M == kDynFori;
  const int tid = threadIdx.x;
  const size_t i = static_cast<size_t>(blockIdx.x) * kTile + tid;
  float v = x[i];
  int go = 1;
  if (in_smem) {
    if (tid == 0) go_flag = 1;
    __syncthreads();
  }
  for (int r = 0; r < rounds(M); ++r) {
    if (in_smem) go = go_flag;  // block-uniform
    const int n = trip_count(M, go);
    if (M == kWhen) {
      if (go) {  // `pl.when`: the body and the reduction skipped together
        for (int it = 0; it < n; ++it) v = body_work(v);
        const float s = block_sum(v, scratch);
        if (tid == 0) go_flag = next_go(M, go, s, thresh);
      }
      __syncthreads();
      continue;
    }
    for (int it = 0; it < n; ++it) v = body_work(v);
    if (M == kLane) {
      go = next_go(M, go, v, lane_thresh);
    } else if (M == kDynFori) {
      const float s = block_sum(v, scratch);
      if (tid == 0) go_flag = next_go(M, go, s, thresh);
      __syncthreads();
    } else if (M == kDynVal) {
      const float s = block_sum(v, scratch);
      go = __syncthreads_or(tid == 0 && next_go(M, go, s, thresh));
    }
  }
  out[i] = v;
}

template <int M>
cudaError_t launch(const float* x, float* out, int tiles, float thresh, float lane_thresh,
                   cudaStream_t stream) {
  probe_kernel<M><<<tiles, kTile, 0, stream>>>(x, out, thresh, lane_thresh);
  return cudaGetLastError();
}
#else
float tile_sum(const float* v) {
  float s = 0.0f;
  for (int e = 0; e < kTile; ++e) s += v[e];
  return s;
}

// One tile on the host: every element's rounds, then the next flags from
// the tile's sum (kept per element, equal across the tile but in `lane`).
void probe_tile(int mode, const float* x, float* v, float thresh, float lane_thresh) {
  int go[kTile];
  for (int e = 0; e < kTile; ++e) {
    v[e] = x[e];
    go[e] = 1;
  }
  for (int r = 0; r < rounds(mode); ++r) {
    for (int e = 0; e < kTile; ++e)
      for (int it = 0; it < trip_count(mode, go[e]); ++it) v[e] = body_work(v[e]);
    const float s = mode == kLane ? 0.0f : tile_sum(v);
    for (int e = 0; e < kTile; ++e)
      go[e] = mode == kLane ? next_go(mode, go[e], v[e], lane_thresh) : next_go(mode, go[e], s, thresh);
  }
}
#endif

bool bad_args(int mode, int tiles) { return mode < kAlways || mode > kLane || tiles <= 0; }

}  // namespace

extern "C" {

// x/out (tiles, 8, 128) float32; thresh: the tile-sum threshold;
// lane_thresh: the per-element threshold of the lane mode.
#ifdef __CUDACC__
const char* mtgp_error_string(int status) {
  return cudaGetErrorString(static_cast<cudaError_t>(status));
}

// Launches on `stream`; returns cudaGetLastError() of the launch.
int branch_probe_launch(int mode, const float* x, float* out, int tiles, float thresh,
                        float lane_thresh, void* stream) {
  if (bad_args(mode, tiles)) return static_cast<int>(cudaErrorInvalidValue);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  switch (mode) {
    case kAlways: return launch<kAlways>(x, out, tiles, thresh, lane_thresh, s);
    case kWhen: return launch<kWhen>(x, out, tiles, thresh, lane_thresh, s);
    case kDynFori: return launch<kDynFori>(x, out, tiles, thresh, lane_thresh, s);
    case kDynVal: return launch<kDynVal>(x, out, tiles, thresh, lane_thresh, s);
    default: return launch<kLane>(x, out, tiles, thresh, lane_thresh, s);
  }
}
#else
// host build of the same per-element code (tests without a card)
int branch_probe_host(int mode, const float* x, float* out, int tiles, float thresh,
                      float lane_thresh) {
  if (bad_args(mode, tiles)) return 1;
  for (int t = 0; t < tiles; ++t)
    probe_tile(mode, x + static_cast<size_t>(t) * kTile, out + static_cast<size_t>(t) * kTile,
               thresh, lane_thresh);
  return 0;
}
#endif

}  // extern "C"
