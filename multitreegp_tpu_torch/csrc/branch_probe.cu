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
//   when    - `pl.when` on an SMEM flag: a block-uniform flag read at the top
//             of each round; while it is up the body and the tile's reduction
//             run, once it drops both are skipped (no barrier either);
//   dynfori - a chunked loop whose inner trip count (CH or 0) is read from
//             that flag;
//   dynval  - the same, the trip count taken straight from the reduction by
//             `__syncthreads_or` (the flag is the barrier's result).
// And the GPU's own form of the question:
//   lane    - each thread tests its own value against the per-element
//             threshold; the input puts one slow element in every 32 (one per
//             warp), which never crosses it within TOTAL iterations. A warp
//             runs until its slowest lane is done: the divergence that sets
//             the adaptive kernels' time.
//
// The tile's reduction costs one barrier a round: each warp sums its values
// by shuffles and writes the partial to shared scratch, double-buffered by
// the round's parity (so no trailing barrier guards its reuse); after one
// __syncthreads every warp of `when` and `dynfori` reads the 32 partials and
// reduces them in the same fixed order, so every thread holds the same tile
// sum and the same flag. Their flag therefore lives in a register, not in
// shared memory, and needs no second round trip. `dynval` keeps
// __syncthreads_or as its mechanism: warp 0 alone sums the partials and the
// OR is a second barrier. What sets the skip modes' time besides their
// iterations (the launch, a reduction's drain after each round's body) is
// measured in PERF.md, section 6.
//
// Every mode is `rounds` rounds; a round runs the body `trip_count` times on
// an element whose flag is up, then `next_go` sets the flag from the tile's
// sum (or, in `lane`, the element). Those three and the body are plain C++
// under PROBE_HD, shared by the kernel and, without __CUDACC__, a host loop
// over tiles (sums in element order) that tests check against the plain
// PyTorch version where there is no card. The mechanisms that carry the flag
// (the block reduction, barriers, __syncthreads_or) run only on the card.
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
// Each warp's partial sum of v (a shuffle butterfly, equal in all its lanes)
// to scratch[parity][warp], then the one barrier. The other parity's half is
// the next round's, so the scratch needs no barrier before it is written
// again.
__device__ inline void publish_partial(float v, float (*scratch)[32], int parity) {
  for (int o = 16; o > 0; o >>= 1) v += __shfl_xor_sync(0xffffffffu, v, o);
  if ((threadIdx.x & 31) == 0) scratch[parity][threadIdx.x >> 5] = v;
  __syncthreads();
}

// The tile's sum from the 32 published partials, in one fixed order: every
// warp that calls it gets the same value in all its lanes.
__device__ inline float sum_partials(float (*scratch)[32], int parity) {
  float s = scratch[parity][threadIdx.x & 31];
  for (int o = 16; o > 0; o >>= 1) s += __shfl_xor_sync(0xffffffffu, s, o);
  return s;
}

template <int M>
__global__ void __launch_bounds__(kTile) probe_kernel(const float* __restrict__ x,
                                                      float* __restrict__ out, float thresh,
                                                      float lane_thresh) {
  static_assert(kTile == 32 * 32, "one partial per warp, reduced by one warp");
  __shared__ float scratch[2][32];
  const int tid = threadIdx.x;
  const size_t i = static_cast<size_t>(blockIdx.x) * kTile + tid;
  float v = x[i];
  int go = 1;  // block-uniform in every mode but `lane`
  for (int r = 0; r < rounds(M); ++r) {
    const int n = trip_count(M, go);
    if (M == kWhen) {
      if (go) {  // `pl.when`: the body and the reduction skipped together
        for (int it = 0; it < n; ++it) v = body_work(v);
        publish_partial(v, scratch, r & 1);
        go = next_go(M, go, sum_partials(scratch, r & 1), thresh);
      }
      continue;
    }
    for (int it = 0; it < n; ++it) v = body_work(v);
    if (M == kLane) {
      go = next_go(M, go, v, lane_thresh);
    } else if (M == kDynFori) {
      publish_partial(v, scratch, r & 1);
      go = next_go(M, go, sum_partials(scratch, r & 1), thresh);
    } else if (M == kDynVal) {
      // only thread 0's predicate enters the OR: warp 0 alone sums the tile
      publish_partial(v, scratch, r & 1);
      const float s = tid < 32 ? sum_partials(scratch, r & 1) : 0.0f;
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
