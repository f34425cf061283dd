// Tree interpreter: root value of every tree on every lane, and its VJP.
//
// Replaces two TPU kernels of multitreegp_tpu/core/pallas_interpreter.py:
//   * the forward `_make_kernel_unrolled` / `_make_kernel` (reached through
//     `evaluate_trees_pallas` -> `_forward` -> `_run` -> `pl.pallas_call`):
//     `interpret_fwd` below;
//   * the backward `_make_bwd_kernel` (`_backward` -> `_run_bwd` ->
//     `pl.pallas_call`), the `custom_vjp` of the former: `interpret_bwd`.
// A lane is one tree on one data vector. The forward returns the tree's root
// value; the backward, given the root's cotangent g, returns the cotangent of
// every row's constant (dconst, zero on non-CONST rows) and of every data
// variable (ddata), per lane. The wrapper (core/cuda_interpreter.py) sums
// them back to the primal shapes.
//
// What bounds it on this card: instruction issue and local-memory latency.
// A lane reads its tree once (rows of lanes that share a tree hit in L1) and
// its data vector once, and writes 4 bytes (forward) or 4 * (N + V) bytes
// (backward); per row it runs an opcode dispatch and a dynamically indexed
// read of an earlier row.
//
// Design: one thread per lane, nothing shared between threads. The lane's row
// values live in a per-thread array `vals[N]` (local memory, cached in L1);
// the template parameter N bounds it, so the N = 32 instance does not reserve
// the stack of the N = 256 one. By the root-last layout invariant a row's
// first operand is the row directly below it (vals[i-1]) and a binary row's
// second is vals[c2]; a `switch` over the device op id picks the operator. The
// backward recomputes the values, then sweeps the rows top-down: a row's
// cotangent g_i goes to dvals[i-1] (first operand) and then dvals[c2]
// (second), to dconst[i] on CONST rows and to ddata[v] on variable rows. The
// TPU kernels' (S, 128) tiles, unrolled variant, window-9 select ladder and
// far-row tables were Mosaic's way to gather without dynamic indexing; a
// thread indexes its own array directly, so none of them is carried over.
// Lanes are the joint batch of the trees' and the data's broadcast shapes,
// flattened; each operand comes with its element strides over that batch
// (0 where it is broadcast), so no broadcast copy is ever made.
//
// Numerics: the forward runs the plain version's float32 operations; the
// backward uses the expressions PyTorch autograd uses for them (d/dy of x/y
// is -g * ((x / y) / y), d/dx of sin x is g * cos(x)), and accumulates each cotangent in the order the
// autograd engine does (the parent's dy before the next row's dx; variable
// rows top-down). Built with -fmad=false and IEEE division, so the kernel
// equals the plain version (core/interpreter.py) bit for bit per lane.
//
// The per-lane code is plain C++ under MTGP_HD, so the same file also
// compiles for the host (without __CUDACC__) into a lane loop with the same
// entry points, which tests run against the plain version without a card.
#include "tree_eval.cuh"  // op ids, apply_binary, apply_unary

namespace {

constexpr int kMaxVars = 32;
constexpr int kMaxOps = 32;
constexpr int kMaxDims = 8;

// Everything a lane needs besides the pointers, passed by value (the kernel
// parameter space holds it; no device copy, no table in device memory).
struct Params {
  int ndim;                   // joint batch rank
  int64_t shape[kMaxDims];    // joint batch shape
  int64_t tree[kMaxDims];     // element strides of ops and c2 over the batch
  int64_t cst[kMaxDims];      // ... of const
  int64_t data[kMaxDims];     // ... of data
  int devop[kMaxOps];         // opcode - kOpStart -> device op id
  int64_t L;                  // lanes = prod(shape)
  int n;                      // rows per tree
  int nvar;                   // data variables per lane
  int var_start;              // first variable opcode
};

struct Lane {
  const int* ops;
  const int* c2;
  const float* cst;
  const float* x;
};

MTGP_HD inline Lane lane_operands(const Params& p, const int* ops, const int* c2,
                                  const float* cst, const float* data, int64_t lane) {
  int64_t t = 0, c = 0, d = 0;
  for (int k = p.ndim - 1; k >= 0; --k) {
    const int64_t i = lane % p.shape[k];
    lane /= p.shape[k];
    t += i * p.tree[k];
    c += i * p.cst[k];
    d += i * p.data[k];
  }
  return Lane{ops + t, c2 + t, cst + c, data + d};
}

// Cotangents of (x, y) given the result's cotangent g: PyTorch autograd's
// formulas for add, sub, mul and true division, and for sin (g * cos(x)) and
// cos (g * -sin(x)), which have no second operand. U = false compiles the
// unary operators out (tree_eval.cuh eval_tree).
template <bool U>
MTGP_HD inline void op_vjp(int id, float x, float y, float g, float& dx, float& dy) {
  dy = 0.0f;
  if (U && is_unary(id)) {
    dx = id == kSin ? g * cosf(x) : g * -sinf(x);
    return;
  }
  switch (id) {
    case kAdd: dx = g; dy = g; break;
    case kSub: dx = g; dy = -g; break;
    case kMul: dx = g * y; dy = g * x; break;
    default: dx = g / y; dy = -g * ((x / y) / y); break;  // kDiv
  }
}

template <bool U>
MTGP_HD inline float apply_op(int id, float x, float y) {
  return U && is_unary(id) ? apply_unary(id, x) : apply_binary(id, x, y);
}

// Second operand of row i: vals[c2] for an earlier row, else 0.
MTGP_HD inline bool has_second(int c2, int i) { return c2 >= 0 && c2 < i; }

// Fills vals[0..n) bottom-up; returns the root (row n-1).
template <bool U>
MTGP_HD inline float forward_rows(const Params& p, const Lane& ln, float* vals) {
  for (int i = 0; i < p.n; ++i) {
    const int op = ln.ops[i];
    float v = 0.0f;
    if (op == kConst) {
      v = ln.cst[i];
    } else if (op >= p.var_start) {
      const int var = op - p.var_start;  // a variable past the data's width reads 0
      v = var < p.nvar ? ln.x[var] : 0.0f;
    } else if (op >= kOpStart) {
      const int c2 = ln.c2[i];
      const float x = i > 0 ? vals[i - 1] : 0.0f;
      const float y = has_second(c2, i) ? vals[c2] : 0.0f;
      v = apply_op<U>(p.devop[op - kOpStart], x, y);
    }
    vals[i] = v;  // EMPTY (and unknown) rows are 0
  }
  return vals[p.n - 1];
}

// dconst / ddata of one lane, written with stride L (rows / variables major).
template <int N, bool U>
MTGP_HD void backward_lane(const Params& p, const Lane& ln, float g, float* dconst,
                           float* ddata) {
  float vals[N], dvals[N], dd[kMaxVars];
  forward_rows<U>(p, ln, vals);
  for (int i = 0; i < p.n; ++i) dvals[i] = 0.0f;
  for (int v = 0; v < p.nvar; ++v) dd[v] = 0.0f;
  dvals[p.n - 1] = g;
  for (int i = p.n - 1; i >= 0; --i) {
    const int op = ln.ops[i];
    const float gi = dvals[i];
    float dc = 0.0f;
    if (op == kConst) {
      dc = gi;
    } else if (op >= p.var_start) {
      const int var = op - p.var_start;
      if (var < p.nvar) dd[var] += gi;
    } else if (op >= kOpStart) {
      const int id = p.devop[op - kOpStart];
      const int c2 = ln.c2[i];
      const bool second = !(U && is_unary(id)) && has_second(c2, i);
      const float x = i > 0 ? vals[i - 1] : 0.0f;
      const float y = second ? vals[c2] : 0.0f;
      float dx, dy;
      op_vjp<U>(id, x, y, gi, dx, dy);
      if (i > 0) dvals[i - 1] += dx;
      if (second) dvals[c2] += dy;
    }
    dconst[i * p.L] = dc;
  }
  for (int v = 0; v < p.nvar; ++v) ddata[v * p.L] = dd[v];
}

template <int N, bool U>
MTGP_HD inline void forward_lane(const Params& p, const Lane& ln, float* out) {
  float vals[N];
  *out = forward_rows<U>(p, ln, vals);
}

#ifdef __CUDACC__
template <int N, bool U>
__global__ void interpret_fwd_kernel(Params p, const int* __restrict__ ops,
                                     const int* __restrict__ c2, const float* __restrict__ cst,
                                     const float* __restrict__ data, float* __restrict__ out) {
  const int64_t lane = static_cast<int64_t>(blockIdx.x) * blockDim.x + threadIdx.x;
  if (lane >= p.L) return;
  forward_lane<N, U>(p, lane_operands(p, ops, c2, cst, data, lane), out + lane);
}

template <int N, bool U>
__global__ void interpret_bwd_kernel(Params p, const int* __restrict__ ops,
                                     const int* __restrict__ c2, const float* __restrict__ cst,
                                     const float* __restrict__ data, const float* __restrict__ g,
                                     float* __restrict__ dconst, float* __restrict__ ddata) {
  const int64_t lane = static_cast<int64_t>(blockIdx.x) * blockDim.x + threadIdx.x;
  if (lane >= p.L) return;
  backward_lane<N, U>(p, lane_operands(p, ops, c2, cst, data, lane), g[lane], dconst + lane,
                   ddata + lane);
}

constexpr int kThreads = 128;

inline unsigned blocks(const Params& p) {
  return static_cast<unsigned>((p.L + kThreads - 1) / kThreads);
}
#endif

// Reads the layout array [ndim, shape[8], tree[8], cst[8], data[8]] and the
// op table; returns 1 on arguments the kernels do not take.
int make_params(const int64_t* layout, const int* devop, int nops, int64_t L, int n, int nvar,
                int var_start, Params* p) {
  if (L <= 0 || n <= 0 || n > kMaxNodes || nvar < 0 || nvar > kMaxVars || nops < 0 ||
      nops > kMaxOps || var_start != kOpStart + nops)
    return 1;
  const int ndim = static_cast<int>(layout[0]);
  if (ndim < 0 || ndim > kMaxDims) return 1;
  p->ndim = ndim;
  int64_t lanes = 1;
  for (int k = 0; k < kMaxDims; ++k) {
    p->shape[k] = layout[1 + k];
    p->tree[k] = layout[1 + kMaxDims + k];
    p->cst[k] = layout[1 + 2 * kMaxDims + k];
    p->data[k] = layout[1 + 3 * kMaxDims + k];
    if (k < ndim) {
      if (p->shape[k] <= 0) return 1;
      lanes *= p->shape[k];
    }
  }
  if (lanes != L) return 1;
  for (int k = 0; k < kMaxOps; ++k) {
    p->devop[k] = k < nops ? devop[k] : 0;
    if (k < nops && (devop[k] < kAdd || devop[k] > kCos)) return 1;
  }
  p->L = L;
  p->n = n;
  p->nvar = nvar;
  p->var_start = var_start;
  return 0;
}

}  // namespace

#define MTGP_INTERP_ARGS                                                                      \
  const int *ops, const int *c2, const float *cst, const float *data, const int64_t *layout, \
      const int *devop, int nops, long long L, int n, int nvar, int var_start, int unary

extern "C" {

// ops/c2 int32 and cst float32 trees, data float32 vectors, each addressed
// per lane through `layout` (rows and variables contiguous); devop (nops,)
// host array. Forward: out (L,). Backward: g (L,) -> dconst (n, L) and
// ddata (nvar, L), lane-minor.
#ifdef __CUDACC__
const char* mtgp_error_string(int status) {
  return cudaGetErrorString(static_cast<cudaError_t>(status));
}

// Launch on `stream`; return cudaGetLastError() of the launch.
int interpret_fwd(MTGP_INTERP_ARGS, float* out, void* stream) {
  Params p;
  if (make_params(layout, devop, nops, L, n, nvar, var_start, &p))
    return static_cast<int>(cudaErrorInvalidValue);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  // instances: the main path's N <= 32 and everything up to 256, with unary
  // operators or without
#define MTGP_FWD(N, U) interpret_fwd_kernel<N, U><<<blocks(p), kThreads, 0, s>>>(p, ops, c2, cst, data, out)
  if (n <= 32) {
    if (unary) MTGP_FWD(32, true); else MTGP_FWD(32, false);
  } else {
    if (unary) MTGP_FWD(kMaxNodes, true); else MTGP_FWD(kMaxNodes, false);
  }
#undef MTGP_FWD
  return static_cast<int>(cudaGetLastError());
}

int interpret_bwd(MTGP_INTERP_ARGS, const float* g, float* dconst, float* ddata, void* stream) {
  Params p;
  if (make_params(layout, devop, nops, L, n, nvar, var_start, &p))
    return static_cast<int>(cudaErrorInvalidValue);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
#define MTGP_BWD(N, U) \
  interpret_bwd_kernel<N, U><<<blocks(p), kThreads, 0, s>>>(p, ops, c2, cst, data, g, dconst, ddata)
  if (n <= 32) {
    if (unary) MTGP_BWD(32, true); else MTGP_BWD(32, false);
  } else {
    if (unary) MTGP_BWD(kMaxNodes, true); else MTGP_BWD(kMaxNodes, false);
  }
#undef MTGP_BWD
  return static_cast<int>(cudaGetLastError());
}
#else
// host build of the same per-lane code (tests without a card); `stream` is
// ignored and 1 reports bad arguments
const char* mtgp_error_string(int status) {
  return status ? "invalid arguments" : "no error";
}

int interpret_fwd(MTGP_INTERP_ARGS, float* out, void* stream) {
  (void)stream;
  Params p;
  if (make_params(layout, devop, nops, L, n, nvar, var_start, &p)) return 1;
  for (int64_t lane = 0; lane < L; ++lane) {
    const Lane ln = lane_operands(p, ops, c2, cst, data, lane);
    if (n <= 32) unary ? forward_lane<32, true>(p, ln, out + lane) : forward_lane<32, false>(p, ln, out + lane);
    else unary ? forward_lane<kMaxNodes, true>(p, ln, out + lane)
               : forward_lane<kMaxNodes, false>(p, ln, out + lane);
  }
  return 0;
}

int interpret_bwd(MTGP_INTERP_ARGS, const float* g, float* dconst, float* ddata, void* stream) {
  (void)stream;
  Params p;
  if (make_params(layout, devop, nops, L, n, nvar, var_start, &p)) return 1;
  for (int64_t lane = 0; lane < L; ++lane) {
    const Lane ln = lane_operands(p, ops, c2, cst, data, lane);
    if (n <= 32) {
      if (unary) backward_lane<32, true>(p, ln, g[lane], dconst + lane, ddata + lane);
      else backward_lane<32, false>(p, ln, g[lane], dconst + lane, ddata + lane);
    } else {
      if (unary) backward_lane<kMaxNodes, true>(p, ln, g[lane], dconst + lane, ddata + lane);
      else backward_lane<kMaxNodes, false>(p, ln, g[lane], dconst + lane, ddata + lane);
    }
  }
  return 0;
}
#endif

}  // extern "C"
