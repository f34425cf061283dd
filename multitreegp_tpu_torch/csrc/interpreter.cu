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
// Semantics (core/interpreter.py, JAX `evaluate_trees_ladder`): rows run
// bottom to top; a row's first operand is the row directly below it (c1 ==
// i-1 in the root-last layout) and its second the value of row c2, 0 unless
// 0 <= c2 < i, whatever the tree: no postorder stack is simulated
// (tree_prog.cuh's stack slots agree with this only on well-formed trees).
//
// What bounds it on this card: the latency of each lane's row chain, and at
// the recompute's 1,600 lanes the launch itself. A lane reads a tree that its
// group shares and its data vector, and writes 4 bytes (forward) or 4 * (N +
// V) bytes (backward).
//
// Design. The wrapper orders the joint batch's dimensions so that those along
// which the trees are broadcast (stride 0 in ops, c2 and const) come last: a
// lane is (group, member), the members of a group read one tree, and
// consecutive lanes are one group's members (in the recompute a tree's 16
// trajectories, two trees to a warp). Each lane still writes its outputs at
// its index in the joint batch. A block runs one warp of consecutive lanes
// (kThreads: the recompute's 1,600 lanes take 50 SMs; 128-thread blocks ran
// in the same device time). In two phases
// between barriers it stages what the row loop reads: first each lane copies
// its data vector into its column of shared memory (column V holds 0: EMPTY
// rows and variables past the data's width read it) while the threads of the
// block's groups work out where their trees lie; then its threads load the
// trees' rows, one row per thread, coalesced, a row's three words at once,
// and decode each into shared memory (Row: the kind, the device op id or data
// slot, and c2 + 1 where row c2 is a second operand, folded into one word
// beside the constant); a shared minimum finds each tree's first live row.
// The row loop then makes no global load: the row comes from shared memory
// (one address per group of the warp), the first operand from a register, the
// second from the lane's row array in local memory, and every row runs the
// same instructions whatever its kind (division, the unary operators and the
// extended build's pow, max and min keep a branch), so
// the groups of a warp do not take their rows' branches one after the other.
// The VJP runs the same forward into the lane's tape (each row's value beside
// the cotangent that rows above have sent it as their second operand), then
// sweeps top-down carrying the cotangent of the current row in a register:
// row i's cotangent is the tape's sum for row i plus row i+1's dx, so each
// row makes one tape load (value and partial sum of row i-1, one 8-byte
// word) and at most one read-modify-write (its c2 row).
//
// Numerics: the forward runs the plain version's float32 operations; the
// backward uses the expressions PyTorch autograd uses for them (d/dy of x/y
// is -g * ((x / y) / y), d/dx of sin x is g * cos(x); the extended build's
// in unary_vjp and binary_vjp; a user build's in the VJP generated from
// autograd's graph of each user operator), and accumulates each
// cotangent in the order the autograd engine does: a row's sum from the rows
// above that read it as their second operand, top-down, then its parent's dx
// (then that parent's dy where c2 == i-1); variable rows top-down. Built with
// -fmad=false and IEEE division, so the kernel equals the plain version
// (core/interpreter.py) bit for bit per lane.
//
// Trees of more than 256 rows (up to kMaxRows = 1024) run the same code in a
// third instance: the lane's row array and tape in local memory (4 and 8 KB
// a thread at 1024 rows), and the decoded rows of a block's groups in shared
// memory as below. A block whose lanes share no tree would stage 32 trees,
// 262 KB at 1024 rows, past the 227 KB a block may have; there the block runs
// fewer lanes (Params::block, the largest power of two up to kThreads whose
// staging fits; 16 at 1024 rows and one lane a tree), its other threads only
// staging. Layouts whose groups have several members (the recompute's 16 a
// tree: at most 3 groups a block) keep 32 lanes at every N.
//
// Everything past those three instances (more than kMaxRows rows, more than
// kRowVars variables, more than kMaxOps operators) runs the wide instance,
// whose sizes are runtime values (the wrapper sets the layout's `wide` word):
// * the lane's values (forward) and tape (backward) lie in a scratch buffer
//   that the wrapper allocates, lane-minor ([row][lane] of the launch's
//   lanes), so a group's members read and write one row's entries
//   coalesced; the wrapper splits the lanes into launches whose scratch
//   stays under its budget (core/cuda_interpreter.py SCRATCH_BYTES);
// * a block stages its groups' rows in chunks of WideParams::chunk rows
//   (kWideStage bytes of shared memory, whatever the tree's size): the rows
//   run in order, bottom to top forward and top to bottom backward, and a
//   row's second operand is a value of the tape, not a row, so the block
//   stages a chunk, runs it, and stages the next; each tree's first live
//   row is found while the forward stages (a group's rows run from the
//   chunk that holds it), and a padding row's c2 and constant are not read;
// * a decoded row (WideRow) keeps the device op id or data slot in 30 bits
//   and c2 + 1 (or the constant) in a word of its own, so a user build's
//   ids past 63 (a set of more than 47 user operators) run here;
// * the data vector is read where it lies, and ddata accumulated where the
//   wrapper reads it;
// * the device op table holds every id (kDeviceOps).
// Per lane it runs the same float32 operations in the same order as the
// other instances, so it is bit-equal to the plain version too.
//
// The per-thread code is plain C++ under MTGP_HD, so the same file also
// compiles for the host (without __CUDACC__): a loop over the blocks runs
// each phase's threads one after the other, with the same entry points,
// which tests run against the plain version without a card.
#include "tree_eval.cuh"  // op ids, apply_binary, apply_unary

#ifndef __CUDACC__
#include <string.h>

#include <vector>
#endif

namespace {

// the fixed instances' limits: variables (the decoded row's 6-bit slot holds
// them and the zero column), operators (Params::devop) and rows
constexpr int kRowVars = 63;
constexpr int kMaxOps = 32;
constexpr int kMaxRows = 1024;
constexpr int kMaxDims = 8;
constexpr int kThreads = 32;  // threads per block, and its most lanes
constexpr size_t kMaxShared = 227 * 1024;  // a block's shared memory, opted in
// the wide instance: the entries of its device op table (opcode - kOpStart
// -> id; a set's operators have distinct ids, so 64 hold any set of the
// default and extended builds, and a user build holds its kUserFrom + kCount
// where that is more: core/cuda_interpreter.py op_table_words), the rows a
// block stages at once (bytes), and the most variables its decoded slot
// holds
#if defined(MTGP_USER_OPS)
constexpr int kDeviceOps = kLastOp + 1 > 64 ? kLastOp + 1 : 64;
#else
constexpr int kDeviceOps = 64;
#endif
constexpr int kWideStage = 6 * 1024;
constexpr int kWideMaxVars = (1 << 28) - 1;
// layout words: [ndim, ngroup, n, nvar, var_start, nops, unary, wide], then
// shape, tree, const, data and out strides (kMaxDims each), then the device
// op table (kDeviceOps)
constexpr int kHeader = 8;

// decoded row kinds (bits 0-1 of Row::meta); EMPTY and unknown rows decode
// to a variable leaf of the zero column
constexpr int kLeafConst = 0;
constexpr int kLeafVar = 1;
constexpr int kBinary = 2;
constexpr int kUnary = 3;

// One decoded row: `meta` holds the kind (bits 0-1), the device op id or data
// slot (bits 2-7) and c2 + 1 where row c2 is the row's second operand, else 0
// (bits 16-31, read as meta >> 16: up to 32,767, so any c2 < kMaxRows); `c`
// is the constant of a CONST row.
struct alignas(8) Row {
  int meta;
  float c;
};

// One row of a lane's tape: its value and the cotangent sent to it so far.
struct alignas(8) Tape {
  float v;
  float g;
};

// Everything a lane needs besides the pointers, passed by value (the kernel
// parameter space holds it). The joint batch's dimensions are in the
// wrapper's order, size-1 dimensions dropped: the first `ngroup` index the
// trees' groups, the rest a group's members.
struct Params {
  int ndim, ngroup;
  int n;                      // rows per tree
  int nvar;                   // data variables per lane
  int var_start;              // first variable opcode
  int lanes, members, max_groups;
  int block;                  // lanes a block runs (<= kThreads)
  unsigned shape[kMaxDims];
  int64_t tree[kMaxDims];     // element strides of ops and c2 over the batch
  int64_t cst[kMaxDims];      // ... of const
  int64_t data[kMaxDims];     // ... of data
  int64_t out[kMaxDims];      // ... of a lane's outputs (the batch, row-major)
  int devop[kMaxOps];         // opcode - kOpStart -> device op id
};

// The block's shared memory.
struct Shared {
  Row* rows;        // max_groups trees of n rows, n + 1 apart
  int64_t* toff;    // each group's element offset in ops and c2
  int64_t* coff;    // ... in const
  int* start;       // each group's first live row
  float* x;         // (nvar + 1) x kThreads: the lanes' data, column nvar 0
  float* dd;        // (nvar + 1) x kThreads: the lanes' ddata (backward)
};

MTGP_HD inline size_t shared_bytes(const Params& p, bool bwd) {
  const size_t g = p.max_groups;
  return g * (p.n + 1) * sizeof(Row) + g * (2 * sizeof(int64_t) + sizeof(int)) +
         (bwd ? 2 : 1) * static_cast<size_t>(p.nvar + 1) * kThreads * sizeof(float);
}

MTGP_HD inline Shared carve(const Params& p, void* base, bool bwd) {
  Shared s;
  s.rows = static_cast<Row*>(base);
  s.toff = reinterpret_cast<int64_t*>(s.rows + p.max_groups * (p.n + 1));
  s.coff = s.toff + p.max_groups;
  s.start = reinterpret_cast<int*>(s.coff + p.max_groups);
  s.x = reinterpret_cast<float*>(s.start + p.max_groups);
  s.dd = bwd ? s.x + (p.nvar + 1) * kThreads : nullptr;
  return s;
}

// The lanes [first, first + lanes) of block b and the groups they span;
// `lanes` is what block_lanes gives.
struct Block {
  int first, g0, ngroups, lanes;
};

// Lanes a block of instance N runs: kThreads up to 256 rows (a constant of
// the instance), p.block past it.
template <int N>
MTGP_HD inline int block_lanes(const Params& p) {
  return N > kMaxNodes ? p.block : kThreads;
}

MTGP_HD inline Block block_of(const Params& p, int b, int lanes) {
  const int first = b * lanes;
  const int last = (first + lanes < p.lanes ? first + lanes : p.lanes) - 1;
  return Block{first, first / p.members, last / p.members - first / p.members + 1, lanes};
}

MTGP_HD inline int blocks(const Params& p) { return (p.lanes + p.block - 1) / p.block; }

MTGP_HD inline void shared_min(int* at, int v) {
#ifdef __CUDA_ARCH__
  atomicMin(at, v);
#else
  if (v < *at) *at = v;
#endif
}

// Thread q: group g0 + q's offsets in ops / c2 and const.
MTGP_HD inline void stage_group(const Params& p, const Block& b, int q, const Shared& s) {
  if (q >= b.ngroups) return;
  unsigned g = b.g0 + q;
  int64_t t = 0, c = 0;
  for (int k = p.ngroup - 1; k >= 0; --k) {
    const unsigned i = g % p.shape[k];
    g /= p.shape[k];
    t += i * p.tree[k];
    c += i * p.cst[k];
  }
  s.toff[q] = t;
  s.coff[q] = c;
  s.start[q] = p.n;
}

// Thread t: row t % n of group t / n, loaded (its three words at once) and
// decoded.
MTGP_HD inline void stage_row(const Params& p, int t, const int* ops, const int* c2,
                              const float* cst, const Shared& s) {
  const int q = t / p.n, i = t - q * p.n;
  const int op = ops[s.toff[q] + i], second = c2[s.toff[q] + i];
  const float c = cst[s.coff[q] + i];
  int meta = kLeafVar | p.nvar << 2;  // EMPTY and unknown rows read the zero column
  if (op == kConst) {
    meta = kLeafConst;
  } else if (op >= p.var_start) {
    const int var = op - p.var_start;  // a variable past the data's width reads 0
    meta = kLeafVar | (var < p.nvar ? var : p.nvar) << 2;
  } else if (op >= kOpStart) {
    const int id = p.devop[op - kOpStart];
    meta = is_unary(id) ? kUnary | id << 2
                        : kBinary | id << 2 | (second >= 0 && second < i ? second + 1 : 0) << 16;
  }
  s.rows[q * (p.n + 1) + i] = Row{meta, op == kConst ? c : 0.0f};
  if (op != kEmpty) shared_min(s.start + q, i);
}

// Where lane `lane` (in the wrapper's order) reads its data and writes its
// outputs, and its group.
struct LaneAt {
  int group;
  int64_t data, out;
};

MTGP_HD inline LaneAt lane_at(const Params& p, int lane) {
  unsigned m = lane % p.members, g = lane / p.members;
  LaneAt at{static_cast<int>(g), 0, 0};
  for (int k = p.ndim - 1; k >= p.ngroup; --k) {
    const unsigned i = m % p.shape[k];
    m /= p.shape[k];
    at.data += i * p.data[k];
    at.out += i * p.out[k];
  }
  for (int k = p.ngroup - 1; k >= 0; --k) {
    const unsigned i = g % p.shape[k];
    g /= p.shape[k];
    at.data += i * p.data[k];
    at.out += i * p.out[k];
  }
  return at;
}

// The first phase of thread tid: a group's offsets (tid < ngroups), and its
// lane's place in the batch and data column (and zeroed ddata column, for
// the VJP), so the data's loads overlap the block's first barrier; group -1
// past the last lane.
MTGP_HD inline LaneAt stage_lane(const Params& p, const Block& b, int tid, const float* data,
                                 const Shared& s) {
  stage_group(p, b, tid, s);
  const int lane = b.first + tid;
  if (tid >= b.lanes || lane >= p.lanes) return LaneAt{-1, 0, 0};
  const LaneAt at = lane_at(p, lane);
  for (int v = 0; v < p.nvar; ++v) s.x[v * kThreads + tid] = data[at.data + v];
  s.x[p.nvar * kThreads + tid] = 0.0f;
  if (s.dd)
    for (int v = 0; v <= p.nvar; ++v) s.dd[v * kThreads + tid] = 0.0f;
  return at;
}

MTGP_HD inline void put(float& e, float v) { e = v; }
MTGP_HD inline void put(Tape& e, float v) { e = Tape{v, 0.0f}; }
MTGP_HD inline float value(float e) { return e; }
MTGP_HD inline float value(const Tape& e) { return e.v; }

// Rows start..n-1 of one tree on the lane's data column xs (stride `stride`),
// each row's value into tape[i]; returns the root (0 for an empty tree). U =
// false compiles the unary rows out (tree_prog.cuh row_step).
template <bool U, typename E>
MTGP_HD inline float forward_rows(int n, const Row* rows, int start, const float* xs, int stride,
                                  E* tape) {
  float v = 0.0f;  // row i-1, the first operand
  for (int i = start; i < n; ++i) {
    const Row w = rows[i];
    const int kind = w.meta & 3, arg = (w.meta >> 2) & 63, sec = w.meta >> 16;
    const float x = v;
    const float y = sec > start ? value(tape[sec - 1]) : 0.0f;
    float r = arg == kAdd ? x + y : arg == kSub ? x - y : x * y;
    if (kind == kBinary && arg == kDiv) r = x / y;
#ifdef MTGP_EXT_OPS
    if (kind == kBinary && arg >= kPow) r = apply_binary(arg, x, y);
#endif
    if (U && kind == kUnary) r = apply_unary(arg, x);
    const float leaf = kind == kLeafVar ? xs[arg * stride] : w.c;
    v = kind >= kBinary ? r : leaf;
    put(tape[i], v);
  }
  return v;
}

#ifdef MTGP_EXT_OPS
// tanh_backward(g, r) = g * (1 - r * r): PyTorch's CUDA kernel is built with
// contraction, which makes its 1 - r * r one fused multiply-add; the same here,
// explicitly (-fmad=false keeps a written fmaf)
MTGP_HD inline float tanh_grad(float r) { return fmaf(-r, r, 1.0f); }

// The extended build's cotangents, autograd's formulas
// (tools/autograd/derivatives.yaml, and pow_backward for torch.square's
// pow(x, 2)) on the row's operand x and its value r: the unary rows' dx
// (for sin and cos, as below)...
MTGP_HD inline float unary_vjp(int id, float g, float x, float r) {
#ifdef MTGP_USER_OPS
  if (id >= kUserFrom) {  // the generated VJP, which recomputes what it needs from x
    float dx;
    mtgp_user::vjp_unary(id - kUserFrom, g, x, dx);
    return dx;
  }
#endif
  switch (id) {
    case kSin: return g * cosf(x);
    case kCos: return g * -sinf(x);
    case kExp: return g * r;
    case kLog: return g / x;
    case kSqrt: return g / (2.0f * r);
    case kTanh: return g * tanh_grad(r);
    case kTan: return g * (1.0f + r * r);
    case kAbs: return g * static_cast<float>((0.0f < x) - (x < 0.0f));  // sgn, 0 at 0 and NaN
    case kNeg: return -g;
    default: return g * (2.0f * x);  // kSquare
  }
}

// ... and the binary ones' (dx, dy): pow_backward_self / pow_backward_exponent
// (0 where the exponent is 0, and where the base is 0 and the exponent
// >= 0), maximum / minimum (half to each on a tie).
MTGP_HD inline void binary_vjp(int id, float g, float x, float y, float r, float& dx, float& dy) {
#ifdef MTGP_USER_OPS
  if (id >= kUserFrom) {  // the generated VJP, which recomputes what it needs from x, y
    mtgp_user::vjp_binary(id - kUserFrom, g, x, y, dx, dy);
    return;
  }
#endif
  if (id == kPow) {
    dx = y == 0.0f ? 0.0f : g * (y * powf(x, y - 1.0f));
    dy = g * (x == 0.0f && y >= 0.0f ? 0.0f : r * logf(x));
    return;
  }
  const float share = x == y ? g / 2.0f : g;
  const bool x_loses = id == kMax ? x < y : x > y;
  const bool y_loses = id == kMax ? x > y : x < y;
  dx = x_loses ? 0.0f : share;
  dy = y_loses ? 0.0f : share;
}
#endif

// The top-down sweep of one lane from the root's cotangent g over the tape
// that forward_rows filled: dconst rows (stride L) and the ddata column dd.
// Cotangents of (x, y): PyTorch autograd's formulas for add, sub, mul and true
// division, and for sin (g * cos(x)) and cos (g * -sin(x)); the extended
// build's rows read their own value from the tape (exp, sqrt, tanh, tan, pow
// use the result).
template <bool U>
MTGP_HD inline void backward_rows(int n, const Row* rows, int start, float g, Tape* tape,
                                  float* dd, int stride, float* dconst, int64_t L) {
  for (int i = n - 1; i >= start; --i) {
    const Row w = rows[i];
    const int kind = w.meta & 3, arg = (w.meta >> 2) & 63, sec = w.meta >> 16;
    const Tape below = i > start ? tape[i - 1] : Tape{0.0f, 0.0f};
    const float x = below.v;
    const float y = sec > start ? tape[sec - 1].v : 0.0f;
    float dx = arg == kMul ? g * y : g;
    float dy = arg == kAdd ? g : arg == kSub ? -g : g * x;
    if (kind == kBinary && arg == kDiv) {
      dx = g / y;
      dy = -g * ((x / y) / y);
    }
#ifdef MTGP_EXT_OPS
    if (kind == kBinary && arg >= kPow) binary_vjp(arg, g, x, y, tape[i].v, dx, dy);
    if (U && kind == kUnary) dx = unary_vjp(arg, g, x, tape[i].v);
#else
    if (U && kind == kUnary) dx = arg == kSin ? g * cosf(x) : g * -sinf(x);
#endif
    float next = below.g;  // row i-1's cotangent from the rows above row i
    if (kind >= kBinary) {
      next = next + dx;
      if (sec > start) {
        if (sec == i) next = next + dy;  // c2 == i-1
        else tape[sec - 1].g += dy;
      }
    }
    if (kind == kLeafVar) dd[arg * stride] += g;
    dconst[i * L] = kind == kLeafConst ? g : 0.0f;
    g = next;
  }
  for (int i = 0; i < start; ++i) dconst[i * L] = 0.0f;
}

// Thread tid's lane (at, from stage_lane) of block b: its root value into out.
template <int N, bool U>
MTGP_HD inline void forward_lane(const Params& p, const Block& b, int tid, const LaneAt& at,
                                 float* out, const Shared& s) {
  if (at.group < 0) return;
  const int q = at.group - b.g0;
  float vals[N];
  out[at.out] =
      forward_rows<U>(p.n, s.rows + q * (p.n + 1), s.start[q], s.x + tid, kThreads, vals);
}

// Thread tid's lane of block b: dconst (n, L) and ddata (nvar, L), lane-minor.
template <int N, bool U>
MTGP_HD inline void backward_lane(const Params& p, const Block& b, int tid, const LaneAt& at,
                                  const float* g, float* dconst, float* ddata, const Shared& s) {
  if (at.group < 0) return;
  const float* xs = s.x + tid;
  float* dd = s.dd + tid;
  const int q = at.group - b.g0;
  const Row* rows = s.rows + q * (p.n + 1);
  Tape tape[N];
  forward_rows<U>(p.n, rows, s.start[q], xs, kThreads, tape);
  backward_rows<U>(p.n, rows, s.start[q], g[at.out], tape, dd, kThreads, dconst + at.out, p.lanes);
  for (int v = 0; v < p.nvar; ++v) ddata[v * static_cast<int64_t>(p.lanes) + at.out] = dd[v * kThreads];
}

// ---------------------------------------------------------------------------
// The wide instance (see the top of the file).

// A decoded row: `meta` holds the kind (bits 0-1) and the device op id or
// data slot (bits 2-31); `word` c2 + 1 on a binary row whose second operand
// is row c2 (else 0), the constant's bits on a CONST row.
struct alignas(8) WideRow {
  int meta;
  int word;
};

// The layout, the whole op table, and this launch's lanes.
struct WideParams {
  Params p;                // p.devop unused; p.block == kThreads
  int op[kDeviceOps];      // opcode - kOpStart -> device op id
  int64_t lane0;           // the launch's first lane (a multiple of kThreads)
  int64_t count;           // its lanes: the scratch's row stride
  int chunk;               // rows a block stages at once
};

struct WideShared {
  WideRow* rows;    // max_groups chunks of `chunk` rows
  int64_t* toff;    // each group's element offset in ops and c2
  int64_t* coff;    // ... in const
  int* start;       // each group's first live row (n until staged)
};

MTGP_HD inline size_t wide_shared_bytes(const WideParams& w) {
  const size_t g = w.p.max_groups;
  return g * w.chunk * sizeof(WideRow) + g * (2 * sizeof(int64_t) + sizeof(int));
}

MTGP_HD inline WideShared wide_carve(const WideParams& w, void* base) {
  WideShared s;
  s.rows = static_cast<WideRow*>(base);
  s.toff = reinterpret_cast<int64_t*>(s.rows + w.p.max_groups * w.chunk);
  s.coff = s.toff + w.p.max_groups;
  s.start = reinterpret_cast<int*>(s.coff + w.p.max_groups);
  return s;
}

MTGP_HD inline float bits_float(int b) {
#ifdef __CUDA_ARCH__
  return __int_as_float(b);
#else
  float f;
  memcpy(&f, &b, sizeof f);
  return f;
#endif
}

MTGP_HD inline int float_bits(float f) {
#ifdef __CUDA_ARCH__
  return __float_as_int(f);
#else
  int b;
  memcpy(&b, &f, sizeof b);
  return b;
#endif
}

// Block b of the launch (b counted from lane 0 of the batch).
MTGP_HD inline Block wide_block(const WideParams& w, int64_t b) {
  return block_of(w.p, static_cast<int>(b), kThreads);
}

// The first phase of thread tid: a group's offsets (tid < ngroups) and its
// lane's place; group -1 past the launch's last lane.
MTGP_HD inline LaneAt wide_lane(const WideParams& w, const Block& b, int tid,
                                const WideShared& s) {
  stage_group(w.p, b, tid, Shared{nullptr, s.toff, s.coff, s.start, nullptr, nullptr});
  const int64_t lane = static_cast<int64_t>(b.first) + tid;
  if (lane >= w.p.lanes || lane >= w.lane0 + w.count) return LaneAt{-1, 0, 0};
  return lane_at(w.p, static_cast<int>(lane));
}

// Thread t's row of the chunk [c0, c0 + len): row c0 + t % len of group
// t / len, decoded; a padding row reads its opcode alone. With `find`, a
// live row lowers its group's first live row.
MTGP_HD inline void wide_stage_row(const WideParams& w, int t, int c0, int len, bool find,
                                   const int* ops, const int* c2, const float* cst,
                                   const WideShared& s) {
  const int q = t / len, i = c0 + t - q * len;
  const int64_t at = s.toff[q] + i;
  const int op = ops[at];
  int meta = kLeafVar | w.p.nvar << 2, word = 0;  // EMPTY and unknown rows read 0
  if (op == kConst) {
    meta = kLeafConst;
    word = float_bits(cst[s.coff[q] + i]);
  } else if (op >= w.p.var_start) {
    const int var = op - w.p.var_start;  // a variable past the data's width reads 0
    meta = kLeafVar | (var < w.p.nvar ? var : w.p.nvar) << 2;
  } else if (op >= kOpStart) {
    const int id = w.op[op - kOpStart];
    if (is_unary(id)) {
      meta = kUnary | id << 2;
    } else {
      const int second = c2[at];
      meta = kBinary | id << 2;
      word = second >= 0 && second < i ? second + 1 : 0;
    }
  }
  s.rows[q * w.chunk + (i - c0)] = WideRow{meta, word};
  if (find && op != kEmpty) shared_min(s.start + q, i);
}

// Rows max(from, start)..to-1 of one tree, continuing from the first operand
// v (row from-1's value), each row's value into tape[i * stride]; the lane's
// data is x[0..nvar). forward_rows' operations, row for row (written apart
// from it, and wide_backward_rows from backward_rows, so that the fixed
// instances compile to the code they did).
template <bool U, typename E>
MTGP_HD inline float wide_forward_rows(int from, int to, const WideRow* rows, int start,
                                       const float* x, int nvar, E* tape, int64_t stride,
                                       float v) {
  for (int i = from > start ? from : start; i < to; ++i) {
    const WideRow w = rows[i - from];
    const int kind = w.meta & 3, arg = w.meta >> 2, sec = kind == kBinary ? w.word : 0;
    const float xv = v;
    const float y = sec > start ? value(tape[(sec - 1) * stride]) : 0.0f;
    float r = arg == kAdd ? xv + y : arg == kSub ? xv - y : xv * y;
    if (kind == kBinary && arg == kDiv) r = xv / y;
#ifdef MTGP_EXT_OPS
    if (kind == kBinary && arg >= kPow) r = apply_binary(arg, xv, y);
#endif
    if (U && kind == kUnary) r = apply_unary(arg, xv);
    const float leaf = kind == kLeafVar ? (arg < nvar ? x[arg] : 0.0f) : bits_float(w.word);
    v = kind >= kBinary ? r : leaf;
    put(tape[i * stride], v);
  }
  return v;
}

// Rows to-1 down to max(from, start) of the sweep from row to-1's cotangent
// g; returns row from-1's: backward_rows' operations, row for row, with
// ddata accumulated in dd[v * L] (the zero column's dropped) and dconst[i *
// L] written.
template <bool U>
MTGP_HD inline float wide_backward_rows(int from, int to, const WideRow* rows, int start,
                                        float g, Tape* tape, int64_t stride, int nvar,
                                        float* dd, float* dconst, int64_t L) {
  for (int i = to - 1; i >= (from > start ? from : start); --i) {
    const WideRow w = rows[i - from];
    const int kind = w.meta & 3, arg = w.meta >> 2, sec = kind == kBinary ? w.word : 0;
    const Tape below = i > start ? tape[(i - 1) * stride] : Tape{0.0f, 0.0f};
    const float x = below.v;
    const float y = sec > start ? tape[(sec - 1) * stride].v : 0.0f;
    float dx = arg == kMul ? g * y : g;
    float dy = arg == kAdd ? g : arg == kSub ? -g : g * x;
    if (kind == kBinary && arg == kDiv) {
      dx = g / y;
      dy = -g * ((x / y) / y);
    }
#ifdef MTGP_EXT_OPS
    if (kind == kBinary && arg >= kPow) binary_vjp(arg, g, x, y, tape[i * stride].v, dx, dy);
    if (U && kind == kUnary) dx = unary_vjp(arg, g, x, tape[i * stride].v);
#else
    if (U && kind == kUnary) dx = arg == kSin ? g * cosf(x) : g * -sinf(x);
#endif
    float next = below.g;
    if (kind >= kBinary) {
      next = next + dx;
      if (sec > start) {
        if (sec == i) next = next + dy;  // c2 == i-1
        else tape[(sec - 1) * stride].g += dy;
      }
    }
    if (kind == kLeafVar && arg < nvar) dd[arg * L] += g;
    dconst[i * L] = kind == kLeafConst ? g : 0.0f;
    g = next;
  }
  return g;
}

// Thread tid's lane (at) over the staged chunk [c0, c1): the forward's next
// rows into its scratch column, continuing from v.
template <bool U, typename E>
MTGP_HD inline float wide_forward_chunk(const WideParams& w, const Block& b, int tid,
                                        const LaneAt& at, int c0, int c1, float v,
                                        const float* data, E* scratch, const WideShared& s) {
  if (at.group < 0) return v;
  const int q = at.group - b.g0;
  const int64_t col = b.first + tid - w.lane0;
  return wide_forward_rows<U>(c0, c1, s.rows + q * w.chunk, s.start[q], data + at.data,
                              w.p.nvar, scratch + col, w.count, v);
}

// ... and the sweep's rows of the chunk, from the cotangent g of row c1-1.
template <bool U>
MTGP_HD inline float wide_backward_chunk(const WideParams& w, const Block& b, int tid,
                                         const LaneAt& at, int c0, int c1, float g,
                                         Tape* scratch, float* dconst, float* ddata,
                                         const WideShared& s) {
  if (at.group < 0) return g;
  const int q = at.group - b.g0;
  const int64_t col = b.first + tid - w.lane0;
  return wide_backward_rows<U>(c0, c1, s.rows + q * w.chunk, s.start[q], g, scratch + col,
                               w.count, w.p.nvar, ddata + at.out, dconst + at.out, w.p.lanes);
}

// The lowest first live row of the block's groups (the backward's last chunk).
MTGP_HD inline int wide_block_start(const WideParams& w, const Block& b, const WideShared& s) {
  int lo = w.p.n;
  for (int q = 0; q < b.ngroups; ++q) lo = s.start[q] < lo ? s.start[q] : lo;
  return lo;
}

// Thread tid's lane before the backward's sweep: its ddata column zeroed
// (the sweep accumulates into it); after it, dconst of the rows below its
// tree's first live row.
MTGP_HD inline void wide_zero_ddata(const WideParams& w, const LaneAt& at, float* ddata) {
  if (at.group < 0) return;
  for (int v = 0; v < w.p.nvar; ++v) ddata[v * static_cast<int64_t>(w.p.lanes) + at.out] = 0.0f;
}

MTGP_HD inline void wide_zero_below(const WideParams& w, const Block& b, const LaneAt& at,
                                    float* dconst, const WideShared& s) {
  if (at.group < 0) return;
  const int start = s.start[at.group - b.g0];
  for (int i = 0; i < start; ++i) dconst[i * static_cast<int64_t>(w.p.lanes) + at.out] = 0.0f;
}

#ifdef __CUDACC__
template <int N, bool U>
__global__ void __launch_bounds__(kThreads)
    interpret_fwd_kernel(Params p, const int* __restrict__ ops, const int* __restrict__ c2,
                         const float* __restrict__ cst, const float* __restrict__ data,
                         float* __restrict__ out) {
  extern __shared__ int64_t smem[];
  const Shared s = carve(p, smem, false);
  const Block b = block_of(p, blockIdx.x, block_lanes<N>(p));
  const LaneAt at = stage_lane(p, b, threadIdx.x, data, s);
  __syncthreads();
  for (int t = threadIdx.x; t < b.ngroups * p.n; t += kThreads) stage_row(p, t, ops, c2, cst, s);
  __syncthreads();
  forward_lane<N, U>(p, b, threadIdx.x, at, out, s);
}

template <int N, bool U>
__global__ void __launch_bounds__(kThreads)
    interpret_bwd_kernel(Params p, const int* __restrict__ ops, const int* __restrict__ c2,
                         const float* __restrict__ cst, const float* __restrict__ data,
                         const float* __restrict__ g, float* __restrict__ dconst,
                         float* __restrict__ ddata) {
  extern __shared__ int64_t smem[];
  const Shared s = carve(p, smem, true);
  const Block b = block_of(p, blockIdx.x, block_lanes<N>(p));
  const LaneAt at = stage_lane(p, b, threadIdx.x, data, s);
  __syncthreads();
  for (int t = threadIdx.x; t < b.ngroups * p.n; t += kThreads) stage_row(p, t, ops, c2, cst, s);
  __syncthreads();
  backward_lane<N, U>(p, b, threadIdx.x, at, g, dconst, ddata, s);
}

// The wide instance's kernels: a block stages its groups' rows a chunk at a
// time between barriers; the forward runs each chunk as it is staged, the
// VJP runs the forward into its tape, then the sweep top-down over the
// chunks again (the top one is still staged).
template <bool U>
__global__ void __launch_bounds__(kThreads)
    interpret_fwd_wide(const __grid_constant__ WideParams w, const int* __restrict__ ops,
                       const int* __restrict__ c2, const float* __restrict__ cst,
                       const float* __restrict__ data, float* __restrict__ out,
                       float* __restrict__ scratch) {
  extern __shared__ int64_t smem[];
  const WideShared s = wide_carve(w, smem);
  const Block b = wide_block(w, w.lane0 / kThreads + blockIdx.x);
  const LaneAt at = wide_lane(w, b, threadIdx.x, s);
  float v = 0.0f;
  for (int c0 = 0; c0 < w.p.n; c0 += w.chunk) {
    const int c1 = c0 + w.chunk < w.p.n ? c0 + w.chunk : w.p.n;
    __syncthreads();
    for (int t = threadIdx.x; t < b.ngroups * (c1 - c0); t += kThreads)
      wide_stage_row(w, t, c0, c1 - c0, true, ops, c2, cst, s);
    __syncthreads();
    v = wide_forward_chunk<U>(w, b, threadIdx.x, at, c0, c1, v, data, scratch, s);
  }
  if (at.group >= 0) out[at.out] = v;
}

template <bool U>
__global__ void __launch_bounds__(kThreads)
    interpret_bwd_wide(const __grid_constant__ WideParams w, const int* __restrict__ ops,
                       const int* __restrict__ c2, const float* __restrict__ cst,
                       const float* __restrict__ data, const float* __restrict__ g,
                       float* __restrict__ dconst, float* __restrict__ ddata,
                       Tape* __restrict__ scratch) {
  extern __shared__ int64_t smem[];
  const WideShared s = wide_carve(w, smem);
  const Block b = wide_block(w, w.lane0 / kThreads + blockIdx.x);
  const LaneAt at = wide_lane(w, b, threadIdx.x, s);
  wide_zero_ddata(w, at, ddata);
  float v = 0.0f;
  const int last = (w.p.n - 1) / w.chunk * w.chunk;  // the top chunk's first row
  for (int c0 = 0; c0 < w.p.n; c0 += w.chunk) {
    const int c1 = c0 + w.chunk < w.p.n ? c0 + w.chunk : w.p.n;
    __syncthreads();
    for (int t = threadIdx.x; t < b.ngroups * (c1 - c0); t += kThreads)
      wide_stage_row(w, t, c0, c1 - c0, true, ops, c2, cst, s);
    __syncthreads();
    v = wide_forward_chunk<U>(w, b, threadIdx.x, at, c0, c1, v, data, scratch, s);
  }
  float cot = at.group >= 0 ? g[at.out] : 0.0f;
  const int lo = wide_block_start(w, b, s);
  for (int c0 = last; c0 >= 0 && c0 + w.chunk > lo; c0 -= w.chunk) {
    const int c1 = c0 + w.chunk < w.p.n ? c0 + w.chunk : w.p.n;
    if (c0 != last) {
      __syncthreads();
      for (int t = threadIdx.x; t < b.ngroups * (c1 - c0); t += kThreads)
        wide_stage_row(w, t, c0, c1 - c0, false, ops, c2, cst, s);
      __syncthreads();
    }
    cot = wide_backward_chunk<U>(w, b, threadIdx.x, at, c0, c1, cot, scratch, dconst, ddata, s);
  }
  wide_zero_below(w, b, at, dconst, s);
}

// Launch `kernel` on `stream` with the block's shared memory, opting in
// above 48 KB (at N = 256 a block whose lanes share no tree stages 64 KB at
// 32 lanes; at N = 1024, 131 KB at 16); returns cudaGetLastError() of the
// launch.
template <typename Kernel, typename... Args>
int launch(Kernel kernel, const Params& p, bool bwd, void* stream, Args... args) {
  const size_t smem = shared_bytes(p, bwd);
  if (smem > 48 * 1024) {
    const cudaError_t e = cudaFuncSetAttribute(
        kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, static_cast<int>(smem));
    if (e != cudaSuccess) return static_cast<int>(e);
  }
  kernel<<<blocks(p), kThreads, smem, static_cast<cudaStream_t>(stream)>>>(p, args...);
  return static_cast<int>(cudaGetLastError());
}
#endif

// Reads the layout words into w (w->p the fixed instances' Params, w->op
// the whole op table; the launch's lanes are set by the caller), and the
// header's `unary` and `wide`; returns 1 on words the kernels do not take.
int make_params(const int64_t* words, WideParams* w, int* unary, int* wide) {
  Params* p = &w->p;
  const int64_t ndim = words[0], ngroup = words[1], n = words[2], nvar = words[3],
                var_start = words[4], nops = words[5];
  *unary = words[6] != 0;
  *wide = words[7] != 0;
  if (ndim < 0 || ndim > kMaxDims || ngroup < 0 || ngroup > ndim || n <= 0 ||
      n >= 0x7fffffff || nvar < 0 || nvar > kWideMaxVars || nops < 0 || nops > kDeviceOps ||
      var_start != kOpStart + nops)
    return 1;
  if (!*wide && (n > kMaxRows || nvar > kRowVars || nops > kMaxOps)) return 1;
  p->ndim = static_cast<int>(ndim);
  p->ngroup = static_cast<int>(ngroup);
  p->n = static_cast<int>(n);
  p->nvar = static_cast<int>(nvar);
  p->var_start = static_cast<int>(var_start);
  int64_t lanes = 1, members = 1;
  for (int k = 0; k < kMaxDims; ++k) {
    const int64_t size = words[kHeader + k];
    p->shape[k] = static_cast<unsigned>(size);
    p->tree[k] = words[kHeader + kMaxDims + k];
    p->cst[k] = words[kHeader + 2 * kMaxDims + k];
    p->data[k] = words[kHeader + 3 * kMaxDims + k];
    p->out[k] = words[kHeader + 4 * kMaxDims + k];
    if (k < ndim) {
      if (size <= 0 || size > 0x7fffffff) return 1;
      lanes *= size;
      if (k >= ngroup) members *= size;
      if (lanes > 0x7fffffff) return 1;
    }
  }
  for (int k = 0; k < kDeviceOps; ++k) {
    w->op[k] = k < nops ? static_cast<int>(words[kHeader + 5 * kMaxDims + k]) : 0;
    if (k < nops && (w->op[k] < kAdd || w->op[k] > kLastOp)) return 1;
    if (k < kMaxOps) p->devop[k] = w->op[k];
  }
  p->lanes = static_cast<int>(lanes);
  p->members = static_cast<int>(members);
  const int64_t groups = lanes / members;
  if (*wide) {  // 32 lanes a block, their rows staged `chunk` at a time
    const int64_t span = (kThreads - 1) / members + 2, mg = kThreads < groups ? kThreads : groups;
    p->block = kThreads;
    p->max_groups = static_cast<int>(span < mg ? span : mg);
    const int64_t chunk = kWideStage / (sizeof(WideRow) * p->max_groups);
    w->chunk = static_cast<int>(chunk < n ? chunk : n);
    return 0;
  }
  // the most lanes a block can run with its groups' rows staged (both
  // kernels: the VJP's staging is the larger)
  for (int block = kThreads; block >= 1; block /= 2) {
    const int64_t span = (block - 1) / members + 2, mg = block < groups ? block : groups;
    p->block = block;
    p->max_groups = static_cast<int>(span < mg ? span : mg);
    // up to 256 rows every layout fits at kThreads (block_lanes relies on it)
    if (shared_bytes(*p, true) <= kMaxShared) return n > kMaxNodes || block == kThreads ? 0 : 1;
  }
  return 1;
}

// The launch's lanes [lane0, lane0 + count): the whole batch for the fixed
// instances; for the wide one a run of whole blocks (the last may end the
// batch) with its scratch. Returns 1 on a range the instance does not take.
int set_lanes(WideParams* w, int wide, const void* scratch, int64_t lane0, int64_t count) {
  w->lane0 = lane0;
  w->count = count;
  if (!wide) return lane0 != 0 || count != w->p.lanes;
  return scratch == nullptr || lane0 < 0 || lane0 % kThreads != 0 || count <= 0 ||
         lane0 + count > w->p.lanes || (lane0 + count < w->p.lanes && count % kThreads != 0);
}

#ifdef __CUDACC__
// The wide instance's launch: the launch's blocks, its shared memory
// (within 48 KB: kWideStage of rows).
template <typename Kernel, typename... Args>
int launch_wide(Kernel kernel, const WideParams& w, void* stream, Args... args) {
  const int64_t grid = (w.count + kThreads - 1) / kThreads;
  kernel<<<static_cast<unsigned>(grid), kThreads, wide_shared_bytes(w),
           static_cast<cudaStream_t>(stream)>>>(w, args...);
  return static_cast<int>(cudaGetLastError());
}
#else
// The host build's launch: each block's phases run their threads one after
// the other; returns 1 on bad arguments.
template <typename LaneFn>
int host_blocks(const int* ops, const int* c2, const float* cst, const float* data,
                const Params& p, bool bwd, bool unary, LaneFn lane_fn) {
  std::vector<int64_t> smem((shared_bytes(p, bwd) + 7) / 8);
  const Shared s = carve(p, smem.data(), bwd);
  std::vector<LaneAt> at(kThreads);
  for (int blk = 0; blk < blocks(p); ++blk) {
    const Block b = block_of(p, blk, p.block);
    for (int tid = 0; tid < kThreads; ++tid) at[tid] = stage_lane(p, b, tid, data, s);
    for (int t = 0; t < b.ngroups * p.n; ++t) stage_row(p, t, ops, c2, cst, s);
    for (int tid = 0; tid < kThreads; ++tid) lane_fn(p, b, tid, at[tid], s, unary);
  }
  return 0;
}

// ... and of the wide instance: per block of the launch, each chunk's
// staging, then its rows thread by thread; `sweep` also runs the VJP's
// top-down pass over the chunks.
template <bool U>
void host_wide(const WideParams& w, const int* ops, const int* c2, const float* cst,
               const float* data, float* out, const float* g, float* dconst, float* ddata,
               void* scratch) {
  std::vector<int64_t> smem((wide_shared_bytes(w) + 7) / 8);
  const WideShared s = wide_carve(w, smem.data());
  std::vector<LaneAt> at(kThreads);
  std::vector<float> v(kThreads), cot(kThreads);
  const bool sweep = g != nullptr;
  const int n = w.p.n, last = (n - 1) / w.chunk * w.chunk;
  const int64_t first = w.lane0 / kThreads, end = first + (w.count + kThreads - 1) / kThreads;
  for (int64_t blk = first; blk < end; ++blk) {
    const Block b = wide_block(w, blk);
    for (int tid = 0; tid < kThreads; ++tid) {
      at[tid] = wide_lane(w, b, tid, s);
      v[tid] = 0.0f;
      if (sweep) wide_zero_ddata(w, at[tid], ddata);
    }
    for (int c0 = 0; c0 < n; c0 += w.chunk) {
      const int c1 = c0 + w.chunk < n ? c0 + w.chunk : n;
      for (int t = 0; t < b.ngroups * (c1 - c0); ++t)
        wide_stage_row(w, t, c0, c1 - c0, true, ops, c2, cst, s);
      for (int tid = 0; tid < kThreads; ++tid)
        v[tid] = sweep ? wide_forward_chunk<U>(w, b, tid, at[tid], c0, c1, v[tid], data,
                                                static_cast<Tape*>(scratch), s)
                       : wide_forward_chunk<U>(w, b, tid, at[tid], c0, c1, v[tid], data,
                                                static_cast<float*>(scratch), s);
    }
    if (!sweep) {
      for (int tid = 0; tid < kThreads; ++tid)
        if (at[tid].group >= 0) out[at[tid].out] = v[tid];
      continue;
    }
    for (int tid = 0; tid < kThreads; ++tid) cot[tid] = at[tid].group >= 0 ? g[at[tid].out] : 0.0f;
    const int lo = wide_block_start(w, b, s);
    for (int c0 = last; c0 >= 0 && c0 + w.chunk > lo; c0 -= w.chunk) {
      const int c1 = c0 + w.chunk < n ? c0 + w.chunk : n;
      if (c0 != last)
        for (int t = 0; t < b.ngroups * (c1 - c0); ++t)
          wide_stage_row(w, t, c0, c1 - c0, false, ops, c2, cst, s);
      for (int tid = 0; tid < kThreads; ++tid)
        cot[tid] = wide_backward_chunk<U>(w, b, tid, at[tid], c0, c1, cot[tid],
                                          static_cast<Tape*>(scratch), dconst, ddata, s);
    }
    for (int tid = 0; tid < kThreads; ++tid) wide_zero_below(w, b, at[tid], dconst, s);
  }
}
#endif

}  // namespace

extern "C" {

// ops/c2 int32 and cst float32 trees, data float32 vectors, each addressed
// per lane through the layout words (rows and variables contiguous).
// Forward: out (L,). Backward: g (L,) -> dconst (n, L) and ddata (nvar, L),
// lane-minor, L the joint batch in row-major order. The lanes [lane0, lane0
// + count) run: all of them (lane0 = 0, count = L) for the fixed instances;
// for the wide one (the layout's `wide` word) a run of whole blocks, with
// `scratch` the values (forward: count * n floats) or the tape (backward:
// count * n (value, cotangent) pairs) of those lanes, [row][lane].
#ifdef __CUDACC__
const char* mtgp_error_string(int status) {
  return cudaGetErrorString(static_cast<cudaError_t>(status));
}

// Launch on `stream`; return cudaGetLastError() of the launch. Instances: the
// main path's N <= 32, everything up to 256, up to kMaxRows, and the wide
// one, with unary operators or without.
int interpret_fwd(const int* ops, const int* c2, const float* cst, const float* data,
                  const int64_t* layout, float* out, float* scratch, int64_t lane0,
                  int64_t count, void* stream) {
  WideParams w;
  int unary, wide;
  if (make_params(layout, &w, &unary, &wide) || set_lanes(&w, wide, scratch, lane0, count))
    return static_cast<int>(cudaErrorInvalidValue);
  const Params& p = w.p;
  if (wide)
    return unary ? launch_wide(interpret_fwd_wide<true>, w, stream, ops, c2, cst, data, out, scratch)
                 : launch_wide(interpret_fwd_wide<false>, w, stream, ops, c2, cst, data, out, scratch);
#define MTGP_FWD(N, U) launch(interpret_fwd_kernel<N, U>, p, false, stream, ops, c2, cst, data, out)
  if (p.n <= 32) return unary ? MTGP_FWD(32, true) : MTGP_FWD(32, false);
  if (p.n <= kMaxNodes) return unary ? MTGP_FWD(kMaxNodes, true) : MTGP_FWD(kMaxNodes, false);
  return unary ? MTGP_FWD(kMaxRows, true) : MTGP_FWD(kMaxRows, false);
#undef MTGP_FWD
}

int interpret_bwd(const int* ops, const int* c2, const float* cst, const float* data,
                  const int64_t* layout, const float* g, float* dconst, float* ddata,
                  float* scratch, int64_t lane0, int64_t count, void* stream) {
  WideParams w;
  int unary, wide;
  if (make_params(layout, &w, &unary, &wide) || set_lanes(&w, wide, scratch, lane0, count))
    return static_cast<int>(cudaErrorInvalidValue);
  const Params& p = w.p;
  Tape* tape = reinterpret_cast<Tape*>(scratch);
  if (wide)
    return unary ? launch_wide(interpret_bwd_wide<true>, w, stream, ops, c2, cst, data, g, dconst,
                               ddata, tape)
                 : launch_wide(interpret_bwd_wide<false>, w, stream, ops, c2, cst, data, g, dconst,
                               ddata, tape);
#define MTGP_BWD(N, U) \
  launch(interpret_bwd_kernel<N, U>, p, true, stream, ops, c2, cst, data, g, dconst, ddata)
  if (p.n <= 32) return unary ? MTGP_BWD(32, true) : MTGP_BWD(32, false);
  if (p.n <= kMaxNodes) return unary ? MTGP_BWD(kMaxNodes, true) : MTGP_BWD(kMaxNodes, false);
  return unary ? MTGP_BWD(kMaxRows, true) : MTGP_BWD(kMaxRows, false);
#undef MTGP_BWD
}
#else
// host build of the same per-thread code (tests without a card); `stream`
// is ignored and 1 reports bad arguments
const char* mtgp_error_string(int status) {
  return status ? "invalid arguments" : "no error";
}

int interpret_fwd(const int* ops, const int* c2, const float* cst, const float* data,
                  const int64_t* layout, float* out, float* scratch, int64_t lane0,
                  int64_t count, void* stream) {
  (void)stream;
  WideParams w;
  int unary, wide;
  if (make_params(layout, &w, &unary, &wide) || set_lanes(&w, wide, scratch, lane0, count)) return 1;
  if (wide) {
    unary ? host_wide<true>(w, ops, c2, cst, data, out, nullptr, nullptr, nullptr, scratch)
          : host_wide<false>(w, ops, c2, cst, data, out, nullptr, nullptr, nullptr, scratch);
    return 0;
  }
  return host_blocks(ops, c2, cst, data, w.p, false, unary != 0,
                     [&](const Params& p, const Block& b, int tid, const LaneAt& at,
                         const Shared& s, bool unary) {
    if (p.n <= 32) unary ? forward_lane<32, true>(p, b, tid, at, out, s)
                         : forward_lane<32, false>(p, b, tid, at, out, s);
    else if (p.n <= kMaxNodes) unary ? forward_lane<kMaxNodes, true>(p, b, tid, at, out, s)
                                     : forward_lane<kMaxNodes, false>(p, b, tid, at, out, s);
    else unary ? forward_lane<kMaxRows, true>(p, b, tid, at, out, s)
               : forward_lane<kMaxRows, false>(p, b, tid, at, out, s);
  });
}

int interpret_bwd(const int* ops, const int* c2, const float* cst, const float* data,
                  const int64_t* layout, const float* g, float* dconst, float* ddata,
                  float* scratch, int64_t lane0, int64_t count, void* stream) {
  (void)stream;
  WideParams w;
  int unary, wide;
  if (make_params(layout, &w, &unary, &wide) || set_lanes(&w, wide, scratch, lane0, count)) return 1;
  if (wide) {
    unary ? host_wide<true>(w, ops, c2, cst, data, nullptr, g, dconst, ddata, scratch)
          : host_wide<false>(w, ops, c2, cst, data, nullptr, g, dconst, ddata, scratch);
    return 0;
  }
  return host_blocks(ops, c2, cst, data, w.p, true, unary != 0,
                     [&](const Params& p, const Block& b, int tid, const LaneAt& at,
                         const Shared& s, bool unary) {
    if (p.n <= 32) unary ? backward_lane<32, true>(p, b, tid, at, g, dconst, ddata, s)
                         : backward_lane<32, false>(p, b, tid, at, g, dconst, ddata, s);
    else if (p.n <= kMaxNodes)
      unary ? backward_lane<kMaxNodes, true>(p, b, tid, at, g, dconst, ddata, s)
            : backward_lane<kMaxNodes, false>(p, b, tid, at, g, dconst, ddata, s);
    else unary ? backward_lane<kMaxRows, true>(p, b, tid, at, g, dconst, ddata, s)
               : backward_lane<kMaxRows, false>(p, b, tid, at, g, dconst, ddata, s);
  });
}
#endif

}  // extern "C"
