// Fused reproduction: two children per (pair x tree) lane in one launch.
//
// Replaces the TPU kernel `_make_kernel` of
// multitreegp_tpu/core/pallas_reproduction.py (reached through
// `reproduce_pairs_pallas` -> `pl.pallas_call`), which runs
// `tile_surgery.reproduce_tiles`: crossover with bounded rejection, the
// seven-case mutation, fresh grow-sampling. It computes what
// reproduce_tiles computes, lane by lane; its plain version is
// multitreegp_tpu_torch/core/tile_surgery.py.
//
// What bounds it on this card: the latency of each lane's dependent steps
// (Gumbel draws over N rows, span walks, splices, compaction) and the
// uniforms it reads. The bytes are its two parents, its two children
// (16 N bytes) and its row of uniforms (R floats, R = 1,778 at N = 32).
//
// Design: one warp per lane. The TPU kernel worked row-parallel across a
// vector unit; a warp is the card's width for the same rows. Each lane's
// trees and blocks live in the warp's shared memory, and lane l of the warp
// owns rows [l * ceil(rows / 32), ...) of every row-wise step, so the
// serial loops of one thread become warp collectives: a Gumbel draw over
// rows is one warp argmax (ties to the highest row), a subtree span is a
// warp prefix sum of arities, compaction a prefix count and a move in shared
// memory, a splice or a block one row per thread. Control decisions (the
// action, the retry loops, the mutation case) are warp-uniform; the grow
// sampler draws every node's leaf, operator and coefficient in parallel and
// keeps only its short dependence on the open-slot count serial. A lane
// runs only the branches its action needs, as plain code: crossover only
// for crossover lanes, one mutation case, a fresh sample only when one is
// used. Randomness is a uniform buffer drawn by the wrapper, lane-major
// (L, R): lane j reads its row at the offsets at which reproduce_tiles calls
// urand, so a skipped branch still leaves every later branch on its own
// draws, kernel and plain version see the same numbers, and the 32 threads
// of a warp read neighbouring words. Parents and children are lane-major
// (L, n) as the population stores them. Child pointers are rebuilt
// afterwards in PyTorch (trees.rebuild_pointers).
//
// Numerics copy tile_surgery: Gumbel clip [1e-7, 1 - 1e-7] and
// -log(-log(u)), score log(max(w, 1e-30)) + gumbel, ties to the highest row,
// Box-Muller sqrt(-2 log(max(u1, 1e-7))) * cos(2 pi u2). Built with
// -fmad=false.
//
// The warp code is plain C++ under MTGP_HD with a host definition of its
// few collectives (a loop over the 32 lanes) and of the warp's lane loop,
// so the same file also compiles for the host (without __CUDACC__) into a
// loop over lanes that runs this very code, 32 threads' worth at a time,
// and that tests run against the plain version on machines without a card.
#include <math.h>
#include <stddef.h>
#include <stdint.h>

#ifdef __CUDACC__
#include <cuda_runtime.h>
#define MTGP_HD __host__ __device__
#else
#include <vector>
#define MTGP_HD
#endif

namespace {

constexpr int kEmpty = 0;
constexpr int kConst = 1;
constexpr int kOpStart = 2;
constexpr int kMaxNodes = 256;
constexpr int kWarp = 32;
constexpr float kNeg = -1e30f;
constexpr float kGumbelHi = static_cast<float>(1.0 - 1e-7);
constexpr float kTwoPi = 6.283185307179586f;

// mutation applicability by tree size class (tile_surgery PROBS_*), bit r
// set when mutation r applies
constexpr int kProbsDefault = 0x7f;  // 1 1 1 1 1 1 1
constexpr int kProbsFull = 0x4e;     // 0 1 1 1 0 0 1
constexpr int kProbsSmall = 0x57;    // 1 1 1 0 1 0 1
constexpr int kProbsLeaf = 0x53;     // 1 1 0 0 1 0 1

// ------------------------------------------------------------ warp model
//
// Code outside FOR_LANES is warp-uniform: every thread of the warp runs it
// with the same values (on the host it runs once). A FOR_LANES(l) body is
// the per-thread part: on the card thread l of the warp runs it once; on
// the host it runs for l = 0..31 in turn. Values cross lanes only through
// the warp's shared memory (after warp_sync) or the collectives below.

#ifdef __CUDA_ARCH__
#define FOR_LANES(l) \
  for (int l = static_cast<int>(threadIdx.x) & (kWarp - 1), l##_once = 1; l##_once; l##_once = 0)
#else
#define FOR_LANES(l) for (int l = 0; l < kWarp; ++l)
#endif

MTGP_HD inline void warp_sync() {
#ifdef __CUDA_ARCH__
  __syncwarp();
#endif
}

// one value per lane: a register on the card, 32 values on the host
template <typename T>
struct PerLane {
#ifdef __CUDA_ARCH__
  T v;
  __device__ T& operator[](int) { return v; }
  __device__ const T& operator[](int) const { return v; }
#else
  T v[kWarp];
  T& operator[](int l) { return v[l]; }
  const T& operator[](int l) const { return v[l]; }
#endif
};

MTGP_HD inline int warp_sum(const PerLane<int>& x) {
#ifdef __CUDA_ARCH__
  int v = x[0];
  for (int o = kWarp / 2; o > 0; o >>= 1) v += __shfl_xor_sync(0xffffffffu, v, o);
  return v;
#else
  int v = 0;
  for (int l = 0; l < kWarp; ++l) v += x[l];
  return v;
#endif
}

MTGP_HD inline int warp_max(const PerLane<int>& x) {
#ifdef __CUDA_ARCH__
  return __reduce_max_sync(0xffffffffu, x[0]);
#else
  int v = x[0];
  for (int l = 1; l < kWarp; ++l) v = x[l] > v ? x[l] : v;
  return v;
#endif
}

MTGP_HD inline int warp_or(const PerLane<int>& x) {
#ifdef __CUDA_ARCH__
  return static_cast<int>(__reduce_or_sync(0xffffffffu, static_cast<unsigned>(x[0])));
#else
  int v = 0;
  for (int l = 0; l < kWarp; ++l) v |= x[l];
  return v;
#endif
}

// exclusive prefix sum over lanes into `excl`; returns the total
MTGP_HD inline int warp_exclusive_scan(const PerLane<int>& x, PerLane<int>& excl) {
#ifdef __CUDA_ARCH__
  const int lane = static_cast<int>(threadIdx.x) & (kWarp - 1);
  int v = x[0];
  for (int o = 1; o < kWarp; o <<= 1) {
    const int up = __shfl_up_sync(0xffffffffu, v, o);
    if (lane >= o) v += up;
  }
  excl[0] = v - x[0];
  return __shfl_sync(0xffffffffu, v, kWarp - 1);
#else
  int v = 0;
  for (int l = 0; l < kWarp; ++l) {
    excl[l] = v;
    v += x[l];
  }
  return v;
#endif
}

// the row of the largest score; ties go to the highest row (rows are
// distinct except the -1 of lanes without rows, whose score is -inf)
MTGP_HD inline bool beats(float s2, int r2, float s, int r) {
  return s2 > s || (s2 == s && r2 > r);
}

MTGP_HD inline int warp_argmax(const PerLane<float>& score, const PerLane<int>& row) {
#ifdef __CUDA_ARCH__
  float s = score[0];
  int r = row[0];
  for (int o = kWarp / 2; o > 0; o >>= 1) {
    const float s2 = __shfl_xor_sync(0xffffffffu, s, o);
    const int r2 = __shfl_xor_sync(0xffffffffu, r, o);
    if (beats(s2, r2, s, r)) {
      s = s2;
      r = r2;
    }
  }
  return r;
#else
  float s = score[0];
  int r = row[0];
  for (int l = 1; l < kWarp; ++l)
    if (beats(score[l], row[l], s, r)) {
      s = score[l];
      r = row[l];
    }
  return r;
#endif
}

// rows [first, last) of `rows` that lane l owns in row-wise steps
struct Chunk {
  int first, last;
  MTGP_HD Chunk(int l, int rows) {
    const int c = (rows + kWarp - 1) / kWarp;
    first = l * c < rows ? l * c : rows;
    last = first + c < rows ? first + c : rows;
  }
};

// ------------------------------------------------------------ operands

struct Params {
  const int* p1o;      // (L, n) lane-major
  const float* p1c;
  const int* p2o;
  const float* p2c;
  const uint8_t* cx;   // (L,)
  const int* act1;
  const int* act2;
  const float* vmask;  // (V, L)
  const float* u;      // (L, R) lane-major
  int* c1o;            // (L, n) lane-major
  float* c1c;
  int* c2o;
  float* c2c;
  const int* slots;     // (num_opcodes,) arity by opcode
  const float* probs;   // (K,) operator weights
  const float* decay;   // (max depth,) float32(0.7 ** depth)
  int L, n, V, K, var_start, max_init_depth, cx_retries, mut_retries, R;
  float coef_sd;
};

// rows of u consumed by each part of reproduce_tiles, in call order
MTGP_HD inline int tree_rows(const Params& p, int depth) {
  return ((1 << depth) - 1) * (4 + p.V + p.K);
}
MTGP_HD inline int leaf_rows(const Params& p) { return p.V + 3; }
MTGP_HD inline int cx_rows(const Params& p) { return p.cx_retries * 2 * p.n; }
MTGP_HD inline int mut_rows(const Params& p) {
  return 7 + tree_rows(p, 2) + 2 * p.n + leaf_rows(p) + p.mut_retries * (p.n + p.K) +
         2 * leaf_rows(p) + p.n + leaf_rows(p) + p.K + 1 + p.n + p.K + 1;
}
MTGP_HD inline int total_rows(const Params& p) {
  return 2 * tree_rows(p, p.max_init_depth) + cx_rows(p) + 2 * mut_rows(p);
}

template <int N>
struct Rows {  // a tree (rows 0..n-1, padding first) or a block (rows 0..size-1, root last)
  int op[N];
  float c[N];
  int size;
};

// the grow sampler's per-node draws and its node buffer
template <int N>
struct Nodes {
  int leaf[N];     // the node's leaf opcode
  float coeff[N];  // its constant
  int oper[N];     // its operator opcode
  int oper_ar[N];  // the operator's arity
  int want[N];     // grows if the budget allows: depth left and u < 0.7 ** depth
  int idx[N];      // the chosen opcode
  int ar[N];       // its arity
  int buf_op[N];   // rows in buffer (DFS) order
  float buf_c[N];
};

// one warp's shared memory
template <int N>
struct WarpMem {
  Rows<N> t1, t2, b2, blk, tmp;
  Nodes<N> nodes;
};

// one lane's view of the inputs
struct Lane {
  const Params& p;
  int j;
  MTGP_HD float U(int r) const { return p.u[static_cast<size_t>(j) * p.R + r]; }
  MTGP_HD float vm(int v) const { return p.vmask[static_cast<size_t>(v) * p.L + j]; }
  MTGP_HD int arity(int op) const {
    return (op >= kOpStart && op < p.var_start) ? p.slots[op] : 0;
  }
  MTGP_HD bool is_op(int op) const { return op >= kOpStart && op < p.var_start; }
  MTGP_HD bool is_leaf(int op) const { return op == kConst || op >= p.var_start; }
  MTGP_HD size_t row(int i) const { return static_cast<size_t>(j) * p.n + i; }
};

MTGP_HD inline float gumbel(float u) {
  u = fminf(fmaxf(u, 1e-7f), kGumbelHi);
  return -logf(-logf(u));
}

MTGP_HD inline float score(float w, float u) {
  return w > 0.0f ? logf(fmaxf(w, 1e-30f)) + gumbel(u) : kNeg;
}

// Gumbel-argmax row draw over `rows` weights read from u rows r0.., by one
// thread; ties to the highest row, all-zero weights give the last row.
template <typename W>
MTGP_HD int choose_serial(const Lane& ln, int rows, int r0, W w) {
  float best = -INFINITY;
  int arg = 0;
  for (int r = 0; r < rows; ++r) {
    const float s = score(w(r), ln.U(r0 + r));
    if (s >= best) {
      best = s;
      arg = r;
    }
  }
  return arg;
}

// the same draw by the warp: each thread scores its rows, one warp argmax
template <typename W>
MTGP_HD int choose_row(const Lane& ln, int rows, int r0, W w) {
  PerLane<float> best;
  PerLane<int> arg;
  FOR_LANES(l) {
    float b = -INFINITY;
    int a = -1;
    const Chunk ch(l, rows);
    for (int r = ch.first; r < ch.last; ++r) {
      const float s = score(w(r), ln.U(r0 + r));
      if (s >= b) {
        b = s;
        a = r;
      }
    }
    best[l] = b;
    arg[l] = a;
  }
  return warp_argmax(best, arg);
}

MTGP_HD inline float normal(float u1, float u2) {
  u1 = fminf(fmaxf(u1, 1e-7f), 1.0f);
  return sqrtf(-2.0f * logf(u1)) * cosf(kTwoPi * u2);
}

MTGP_HD inline int sample_operator(const Lane& ln, int r0) {
  return choose_row(ln, ln.p.K, r0, [&](int r) { return ln.p.probs[r]; }) + kOpStart;
}

// 50/50 constant/variable leaf; `exclude` removes one variable opcode
MTGP_HD inline void sample_leaf(const Lane& ln, int r0, int exclude, int* op, float* c) {
  const Params& p = ln.p;
  float psum = 0.0f;
  for (int v = 0; v < p.V; ++v) psum += (p.var_start + v == exclude) ? 0.0f : ln.vm(v);
  const bool has_var = psum > 0.0f;
  const int vr = choose_row(ln, p.V, r0, [&](int v) {
    const float w = (p.var_start + v == exclude) ? 0.0f : ln.vm(v);
    return has_var ? w : 1.0f;
  });
  const float coeff = normal(ln.U(r0 + p.V), ln.U(r0 + p.V + 1)) * p.coef_sd;
  const bool take_const = ln.U(r0 + p.V + 2) < 0.5f || !has_var;
  *op = take_const ? kConst : vr + p.var_start;
  *c = take_const ? coeff : 0.0f;
}

// depth of BFS node i: floor(log2(i + 1))
MTGP_HD inline int node_depth(int i) {
  int d = 0;
  while ((i + 1) >> (d + 1)) ++d;
  return d;
}

// buffer (DFS) position of BFS node i in a tree of depth limit `depth`:
// the root at s - 1, a left child directly below its parent, a right child
// below the left child's full subtree
MTGP_HD inline int node_pos(int i, int depth) {
  const int d = node_depth(i);
  int pos = (1 << depth) - 2;
  for (int lev = 0; lev < d; ++lev) {
    const bool right = ((i + 1) >> (d - 1 - lev)) & 1;
    pos -= right ? (1 << (depth - lev - 1)) : 1;
  }
  return pos;
}

// Grow-sample a tree of depth limit `depth` from u rows r0.. into a block.
template <int N>
MTGP_HD void sample_tree(const Lane& ln, int r0, int depth, Rows<N>& out, Nodes<N>& nd) {
  const Params& p = ln.p;
  const int s = (1 << depth) - 1;
  float vsum = 0.0f;
  for (int v = 0; v < p.V; ++v) vsum += ln.vm(v);
  const bool has_var = vsum > 0.0f;
  const int stride = 4 + p.V + p.K;
  warp_sync();
  // every node's draws, in parallel
  FOR_LANES(l) {
    const Chunk ch(l, s);
    for (int i = ch.first; i < ch.last; ++i) {
      const int b = r0 + i * stride;
      nd.coeff[i] = normal(ln.U(b), ln.U(b + 1)) * p.coef_sd;
      const int vr = choose_serial(ln, p.V, b + 2, [&](int v) { return has_var ? ln.vm(v) : 1.0f; });
      const bool take_const = ln.U(b + 2 + p.V) < 0.5f || !has_var;
      nd.leaf[i] = take_const ? kConst : vr + p.var_start;
      nd.oper[i] = choose_serial(ln, p.K, b + 3 + p.V, [&](int r) { return p.probs[r]; }) + kOpStart;
      nd.oper_ar[i] = ln.arity(nd.oper[i]);
      const int dep = node_depth(i);
      nd.want[i] = dep + 1 < depth && ln.U(b + 3 + p.V + p.K) < p.decay[dep];
    }
  }
  warp_sync();
  // the open-slot chain, node by node (the same on every thread)
  int open = 1;
  for (int i = 0; i < s; ++i) {
    const bool grow = open < p.n - i - 1 && nd.want[i];
    int index = grow ? nd.oper[i] : nd.leaf[i];
    int ar = grow ? nd.oper_ar[i] : 0;
    if (open == 0) index = kEmpty;
    if (i > 0 && !(nd.ar[(i + (i % 2) - 2) / 2] + i % 2 > 1)) index = kEmpty;
    if (index == kEmpty) ar = 0;
    nd.idx[i] = index;
    nd.ar[i] = ar;
    if (index != kEmpty) {
      open = open + ar - 1;
      if (open < 0) open = 0;
    }
  }
  warp_sync();
  FOR_LANES(l) {
    const Chunk ch(l, s);
    for (int i = ch.first; i < ch.last; ++i) {
      const int pos = node_pos(i, depth);
      nd.buf_op[pos] = nd.idx[i];
      nd.buf_c[pos] = nd.idx[i] == kConst ? nd.coeff[i] : 0.0f;
    }
  }
  warp_sync();
  // compaction: kept rows in buffer (DFS) order make the root-last block
  PerLane<int> kept, first;
  FOR_LANES(l) {
    const Chunk ch(l, s);
    int k = 0;
    for (int r = ch.first; r < ch.last; ++r) k += nd.buf_op[r] != kEmpty;
    kept[l] = k;
  }
  const int size = warp_exclusive_scan(kept, first);
  FOR_LANES(l) {
    const Chunk ch(l, s);
    int k = first[l];
    for (int r = ch.first; r < ch.last; ++r)
      if (nd.buf_op[r] != kEmpty) {
        out.op[k] = nd.buf_op[r];
        out.c[k] = nd.buf_c[r];
        ++k;
      }
  }
  out.size = size;
  warp_sync();
}

template <int N>
MTGP_HD void load_tree(const Lane& ln, const int* ops, const float* cst, Rows<N>& t) {
  PerLane<int> live;
  FOR_LANES(l) {
    int k = 0;
    for (int i = l; i < ln.p.n; i += kWarp) {
      t.op[i] = ops[ln.row(i)];
      t.c[i] = cst[ln.row(i)];
      k += t.op[i] != kEmpty;
    }
    live[l] = k;
  }
  t.size = warp_sum(live);
  warp_sync();
}

// subtree size at row idx: idx - k + 1 for the largest k <= idx with
// sum(1 - arity[k..idx]) == 1, k = -1 when there is none. With the prefix
// sums P(k) = sum(1 - arity[0..k-1]) the condition is P(k) == P(idx + 1) - 1.
template <int N>
MTGP_HD int span_at(const Lane& ln, const Rows<N>& t, int idx) {
  PerLane<int> part, before, found;
  FOR_LANES(l) {
    const Chunk ch(l, idx + 1);
    int acc = 0;
    for (int r = ch.first; r < ch.last; ++r) acc += 1 - ln.arity(t.op[r]);
    part[l] = acc;
  }
  const int total = warp_exclusive_scan(part, before);
  FOR_LANES(l) {
    const Chunk ch(l, idx + 1);
    int acc = before[l], k = -1;
    for (int r = ch.first; r < ch.last; ++r) {
      if (acc == total - 1) k = r;
      acc += 1 - ln.arity(t.op[r]);
    }
    found[l] = k;
  }
  return idx - warp_max(found) + 1;
}

template <int N>
MTGP_HD void write_tree(const Lane& ln, const Rows<N>& t, int* ops, float* cst) {
  FOR_LANES(l) {
    for (int i = l; i < ln.p.n; i += kWarp) {
      ops[ln.row(i)] = t.op[i];
      cst[ln.row(i)] = t.c[i];
    }
  }
}

// a block (rows 0..size-1) written as a whole tree, padding first
template <int N>
MTGP_HD void write_block(const Lane& ln, const Rows<N>& b, int* ops, float* cst) {
  const int n = ln.p.n;
  FOR_LANES(l) {
    for (int i = l; i < n; i += kWarp) {
      const int k = i - (n - b.size);
      ops[ln.row(i)] = k >= 0 ? b.op[k] : kEmpty;
      cst[ln.row(i)] = k >= 0 ? b.c[k] : 0.0f;
    }
  }
}

// t with the subtree at idx (old rows) replaced by block b, written out
template <int N>
MTGP_HD void write_splice(const Lane& ln, const Rows<N>& t, int idx, int old, const Rows<N>& b,
                          int* ops, float* cst) {
  const int n = ln.p.n;
  const int bs = b.size;
  FOR_LANES(l) {
    for (int i = l; i < n; i += kWarp) {
      int o;
      float c;
      if (i > idx) {
        o = t.op[i];
        c = t.c[i];
      } else if (i > idx - bs) {
        const int k = i - (idx - bs + 1);
        o = b.op[k];
        c = b.c[k];
      } else {
        const int src = i + bs - old;
        o = src >= 0 ? t.op[src] : kEmpty;
        c = src >= 0 ? t.c[src] : 0.0f;
      }
      ops[ln.row(i)] = o;
      cst[ln.row(i)] = c;
    }
  }
}

// the subtree of t at idx (span rows) as a block
template <int N>
MTGP_HD void extract(const Rows<N>& t, int idx, int span, Rows<N>& b) {
  warp_sync();
  FOR_LANES(l) {
    for (int k = l; k < span; k += kWarp) {
      b.op[k] = t.op[idx - span + 1 + k];
      b.c[k] = t.c[idx - span + 1 + k];
    }
  }
  b.size = span;
  warp_sync();
}

// a whole tree as a block
template <int N>
MTGP_HD void tree_block(const Lane& ln, const Rows<N>& t, Rows<N>& b) {
  extract(t, ln.p.n - 1, t.size, b);
}

// op(first) or op(first, second) as a block: [second.., first.., op]
template <int N>
MTGP_HD void compose(int op, int arity, const Rows<N>& first, const Rows<N>& second,
                     Rows<N>& b) {
  const int lead = arity == 2 ? second.size : 0;
  const int size = lead + first.size + 1;
  warp_sync();
  FOR_LANES(l) {
    for (int k = l; k < size; k += kWarp) {
      if (k < lead) {
        b.op[k] = second.op[k];
        b.c[k] = second.c[k];
      } else if (k < size - 1) {
        b.op[k] = first.op[k - lead];
        b.c[k] = first.c[k - lead];
      } else {
        b.op[k] = op;
        b.c[k] = 0.0f;
      }
    }
  }
  b.size = size;
  warp_sync();
}

template <int N>
MTGP_HD void leaf_block(int op, float c, Rows<N>& b) {
  warp_sync();
  b.op[0] = op;
  b.c[0] = op == kConst ? c : 0.0f;
  b.size = 1;
  warp_sync();
}

template <int N>
MTGP_HD bool subtrees_equal(const Rows<N>& t1, int n1, int s1, const Rows<N>& t2, int n2,
                            int s2, int n) {
  if (s1 != s2 || !(t1.size > 1 || t2.size > 1)) return false;
  const int lo = n1 - s1 + 1 > 0 ? n1 - s1 + 1 : 0;
  PerLane<int> bad;
  FOR_LANES(l) {
    int b = 0;
    for (int i = lo + l; i <= n1; i += kWarp) {
      const int src = i + n2 - n1;
      const bool in = src >= 0 && src < n;
      const int o2 = in ? t2.op[src] : -1;
      const float c2 = in ? t2.c[src] : 0.0f;
      const bool same_leaf = t1.op[i] == kConst && o2 == kConst && t1.c[i] == c2;
      b |= !((t1.op[i] == o2 && t1.op[i] > kConst) || same_leaf);
    }
    bad[l] = b;
  }
  return !warp_or(bad);
}

template <int N>
MTGP_HD void crossover(const Lane& ln, int r0, const Rows<N>& t1, const Rows<N>& t2,
                       Rows<N>& b) {
  const Params& p = ln.p;
  const int n = p.n;
  const int empty1 = n - t1.size, empty2 = n - t2.size;
  auto w1 = [&](int r) { return (t1.op[r] != kEmpty ? 1.0f : 0.0f) + (ln.is_op(t1.op[r]) ? 1.0f : 0.0f); };
  auto w2 = [&](int r) { return (t2.op[r] != kEmpty ? 1.0f : 0.0f) + (ln.is_op(t2.op[r]) ? 1.0f : 0.0f); };
  bool done = false;
  int idx1 = 0, idx2 = 0;
  for (int a = 0; a < p.cx_retries && !done; ++a) {
    const int c1 = choose_row(ln, n, r0 + 2 * a * n, w1);
    const int c2 = choose_row(ln, n, r0 + (2 * a + 1) * n, w2);
    const int s1 = span_at(ln, t1, c1), s2 = span_at(ln, t2, c2);
    const bool fits = empty1 >= s2 - s1 && empty2 >= s1 - s2;
    if (fits && !subtrees_equal(t1, c1, s1, t2, c2, s2, n)) {
      done = true;
      idx1 = c1;
      idx2 = c2;
    }
  }
  if (!done) {
    write_tree(ln, t1, p.c1o, p.c1c);
    write_tree(ln, t2, p.c2o, p.c2c);
    return;
  }
  const int s1 = span_at(ln, t1, idx1), s2 = span_at(ln, t2, idx2);
  extract(t2, idx2, s2, b);
  write_splice(ln, t1, idx1, s1, b, p.c1o, p.c1c);
  extract(t1, idx1, s1, b);
  write_splice(ln, t2, idx2, s2, b, p.c2o, p.c2c);
}

// One mutation of t from u rows r0.. (fresh tree rows at f0), written out.
template <int N>
MTGP_HD void mutate(const Lane& ln, int r0, int f0, const Rows<N>& t, int* ops, float* cst,
                    WarpMem<N>& m) {
  const Params& p = ln.p;
  const int n = p.n, size = t.size, empty = n - size;
  const int probs = size == 1 ? kProbsLeaf : size <= 3 ? kProbsSmall
                    : empty < 8 ? kProbsFull : kProbsDefault;
  const int which = choose_row(ln, 7, r0, [&](int r) { return (probs >> r) & 1 ? 1.0f : 0.0f; });
  // row offsets of every draw, in reproduce_tiles' order
  const int o_b2 = r0 + 7;
  const int o_add = o_b2 + tree_rows(p, 2);
  const int o_ml = o_add + n;
  const int o_ml_leaf = o_ml + n;
  const int o_mo = o_ml_leaf + leaf_rows(p);
  const int o_la = o_mo + p.mut_retries * (n + p.K);
  const int o_lb = o_la + leaf_rows(p);
  const int o_del = o_lb + leaf_rows(p);
  const int o_del_leaf = o_del + n;
  const int o_pre_op = o_del_leaf + leaf_rows(p);
  const int o_pre_side = o_pre_op + p.K;
  const int o_ins = o_pre_side + 1;
  const int o_ins_op = o_ins + n;
  const int o_ins_side = o_ins_op + p.K;

  PerLane<int> kinds;  // bit 0: an operator row; bit 1: a non-root operator row
  FOR_LANES(l) {
    int f = 0;
    for (int i = l; i < n; i += kWarp)
      if (ln.is_op(t.op[i])) f |= i < n - 1 ? 3 : 1;
    kinds[l] = f;
  }
  const int found = warp_or(kinds);
  const bool has_op = found & 1, has_nonroot = found & 2;
  auto leaf_w = [&](int r) { return ln.is_leaf(t.op[r]) ? 1.0f : 0.0f; };
  auto nonroot_w = [&](int r) {
    return has_nonroot ? (ln.is_op(t.op[r]) && r < n - 1 ? 1.0f : 0.0f) : 1.0f;
  };
  Rows<N>& b2 = m.b2;
  Rows<N>& blk = m.blk;
  Rows<N>& tmp = m.tmp;
  switch (which) {
    case 0: {  // add_subtree: a leaf becomes a depth-2 subtree
      sample_tree(ln, o_b2, 2, b2, m.nodes);
      if (empty >= b2.size - 1) {
        const int idx = choose_row(ln, n, o_add, leaf_w);
        write_splice(ln, t, idx, 1, b2, ops, cst);
        return;
      }
      break;
    }
    case 1: {  // mutate_leaf: a leaf becomes a different leaf
      const int idx = choose_row(ln, n, o_ml, leaf_w);
      int op;
      float c;
      sample_leaf(ln, o_ml_leaf, t.op[idx], &op, &c);
      leaf_block(op, c, blk);
      write_splice(ln, t, idx, 1, blk, ops, cst);
      return;
    }
    case 2: {  // mutate_operator: bounded retries over (node, new operator)
      if (!has_op) break;
      bool done = false;
      int mo_idx = 0, mo_op = 0;
      for (int a = 0; a < p.mut_retries && !done; ++a) {
        const int rb = o_mo + a * (n + p.K);
        const int cand = choose_row(ln, n, rb, [&](int r) { return ln.is_op(t.op[r]) ? 1.0f : 0.0f; });
        const int new_op = sample_operator(ln, rb + n);
        const int need = ln.arity(new_op) == 2 ? 7 : 8;
        if (t.op[cand] != new_op && empty + span_at(ln, t, cand) >= need) {
          done = true;
          mo_idx = cand;
          mo_op = new_op;
        }
      }
      if (!done) break;
      const int new_ar = ln.arity(mo_op);
      if (ln.arity(t.op[mo_idx]) == new_ar) {  // same arity: swap the opcode in place
        FOR_LANES(l) {
          for (int i = l; i < n; i += kWarp) {
            ops[ln.row(i)] = i == mo_idx ? mo_op : t.op[i];
            cst[ln.row(i)] = t.c[i];
          }
        }
        return;
      }
      if (new_ar == 1) {  // binary -> unary: a fresh depth-2 subtree below it
        sample_tree(ln, o_b2, 2, b2, m.nodes);
        compose(mo_op, 1, b2, b2, blk);
      } else {  // unary -> binary: two fresh leaves below it
        int op;
        float c;
        sample_leaf(ln, o_la, -1, &op, &c);
        leaf_block(op, c, b2);
        sample_leaf(ln, o_lb, -1, &op, &c);
        leaf_block(op, c, tmp);
        compose(mo_op, 2, b2, tmp, blk);
      }
      write_splice(ln, t, mo_idx, span_at(ln, t, mo_idx), blk, ops, cst);
      return;
    }
    case 3: {  // delete_operator: a non-root operator subtree becomes a leaf
      if (!has_nonroot) break;
      const int idx = choose_row(ln, n, o_del, nonroot_w);
      int op;
      float c;
      sample_leaf(ln, o_del_leaf, -1, &op, &c);
      leaf_block(op, c, blk);
      write_splice(ln, t, idx, span_at(ln, t, idx), blk, ops, cst);
      return;
    }
    case 4: {  // prepend_operator: a new root above the whole tree
      const int op = sample_operator(ln, o_pre_op);
      const int ar = ln.arity(op);
      sample_tree(ln, o_b2, 2, b2, m.nodes);
      const bool side = ln.U(o_pre_side) < 0.5f;  // the sample is the first operand
      const int bs = ar == 1 ? size + 1 : size + b2.size + 1;
      if (bs > n) break;
      tree_block(ln, t, tmp);
      if (ar == 1)
        compose(op, 1, tmp, tmp, blk);
      else if (side)
        compose(op, 2, b2, tmp, blk);
      else
        compose(op, 2, tmp, b2, blk);
      write_block(ln, blk, ops, cst);
      return;
    }
    case 5: {  // insert_operator: a new operator above a non-root operator
      if (!has_nonroot) break;
      const int idx = choose_row(ln, n, o_ins, nonroot_w);
      const int span = span_at(ln, t, idx);
      const int op = sample_operator(ln, o_ins_op);
      const int ar = ln.arity(op);
      sample_tree(ln, o_b2, 2, b2, m.nodes);
      const bool side = ln.U(o_ins_side) < 0.5f;
      const int bs = ar == 1 ? span + 1 : span + b2.size + 1;
      if (empty < bs - span) break;
      extract(t, idx, span, tmp);
      if (ar == 1)
        compose(op, 1, tmp, tmp, blk);
      else if (side)
        compose(op, 2, b2, tmp, blk);
      else
        compose(op, 2, tmp, b2, blk);
      write_splice(ln, t, idx, span, blk, ops, cst);
      return;
    }
    default: {  // 6, replace_tree: the fresh tree of this child
      sample_tree(ln, f0, p.max_init_depth, blk, m.nodes);
      write_block(ln, blk, ops, cst);
      return;
    }
  }
  write_tree(ln, t, ops, cst);  // an inapplicable case leaves the tree unchanged
}

template <int N>
MTGP_HD void child(const Lane& ln, int act, int r_mut, int r_fresh, const Rows<N>& t, int* ops,
                   float* cst, WarpMem<N>& m) {
  if (act == 1) {
    mutate(ln, r_mut, r_fresh, t, ops, cst, m);
  } else if (act == 2) {
    sample_tree(ln, r_fresh, ln.p.max_init_depth, m.blk, m.nodes);
    write_block(ln, m.blk, ops, cst);
  } else {
    write_tree(ln, t, ops, cst);
  }
  warp_sync();  // the next child reuses the scratch rows
}

// lane j of the population, by one warp whose shared memory is m
template <int N>
MTGP_HD void reproduce_lane(const Params& p, int j, WarpMem<N>& m) {
  const Lane ln{p, j};
  load_tree(ln, p.p1o, p.p1c, m.t1);
  load_tree(ln, p.p2o, p.p2c, m.t2);
  const int r_f1 = 0;
  const int r_f2 = tree_rows(p, p.max_init_depth);
  const int r_cx = 2 * r_f2;
  const int r_m1 = r_cx + cx_rows(p);
  const int r_m2 = r_m1 + mut_rows(p);
  if (p.cx[j]) {
    crossover(ln, r_cx, m.t1, m.t2, m.blk);
  } else {
    child(ln, p.act1[j], r_m1, r_f1, m.t1, p.c1o, p.c1c, m);
    child(ln, p.act2[j], r_m2, r_f2, m.t2, p.c2o, p.c2c, m);
  }
}

int check_params(const Params& p) {
  if (p.L <= 0 || p.n <= 0 || p.n > kMaxNodes || p.V <= 0 || p.K <= 0 ||
      p.max_init_depth < 1 || (1 << p.max_init_depth) - 1 > p.n || p.n < 3 ||
      p.R != total_rows(p))
    return 1;
  return 0;
}

Params make_params(const int* p1o, const float* p1c, const int* p2o, const float* p2c,
                   const uint8_t* cx, const int* act1, const int* act2, const float* vmask,
                   const float* u, int* c1o, float* c1c, int* c2o, float* c2c,
                   const int* slots, const float* probs, const float* decay, int L, int n,
                   int V, int K, int var_start, int max_init_depth, int cx_retries,
                   int mut_retries, float coef_sd, int rows) {
  return Params{p1o, p1c, p2o, p2c, cx, act1, act2, vmask, u, c1o, c1c, c2o, c2c, slots,
                probs, decay, L, n, V, K, var_start, max_init_depth, cx_retries,
                mut_retries, rows, coef_sd};
}

#ifdef __CUDACC__
// p is read where it lies (__grid_constant__): the lanes' code takes its
// address, which would otherwise copy it to local memory
template <int N>
__global__ void reproduce_kernel(const __grid_constant__ Params p) {
  extern __shared__ unsigned char smem[];
  const int w = static_cast<int>(threadIdx.x) / kWarp;
  const int j = blockIdx.x * (blockDim.x / kWarp) + w;
  if (j >= p.L) return;  // the whole warp
  reproduce_lane<N>(p, j, reinterpret_cast<WarpMem<N>*>(smem)[w]);
}

template <int N>
cudaError_t launch(const Params& p, cudaStream_t stream) {
  // up to 4 warps (lanes) a block, within the 48 KB of shared memory a
  // block gets without opting in (2 warps at N = 256)
  constexpr int kWarps = 48 * 1024 / sizeof(WarpMem<N>) < 4 ? 48 * 1024 / sizeof(WarpMem<N>) : 4;
  static_assert(kWarps >= 1, "one warp's rows must fit in 48 KB");
  reproduce_kernel<N><<<(p.L + kWarps - 1) / kWarps, kWarps * kWarp, kWarps * sizeof(WarpMem<N>),
                        stream>>>(p);
  return cudaGetLastError();
}
#endif

}  // namespace

#define MTGP_REPRODUCE_ARGS                                                                   \
  const int *p1o, const float *p1c, const int *p2o, const float *p2c, const uint8_t *cx,      \
      const int *act1, const int *act2, const float *vmask, const float *u, int *c1o,         \
      float *c1c, int *c2o, float *c2c, const int *slots, const float *probs,                 \
      const float *decay, int L, int n, int V, int K, int var_start, int max_init_depth,      \
      int cx_retries, int mut_retries, float coef_sd, int rows
#define MTGP_REPRODUCE_PARAMS                                                                 \
  make_params(p1o, p1c, p2o, p2c, cx, act1, act2, vmask, u, c1o, c1c, c2o, c2c, slots, probs, \
              decay, L, n, V, K, var_start, max_init_depth, cx_retries, mut_retries, coef_sd, \
              rows)

extern "C" {

// Parents and children are (L, n) lane-major (row i of lane j at j * n + i);
// vmask (V, L); u (L, rows) lane-major uniforms in [0, 1); cx/act1/act2
// (L,). `rows` must equal the row count of reproduce_tiles for these sizes.
#ifdef __CUDACC__
const char* mtgp_error_string(int status) {
  return cudaGetErrorString(static_cast<cudaError_t>(status));
}

int reproduce_rows(int n, int V, int K, int max_init_depth, int cx_retries, int mut_retries) {
  Params p{};
  p.n = n; p.V = V; p.K = K; p.max_init_depth = max_init_depth;
  p.cx_retries = cx_retries; p.mut_retries = mut_retries;
  return total_rows(p);
}

int reproduce_launch(MTGP_REPRODUCE_ARGS, void* stream) {
  const Params p = MTGP_REPRODUCE_PARAMS;
  if (check_params(p)) return static_cast<int>(cudaErrorInvalidValue);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  // two instances: the main path's N = 32, and everything up to 256
  if (n <= 32) return launch<32>(p, s);
  return launch<kMaxNodes>(p, s);
}
#else
// host build of the same warp code (tests without a card): one lane after
// another, each by a warp of 32 host "threads"
int reproduce_host(MTGP_REPRODUCE_ARGS) {
  const Params p = MTGP_REPRODUCE_PARAMS;
  if (check_params(p)) return 1;
  if (n <= 32) {
    std::vector<WarpMem<32>> m(1);
    for (int j = 0; j < L; ++j) reproduce_lane<32>(p, j, m[0]);
  } else {
    std::vector<WarpMem<kMaxNodes>> m(1);
    for (int j = 0; j < L; ++j) reproduce_lane<kMaxNodes>(p, j, m[0]);
  }
  return 0;
}
#endif

}  // extern "C"
