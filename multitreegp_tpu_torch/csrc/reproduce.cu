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
// What bounds it on this card: latency of serial per-lane code. A lane does
// a few hundred dependent steps (Gumbel draws over N rows, span walks,
// splices) on trees of N rows; the bytes are its two parents, its two
// children (16 N bytes) and the uniforms it reads. There is no shared work
// between lanes, so nothing to stage in shared memory.
//
// Design: one thread per lane, holding the parents' (ops, const) rows in
// local memory (L1-resident at N = 32). The TPU code moved rows with
// log2(N)-stage cyclic shifts, read rows with masked reduces and drew every
// branch for every lane, because a vector unit cannot branch per lane. Here a
// lane runs only the branches its action needs, as plain serial code:
// crossover only for crossover lanes, one mutation case, a fresh sample only
// when one is used. Randomness is a uniform buffer u (R, L) drawn by the
// wrapper; lane j reads column j at the row offsets at which reproduce_tiles
// calls urand, so a skipped branch still leaves every later branch on its
// own rows, and kernel and plain version see the same numbers. Child
// pointers are rebuilt afterwards in PyTorch (trees.rebuild_pointers).
//
// Numerics copy tile_surgery: Gumbel clip [1e-7, 1 - 1e-7] and
// -log(-log(u)), score log(max(w, 1e-30)) + gumbel, ties to the highest row,
// Box-Muller sqrt(-2 log(max(u1, 1e-7))) * cos(2 pi u2). Built with
// -fmad=false.
//
// The per-lane code is plain C++ under MTGP_HD, so the same file also
// compiles for the host (without __CUDACC__) into a lane loop that tests can
// run against the plain version on machines without a card.
#include <math.h>
#include <stddef.h>
#include <stdint.h>

#ifdef __CUDACC__
#include <cuda_runtime.h>
#define MTGP_HD __host__ __device__
#else
#define MTGP_HD
#endif

namespace {

constexpr int kEmpty = 0;
constexpr int kConst = 1;
constexpr int kOpStart = 2;
constexpr int kMaxNodes = 256;
constexpr float kNeg = -1e30f;
constexpr float kGumbelHi = static_cast<float>(1.0 - 1e-7);
constexpr float kTwoPi = 6.283185307179586f;

// mutation applicability by tree size class (tile_surgery PROBS_*), bit r
// set when mutation r applies
constexpr int kProbsDefault = 0x7f;  // 1 1 1 1 1 1 1
constexpr int kProbsFull = 0x4e;     // 0 1 1 1 0 0 1
constexpr int kProbsSmall = 0x57;    // 1 1 1 0 1 0 1
constexpr int kProbsLeaf = 0x53;     // 1 1 0 0 1 0 1

struct Params {
  const int* p1o;
  const float* p1c;
  const int* p2o;
  const float* p2c;
  const uint8_t* cx;
  const int* act1;
  const int* act2;
  const float* vmask;  // (V, L)
  const float* u;      // (R, L)
  int* c1o;
  float* c1c;
  int* c2o;
  float* c2c;
  const int* slots;     // (num_opcodes,) arity by opcode
  const float* probs;   // (K,) operator weights
  const float* decay;   // (max depth,) float32(0.7 ** depth)
  int L, n, V, K, var_start, max_init_depth, cx_retries, mut_retries;
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

// one lane's view of the inputs
struct Lane {
  const Params& p;
  int j;
  MTGP_HD float U(int r) const { return p.u[static_cast<size_t>(r) * p.L + j]; }
  MTGP_HD float vm(int v) const { return p.vmask[static_cast<size_t>(v) * p.L + j]; }
  MTGP_HD int arity(int op) const {
    return (op >= kOpStart && op < p.var_start) ? p.slots[op] : 0;
  }
  MTGP_HD bool is_op(int op) const { return op >= kOpStart && op < p.var_start; }
  MTGP_HD bool is_leaf(int op) const { return op == kConst || op >= p.var_start; }
};

MTGP_HD inline float gumbel(float u) {
  u = fminf(fmaxf(u, 1e-7f), kGumbelHi);
  return -logf(-logf(u));
}

// Gumbel-argmax row draw over `rows` weights read from u rows r0..; ties to
// the highest row, all-zero weights give the last row.
template <typename W>
MTGP_HD int choose_row(const Lane& ln, int rows, int r0, W w) {
  float best = -INFINITY;
  int arg = 0;
  for (int r = 0; r < rows; ++r) {
    const float wr = w(r);
    const float s = wr > 0.0f ? logf(fmaxf(wr, 1e-30f)) + gumbel(ln.U(r0 + r)) : kNeg;
    if (s >= best) {
      best = s;
      arg = r;
    }
  }
  return arg;
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

// Grow-sample a tree of depth limit `depth` from u rows r0.. into a block.
template <int N>
MTGP_HD void sample_tree(const Lane& ln, int r0, int depth, Rows<N>& out) {
  const Params& p = ln.p;
  const int s = (1 << depth) - 1;
  int pos[N], dep[N], buf_op[N];
  float buf_c[N];
  pos[0] = s - 1;
  dep[0] = 0;
  for (int i = 0; i < s; ++i) {
    const int l = 2 * i + 1;
    if (l < s) {
      dep[l] = dep[l + 1] = dep[i] + 1;
      const int child_span = (1 << (depth - dep[i] - 1)) - 1;
      pos[l] = pos[i] - 1;
      pos[l + 1] = pos[i] - 1 - child_span;
    }
  }
  float vsum = 0.0f;
  for (int v = 0; v < p.V; ++v) vsum += ln.vm(v);
  const bool has_var = vsum > 0.0f;
  const int stride = 4 + p.V + p.K;
  int open = 1;
  for (int i = 0; i < s; ++i) {
    const int b = r0 + i * stride;
    const float coeff = normal(ln.U(b), ln.U(b + 1)) * p.coef_sd;
    const int vr = choose_row(ln, p.V, b + 2, [&](int v) { return has_var ? ln.vm(v) : 1.0f; });
    const bool take_const = ln.U(b + 2 + p.V) < 0.5f || !has_var;
    const int leaf = take_const ? kConst : vr + p.var_start;
    const int oper = sample_operator(ln, b + 3 + p.V);
    const bool grow = open < p.n - i - 1 && dep[i] + 1 < depth;
    int index = (grow && ln.U(b + 3 + p.V + p.K) < p.decay[dep[i]]) ? oper : leaf;
    if (open == 0) index = kEmpty;
    if (i > 0) {
      const int parent = (i + (i % 2) - 2) / 2;
      const int is_left = i % 2;
      if (!(ln.arity(buf_op[pos[parent]]) + is_left > 1)) index = kEmpty;
    }
    buf_op[pos[i]] = index;
    buf_c[pos[i]] = index == kConst ? coeff : 0.0f;
    if (index != kEmpty) {
      open = open + ln.arity(index) - 1;
      if (open < 0) open = 0;
    }
  }
  // compaction: kept rows in buffer (DFS) order make the root-last block
  int k = 0;
  for (int r = 0; r < s; ++r) {
    if (buf_op[r] != kEmpty) {
      out.op[k] = buf_op[r];
      out.c[k] = buf_c[r];
      ++k;
    }
  }
  out.size = k;
}

template <int N>
MTGP_HD void load_tree(const Lane& ln, const int* ops, const float* cst, Rows<N>& t) {
  const Params& p = ln.p;
  t.size = 0;
  for (int i = 0; i < p.n; ++i) {
    t.op[i] = ops[static_cast<size_t>(i) * p.L + ln.j];
    t.c[i] = cst[static_cast<size_t>(i) * p.L + ln.j];
    t.size += t.op[i] != kEmpty;
  }
}

// subtree size at row idx: idx - k + 1 for the largest k <= idx with
// sum(1 - arity[k..idx]) == 1, k = -1 when there is none
template <int N>
MTGP_HD int span_at(const Lane& ln, const Rows<N>& t, int idx) {
  int acc = 0;
  for (int k = idx; k >= 0; --k) {
    acc += 1 - ln.arity(t.op[k]);
    if (acc == 1) return idx - k + 1;
  }
  return idx + 2;
}

template <int N>
MTGP_HD void write_tree(const Lane& ln, const Rows<N>& t, int* ops, float* cst) {
  for (int i = 0; i < ln.p.n; ++i) {
    ops[static_cast<size_t>(i) * ln.p.L + ln.j] = t.op[i];
    cst[static_cast<size_t>(i) * ln.p.L + ln.j] = t.c[i];
  }
}

// a block (rows 0..size-1) written as a whole tree, padding first
template <int N>
MTGP_HD void write_block(const Lane& ln, const Rows<N>& b, int* ops, float* cst) {
  const int n = ln.p.n;
  for (int i = 0; i < n; ++i) {
    const int k = i - (n - b.size);
    ops[static_cast<size_t>(i) * ln.p.L + ln.j] = k >= 0 ? b.op[k] : kEmpty;
    cst[static_cast<size_t>(i) * ln.p.L + ln.j] = k >= 0 ? b.c[k] : 0.0f;
  }
}

// t with the subtree at idx (old rows) replaced by block b, written out
template <int N>
MTGP_HD void write_splice(const Lane& ln, const Rows<N>& t, int idx, int old, const Rows<N>& b,
                          int* ops, float* cst) {
  const int n = ln.p.n;
  const int bs = b.size;
  for (int i = 0; i < n; ++i) {
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
    ops[static_cast<size_t>(i) * ln.p.L + ln.j] = o;
    cst[static_cast<size_t>(i) * ln.p.L + ln.j] = c;
  }
}

// the subtree of t at idx (span rows) as a block
template <int N>
MTGP_HD void extract(const Rows<N>& t, int idx, int span, Rows<N>& b) {
  for (int k = 0; k < span; ++k) {
    b.op[k] = t.op[idx - span + 1 + k];
    b.c[k] = t.c[idx - span + 1 + k];
  }
  b.size = span;
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
  int k = 0;
  if (arity == 2)
    for (int r = 0; r < second.size; ++r, ++k) {
      b.op[k] = second.op[r];
      b.c[k] = second.c[r];
    }
  for (int r = 0; r < first.size; ++r, ++k) {
    b.op[k] = first.op[r];
    b.c[k] = first.c[r];
  }
  b.op[k] = op;
  b.c[k] = 0.0f;
  b.size = k + 1;
}

template <int N>
MTGP_HD void leaf_block(int op, float c, Rows<N>& b) {
  b.op[0] = op;
  b.c[0] = op == kConst ? c : 0.0f;
  b.size = 1;
}

template <int N>
MTGP_HD bool subtrees_equal(const Rows<N>& t1, int n1, int s1, const Rows<N>& t2, int n2,
                            int s2, int n) {
  if (s1 != s2 || !(t1.size > 1 || t2.size > 1)) return false;
  for (int i = n1 - s1 + 1 > 0 ? n1 - s1 + 1 : 0; i <= n1; ++i) {
    const int src = i + n2 - n1;
    const bool in = src >= 0 && src < n;
    const int o2 = in ? t2.op[src] : -1;
    const float c2 = in ? t2.c[src] : 0.0f;
    const bool same_leaf = t1.op[i] == kConst && o2 == kConst && t1.c[i] == c2;
    if (!((t1.op[i] == o2 && t1.op[i] > kConst) || same_leaf)) return false;
  }
  return true;
}

template <int N>
MTGP_HD void crossover(const Lane& ln, int r0, const Rows<N>& t1, const Rows<N>& t2) {
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
  Rows<N> b;
  extract(t2, idx2, s2, b);
  write_splice(ln, t1, idx1, s1, b, p.c1o, p.c1c);
  extract(t1, idx1, s1, b);
  write_splice(ln, t2, idx2, s2, b, p.c2o, p.c2c);
}

// One mutation of t from u rows r0.. (fresh tree rows at f0), written out.
template <int N>
MTGP_HD void mutate(const Lane& ln, int r0, int f0, const Rows<N>& t, int* ops, float* cst) {
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

  bool has_op = false, has_nonroot = false;
  for (int i = 0; i < n; ++i) {
    has_op = has_op || ln.is_op(t.op[i]);
    has_nonroot = has_nonroot || (ln.is_op(t.op[i]) && i < n - 1);
  }
  auto leaf_w = [&](int r) { return ln.is_leaf(t.op[r]) ? 1.0f : 0.0f; };
  auto nonroot_w = [&](int r) {
    return has_nonroot ? (ln.is_op(t.op[r]) && r < n - 1 ? 1.0f : 0.0f) : 1.0f;
  };
  Rows<N> b2, blk, tmp;
  switch (which) {
    case 0: {  // add_subtree: a leaf becomes a depth-2 subtree
      sample_tree(ln, o_b2, 2, b2);
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
        for (int i = 0; i < n; ++i) {
          ops[static_cast<size_t>(i) * p.L + ln.j] = i == mo_idx ? mo_op : t.op[i];
          cst[static_cast<size_t>(i) * p.L + ln.j] = t.c[i];
        }
        return;
      }
      if (new_ar == 1) {  // binary -> unary: a fresh depth-2 subtree below it
        sample_tree(ln, o_b2, 2, b2);
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
      sample_tree(ln, o_b2, 2, b2);
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
      sample_tree(ln, o_b2, 2, b2);
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
      sample_tree(ln, f0, p.max_init_depth, blk);
      write_block(ln, blk, ops, cst);
      return;
    }
  }
  write_tree(ln, t, ops, cst);  // an inapplicable case leaves the tree unchanged
}

template <int N>
MTGP_HD void child(const Lane& ln, int act, int r_mut, int r_fresh, const Rows<N>& t, int* ops,
                   float* cst) {
  if (act == 1) {
    mutate(ln, r_mut, r_fresh, t, ops, cst);
  } else if (act == 2) {
    Rows<N> f;
    sample_tree(ln, r_fresh, ln.p.max_init_depth, f);
    write_block(ln, f, ops, cst);
  } else {
    write_tree(ln, t, ops, cst);
  }
}

template <int N>
MTGP_HD void reproduce_lane(const Params& p, int j) {
  const Lane ln{p, j};
  Rows<N> t1, t2;
  load_tree(ln, p.p1o, p.p1c, t1);
  load_tree(ln, p.p2o, p.p2c, t2);
  const int r_f1 = 0;
  const int r_f2 = tree_rows(p, p.max_init_depth);
  const int r_cx = 2 * r_f2;
  const int r_m1 = r_cx + cx_rows(p);
  const int r_m2 = r_m1 + mut_rows(p);
  if (p.cx[j]) {
    crossover(ln, r_cx, t1, t2);
  } else {
    child(ln, p.act1[j], r_m1, r_f1, t1, p.c1o, p.c1c);
    child(ln, p.act2[j], r_m2, r_f2, t2, p.c2o, p.c2c);
  }
}

typedef void (*LaneFn)(const Params&, int);

int check_params(const Params& p, int rows) {
  if (p.L <= 0 || p.n <= 0 || p.n > kMaxNodes || p.V <= 0 || p.K <= 0 ||
      p.max_init_depth < 1 || (1 << p.max_init_depth) - 1 > p.n || p.n < 3 ||
      rows != total_rows(p))
    return 1;
  return 0;
}

Params make_params(const int* p1o, const float* p1c, const int* p2o, const float* p2c,
                   const uint8_t* cx, const int* act1, const int* act2, const float* vmask,
                   const float* u, int* c1o, float* c1c, int* c2o, float* c2c,
                   const int* slots, const float* probs, const float* decay, int L, int n,
                   int V, int K, int var_start, int max_init_depth, int cx_retries,
                   int mut_retries, float coef_sd) {
  return Params{p1o, p1c, p2o, p2c, cx, act1, act2, vmask, u, c1o, c1c, c2o, c2c, slots,
                probs, decay, L, n, V, K, var_start, max_init_depth, cx_retries,
                mut_retries, coef_sd};
}

#ifdef __CUDACC__
template <int N>
__global__ void reproduce_kernel(Params p) {
  const int j = blockIdx.x * blockDim.x + threadIdx.x;
  if (j < p.L) reproduce_lane<N>(p, j);
}

template <int N>
cudaError_t launch(const Params& p, cudaStream_t stream) {
  constexpr int kThreads = 128;
  reproduce_kernel<N><<<(p.L + kThreads - 1) / kThreads, kThreads, 0, stream>>>(p);
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
              decay, L, n, V, K, var_start, max_init_depth, cx_retries, mut_retries, coef_sd)

extern "C" {

// Tiles are (n, L) row-major (lane j of row i at i * L + j); vmask (V, L);
// u (rows, L) uniforms in [0, 1); cx/act1/act2 (L,). `rows` must equal the
// row count of reproduce_tiles for these sizes.
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
  if (check_params(p, rows)) return static_cast<int>(cudaErrorInvalidValue);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  // two instances: the main path's N = 32, and everything up to 256
  if (n <= 32) return launch<32>(p, s);
  return launch<256>(p, s);
}
#else
// host build of the same per-lane code (tests without a card)
int reproduce_host(MTGP_REPRODUCE_ARGS) {
  const Params p = MTGP_REPRODUCE_PARAMS;
  if (check_params(p, rows)) return 1;
  for (int j = 0; j < L; ++j) {
    if (n <= 32) reproduce_lane<32>(p, j);
    else reproduce_lane<256>(p, j);
  }
  return 0;
}
#endif

}  // extern "C"
