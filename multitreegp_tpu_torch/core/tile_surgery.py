"""Lane-parallel tree surgery on ``(N, L)`` tiles, in plain PyTorch.

Port of ``multitreegp_tpu/core/tile_surgery.py``: the whole reproduction
step on tiles of ``L`` trees stored as lanes (rows are node rows, root-last,
padding-first). Only ``(ops, const)`` are carried; child pointers are rebuilt
afterwards (:func:`trees.rebuild_pointers`). This module is the plain version
of the reproduction kernel (``csrc/reproduce.cu``) and the CPU path.

Randomness is injected exactly as in the JAX module: every sampling function
takes ``urand(rows) -> (rows, L)`` float32 uniforms, and the order and row
counts of the ``urand`` calls are the JAX module's, so both produce the same
children from the same uniforms. Row moves use ``gather`` where the TPU code
used log-depth roll ladders; the results are the same integers and floats.
"""
from __future__ import annotations

import math
from typing import Callable, List, NamedTuple, Tuple

import numpy as np
import torch

from .trees import CONST, EMPTY, OP_START, bfs_tables

Rand = Callable[[int], torch.Tensor]  # urand(rows) -> (rows, L) float32 in [0, 1)

_NEG = -1e30
_TWO_PI = 2.0 * math.pi


class SurgeryConfig(NamedTuple):
    """Static tables shared by all tile surgery."""

    n: int  # max_nodes
    var_start: int
    num_vars: int
    slots: Tuple[int, ...]  # arity by opcode
    operator_probs: Tuple[float, ...]  # unnormalised sampling weights
    coefficient_sd: float
    max_init_depth: int
    cx_retries: int = 8
    mut_retries: int = 8

    @property
    def num_operators(self) -> int:
        return self.var_start - OP_START


def make_config(fset, max_nodes: int, max_init_depth: int, coefficient_sd: float = 1.0) -> SurgeryConfig:
    if 2**max_init_depth - 1 > max_nodes:
        raise ValueError(
            f"max_init_depth {max_init_depth} needs {2**max_init_depth - 1} rows "
            f"> max_nodes {max_nodes}"
        )
    return SurgeryConfig(
        n=max_nodes,
        var_start=fset.var_start,
        num_vars=fset.num_variables,
        slots=tuple(int(s) for s in fset.slots()),
        operator_probs=tuple(float(np.float32(p)) for p in fset.operator_probs),
        coefficient_sd=float(coefficient_sd),
        max_init_depth=int(max_init_depth),
    )


# --------------------------------------------------------------------- basics


def _rows(n: int, like: torch.Tensor) -> torch.Tensor:
    return torch.arange(n, dtype=torch.int32, device=like.device)[:, None]


def arity_tile(ops: torch.Tensor, cfg: SurgeryConfig) -> torch.Tensor:
    """Per-row arity (0 outside the operator range)."""
    ar = torch.zeros_like(ops)
    for code in range(OP_START, cfg.var_start):
        if cfg.slots[code]:
            ar = torch.where(ops == code, cfg.slots[code], ar)
    return ar


def sizes_tile(ops: torch.Tensor) -> torch.Tensor:
    """(1, L) non-empty row count per lane."""
    return (ops != EMPTY).sum(dim=0, keepdim=True, dtype=torch.int32)


def row_at(tile: torch.Tensor, idx: torch.Tensor) -> torch.Tensor:
    """(1, L) value of per-lane row ``idx`` ((1, L) int32, in range)."""
    return torch.gather(tile, 0, idx.long())


def span_at(ops: torch.Tensor, idx: torch.Tensor, cfg: SurgeryConfig) -> torch.Tensor:
    """(1, L) subtree size at per-lane row ``idx``: ``idx - k + 1`` for the
    largest ``k <= idx`` with ``sum(1 - arity[k..idx]) == 1`` (``k = -1``
    when there is none, as in the JAX closed form)."""
    n = ops.shape[0]
    ri = _rows(n, ops)
    w = 1 - arity_tile(ops, cfg)
    csum = torch.cumsum(w, dim=0, dtype=torch.int32)
    c_at = row_at(csum, idx)
    valid = (c_at - (csum - w) == 1) & (ri <= idx)
    k = torch.where(valid, ri, -1).amax(dim=0, keepdim=True)
    return (idx - k + 1).to(torch.int32)


def shift_rows(tile: torch.Tensor, delta: torch.Tensor, valid: torch.Tensor, fill) -> torch.Tensor:
    """``out[j, l] = tile[j + delta[l], l]`` where valid and in range, else fill."""
    n = tile.shape[0]
    src = _rows(n, tile) + delta
    ok = valid & (src >= 0) & (src < n)
    moved = torch.gather(tile, 0, src.clamp(0, n - 1).long().expand_as(tile))
    return torch.where(ok, moved, torch.full_like(tile, fill))


# ------------------------------------------------------- structural primitives


def extract_block(ops, const, idx, span):
    """The subtree at per-lane row ``idx`` as a root-last block."""
    n = ops.shape[0]
    valid = _rows(n, ops) > (n - 1 - span)
    delta = idx - (n - 1)
    return shift_rows(ops, delta, valid, EMPTY), shift_rows(const, delta, valid, 0.0)


def splice_tiles(ops, const, idx, old_size, b_ops, b_const, bs):
    """Replace the subtree at ``idx`` (``old_size`` rows) with a block of
    ``bs`` rows."""
    n = ops.shape[0]
    ri = _rows(n, ops)
    delta = bs - old_size
    in_above = ri > idx
    in_block = (ri > idx - bs) & ~in_above
    below_valid = (ri + delta <= idx - old_size) & ~in_block & ~in_above
    t_ops = torch.where(in_above, ops, shift_rows(ops, delta, below_valid, EMPTY))
    t_const = torch.where(in_above, const, shift_rows(const, delta, below_valid, 0.0))
    blk_delta = (n - 1) - idx
    blk_ops = shift_rows(b_ops, blk_delta, in_block, EMPTY)
    blk_const = shift_rows(b_const, blk_delta, in_block, 0.0)
    return torch.where(in_block, blk_ops, t_ops), torch.where(in_block, blk_const, t_const)


def leaf_block_tiles(n: int, op, const):
    """(N, L) block holding one leaf at the root row; op/const are (1, L)."""
    root = _rows(n, op) == n - 1
    return (
        torch.where(root, op, EMPTY),
        torch.where(root & (op == CONST), const, 0.0),
    )


def _shift_down1(t):
    return torch.cat([t[1:], torch.zeros_like(t[:1])], dim=0)


def compose1_tiles(op, b_ops, b_const, b_size):
    """Block for unary ``op(child)``."""
    n = b_ops.shape[0]
    ri = _rows(n, b_ops)
    root = ri == n - 1
    valid = (ri > n - 2 - b_size) & ~root
    return (
        torch.where(root, op, torch.where(valid, _shift_down1(b_ops), EMPTY)),
        torch.where(root | ~valid, 0.0, _shift_down1(b_const)),
        b_size + 1,
    )


def compose2_tiles(op, a_ops, a_const, a_size, b_ops, b_const, b_size):
    """Block for binary ``op(first, second)``: first directly below the root,
    second below it."""
    n = a_ops.shape[0]
    ri = _rows(n, a_ops)
    root = ri == n - 1
    a_valid = (ri > n - 2 - a_size) & ~root
    off = 1 + a_size
    in_b = (ri > n - 1 - off - b_size) & (ri <= n - 1 - off)
    b_sh_ops = shift_rows(b_ops, off, in_b, EMPTY)
    b_sh_const = shift_rows(b_const, off, in_b, 0.0)
    out_ops = torch.where(
        root, op, torch.where(in_b, b_sh_ops, torch.where(a_valid, _shift_down1(a_ops), EMPTY))
    )
    out_const = torch.where(
        root, 0.0, torch.where(in_b, b_sh_const, torch.where(a_valid, _shift_down1(a_const), 0.0))
    )
    return out_ops, out_const, a_size + b_size + 1


# -------------------------------------------------------------- random draws


def _gumbel(u: torch.Tensor) -> torch.Tensor:
    u = u.clamp(1e-7, 1.0 - 1e-7)
    return -torch.log(-torch.log(u))


def choose_row(weights: torch.Tensor, u: torch.Tensor) -> torch.Tensor:
    """(1, L) categorical row draw by Gumbel argmax; ties go to the highest
    row, all-zero weights give row ``rows - 1``."""
    n = weights.shape[0]
    score = torch.where(
        weights > 0, torch.log(weights.clamp(min=1e-30)) + _gumbel(u), _NEG
    )
    m = score.amax(dim=0, keepdim=True)
    return torch.where(score == m, _rows(n, weights), -1).amax(dim=0, keepdim=True)


def normal_rows(urand: Rand, rows: int) -> torch.Tensor:
    """(rows, L) standard normals by Box-Muller."""
    u1 = urand(rows).clamp(1e-7, 1.0)
    u2 = urand(rows)
    return torch.sqrt(-2.0 * torch.log(u1)) * torch.cos(_TWO_PI * u2)


def leaf_rows_mask(ops, cfg: SurgeryConfig):
    return (ops == CONST) | (ops >= cfg.var_start)


def operator_rows_mask(ops, cfg: SurgeryConfig):
    return (ops >= OP_START) & (ops < cfg.var_start)


def _op_weights(cfg: SurgeryConfig, like: torch.Tensor) -> torch.Tensor:
    return torch.tensor(cfg.operator_probs, dtype=torch.float32, device=like.device)[:, None]


def sample_operator(urand: Rand, cfg: SurgeryConfig, l: int) -> torch.Tensor:
    """(1, L) operator opcode ~ operator_probs."""
    u = urand(cfg.num_operators)
    w = _op_weights(cfg, u).expand(-1, l)
    return choose_row(w, u) + OP_START


def _arity_of_op(op: torch.Tensor, cfg: SurgeryConfig) -> torch.Tensor:
    ar = torch.zeros_like(op)
    for code in range(OP_START, cfg.var_start):
        ar = torch.where(op == code, cfg.slots[code], ar)
    return ar


def sample_leaf(urand: Rand, vmask: torch.Tensor, cfg: SurgeryConfig, exclude_var=None):
    """50/50 constant-vs-variable leaf per lane; ``exclude_var`` (1, L)
    removes one variable opcode (a constant when none remains)."""
    v = vmask.shape[0]
    p = vmask
    if exclude_var is not None:
        var_ids = _rows(v, vmask) + cfg.var_start
        p = torch.where(var_ids == exclude_var, 0.0, p)
    has_var = p.sum(dim=0, keepdim=True) > 0
    var_row = choose_row(torch.where(has_var, p, torch.ones_like(p)), urand(v))
    coeff = normal_rows(urand, 1) * cfg.coefficient_sd
    take_const = (urand(1) < 0.5) | ~has_var
    op = torch.where(take_const, CONST, var_row + cfg.var_start).to(torch.int32)
    return op, torch.where(take_const, coeff, 0.0)


def compact_rows(ops: torch.Tensor, const: torch.Tensor):
    """Stable-pack non-EMPTY rows to the bottom (root-last, padding-first)."""
    n = ops.shape[0]
    kept = (ops != EMPTY).to(torch.int32)
    # destination row of a kept row: n - (number of kept rows at or below it)
    below = torch.flip(torch.cumsum(torch.flip(kept, [0]), dim=0), [0])
    dest = torch.where(kept != 0, n - below, n).long()  # n: dropped
    out_ops = torch.zeros((n + 1,) + ops.shape[1:], dtype=ops.dtype, device=ops.device)
    out_const = torch.zeros((n + 1,) + const.shape[1:], dtype=const.dtype, device=const.device)
    out_ops.scatter_(0, dest, ops)
    out_const.scatter_(0, dest, const)
    return out_ops[:n], out_const[:n]


# ------------------------------------------------------------- grow sampling


def sample_tree_tile(urand: Rand, vmask: torch.Tensor, cfg: SurgeryConfig, depth_limit: int):
    """Grow-sample one tree per lane: ``(ops (N, L), const (N, L), size (1, L))``.

    BFS order, operator probability ``0.7**depth``, leaves 50/50
    constant/variable, children EMPTY when the parent has no open slot or the
    ``max_nodes`` budget is spent; then compacted root-last.
    """
    n = cfg.n
    v, l = vmask.shape
    s, dfs_pos, dep, parent, is_left = bfs_tables(depth_limit)
    rows_ops: List[torch.Tensor] = [None] * s  # type: ignore[list-item]
    rows_const: List[torch.Tensor] = [None] * s  # type: ignore[list-item]
    open_slots = torch.ones((1, l), dtype=torch.int32, device=vmask.device)
    has_var = vmask.sum(dim=0, keepdim=True) > 0
    for i in range(s):
        coeff = normal_rows(urand, 1) * cfg.coefficient_sd
        var_row = choose_row(torch.where(has_var, vmask, torch.ones_like(vmask)), urand(v))
        take_const = (urand(1) < 0.5) | ~has_var
        leaf = torch.where(take_const, CONST, var_row + cfg.var_start).to(torch.int32)
        operator = sample_operator(urand, cfg, l)
        grow = (open_slots < n - i - 1) & (dep[i] + 1 < depth_limit)
        decay = float(np.float32(0.7 ** dep[i]))
        index = torch.where(grow & (urand(1) < decay), operator, leaf)
        index = torch.where(open_slots == 0, EMPTY, index)
        if i > 0:
            parent_ar = arity_tile(rows_ops[dfs_pos[parent[i]]], cfg)
            has_slot = parent_ar + (1 if is_left[i] else 0) > 1
            index = torch.where(~has_slot, EMPTY, index)
        index = index.to(torch.int32)
        rows_ops[dfs_pos[i]] = index
        rows_const[dfs_pos[i]] = torch.where(index == CONST, coeff, 0.0)
        open_slots = torch.where(
            index == EMPTY, open_slots, (open_slots + arity_tile(index, cfg) - 1).clamp(min=0)
        )
    pad = n - s
    buf_ops = torch.cat([torch.zeros((pad, l), dtype=torch.int32, device=vmask.device)] + rows_ops)
    buf_const = torch.cat([torch.zeros((pad, l), dtype=torch.float32, device=vmask.device)] + rows_const)
    out_ops, out_const = compact_rows(buf_ops, buf_const)
    return out_ops, out_const, sizes_tile(buf_ops)


# ----------------------------------------------------------------- crossover


def node_probs_tile(ops, cfg: SurgeryConfig):
    """Crossover node weights: operators 2, leaves 1, padding 0."""
    return (ops != EMPTY).float() + operator_rows_mask(ops, cfg).float()


def _subtrees_equal_tile(ops1, const1, n1, s1, ops2, const2, n2, s2, size1, size2):
    """The reference's subtree equality (same span, all rows equal, leaves by
    value), on tiles."""
    n = ops1.shape[0]
    ri = _rows(n, ops1)
    inrange = (ri > n1 - s1) & (ri <= n1)
    t2s_ops = shift_rows(ops2, n2 - n1, inrange, -1)
    t2s_const = shift_rows(const2, n2 - n1, inrange, 0.0)
    same_leaf = (ops1 == CONST) & (t2s_ops == CONST) & (const1 == t2s_const)
    rows_eq = ((ops1 == t2s_ops) & (ops1 > CONST)) | same_leaf
    any_bad = (inrange & ~rows_eq).any(dim=0, keepdim=True)
    multi = (size1 > 1) | (size2 > 1)
    return (s1 == s2) & multi & ~any_bad


def crossover_tiles(ops1, const1, ops2, const2, urand: Rand, cfg: SurgeryConfig):
    """Subtree exchange with bounded rejection: ``cx_retries`` node pairs,
    the first valid one wins, identity when none is."""
    n, l = ops1.shape
    w1 = node_probs_tile(ops1, cfg)
    w2 = node_probs_tile(ops2, cfg)
    size1 = sizes_tile(ops1)
    size2 = sizes_tile(ops2)
    empty1 = n - size1
    empty2 = n - size2
    done = torch.zeros((1, l), dtype=torch.bool, device=ops1.device)
    idx1 = torch.zeros((1, l), dtype=torch.int32, device=ops1.device)
    idx2 = torch.zeros_like(idx1)
    for _ in range(cfg.cx_retries):
        c1 = choose_row(w1, urand(n))
        c2 = choose_row(w2, urand(n))
        s1 = span_at(ops1, c1, cfg)
        s2 = span_at(ops2, c2, cfg)
        fits = (empty1 >= s2 - s1) & (empty2 >= s1 - s2)
        eq = _subtrees_equal_tile(ops1, const1, c1, s1, ops2, const2, c2, s2, size1, size2)
        valid = fits & ~eq
        take = valid & ~done
        idx1 = torch.where(take, c1, idx1)
        idx2 = torch.where(take, c2, idx2)
        done = done | valid
    s1 = span_at(ops1, idx1, cfg)
    s2 = span_at(ops2, idx2, cfg)
    b1_ops, b1_const = extract_block(ops1, const1, idx1, s1)
    b2_ops, b2_const = extract_block(ops2, const2, idx2, s2)
    o1_ops, o1_const = splice_tiles(ops1, const1, idx1, s1, b2_ops, b2_const, s2)
    o2_ops, o2_const = splice_tiles(ops2, const2, idx2, s2, b1_ops, b1_const, s1)
    return (
        torch.where(done, o1_ops, ops1),
        torch.where(done, o1_const, const1),
        torch.where(done, o2_ops, ops2),
        torch.where(done, o2_const, const2),
    )


# ------------------------------------------------------------------ mutation

# applicability of the 7 mutations by tree size class (reference
# get_mutations): add_subtree, mutate_leaf, mutate_operator, delete_operator,
# prepend_operator, insert_operator, replace_tree
PROBS_DEFAULT = (1, 1, 1, 1, 1, 1, 1)
PROBS_FULL = (0, 1, 1, 1, 0, 0, 1)
PROBS_SMALL = (1, 1, 1, 0, 1, 0, 1)
PROBS_LEAF = (1, 1, 0, 0, 1, 0, 1)


def mutation_probs_tile(ops, cfg: SurgeryConfig):
    """(7, L) per-lane mutation weights by tree size class."""
    size = sizes_tile(ops)
    empty = cfg.n - size

    def table(t):
        return torch.tensor(t, dtype=torch.float32, device=ops.device)[:, None]

    return torch.where(
        size == 1, table(PROBS_LEAF),
        torch.where(size <= 3, table(PROBS_SMALL),
                    torch.where(empty < 8, table(PROBS_FULL), table(PROBS_DEFAULT))),
    )


def mutate_tiles(ops, const, vmask, urand: Rand, cfg: SurgeryConfig, fresh_ops, fresh_const):
    """One mutation per lane: ``which`` ~ applicability weights, then the
    seven operators as one parametrised splice; ``fresh_*`` is the tree that
    replace_tree uses."""
    n, l = ops.shape
    ri = _rows(n, ops)
    size = sizes_tile(ops)
    empty = n - size
    one = torch.ones((1, l), dtype=torch.int32, device=ops.device)

    which = choose_row(mutation_probs_tile(ops, cfg), urand(7))

    b2_ops, b2_const, b2_size = sample_tree_tile(urand, vmask, cfg, 2)
    leafmask = leaf_rows_mask(ops, cfg).float()
    opmask = operator_rows_mask(ops, cfg).float()
    opmask_nonroot = opmask * (ri < n - 1).float()
    has_op = opmask.sum(dim=0, keepdim=True) > 0
    has_nonroot = opmask_nonroot.sum(dim=0, keepdim=True) > 0

    # 0: add_subtree — leaf -> depth-2 subtree
    idx_add = choose_row(leafmask, urand(n))
    add_fits = empty >= b2_size - 1

    # 1: mutate_leaf — leaf -> different leaf
    idx_ml = choose_row(leafmask, urand(n))
    ml_op, ml_const = sample_leaf(urand, vmask, cfg, exclude_var=row_at(ops, idx_ml))

    # 2: mutate_operator — bounded retries over (node, new operator) pairs
    w_mo = torch.where(has_op, opmask, torch.ones_like(opmask))
    mo_done = torch.zeros((1, l), dtype=torch.bool, device=ops.device)
    mo_idx = torch.zeros_like(one)
    mo_op = torch.zeros_like(one)
    for _ in range(cfg.mut_retries):
        cand = choose_row(w_mo, urand(n))
        new_op = sample_operator(urand, cfg, l)
        spn = span_at(ops, cand, cfg)
        need = torch.where(_arity_of_op(new_op, cfg) == 2, 7, 8)
        ok = has_op & (row_at(ops, cand) != new_op) & (empty + spn >= need)
        take = ok & ~mo_done
        mo_idx = torch.where(take, cand, mo_idx)
        mo_op = torch.where(take, new_op, mo_op)
        mo_done = mo_done | ok
    mo_span = span_at(ops, mo_idx, cfg)
    mo_old_ar = row_at(arity_tile(ops, cfg), mo_idx)
    mo_new_ar = _arity_of_op(mo_op, cfg)
    same_arity = mo_old_ar == mo_new_ar
    mo1_ops, mo1_const, mo1_size = compose1_tiles(mo_op, b2_ops, b2_const, b2_size)
    la_op, la_const = sample_leaf(urand, vmask, cfg)
    lb_op, lb_const = sample_leaf(urand, vmask, cfg)
    la_blk = leaf_block_tiles(n, la_op, la_const)
    lb_blk = leaf_block_tiles(n, lb_op, lb_const)
    mo2_ops, mo2_const, mo2_size = compose2_tiles(mo_op, *la_blk, one, *lb_blk, one)

    # 3: delete_operator — non-root operator subtree -> leaf
    w_nonroot = torch.where(has_nonroot, opmask_nonroot, torch.ones_like(opmask))
    idx_del = choose_row(w_nonroot, urand(n))
    del_span = span_at(ops, idx_del, cfg)
    del_op, del_const = sample_leaf(urand, vmask, cfg)
    del_blk_ops, del_blk_const = leaf_block_tiles(n, del_op, del_const)

    # 4: prepend_operator — new root above the whole tree
    pre_op = sample_operator(urand, cfg, l)
    pre_ar = _arity_of_op(pre_op, cfg)
    pre_side = urand(1) < 0.5  # True: the sampled subtree is the first operand
    pre1_ops, pre1_const, pre1_size = compose1_tiles(pre_op, ops, const, size)
    pre2_ops, pre2_const, pre2_size = compose2_tiles(
        pre_op,
        torch.where(pre_side, b2_ops, ops), torch.where(pre_side, b2_const, const),
        torch.where(pre_side, b2_size, size),
        torch.where(pre_side, ops, b2_ops), torch.where(pre_side, const, b2_const),
        torch.where(pre_side, size, b2_size),
    )
    pre_blk_ops = torch.where(pre_ar == 1, pre1_ops, pre2_ops)
    pre_blk_const = torch.where(pre_ar == 1, pre1_const, pre2_const)
    pre_bs = torch.where(pre_ar == 1, pre1_size, pre2_size)
    pre_fits = pre_bs <= n

    # 5: insert_operator — new operator spliced above a non-root operator
    idx_ins = choose_row(w_nonroot, urand(n))
    ins_span = span_at(ops, idx_ins, cfg)
    ins_op = sample_operator(urand, cfg, l)
    ins_ar = _arity_of_op(ins_op, cfg)
    old_ops, old_const = extract_block(ops, const, idx_ins, ins_span)
    ins_side = urand(1) < 0.5
    ins1_ops, ins1_const, ins1_size = compose1_tiles(ins_op, old_ops, old_const, ins_span)
    ins2_ops, ins2_const, ins2_size = compose2_tiles(
        ins_op,
        torch.where(ins_side, b2_ops, old_ops), torch.where(ins_side, b2_const, old_const),
        torch.where(ins_side, b2_size, ins_span),
        torch.where(ins_side, old_ops, b2_ops), torch.where(ins_side, old_const, b2_const),
        torch.where(ins_side, ins_span, b2_size),
    )
    ins_blk_ops = torch.where(ins_ar == 1, ins1_ops, ins2_ops)
    ins_blk_const = torch.where(ins_ar == 1, ins1_const, ins2_const)
    ins_bs = torch.where(ins_ar == 1, ins1_size, ins2_size)
    ins_fits = empty >= ins_bs - ins_span

    # one parametrised splice
    def pick(case_vals, default):
        out = default
        for c, v in case_vals:
            out = torch.where(which == c, v, out)
        return out

    ml_blk_ops, ml_blk_const = leaf_block_tiles(n, ml_op, ml_const)
    mo_blk_ops = torch.where(mo_new_ar == 1, mo1_ops, mo2_ops)
    mo_blk_const = torch.where(mo_new_ar == 1, mo1_const, mo2_const)
    mo_bs = torch.where(mo_new_ar == 1, mo1_size, mo2_size)
    sp_idx = pick([(0, idx_add), (1, idx_ml), (2, mo_idx), (3, idx_del), (5, idx_ins)],
                  torch.full_like(one, n - 1))
    sp_old = pick([(0, one), (1, one), (2, mo_span), (3, del_span), (5, ins_span)], size)
    sp_blk_ops = pick([(0, b2_ops), (1, ml_blk_ops), (2, mo_blk_ops), (3, del_blk_ops),
                       (5, ins_blk_ops)], pre_blk_ops)
    sp_blk_const = pick([(0, b2_const), (1, ml_blk_const), (2, mo_blk_const),
                         (3, del_blk_const), (5, ins_blk_const)], pre_blk_const)
    sp_bs = pick([(0, b2_size), (1, one), (2, mo_bs), (3, one), (5, ins_bs)], pre_bs)
    out_ops, out_const = splice_tiles(ops, const, sp_idx, sp_old, sp_blk_ops, sp_blk_const, sp_bs)

    # per-case validity: an invalid case leaves the tree unchanged
    no = torch.zeros_like(has_op)
    valid = pick(
        [(0, add_fits), (1, ~no), (2, mo_done & ~same_arity), (3, has_nonroot),
         (4, pre_fits), (5, has_nonroot & ins_fits)],
        no,
    )
    out_ops = torch.where(valid, out_ops, ops)
    out_const = torch.where(valid, out_const, const)
    # mutate_operator with the same arity: in-place opcode swap
    swap = (which == 2) & mo_done & same_arity
    out_ops = torch.where(swap & (ri == mo_idx), mo_op, out_ops)
    # replace_tree: the pre-sampled fresh tree
    out_ops = torch.where(which == 6, fresh_ops, out_ops)
    out_const = torch.where(which == 6, fresh_const, out_const)
    return out_ops, out_const


# ----------------------------------------------------------- full reproduce


def reproduce_tiles(p1_ops, p1_const, p2_ops, p2_const, cxflag, act1, act2, vmask,
                    urand: Rand, cfg: SurgeryConfig):
    """Two children per lane from two parents and per-lane actions.

    ``cxflag`` (1, L) bool exchanges subtrees; otherwise ``act`` (1, L) is
    0 = copy the parent, 1 = mutate it, 2 = a fresh tree at ``max_init_depth``.
    """
    f1_ops, f1_const, _ = sample_tree_tile(urand, vmask, cfg, cfg.max_init_depth)
    f2_ops, f2_const, _ = sample_tree_tile(urand, vmask, cfg, cfg.max_init_depth)
    x1_ops, x1_const, x2_ops, x2_const = crossover_tiles(p1_ops, p1_const, p2_ops, p2_const, urand, cfg)
    m1_ops, m1_const = mutate_tiles(p1_ops, p1_const, vmask, urand, cfg, f1_ops, f1_const)
    m2_ops, m2_const = mutate_tiles(p2_ops, p2_const, vmask, urand, cfg, f2_ops, f2_const)

    def out(p_ops, p_const, x_ops, x_const, m_ops, m_const, f_ops, f_const, act):
        o_ops = torch.where(act == 1, m_ops, torch.where(act == 2, f_ops, p_ops))
        o_const = torch.where(act == 1, m_const, torch.where(act == 2, f_const, p_const))
        return torch.where(cxflag, x_ops, o_ops), torch.where(cxflag, x_const, o_const)

    c1 = out(p1_ops, p1_const, x1_ops, x1_const, m1_ops, m1_const, f1_ops, f1_const, act1)
    c2 = out(p2_ops, p2_const, x2_ops, x2_const, m2_ops, m2_const, f2_ops, f2_const, act2)
    return c1[0], c1[1], c2[0], c2[1]


# ------------------------------------------------------------ uniform rows


class BufferRand:
    """``urand`` reading consecutive rows of a ``(R, L)`` uniform buffer —
    the row order the reproduction kernel reads its buffer in."""

    def __init__(self, u: torch.Tensor):
        self.u = u
        self.row = 0

    def __call__(self, rows: int) -> torch.Tensor:
        if self.row + rows > self.u.shape[0]:
            raise ValueError(f"uniform buffer of {self.u.shape[0]} rows exhausted")
        out = self.u[self.row:self.row + rows]
        self.row += rows
        return out


class CountingRand:
    """``urand`` that counts the rows drawn (and returns zeros)."""

    def __init__(self, l: int):
        self.l = l
        self.row = 0

    def __call__(self, rows: int) -> torch.Tensor:
        self.row += rows
        return torch.zeros((rows, self.l), dtype=torch.float32)


def rows_per_lane(cfg: SurgeryConfig) -> int:
    """Uniform rows one lane of :func:`reproduce_tiles` consumes, counted by
    running it once on a one-lane tile."""
    ops = torch.zeros((cfg.n, 1), dtype=torch.int32)
    ops[-1] = CONST
    const = torch.zeros((cfg.n, 1), dtype=torch.float32)
    flag = torch.zeros((1, 1), dtype=torch.bool)
    act = torch.zeros((1, 1), dtype=torch.int32)
    vmask = torch.ones((cfg.num_vars, 1), dtype=torch.float32)
    counter = CountingRand(1)
    reproduce_tiles(ops, const, ops, const, flag, act, act, vmask, counter, cfg)
    return counter.row
