"""Subtree crossover (extract + splice, bounded rejection) and the per-tree
masks of crossover and mutation.

Port of ``multitreegp_tpu/ops/crossover.py`` (reference
``genetic_operators/crossover.py``): crossover points are drawn from the
non-empty rows, operators weighted 2:1 over leaves; a pair of points is
rejected when the exchanged subtrees would overflow either tree's
``max_nodes``, or when the two subtrees are equal (same size and row by
row the same operator or variable, or constants of equal value; two
single-row trees are exempt). ``CX_RETRIES`` pairs are drawn and the first
valid one is taken; with none valid the trees stay as they are. A forced
Bernoulli mask picks which trees of a candidate cross.

Batched over leading dimensions; every draw comes from the caller's
``torch.Generator``. The fused path (``core/cuda_reproduction.py``) runs the
same law inside kernel #2.
"""
from __future__ import annotations

from typing import Tuple

import torch

from ..core.registry import FunctionSet
from ..core.trees import CONST, EMPTY, OP_START, TreeTensors, subtree_span_at, tree_sizes
from .splice import extract_subtree, splice

CX_RETRIES = 8


def forced_bernoulli_mask(p: torch.Tensor, m: int, shape, generator: torch.Generator) -> torch.Tensor:
    """Bernoulli(p) masks over ``m`` trees with at least one success.

    ``p`` broadcasts against ``shape``; returns bool ``shape + (m,)``. An
    all-zero draw is replaced by one uniformly chosen tree (the JAX package's
    bounded version of the reference's resample-until-non-zero).
    """
    dev = generator.device
    shape = tuple(shape)
    mask = torch.rand(shape + (m,), generator=generator, device=dev) < p[..., None]
    pick = torch.randint(0, m, shape, generator=generator, device=dev)
    force = torch.nn.functional.one_hot(pick, m).to(torch.bool)
    return torch.where(mask.any(dim=-1, keepdim=True), mask, force)


def _node_probs(ops: torch.Tensor, var_start: int) -> torch.Tensor:
    """Sampling weights over rows: operators 2, leaves 1, padding 0."""
    is_op = (ops >= OP_START) & (ops < var_start)
    return (ops != EMPTY).to(torch.float32) + is_op.to(torch.float32)


def _rows_at(x: torch.Tensor, rows: torch.Tensor) -> torch.Tensor:
    """``x[..., rows]`` per tree, ``x (..., N)`` broadcast against ``rows``."""
    batch = torch.broadcast_shapes(x.shape[:-1], rows.shape[:-1])
    return torch.gather(x.expand(batch + x.shape[-1:]), -1, rows.expand(batch + rows.shape[-1:]))


def draw_rows(probs: torch.Tensor, k: int, generator: torch.Generator) -> torch.Tensor:
    """``k`` rows per tree, drawn with replacement with weights ``probs
    (..., N)`` (each row of positive sum): int32 ``(..., k)``."""
    flat = probs.reshape(-1, probs.shape[-1])
    rows = torch.multinomial(flat, k, replacement=True, generator=generator)
    return rows.reshape(probs.shape[:-1] + (k,)).to(torch.int32)


def _subtrees_equal(t1: TreeTensors, n1: torch.Tensor, s1: torch.Tensor, t2: TreeTensors,
                    n2: torch.Tensor, s2: torch.Tensor) -> torch.Tensor:
    """Whether the subtrees at rows ``n1`` of ``t1`` and ``n2`` of ``t2``
    (sizes ``s1``, ``s2``) are equal, by the reference's semantics
    (``crossover.py:42-58,84-88``)."""
    n = t1.max_nodes
    o = torch.arange(n, dtype=torch.int32, device=t1.device)
    r1 = (n1[..., None] - o).clamp(0, n - 1).long()
    r2 = (n2[..., None] - o).clamp(0, n - 1).long()
    ops1, ops2 = _rows_at(t1.ops, r1), _rows_at(t2.ops, r2)
    same_leaf = (ops1 == CONST) & (ops2 == CONST) & (_rows_at(t1.const, r1) == _rows_at(t2.const, r2))
    rows_eq = ((ops1 == ops2) & (ops1 > CONST)) | same_leaf
    all_eq = torch.where(o < s1[..., None], rows_eq, True).all(dim=-1)
    multi = (tree_sizes(t1) > 1) | (tree_sizes(t2) > 1)
    return (s1 == s2) & multi & all_eq


def first_valid(valid: torch.Tensor, *choices: torch.Tensor):
    """``(ok, choices at the first valid attempt)`` along the last axis
    (the first attempt where none is valid)."""
    pick = torch.argmax(valid.to(torch.int32), dim=-1, keepdim=True)
    return (valid.any(dim=-1),) + tuple(torch.gather(c, -1, pick)[..., 0] for c in choices)


def crossover_trees(tree1: TreeTensors, tree2: TreeTensors, generator: torch.Generator,
                    fset: FunctionSet) -> Tuple[TreeTensors, TreeTensors]:
    """Cross pairs of trees of one batch shape: the subtree at a drawn row
    of each tree goes into the other."""
    n = tree1.max_nodes
    slots = fset.slots(tree1.device)
    n1s = draw_rows(_node_probs(tree1.ops, fset.var_start), CX_RETRIES, generator)
    n2s = draw_rows(_node_probs(tree2.ops, fset.var_start), CX_RETRIES, generator)
    s1s = subtree_span_at(tree1.ops[..., None, :], slots, n1s)
    s2s = subtree_span_at(tree2.ops[..., None, :], slots, n2s)
    empty1 = (n - tree_sizes(tree1))[..., None]
    empty2 = (n - tree_sizes(tree2))[..., None]
    fits = (empty1 >= s2s - s1s) & (empty2 >= s1s - s2s)
    wide1, wide2 = tree1.map(lambda a: a[..., None, :]), tree2.map(lambda a: a[..., None, :])
    valid = fits & ~_subtrees_equal(wide1, n1s, s1s, wide2, n2s, s2s)
    ok, n1, n2, s1, s2 = first_valid(valid, n1s, n2s, s1s, s2s)

    b1 = extract_subtree(tree1, n1, s1)
    b2 = extract_subtree(tree2, n2, s2)
    c1 = splice(tree1, n1, s1, b2, s2)
    c2 = splice(tree2, n2, s2, b1, s1)
    keep = lambda new, old: TreeTensors(*(torch.where(ok[..., None], a, b) for a, b in zip(new, old)))
    return keep(c1, tree1), keep(c2, tree2)


def crossover_candidates(parent1: TreeTensors, parent2: TreeTensors, generator: torch.Generator,
                         reproduction_probability: torch.Tensor,
                         fset: FunctionSet) -> Tuple[TreeTensors, TreeTensors]:
    """Cross candidates ``(..., num_trees, N)`` tree by tree under a forced
    Bernoulli mask (``reproduction_probability`` broadcasts against the
    candidates' batch)."""
    shape = parent1.batch_shape[:-1]
    mask = forced_bernoulli_mask(reproduction_probability, parent1.batch_shape[-1], shape,
                                 generator)[..., None]
    c1, c2 = crossover_trees(parent1, parent2, generator, fset)
    sel = lambda new, old: TreeTensors(*(torch.where(mask, a, b) for a, b in zip(new, old)))
    return sel(c1, parent1), sel(c2, parent2)
