"""The seven mutation operators, built on the splice primitive.

Port of ``multitreegp_tpu/ops/mutation.py`` (reference
``genetic_operators/mutation.py``), operator by operator:

0. ``add_subtree``: a leaf becomes a fresh depth-2 subtree.
1. ``mutate_leaf``: a leaf becomes a *different* leaf (the old variable
   is left out of the draw; constants may stay constants).
2. ``mutate_operator``: an operator becomes a different operator; a change
   of arity discards the old operands for fresh ones (a depth-2 subtree for
   2 -> 1, two depth-1 leaves for 1 -> 2); the replacement must fit (the
   reference's sizes 7 / 8). ``MUT_RETRIES`` attempts, the first valid one
   taken.
3. ``delete_operator``: a non-root operator's subtree becomes a leaf.
4. ``prepend_operator``: a new operator becomes the root, the old tree one
   operand and (binary) a fresh depth-2 subtree the other, a coin flip
   deciding the side.
5. ``insert_operator``: a new operator above a non-root operator, the old
   subtree on a coin-flipped side.
6. ``replace_tree``: the tree resampled at ``max_init_depth``.

Applicability per tree (``get_mutation_probs``, reference ``get_mutations``
:523-539): fewer than 8 empty rows: no growth; at most 3 rows: no
delete/insert; one row: no operator mutation either. Each operator leaves a
tree unchanged where its preconditions fail, so no child is invalid.

Every operator takes trees of any batch shape ``B`` and their variable
masks ``(*B, V)``; every draw comes from the caller's ``torch.Generator``.
``mutate_tree`` draws each tree's operator, runs all seven on the batch and
keeps each tree's own (JAX's ``lax.switch`` under ``vmap`` computes every
branch the same way).
"""
from __future__ import annotations

import math
from typing import Callable, Tuple

import torch

from ..core.registry import FunctionSet
from ..core.trees import CONST, OP_START, TreeTensors, subtree_span_at, tree_sizes
from .crossover import draw_rows, first_valid, forced_bernoulli_mask
from .splice import compose1, compose2, extract_subtree, leaf_block, splice

MUT_RETRIES = 8
NUM_MUTATIONS = 7

# the reference's get_mutations tables (mutation.py:534-537)
_PROBS_DEFAULT = (1.0, 1.0, 1.0, 1.0, 1.0, 1.0, 1.0)
_PROBS_FULL = (0.0, 1.0, 1.0, 1.0, 0.0, 0.0, 1.0)
_PROBS_SMALL = (1.0, 1.0, 1.0, 0.0, 1.0, 0.0, 1.0)
_PROBS_LEAF = (1.0, 1.0, 0.0, 0.0, 1.0, 0.0, 1.0)


def _select(cond: torch.Tensor, a: TreeTensors, b: TreeTensors) -> TreeTensors:
    """Per tree (``cond`` of the batch shape), ``a`` where True."""
    return TreeTensors(*(torch.where(cond[..., None], x, y) for x, y in zip(a, b)))


def _leaf_rows(ops: torch.Tensor, var_start: int) -> torch.Tensor:
    return (ops == CONST) | (ops >= var_start)


def _operator_rows(ops: torch.Tensor, var_start: int) -> torch.Tensor:
    return (ops >= OP_START) & (ops < var_start)


def _choose_row(probs: torch.Tensor, generator: torch.Generator) -> torch.Tensor:
    """One row per tree with probability proportional to ``probs``."""
    return draw_rows(probs, 1, generator)[..., 0]


def _draw_operators(fset: FunctionSet, shape, generator: torch.Generator) -> torch.Tensor:
    """Operator opcodes of batch ``shape`` drawn by the operators' weights."""
    shape = tuple(shape)
    probs = fset.probs(generator.device).expand(math.prod(shape), -1)
    ops = torch.multinomial(probs, 1, generator=generator)
    return (ops.reshape(shape) + OP_START).to(torch.int32)


def _side_coin(shape, generator: torch.Generator) -> torch.Tensor:
    """Per tree, whether the old subtree goes second under a new binary
    operator (a fair coin)."""
    return torch.rand(shape, generator=generator, device=generator.device) < 0.5


def _set_row(x: torch.Tensor, idx: torch.Tensor, value: torch.Tensor) -> torch.Tensor:
    """``x`` with row ``idx`` of each tree set to ``value``."""
    return x.scatter(-1, idx[..., None].long(), value[..., None].to(x.dtype))


def _sample_leaf(generator: torch.Generator, fset: FunctionSet, variable_mask: torch.Tensor,
                 coefficient_sd: float, exclude_var: torch.Tensor = None):
    """50/50 constant vs variable leaves, one per row of ``variable_mask
    (*B, V)``: ``(op, coefficient)`` of batch ``B``. ``exclude_var`` (an
    opcode per tree) leaves that variable out of the draw; with no variable
    left the leaf is a constant."""
    dev = generator.device
    shape = variable_mask.shape[:-1]
    coeff = torch.randn(shape, generator=generator, device=dev) * coefficient_sd
    p = variable_mask
    if exclude_var is not None:
        v = fset.num_variables
        idx = (exclude_var - fset.var_start).clamp(0, v - 1)
        drop = (exclude_var >= fset.var_start)[..., None] & (
            torch.arange(v, device=dev) == idx[..., None])
        p = torch.where(drop, 0.0, p)
    has_var = p.sum(dim=-1) > 0
    weights = torch.where(has_var[..., None], p, torch.ones_like(p)).reshape(-1, p.shape[-1])
    var_op = torch.multinomial(weights, 1, generator=generator).reshape(shape).to(torch.int32)
    take_const = (torch.rand(shape, generator=generator, device=dev) < 0.5) | ~has_var
    op = torch.where(take_const, CONST, var_op + fset.var_start)
    return op, torch.where(take_const, coeff, 0.0)


def make_mutators(fset: FunctionSet, sample_tree: Callable, max_nodes: int, max_init_depth: int,
                  coefficient_sd: float = 1.0):
    """Build the seven mutation operators and their dispatch: returns
    ``(mutate_candidate, mutate_tree, mutators)``. ``sample_tree`` is
    :func:`~.initialization.make_tree_sampler`'s."""
    n = max_nodes
    var_start = fset.var_start

    def block_of(tree: TreeTensors) -> Tuple[TreeTensors, torch.Tensor]:
        size = tree_sizes(tree)
        return extract_subtree(tree, n - 1, size), size

    def operator_probs(tree: TreeTensors, root: bool):
        rows = _operator_rows(tree.ops, var_start)
        if not root:
            rows = rows.clone()
            rows[..., n - 1] = False
        has = rows.any(dim=-1)
        return has, torch.where(has[..., None], rows.to(torch.float32), 1.0)

    # -- 0: add_subtree --------------------------------------------------------
    def add_subtree(tree, generator, vmask):
        idx = _choose_row(_leaf_rows(tree.ops, var_start).to(torch.float32), generator)
        block, bs = block_of(sample_tree(generator, 2, vmask))
        fits = (n - tree_sizes(tree)) >= bs - 1
        return _select(fits, splice(tree, idx, 1, block, bs), tree)

    # -- 1: mutate_leaf --------------------------------------------------------
    def mutate_leaf(tree, generator, vmask):
        idx = _choose_row(_leaf_rows(tree.ops, var_start).to(torch.float32), generator)
        old = torch.gather(tree.ops, -1, idx[..., None].long())[..., 0]
        op, coeff = _sample_leaf(generator, fset, vmask, coefficient_sd, exclude_var=old)
        return tree._replace(ops=_set_row(tree.ops, idx, op),
                             const=_set_row(tree.const, idx, torch.where(op == CONST, coeff, 0.0)))

    # -- 2: mutate_operator ----------------------------------------------------
    def mutate_operator(tree, generator, vmask):
        slots = fset.slots(tree.device)
        has_op, probs = operator_probs(tree, root=True)
        empty = n - tree_sizes(tree)
        idxs = draw_rows(probs, MUT_RETRIES, generator)
        new_ops = _draw_operators(fset, idxs.shape, generator)
        spans = subtree_span_at(tree.ops[..., None, :], slots, idxs)
        need = torch.where(slots[new_ops.long()] == 2, 7, 8)
        old_ops = torch.gather(tree.ops, -1, idxs.long())
        valid = (old_ops != new_ops) & (empty[..., None] + spans >= need) & has_op[..., None]
        ok, idx, new_op, span, old_op = first_valid(valid, idxs, new_ops, spans, old_ops)
        old_arity, new_arity = slots[old_op.long()], slots[new_op.long()]

        same = tree._replace(ops=_set_row(tree.ops, idx, new_op))
        # 2 -> 1: a fresh depth-2 subtree under the new unary operator
        sub_b, sub_s = block_of(sample_tree(generator, 2, vmask))
        blk1, bs1 = compose1(new_op, sub_b, sub_s)
        to_unary = splice(tree, idx, span, blk1, bs1)
        # 1 -> 2: two fresh depth-1 leaves under the new binary operator
        la_b, la_s = block_of(sample_tree(generator, 1, vmask))
        lb_b, lb_s = block_of(sample_tree(generator, 1, vmask))
        blk2, bs2 = compose2(new_op, la_b, la_s, lb_b, lb_s)
        to_binary = splice(tree, idx, span, blk2, bs2)
        out = _select(old_arity == new_arity, same, _select(new_arity == 1, to_unary, to_binary))
        return _select(ok, out, tree)

    # -- 3: delete_operator ----------------------------------------------------
    def delete_operator(tree, generator, vmask):
        slots = fset.slots(tree.device)
        has, probs = operator_probs(tree, root=False)
        idx = _choose_row(probs, generator)
        span = subtree_span_at(tree.ops, slots, idx)
        op, coeff = _sample_leaf(generator, fset, vmask, coefficient_sd)
        return _select(has, splice(tree, idx, span, leaf_block(n, op, coeff), 1), tree)

    def over(new_op, old_b, old_s, generator, vmask):
        """The block of ``new_op`` over ``old_b`` (``old_s`` rows): unary
        ``new_op(old)``; binary with a fresh depth-2 subtree, ``old`` first
        or second by a coin flip."""
        sub_b, sub_s = block_of(sample_tree(generator, 2, vmask))
        second = _side_coin(new_op.shape, generator)
        blk_u, bs_u = compose1(new_op, old_b, old_s)
        first_b, first_s = _select(second, sub_b, old_b), torch.where(second, sub_s, old_s)
        second_b, second_s = _select(second, old_b, sub_b), torch.where(second, old_s, sub_s)
        blk_b, bs_b = compose2(new_op, first_b, first_s, second_b, second_s)
        unary = fset.slots(new_op.device)[new_op.long()] == 1
        return _select(unary, blk_u, blk_b), torch.where(unary, bs_u, bs_b)

    # -- 4: prepend_operator ---------------------------------------------------
    def prepend_operator(tree, generator, vmask):
        new_op = _draw_operators(fset, tree.batch_shape, generator)
        tree_b, size = block_of(tree)
        blk, bs = over(new_op, tree_b, size, generator, vmask)
        return _select(bs <= n, splice(tree, n - 1, size, blk, bs), tree)

    # -- 5: insert_operator ----------------------------------------------------
    def insert_operator(tree, generator, vmask):
        slots = fset.slots(tree.device)
        has, probs = operator_probs(tree, root=False)
        idx = _choose_row(probs, generator)
        span = subtree_span_at(tree.ops, slots, idx)
        new_op = _draw_operators(fset, tree.batch_shape, generator)
        blk, bs = over(new_op, extract_subtree(tree, idx, span), span, generator, vmask)
        fits = (n - tree_sizes(tree)) >= bs - span
        return _select(has & fits, splice(tree, idx, span, blk, bs), tree)

    # -- 6: replace_tree -------------------------------------------------------
    def replace_tree(tree, generator, vmask):
        return sample_tree(generator, max_init_depth, vmask)

    mutators = [add_subtree, mutate_leaf, mutate_operator, delete_operator, prepend_operator,
                insert_operator, replace_tree]

    def mutate_tree(tree: TreeTensors, generator: torch.Generator,
                    variable_mask: torch.Tensor) -> TreeTensors:
        """One mutation per tree, its operator drawn by
        :func:`get_mutation_probs`; ``variable_mask`` ``(*B, V)``."""
        probs = get_mutation_probs(tree)
        which = torch.multinomial(probs.reshape(-1, NUM_MUTATIONS), 1, generator=generator)
        which = which.reshape(tree.batch_shape)
        out = tree
        for k, mutate in enumerate(mutators):
            out = _select(which == k, mutate(tree, generator, variable_mask), out)
        return out

    def mutate_candidate(trees: TreeTensors, generator: torch.Generator,
                         reproduction_probability: torch.Tensor,
                         variable_mask: torch.Tensor) -> TreeTensors:
        """Mutate candidates ``(..., num_trees, N)`` under a forced Bernoulli
        mask over their trees (reference ``mutate_trees``, :555-577);
        ``variable_mask`` ``(num_trees, V)``."""
        shape, m = trees.batch_shape[:-1], trees.batch_shape[-1]
        mask = forced_bernoulli_mask(reproduction_probability, m, shape, generator)
        vmask = variable_mask.to(trees.device).expand(tuple(trees.batch_shape) + (-1,))
        return _select(mask, mutate_tree(trees, generator, vmask), trees)

    return mutate_candidate, mutate_tree, mutators


def get_mutation_probs(tree: TreeTensors) -> torch.Tensor:
    """Per tree, the weights of the seven operators (reference
    ``get_mutations``, :523-539): float32 ``(*B, 7)``."""
    size = tree_sizes(tree)[..., None]
    table = lambda t: torch.tensor(t, dtype=torch.float32, device=tree.device)
    probs = torch.where(tree.max_nodes - size < 8, table(_PROBS_FULL), table(_PROBS_DEFAULT))
    probs = torch.where(size <= 3, table(_PROBS_SMALL), probs)
    return torch.where(size == 1, table(_PROBS_LEAF), probs)
