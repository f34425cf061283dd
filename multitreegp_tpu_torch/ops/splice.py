"""Subtree surgery: extract, splice and compose, batched over trees.

Port of ``multitreegp_tpu/ops/splice.py``. The layout keeps a subtree in a
contiguous row range (root-last, padding-first), so crossover and every
structural mutation are one primitive:

    splice(tree, node_idx, old_size, block, block_size)
        "replace the subtree in rows (node_idx - old_size, node_idx] with
         the block_size rows of block"

plus ``extract_subtree`` (a subtree as a root-last block) and
``compose1``/``compose2`` (an operator over child blocks). Each is a gather
with a closed-form row map. A *block* is a tree fragment in its own N-row
buffer: rows (N-1-size, N-1], root at N-1, absolute child pointers.

Splice row map: with ``end = node_idx - old_size`` and ``delta = block_size
- old_size``, output row j comes from tree row j above ``node_idx``, from
block row ``j + (N-1-node_idx)`` in ``(node_idx - block_size, node_idx]``,
and from tree row ``j + delta`` below (rows shifted past the bottom become
padding). Tree pointers ``p <= end`` move by ``-delta``; block pointers by
``node_idx - (N-1)``.

Every function takes trees of any batch shape ``B`` and per-tree row
indices and sizes as int32 tensors of shape ``B`` (or Python ints). They
make no draws, so they equal the JAX package's on the same inputs.
Callers keep splices valid (``delta <= empty rows``).
"""
from __future__ import annotations

from typing import Tuple, Union

import torch

from ..core.trees import CONST, EMPTY, TreeTensors

Index = Union[int, torch.Tensor]


def _col(x: Index) -> Index:
    """A per-tree value as a column against the rows."""
    return x[..., None] if isinstance(x, torch.Tensor) else x


def _rows(n: int, device) -> torch.Tensor:
    return torch.arange(n, dtype=torch.int32, device=device)


def _gather_rows(tree: TreeTensors, src: torch.Tensor, valid: torch.Tensor) -> TreeTensors:
    """Rows ``src`` (clipped) of each tree; rows where ``valid`` is False
    become padding."""
    n = tree.max_nodes
    batch = torch.broadcast_shapes(tree.batch_shape, src.shape[:-1], valid.shape[:-1])
    s = src.clamp(0, n - 1).long().expand(batch + (n,))
    valid = valid.expand(batch + (n,))

    def take(x):
        return torch.gather(x.expand(batch + (n,)), -1, s)

    return TreeTensors(
        torch.where(valid, take(tree.ops), EMPTY),
        torch.where(valid, take(tree.c1), -1),
        torch.where(valid, take(tree.c2), -1),
        torch.where(valid, take(tree.const), 0.0),
    )


def _shift_pointers(tree: TreeTensors, amount: Index, upto: Index = None) -> TreeTensors:
    """Add ``amount`` to every child pointer (only to pointers ``<= upto``
    where it is given)."""
    amount, upto = _col(amount), _col(upto)

    def fix(p):
        cond = p >= 0 if upto is None else (p >= 0) & (p <= upto)
        return torch.where(cond, p + amount, p)

    return tree._replace(c1=fix(tree.c1), c2=fix(tree.c2))


def _select(cond: torch.Tensor, a: TreeTensors, b: TreeTensors) -> TreeTensors:
    return TreeTensors(*(torch.where(cond, x, y) for x, y in zip(a, b)))


def extract_subtree(tree: TreeTensors, node_idx: Index, size: Index) -> TreeTensors:
    """The subtree rooted at ``node_idx`` (``size`` rows) as a block: a
    standalone tree, root at N-1, padding in front."""
    n = tree.max_nodes
    idx = _rows(n, tree.device)
    shift = node_idx - (n - 1)  # <= 0
    out = _gather_rows(tree, idx + _col(shift), idx > _col(n - 1 - size))
    return _shift_pointers(out, -shift)


def splice(tree: TreeTensors, node_idx: Index, old_size: Index, block: TreeTensors,
           block_size: Index) -> TreeTensors:
    """Replace the subtree at ``node_idx`` (``old_size`` rows) by ``block``
    (``block_size`` rows)."""
    n = tree.max_nodes
    idx = _rows(n, tree.device)
    node, end = _col(node_idx), _col(node_idx - old_size)
    delta = block_size - old_size
    in_above = idx > node
    in_block = (idx > node - _col(block_size)) & ~in_above
    # tree-sourced rows: above unchanged, below shifted by -delta
    below = idx + _col(delta)
    src_tree = torch.where(in_above, idx, below)
    valid_tree = in_above | ((below >= 0) & (below <= end))
    t = _shift_pointers(_gather_rows(tree, src_tree, valid_tree & ~in_block), -delta,
                        upto=node_idx - old_size)
    # block-sourced rows
    shift = (n - 1) - node_idx  # >= 0
    b = _shift_pointers(_gather_rows(block, idx + _col(shift), in_block), -shift)
    return _select(in_block, b, t)


def leaf_block(max_nodes: int, op: torch.Tensor, const: torch.Tensor) -> TreeTensors:
    """Single-leaf blocks (size 1) of opcodes ``op`` and constants
    ``const`` (kept on CONST rows only), both of batch shape ``B``."""
    root = _rows(max_nodes, op.device) == max_nodes - 1
    ops = torch.where(root, op[..., None].to(torch.int32), 0)
    c = torch.full(ops.shape, -1, dtype=torch.int32, device=op.device)
    value = torch.where(op == CONST, const, 0.0)
    return TreeTensors(ops, c, c.clone(), torch.where(root, value[..., None], 0.0))


def compose1(op: Index, child: TreeTensors, child_size: Index) -> Tuple[TreeTensors, Index]:
    """The block of unary ``op(child)`` and its size."""
    n = child.max_nodes
    idx = _rows(n, child.device)
    moved = _gather_rows(child, idx + 1, (idx > _col(n - 2 - child_size)) & (idx <= n - 2))
    moved = _shift_pointers(moved, -1)
    root = idx == n - 1
    return TreeTensors(
        torch.where(root, _col(op), moved.ops),
        torch.where(root, n - 2, moved.c1),
        torch.where(root, -1, moved.c2),
        torch.where(root, 0.0, moved.const),
    ), child_size + 1


def compose2(op: Index, first: TreeTensors, first_size: Index, second: TreeTensors,
             second_size: Index) -> Tuple[TreeTensors, Index]:
    """The block of binary ``op(first, second)`` and its size: ``first``
    directly below the root (child 1), ``second`` below it (child 2)."""
    n = first.max_nodes
    idx = _rows(n, first.device)
    a = _gather_rows(first, idx + 1, (idx > _col(n - 2 - first_size)) & (idx <= n - 2))
    a = _shift_pointers(a, -1)
    off = 1 + first_size
    in_b = (idx > _col(n - 1 - off - second_size)) & (idx <= _col(n - 1 - off))
    b = _shift_pointers(_gather_rows(second, idx + _col(off), in_b), -off)
    root = idx == n - 1
    merged = _select(in_b, b, a)
    return TreeTensors(
        torch.where(root, _col(op), merged.ops),
        torch.where(root, n - 2, merged.c1),
        torch.where(root, _col(n - 2 - first_size), merged.c2),
        torch.where(root, 0.0, merged.const),
    ), first_size + second_size + 1
