"""Tree tensor representation (PyTorch).

Same struct-of-arrays encoding as the JAX package (``multitreegp_tpu/core/
trees.py``): a tree is ``max_nodes`` rows of

* ``ops``   int32  ``(..., N)`` — opcode per row (see :mod:`registry`)
* ``c1``    int32  ``(..., N)`` — row of the first child, ``-1`` if none
* ``c2``    int32  ``(..., N)`` — row of the second child, ``-1`` if none
* ``const`` float32 ``(..., N)`` — constant of ``CONST`` rows, else 0

with the same invariants: root-last (the root is row ``N-1`` and children sit
below their parents), padding-first (``EMPTY`` rows packed at the front) and
contiguous subtrees (the subtree at row ``i`` fills rows ``(end, i]``).
"""
from __future__ import annotations

from typing import NamedTuple, Tuple

import numpy as np
import torch

# 0 = EMPTY, 1 = CONST, 2 .. 2+K-1 = operators, 2+K .. = variables
EMPTY = 0
CONST = 1
OP_START = 2


class TreeTensors(NamedTuple):
    """Stacked trees; all fields share leading dims + ``(N,)``."""

    ops: torch.Tensor  # int32
    c1: torch.Tensor  # int32
    c2: torch.Tensor  # int32
    const: torch.Tensor  # float32

    @property
    def max_nodes(self) -> int:
        return self.ops.shape[-1]

    @property
    def batch_shape(self) -> torch.Size:
        return self.ops.shape[:-1]

    @property
    def device(self) -> torch.device:
        return self.ops.device

    def __getitem__(self, idx) -> "TreeTensors":
        return TreeTensors(self.ops[idx], self.c1[idx], self.c2[idx], self.const[idx])

    def map(self, fn) -> "TreeTensors":
        """Apply ``fn`` to every field (reshape, index, concatenate, ...)."""
        return TreeTensors(fn(self.ops), fn(self.c1), fn(self.c2), fn(self.const))


def empty_trees(batch_shape, max_nodes: int, device=None) -> TreeTensors:
    """All-padding trees: every row is ``(EMPTY, -1, -1, 0.0)``."""
    shape = tuple(batch_shape) + (max_nodes,)
    return TreeTensors(
        torch.zeros(shape, dtype=torch.int32, device=device),
        torch.full(shape, -1, dtype=torch.int32, device=device),
        torch.full(shape, -1, dtype=torch.int32, device=device),
        torch.zeros(shape, dtype=torch.float32, device=device),
    )


def tree_sizes(trees: TreeTensors) -> torch.Tensor:
    """Number of non-empty rows per tree: int32 ``(...,)``."""
    return (trees.ops != EMPTY).sum(dim=-1, dtype=torch.int32)


def pack(trees: TreeTensors) -> torch.Tensor:
    """The reference's ``(..., N, 4)`` float32 layout (``ops``, ``c1``,
    ``c2``, ``const`` along the last axis), for interchange."""
    return torch.stack([trees.ops.float(), trees.c1.float(), trees.c2.float(), trees.const.float()],
                       dim=-1)


def unpack(arr: torch.Tensor) -> TreeTensors:
    """Inverse of :func:`pack`; also takes the reference's float64 tensors.
    The opcodes and pointers are cast to int32 (truncating, as ``astype``),
    the constants to float32."""
    return TreeTensors(arr[..., 0].to(torch.int32), arr[..., 1].to(torch.int32),
                       arr[..., 2].to(torch.int32), arr[..., 3].to(torch.float32))


def arity_of(ops: torch.Tensor, slots: torch.Tensor) -> torch.Tensor:
    """Per-row arity (0 for EMPTY/CONST/variables) from the registry table."""
    return slots[ops.clamp(0, slots.shape[0] - 1).long()]


def subtree_spans(ops: torch.Tensor, slots: torch.Tensor) -> torch.Tensor:
    """Subtree size of every row (0 for empty rows).

    With ``w[j] = 1 - arity[j]`` the subtree rooted at row ``i`` starts at
    the largest ``k <= i`` with ``sum(w[k..i]) == 1``
    (``multitreegp_tpu.core.trees.subtree_spans`` derives it).
    """
    n = ops.shape[-1]
    w = 1 - arity_of(ops, slots).to(torch.int32)
    csum = torch.cumsum(w, dim=-1, dtype=torch.int32)
    csum_im1 = torch.cat([torch.zeros_like(csum[..., :1]), csum[..., :-1]], dim=-1)
    idx = torch.arange(n, dtype=torch.int32, device=ops.device)
    s = csum[..., None, :] - csum_im1[..., :, None]  # [..., k, i]
    valid = (s == 1) & (idx[:, None] <= idx[None, :])
    k = torch.where(valid, idx[:, None], torch.full_like(s, -1)).amax(dim=-2)
    size = idx - k + 1
    return torch.where(ops != EMPTY, size, torch.zeros_like(size)).to(torch.int32)


def subtree_span_at(ops: torch.Tensor, slots: torch.Tensor, node_idx: torch.Tensor) -> torch.Tensor:
    """Subtree size of the one row ``node_idx`` of each tree: int32 of the
    batch shape of ``ops (..., N)`` broadcast against ``node_idx``.

    O(N) per row asked for, against the ``(..., N, N)`` of
    :func:`subtree_spans`; ``ops[..., None, :]`` against ``node_idx (..., R)``
    gives R rows of each tree.
    """
    n = ops.shape[-1]
    w = 1 - arity_of(ops, slots).to(torch.int32)
    csum = torch.cumsum(w, dim=-1, dtype=torch.int32)
    batch = torch.broadcast_shapes(ops.shape[:-1], node_idx.shape)
    node = node_idx.expand(batch).long()
    c_at = torch.gather(csum.expand(batch + (n,)), -1, node[..., None])
    s = c_at - (csum - w)  # csum[k] - w[k] is the sum up to row k - 1
    idx = torch.arange(n, dtype=torch.int64, device=ops.device)
    valid = (s == 1) & (idx <= node[..., None])
    k = torch.where(valid, idx, -1).amax(dim=-1)
    return (node - k + 1).to(torch.int32)


def rebuild_pointers(ops: torch.Tensor, slots: torch.Tensor) -> Tuple[torch.Tensor, torch.Tensor]:
    """Derive ``(c1, c2)`` from opcodes: ``c1[i] = i-1`` for operators and
    ``c2[i] = i-1-span(i-1)`` for binary operators (root-last layout)."""
    n = ops.shape[-1]
    ar = arity_of(ops, slots)
    spans = subtree_spans(ops, slots)
    idx = torch.arange(n, dtype=torch.int32, device=ops.device)
    span_below = torch.cat([torch.zeros_like(spans[..., :1]), spans[..., :-1]], dim=-1)
    minus1 = torch.full_like(spans, -1)
    c1 = torch.where(ar >= 1, (idx - 1).expand_as(spans), minus1)
    c2 = torch.where(ar == 2, idx - 1 - span_below, minus1)
    return c1.to(torch.int32), c2.to(torch.int32)


def bfs_tables(depth: int):
    """Layout of a full binary BFS buffer of the given depth, as lists:
    ``(size, dfs_pos, node_depth, parent, is_left)``. ``dfs_pos[i]`` is the
    row of BFS node ``i`` in the root-last depth-first layout (a node's first
    child directly below it, the second below the first child's subtree)."""
    s = 2**depth - 1
    pos = [0] * s
    dep = [0] * s
    pos[0] = s - 1
    for i in range(s):
        lft, r = 2 * i + 1, 2 * i + 2
        if lft < s:
            dep[lft] = dep[r] = dep[i] + 1
            child_span = 2 ** (depth - dep[i] - 1) - 1
            pos[lft] = pos[i] - 1
            pos[r] = pos[i] - 1 - child_span
    parent = [(i + (i % 2) - 2) // 2 if i > 0 else 0 for i in range(s)]
    is_left = [i % 2 == 1 for i in range(s)]
    return s, pos, dep, parent, is_left


def validate_host(trees: TreeTensors, slots) -> None:
    """Host-side invariant checker (tests and the GPU smoke run).

    Raises ``ValueError`` on: an empty tree, padding not packed at the front,
    child pointers inconsistent with arity, a row referenced twice or never,
    or a non-contiguous subtree.
    """
    n = trees.max_nodes
    ops = trees.ops.detach().cpu().numpy().reshape(-1, n)
    c1 = trees.c1.detach().cpu().numpy().reshape(-1, n)
    c2 = trees.c2.detach().cpu().numpy().reshape(-1, n)
    slots = np.asarray(slots.cpu() if isinstance(slots, torch.Tensor) else slots)

    def fail(t, msg):
        raise ValueError(f"tree {t}: {msg}")

    for t in range(ops.shape[0]):
        o, a, b = ops[t], c1[t], c2[t]
        size = int((o != EMPTY).sum())
        if size < 1:
            fail(t, "empty tree")
        if not (o[: n - size] == EMPTY).all():
            fail(t, "padding not packed at front")
        for i in range(n - size, n):
            ar = int(slots[o[i]]) if o[i] < len(slots) else 0
            if ar >= 1 and not 0 <= a[i] < i:
                fail(t, f"row {i}: bad c1 {a[i]}")
            if ar == 0 and a[i] != -1:
                fail(t, f"row {i}: leaf with c1 {a[i]}")
            if ar == 2 and not (0 <= b[i] < a[i]):
                fail(t, f"row {i}: bad c2 {b[i]}")
            if ar != 2 and b[i] != -1:
                fail(t, f"row {i}: row with c2 {b[i]}")
        refs = sorted(int(x) for x in list(a) + list(b) if x >= 0)
        if refs != list(range(n - size, n - 1)):
            fail(t, f"child refs {refs} != rows {list(range(n - size, n - 1))}")
        # contiguity: the subtree at row i holds exactly the rows (lo, i]
        lo = {}
        for i in range(n - size, n):
            lo[i] = min([i] + [lo[int(c)] for c in (a[i], b[i]) if c >= 0])
            seen, todo = 0, [i]
            while todo:
                j = todo.pop()
                seen += 1
                todo += [int(c) for c in (a[j], b[j]) if c >= 0]
            if seen != i - lo[i] + 1:
                fail(t, f"row {i}: non-contiguous subtree")
