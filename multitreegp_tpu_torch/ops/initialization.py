"""Population initialization (grow sampling), in plain PyTorch on the device.

Law of ``multitreegp_tpu/ops/initialization.py`` (reference
``initialization.py:9-164``): nodes are drawn in breadth-first order over a
full binary buffer of ``2**max_init_depth - 1`` slots; an operator is drawn
with probability ``0.7**depth`` while the node may still grow (its depth + 1
is below the depth limit and the open-slot budget leaves room); leaves are
50/50 constant (normal, ``coefficient_sd``) vs variable (the tree's variable
mask); a node is EMPTY when its parent has no open slot for it or the
open-slot budget is spent; the kept rows are then packed root-last.

All lanes (trees) advance together, one BFS slot per step; randomness comes
from the caller's ``torch.Generator``. The child pointers come from the
buffer's own layout (each BFS node's children), remapped by the packing, in
O(N) per tree.
"""
from __future__ import annotations

from typing import Union

import torch

from ..core.registry import FunctionSet
from ..core.trees import CONST, EMPTY, OP_START, TreeTensors, bfs_tables


def _grow_probability(depth) -> float:
    """Probability that a node at ``depth`` (the root's is 0) that may still
    grow is drawn an operator."""
    return 0.7 ** depth


def _grow(fset: FunctionSet, generator: torch.Generator, shape, depth: int,
          depth_limit: Union[int, torch.Tensor], vweights: torch.Tensor, max_nodes: int,
          coefficient_sd: float):
    """Draw the BFS buffer of depth ``depth`` for trees of batch ``shape``:
    ``(ops, const)`` of shape ``shape + (2**depth - 1,)`` in depth-first
    (root-last) order. ``vweights`` is ``(prod(shape), V)``."""
    s, dfs_pos, dep, parent, is_left = bfs_tables(depth)
    dev = generator.device
    lanes = vweights.shape[0]
    slots = fset.slots(dev)
    probs = fset.probs(dev).expand(lanes, -1)

    def rand():
        return torch.rand(shape, generator=generator, device=dev)

    buf_ops = torch.zeros(shape + (s,), dtype=torch.int32, device=dev)
    buf_const = torch.zeros(shape + (s,), dtype=torch.float32, device=dev)
    open_slots = torch.ones(shape, dtype=torch.int32, device=dev)
    for i in range(s):
        coeff = torch.randn(shape, generator=generator, device=dev) * coefficient_sd
        var = torch.multinomial(vweights, 1, generator=generator).reshape(shape)
        leaf = torch.where(rand() < 0.5, CONST, var.to(torch.int32) + fset.var_start)
        operator = torch.multinomial(probs, 1, generator=generator).reshape(shape)
        operator = operator.to(torch.int32) + OP_START
        grow = (open_slots < max_nodes - i - 1) & (dep[i] + 1 < depth_limit)
        index = torch.where(grow & (rand() < _grow_probability(dep[i])), operator, leaf)
        index = torch.where(open_slots == 0, EMPTY, index)
        if i > 0:
            parent_ar = slots[buf_ops[..., dfs_pos[parent[i]]].long()]
            index = torch.where(parent_ar + int(is_left[i]) > 1, index, EMPTY)
        buf_ops[..., dfs_pos[i]] = index
        buf_const[..., dfs_pos[i]] = torch.where(index == CONST, coeff, 0.0)
        grown = (open_slots + slots[index.long()] - 1).clamp(min=0)
        open_slots = torch.where(index == EMPTY, open_slots, grown)
    return buf_ops, buf_const


def _pack(fset: FunctionSet, depth: int, buf_ops: torch.Tensor, buf_const: torch.Tensor,
          max_nodes: int) -> TreeTensors:
    """Pack the kept rows of a depth-first buffer root-last: row i lands at
    N - (kept rows at >= i), and so do the pointers to it."""
    s, dfs_pos, _, _, _ = bfs_tables(depth)
    dev = buf_ops.device
    shape = buf_ops.shape[:-1]
    kept = buf_ops != EMPTY
    suffix = torch.flip(torch.cumsum(torch.flip(kept.to(torch.int32), [-1]), -1), [-1])
    dest = torch.where(kept, max_nodes - suffix, max_nodes).long()
    # each buffer row's children rows in the buffer (BFS node i's children
    # are BFS nodes 2i + 1 and 2i + 2), -1 at the last level
    left, right = [-1] * s, [-1] * s
    for i in range(s):
        if 2 * i + 2 < s:
            left[dfs_pos[i]], right[dfs_pos[i]] = dfs_pos[2 * i + 1], dfs_pos[2 * i + 2]
    arity = fset.slots(dev)[buf_ops.long()]

    def pointers(table, need):
        child = torch.tensor(table, dtype=torch.int64, device=dev).expand(shape + (s,))
        at = torch.gather(suffix, -1, child.clamp(min=0))
        return torch.where((arity >= need) & (child >= 0), max_nodes - at, -1)

    def packed(values, fill, dtype):
        out = torch.full(shape + (max_nodes + 1,), fill, dtype=dtype, device=dev)
        out.scatter_(-1, dest, values.to(dtype))
        return out[..., :max_nodes].contiguous()

    return TreeTensors(packed(buf_ops, EMPTY, torch.int32),
                       packed(pointers(left, 1), -1, torch.int32),
                       packed(pointers(right, 2), -1, torch.int32),
                       packed(buf_const, 0.0, torch.float32))


def _check_depth(max_init_depth: int, max_nodes: int) -> None:
    if 2**max_init_depth - 1 > max_nodes:
        raise ValueError(f"max_init_depth {max_init_depth} needs {2**max_init_depth - 1} rows "
                         f"> max_nodes {max_nodes}")


def make_tree_sampler(fset: FunctionSet, max_init_depth: int, max_nodes: int,
                      coefficient_sd: float = 1.0):
    """Return ``sample_tree(generator, depth_limit, variable_mask) ->
    TreeTensors``: one grown tree per row of ``variable_mask (*B, V)``, of
    batch shape ``B``. ``depth_limit`` is an int (the mutations' 1 and 2,
    and ``max_init_depth``) or an int tensor of shape ``B``; nodes at depth
    >= ``depth_limit - 1`` are leaves."""
    _check_depth(max_init_depth, max_nodes)

    def sample_tree(generator: torch.Generator, depth_limit: Union[int, torch.Tensor],
                    variable_mask: torch.Tensor) -> TreeTensors:
        shape = tuple(variable_mask.shape[:-1])
        vweights = variable_mask.to(generator.device).reshape(-1, variable_mask.shape[-1])
        # a Python limit d < max_init_depth leaves every slot below depth d
        # EMPTY, so the buffer stops there; the law is the same
        depth = max_init_depth
        if isinstance(depth_limit, int):
            depth = max(1, min(depth_limit, max_init_depth))
        buf_ops, buf_const = _grow(fset, generator, shape, depth, depth_limit, vweights,
                                   max_nodes, coefficient_sd)
        return _pack(fset, depth, buf_ops, buf_const, max_nodes)

    return sample_tree


def make_population_sampler(fset: FunctionSet, max_init_depth: int, max_nodes: int,
                            coefficient_sd: float = 1.0):
    """Return ``sample_population(generator, population_size, num_populations=1)
    -> TreeTensors`` of batch ``(num_populations, population_size, num_trees)``."""
    _check_depth(max_init_depth, max_nodes)

    def sample_population(generator: torch.Generator, population_size: int,
                          num_populations: int = 1) -> TreeTensors:
        m = fset.num_trees
        shape = (num_populations, population_size, m)
        vweights = fset.variable_mask.to(generator.device).expand(shape + (-1,))
        buf_ops, buf_const = _grow(fset, generator, shape, max_init_depth, max_init_depth,
                                   vweights.reshape(-1, vweights.shape[-1]), max_nodes,
                                   coefficient_sd)
        return _pack(fset, max_init_depth, buf_ops, buf_const, max_nodes)

    return sample_population
