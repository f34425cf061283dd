"""Population initialization (grow sampling), in plain PyTorch on the device.

Law of ``multitreegp_tpu/ops/initialization.py`` (reference
``initialization.py:9-164``): nodes are drawn in breadth-first order over a
full binary buffer of ``2**max_init_depth - 1`` slots; an operator is drawn
with probability ``0.7**depth`` while the node may still grow; leaves are
50/50 constant (normal, ``coefficient_sd``) vs variable (the tree's variable
mask); a node is EMPTY when its parent has no open slot for it or the
open-slot budget is spent; the kept rows are then packed root-last.

All lanes (population x trees) advance together, one BFS slot per step;
randomness comes from the caller's ``torch.Generator``.
"""
from __future__ import annotations

import torch

from ..core.registry import FunctionSet
from ..core.trees import CONST, EMPTY, OP_START, TreeTensors, bfs_tables, rebuild_pointers


def make_population_sampler(fset: FunctionSet, max_init_depth: int, max_nodes: int,
                            coefficient_sd: float = 1.0):
    """Return ``sample_population(generator, population_size, num_populations=1)
    -> TreeTensors`` of batch ``(num_populations, population_size, num_trees)``."""
    s, dfs_pos, dep, parent, is_left = bfs_tables(max_init_depth)
    if s > max_nodes:
        raise ValueError(f"max_init_depth {max_init_depth} needs {s} rows > max_nodes {max_nodes}")

    def sample_population(generator: torch.Generator, population_size: int,
                          num_populations: int = 1) -> TreeTensors:
        dev = generator.device
        m = fset.num_trees
        shape = (num_populations, population_size, m)
        lanes = num_populations * population_size * m
        slots = fset.slots(dev)
        probs = fset.probs(dev).expand(lanes, -1)
        vweights = fset.variable_mask.to(dev).expand(num_populations, population_size, m, -1)
        vweights = vweights.reshape(lanes, -1)

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
            grow = (open_slots < max_nodes - i - 1) & (dep[i] + 1 < max_init_depth)
            index = torch.where(grow & (rand() < 0.7 ** dep[i]), operator, leaf)
            index = torch.where(open_slots == 0, EMPTY, index)
            if i > 0:
                parent_ar = slots[buf_ops[..., dfs_pos[parent[i]]].long()]
                index = torch.where(parent_ar + int(is_left[i]) > 1, index, EMPTY)
            buf_ops[..., dfs_pos[i]] = index
            buf_const[..., dfs_pos[i]] = torch.where(index == CONST, coeff, 0.0)
            grown = (open_slots + slots[index.long()] - 1).clamp(min=0)
            open_slots = torch.where(index == EMPTY, open_slots, grown)

        # pack kept rows root-last: DFS row i lands at N - (kept rows at >= i)
        kept = buf_ops != EMPTY
        suffix = torch.flip(torch.cumsum(torch.flip(kept.to(torch.int32), [-1]), -1), [-1])
        dest = torch.where(kept, max_nodes - suffix, max_nodes).long()
        ops = torch.zeros(shape + (max_nodes + 1,), dtype=torch.int32, device=dev)
        const = torch.zeros(shape + (max_nodes + 1,), dtype=torch.float32, device=dev)
        ops.scatter_(-1, dest, buf_ops)
        const.scatter_(-1, dest, buf_const)
        ops, const = ops[..., :max_nodes].contiguous(), const[..., :max_nodes].contiguous()
        c1, c2 = rebuild_pointers(ops, slots)
        return TreeTensors(ops, c1, c2, const)

    return sample_population
