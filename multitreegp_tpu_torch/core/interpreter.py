"""Batched tree interpreter in plain PyTorch.

Semantics of the JAX package's ``evaluate_trees_ladder`` / ``_dispatch``
(``multitreegp_tpu/core/interpreter.py``): every lane advances one tree row
per step, bottom to top; a row's first operand is the row directly below it
(``c1 == i-1`` in the root-last layout), its second operand the value of row
``c2`` (0 when ``c2 == -1``). EMPTY rows evaluate to 0, CONST rows to their
constant, variable rows to the matching data column (0 for a variable past
the data's width).

This is the plain version behind the fitness kernel (``cuda_rollout``) and
the CPU path. The double ``where`` feeds not-selected lanes safe operands, so
autograd through it never sees NaN from a branch that was not taken.
"""
from __future__ import annotations

from typing import Callable

import torch

from .registry import FunctionSet
from .trees import CONST, OP_START, TreeTensors


def dispatch(
    fset: FunctionSet,
    op: torch.Tensor,
    x: torch.Tensor,
    y: torch.Tensor,
    leaf: torch.Tensor,
    const: torch.Tensor,
) -> torch.Tensor:
    """Branch-free opcode dispatch over full lane tensors."""
    val = torch.zeros_like(x)
    one = torch.ones_like(x)
    for k, fn in enumerate(fset.operator_fns):
        sel = op == (OP_START + k)
        val = torch.where(sel, fn(torch.where(sel, x, one), torch.where(sel, y, one)), val)
    val = torch.where(op == CONST, const, val)
    return torch.where(op >= fset.var_start, leaf, val)


def evaluate_trees(trees: TreeTensors, data: torch.Tensor, fset: FunctionSet) -> torch.Tensor:
    """Root value of every tree on every data vector.

    Args:
        trees: batch shape ``B``.
        data: flat variable vectors ``(*B', V)`` with ``B'`` broadcastable
            against ``B``.
        fset: the opcode registry.

    Returns float32 root values of the joint batch shape.
    """
    n = trees.max_nodes
    batch = torch.broadcast_shapes(trees.batch_shape, data.shape[:-1])
    nvar = data.shape[-1]
    vals = torch.zeros(batch + (n,), dtype=torch.float32, device=data.device)
    zero = torch.zeros(batch, dtype=torch.float32, device=data.device)
    for i in range(n):
        op = trees.ops[..., i].expand(batch)
        c2 = trees.c2[..., i].expand(batch)
        x = vals[..., i - 1] if i else zero
        y = torch.gather(vals, -1, c2.clamp(min=0).long()[..., None])[..., 0]
        y = torch.where(c2 >= 0, y, zero)
        leaf = zero
        for j in range(nvar):
            leaf = torch.where(op == fset.var_start + j, data[..., j].expand(batch), leaf)
        vals[..., i] = dispatch(fset, op, x, y, leaf, trees.const[..., i].expand(batch))
    return vals[..., -1].clone()


def make_candidate_evaluator(fset: FunctionSet) -> Callable[[TreeTensors, torch.Tensor], torch.Tensor]:
    """``(candidate (num_trees, N), data (V,)) -> (num_trees,)`` root values —
    the reference's ``tree_evaluator`` contract."""

    def evaluate(candidate: TreeTensors, data: torch.Tensor) -> torch.Tensor:
        return evaluate_trees(candidate, data[None, :], fset)

    return evaluate
