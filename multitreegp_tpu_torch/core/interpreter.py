"""Batched tree interpreter: the plain version, its VJP, and the dispatcher.

Semantics of the JAX package's ``evaluate_trees_ladder`` / ``_dispatch``
(``multitreegp_tpu/core/interpreter.py``): every lane advances one tree row
per step, bottom to top; a row's first operand is the row directly below it
(``c1 == i-1`` in the root-last layout), its second operand the value of row
``c2`` (0 unless ``0 <= c2 < i``). EMPTY rows evaluate to 0, CONST rows to
their constant, variable rows to the matching data column (0 for a variable
past the data's width).

* :func:`evaluate_trees_plain` is the plain PyTorch version. The double
  ``where`` feeds not-selected lanes safe operands, so autograd through it
  never sees NaN from a branch that was not taken; the rows are kept in a
  list (not written into one buffer in place), so autograd can run through
  it. Every plain version of a kernel (``sr_fitness_plain``, ...) calls it.
* :func:`evaluate_trees` is what the rest of the port calls: on CUDA tensors
  :class:`EvaluateTrees` (the forward kernel ``csrc/interpreter.cu``, with the
  reverse-sweep kernel as its backward), or a raise for an operator the
  kernel lacks; on CPU tensors the plain version.
"""
from __future__ import annotations

from typing import Callable, Tuple

import torch

from .cuda_interpreter import evaluate_trees_cuda, evaluate_trees_vjp_cuda
from .registry import FunctionSet
from .trees import CONST, EMPTY, OP_START, TreeTensors


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


class _TakeLast(torch.autograd.Function):
    """``torch.gather(below, -1, idx)`` with one index per lane. Its backward
    writes each cotangent at its index (``scatter_``) where ``gather``'s adds
    it to zeros (``scatter_add_``): on CUDA that add is atomic, and the card's
    atomic float add flushes a subnormal to zero, so the second operands'
    subnormal cotangents (an ``exp`` or ``pow`` that underflows) would be
    lost. The same values otherwise, at the same place in autograd's graph."""

    @staticmethod
    def forward(ctx, below, idx):
        ctx.save_for_backward(idx)
        ctx.shape = below.shape
        return torch.gather(below, -1, idx)

    @staticmethod
    def backward(ctx, g):
        (idx,) = ctx.saved_tensors
        return torch.zeros(ctx.shape, dtype=g.dtype, device=g.device).scatter_(-1, idx, g), None


def evaluate_trees_plain(trees: TreeTensors, data: torch.Tensor, fset: FunctionSet) -> torch.Tensor:
    """Root value of every tree on every data vector (plain PyTorch).

    Args:
        trees: batch shape ``B``.
        data: flat variable vectors ``(*B', V)`` with ``B'`` broadcastable
            against ``B``.
        fset: the opcode registry.

    Returns float32 root values of the joint batch shape.
    """
    n = trees.max_nodes
    batch = torch.broadcast_shapes(trees.batch_shape, trees.const.shape[:-1], data.shape[:-1])
    nvar = data.shape[-1]
    zero = torch.zeros(batch, dtype=torch.float32, device=data.device)
    # Rows below the lowest non-EMPTY row of any tree are EMPTY on every
    # lane: they evaluate to 0 and feed nothing, so the sweep starts there.
    used = (trees.ops != EMPTY).reshape(-1, n).any(dim=0)
    start = int(torch.where(used.any(), used.int().argmax(), n - 1)) if used.numel() else n - 1
    rows = []  # rows[i - start] is row i
    for i in range(start, n):
        op = trees.ops[..., i].expand(batch)
        c2 = trees.c2[..., i].expand(batch)
        x = rows[-1] if rows else zero
        y = zero
        if rows:
            below = torch.stack(rows, -1)
            y = _TakeLast.apply(below, (c2 - start).clamp(0, i - 1 - start).long()[..., None])[..., 0]
            y = torch.where((c2 >= start) & (c2 < i), y, zero)
        leaf = zero
        for j in range(nvar):
            leaf = torch.where(op == fset.var_start + j, data[..., j].expand(batch), leaf)
        rows.append(dispatch(fset, op, x, y, leaf, trees.const[..., i].expand(batch)))
    return rows[-1]


def evaluate_trees_vjp_plain(
    trees: TreeTensors, data: torch.Tensor, g: torch.Tensor, fset: FunctionSet,
) -> Tuple[torch.Tensor, torch.Tensor]:
    """Plain version of the reverse-sweep kernel: ``(dconst like
    trees.const, ddata like data)`` by autograd through
    :func:`evaluate_trees_plain`."""
    with torch.enable_grad():
        const = trees.const.detach().requires_grad_(True)
        x = data.detach().requires_grad_(True)
        out = evaluate_trees_plain(trees._replace(const=const), x, fset)
        grads = torch.autograd.grad(out, (const, x), g, allow_unused=True)
    return tuple(torch.zeros_like(t) if d is None else d for t, d in zip((const, x), grads))


class EvaluateTrees(torch.autograd.Function):
    """``evaluate_trees`` with the reverse-sweep kernel as its backward:
    kernels on CUDA tensors, the plain versions on CPU tensors. No gradient
    goes to ``ops``, ``c1`` or ``c2``."""

    @staticmethod
    def forward(ctx, ops, c1, c2, const, data, fset: FunctionSet):
        trees = TreeTensors(ops, c1, c2, const)
        ctx.fset = fset
        ctx.save_for_backward(ops, c1, c2, const, data)
        if ops.device.type == "cuda":
            return evaluate_trees_cuda(trees, data, fset)
        return evaluate_trees_plain(trees, data, fset)

    @staticmethod
    def backward(ctx, g):
        ops, c1, c2, const, data = ctx.saved_tensors
        trees = TreeTensors(ops, c1, c2, const)
        vjp = evaluate_trees_vjp_cuda if ops.device.type == "cuda" else evaluate_trees_vjp_plain
        dconst, ddata = vjp(trees, data, g, ctx.fset)
        return None, None, None, dconst, ddata, None


# the JAX package's ``impl`` values (its Pallas kernel, its select ladder, its
# gather loop); here each names the one interpreter the device has
IMPLS = ("auto", "pallas", "ladder", "gather")


def check_impl(impl: str) -> None:
    if impl not in IMPLS:
        raise ValueError(f"impl must be one of {IMPLS}, got {impl!r}")


def evaluate_trees(trees: TreeTensors, data: torch.Tensor, fset: FunctionSet,
                   impl: str = "auto") -> torch.Tensor:
    """Root value of every tree on every data vector: the kernels on CUDA
    tensors (differentiable in ``const`` and ``data``), the plain version on
    CPU tensors, whatever ``impl`` (JAX's keyword, one of :data:`IMPLS`).
    Shapes as :func:`evaluate_trees_plain`."""
    check_impl(impl)
    dev = trees.ops.device
    if dev.type == "cuda":
        fset.require_device_ops()
        return EvaluateTrees.apply(trees.ops, trees.c1, trees.c2, trees.const, data, fset)
    if dev.type == "cpu":
        return evaluate_trees_plain(trees, data, fset)
    raise NotImplementedError(f"no interpreter for device {dev}")


def make_candidate_evaluator(fset: FunctionSet) -> Callable[[TreeTensors, torch.Tensor], torch.Tensor]:
    """``(candidate (num_trees, N), data (V,)) -> (num_trees,)`` root values —
    the reference's ``tree_evaluator`` contract."""

    def evaluate(candidate: TreeTensors, data: torch.Tensor) -> torch.Tensor:
        return evaluate_trees(candidate, data[None, :], fset)

    return evaluate
