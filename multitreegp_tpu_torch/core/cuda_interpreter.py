"""Tree interpreter kernels: the forward and the VJP of ``evaluate_trees``.

Counterpart of ``multitreegp_tpu/core/pallas_interpreter.py``
(``evaluate_trees_pallas``: the forward kernel ``_run`` and the reverse-sweep
kernel ``_run_bwd``). Both launch ``csrc/interpreter.cu`` on CUDA tensors:

* :func:`evaluate_trees_cuda`: root value of every tree on every data
  vector, trees broadcast against data as in ``evaluate_trees``;
* :func:`evaluate_trees_vjp_cuda`: given the roots' cotangent, the cotangents
  of the trees' constants and of the data, summed back to their own shapes
  (the role of ``_unbroadcast``).

Lanes are the flattened joint batch. The kernels read each operand through
its strides over that batch (0 where broadcast), so a population
``(K, 1, m, N)`` meeting states ``(K, B, 1, d)`` is never copied ``B`` or
``m`` times. The per-lane cotangents come back lane-minor, ``(N, L)`` and
``(V, L)``, and are summed over the broadcast dimensions here.

The plain versions (``core/interpreter.py``) and the autograd ``Function``
that picks between them live beside the dispatcher in ``interpreter.py``.
"""
from __future__ import annotations

import ctypes
import math
from typing import Tuple

import torch

from .. import _build
from .registry import FunctionSet
from .trees import TreeTensors

MAX_NODES = 256  # csrc/interpreter.cu kMaxNodes
MAX_VARS = 32  # kMaxVars
MAX_OPS = 32  # kMaxOps
MAX_DIMS = 8  # kMaxDims: rank of the joint batch

_PTR, _INT, _I64 = ctypes.c_void_p, ctypes.c_int, ctypes.c_longlong
# ops, c2, cst, data, layout, devop, nops, L, n, nvar, var_start, unary
_COMMON_ARGTYPES = [_PTR] * 6 + [_INT, _I64, _INT, _INT, _INT, _INT]


def _row_major(t: torch.Tensor) -> torch.Tensor:
    """``t`` with a unit stride along its last dimension (rows, variables);
    broadcast views keep theirs, so they are not copied."""
    return t if t.shape[-1] <= 1 or t.stride(-1) == 1 else t.contiguous()


def _operands(trees: TreeTensors, data: torch.Tensor, fset: FunctionSet):
    """Checked operands, the joint batch and the kernel's layout array."""
    n = trees.max_nodes
    dev = trees.ops.device
    for name, t, dtype in (("ops", trees.ops, torch.int32), ("c2", trees.c2, torch.int32),
                           ("const", trees.const, torch.float32), ("data", data, torch.float32)):
        if t.device != dev or t.dtype != dtype:
            raise ValueError(f"{name}: expected {dtype} on {dev}, got {t.dtype} on {t.device}")
    if trees.c2.shape != trees.ops.shape or trees.const.shape[-1] != n:
        raise ValueError("ops, c2 and const must describe the same trees")
    if n > MAX_NODES:
        raise NotImplementedError(f"max_nodes {n} > {MAX_NODES}, the interpreter kernel's limit")
    nvar = data.shape[-1]
    if nvar > MAX_VARS:
        raise NotImplementedError(f"{nvar} variables > {MAX_VARS}, the interpreter kernel's limit")
    fset.require_device_ops()
    if fset.num_operators > MAX_OPS:
        raise NotImplementedError(f"{fset.num_operators} operators > {MAX_OPS}")
    batch = torch.broadcast_shapes(trees.batch_shape, trees.const.shape[:-1], data.shape[:-1])
    if len(batch) > MAX_DIMS:
        raise NotImplementedError(f"batch rank {len(batch)} > {MAX_DIMS}")
    ops, c2, cst, x = (_row_major(t) for t in (trees.ops, trees.c2, trees.const, data))

    def strides(t):
        return list(torch.broadcast_to(t, batch + t.shape[-1:]).stride()[:-1])

    pad = lambda v: v + [0] * (MAX_DIMS - len(v))
    layout = (ctypes.c_int64 * (1 + 4 * MAX_DIMS))(
        len(batch), *pad(list(batch)), *pad(strides(ops)), *pad(strides(cst)), *pad(strides(x)))
    devop = (ctypes.c_int * max(1, fset.num_operators))(*fset.device_op_ids)
    return ops, c2, cst, x, batch, layout, devop


def run_forward(fn, trees: TreeTensors, data: torch.Tensor, fset: FunctionSet,
                stream=None) -> torch.Tensor:
    """Call ``interpret_fwd`` (of the CUDA library, or of the host build on
    CPU tensors); returns ``(status, roots shaped like the joint batch)``."""
    ops, c2, cst, x, batch, layout, devop = _operands(trees, data, fset)
    out = torch.empty(batch, dtype=torch.float32, device=ops.device)
    lanes = math.prod(batch)
    if lanes == 0:
        return 0, out
    fn.argtypes = _COMMON_ARGTYPES + [_PTR, _PTR]
    fn.restype = _INT
    status = fn(ops.data_ptr(), c2.data_ptr(), cst.data_ptr(), x.data_ptr(), layout, devop,
                fset.num_operators, lanes, trees.max_nodes, x.shape[-1], fset.var_start,
                fset.has_unary, out.data_ptr(), stream)
    return status, out


def run_backward(fn, trees: TreeTensors, data: torch.Tensor, g: torch.Tensor, fset: FunctionSet,
                 stream=None):
    """Call ``interpret_bwd``; returns ``(status, dconst (*batch, N), ddata
    (*batch, V))`` per lane (views of the lane-minor outputs)."""
    ops, c2, cst, x, batch, layout, devop = _operands(trees, data, fset)
    n, nvar, lanes = trees.max_nodes, x.shape[-1], math.prod(batch)
    if g.shape != batch or g.dtype != torch.float32 or g.device != ops.device:
        raise ValueError(f"cotangent {tuple(g.shape)} {g.dtype}: expected {tuple(batch)} float32")
    g = g.contiguous()
    dconst = torch.empty((n, lanes), dtype=torch.float32, device=ops.device)
    ddata = torch.empty((nvar, lanes), dtype=torch.float32, device=ops.device)
    status = 0
    if lanes:
        fn.argtypes = _COMMON_ARGTYPES + [_PTR] * 4
        fn.restype = _INT
        status = fn(ops.data_ptr(), c2.data_ptr(), cst.data_ptr(), x.data_ptr(), layout, devop,
                    fset.num_operators, lanes, n, nvar, fset.var_start, fset.has_unary,
                    g.data_ptr(), dconst.data_ptr(), ddata.data_ptr(), stream)
    per_lane = lambda t: t.view((t.shape[0],) + tuple(batch)).movedim(0, -1)
    return status, per_lane(dconst), per_lane(ddata)


def _require_cuda(trees: TreeTensors) -> torch.device:
    dev = trees.ops.device
    if dev.type != "cuda":
        raise ValueError(f"the interpreter kernels take CUDA tensors, got {dev}")
    return dev


def evaluate_trees_cuda(trees: TreeTensors, data: torch.Tensor, fset: FunctionSet) -> torch.Tensor:
    """Launch the forward kernel: float32 roots of the joint batch shape."""
    dev = _require_cuda(trees)
    lib = _build.load("interpreter")
    status, out = run_forward(lib.interpret_fwd, trees, data, fset,
                              torch.cuda.current_stream(dev).cuda_stream)
    _build.check(lib, status, "interpreter forward kernel launch")
    evaluate_trees_cuda.launches += 1
    return out


evaluate_trees_cuda.launches = 0


def evaluate_trees_vjp_cuda(
    trees: TreeTensors, data: torch.Tensor, g: torch.Tensor, fset: FunctionSet,
) -> Tuple[torch.Tensor, torch.Tensor]:
    """Launch the reverse-sweep kernel: ``(dconst like trees.const, ddata
    like data)`` for the roots' cotangent ``g``."""
    dev = _require_cuda(trees)
    lib = _build.load("interpreter")
    status, dconst, ddata = run_backward(lib.interpret_bwd, trees, data, g, fset,
                                         torch.cuda.current_stream(dev).cuda_stream)
    _build.check(lib, status, "interpreter backward kernel launch")
    evaluate_trees_vjp_cuda.launches += 1
    return dconst.sum_to_size(trees.const.shape), ddata.sum_to_size(data.shape)


evaluate_trees_vjp_cuda.launches = 0
