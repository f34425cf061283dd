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
``m`` times. The layout words order the batch's dimensions so that those
along which the trees are broadcast come last: consecutive lanes then share
a tree, which a block stages once. The per-lane cotangents come back
lane-minor, ``(N, L)`` and ``(V, L)``, in the joint batch's own order, and
are summed over the broadcast dimensions here.

Launch path: everything that depends only on the operands' signature (their
shapes, strides, dtypes and devices, and the function set's operators) is
worked out once and kept in a small cache keyed by that signature: the
checks, the joint batch, the dimension order and the layout words. A hit
vouches for those checks; the cotangent and the device type are checked on
every call. The entry points' ``ctypes`` types are set once per library.

Instances. Trees of up to 1,024 rows, on up to 63 variables, with up to 32
operators (device op ids up to ``registry.FIXED_MAX_OP``), run the fixed
instances (their row arrays in local memory). Any other size runs the wide
instance (the layout's ``wide`` word): its values
and tape lie in a scratch buffer allocated here, ``[row][lane]`` over the
lanes of one launch, and the lanes are split into launches so that the
scratch stays within :data:`SCRATCH_BYTES`; each launch counts in the
wrappers' ``launches``. Its limit is what that budget holds: one block of
:data:`THREADS` lanes' tape, :data:`MAX_NODES` rows; past it, and past
:data:`MAX_VARS` variables, ``NotImplementedError``.

A function set with an operator past ``+ - * / sin cos`` launches the
library's extended build, one with user operators the user build of its
generated header (``_build.load("interpreter", fset.variant)``); the layout
words carry the device op table, whose ids each build's ``make_params``
checks against the operators it computes, and whether the set has unary
operators (the instance without the unary rows' code otherwise). The
layout cache keys on the header's hash too: two sets may share device op
ids and differ in their user code.

The plain versions (``core/interpreter.py``) and the autograd ``Function``
that picks between them live beside the dispatcher in ``interpreter.py``.
"""
from __future__ import annotations

import ctypes
import math
from typing import Dict, NamedTuple, Sequence, Tuple

import torch

from .. import _build
from .registry import FIXED_MAX_OP, USER_FROM, FunctionSet
from .trees import TreeTensors

# the fixed instances' limits (csrc/interpreter.cu kMaxRows, kRowVars, kMaxOps)
FIXED_ROWS = 1024
FIXED_VARS = 63
FIXED_OPS = 32
DEVICE_OPS = 64  # kDeviceOps: the op table's entries, at least (a user build: kUserFrom + kCount)
THREADS = 32  # kThreads: a block's lanes; a wide launch runs whole blocks
# the wide instance's scratch per launch: the forward's values (4 B) or the
# VJP's tape (8 B) of each row of each lane of the launch
SCRATCH_BYTES = 1 << 30
MAX_NODES = SCRATCH_BYTES // (THREADS * 8)  # one block's tape in the budget
MAX_VARS = (1 << 28) - 1  # kWideMaxVars: the decoded row's data slot
MAX_DIMS = 8  # kMaxDims: rank of the joint batch
MAX_LANES = 2**31 - 1  # lanes and shapes are indexed in 32 bits
HEADER_WORDS = 8 + 5 * MAX_DIMS  # the layout's header and 5 words per dimension, then the op table
MAX_LAYOUTS = 64  # operand signatures kept; the oldest goes first

_PTR, _INT, _I64 = ctypes.c_void_p, ctypes.c_int, ctypes.c_int64
# ops, c2, cst, data, layout; then out (forward) or g, dconst, ddata
# (backward); then the scratch, the launch's first lane and lane count, and
# the stream
_ARGTYPES = {"interpret_fwd": [_PTR] * 7 + [_I64, _I64, _PTR],
             "interpret_bwd": [_PTR] * 9 + [_I64, _I64, _PTR]}


class Layout(NamedTuple):
    """What one operand signature needs: which operands to copy (their last
    dimension strided), the joint batch, the kernel's layout words, and the
    lanes a launch runs (all of them, but for the wide instance)."""

    copy: Tuple[bool, bool, bool, bool]  # ops, c2, const, data
    batch: torch.Size
    lanes: int
    words: ctypes.Array  # kept alive for `address`
    address: int
    wide: bool
    fwd_step: int  # lanes a forward launch runs
    bwd_step: int  # ... a VJP launch


def takes_fixed(n: int, nvar: int, nops: int, max_op: int) -> bool:
    """Whether the fixed instances take trees of ``n`` rows on ``nvar``
    variables with ``nops`` operators whose device op ids reach ``max_op``
    (else the wide instance runs)."""
    return n <= FIXED_ROWS and nvar <= FIXED_VARS and nops <= FIXED_OPS and max_op <= FIXED_MAX_OP


def op_table_words(fset: FunctionSet) -> int:
    """Entries of the layout's device op table: ``DEVICE_OPS``, or for a
    user build with more operators than that ``USER_FROM`` plus its user
    operators (``kDeviceOps``, csrc/interpreter.cu), so that any set's
    operators fit."""
    return max(DEVICE_OPS, USER_FROM + fset.user_count)


def _step(lanes: int, n: int, row_bytes: int) -> int:
    """Lanes a wide launch runs: whole blocks whose scratch of ``row_bytes``
    per row and lane fits :data:`SCRATCH_BYTES`, at most all of them."""
    per = max(THREADS, SCRATCH_BYTES // (n * row_bytes) // THREADS * THREADS)
    return min(per, lanes)


_layouts: Dict[tuple, Layout] = {}


def _bind(fn, name: str):
    if fn.argtypes is None:  # once per library function
        fn.argtypes, fn.restype = _ARGTYPES[name], _INT
    return fn


def _row_major(t: torch.Tensor) -> bool:
    """Whether ``t`` has a unit stride along its last dimension (rows,
    variables); broadcast views keep theirs, so they are not copied."""
    return t.shape[-1] <= 1 or t.stride(-1) == 1


def _broadcast(shapes: Sequence[Tuple[int, ...]]) -> Tuple[int, ...]:
    """``torch.broadcast_shapes`` of the batch shapes, on tuples."""
    rank = max(len(s) for s in shapes)
    out = []
    for k in range(rank):
        sizes = {s[k - rank + len(s)] for s in shapes if k - rank + len(s) >= 0} - {1}
        if len(sizes) > 1:
            raise ValueError(f"batch shapes {shapes} do not broadcast")
        out.append(sizes.pop() if sizes else 1)
    return tuple(out)


def _batch_strides(t: torch.Tensor, batch: Tuple[int, ...]) -> list:
    """Element strides of ``t``'s batch dimensions over ``batch`` (0 where
    ``t`` is broadcast; size-1 dimensions of ``batch`` are not read)."""
    strides = t.broadcast_to(batch + t.shape[-1:]).stride()
    return [s if size > 1 else 0 for s, size in zip(strides, batch)]


def _signature(trees: TreeTensors, data: torch.Tensor, fset: FunctionSet) -> tuple:
    ops, c2, cst = trees.ops, trees.c2, trees.const
    return (ops.shape, ops.stride(), ops.dtype, ops.device, c2.shape, c2.stride(), c2.dtype,
            c2.device, cst.shape, cst.stride(), cst.dtype, cst.device, data.shape, data.stride(),
            data.dtype, data.device, fset.device_op_ids, fset.arities, fset.user_hash)


def _make_layout(trees: TreeTensors, data: torch.Tensor, fset: FunctionSet) -> Layout:
    """Check the operands and work out their layout (a cache miss)."""
    n = trees.max_nodes
    dev = trees.ops.device
    for name, t, dtype in (("ops", trees.ops, torch.int32), ("c2", trees.c2, torch.int32),
                           ("const", trees.const, torch.float32), ("data", data, torch.float32)):
        if t.device != dev or t.dtype != dtype:
            raise ValueError(f"{name}: expected {dtype} on {dev}, got {t.dtype} on {t.device}")
    if trees.c2.shape != trees.ops.shape or trees.const.shape[-1] != n:
        raise ValueError("ops, c2 and const must describe the same trees")
    if n * THREADS * 8 > SCRATCH_BYTES:
        raise NotImplementedError(
            f"max_nodes {n}: one block's tape ({THREADS} lanes x {n} rows x 8 B) exceeds the "
            f"interpreter kernel's scratch of {SCRATCH_BYTES} B ({SCRATCH_BYTES // (THREADS * 8)} rows)")
    nvar = data.shape[-1]
    if nvar > MAX_VARS:
        raise NotImplementedError(f"{nvar} variables > {MAX_VARS}, the interpreter kernel's limit")
    fset.require_device_ops()
    batch = _broadcast([trees.ops.shape[:-1], trees.const.shape[:-1], data.shape[:-1]])
    if len(batch) > MAX_DIMS:
        raise NotImplementedError(f"batch rank {len(batch)} > {MAX_DIMS}")
    lanes = math.prod(batch)
    if lanes > MAX_LANES:
        raise NotImplementedError(f"{lanes} lanes > {MAX_LANES}")
    operands = [trees.ops, trees.c2, trees.const, data]
    copy = [not _row_major(t) for t in operands]
    ops, c2, cst, x = (t.contiguous() if c else t for t, c in zip(operands, copy))
    tree = _batch_strides(ops, batch)
    if _batch_strides(c2, batch) != tree:  # the kernel reads both at one offset
        copy[0] = copy[1] = True
        ops, c2 = ops.contiguous(), c2.contiguous()
        tree = _batch_strides(ops, batch)
    cs, xs = _batch_strides(cst, batch), _batch_strides(x, batch)
    out = [math.prod(batch[k + 1:]) for k in range(len(batch))]
    dims = [k for k in range(len(batch)) if batch[k] > 1]
    group = [k for k in dims if tree[k] or cs[k]]
    order = group + [k for k in dims if not (tree[k] or cs[k])]

    def per_dim(v):
        return [v[k] for k in order] + [0] * (MAX_DIMS - len(order))

    ids = list(fset.device_op_ids)
    wide = not takes_fixed(n, nvar, fset.num_operators, fset.max_device_op)
    words = (ctypes.c_int64 * (HEADER_WORDS + op_table_words(fset)))(
        len(order), len(group), n, nvar, fset.var_start, fset.num_operators, fset.has_unary, wide,
        *per_dim(batch), *per_dim(tree), *per_dim(cs), *per_dim(xs),
        *per_dim(out), *ids, *[0] * (op_table_words(fset) - len(ids)))
    steps = (_step(lanes, n, 4), _step(lanes, n, 8)) if wide and lanes else (lanes, lanes)
    return Layout(tuple(copy), torch.Size(batch), lanes, words, ctypes.addressof(words), wide,
                  *steps)


def _operands(trees: TreeTensors, data: torch.Tensor, fset: FunctionSet):
    """The operands as the kernel reads them and their :class:`Layout`,
    from the cache where this signature was seen before."""
    key = _signature(trees, data, fset)
    layout = _layouts.get(key)
    if layout is None:
        _build.refuse_in_capture("an interpreter layout made")
        layout = _make_layout(trees, data, fset)
        if len(_layouts) >= MAX_LAYOUTS:
            del _layouts[next(iter(_layouts))]
        _layouts[key] = layout
    operands = trees.ops, trees.c2, trees.const, data
    if any(layout.copy):
        operands = tuple(t.contiguous() if c else t for t, c in zip(operands, layout.copy))
    return operands + (layout,)


def _launches(fn, layout: Layout, step: int, row_floats: int, device, args: tuple, stream):
    """Call ``fn(*args, scratch, lane0, count, stream)`` once (the fixed
    instances) or once per ``step`` lanes (the wide one, with a scratch of
    ``row_floats`` floats per row and lane); returns ``(status, launches)``,
    stopping at the first launch that fails."""
    if not layout.wide:
        return fn(*args, None, 0, layout.lanes, stream), 1
    n = layout.words[2]
    scratch = torch.empty(step * n * row_floats, dtype=torch.float32, device=device)
    launches = 0
    for lane0 in range(0, layout.lanes, step):
        status = fn(*args, scratch.data_ptr(), lane0, min(step, layout.lanes - lane0), stream)
        launches += 1
        if status:
            break
    return status, launches


def _forward(fn, ops, c2, cst, x, layout: Layout, stream):
    """``(status, roots shaped like the joint batch, launches)``."""
    out = torch.empty(layout.batch, dtype=torch.float32, device=ops.device)
    if not layout.lanes:
        return 0, out, 0
    args = (ops.data_ptr(), c2.data_ptr(), cst.data_ptr(), x.data_ptr(), layout.address,
            out.data_ptr())
    status, launches = _launches(_bind(fn, "interpret_fwd"), layout, layout.fwd_step, 1,
                                 ops.device, args, stream)
    return status, out, launches


def _backward(fn, ops, c2, cst, x, layout: Layout, n: int, g: torch.Tensor, stream):
    """``(status, dconst (*batch, N), ddata (*batch, V), launches)`` per lane
    (views of the lane-minor outputs)."""
    batch, lanes = layout.batch, layout.lanes
    if g.shape != batch or g.dtype != torch.float32 or g.device != ops.device:
        raise ValueError(f"cotangent {tuple(g.shape)} {g.dtype}: expected {tuple(batch)} float32")
    g = g.contiguous()
    # one allocation for both outputs (each torch.empty is ~9 us of host time
    # on the card's host, PERF.md §6)
    both = torch.empty((n + x.shape[-1], lanes), dtype=torch.float32, device=ops.device)
    dconst, ddata = both[:n], both[n:]
    status, launches = 0, 0
    if lanes:
        args = (ops.data_ptr(), c2.data_ptr(), cst.data_ptr(), x.data_ptr(), layout.address,
                g.data_ptr(), dconst.data_ptr(), ddata.data_ptr())
        status, launches = _launches(_bind(fn, "interpret_bwd"), layout, layout.bwd_step, 2,
                                     ops.device, args, stream)
    per_lane = lambda t: t.view((t.shape[0],) + tuple(batch)).movedim(0, -1)
    return status, per_lane(dconst), per_lane(ddata), launches


def run_forward(fn, trees: TreeTensors, data: torch.Tensor, fset: FunctionSet,
                stream=None) -> torch.Tensor:
    """Call ``interpret_fwd`` (of the CUDA library, or of the host build on
    CPU tensors); returns ``(status, roots shaped like the joint batch)``."""
    return _forward(fn, *_operands(trees, data, fset), stream)[:2]


def run_backward(fn, trees: TreeTensors, data: torch.Tensor, g: torch.Tensor, fset: FunctionSet,
                 stream=None):
    """Call ``interpret_bwd``; returns ``(status, dconst (*batch, N), ddata
    (*batch, V))`` per lane (views of the lane-minor outputs)."""
    return _backward(fn, *_operands(trees, data, fset), trees.max_nodes, g, stream)[:3]


def _require_cuda(trees: TreeTensors) -> torch.device:
    dev = trees.ops.device
    if dev.type != "cuda":
        raise ValueError(f"the interpreter kernels take CUDA tensors, got {dev}")
    return dev


def evaluate_trees_cuda(trees: TreeTensors, data: torch.Tensor, fset: FunctionSet) -> torch.Tensor:
    """Launch the forward kernel: float32 roots of the joint batch shape."""
    dev = _require_cuda(trees)
    lib = _build.load("interpreter", fset.variant)
    status, out, launches = _forward(lib.interpret_fwd, *_operands(trees, data, fset),
                                     torch.cuda.current_stream(dev).cuda_stream)
    evaluate_trees_cuda.launches += launches
    _build.check(lib, status, "interpreter forward kernel launch")
    return out


evaluate_trees_cuda.launches = 0


def evaluate_trees_vjp_cuda(
    trees: TreeTensors, data: torch.Tensor, g: torch.Tensor, fset: FunctionSet,
) -> Tuple[torch.Tensor, torch.Tensor]:
    """Launch the reverse-sweep kernel: ``(dconst like trees.const, ddata
    like data)`` for the roots' cotangent ``g``."""
    dev = _require_cuda(trees)
    lib = _build.load("interpreter", fset.variant)
    status, dconst, ddata, launches = _backward(
        lib.interpret_bwd, *_operands(trees, data, fset), trees.max_nodes, g,
        torch.cuda.current_stream(dev).cuda_stream)
    evaluate_trees_vjp_cuda.launches += launches
    _build.check(lib, status, "interpreter backward kernel launch")
    return dconst.sum_to_size(trees.const.shape), ddata.sum_to_size(data.shape)


evaluate_trees_vjp_cuda.launches = 0
