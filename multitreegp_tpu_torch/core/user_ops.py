"""User operator callables as generated device code: trace, check, emit.

In the JAX package an operator is any callable, which Pallas traces into
every tree kernel. Here a torch callable outside the operator table
(``registry.OPERATORS``), or under a table name but computing something else
(a protected ``log``), is traced to an aten graph, forward and VJP, and each
graph is written out as one ``__host__ __device__`` function of float32
scalars. The functions of a function set's operators make one header, which
the tree kernels' third build (``_build.user_variant``: ``-DMTGP_EXT_OPS
-DMTGP_USER_OPS -include <header>``, the libraries ``<name>_u<hash12>``)
compiles in; ``csrc/tree_eval.cuh`` dispatches a device op id of
:data:`USER_FROM` or more to them.

* **Trace.** ``make_fx`` of ``fn(x, y)`` (a unary operator's ``fn`` ignores
  ``y``) on float32 CPU tensors of shape ``(8,)``, and of ``lambda x, y, g:
  torch.func.vjp(fn, x, y)[1](g)``, each functionalised
  (``torch.func.functionalize``, mutations and views removed: ``mul_``
  becomes ``mul``): the backward graph holds autograd's own formulas, which
  autograd runs through the same callable in the plain versions.
* **Check.** Every node is an aten op of :data:`EMITTERS`, every value
  float32 (a comparison's bool only as a ``where`` condition or a logical
  operand), every tensor value per lane (shape ``(8,)``) or a constant.
  Refused, with the reason: a callable that does not trace (Python control
  flow on values, ``.item()``, numpy), that writes into its own inputs,
  that draws random numbers, that reduces over the lanes, that holds a
  tensor constant, or that has a node outside the table (among them the
  special functions whose CUDA form is PyTorch's own series, ``lgamma``,
  whose VJP is ``digamma``, and ``torch.special.i0``). A refused callable
  runs on the CPU only.
* **Emit.** One statement per aten node, one float32 rounding each, as
  PyTorch's CUDA elementwise kernel for that node computes it (a division by
  a Python scalar multiplies by its float32 reciprocal, as the CUDA kernel
  does; the CPU one divides); constants as float32 bit patterns; both sides
  of a ``where`` are computed and one is selected. Math functions are the
  CUDA library's calls PyTorch's kernels make (``erff``, ``atan2f``,
  ``powf``, ...), the host build's the C library's; where PyTorch's CPU and
  CUDA kernels compute a node by other formulas (``rsqrt``: ``rsqrtf`` on
  the card, ``1 / sqrt`` on the CPU), the header's prelude holds both under
  ``__CUDA_ARCH__``, so that each build agrees with PyTorch on its device.

The header's text is the same for the same code, so its sha256 names the
library (``_build.header_hash``): function sets that trace to the same code
share one build, across processes.
"""
from __future__ import annotations

import struct
from dataclasses import dataclass
from typing import Callable, Dict, List, Sequence, Tuple

import torch

USER_FROM = 17  # the first user device op id, past kMin (csrc/tree_eval.cuh kUserFrom)
MAX_DEVICE_OP = 63  # a decoded row keeps its device op id in 6 bits
TRACE_LANES = 8


class Refused(Exception):
    """A callable the emitter does not compile; ``str()`` is the reason."""


@dataclass(frozen=True)
class UserOp:
    """One traced operator: its name, arity, and the C++ bodies of its
    forward ``(x, y) -> value`` and VJP ``(g, x, y) -> (dx, dy)``."""

    name: str
    arity: int
    forward: str
    vjp: str


def _f32(v) -> str:
    """A float32 constant as its exact bit pattern."""
    bits = struct.unpack("<I", struct.pack("<f", float(v)))[0]
    return f"mtgp_user::bits(0x{bits:08x}u)"


def _scalar(v) -> float:
    if isinstance(v, bool) or not isinstance(v, (int, float)):
        raise Refused(f"a non-numeric argument {v!r}")
    return float(v)


def _div_scalar(a: str, s) -> str:
    # PyTorch's CUDA true division by a CPU scalar: a * (1 / s), the
    # reciprocal rounded to float32 on the host
    inv = torch.tensor(1.0, dtype=torch.float32) / torch.tensor(_scalar(s), dtype=torch.float32)
    return f"{a} * {_f32(float(inv))}"


def _pow_scalar(a: str, e) -> str:
    # PyTorch's pow(tensor, scalar) for a float32 base (PowKernel.cu, and
    # the CPU's pow_tensor_scalar_kernel with the same cases): exponent 0
    # fills 1, 1 copies, 0.5 is sqrt, -0.5 rsqrt, -1 the reciprocal, 2 and 3
    # the products base * base (* base), -2 one over base * base; any other
    # exponent, rounded to float32, goes to powf
    e = _scalar(e)
    special = {0.0: _f32(1.0), 1.0: a, 0.5: f"sqrtf({a})", -0.5: f"mtgp_user::rsqrt({a})",
               -1.0: f"1.0f / {a}", 2.0: f"{a} * {a}", 3.0: f"{a} * {a} * {a}",
               -2.0: f"1.0f / ({a} * {a})"}
    return special.get(e, f"powf({a}, {_f32(e)})")


def _alpha_one(kwargs) -> None:
    if _scalar(kwargs.get("alpha", 1)) != 1.0:
        raise Refused("an add or sub with alpha != 1 (its CUDA kernel contracts b * alpha + a)")


def _float_kwarg(kwargs) -> None:
    dtype = kwargs.get("dtype")
    if dtype is not None and dtype != torch.float32:
        raise Refused(f"a constant of dtype {dtype}")


def _clamp(a, lo, hi) -> str:
    # clamp, clamp_min, clamp_max by Python scalars (TensorCompare.cu): NaN
    # propagates from the value, then ::min(::max(v, lo), hi), fmaxf/fminf
    if lo is None and hi is None:
        raise Refused("a clamp without bounds")
    inner = a if lo is None else f"fmaxf({a}, {lo})"
    inner = inner if hi is None else f"fminf({inner}, {hi})"
    return f"({a} != {a} ? {a} : {inner})"


def _nan_first(fn: str):
    # maximum / minimum (MaxMinElementwiseKernel.cu): a if it is NaN, else b
    # if it is NaN, else fmaxf / fminf
    return lambda a, k: f"({a[0]} != {a[0]} ? {a[0]} : ({a[1]} != {a[1]} ? {a[1]} : {fn}({a[0]}, {a[1]})))"


def _bool_to_float(a, k) -> str:
    if set(k) - {"dtype", "layout", "device", "pin_memory"} or k.get("dtype") != torch.float32:
        raise Refused(f"a copy to {k.get('dtype')} (only bool to float32 is emitted)")
    return f"static_cast<float>({a[0]})"


def _call(fn: str):
    return lambda a, k: f"{fn}({', '.join(a)})"


_AT = torch.ops.aten
# aten op -> emitter(args as C++ expressions or Python scalars, kwargs) -> C++
# expression of one float32 (or bool) rounding, as the op's CUDA kernel
# computes it for float32 operands
EMITTERS: Dict[object, Callable] = {
    _AT.abs.default: lambda a, k: f"fabsf({a[0]})",
    _AT.neg.default: lambda a, k: f"-{a[0]}",
    _AT.exp.default: lambda a, k: f"expf({a[0]})",
    _AT.log.default: lambda a, k: f"logf({a[0]})",
    _AT.sqrt.default: lambda a, k: f"sqrtf({a[0]})",
    _AT.sin.default: lambda a, k: f"sinf({a[0]})",
    _AT.cos.default: lambda a, k: f"cosf({a[0]})",
    _AT.tan.default: lambda a, k: f"tanf({a[0]})",
    _AT.tanh.default: lambda a, k: f"tanhf({a[0]})",
    # CUDA's reciprocal kernel: 1 / a, IEEE division
    _AT.reciprocal.default: lambda a, k: f"1.0f / {a[0]}",
    # sign / sgn of a float: (0 < a) - (a < 0), 0 at 0 and NaN
    _AT.sgn.default: lambda a, k: f"static_cast<float>((0.0f < {a[0]}) - ({a[0]} < 0.0f))",
    _AT.sign.default: lambda a, k: f"static_cast<float>((0.0f < {a[0]}) - ({a[0]} < 0.0f))",
    # tanh_backward(g, r): g * (1 - r * r), contracted into one FMA in
    # PyTorch's CUDA build (as csrc/interpreter.cu tanh_grad)
    _AT.tanh_backward.default: lambda a, k: f"{a[0]} * fmaf(-{a[1]}, {a[1]}, 1.0f)",
    _AT.add.Tensor: lambda a, k: (_alpha_one(k), f"{a[0]} + {a[1]}")[1],
    _AT.add.Scalar: lambda a, k: (_alpha_one(k), f"{a[0]} + {a[1]}")[1],
    _AT.sub.Tensor: lambda a, k: (_alpha_one(k), f"{a[0]} - {a[1]}")[1],
    _AT.sub.Scalar: lambda a, k: (_alpha_one(k), f"{a[0]} - {a[1]}")[1],
    _AT.rsub.Scalar: lambda a, k: (_alpha_one(k), f"{a[1]} - {a[0]}")[1],
    _AT.pow.Tensor_Scalar: "pow",  # by a Python scalar: see _pow_scalar
    _AT.mul.Tensor: lambda a, k: f"{a[0]} * {a[1]}",
    _AT.mul.Scalar: lambda a, k: f"{a[0]} * {a[1]}",
    _AT.div.Tensor: "div",  # by a tensor or by a Python scalar: see _emit_node
    _AT.div.Scalar: "div",
    _AT.gt.Scalar: lambda a, k: f"{a[0]} > {a[1]}",
    _AT.gt.Tensor: lambda a, k: f"{a[0]} > {a[1]}",
    _AT.ge.Scalar: lambda a, k: f"{a[0]} >= {a[1]}",
    _AT.ge.Tensor: lambda a, k: f"{a[0]} >= {a[1]}",
    _AT.lt.Scalar: lambda a, k: f"{a[0]} < {a[1]}",
    _AT.lt.Tensor: lambda a, k: f"{a[0]} < {a[1]}",
    _AT.le.Scalar: lambda a, k: f"{a[0]} <= {a[1]}",
    _AT.le.Tensor: lambda a, k: f"{a[0]} <= {a[1]}",
    _AT.eq.Scalar: lambda a, k: f"{a[0]} == {a[1]}",
    _AT.eq.Tensor: lambda a, k: f"{a[0]} == {a[1]}",
    _AT.ne.Scalar: lambda a, k: f"{a[0]} != {a[1]}",
    _AT.ne.Tensor: lambda a, k: f"{a[0]} != {a[1]}",
    _AT.logical_and.default: lambda a, k: f"{a[0]} && {a[1]}",
    _AT.logical_or.default: lambda a, k: f"{a[0]} || {a[1]}",
    _AT.logical_not.default: lambda a, k: f"!{a[0]}",
    _AT.bitwise_and.Tensor: lambda a, k: f"{a[0]} && {a[1]}",
    _AT.bitwise_or.Tensor: lambda a, k: f"{a[0]} || {a[1]}",
    _AT.bitwise_not.default: lambda a, k: f"!{a[0]}",
    _AT.where.self: lambda a, k: f"{a[0]} ? {a[1]} : {a[2]}",
    _AT.where.ScalarSelf: lambda a, k: f"{a[0]} ? {a[1]} : {a[2]}",
    _AT.where.ScalarOther: lambda a, k: f"{a[0]} ? {a[1]} : {a[2]}",
    _AT.where.Scalar: lambda a, k: f"{a[0]} ? {a[1]} : {a[2]}",
    _AT.scalar_tensor.default: lambda a, k: (_float_kwarg(k), a[0])[1],
    _AT.zeros_like.default: lambda a, k: (_float_kwarg(k), _f32(0.0))[1],
    _AT.ones_like.default: lambda a, k: (_float_kwarg(k), _f32(1.0))[1],
    _AT.full_like.default: lambda a, k: (_float_kwarg(k), a[1])[1],
    # the CUDA library's calls that PyTorch's kernels make for float32
    # (UnaryOpsKernel.cu, UnarySpecialOpsKernel.cu, UnaryGeometric*Kernel.cu,
    # BinaryMiscOpsKernels.cu, PowKernel.cu, ...)
    **{getattr(_AT, op).default: _call(fn) for op, fn in (
        ("erf", "erff"), ("erfc", "erfcf"), ("atan", "atanf"), ("asin", "asinf"), ("acos", "acosf"),
        ("sinh", "sinhf"), ("cosh", "coshf"), ("asinh", "asinhf"), ("acosh", "acoshf"),
        ("atanh", "atanhf"), ("log1p", "log1pf"), ("log2", "log2f"), ("log10", "log10f"),
        ("expm1", "expm1f"), ("exp2", "exp2f"), ("atan2", "atan2f"), ("hypot", "hypotf"),
        ("floor", "floorf"), ("ceil", "ceilf"), ("trunc", "truncf"),
        # round half to even: std::nearbyint
        ("round", "nearbyintf"),
        # rsqrtf on the card, 1 / sqrt on the CPU: the prelude's
        ("rsqrt", "mtgp_user::rsqrt"))},
    _AT.fmod.Tensor: _call("fmodf"),
    _AT.fmod.Scalar: _call("fmodf"),
    _AT.pow.Tensor_Tensor: _call("powf"),
    # fmod, then the divisor added where the result is non-zero and lies on
    # the other side of 0 from the divisor (both devices)
    _AT.remainder.Tensor: _call("mtgp_user::remainder"),
    _AT.remainder.Scalar: _call("mtgp_user::remainder"),
    _AT.div.Tensor_mode: "div",  # floor or trunc, by a tensor: see _emit_node
    # one / (one + exp(-x)); its backward a * (one - b) * b
    _AT.sigmoid.default: lambda a, k: f"1.0f / (1.0f + expf(-{a[0]}))",
    _AT.sigmoid_backward.default: lambda a, k: f"{a[0]} * (1.0f - {a[1]}) * {a[1]}",
    _AT.clamp.default: lambda a, k: _clamp(*(a + [None, None])[:3]),
    _AT.clamp_min.default: lambda a, k: _clamp(a[0], a[1], None),
    _AT.clamp_max.default: lambda a, k: _clamp(a[0], None, a[1]),
    # relu is clamp_min(x, 0) on the card; its backward threshold_backward
    # (x <= threshold ? 0 : grad), with the forward's result as x
    _AT.relu.default: lambda a, k: _clamp(a[0], _f32(0.0), None),
    _AT.threshold_backward.default: lambda a, k: f"{a[1]} <= {a[2]} ? {_f32(0.0)} : {a[0]}",
    _AT.maximum.default: _nan_first("fmaxf"),
    _AT.minimum.default: _nan_first("fminf"),
    _AT.masked_fill.Scalar: lambda a, k: f"{a[1]} ? {a[2]} : {a[0]}",
    _AT._to_copy.default: _bool_to_float,
    # functionalised ``torch.empty_like(x).fill_(v)``: the constant v
    _AT.empty_like.default: lambda a, k: (_float_kwarg(k), _f32(0.0))[1],
    _AT.fill.Scalar: lambda a, k: a[1],
    _AT.clone.default: lambda a, k: a[0],
    _AT.alias.default: lambda a, k: a[0],
    _AT.detach.default: lambda a, k: a[0],
}
# ops whose value is a constant (a 0-dim tensor or a tensor like the lanes)
_CONSTANT_MAKERS = {_AT.scalar_tensor.default, _AT.zeros_like.default, _AT.ones_like.default,
                    _AT.full_like.default, _AT.empty_like.default, _AT.fill.Scalar}
# ops whose first argument is read only for its shape
_SHAPE_ONLY = {_AT.zeros_like.default, _AT.ones_like.default, _AT.full_like.default,
               _AT.empty_like.default, _AT.fill.Scalar}
_BOOL_OPS = {op for op in EMITTERS if str(op).split(".")[1] in
             ("gt", "ge", "lt", "le", "eq", "ne", "logical_and", "logical_or", "logical_not",
              "bitwise_and", "bitwise_or", "bitwise_not")}


def trace(fn: Callable) -> Tuple[torch.fx.GraphModule, torch.fx.GraphModule]:
    """``(forward graph of fn(x, y), graph of its VJP (x, y, g) -> (dx,
    dy))``, dead nodes removed; raises :class:`Refused` where the callable
    does not trace."""
    from torch.fx.experimental.proxy_tensor import make_fx

    x, y, g = (torch.zeros(TRACE_LANES, dtype=torch.float32) for _ in range(3))
    pure = lambda f: torch.func.functionalize(f, remove="mutations_and_views")
    graphs = []
    for f, args in ((fn, (x, y)), (lambda x, y, g: torch.func.vjp(fn, x, y)[1](g), (x, y, g))):
        try:
            gm = make_fx(pure(f))(*args)
        except Exception as exc:  # noqa: BLE001 - any failure to trace refuses the callable
            first = str(exc).strip().splitlines()[0] if str(exc).strip() else ""
            raise Refused(f"it does not trace to an aten graph ({type(exc).__name__}: {first[:160]})") from exc
        # functionalisation writes a mutated input back with copy_
        if any(n.target == _AT.copy_.default for n in gm.graph.nodes):
            raise Refused("it writes into its own inputs (aten.copy_)")
        gm.graph.eliminate_dead_code()
        graphs.append(gm)
    return tuple(graphs)


def _check_value(node, what: str) -> None:
    val = node.meta.get("val")
    if not isinstance(val, torch.Tensor):
        raise Refused(f"{what} has no tensor value")
    if val.dtype not in (torch.float32, torch.bool):
        raise Refused(f"{what} computes in {val.dtype}, not float32")
    if val.dtype == torch.bool and node.target not in _BOOL_OPS:
        raise Refused(f"{what} makes a bool outside a comparison")
    if tuple(val.shape) not in ((TRACE_LANES,), ()):
        raise Refused(f"{what} is not per lane (shape {tuple(val.shape)})")
    if val.dim() == 0 and node.target not in _CONSTANT_MAKERS:
        raise Refused(f"{what} reduces over the lanes")


def _emit_graph(gm: torch.fx.GraphModule, inputs: Sequence[str]) -> Tuple[List[str], List[str]]:
    """``(statements, output expressions)`` of one graph, its placeholders
    bound to ``inputs`` in order."""
    names: Dict[torch.fx.Node, str] = {}
    lines: List[str] = []
    placeholders = iter(inputs)
    outputs: List[str] = []
    for node in gm.graph.nodes:
        if node.op == "placeholder":
            names[node] = next(placeholders)
        elif node.op == "get_attr":
            raise Refused(f"it holds a tensor constant ({node.target})")
        elif node.op == "call_function":
            _emit_node(node, names, lines)
        elif node.op == "output":
            outs = node.args[0]
            outs = outs if isinstance(outs, (tuple, list)) else (outs,)
            for o in outs:
                if o is None:
                    outputs.append(_f32(0.0))
                elif isinstance(o, torch.fx.Node):
                    if isinstance(o.meta.get("val"), torch.Tensor) and o.meta["val"].dtype != torch.float32:
                        raise Refused("its value is not float32")
                    outputs.append(names[o])
                else:
                    outputs.append(_f32(_scalar(o)))
        else:
            raise Refused(f"a graph node of kind {node.op}")
    return lines, outputs


def check_op(node, check_value: Callable = None) -> str:
    """Refuse ``node`` unless the emitter compiles its aten op on values that
    ``check_value(node, what)`` admits (default: per lane or constant,
    :func:`_check_value`); returns the op's name."""
    target = node.target
    what = f"{target}" if isinstance(target, torch._ops.OpOverload) else repr(target)
    if isinstance(target, torch._ops.OpOverload):
        tags = getattr(target, "tags", ())
        if torch.Tag.nondeterministic_seeded in tags:
            raise Refused(f"it draws random numbers ({what})")
        if torch.Tag.reduction in tags:
            raise Refused(f"it reduces over the lanes ({what})")
    if EMITTERS.get(target) is None:
        raise Refused(f"it has an aten op outside the emitter's table ({what})")
    (check_value or _check_value)(node, what)
    if target == _AT.empty_like.default and any(u.target != _AT.fill.Scalar for u in node.users):
        raise Refused(f"it reads an uninitialised tensor ({what})")
    if target == _AT._to_copy.default and node.args[0].meta["val"].dtype != torch.bool:
        raise Refused(f"a copy from {node.args[0].meta['val'].dtype} (only bool to float32 is emitted)")
    return what


def node_expr(node, name_of: Callable) -> str:
    """The C++ expression of one float32 (or bool) rounding of a checked
    node (:func:`check_op`), its node operands named by ``name_of(node)``."""
    target = node.target
    what = f"{target}"
    emitter = EMITTERS[target]
    skip_first = target in _SHAPE_ONLY

    def arg(a, i):
        if a is None:  # an absent optional argument (a clamp's bound)
            return None
        if isinstance(a, torch.fx.Node):
            if skip_first and i == 0:
                return None
            return name_of(a)
        return _f32(_scalar(a))

    if emitter == "pow":
        a, e = node.args[:2]
        if not isinstance(a, torch.fx.Node):
            raise Refused(f"a power of a scalar ({what})")
        return _pow_scalar(name_of(a), e)
    if emitter == "div":
        a, b = node.args[:2]
        mode = node.kwargs.get("rounding_mode")
        if not isinstance(a, torch.fx.Node):
            raise Refused(f"a division of a scalar ({what})")
        if mode is None:
            return f"{name_of(a)} / {name_of(b)}" if isinstance(b, torch.fx.Node) else _div_scalar(name_of(a), b)
        if not isinstance(b, torch.fx.Node):
            # by a scalar the card multiplies by its reciprocal, the CPU divides
            raise Refused(f"a rounded division by a scalar ({what})")
        if mode == "floor":  # c10::div_floor_floating
            return f"mtgp_user::div_floor({name_of(a)}, {name_of(b)})"
        return f"truncf({name_of(a)} / {name_of(b)})"  # trunc: std::trunc(a / b)
    try:
        return emitter([arg(a, i) for i, a in enumerate(node.args)], dict(node.kwargs))
    except Refused as exc:
        raise Refused(f"{exc} ({what})") from exc


def _emit_node(node, names: Dict, lines: List[str]) -> None:
    check_op(node)
    expr = node_expr(node, names.__getitem__)
    ctype = "bool" if node.meta["val"].dtype == torch.bool else "float"
    name = f"v{len(lines)}"
    names[node] = name
    lines.append(f"const {ctype} {name} = {expr};")


def compile_op(name: str, fn: Callable, arity: int) -> UserOp:
    """Trace ``fn(x, y)`` and emit its forward and VJP; raises
    :class:`Refused` with the reason where it cannot."""
    fwd, bwd = trace(fn)
    f_lines, f_out = _emit_graph(fwd, ("x", "y"))
    b_lines, b_out = _emit_graph(bwd, ("x", "y", "g"))
    if len(f_out) != 1 or len(b_out) != 2:
        raise Refused(f"it returns {len(f_out)} values, not one")
    forward = "\n".join(f_lines + [f"return {f_out[0]};"])
    vjp = "\n".join(b_lines + [f"dx = {b_out[0]};", f"dy = {b_out[1]};"])
    return UserOp(name, arity, forward, vjp)


_PRELUDE_HEAD = """\
// Generated by multitreegp_tpu_torch/core/user_ops.py: the user operators of
// one function set, device op ids kUserFrom + k. Built into the tree kernels'
// user libraries with -DMTGP_EXT_OPS -DMTGP_USER_OPS -include <this file>.
#pragma once

"""
# the includes and MTGP_USER_HD, and the helpers in namespace mtgp_user, that
# a generated header defines (core/user_envs.py's too, unless the user
# operators' header, included first, has)
INCLUDES = """\
#include <math.h>
#include <stdint.h>
#include <string.h>

#ifdef __CUDACC__
#include <cuda_runtime.h>
#define MTGP_USER_HD __host__ __device__
#else
#define MTGP_USER_HD
#endif
"""
HELPERS = """\
MTGP_USER_HD inline float bits(uint32_t u) {
#ifdef __CUDA_ARCH__
  return __uint_as_float(u);
#else
  float f;
  memcpy(&f, &u, sizeof f);
  return f;
#endif
}

// PyTorch's rsqrt: ::rsqrt on the card (rsqrtf), 1 / sqrt on the CPU
MTGP_USER_HD inline float rsqrt(float x) {
#ifdef __CUDA_ARCH__
  return rsqrtf(x);
#else
  return 1.0f / sqrtf(x);
#endif
}

// PyTorch's remainder of floats: fmod, moved by the divisor where the
// result is non-zero and lies on the other side of 0 from the divisor
MTGP_USER_HD inline float remainder(float a, float b) {
  float mod = fmodf(a, b);
  if ((mod != 0.0f) && ((b < 0.0f) != (mod < 0.0f))) mod += b;
  return mod;
}

// c10::div_floor_floating: a / b rounded down, as Python's a // b
MTGP_USER_HD inline float div_floor(float a, float b) {
  if (b == 0.0f) return a / b;
  float mod = fmodf(a, b);
  float div = (a - mod) / b;
  if ((mod != 0.0f) && ((b < 0.0f) != (mod < 0.0f))) div -= 1.0f;
  float floordiv;
  if (div != 0.0f) {
    floordiv = floorf(div);
    if (div - floordiv > 0.5f) floordiv += 1.0f;
  } else {  // 0 on the quotient's side of 0 (here |a| < |b|: a / b is finite)
    floordiv = (a / b) * 0.0f;
  }
  return floordiv;
}
"""
_PRELUDE = _PRELUDE_HEAD + INCLUDES + "\nnamespace mtgp_user {\n\n" + HELPERS


def header(ops: Sequence[UserOp]) -> str:
    """The generated header of ``ops`` (user op k: device op id
    ``USER_FROM + k``): code only, no names, so that the same code gives the
    same text."""
    parts = [_PRELUDE, f"constexpr int kCount = {len(ops)};", ""]
    indent = lambda body: "\n".join("  " + line for line in body.splitlines())
    for k, op in enumerate(ops):
        parts += [f"// user op {k} ({'unary' if op.arity == 1 else 'binary'})",
                  f"MTGP_USER_HD inline float forward{k}(float x, float y) {{",
                  "  (void)x;\n  (void)y;", indent(op.forward), "}",
                  f"MTGP_USER_HD inline void vjp{k}(float g, float x, float y, float& dx, float& dy) {{",
                  "  (void)g;\n  (void)x;\n  (void)y;", indent(op.vjp), "}", ""]
    unary = [k for k, op in enumerate(ops) if op.arity == 1]
    binary = [k for k, op in enumerate(ops) if op.arity == 2]
    parts += ["// whether user op k is unary",
              "MTGP_USER_HD inline bool unary(int k) {",
              "  switch (k) {", *[f"    case {k}:" for k in unary],
              *(["      return true;"] if unary else []),
              "    default: return false;", "  }", "}", ""]
    # one dispatch per arity, so that a row's unary and binary paths each
    # hold only their own operators' code
    for kind, ks, args, call in (("unary", unary, "float x", "x, 0.0f"),
                                 ("binary", binary, "float x, float y", "x, y")):
        cases = lambda fmt: ([f"    case {k}: {fmt.format(k=k)}" for k in ks[:-1]]
                             + [f"    default: {fmt.format(k=ks[-1])}"])
        parts += [f"// the {kind} user op k's value",
                  f"MTGP_USER_HD inline float forward_{kind}(int k, {args}) {{"]
        parts += (["  switch (k) {", *cases(f"return forward{{k}}({call});"), "  }"] if ks
                  else ["  (void)k;", *([] if kind == "unary" else ["  (void)y;"]), "  (void)x;",
                        "  return 0.0f;"])
        parts += ["}", "", f"// the {kind} user op k's cotangents for the value's cotangent g",
                  f"MTGP_USER_HD inline void vjp_{kind}(int k, float g, {args}, float& dx"
                  + (", float& dy) {" if kind == "binary" else ") {")]
        if kind == "unary" and ks:
            parts += ["  float dy;"]
        parts += (["  switch (k) {", *cases(f"vjp{{k}}(g, {call}, dx, dy); return;"), "  }"] if ks
                  else ["  (void)k;\n  (void)g;\n  (void)x;", *([] if kind == "unary" else ["  (void)y;"]),
                        "  dx = 0.0f;", *(["  dy = 0.0f;"] if kind == "binary" else [])])
        parts += ["}", ""]
    parts += ["}  // namespace mtgp_user", ""]
    return "\n".join(parts)
