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
  A 0-d float32 tensor constant (``x * torch.tensor(2.0)``) is one
  literal, as a Python number would be. Refused, with the reason: a
  callable that does not trace (Python control flow on values, ``.item()``,
  numpy, ops without an autograd derivative: ``//``, ``heaviside``,
  ``igamma``), that writes into its own inputs, that draws random numbers,
  that reduces over the lanes, that holds a tensor constant with a lane axis
  or of another dtype, or that has a node outside the table. A refused
  callable runs on the CPU only.
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
  The formulas longer than one expression (the special functions, the
  activations and their backwards, ``logaddexp``, rounded division by a
  scalar, ``clamp`` by tensors) are helpers in ``csrc/user_math.cuh``,
  each written twice where the devices differ: PyTorch's CUDA formula with
  nvcc's contractions written out as FMAs (the kernels build with
  ``-fmad=false``), its CPU formula on the host. A header holds only the
  helpers its operators call.
* **Trace the VJP as autograd runs it.** The VJP is traced with grad mode
  off, as ``torch.autograd.grad`` runs the backward without
  ``create_graph``: autograd's formulas for ``silu``, ``mish`` and
  ``logit`` then call their backward kernels (``silu_backward``, ...), as
  the plain versions do, not the decompositions it records for a second
  derivative.

The header's text is the same for the same code, so its sha256 names the
library (``_build.header_hash``): function sets that trace to the same code
share one build, across processes.
"""
from __future__ import annotations

import math
import operator
import re
import struct
from dataclasses import dataclass
from functools import lru_cache
from pathlib import Path
from typing import Callable, Dict, List, Sequence, Tuple

import torch

USER_FROM = 17  # the first user device op id, past kMin (csrc/tree_eval.cuh kUserFrom)
TRACE_LANES = 8
MATH_SOURCE = Path(__file__).resolve().parent.parent / "csrc" / "user_math.cuh"


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
    helpers: Tuple[str, ...] = ()  # the csrc/user_math.cuh sections it calls


def _f32(v) -> str:
    """A float32 constant as its exact bit pattern."""
    bits = struct.unpack("<I", struct.pack("<f", float(v)))[0]
    return f"mtgp_user::bits(0x{bits:08x}u)"


def _scalar(v) -> float:
    if isinstance(v, bool) or not isinstance(v, (int, float)):
        raise Refused(f"a non-numeric argument {v!r}")
    return float(v)


def _exact_reciprocal(s) -> bool:
    """Whether float32 ``s``'s reciprocal is exact (a power of 2, or inf):
    a division by it and a multiply by its reciprocal round alike."""
    return math.frexp(_f32_of(s))[0] in (0.5, -0.5) or not math.isfinite(_f32_of(s))


def _div_scalar(a: str, s) -> str:
    # PyTorch's CUDA true division by a CPU scalar: a * (1 / s), the
    # reciprocal rounded to float32 on the host; its CPU kernel divides,
    # which rounds alike where the reciprocal is exact, else the helper
    # holds both
    inv = torch.tensor(1.0, dtype=torch.float32) / torch.tensor(_scalar(s), dtype=torch.float32)
    if _exact_reciprocal(s):
        return f"{a} * {_f32(float(inv))}"
    return f"mtgp_user::div_cpu_scalar({a}, {_f32(s)}, {_f32(float(inv))})"


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


class ByNode:
    """An emitter that reads the node itself: ``fn(node, operand)``, where
    ``operand(i, default)`` is argument ``i`` (or the keyword of that
    position) as a C++ expression, or ``default`` where it is absent."""

    def __init__(self, fn: Callable):
        self.fn = fn


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
    # of two bools (nan_to_num's VJP: isfinite as a product of masks) a
    # logical and
    _AT.mul.Tensor: ByNode(lambda node, arg: f"{arg(0)} && {arg(1)}" if value_of(node).dtype == torch.bool
                           else f"{arg(0)} * {arg(1)}"),
    _AT.mul.Scalar: lambda a, k: f"{a[0]} * {a[1]}",
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
    # fmod, then the divisor added where the result is non-zero and lies on
    # the other side of 0 from the divisor (both devices)
    _AT.remainder.Tensor: _call("mtgp_user::remainder"),
    _AT.remainder.Scalar: _call("mtgp_user::remainder"),
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


def _helper(fn: str) -> ByNode:
    """``mtgp_user::fn(operands)``, a function of ``csrc/user_math.cuh``."""
    return ByNode(lambda node, arg: f"mtgp_user::{fn}({', '.join(arg(i) for i in range(len(node.args)))})")


def _lane_or_scalar(a):
    """Operand ``a`` as a node, or as a number where it is a Python scalar or
    a 0-d tensor constant (a CPU scalar to PyTorch's CUDA kernels)."""
    c = _constant_of(a)
    return a if c is None else c


def _pow(node, arg) -> str:
    # pow(tensor, scalar): see _pow_scalar
    a, e = (_lane_or_scalar(v) for v in node.args[:2])
    if not isinstance(a, torch.fx.Node):
        raise Refused("a power of a scalar by a scalar")
    if isinstance(e, torch.fx.Node):
        raise Refused("a power by a tensor")
    return _pow_scalar(arg(0), e)


def _pow_tensor(node, arg) -> str:
    a, e = (_lane_or_scalar(v) for v in node.args[:2])
    if isinstance(a, torch.fx.Node) and isinstance(e, torch.fx.Node):
        return f"powf({arg(0)}, {arg(1)})"
    if isinstance(a, torch.fx.Node):  # by a 0-d constant: the CPU's pow and the CUDA
        raise Refused("a power by a tensor constant")  # kernel's cases by a scalar part
    if isinstance(e, torch.fx.Node):  # a CPU scalar base: powf
        return f"powf({arg(0)}, {arg(1)})"
    raise Refused("a power of a scalar by a scalar")


def _div(node, arg) -> str:
    a, b = (_lane_or_scalar(v) for v in node.args[:2])
    mode = node.kwargs.get("rounding_mode")
    if not isinstance(a, torch.fx.Node):
        if mode is None and isinstance(b, torch.fx.Node):  # a CPU scalar numerator divides
            return f"{arg(0)} / {arg(1)}"
        raise Refused("a division of a scalar")
    if mode is None:
        return f"{arg(0)} / {arg(1)}" if isinstance(b, torch.fx.Node) else _div_scalar(arg(0), b)
    if not isinstance(b, torch.fx.Node):
        # by a scalar the card multiplies by its float reciprocal, the CPU
        # divides: the helpers hold both
        inv = torch.tensor(1.0, dtype=torch.float32) / torch.tensor(_scalar(b), dtype=torch.float32)
        fn = "div_floor_scalar" if mode == "floor" else "div_trunc_scalar"
        return f"mtgp_user::{fn}({arg(0)}, {_f32(b)}, {_f32(float(inv))})"
    if mode == "floor":  # c10::div_floor_floating
        return f"mtgp_user::div_floor({arg(0)}, {arg(1)})"
    return f"truncf({arg(0)} / {arg(1)})"  # trunc: std::trunc(a / b)


def _value_arg(node, i: int, name: str, default):
    """Argument ``i`` of ``node`` (or its keyword ``name``) as a Python
    value, ``default`` where it is absent."""
    if i < len(node.args):
        return node.args[i]
    return node.kwargs.get(name, default)


def _f32_of(v) -> float:
    """``v`` rounded to float32, as a Python float."""
    return struct.unpack("<f", struct.pack("<f", float(v)))[0]


def _num(node, i: int, name: str, default) -> float:
    v = _value_arg(node, i, name, default)
    if isinstance(v, torch.fx.Node):
        raise Refused(f"a tensor {name} ({node.target})")
    return _scalar(v)


def _pow_base(node, arg) -> str:
    # pow(scalar, tensor) (Pow.cpp): a base of 1 fills 1, any other is
    # rounded to float32 and goes to powf with the tensor as exponent
    base = _num(node, 0, "self", None)
    return _f32(1.0) if base == 1.0 else f"powf({_f32(base)}, {arg(1)})"


def _clamp_tensor(node, arg) -> str:
    # clamp(x, lo, hi) by tensors: clamp_stub with both bounds, else
    # maximum_stub / minimum_stub (NaN first); clamp_min / clamp_max alike
    target = node.target
    lo = arg(1, None) if target != _AT.clamp_max.Tensor else None
    hi = (arg(2, None) if target == _AT.clamp.Tensor else arg(1, None)) if target != _AT.clamp_min.Tensor else None
    if lo is not None and hi is not None:
        return f"mtgp_user::clamp_tensor({arg(0)}, {lo}, {hi})"
    if lo is None and hi is None:
        raise Refused("a clamp without bounds")
    return _nan_first("fmaxf" if hi is None else "fminf")([arg(0), lo if hi is None else hi], {})


def _round_decimals(node, arg) -> str:
    # round(x, decimals=k) (round_decimals_kernel, both devices): k >= 0
    # nearbyint(x * 10^k) / 10^k, k < 0 nearbyint(x / 10^-k) * 10^-k, the
    # power rounded to float32
    k = int(_value_arg(node, 1, "decimals", 0))
    p = _f32(float(10.0 ** abs(k)))
    return f"nearbyintf({arg(0)} / {p}) * {p}" if k < 0 else f"nearbyintf({arg(0)} * {p}) / {p}"


def _polygamma(node, arg) -> str:
    n = int(node.args[0])
    if n < 0:
        raise Refused(f"polygamma of order {n}")
    if n == 0:
        return f"mtgp_user::t_digamma({arg(1)})"
    if n == 1:
        return f"mtgp_user::t_trigamma({arg(1)})"
    return f"mtgp_user::t_polygamma({n}, {arg(1)})"


def _no_eps(node) -> None:
    if _value_arg(node, 1 if node.target == _AT.logit.default else 2, "eps", None) is not None:
        raise Refused(f"a logit with eps ({node.target})")


def _logit(node, arg) -> str:
    _no_eps(node)
    if node.target == _AT.logit.default:
        return f"mtgp_user::t_logit({arg(0)})"
    return f"mtgp_user::t_logit_backward({arg(0)}, {arg(1)})"


def _softplus(node, arg) -> str:
    # softplus(x, beta=1, threshold=20), softplus_backward(g, x, beta,
    # threshold): beta and threshold rounded to float32
    back = node.target == _AT.softplus_backward.default
    o = 1 if back else 0
    beta, thr = _f32(_num(node, 1 + o, "beta", 1.0)), _f32(_num(node, 2 + o, "threshold", 20.0))
    if back:
        return f"mtgp_user::t_softplus_backward({arg(0)}, {arg(1)}, {beta}, {thr})"
    return f"mtgp_user::t_softplus({arg(0)}, {beta}, {thr})"


def _gelu(node, arg) -> str:
    back = node.target == _AT.gelu_backward.default
    approx = _value_arg(node, 2 if back else 1, "approximate", "none")
    if approx not in ("none", "tanh"):
        raise Refused(f"gelu with approximate={approx!r}")
    fn = "t_gelu" + ("_tanh" if approx == "tanh" else "") + ("_backward" if back else "")
    return f"mtgp_user::{fn}({', '.join([arg(0), arg(1)] if back else [arg(0)])})"


def _elu_coefs(alpha: float, scale: float, input_scale: float) -> str:
    # negcoef = alpha * scale in float32, poscoef = scale, negiptcoef =
    # input_scale (elu_kernel's opmath values)
    neg = _f32_of(_f32_of(alpha) * _f32_of(scale))
    return f"{_f32(neg)}, {_f32(scale)}, {_f32(input_scale)}"


def _elu(node, arg) -> str:
    if node.target == _AT.celu.default:  # celu(x, a) = elu(x, a, 1, 1 / a)
        alpha = _num(node, 1, "alpha", 1.0)
        return f"mtgp_user::t_elu({arg(0)}, {_elu_coefs(alpha, 1.0, 1.0 / alpha)})"
    if node.target == _AT.elu.default:
        coefs = _elu_coefs(_num(node, 1, "alpha", 1.0), _num(node, 2, "scale", 1.0),
                           _num(node, 3, "input_scale", 1.0))
        return f"mtgp_user::t_elu({arg(0)}, {coefs})"
    # elu_backward(g, alpha, scale, input_scale, is_result, self_or_result)
    if _value_arg(node, 4, "is_result", False):
        raise Refused("an elu_backward on the result (an in-place elu)")
    coefs = _elu_coefs(_num(node, 1, "alpha", 1.0), _num(node, 2, "scale", 1.0),
                       _num(node, 3, "input_scale", 1.0))
    return f"mtgp_user::t_elu_backward({arg(0)}, {arg(5)}, {coefs})"


def _leaky_relu(node, arg) -> str:
    # x > 0 ? x : x * slope; backward (g, x, slope, self_is_result): x > 0 ?
    # g : g * slope
    back = node.target == _AT.leaky_relu_backward.default
    slope = _f32(_num(node, 2 if back else 1, "negative_slope", 0.01))
    x, v = (arg(1), arg(0)) if back else (arg(0), arg(0))
    return f"({x} > 0.0f ? {v} : {v} * {slope})"


def _hardtanh(node, arg) -> str:
    # hardtanh is clamp by scalars; its backward 0 where x <= min or x >=
    # max, else g
    back = node.target == _AT.hardtanh_backward.default
    o = 1 if back else 0
    lo, hi = _f32(_num(node, 1 + o, "min_val", -1.0)), _f32(_num(node, 2 + o, "max_val", 1.0))
    if back:
        return f"mtgp_user::t_hardtanh_backward({arg(0)}, {arg(1)}, {lo}, {hi})"
    return _clamp(arg(0), lo, hi)


def _softshrink(node, arg) -> str:
    back = node.target == _AT.softshrink_backward.default
    lambd = _f32(_num(node, 2 if back else 1, "lambd", 0.5))
    if back:
        return f"mtgp_user::t_softshrink_backward({arg(0)}, {arg(1)}, {lambd})"
    return f"mtgp_user::t_softshrink({arg(0)}, {lambd})"


def _nan_to_num(node, arg) -> str:
    # NaN, +inf and -inf replaced (defaults 0, the largest and the lowest
    # float32), as float32 values
    nan, pos, neg = (_value_arg(node, i, n, None) for i, n in ((1, "nan"), (2, "posinf"), (3, "neginf")))
    big = float(torch.finfo(torch.float32).max)
    nan = _f32(0.0 if nan is None else _scalar(nan))
    pos = _f32(big if pos is None else _scalar(pos))
    neg = _f32(-big if neg is None else _scalar(neg))
    x = arg(0)
    return f"({x} != {x} ? {nan} : ({x} == INFINITY ? {pos} : ({x} == -INFINITY ? {neg} : {x})))"


def _scaled(c: float) -> ByNode:
    # deg2rad / rad2deg: a multiply by the double constant rounded to float32
    # (mul by a CPU scalar)
    return ByNode(lambda node, arg: f"{arg(0)} * {_f32(c)}")


def _zeros(node, arg) -> str:
    _float_kwarg(node.kwargs)
    return _f32(0.0)


def _log_sigmoid(node, arg) -> str:
    if node.target == _AT.log_sigmoid_forward.default:
        return f"mtgp_user::t_log_sigmoid({arg(0)})"
    # log_sigmoid_backward(g, x, buffer): the CUDA kernel recomputes the
    # buffer (empty there), the CPU's held exp(-|x|)
    return f"mtgp_user::t_log_sigmoid_backward({arg(0)}, {arg(1)})"


# the ops that read their node (a scalar operand, a keyword), then the
# special functions, activations and the rest (csrc/user_math.cuh helpers,
# or one expression)
EMITTERS.update({
    _AT.pow.Tensor_Scalar: ByNode(_pow),
    _AT.pow.Tensor_Tensor: ByNode(_pow_tensor),
    _AT.div.Tensor: ByNode(_div),
    _AT.div.Scalar: ByNode(_div),
    _AT.div.Tensor_mode: ByNode(_div),
    _AT.pow.Scalar: ByNode(_pow_base),
    _AT.clamp.Tensor: ByNode(_clamp_tensor),
    _AT.clamp_min.Tensor: ByNode(_clamp_tensor),
    _AT.clamp_max.Tensor: ByNode(_clamp_tensor),
    _AT.round.decimals: ByNode(_round_decimals),
    _AT.lgamma.default: _call("lgammaf"),
    _AT.digamma.default: _helper("t_digamma"),
    _AT.polygamma.default: ByNode(_polygamma),
    _AT.i0.default: _helper("t_i0"),
    _AT.special_i0e.default: _helper("t_i0e"),
    _AT.special_i1.default: _helper("t_i1"),
    _AT.special_i1e.default: _helper("t_i1e"),
    _AT.special_erfcx.default: _helper("t_erfcx"),
    _AT.erfinv.default: _helper("t_erfinv"),
    _AT.special_ndtri.default: _helper("t_ndtri"),
    _AT.special_log_ndtr.default: _helper("t_log_ndtr"),
    _AT.special_entr.default: _helper("t_entr"),
    _AT.xlogy.Tensor: _helper("t_xlogy"),
    _AT.special_xlog1py.default: _helper("t_xlog1py"),
    _AT.logit.default: ByNode(_logit),
    _AT.logit_backward.default: ByNode(_logit),
    _AT.sinc.default: _helper("t_sinc"),
    _AT.softplus.default: ByNode(_softplus),
    _AT.softplus_backward.default: ByNode(_softplus),
    _AT.gelu.default: ByNode(_gelu),
    _AT.gelu_backward.default: ByNode(_gelu),
    _AT.silu.default: _helper("t_silu"),
    _AT.silu_backward.default: _helper("t_silu_backward"),
    _AT.mish.default: _helper("t_mish"),
    _AT.mish_backward.default: _helper("t_mish_backward"),
    _AT.elu.default: ByNode(_elu),
    _AT.celu.default: ByNode(_elu),
    _AT.elu_backward.default: ByNode(_elu),
    _AT.leaky_relu.default: ByNode(_leaky_relu),
    _AT.leaky_relu_backward.default: ByNode(_leaky_relu),
    _AT.hardtanh.default: ByNode(_hardtanh),
    _AT.hardtanh_backward.default: ByNode(_hardtanh),
    _AT.hardswish.default: _helper("t_hardswish"),
    _AT.hardswish_backward.default: _helper("t_hardswish_backward"),
    _AT.hardsigmoid.default: _helper("t_hardsigmoid"),
    _AT.hardsigmoid_backward.default: _helper("t_hardsigmoid_backward"),
    _AT.softshrink.default: ByNode(_softshrink),
    _AT.softshrink_backward.default: ByNode(_softshrink),
    _AT.log_sigmoid_forward.default: ByNode(_log_sigmoid),
    _AT.log_sigmoid_backward.default: ByNode(_log_sigmoid),
    _AT.logaddexp.default: _helper("t_logaddexp"),
    _AT.logaddexp2.default: _helper("t_logaddexp2"),
    _AT.copysign.Tensor: _call("copysignf"),
    _AT.fmax.default: _call("fmaxf"),
    _AT.fmin.default: _call("fminf"),
    _AT.isnan.default: lambda a, k: f"({a[0]} != {a[0]})",
    _AT.zeros.default: ByNode(_zeros),
    _AT.frac.default: lambda a, k: f"({a[0]} - truncf({a[0]}))",
    # deg2rad / rad2deg multiply by M_PI_180 / M_180_PI (UnaryOps.cpp)
    _AT.deg2rad.default: _scaled(math.pi / 180.0),
    _AT.rad2deg.default: _scaled(180.0 / math.pi),
    _AT.nan_to_num.default: ByNode(_nan_to_num),
    # ldexp(x, y) = x * pow(2.0, y) (BinaryOps.cpp)
    _AT.ldexp.Tensor: lambda a, k: f"{a[0]} * powf({_f32(2.0)}, {a[1]})",
    # a constant's copies (x * torch.tensor(2.0)): the constant itself
    _AT.lift_fresh_copy.default: lambda a, k: a[0],
    _AT.detach_copy.default: lambda a, k: a[0],
})
# ops whose value is a constant (a 0-dim tensor or a tensor like the lanes)
_CONSTANT_MAKERS = {_AT.scalar_tensor.default, _AT.zeros_like.default, _AT.ones_like.default,
                    _AT.full_like.default, _AT.empty_like.default, _AT.fill.Scalar, _AT.zeros.default}
# ops with more than one output, of which a graph reads output 0 (the value)
# through getitem; log_sigmoid_forward's second is a buffer that the CUDA
# kernel leaves empty and its backward recomputes
_MULTI_OUTPUT = {_AT.log_sigmoid_forward.default}
# ops whose first argument is read only for its shape
_SHAPE_ONLY = {_AT.zeros_like.default, _AT.ones_like.default, _AT.full_like.default,
               _AT.empty_like.default, _AT.fill.Scalar}
_BOOL_OPS = {op for op in EMITTERS if str(op).split(".")[1] in
             ("gt", "ge", "lt", "le", "eq", "ne", "logical_and", "logical_or", "logical_not",
              "bitwise_and", "bitwise_or", "bitwise_not", "isnan")} | {_AT.mul.Tensor}


def trace(fn: Callable) -> Tuple[torch.fx.GraphModule, torch.fx.GraphModule]:
    """``(forward graph of fn(x, y), graph of its VJP (x, y, g) -> (dx,
    dy))``, dead nodes removed; raises :class:`Refused` where the callable
    does not trace."""
    from torch.fx.experimental.proxy_tensor import make_fx

    x, y, g = (torch.zeros(TRACE_LANES, dtype=torch.float32) for _ in range(3))
    pure = lambda f: torch.func.functionalize(f, remove="mutations_and_views")

    def vjp(x, y, g):
        pullback = torch.func.vjp(fn, x, y)[1]
        with torch.no_grad():  # the backward as autograd.grad runs it: no create_graph
            return pullback(g)

    graphs = []
    for f, args in ((fn, (x, y)), (vjp, (x, y, g))):
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


def value_of(node):
    """The traced value of ``node``: its tensor, output 0 of a
    multi-output op (:data:`_MULTI_OUTPUT`)."""
    val = node.meta.get("val")
    if node.target in _MULTI_OUTPUT and isinstance(val, (tuple, list)):
        return val[0]
    return val


def _check_value(node, what: str) -> None:
    val = value_of(node)
    if not isinstance(val, torch.Tensor):
        raise Refused(f"{what} has no tensor value")
    if val.dtype not in (torch.float32, torch.bool):
        raise Refused(f"{what} computes in {val.dtype}, not float32")
    if val.dtype == torch.bool and node.target not in _BOOL_OPS:
        raise Refused(f"{what} makes a bool outside a comparison")
    if tuple(val.shape) not in ((TRACE_LANES,), ()):
        raise Refused(f"{what} is not per lane (shape {tuple(val.shape)})")
    if val.dim() == 0 and node.target not in _CONSTANT_MAKERS:
        if any(_constant_of(a) is not None for a in node.args):
            raise Refused(f"{what} computes on a tensor constant alone")
        raise Refused(f"{what} reduces over the lanes")


def _constant(gm: torch.fx.GraphModule, node) -> float:
    """The value of a ``get_attr`` tensor constant, refused unless it is a
    0-d float32 tensor (marked on the node: :func:`_constant_of`)."""
    value = getattr(gm, node.target)
    if not isinstance(value, torch.Tensor) or value.dim() != 0:
        shape = tuple(value.shape) if isinstance(value, torch.Tensor) else type(value).__name__
        raise Refused(f"it holds a tensor constant with a lane axis ({node.target}, shape {shape})")
    if value.dtype != torch.float32:
        raise Refused(f"it holds a tensor constant of dtype {value.dtype} ({node.target})")
    node.meta["mtgp_const"] = float(value)
    return float(value)


_CONSTANT_COPIES = {_AT.lift_fresh_copy.default, _AT.detach_copy.default, _AT.clone.default,
                    _AT.alias.default, _AT.detach.default}


def _constant_of(node):
    """The value of a 0-d tensor constant, or of its copy (marked on the
    node), else None: such an operand is a CPU scalar to PyTorch's CUDA
    kernels, as a Python number is."""
    if not isinstance(node, torch.fx.Node):
        return None
    if "mtgp_const" not in node.meta and node.op == "call_function" and node.target in _CONSTANT_COPIES:
        src = node.args[0] if node.args else None
        if isinstance(src, torch.fx.Node) and "mtgp_const" in src.meta:
            node.meta["mtgp_const"] = src.meta["mtgp_const"]
    return node.meta.get("mtgp_const")


def _output_of(node, names: Dict) -> str:
    """``getitem`` of a multi-output op: output 0 is the op's value; the
    others (log_sigmoid_forward's buffer) are not read by any emitted op."""
    src, index = node.args
    if not isinstance(src, torch.fx.Node) or src.target not in _MULTI_OUTPUT:
        raise Refused(f"it indexes a value that is not a tensor ({getattr(src, 'target', src)})")
    return names[src] if index == 0 else _f32(0.0)


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
            names[node] = _f32(_constant(gm, node))
        elif node.op == "call_function" and node.target is operator.getitem:
            names[node] = _output_of(node, names)
        elif node.op == "call_function" and _constant_of(node) is not None:
            names[node] = names[node.args[0]]
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
    emitter = EMITTERS[target]
    skip_first = target in _SHAPE_ONLY

    def arg(a, i):
        a = _lane_or_scalar(a)  # a 0-d tensor constant is a number to the emitters
        if a is None:  # an absent optional argument (a clamp's bound)
            return None
        if isinstance(a, torch.fx.Node):
            if skip_first and i == 0:
                return None
            return name_of(a)
        return _f32(_scalar(a))

    try:
        if isinstance(emitter, ByNode):
            def operand(i, *default):
                if i >= len(node.args) and default:
                    return default[0]
                return arg(node.args[i], i)
            return emitter.fn(node, operand)
        return emitter([arg(a, i) for i, a in enumerate(node.args)], dict(node.kwargs))
    except Refused as exc:
        raise Refused(f"{exc} ({target})") from exc


_CALL = re.compile(r"\bmtgp_user::(\w+)\(")
_DEFINITION = re.compile(r"^MTGP_USER_HD inline [^(]*?(\w+)\(", re.MULTILINE)


@lru_cache(maxsize=1)
def _math_functions() -> Dict[str, str]:
    """Each function of ``csrc/user_math.cuh`` -> the section defining it."""
    return {fn: name for name, (_, body) in math_sections().items() for fn in _DEFINITION.findall(body)}


def sections_called(code: str) -> Tuple[str, ...]:
    """The ``csrc/user_math.cuh`` sections whose functions ``code`` calls as
    ``mtgp_user::fn(...)`` (the prelude's own helpers need none)."""
    functions = _math_functions()
    return tuple(dict.fromkeys(functions[fn] for fn in _CALL.findall(code) if fn in functions))


def _emit_node(node, names: Dict, lines: List[str]) -> None:
    check_op(node)
    expr = node_expr(node, names.__getitem__)
    ctype = "bool" if value_of(node).dtype == torch.bool else "float"
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
    return UserOp(name, arity, forward, vjp, sections_called(forward + "\n" + vjp))


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
_SECTION = re.compile(r"^// == (\w+):(.*)$", re.MULTILINE)


@lru_cache(maxsize=1)
def math_sections() -> Dict[str, Tuple[Tuple[str, ...], str]]:
    """``csrc/user_math.cuh`` by section: name -> (the sections it calls,
    its text), in the file's order."""
    text = MATH_SOURCE.read_text()
    heads = list(_SECTION.finditer(text))
    out = {}
    for i, m in enumerate(heads):
        end = heads[i + 1].start() if i + 1 < len(heads) else len(text)
        out[m.group(1)] = (tuple(m.group(2).split()), text[m.end() + 1:end].strip() + "\n")
    return out


def math_text(names: Sequence[str]) -> str:
    """The sections ``names`` and those they call, in the file's order, each
    under an include guard of its own (a user operator header and a plant's
    may both hold one); ``""`` for none."""
    sections = math_sections()
    need, todo = set(), list(names)
    while todo:
        name = todo.pop()
        if name not in need:
            need.add(name)
            todo += sections[name][0]
    parts = []
    for name, (_, body) in sections.items():
        if name in need:
            guard = f"MTGP_USER_MATH_{name.upper()}"
            parts.append(f"#ifndef {guard}\n#define {guard}\n{body}#endif\n")
    return "\n".join(parts)


def header(ops: Sequence[UserOp]) -> str:
    """The generated header of ``ops`` (user op k: device op id
    ``USER_FROM + k``): code only, no names, so that the same code gives the
    same text."""
    helpers = math_text([h for op in ops for h in op.helpers])
    parts = [_PRELUDE + (helpers + "\n" if helpers else ""), f"constexpr int kCount = {len(ops)};", ""]
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
