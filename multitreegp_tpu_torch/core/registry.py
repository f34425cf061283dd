"""Opcode registry: operators keyed by name, variables, per-tree variable masks.

Same opcode numbering as the JAX package (``multitreegp_tpu/core/
registry.py``): 0 = EMPTY, 1 = CONST, then operators in ``operator_list``
order (duplicate names merged, first wins), then variables in first-appearance
order across layers.

Design change from the JAX registry: there, operators are Python callables
that Pallas traces into the kernels. A CUDA kernel cannot take a callable, so
here an operator is known by its NAME, and every name the kernels implement
has a fixed device op id in :data:`DEVICE_OPS`: ``+ - * / sin cos``, and
``exp log sqrt tanh tan abs neg square pow max min`` with jnp's semantics
(nothing is protected: ``log`` and ``sqrt`` of a negative number are NaN,
``log(0)`` is ``-inf``, ``pow`` of a negative base to a non-integral power is
NaN, ``max``/``min`` propagate NaN). Every tree kernel receives an
``opcode - OP_START -> device op id`` table (:meth:`FunctionSet.device_ops`).
The default build of the kernels knows ``+ - * / sin cos`` only, so those
sets run exactly the code they always ran, and a function set with any later
operator (:attr:`FunctionSet.extended`) loads the extended build (``csrc``
compiled with ``MTGP_EXT_OPS``). A torch callable outside the
table (a user's callable under another name, or under a table name but
computing something else, as a protected ``log``: :func:`table_agrees`) is
traced into generated device code (:mod:`.user_ops`) and takes device op id
``USER_FROM + k``, the k-th such operator of the set; a set with any of them
loads the third build of each tree source (``_build.user_variant``), keyed
by the hash of its generated header. A callable the emitter refuses runs on
the CPU only, through its torch function; every CUDA kernel given such a
function set raises with the reason, and never falls back to the plain
version.
"""
from __future__ import annotations

from dataclasses import dataclass, field
from functools import cache, cached_property, lru_cache
from typing import Callable, Dict, Optional, Sequence, Tuple

import torch

import torch.nn.functional as F

from .. import _build
from . import user_ops
from .trees import CONST, EMPTY, OP_START

# Operators the port knows by name: arity and torch function (x, y) -> value
# (unary ones ignore y). This is what the plain versions run.
OPERATORS: Dict[str, Tuple[int, Callable]] = {
    "+": (2, lambda x, y: x + y),
    "-": (2, lambda x, y: x - y),
    "*": (2, lambda x, y: x * y),
    "/": (2, lambda x, y: x / y),
    "sin": (1, lambda x, y: torch.sin(x)),
    "cos": (1, lambda x, y: torch.cos(x)),
    "exp": (1, lambda x, y: torch.exp(x)),
    "log": (1, lambda x, y: torch.log(x)),
    "sqrt": (1, lambda x, y: torch.sqrt(x)),
    "tanh": (1, lambda x, y: torch.tanh(x)),
    "tan": (1, lambda x, y: torch.tan(x)),
    "abs": (1, lambda x, y: torch.abs(x)),
    "neg": (1, lambda x, y: torch.neg(x)),
    "square": (1, lambda x, y: torch.square(x)),
    "pow": (2, lambda x, y: torch.pow(x, y)),
    "max": (2, lambda x, y: torch.maximum(x, y)),
    "min": (2, lambda x, y: torch.minimum(x, y)),
}
# Device op ids: the operators of csrc/tree_eval.cuh (kAdd .. kMin), which
# every tree-evaluating kernel shares; ids 4-13 are unary. The ids from
# EXTENDED_FROM on exist only in the kernels' extended build. A function set
# with an operator outside this table runs on the CPU only.
DEVICE_OPS: Dict[str, int] = {
    "+": 0, "-": 1, "*": 2, "/": 3, "sin": 4, "cos": 5,
    "exp": 6, "log": 7, "sqrt": 8, "tanh": 9, "tan": 10, "abs": 11, "neg": 12, "square": 13,
    "pow": 14, "max": 15, "min": 16,
}
EXTENDED_FROM = DEVICE_OPS["exp"]  # the first device op id of the extended build
USER_FROM = user_ops.USER_FROM  # the first user operator's device op id
UNKNOWN_DEVICE_OP = -1
# the largest device op id of the tree kernels' fixed instances, whose
# decoded rows keep it in 6 bits (csrc/tree_prog.cuh, interpreter.cu); a set
# with a larger one runs the wide instances, whose rows hold 29 or 30 bits
FIXED_MAX_OP = 63


@cache
def device_table(values: Tuple, dtype: torch.dtype, device: torch.device) -> torch.Tensor:
    """``torch.tensor(values, dtype)`` on ``device``, made once per (values,
    dtype, device): the kernels' small constant tables, so that a launch
    copies nothing from the host. Kept for the process (a captured CUDA graph
    reads them at their addresses), and never made during a capture. Shared:
    never write to it."""
    _build.refuse_in_capture("a kernel table copied from the host")
    return torch.tensor(values, dtype=dtype, device=device)


# The values at which a given callable is held against the table's function
# (every pair of them for a binary operator): signs, zero, values past the
# poles and branch points of the table's operators, and the non-finite ones.
PROBE_VALUES = (-3.0, -2.0, -1.5, -1.0, -0.75, -0.5, -0.25, 0.0, 0.25, 0.5, 0.75, 1.0, 1.5, 2.0, 3.0,
                float("inf"), float("-inf"), float("nan"))


def table_agrees(name: str, fn: Callable) -> bool:
    """Whether ``fn`` (``fn(x)`` for a unary operator, ``fn(x, y)`` for a
    binary one) computes the table's operator ``name`` on
    :data:`PROBE_VALUES`: equal within 1e-6 relative, with the same NaNs and
    infinities. ``fn`` is called on float32 torch tensors, or on numpy
    arrays when it refuses those (a jnp callable). Raises ``ValueError`` for
    a callable that disagrees and returns no torch tensor: it could not run
    in the port at all. Cached per ``(name, fn)`` where ``fn`` hashes."""
    if getattr(fn, "__hash__", None) is None:
        return _table_agrees(name, fn)
    return _table_agrees_cached(name, fn)


def _table_agrees(name: str, fn: Callable) -> bool:
    arity, table_fn = OPERATORS[name]
    v = torch.tensor(PROBE_VALUES, dtype=torch.float32)
    x, y = (v.repeat_interleave(len(v)), v.repeat(len(v))) if arity == 2 else (v, v)
    args = (x,) if arity == 1 else (x, y)
    try:
        got = fn(*args)
    except Exception:  # noqa: BLE001 - a callable that takes arrays, not tensors
        import numpy as np

        try:
            with np.errstate(all="ignore"):  # a protected operator's unselected branch
                got = np.array(fn(*(a.numpy() for a in args)), dtype=np.float32)
        except Exception as exc:  # noqa: BLE001
            raise ValueError(f"operator {name!r}: the given function could not be evaluated "
                             f"on float32 tensors or arrays: {exc}") from exc
    is_torch = isinstance(got, torch.Tensor)
    got = torch.as_tensor(got, dtype=torch.float32).broadcast_to(x.shape)
    agrees = bool(torch.isclose(got, table_fn(x, y), rtol=1e-6, atol=0.0, equal_nan=True).all())
    if not agrees and not is_torch:
        raise ValueError(f"operator {name!r}: the given function differs from the table's "
                         f"({name} as torch computes it) and is not a torch function, so it "
                         f"cannot run in this package")
    return agrees


_table_agrees_cached = lru_cache(maxsize=256)(_table_agrees)


@dataclass(frozen=True)
class FunctionSet:
    """Immutable opcode registry shared by all tree machinery.

    Attributes:
        operator_names: operator names, opcode ``OP_START + k``.
        operator_fns: torch functions ``(x, y) -> value`` (unary ones ignore y).
        arities: operator arities (1 or 2).
        operator_probs: unnormalised sampling probabilities.
        device_op_ids: device op id per operator: the table's, ``USER_FROM +
            k`` for the k-th traced user operator, ``-1`` for a refused one.
        variable_names: flat variable names, opcode ``var_start + v``.
        variable_mask: float32 ``(num_trees, num_variables)`` per-tree leaf
            weights (1 where the tree's layer may use the variable).
        layer_sizes: trees per layer.
        user_header: the generated header of the traced user operators
            (``""`` without any).
        refusals: ``(name, reason)`` of each operator without a device op.
    """

    operator_names: Tuple[str, ...]
    operator_fns: Tuple[Callable, ...] = field(repr=False)
    arities: Tuple[int, ...]
    operator_probs: Tuple[float, ...]
    device_op_ids: Tuple[int, ...]
    variable_names: Tuple[str, ...]
    variable_mask: torch.Tensor = field(repr=False)
    layer_sizes: Tuple[int, ...]
    string_to_op: Dict[str, int] = field(repr=False)
    op_to_string: Dict[int, str] = field(repr=False)
    user_header: str = field(default="", repr=False)
    refusals: Tuple[Tuple[str, str], ...] = ()

    @property
    def num_operators(self) -> int:
        return len(self.operator_names)

    @property
    def num_variables(self) -> int:
        return len(self.variable_names)

    @property
    def var_start(self) -> int:
        return OP_START + self.num_operators

    @property
    def num_opcodes(self) -> int:
        return self.var_start + self.num_variables

    @property
    def num_trees(self) -> int:
        return int(sum(self.layer_sizes))

    def operator_indices(self, device=None) -> torch.Tensor:
        """int64 opcodes of the operators, ``OP_START .. var_start - 1``, on
        ``device``."""
        return torch.arange(OP_START, self.var_start, device=device)

    def variable_indices(self, device=None) -> torch.Tensor:
        """int64 opcodes of the variables, ``var_start .. num_opcodes - 1``,
        on ``device``."""
        return torch.arange(self.var_start, self.num_opcodes, device=device)

    @property
    def data_layout(self) -> Tuple[str, ...]:
        """The order in which the interpreter's flat data vector is packed:
        the variable names, data slot ``v`` for opcode ``var_start + v``."""
        return self.variable_names

    @property
    def has_unary(self) -> bool:
        """Whether any operator is unary: the tree kernels pick their
        instance without the unary rows' code otherwise."""
        return any(a == 1 for a in self.arities)

    @property
    def extended(self) -> bool:
        """Whether any operator lies past ``+ - * / sin cos`` (a user
        operator too): the tree kernels then run a build other than the
        default one (:attr:`variant`)."""
        return any(i >= EXTENDED_FROM for i in self.device_op_ids)

    @property
    def max_device_op(self) -> int:
        """The largest device op id of the set (the fixed instances of the
        tree kernels take at most :data:`FIXED_MAX_OP`)."""
        return max(self.device_op_ids)

    @property
    def user_count(self) -> int:
        """User operators of the set: its header's ``kCount``."""
        return sum(i >= USER_FROM for i in self.device_op_ids)

    @cached_property
    def user_hash(self) -> str:
        """sha256 of :attr:`user_header` (``""`` without user operators): two
        sets with the same device op ids may differ in their user code."""
        return _build.header_hash(self.user_header) if self.user_header else ""

    @cached_property
    def variant(self) -> "_build.Variant":
        """The build of the tree kernels this set runs: the user build of its
        generated header where it has user operators, else the extended
        build where it has an operator past ``+ - * / sin cos``, else the
        default one (``_build.load(name, fset.variant)``)."""
        if self.user_header:
            return _build.user_variant(self.user_header)
        return _build.EXTENDED if self.extended else _build.DEFAULT

    def slots(self, device=None) -> torch.Tensor:
        """int32 arity per opcode: 0 for EMPTY/CONST/variables (cached per
        device)."""
        table = (0, 0) + tuple(self.arities) + (0,) * self.num_variables
        return device_table(table, torch.int32, torch.device(device or "cpu"))

    def probs(self, device=None) -> torch.Tensor:
        """float32 operator sampling weights (cached per device)."""
        return device_table(self.operator_probs, torch.float32, torch.device(device or "cpu"))

    def variable_mask_on(self, device=None) -> torch.Tensor:
        """:attr:`variable_mask` on ``device`` (cached per device)."""
        return device_table(self._mask_rows, torch.float32, torch.device(device or "cpu"))

    @cached_property
    def _mask_rows(self) -> Tuple[Tuple[float, ...], ...]:
        return tuple(tuple(r) for r in self.variable_mask.tolist())

    def device_ops(self, device=None) -> torch.Tensor:
        """int32 device op id per operator (``opcode - OP_START``), cached per
        device (:func:`device_table`)."""
        return device_table(self.device_op_ids, torch.int32, torch.device(device or "cpu"))

    def require_device_ops(self) -> None:
        """Raise ``NotImplementedError`` unless every operator has a device op
        id (the CUDA kernels' precondition), naming each refused operator and
        why the emitter refused it."""
        if self.refusals:
            why = "; ".join(f"{name!r}: {reason}" for name, reason in self.refusals)
            raise NotImplementedError(
                f"operators without a device implementation ({why}); the CUDA kernels "
                f"implement {sorted(DEVICE_OPS)} and torch callables that trace to the "
                f"aten ops of core/user_ops.py")


def build_function_set(
    operator_list: Sequence[Tuple],
    variable_list: Sequence[Sequence[str]],
    layer_sizes: Sequence[int],
) -> FunctionSet:
    """Build a :class:`FunctionSet` from reference-style lists.

    ``operator_list`` entries are ``(name, fn, arity[, probability])`` as in the
    JAX package, or ``(name, arity[, probability])``. A name in
    :data:`OPERATORS` without ``fn`` takes the table's torch function and its
    device op id. With ``fn`` (a torch or a jnp callable) the function is
    first evaluated on :data:`PROBE_VALUES` (:func:`table_agrees`): where it
    agrees with the table's, the table's function and device op id are used;
    a torch callable that does not (a protected ``log``, say) is kept as
    given, like any name outside the table; any other callable that does not
    agree raises ``ValueError``, since it cannot run on torch tensors. Other
    names need a torch callable ``fn``. Such a kept callable is traced
    (:func:`.user_ops.compile_op`): the k-th one that the emitter takes has
    device op id ``USER_FROM + k``, whatever the set's size (past
    :data:`FIXED_MAX_OP` the tree kernels run their wide instances), a
    refused one none (it runs on the CPU only, and
    :meth:`FunctionSet.require_device_ops` gives the reason).
    """
    layer_sizes = tuple(int(s) for s in layer_sizes)
    if len(layer_sizes) != len(variable_list):
        raise ValueError(
            "variable_list must have one entry per layer "
            f"(got {len(variable_list)} for {len(layer_sizes)} layers)"
        )
    if not operator_list:
        raise ValueError("operator_list must not be empty")

    names, fns, arities, probs, dev_ids = [], [], [], [], []
    traced, refusals = [], []
    string_to_op: Dict[str, int] = {}
    for entry in operator_list:
        name = entry[0]
        fn: Optional[Callable] = None
        rest = list(entry[1:])
        if rest and callable(rest[0]):
            fn = rest.pop(0)
        arity = int(rest[0])
        prob = float(rest[1]) if len(rest) > 1 else 1.0
        if arity not in (1, 2):
            raise ValueError(f"operator {name!r}: arity must be 1 or 2, got {arity}")
        if name in string_to_op:
            continue
        dev_id = UNKNOWN_DEVICE_OP
        if name in OPERATORS and OPERATORS[name][0] != arity:
            raise ValueError(f"operator {name!r} has arity {OPERATORS[name][0]}, got {arity}")
        if name in OPERATORS and (fn is None or table_agrees(name, fn)):
            fn, dev_id = OPERATORS[name][1], DEVICE_OPS[name]
        elif fn is None:
            raise ValueError(f"operator {name!r} is not in OPERATORS and has no function")
        else:
            if arity == 1:
                fn = (lambda f: (lambda x, y: f(x)))(fn)
            dev_id, reason = _user_device_op(name, fn, arity, traced)
            if reason is not None:
                refusals.append((name, reason))
        string_to_op[name] = OP_START + len(names)
        names.append(name)
        fns.append(fn)
        arities.append(arity)
        probs.append(prob)
        dev_ids.append(dev_id)

    var_start = OP_START + len(names)
    variable_names = []
    for layer_vars in variable_list:
        if not layer_vars:
            raise ValueError("every layer needs a non-empty variable list")
        for var in layer_vars:
            if var not in string_to_op:
                string_to_op[var] = var_start + len(variable_names)
                variable_names.append(var)

    mask = torch.zeros((sum(layer_sizes), len(variable_names)), dtype=torch.float32)
    row = 0
    for layer_i, layer_vars in enumerate(variable_list):
        for _ in range(layer_sizes[layer_i]):
            for var in layer_vars:
                mask[row, string_to_op[var] - var_start] = 1.0
            row += 1

    op_to_string = {v: k for k, v in string_to_op.items()}
    op_to_string[EMPTY] = "<empty>"
    op_to_string[CONST] = "<const>"
    return FunctionSet(
        operator_names=tuple(names),
        operator_fns=tuple(fns),
        arities=tuple(arities),
        operator_probs=tuple(probs),
        device_op_ids=tuple(dev_ids),
        variable_names=tuple(variable_names),
        variable_mask=mask,
        layer_sizes=layer_sizes,
        string_to_op=string_to_op,
        op_to_string=op_to_string,
        user_header=user_ops.header(traced) if traced else "",
        refusals=tuple(refusals),
    )


def _user_device_op(name: str, fn: Callable, arity: int, traced: list):
    """``(device op id, None)`` for a callable the emitter takes (appended to
    ``traced``), ``(UNKNOWN_DEVICE_OP, reason)`` for one it refuses."""
    try:
        traced.append(user_ops.compile_op(name, fn, arity))
    except user_ops.Refused as exc:
        return UNKNOWN_DEVICE_OP, str(exc)
    return USER_FROM + len(traced) - 1, None


def default_sr_operators():
    """The SymbolicRegression notebook's arithmetic set (reference
    ``examples/SymbolicRegression.ipynb`` cell 6): ``+ - * /`` sampled with
    probabilities 0.5, 0.1, 0.5, 0.1, in the ``(name, fn, arity, prob)``
    form of :func:`build_function_set`."""
    return [
        ("+", torch.add, 2, 0.5),
        ("-", torch.subtract, 2, 0.1),
        ("*", torch.multiply, 2, 0.5),
        ("/", torch.divide, 2, 0.1),
    ]


def protected_division(x, y):
    """gplearn's ``_protected_division``: ``x / y`` where ``|y| > 0.001``, else 1."""
    return torch.where(torch.abs(y) > 0.001, x / y, 1.0)


def protected_log(x):
    """gplearn's ``_protected_log``: ``log|x|`` where ``|x| > 0.001``, else 0."""
    return torch.where(torch.abs(x) > 0.001, torch.log(torch.abs(x)), 0.0)


def protected_sqrt(x):
    """gplearn's ``_protected_sqrt``: ``sqrt|x|``."""
    return torch.sqrt(torch.abs(x))


def protected_inverse(x):
    """gplearn's ``_protected_inverse``: ``1 / x`` where ``|x| > 0.001``, else 0."""
    return torch.where(torch.abs(x) > 0.001, 1.0 / x, 0.0)


def sigmoid(x):
    """gplearn's ``_sigmoid``: ``1 / (1 + exp(-x))``."""
    return 1 / (1 + torch.exp(-x))


def gplearn_operators():
    """``+ - *`` and gplearn's protected operators (``gplearn/functions.py``)
    as torch callables under the names ``/``, ``log``, ``sqrt``, ``inv`` and
    ``sig``, with the SymbolicRegression notebook's probabilities for ``+ -
    * /`` and 0.1 for the rest. ``/``, ``log`` and ``sqrt`` are table names
    whose table functions these callables are not: with ``inv`` and ``sig``
    they become user operators (:mod:`.user_ops`)."""
    return [
        ("+", torch.add, 2, 0.5),
        ("-", torch.subtract, 2, 0.1),
        ("*", torch.multiply, 2, 0.5),
        ("/", protected_division, 2, 0.1),
        ("log", protected_log, 1, 0.1),
        ("sqrt", protected_sqrt, 1, 0.1),
        ("inv", protected_inverse, 1, 0.1),
        ("sig", sigmoid, 1, 0.1),
    ]


def clamped_exp(x):
    """``exp(clamp(x, max=10))``: an exponential protected against overflow."""
    return torch.exp(torch.clamp(x, max=10.0))


def pysr_operators():
    """``+ - * /`` and PySR-style operators (the "Operators" page of the
    PySR docs) as torch callables: ``sigmoid``, ``atan``, ``log1p``,
    ``expm1``, a square root written ``x ** 0.5``, ``maximum`` and an
    exponential protected by a clamp, with the SymbolicRegression notebook's
    probabilities for ``+ - * /`` and 0.1 for the rest. Their names are not
    table names, so each is a user operator (:mod:`.user_ops`)."""
    return default_sr_operators() + [
        ("sigmoid", torch.sigmoid, 1, 0.1),
        ("atan", torch.atan, 1, 0.1),
        ("log1p", torch.log1p, 1, 0.1),
        ("expm1", torch.expm1, 1, 0.1),
        ("sqrt_pow", lambda x: x ** 0.5, 1, 0.1),
        ("maximum", torch.maximum, 2, 0.1),
        ("exp_clamped", clamped_exp, 1, 0.1),
    ]


def vocabulary_operators():
    """``(unary set, binary set)``: one callable for each aten op that the
    emitter compiles past ``+ - * /``, the comparisons and ``where``, each
    traced into generated code with its VJP, in the ``(name, fn, arity)``
    form of :func:`build_function_set`; two sets of at most 32 operators
    (the interpreter's fixed instances), for sweeping every op on the card."""
    unary = [
        ("sigmoid", torch.sigmoid), ("erf", torch.erf), ("erfc", torch.erfc), ("relu", torch.relu),
        ("atan", torch.atan), ("asin", torch.asin), ("acos", torch.acos), ("asinh", torch.asinh),
        ("acosh", torch.acosh), ("atanh", torch.atanh), ("sinh", torch.sinh), ("cosh", torch.cosh),
        ("log1p", torch.log1p), ("log2", torch.log2), ("log10", torch.log10), ("expm1", torch.expm1),
        ("exp2", torch.exp2), ("rsqrt", torch.rsqrt), ("floor", torch.floor), ("ceil", torch.ceil),
        ("round", torch.round), ("trunc", torch.trunc),
        ("clamp", lambda x: torch.clamp(x, -1.5, 2.0)), ("exp_clamped", clamped_exp),
        ("clamp_min", lambda x: torch.clamp(x, min=0.5)), ("sqrt_pow", lambda x: x ** 0.5),
        ("rsqrt_pow", lambda x: x ** -0.5), ("inv_pow", lambda x: x ** -1),
        ("inv_square", lambda x: x ** -2), ("pow4", lambda x: x ** 4), ("pow1_5", lambda x: x ** 1.5)]
    binary = [
        ("maximum", torch.maximum, 2), ("minimum", torch.minimum, 2), ("pow_tensor", torch.pow, 2),
        ("atan2", torch.atan2, 2), ("hypot", torch.hypot, 2), ("fmod", torch.fmod, 2),
        ("remainder", torch.remainder, 2), ("greater", lambda x, y: (x > y).float(), 2),
        ("logical_or", lambda x, y: ((x > 0) | (y > 0)).float(), 2),
        ("logical_and", lambda x, y: ((x > 0) & (y > 0)).float(), 2),
        ("mul_inplace", lambda x, y: x.clone().mul_(y), 2),
        ("div_floor", lambda x, y: torch.div(x, y, rounding_mode="floor"), 2),
        ("div_trunc", lambda x, y: torch.div(x, y, rounding_mode="trunc"), 2),
        # PySR's atanh_clip: atanh(mod(x + 1, 2) - 1)
        ("atanh_clip", lambda x: torch.atanh(torch.remainder(x + 1.0, 2.0) - 1.0), 1),
        ("fmod_scalar", lambda x: torch.fmod(x, 1.5), 1),
        ("remainder_scalar", lambda x: torch.remainder(x, -1.5), 1)]
    return [(name, fn, 1) for name, fn in unary], binary


def special_operators():
    """``(unary set a, unary set b, binary set)``: one callable for each aten
    form the emitter compiles past :func:`vocabulary_operators` (a power of
    a scalar base, clamps by tensors, rounded division by a scalar, rounding
    to decimals, a 0-d tensor constant, the special functions, the
    activations, ``logaddexp``, ``copysign``, ``fmax``/``fmin``, ``frac``,
    ``deg2rad``, ``nan_to_num``, ``ldexp``), each traced into generated code
    with its VJP, in the ``(name, fn, arity)`` form of
    :func:`build_function_set`; sets of at most 32 operators (the
    interpreter's fixed instances), for sweeping every op on the card."""
    unary = [
        ("pow_base", lambda x: 2.0 ** x), ("div_floor_scalar", lambda x: torch.div(x, 1.5, rounding_mode="floor")),
        ("div_trunc_scalar", lambda x: torch.div(x, 1.5, rounding_mode="trunc")),
        ("round_decimals", lambda x: torch.round(x, decimals=2)), ("tensor_constant", lambda x: x / torch.tensor(3.0)),
        ("lgamma", torch.lgamma), ("digamma", torch.digamma), ("trigamma", lambda x: torch.polygamma(1, x)),
        ("polygamma2", lambda x: torch.polygamma(2, x)), ("i0", torch.special.i0), ("i0e", torch.special.i0e),
        ("i1", torch.special.i1), ("i1e", torch.special.i1e), ("erfcx", torch.special.erfcx),
        ("erfinv", torch.erfinv), ("ndtri", torch.special.ndtri), ("log_ndtr", torch.special.log_ndtr),
        ("entr", torch.special.entr), ("logit", torch.logit),
        ("sinc", torch.sinc), ("softplus", F.softplus), ("gelu", F.gelu),
        ("gelu_tanh", lambda x: F.gelu(x, approximate="tanh")), ("silu", F.silu), ("mish", F.mish),
        ("elu", F.elu), ("selu", F.selu), ("celu", lambda x: F.celu(x, 1.5)), ("leaky_relu", F.leaky_relu),
        ("hardtanh", F.hardtanh), ("hardswish", F.hardswish), ("hardsigmoid", F.hardsigmoid),
        ("logsigmoid", F.logsigmoid), ("softshrink", F.softshrink), ("frac", torch.frac),
        ("deg2rad", torch.deg2rad), ("rad2deg", torch.rad2deg), ("nan_to_num", torch.nan_to_num)]
    binary = [
        # a torque clip: bounds by tensors
        ("clamp_tensor", lambda x, y: torch.clamp(x, -torch.abs(y), torch.abs(y))),
        ("clamp_min_tensor", lambda x, y: torch.clamp(x, min=y)),
        ("clamp_max_tensor", lambda x, y: torch.clamp(x, max=y)), ("xlogy", torch.special.xlogy),
        ("xlog1py", torch.special.xlog1py), ("logaddexp", torch.logaddexp), ("logaddexp2", torch.logaddexp2),
        ("copysign", torch.copysign), ("fmax", torch.fmax), ("fmin", torch.fmin), ("ldexp", torch.ldexp)]
    half = (len(unary) + 1) // 2
    return ([(n, f, 1) for n, f in unary[:half]], [(n, f, 1) for n, f in unary[half:]],
            [(n, f, 2) for n, f in binary])


def whole_vocabulary():
    """Every callable of :func:`vocabulary_operators` and
    :func:`special_operators` in one list: a set of them has user device op
    ids past ``FIXED_MAX_OP``, which the tree kernels run in their wide
    instances."""
    unary, binary = vocabulary_operators()
    return unary + binary + [op for ops in special_operators() for op in ops]
