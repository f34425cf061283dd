"""Opcode registry: operators keyed by name, variables, per-tree variable masks.

Same opcode numbering as the JAX package (``multitreegp_tpu/core/
registry.py``): 0 = EMPTY, 1 = CONST, then operators in ``operator_list``
order (duplicate names merged, first wins), then variables in first-appearance
order across layers.

Design change from the JAX registry: there, operators are Python callables
that Pallas traces into the kernels. A CUDA kernel cannot take a callable, so
here an operator is known by its NAME, and every name the kernels implement
has a fixed device op id in :data:`DEVICE_OPS`. The fitness kernel receives
an ``opcode - OP_START -> device op id`` table (:meth:`FunctionSet.device_ops`).
An operator outside that table still runs on the CPU (through its torch
function in :data:`OPERATORS` or a given callable); the CUDA fitness kernel
given such a function set raises.
"""
from __future__ import annotations

from dataclasses import dataclass, field
from functools import lru_cache
from typing import Callable, Dict, Optional, Sequence, Tuple

import torch

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
}
# Device op ids: the operators of csrc/tree_eval.cuh (kAdd .. kCos), which
# every tree-evaluating kernel shares; the ids from 4 on are unary. A function
# set with an operator outside this table runs on the CPU only.
DEVICE_OPS: Dict[str, int] = {"+": 0, "-": 1, "*": 2, "/": 3, "sin": 4, "cos": 5}
UNKNOWN_DEVICE_OP = -1


@lru_cache(maxsize=64)
def device_table(values: Tuple, dtype: torch.dtype, device: torch.device) -> torch.Tensor:
    """``torch.tensor(values, dtype)`` on ``device``, made once per (values,
    dtype, device): the kernels' small constant tables, so that a launch
    copies nothing from the host. Shared: never write to it."""
    return torch.tensor(values, dtype=dtype, device=device)


@dataclass(frozen=True)
class FunctionSet:
    """Immutable opcode registry shared by all tree machinery.

    Attributes:
        operator_names: operator names, opcode ``OP_START + k``.
        operator_fns: torch functions ``(x, y) -> value`` (unary ones ignore y).
        arities: operator arities (1 or 2).
        operator_probs: unnormalised sampling probabilities.
        device_op_ids: device op id per operator, ``-1`` outside the table.
        variable_names: flat variable names, opcode ``var_start + v``.
        variable_mask: float32 ``(num_trees, num_variables)`` per-tree leaf
            weights (1 where the tree's layer may use the variable).
        layer_sizes: trees per layer.
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
        rows = tuple(tuple(r) for r in self.variable_mask.tolist())
        return device_table(rows, torch.float32, torch.device(device or "cpu"))

    def device_ops(self, device=None) -> torch.Tensor:
        """int32 device op id per operator (``opcode - OP_START``), cached per
        device (:func:`device_table`)."""
        return device_table(self.device_op_ids, torch.int32, torch.device(device or "cpu"))

    def require_device_ops(self) -> None:
        """Raise unless every operator has a device op id (the CUDA kernels'
        precondition)."""
        missing = [
            n for n, i in zip(self.operator_names, self.device_op_ids)
            if i == UNKNOWN_DEVICE_OP
        ]
        if missing:
            raise NotImplementedError(
                f"operators {missing} have no device implementation; the CUDA "
                f"kernels implement {sorted(DEVICE_OPS)}"
            )


def build_function_set(
    operator_list: Sequence[Tuple],
    variable_list: Sequence[Sequence[str]],
    layer_sizes: Sequence[int],
) -> FunctionSet:
    """Build a :class:`FunctionSet` from reference-style lists.

    ``operator_list`` entries are ``(name, fn, arity[, probability])`` as in the
    JAX package, or ``(name, arity[, probability])``. A name in
    :data:`OPERATORS` uses the table's torch function (a given ``fn`` is
    ignored: JAX callables cannot run on torch tensors); other names need a
    torch callable ``fn``. Only names in :data:`DEVICE_OPS` run in the
    fitness kernel.
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
        if name in OPERATORS:
            known_arity, fn = OPERATORS[name]
            if known_arity != arity:
                raise ValueError(f"operator {name!r} has arity {known_arity}, got {arity}")
        elif fn is None:
            raise ValueError(f"operator {name!r} is not in OPERATORS and has no function")
        elif arity == 1:
            fn = (lambda f: (lambda x, y: f(x)))(fn)
        dev_id = DEVICE_OPS.get(name, UNKNOWN_DEVICE_OP)
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
    )


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
