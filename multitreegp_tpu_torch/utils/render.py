"""Host-side expression rendering (port of ``multitreegp_tpu/utils/render.py``):
tree tensors to infix strings, simplified with sympy when it is installed."""
from __future__ import annotations

from typing import Optional

from ..core.registry import FunctionSet
from ..core.trees import CONST, EMPTY, TreeTensors


def tree_to_string(tree: TreeTensors, fset: FunctionSet, root: Optional[int] = None) -> str:
    """Render one tree (batch shape ``()``) as an infix expression, from row
    ``root`` (the tree's root, row ``N - 1``, when None)."""
    ops, c1, c2, const = (t.detach().cpu().tolist() for t in tree)

    def rec(i: int) -> str:
        op = ops[i]
        if op == CONST:
            return "{:.2f}".format(const[i])
        if op == EMPTY:
            return "0"
        name = fset.op_to_string.get(op, f"<op{op}>")
        if c1[i] < 0:  # variable
            return name
        if c2[i] < 0:  # unary operator
            return f"{name}({rec(c1[i])})"
        return f"({rec(c1[i])}){name}({rec(c2[i])})"

    return rec(tree.max_nodes - 1 if root is None else root)


def _simplify(expr: str) -> str:
    try:
        import sympy
        from sympy.parsing.sympy_parser import parse_expr
    except ImportError:  # sympy is optional
        return expr
    try:
        return str(parse_expr(expr))
    except (SyntaxError, TypeError, ValueError, sympy.SympifyError):
        return expr


def candidate_to_string(candidate: TreeTensors, fset: FunctionSet, simplify: bool = True) -> str:
    """A candidate as layer-bracketed expression lists, e.g. ``[x1, -x0]``."""
    exprs = []
    for t in range(candidate.batch_shape[0]):
        s = tree_to_string(candidate[t], fset)
        exprs.append(_simplify(s) if simplify else s)
    out, i = [], 0
    for size in fset.layer_sizes:
        out.append("[" + ", ".join(exprs[i:i + size]) + "]")
        i += size
    return ", ".join(out)
