"""Carry trees, function sets, SR and control data over from the JAX package.

Everything crosses as numpy arrays (or objects read attribute by attribute),
so this module never imports ``multitreegp_tpu`` or JAX: the caller hands in
``np.asarray(...)`` of the JAX side's arrays.
"""
from __future__ import annotations

from typing import Tuple

import numpy as np
import torch

from .core.registry import OPERATORS, FunctionSet, build_function_set
from .core.trees import TreeTensors


def trees_from_numpy(ops, c1, c2, const, device=None) -> TreeTensors:
    """``TreeTensors`` from four arrays of equal shape ``(..., N)``."""
    return TreeTensors(
        torch.tensor(np.asarray(ops, np.int32), device=device),
        torch.tensor(np.asarray(c1, np.int32), device=device),
        torch.tensor(np.asarray(c2, np.int32), device=device),
        torch.tensor(np.asarray(const, np.float32), device=device),
    )


def trees_to_numpy(trees: TreeTensors) -> Tuple[np.ndarray, np.ndarray, np.ndarray, np.ndarray]:
    """``(ops, c1, c2, const)`` as host numpy arrays."""
    return tuple(t.detach().cpu().numpy() for t in trees)  # type: ignore[return-value]


def function_set_from_jax(fset) -> FunctionSet:
    """The port's :class:`FunctionSet` equal to a JAX ``FunctionSet``: same
    operator names (hence opcodes), arities, probabilities, variable names,
    per-tree variable mask and layer sizes. ``fset`` is read by attribute; its
    arrays are converted with ``np.asarray``. Each operator's callable is held
    against the port's table (:func:`~.core.registry.table_agrees`): one
    that computes something else under a table name (a protected ``log``)
    raises ``ValueError``, as a name outside the table does."""
    arities = np.asarray(fset.arities).tolist()
    probs = np.asarray(fset.operator_probs, np.float32).tolist()
    mask = np.asarray(fset.variable_mask)
    names = list(fset.variable_names)
    variable_list, row = [], 0
    for size in fset.layer_sizes:
        variable_list.append([names[v] for v in np.flatnonzero(mask[row] > 0)])
        row += size
    ops = []
    for name, fn, a, p in zip(fset.operator_names, fset.operator_fns, arities, probs):
        if name in OPERATORS:  # the JAX callables take (x, y), unary ones ignoring y
            ops.append((name, (lambda x, f=fn: f(x, x)) if a == 1 else fn, int(a), float(p)))
        else:
            ops.append((name, int(a), float(p)))
    out = build_function_set(ops, variable_list, fset.layer_sizes)
    if out.variable_names != tuple(names) or not np.array_equal(out.variable_mask.numpy(), mask):
        raise ValueError("variable order or mask does not round-trip")
    return out


def sr_data_from_numpy(x0s, ts, ys, keys=None, device=None) -> Tuple:
    """SR data tuple ``(x0s (B, d), ts (T,), ys (B, T, d), keys (B, 2) or
    None)``: float32 arrays, and the JAX package's raw process-noise keys as
    int64."""
    as_f32 = lambda a: torch.tensor(np.asarray(a, np.float32), device=device)
    as_key = None if keys is None else torch.tensor(np.asarray(keys).astype(np.int64), device=device)
    return as_f32(x0s), as_f32(ts), as_f32(ys), as_key


def control_data_from_numpy(x0, ts, targets, process_noise_keys, obs_noise_keys, params,
                            device=None) -> Tuple:
    """Control data tuple ``(x0 (B, latent), ts (T,), targets (B, n_targets),
    process_noise_keys (B, 2), obs_noise_keys (B, 2), params)`` from the JAX
    package's ``generate_control_data``: float32 arrays, the raw keys as
    int64, and the parameters (one array or a tuple) as a tuple of float32
    tensors."""
    as_f32 = lambda a: torch.tensor(np.asarray(a, np.float32), device=device)
    as_key = lambda a: torch.tensor(np.asarray(a).astype(np.int64), device=device)
    leaves = params if isinstance(params, (tuple, list)) else (params,)
    return (as_f32(x0), as_f32(ts), as_f32(targets), as_key(process_noise_keys),
            as_key(obs_noise_keys), tuple(as_f32(p) for p in leaves))
