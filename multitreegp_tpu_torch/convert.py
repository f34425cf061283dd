"""Carry trees, function sets, SR and control data over from the JAX package.

Everything crosses as numpy arrays (or objects read attribute by attribute),
so this module never imports ``multitreegp_tpu`` or JAX: the caller hands in
``np.asarray(...)`` of the JAX side's arrays.
"""
from __future__ import annotations

from typing import Callable, Dict, Optional, Tuple

import numpy as np
import torch

from .core.registry import OPERATORS, PROBE_VALUES, FunctionSet, build_function_set, table_agrees
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


def function_set_from_jax(fset, torch_fns: Optional[Dict[str, Callable]] = None) -> FunctionSet:
    """The port's :class:`FunctionSet` equal to a JAX ``FunctionSet``: same
    operator names (hence opcodes), arities, probabilities, variable names,
    per-tree variable mask and layer sizes. ``fset`` is read by attribute; its
    arrays are converted with ``np.asarray``. Each operator's callable is held
    against the port's table (:func:`~.core.registry.table_agrees`). One
    outside the table, or one that computes something else under a table
    name (a protected ``log``), takes its torch counterpart from
    ``torch_fns`` (name -> ``fn(x)`` or ``fn(x, y)``), which must compute
    what the ``jnp`` callable does on :data:`~.core.registry.PROBE_VALUES`
    (within 1e-6 relative, the same NaNs and infinities); a missing or a
    differing counterpart raises ``ValueError``. The ``jnp`` callables are
    called on numpy arrays only."""
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
        a, p = int(a), float(p)
        one = (lambda x, f=fn: f(x, x)) if a == 1 else fn  # JAX's take (x, y), unary ones ignoring y
        if name in OPERATORS and _in_table(name, one):
            ops.append((name, one, a, p))
            continue
        counterpart = (torch_fns or {}).get(name)
        if counterpart is None:
            raise ValueError(f"operator {name!r} is not the port's table operator of that name: "
                             f"give its torch counterpart in torch_fns")
        if not _same_on_probes(fn, counterpart, a):
            raise ValueError(f"operator {name!r}: the torch counterpart differs from the jnp "
                             f"callable on the probe values")
        ops.append((name, counterpart, a, p))
    out = build_function_set(ops, variable_list, fset.layer_sizes)
    if out.variable_names != tuple(names) or not np.array_equal(out.variable_mask.numpy(), mask):
        raise ValueError("variable order or mask does not round-trip")
    return out


def _in_table(name: str, fn: Callable) -> bool:
    """Whether the jnp callable ``fn`` computes the table's ``name``."""
    try:
        return table_agrees(name, fn)
    except ValueError:  # it differs, and is not a torch function
        return False


def _same_on_probes(jnp_fn: Callable, torch_fn: Callable, arity: int) -> bool:
    """Whether ``torch_fn`` (``fn(x)`` or ``fn(x, y)`` on float32 tensors)
    computes what the JAX ``jnp_fn(x, y)`` does (on numpy arrays) on every
    probe value (every pair for a binary operator): within 1e-6 relative,
    with the same NaNs and infinities."""
    v = np.asarray(PROBE_VALUES, np.float32)
    x, y = (np.repeat(v, len(v)), np.tile(v, len(v))) if arity == 2 else (v, v)
    with np.errstate(all="ignore"):  # a protected operator's unselected branch
        want = np.array(np.broadcast_to(np.asarray(jnp_fn(x, y), np.float32), x.shape))
    want = torch.from_numpy(want)
    args = (torch.from_numpy(x),) if arity == 1 else (torch.from_numpy(x), torch.from_numpy(y))
    got = torch.as_tensor(torch_fn(*args), dtype=torch.float32).broadcast_to(want.shape)
    return bool(torch.isclose(got, want, rtol=1e-6, atol=0.0, equal_nan=True).all())


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
