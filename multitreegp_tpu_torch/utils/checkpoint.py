"""Checkpoint / resume for evolution runs.

Port of ``multitreegp_tpu/utils/checkpoint.py``: the complete run state —
populations, random-generator state, generation counter, best-so-far history
— round-trips through one compressed npz file with the same fields, and
with any ``extra`` arrays (stored as ``extra_<name>``, returned under
``"extra"``). The ``torch.Generator`` state (``get_state()``, a uint8
tensor) takes the place of the JAX PRNG key under the field ``key``. The
file is written to a temporary name and moved into place with
``os.replace``, so a reader never sees a torn checkpoint.
"""
from __future__ import annotations

import os
from typing import Any, Dict, Optional

import numpy as np
import torch

from ..core.trees import TreeTensors

_FIELDS = ("ops", "c1", "c2", "const")


def save_checkpoint(
    path: str,
    populations: TreeTensors,
    generator_state: torch.Tensor,
    generation: int,
    best_fitnesses: Optional[torch.Tensor] = None,
    best_solutions: Optional[TreeTensors] = None,
    extra: Optional[Dict[str, Any]] = None,
) -> None:
    host = lambda t: t.detach().cpu().numpy()
    arrays = {name: host(t) for name, t in zip(_FIELDS, populations)}
    arrays["key"] = host(generator_state)
    arrays["generation"] = np.asarray(generation)
    if best_fitnesses is not None:
        arrays["best_fitnesses"] = host(best_fitnesses)
    if best_solutions is not None:
        for name, t in zip(_FIELDS, best_solutions):
            arrays[f"best_{name}"] = host(t)
    for k, v in (extra or {}).items():
        arrays[f"extra_{k}"] = host(v) if isinstance(v, torch.Tensor) else np.asarray(v)
    tmp = path + ".tmp"
    with open(tmp, "wb") as f:
        np.savez_compressed(f, **arrays)
    os.replace(tmp, path)  # atomic, never leaves a torn checkpoint


def load_checkpoint(path: str, device=None) -> Dict[str, Any]:
    """The saved state, tree tensors on ``device``; ``key`` is the generator
    state (a CPU uint8 tensor for ``torch.Generator.set_state``); ``extra``
    the extra arrays as numpy arrays, by name."""
    dev = lambda a: torch.from_numpy(a).to(device)
    with np.load(path) as z:
        out: Dict[str, Any] = {
            "populations": TreeTensors(*(dev(z[name]) for name in _FIELDS)),
            "key": torch.from_numpy(z["key"]),
            "generation": int(z["generation"]),
        }
        if "best_fitnesses" in z:
            out["best_fitnesses"] = dev(z["best_fitnesses"])
        if "best_ops" in z:
            out["best_solutions"] = TreeTensors(*(dev(z[f"best_{name}"]) for name in _FIELDS))
        out["extra"] = {k[len("extra_"):]: np.asarray(z[k]) for k in z.files if k.startswith("extra_")}
    return out
