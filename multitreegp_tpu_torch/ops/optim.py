"""Adam with optax's ``init`` / ``update`` contract, in PyTorch.

The JAX package refines constants with ``optax.adam``. This is the same
transformation, with optax's (0.2.6) update expressions in their order, so
the two agree to float32 rounding:

* ``mu = (1 - b1) * g + b1 * mu`` and ``nu = (1 - b2) * g**2 + b2 * nu``
  (``update_moment``), then the step count is incremented;
* ``mu_hat = mu / (1 - b1**count)``, ``nu_hat = nu / (1 - b2**count)``, the
  bias corrections rounded in float32 as JAX's ``pow`` gives them;
* ``u = mu_hat / (sqrt(nu_hat) + eps)`` (``eps_root = 0``), then ``u * -lr``
  (``scale_by_learning_rate``); :func:`apply_updates` adds it to the params.

``torch.optim.Adam`` orders these operations differently, so it is not used.
The bias corrections are divided as device tensors: PyTorch's CUDA division
by a Python or CPU scalar multiplies by its reciprocal instead. They are made
once per step count (``registry.device_table``), so that an update copies
nothing from the host and can be captured in a CUDA graph.
"""
from __future__ import annotations

from typing import Callable, NamedTuple, Optional, Tuple

import numpy as np
import torch

from ..core.registry import device_table


class AdamState(NamedTuple):
    count: int  # steps taken
    mu: torch.Tensor  # first moment
    nu: torch.Tensor  # second moment


class GradientTransformation(NamedTuple):
    """``init(params) -> state``; ``update(grads, state, params) -> (updates, state)``."""

    init: Callable
    update: Callable


def adam(learning_rate: float = 1e-3, b1: float = 0.9, b2: float = 0.999,
         eps: float = 1e-8) -> GradientTransformation:
    """``optax.adam(learning_rate, b1, b2, eps)`` on float32 tensors."""

    def init(params: torch.Tensor) -> AdamState:
        return AdamState(0, torch.zeros_like(params), torch.zeros_like(params))

    def update(grads: torch.Tensor, state: AdamState,
               params: Optional[torch.Tensor] = None) -> Tuple[torch.Tensor, AdamState]:
        del params
        mu = (1 - b1) * grads + b1 * state.mu
        nu = (1 - b2) * (grads * grads) + b2 * state.nu
        count = state.count + 1
        one = np.float32(1)
        corrections = device_table(
            (float(one - np.float32(b1) ** np.float32(count)),
             float(one - np.float32(b2) ** np.float32(count))), torch.float32, grads.device)
        mu_hat = mu / corrections[0]
        nu_hat = nu / corrections[1]
        updates = mu_hat / (torch.sqrt(nu_hat) + eps)
        return updates * -learning_rate, AdamState(count, mu, nu)

    return GradientTransformation(init, update)


def apply_updates(params: torch.Tensor, updates: torch.Tensor) -> torch.Tensor:
    """``optax.apply_updates`` for one tensor."""
    return params + updates
