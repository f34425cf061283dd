"""Gradient-based refinement of expression constants ("coefficients").

Port of ``multitreegp_tpu/ops/constant_opt.py`` (reference
``genetic_programming.py:435-473``): for the selected candidates, run
``gradient_steps`` epochs of Adam on the constant slots, differentiating the
full fitness (ODE rollout included) with respect to the constants. Each
epoch records the PRE-update constants and their fitness; the result per
candidate is its best epoch (the first minimum), so refinement never hurts.

The gradient flows through ``SREvaluator.evaluate_population`` ->
``SRFitness``: the fused fitness kernel forward, and the unfused recompute
through the interpreter kernels backward. Non-finite gradients are zeroed
before the optimiser sees them, as in the JAX package.
"""
from __future__ import annotations

from typing import Callable, Optional, Tuple

import torch

from ..core.trees import TreeTensors
from .optim import GradientTransformation, adam, apply_updates


def make_constant_optimiser(
    evaluate_population: Callable[[TreeTensors, Tuple], torch.Tensor],
    optimiser: Optional[GradientTransformation] = None,
    gradient_steps: int = 10,
):
    """Build ``optimise(candidates, data) -> (fitness (K,), candidates)``.

    ``candidates`` has batch shape ``(K, num_trees)``; all K candidates are
    refined together (a candidate's fitness depends only on its own
    constants, so the gradient of the summed fitness is per candidate).
    """
    if optimiser is None:
        optimiser = adam(learning_rate=1e-3, b1=0.9, b2=0.999)

    def optimise(candidates: TreeTensors, data: Tuple) -> Tuple[torch.Tensor, TreeTensors]:
        consts = candidates.const.detach()
        state = optimiser.init(consts)
        const_hist, fit_hist = [], []
        for _ in range(gradient_steps):
            c = consts.detach().requires_grad_(True)
            with torch.enable_grad():
                fitness = evaluate_population(candidates._replace(const=c), data)
                (grads,) = torch.autograd.grad(fitness.sum(), (c,))
            grads = torch.nan_to_num(grads, nan=0.0, posinf=0.0, neginf=0.0)
            updates, state = optimiser.update(grads, state, consts)
            const_hist.append(consts)  # the PRE-update constants (reference :452)
            fit_hist.append(fitness.detach())
            consts = apply_updates(consts, updates)
        fits = torch.stack(fit_hist)  # (steps, K)
        best_epoch = torch.argmin(fits, dim=0)  # the first minimum, as jnp.argmin
        lanes = torch.arange(fits.shape[1], device=fits.device)
        best_consts = torch.stack(const_hist)[best_epoch, lanes]
        return fits[best_epoch, lanes], candidates._replace(const=best_consts)

    return optimise
