"""Symbolic-regression evaluator: the candidate's trees ARE the drift.

Port of the fixed-step path of ``multitreegp_tpu/models/evaluators/sr.py``:
a candidate's trees define ``dx = trees(x)``; every candidate is integrated
from every initial state over the save grid; its fitness is the trajectory
MSE against the ground truth, with dead lanes and non-finite errors counted
as ``max_fitness`` and the trajectory mean clipped to ``[0, max_fitness]``.

Population evaluation goes through :class:`core.cuda_rollout.SRFitness`:
the fused kernel on CUDA tensors, its plain version on CPU tensors, and
differentiable in the constants (constant optimisation) by the unfused
recompute. Single-candidate rollouts (``evaluate_candidate``) integrate with
the dispatching interpreter: its kernel on CUDA tensors. The data tuple is
the JAX package's ``(x0s (B, d), ts (T,), ys (B, T, d), keys)``; ``keys`` is
accepted and unused.
"""
from __future__ import annotations

from typing import Optional, Tuple

import torch

from ...core.cuda_rollout import SRFitness
from ...core.interpreter import evaluate_trees
from ...core.registry import FunctionSet
from ...core.trees import TreeTensors
from ..integrators import integrate


class SREvaluator:
    """Fitness = trajectory MSE of the candidate integrated as an ODE."""

    def __init__(
        self,
        fset: Optional[FunctionSet] = None,
        max_fitness: float = 1e5,
        method: str = "rk4",
        substeps: int = 4,
        process_noise: float = 0.0,
    ) -> None:
        self.fset = fset
        self.max_fitness = max_fitness
        self.method = method
        self.substeps = substeps
        self.process_noise = process_noise

    def _check(self) -> None:
        if self.method == "adaptive":
            raise NotImplementedError(
                "method='adaptive' is not ported yet: ROADMAP Queue 1 #14 (adaptive SR)"
            )
        if self.process_noise > 0.0:
            raise NotImplementedError(
                "process_noise > 0 (SDE SR) is not ported yet: ROADMAP Queue 1 #15"
            )

    def evaluate_population(self, population: TreeTensors, data: Tuple) -> torch.Tensor:
        """population: batch shape ``(P, m)``; returns fitness ``(P,)``."""
        self._check()
        x0s, ts, ys, _keys = data
        mse, alive = SRFitness.apply(*population, x0s, ts, ys, self.fset, self.method, self.substeps)
        bad = ~alive | ~torch.isfinite(mse)
        per_traj = torch.where(bad, torch.full_like(mse, self.max_fitness), mse)
        fitness = per_traj.mean(dim=-1)
        fitness = torch.nan_to_num(fitness, nan=self.max_fitness)
        return fitness.clamp(0.0, self.max_fitness)

    def _rollout(self, population: TreeTensors, x0s: torch.Tensor, ts: torch.Tensor):
        """Trajectories ``(T, P, B, d)`` and liveness ``(T, P, B)``."""
        self._check()
        p = population.batch_shape[0]
        b, d = x0s.shape
        trees = population.map(lambda a: a[:, None])

        def drift(t, x):
            return evaluate_trees(trees, x[:, :, None, :], self.fset)

        return integrate(drift, x0s[None].expand(p, b, d), ts, self.method, self.substeps)

    def evaluate_candidate(self, candidate: TreeTensors, data: Tuple):
        """Per-trajectory fitness ``(B,)`` and predictions ``(B, T, d)`` of one
        candidate (inspection and plotting)."""
        x0s, ts, ys, _keys = data
        xs, alive = self._rollout(candidate.map(lambda a: a[None]), x0s, ts)
        pred = xs[:, 0]  # (T, B, d)
        err = ((pred - ys.transpose(0, 1)) ** 2).sum(dim=-1).mean(dim=0)
        bad = ~alive[-1, 0] | ~torch.isfinite(err)
        fitness = torch.where(bad, torch.full_like(err, self.max_fitness), err)
        return fitness, pred.transpose(0, 1)


def sr_trajectories(env, x0s: torch.Tensor, ts: torch.Tensor, method: str = "rk4",
                    substeps: int = 40) -> torch.Tensor:
    """Ground truth ``(B, T, d)``: the environment's drift integrated from
    ``x0s (B, d)`` over ``ts``."""
    xs, _ = integrate(env.drift, x0s, ts, method=method, substeps=substeps)
    return xs.transpose(0, 1).contiguous()


def generate_sr_data(env, generator: torch.Generator, ts: torch.Tensor, batch_size: int = 16,
                     method: str = "rk4", substeps: int = 40) -> Tuple:
    """SR data tuple ``(x0s, ts, ys, None)``: initial states drawn from
    ``generator`` and ground truth by fine-substep RK4 (the role of the
    notebook's ``get_data``)."""
    if getattr(env, "process_noise", 0.0) > 0.0:
        raise NotImplementedError("SDE ground truth is not ported yet: ROADMAP Queue 1 #15")
    x0s = env.sample_init_states(batch_size, generator)
    return x0s, ts, sr_trajectories(env, x0s, ts, method, substeps), None
