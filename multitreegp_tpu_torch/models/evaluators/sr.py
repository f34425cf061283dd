"""Symbolic-regression evaluator: the candidate's trees ARE the drift.

Port of ``multitreegp_tpu/models/evaluators/sr.py``: a candidate's trees
define ``dx = trees(x)``; every candidate is integrated from every initial
state over the save grid; its fitness is the trajectory MSE against the
ground truth, with dead lanes and non-finite errors counted as
``max_fitness`` and the trajectory mean clipped to ``[0, max_fitness]``.
With ``process_noise > 0`` and the data tuple's keys, the candidate is
integrated as the SDE ``dx = trees(x) dt + process_noise dW`` by
Euler-Maruyama with ``substeps`` steps per interval, whatever ``method``
says, its increments drawn from ``fold_in(key, bitcast_f32(t))`` of each
trajectory's key (``integrate_sde``).

Population evaluation is fused where the configuration allows, one kernel
per evaluation on CUDA tensors and its plain version on CPU tensors, and
differentiable in the constants (constant optimisation) through an unfused
recompute:

* fixed step (``method`` euler / heun / rk4): :class:`core.cuda_rollout.SRFitness`;
* SDE: the same kernel with the kick rows of ``make_sr_kick_rows``, its
  recompute through ``integrate_sde``;
* ``method="adaptive"``: :class:`core.cuda_adaptive.SRFitnessAdaptive` with
  the whole-solve step budget (diffrax ``max_steps`` semantics, kernel #5)
  of ``adaptive_budget``, 500 by default, on every grid. The JAX evaluator
  takes the same kernel on a TPU while its VMEM gate passes, and else the
  per-interval kernel with ``adaptive_step_budget(substeps)`` steps per save
  interval, ignoring ``adaptive_budget``; the port has no such gate.

The fused kernels take ``interpreter="auto"`` or ``"pallas"`` and what
``core.cuda_rollout.lanes_refusal`` admits (one tree per state dimension,
``N <= 256``, any state dim and trajectory count whose candidate's decoded
program fits a block's shared memory: d up to 894 at N = 32, 113 at
N = 256; past ``d = 4``, ``B = 1024`` or 63 variables in the kernels' wide
instance), decided from the configuration alone, as the JAX evaluator's
``rollout_available(..., deep_ok=True)``.
Everything else (``interpreter="ladder"`` / ``"gather"`` among it) takes the
general path: the integrator (``integrate``, ``integrate_sde`` or
``integrate_adaptive`` with the per-interval budget) with the dispatching
interpreter as the drift, kernel #8 on CUDA, and the MSE of the trajectory.
``remat`` is accepted and has no effect: PyTorch keeps the autograd tape,
and the fused kernels' backward recomputes the rollout anyway.
:meth:`SREvaluator.prepare_chained` splits a fixed-step evaluation into a
prepared part and ``step(const)``, for one population evaluated with
changing constants.

Single-candidate rollouts (``evaluate_candidate``, ``__call__``) write the
trajectory: ``integrate_sde`` for the SDE; the fixed-step trajectory kernel
(:class:`SRRollout`) where ``N <= 64`` and the fused kernels take the
configuration; else the integrator (``integrate_adaptive`` for
``method="adaptive"``, with the JAX package's per-interval budget); each with
the dispatching interpreter as the drift. The data tuple is the JAX
package's ``(x0s (B, d), ts (T,), ys (B, T, d), keys (B, 2))``; the keys
only matter for the SDE, and may be None otherwise.
"""
from __future__ import annotations

from typing import Optional, Tuple

import torch

from ...core.cuda_adaptive import AdaptiveConfig, SRFitnessAdaptive
from ...core.cuda_rollout import SDENoise, SRFitness, SRRollout, lanes_refusal
from ...core.interpreter import evaluate_trees
from ...core.registry import FunctionSet
from ...core.trees import TreeTensors
from ..integrators import _f32, adaptive_step_budget, integrate, integrate_adaptive, integrate_sde
from .noise import make_sr_kick_rows

ROLLOUT_MAX_NODES = 64  # the JAX trajectory kernel's gate (UNROLL_MAX_NODES)
DEFAULT_ADAPTIVE_BUDGET = 500  # the reference's diffrax max_steps


class SREvaluator:
    """Fitness = trajectory MSE of the candidate integrated as an ODE (an
    SDE with ``process_noise > 0``)."""

    def __init__(
        self,
        fset: Optional[FunctionSet] = None,
        max_fitness: float = 1e5,
        method: str = "rk4",
        substeps: int = 4,
        remat: bool = False,
        interpreter: str = "auto",
        process_noise: float = 0.0,
        rtol: float = 1e-4,
        atol: float = 1e-6,
        adaptive_method: str = "bosh3",
        adaptive_budget: Optional[int] = None,
    ) -> None:
        self.fset = fset
        self.max_fitness = max_fitness
        self.method = method
        self.substeps = substeps
        self.remat = remat  # accepted for the JAX signature; no effect here
        self.interpreter = interpreter
        self.process_noise = process_noise
        self.rtol = rtol
        self.atol = atol
        self.adaptive_method = adaptive_method
        # whole-solve attempted-step budget of the adaptive path (diffrax
        # ``max_steps``); None means the reference's 500
        self.adaptive_budget = adaptive_budget

    def _sde(self, keys) -> bool:
        return self.process_noise > 0.0 and keys is not None

    def _adaptive_config(self) -> AdaptiveConfig:
        """The fused adaptive fitness ``evaluate_population`` computes: the
        global budget, always (see the module docstring)."""
        budget = self.adaptive_budget if self.adaptive_budget is not None else DEFAULT_ADAPTIVE_BUDGET
        return AdaptiveConfig(True, budget, self.adaptive_method, self.rtol, self.atol)

    def _fused(self, population: TreeTensors, x0s: torch.Tensor) -> bool:
        """Whether :meth:`evaluate_population` takes a fused kernel (#1, or #5
        for the adaptive method): from the configuration alone."""
        b, d = x0s.shape
        return (self.interpreter in ("auto", "pallas")
                and lanes_refusal(population.batch_shape[-1], population.max_nodes, d, b) is None)

    def evaluate_population(self, population: TreeTensors, data: Tuple) -> torch.Tensor:
        """population: batch shape ``(P, m)``; returns fitness ``(P,)``."""
        x0s, ts, ys, keys = data
        if not self._fused(population, x0s):  # the general path
            xs, alive = self._rollout(population, x0s, ts, keys)
            err = xs - ys.transpose(0, 1)[:, None]
            mse, alive = (err * err).sum(dim=-1).mean(dim=0), alive[-1]
        elif self._sde(keys):  # Euler-Maruyama, as the general path forces
            noise = SDENoise(make_sr_kick_rows(self.process_noise, ts, keys, self.substeps,
                                               x0s.shape[1]), keys, self.process_noise)
            mse, alive = SRFitness.apply(*population, x0s, ts, ys, self.fset, "euler",
                                         self.substeps, noise)
        elif self.method == "adaptive":
            mse, alive = SRFitnessAdaptive.apply(*population, x0s, ts, ys, self.fset,
                                                 self._adaptive_config())
        else:
            mse, alive = SRFitness.apply(*population, x0s, ts, ys, self.fset, self.method,
                                         self.substeps)
        return self._fitness(mse, alive)

    def _fitness(self, mse: torch.Tensor, alive: torch.Tensor) -> torch.Tensor:
        """Per-candidate fitness ``(P,)`` from per-lane ``mse`` and ``alive``
        ``(P, B)``: dead or non-finite lanes count as ``max_fitness``, the
        mean over trajectories clipped to ``[0, max_fitness]``."""
        bad = ~alive | ~torch.isfinite(mse)
        per_traj = torch.where(bad, torch.full_like(mse, self.max_fitness), mse)
        fitness = per_traj.mean(dim=-1)
        fitness = torch.nan_to_num(fitness, nan=self.max_fitness)
        return fitness.clamp(0.0, self.max_fitness)

    def prepare_chained(self, population: TreeTensors, data: Tuple):
        """Split prepare/run API for repeated evaluation of ONE population
        structure with varying constants (steady-state benchmarks, chained
        constant updates).

        Returns ``(step, const0)``, where ``step(const) -> fitness (P,)``
        equals ``evaluate_population(population._replace(const=const),
        data)`` bit for bit (and is differentiable in ``const`` as it is),
        or None where :meth:`evaluate_population` does not take the fused
        fixed-step kernel #1: the adaptive method without process noise,
        another method, an ``interpreter`` other than ``"auto"`` /
        ``"pallas"``, or a configuration ``lanes_refusal`` refuses.

        What it hoists out of ``step``: the SDE kick rows (rebuilt by every
        :meth:`evaluate_population`) and the contiguous copies of the tree
        structure, the initial states, the grid and the ground truth. The
        port has no size sort or lane layout to prepare, so ``const0`` is
        ``population.const`` in population order (the JAX package's is in
        its size-sorted order)."""
        x0s, ts, ys, keys = data
        sde = self._sde(keys)
        if not self._fused(population, x0s) or (
                not sde and self.method not in ("euler", "heun", "rk4")):
            return None
        method = "euler" if sde else self.method
        noise = None
        if sde:
            noise = SDENoise(make_sr_kick_rows(self.process_noise, ts, keys, self.substeps,
                                               x0s.shape[1]).contiguous(), keys, self.process_noise)
        ops, c1, c2 = (t.contiguous() for t in (population.ops, population.c1, population.c2))
        x0s, ts, ys = x0s.contiguous(), ts.contiguous(), ys.contiguous()

        def step(const: torch.Tensor) -> torch.Tensor:
            mse, alive = SRFitness.apply(ops, c1, c2, const, x0s, ts, ys, self.fset, method,
                                         self.substeps, noise)
            return self._fitness(mse, alive)

        return step, population.const.contiguous()

    def _rollout(self, population: TreeTensors, x0s: torch.Tensor, ts: torch.Tensor, keys=None):
        """Trajectories ``(T, P, B, d)`` and liveness ``(T, P, B)``."""
        p = population.batch_shape[0]
        b, d = x0s.shape
        trees = population.map(lambda a: a[:, None])

        def drift(t, x):
            return evaluate_trees(trees, x[:, :, None, :], self.fset)

        x0 = x0s[None].expand(p, b, d)
        if self._sde(keys):
            pn = _f32(self.process_noise)
            return integrate_sde(drift, lambda t, x: torch.full_like(x, pn), x0, ts, keys,
                                 "euler", self.substeps)
        if self.method == "adaptive":
            per_interval = (
                max(self.adaptive_budget // max(ts.shape[0] - 1, 1), 4)
                if self.adaptive_budget is not None
                else adaptive_step_budget(self.substeps)
            )
            return integrate_adaptive(drift, x0, ts, rtol=self.rtol, atol=self.atol,
                                      max_steps_per_interval=per_interval,
                                      method=self.adaptive_method)
        if population.max_nodes <= ROLLOUT_MAX_NODES and self._fused(population, x0s):
            return SRRollout.apply(*population, x0s, ts, self.fset, self.method, self.substeps)
        return integrate(drift, x0, ts, self.method, self.substeps)

    def evaluate_candidate(self, candidate: TreeTensors, data: Tuple):
        """Per-trajectory fitness ``(B,)`` and predictions ``(B, T, d)`` of one
        candidate (inspection and plotting)."""
        x0s, ts, ys, keys = data
        xs, alive = self._rollout(candidate.map(lambda a: a[None]), x0s, ts, keys)
        pred = xs[:, 0]  # (T, B, d)
        err = ((pred - ys.transpose(0, 1)) ** 2).sum(dim=-1).mean(dim=0)
        bad = ~alive[-1, 0] | ~torch.isfinite(err)
        fitness = torch.where(bad, torch.full_like(err, self.max_fitness), err)
        return fitness, pred.transpose(0, 1)

    def __call__(self, candidate: TreeTensors, data: Tuple) -> torch.Tensor:
        """The reference's call: the candidate's mean fitness over the
        trajectories, clipped to ``[0, max_fitness]``."""
        fitness, _ = self.evaluate_candidate(candidate, data)
        return fitness.mean().clamp(0.0, self.max_fitness)


def sr_trajectories(env, x0s: torch.Tensor, ts: torch.Tensor, method: str = "rk4",
                    substeps: int = 40, keys: Optional[torch.Tensor] = None) -> torch.Tensor:
    """Ground truth ``(B, T, d)``: the environment's drift integrated from
    ``x0s (B, d)`` over ``ts``; for an environment with ``process_noise >
    0``, the SDE over ``env.diffusion`` by Euler-Maruyama with ``substeps``
    steps per interval, its increments drawn from ``keys (B, 2)``."""
    if getattr(env, "process_noise", 0.0) > 0.0:
        xs, _ = integrate_sde(env.drift, env.diffusion, x0s, ts, keys, "euler", substeps)
    else:
        xs, _ = integrate(env.drift, x0s, ts, method=method, substeps=substeps)
    return xs.transpose(0, 1).contiguous()


def generate_sr_data(env, generator: torch.Generator, ts: torch.Tensor, batch_size: int = 16,
                     method: str = "rk4", substeps: int = 40) -> Tuple:
    """SR data tuple ``(x0s, ts, ys, keys)``: initial states, then ``(B, 2)``
    process-noise keys in JAX's raw layout, drawn from ``generator``; the
    ground truth by fine-substep RK4, or the SDE of :func:`sr_trajectories`
    for a noisy environment (the role of the notebook's ``get_data``)."""
    x0s = env.sample_init_states(batch_size, generator)
    keys = torch.randint(0, 2**32, (batch_size, 2), generator=generator, device=generator.device)
    return x0s, ts, sr_trajectories(env, x0s, ts, method, substeps, keys), keys
