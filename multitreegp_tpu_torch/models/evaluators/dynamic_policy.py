"""Dynamic (stateful) symbolic-policy evaluator.

Port of ``multitreegp_tpu/models/evaluators/dynamic_policy.py``: the
candidate is ``state_size`` hidden-state trees (layer 0) and ``n_control``
readout trees (layer 1). The ODE state is augmented to ``[x, a]`` with

    u  = readout([0s(n_obs), a, 0s(n_control), target])
    dx = env.drift(t, x, u)
    da = state_trees([y, a, u, target])

inside the loop, while the post-hoc control replay feeds real observations
(the reference's deliberate bottleneck, kept). The trees' variables are
declared in the order ``[y, a, u, target]``. Dispatch, noise, fitness and
the gradient are the static evaluator's; kernels #6 and #7 take any
``state_size`` whose candidate's decoded program fits a block's shared
memory (``policy_lanes_refusal``; past 2 their wide-state instance, e.g. 8
hidden states at ``max_nodes=30``). Process noise
kicks only the plant's latent state, but its increments are drawn over the
whole ``[x, a]``, as the JAX package draws them.
"""
from __future__ import annotations

from typing import Tuple

import torch

from ...core.interpreter import evaluate_trees
from ...core.registry import FunctionSet
from ...core.trees import TreeTensors
from .static_policy import StaticPolicyEvaluator


class DynamicPolicyEvaluator(StaticPolicyEvaluator):
    """Fitness = env cost of the closed loop driven by a stateful policy."""

    def __init__(
        self,
        env,
        fset: FunctionSet | None = None,
        state_size: int = 1,
        max_fitness: float = 1e4,
        method: str = "rk4",
        substeps: int = 4,
        remat: bool = False,
        interpreter: str = "auto",
        stochastic: bool = False,
        rtol: float = 1e-4,
        atol: float = 1e-4,
        adaptive_method: str = "bosh3",
    ) -> None:
        super().__init__(env, fset, max_fitness, method, substeps, remat, interpreter, stochastic,
                         rtol, atol, adaptive_method)
        self.state_size = state_size

    def _data_width(self) -> int:
        env = self.env
        return env.n_obs + self.state_size + env.n_control + env.n_targets

    def _split(self, population: TreeTensors):
        s = self.state_size
        return population.map(lambda a: a[..., :s, :]), population.map(lambda a: a[..., s:, :])

    def _data_vec(self, y, a, u, targets):
        """``[y, a, u, target]`` with the targets broadcast over leading dims."""
        return torch.cat([y, a, u, targets.expand(y.shape[:-1] + targets.shape[-1:])], dim=-1)

    def _rollout_general(self, population: TreeTensors, data: Tuple):
        x0, ts, targets, _pk, obs_keys, params = data
        env, fset = self.env, self.fset
        latent, n_ctrl = env.latent_size, env.n_control
        state_eq, readout = self._split(population[:, None])  # (P, 1, m_i, N)

        def drift(t, xa):  # xa (P, B, latent + state_size); t a float or (P, B)
            x, a = xa[..., :latent], xa[..., latent:]
            p_t = env.params_at(params, ts, t)
            y = env.f_obs(obs_keys, t, x, p_t)
            zeros_u = y.new_zeros(y.shape[:-1] + (n_ctrl,))
            data_r = self._data_vec(torch.zeros_like(y), a, zeros_u, targets)
            u = evaluate_trees(readout, data_r[..., None, :], fset)
            dx = env.drift(t, x, u, p_t)
            da = evaluate_trees(state_eq, self._data_vec(y, a, u, targets)[..., None, :], fset)
            return torch.cat([dx, da], dim=-1)

        xa0 = torch.cat([x0, x0.new_zeros((x0.shape[0], self.state_size))], dim=-1)
        xa0 = xa0[None].expand((population.batch_shape[0],) + xa0.shape)
        return self._integrate(drift, xa0, data, lambda t, xa: env.cond_alive(t, xa[..., :latent]))

    def _replay(self, population: TreeTensors, xas: torch.Tensor, data: Tuple):
        """``(xs, ys, us, activities)`` on the save grid: the controls with
        real observations, ``u`` zero-fed."""
        _x0, ts, targets, _pk, obs_keys, params = data
        latent = self.env.latent_size
        _state_eq, readout = self._split(population[:, None])
        xs, acts = xas[..., :latent], xas[..., latent:]
        ys = self.env.f_obs(obs_keys, ts[:, None, None], xs, params)
        zeros_u = ys.new_zeros(ys.shape[:-1] + (self.env.n_control,))
        us = evaluate_trees(readout, self._data_vec(ys, acts, zeros_u, targets)[..., None, :],
                            self.fset)
        return xs, ys, us, acts

    def _replay_controls(self, population: TreeTensors, xas: torch.Tensor, data: Tuple):
        return self._replay(population, xas, data)[2]

    def _states(self, xas: torch.Tensor) -> torch.Tensor:
        return xas[..., : self.env.latent_size]

    def evaluate_candidate(self, candidate: TreeTensors, data: Tuple):
        """``(xs, ys, us, activities, per-trajectory fitness)`` of one
        candidate, each ``(B, T, ·)`` but the fitness ``(B,)``."""
        pop = candidate.map(lambda a: a[None])
        xas, alive, _us = self._rollout(pop, data)
        xs, ys, us, acts = self._replay(pop, xas, data)
        cost = self._cost(xs[:, 0], us[:, 0], alive[:, 0], data)
        per_b = lambda a: a[:, 0].transpose(0, 1)
        return per_b(xs), per_b(ys), per_b(us), per_b(acts), cost
