"""Static (feedforward) symbolic-policy evaluator.

Port of ``multitreegp_tpu/models/evaluators/static_policy.py``: the
candidate's trees map observations (and targets) to the control ``u =
trees([y, target])``, recomputed inside the drift at every stage; after the
rollout the controls are re-derived on the save grid, and the fitness is the
environment's cost of (states, controls), with dead saves filled with
``inf`` so that the cost decides what divergence is worth, a non-finite cost
counted as ``max_fitness``, and the trajectory mean clipped to ``[0,
max_fitness]``.

Observation noise (``env.obs_noise != 0``) is ``normal(fold_in(key,
bitcast_f32(t)))`` of the trajectory's observation key at every solver
time; with ``stochastic=True`` and ``env.process_noise > 0`` the plant is
the SDE of its diffusion, integrated by Euler-Maruyama whatever ``method``
says (``integrate_sde``), its increments drawn from the process-noise keys.

Population evaluation takes a fused kernel where the JAX dispatch takes one
and the kernels' one limit (``policy_lanes_refusal``: ``N <= 256`` and a
candidate's decoded program within a block's shared memory) allows, decided
by configuration: a fixed-step method (or process noise, which makes it
euler), a function set whose variables are the data vector ``[y,
targets]``, a plant with a device drift (a built-in class's hand-written
one, or for any other environment with ``tile_safe_drift = True`` the one
``core/user_envs.py`` traces from its methods; a non-tile-safe environment,
or a refused trace, takes the general path, as JAX's gate sends
non-tile-safe environments there, and the reason is kept in
``env_refusal``) and at least two save points take
kernel #6 (any number of trajectories and targets; past two targets its
wide-state instance), given the noise as rows built up front
(``noise.py``); the adaptive method with per-trajectory parameters and no
noise takes kernel #7; everything else (the adaptive method with
observation noise, whose draws fall at data-dependent times, and
``interpreter="ladder"`` / ``"gather"``) the general path, the integrator
with ``evaluate_trees`` (kernel #8 on CUDA) as the policy. A configuration
the gate admits launches its kernel or raises on CUDA; nothing falls back.
The fused rollout is differentiable in the constants through
``core.cuda_policy.PolicyRollout`` (the general path's gradient). The JAX
VMEM gate is not copied. ``remat`` is accepted and has no effect (PyTorch
keeps the tape).

Data: ``(x0, ts, targets, process_noise_keys, obs_noise_keys, params)``, as
``generate_control_data`` returns it.
"""
from __future__ import annotations

from typing import Tuple

import torch

from ...core.cuda_policy import (
    PolicyRollout, _series, plant_refusal, policy_lanes_refusal, rollout_policy,
    rollout_policy_adaptive,
)
from ...core.cuda_rollout import METHODS
from ...core.interpreter import evaluate_trees
from ...core.registry import FunctionSet
from ...core.trees import TreeTensors
from ..integrators import adaptive_step_budget, integrate, integrate_adaptive, integrate_sde
from .noise import make_obs_noise_rows, make_process_noise_rows


class StaticPolicyEvaluator:
    """Fitness = env cost of the closed loop driven by the candidate policy."""

    state_size = 0

    def __init__(
        self,
        env,
        fset: FunctionSet | None = None,
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
        self.env = env
        self.fset = fset
        self.max_fitness = max_fitness
        self.method = method
        self.substeps = substeps
        self.remat = remat
        self.interpreter = interpreter
        self.stochastic = stochastic
        self.rtol = rtol
        self.atol = atol
        self.adaptive_method = adaptive_method
        # why the environment has no device plant (the last gate that asked),
        # or None
        self.env_refusal = None

    # ------------------------------------------------------------ dispatch

    def _sde(self) -> bool:
        return self.stochastic and getattr(self.env, "process_noise", 0.0) > 0.0

    def _data_width(self) -> int:
        return self.env.n_obs + self.env.n_targets

    def _plant_refusal(self, params):
        """``cuda_policy.plant_refusal`` (None where the kernels have the
        environment's plant), kept in ``env_refusal``."""
        self.env_refusal = plant_refusal(self.env, params)
        return self.env_refusal

    def _fused_kind(self, population: TreeTensors, data: Tuple):
        """``"fixed"`` (kernel #6), ``"adaptive"`` (#7) or None (the general
        path), from the configuration alone: the kernels' gate
        (``policy_lanes_refusal``), a data vector the kernels lay out, and a
        plant they run (:meth:`_plant_refusal`)."""
        ts, params = data[1], data[5]
        m, n = population.ops.shape[-2:]
        if (self.interpreter not in ("auto", "pallas")
                or self.fset.num_variables != self._data_width() or ts.shape[0] < 2
                or self._plant_refusal(params) is not None
                or policy_lanes_refusal(m, n) is not None):
            return None
        if self.method in METHODS:
            return "fixed"
        if (self.method == "adaptive" and not _series(params) and self.env.obs_noise == 0.0
                and not self._sde()):
            return "adaptive"
        return None

    def _fused(self, data: Tuple, kind: str):
        """The dispatcher of the fused rollout: ``trees -> (xs, us, alive)``;
        the fixed-step kernel gets the noise rows, built here once."""
        x0, ts, targets, pkeys, obs_keys, params = data
        env = self.env
        if kind == "adaptive":
            return lambda trees: rollout_policy_adaptive(
                trees, x0, ts, targets, params, env, self.fset, rtol=self.rtol,
                atol=self.atol, max_steps=adaptive_step_budget(self.substeps),
                method=self.adaptive_method, state_size=self.state_size)
        # the stochastic general path is Euler whatever the method
        method = "euler" if self._sde() else self.method
        obs_rows = (make_obs_noise_rows(env, ts, params, obs_keys, self.substeps, method)
                    if env.obs_noise != 0.0 else None)
        kick_rows = (make_process_noise_rows(env, ts, params, pkeys, self.substeps,
                                             env.latent_size + self.state_size)
                     if self._sde() else None)
        return lambda trees: rollout_policy(
            trees, x0, ts, targets, params, env, self.fset, self.substeps, method,
            self.state_size, obs_rows, kick_rows)

    def _recompute(self, data: Tuple):
        """``trees -> (xs, us)`` by the general path and the replay: the
        fused rollout's backward."""
        def run(trees):
            xs, _ = self._rollout_general(trees, data)
            return xs, self._replay_controls(trees, xs, data)
        return run

    def _rollout(self, population: TreeTensors, data: Tuple):
        """``(xs, alive, us or None)``: the fused kernel streams the save-grid
        controls beside the states; the general path returns None and the
        caller replays."""
        kind = self._fused_kind(population, data)
        if kind is not None:
            xs, us, alive = PolicyRollout.apply(*population, self._fused(data, kind),
                                                self._recompute(data))
            return xs, alive, us
        xs, alive = self._rollout_general(population, data)
        return xs, alive, None

    # ------------------------------------------------------- general path

    def _controls(self, policy: TreeTensors, obs: torch.Tensor, targets: torch.Tensor):
        """``u = trees([y, target])`` for obs ``(..., B, n_obs)``, targets
        ``(B, n_targets)``."""
        tgt = targets.expand(obs.shape[:-1] + targets.shape[-1:])
        return evaluate_trees(policy, torch.cat([obs, tgt], dim=-1)[..., None, :], self.fset)

    def _diffusion(self, data: Tuple):
        """``(t, x) -> (..., d, d)``: the plant's diffusion on the latent
        block of the integrated state ``x (..., d)``, zero on a policy's
        hidden state."""
        ts, params, env = data[1], data[5], self.env
        latent = env.latent_size

        def diffusion(t, x):
            u0 = x.new_zeros(env.n_control)
            g = env.diffusion(t, x[..., :latent], u0, env.params_at(params, ts, t))
            full = x.new_zeros(x.shape + x.shape[-1:])
            full[..., :latent, :latent] = g
            return full
        return diffusion

    def _integrate(self, drift, x0b: torch.Tensor, data: Tuple, cond_alive):
        ts = data[1]
        if self._sde():
            return integrate_sde(drift, self._diffusion(data), x0b, ts, data[3], "euler",
                                 self.substeps, cond_alive)
        if self.method == "adaptive":
            return integrate_adaptive(
                drift, x0b, ts, rtol=self.rtol, atol=self.atol,
                max_steps_per_interval=adaptive_step_budget(self.substeps),
                cond_alive=cond_alive, method=self.adaptive_method)
        return integrate(drift, x0b, ts, method=self.method, substeps=self.substeps,
                         cond_alive=cond_alive)

    def _rollout_general(self, population: TreeTensors, data: Tuple):
        """``(xs (T, P, B, latent), alive (T, P, B))`` by the integrator; the
        adaptive path's times are per lane, and so are the parameters."""
        x0, ts, targets, _pk, obs_keys, params = data
        env = self.env
        trees = population[:, None]  # (P, 1, m, N)

        def drift(t, x):  # x (P, B, latent); t a float or (P, B)
            p_t = env.params_at(params, ts, t)
            u = self._controls(trees, env.f_obs(obs_keys, t, x, p_t), targets)
            return env.drift(t, x, u, p_t)

        x0b = x0[None].expand((population.batch_shape[0],) + x0.shape)
        return self._integrate(drift, x0b, data, env.cond_alive)

    def _replay(self, population: TreeTensors, xs: torch.Tensor, data: Tuple):
        """Observations and controls on the save grid: ``(ys, us)``."""
        _x0, ts, targets, _pk, obs_keys, params = data
        ys = self.env.f_obs(obs_keys, ts[:, None, None], xs, params)  # (T, P, B, n_obs)
        return ys, self._controls(population[:, None], ys, targets)

    def _replay_controls(self, population: TreeTensors, xs: torch.Tensor, data: Tuple):
        return self._replay(population, xs, data)[1]

    def _states(self, xs: torch.Tensor) -> torch.Tensor:
        """The plant's latent states of a rollout's saved states."""
        return xs

    # ------------------------------------------------------------- fitness

    def _cost(self, xs, us, alive, data) -> torch.Tensor:
        """The env cost per ``(..., B)`` trajectory of saves ``(T, ..., B,
        ·)``: dead saves are ``inf`` in the states and the controls (the
        reference recomputes controls from inf-filled states), and a
        non-finite cost counts as ``max_fitness``."""
        _x0, ts, targets, _pk, _ok, params = data
        live = alive.movedim(0, -1)[..., None]
        xs_b = torch.where(live, xs.movedim(0, -2), float("inf"))
        us_b = torch.where(live, us.movedim(0, -2), float("inf"))
        cost = self.env.fitness(xs_b, us_b, targets, ts, params)
        return torch.where(torch.isfinite(cost), cost, torch.full_like(cost, self.max_fitness))

    def evaluate_population(self, population: TreeTensors, data: Tuple) -> torch.Tensor:
        """population batch ``(P, m)``; returns fitness ``(P,)``."""
        xs, alive, us = self._rollout(population, data)
        if us is None:  # general path: the post-hoc replay
            us = self._replay_controls(population, xs, data)
        fitness = self._cost(self._states(xs), us, alive, data).mean(dim=-1)
        return torch.nan_to_num(fitness, nan=self.max_fitness).clamp(0.0, self.max_fitness)

    def evaluate_candidate(self, candidate: TreeTensors, data: Tuple):
        """``(xs (B, T, latent), ys (B, T, n_obs), us (B, T, n_control),
        per-trajectory fitness (B,))`` of one candidate: the reference's
        inspection API."""
        pop = candidate.map(lambda a: a[None])
        xs, alive, _us = self._rollout(pop, data)
        ys, us = self._replay(pop, xs, data)  # inspection wants ys too
        cost = self._cost(xs[:, 0], us[:, 0], alive[:, 0], data)
        per_b = lambda a: a[:, 0].transpose(0, 1)
        return per_b(xs), per_b(ys), per_b(us), cost
