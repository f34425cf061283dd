"""Environment bases (PyTorch).

Ports of ``SREnvironmentBase`` and ``ControlEnvironmentBase``
(``multitreegp_tpu/models/environments/base.py``): an environment holds
static configuration and samples its data from a ``torch.Generator``; per
trajectory physics parameters are explicit tuples of tensors, ``(B,)`` per
trajectory or ``(B, T)`` series over the save grid. Every function is
batched over leading dimensions (the JAX ones are per lane under ``vmap``).

Observation noise is a deterministic function of the trajectory's key and
the time, ``normal(fold_in(key, bitcast_f32(t)), (n_obs,))``, drawn by the
port's copy of JAX's generator (``core/prng.py``), so solvers that
re-evaluate a time see the same noise and the port draws the JAX package's
numbers from the same keys.
"""
from __future__ import annotations

import abc
from typing import Tuple

import torch

from ...core import prng
from ..integrators import linear_interp


def obs_noise_at(keys: torch.Tensor, t, n_obs: int) -> torch.Tensor:
    """Standard-normal observation noise ``(..., B, n_obs)``, deterministic in
    (key, t): keys ``(B, 2)``; ``t`` a float or a tensor of times that
    broadcasts against ``(..., B)`` (per-lane solver times ``(P, B)``, the
    save grid as ``(T, 1, 1)``)."""
    return prng.normal(prng.fold_in(keys, prng.bitcast_time(t, keys.device)), n_obs)


def _noise_term(z: torch.Tensor, w: torch.Tensor) -> torch.Tensor:
    """``z @ w`` for draws ``z (..., n)``, summed elementwise: with a
    diagonal ``w`` every sum is one product plus exact zeros, so it rounds
    alike on every device."""
    return (z[..., :, None] * w.to(z.device)).sum(dim=-2)


class SREnvironmentBase(abc.ABC):
    """Time-series environment for symbolic regression."""

    def __init__(self, process_noise: float, obs_noise: float, n_var: int, n_obs: int):
        self.process_noise = process_noise
        self.obs_noise = obs_noise
        self.n_var = n_var
        self.n_obs = n_obs

    @abc.abstractmethod
    def sample_init_states(self, batch_size: int, generator: torch.Generator) -> torch.Tensor:
        """``(batch_size, n_var)`` float32 initial states on the generator's
        device."""

    @abc.abstractmethod
    def drift(self, t: torch.Tensor, x: torch.Tensor) -> torch.Tensor:
        """Batched drift: ``x (..., n_var) -> dx (..., n_var)``."""

    def diffusion(self, t, x: torch.Tensor) -> torch.Tensor:
        """``process_noise * I``: one ``(n_var, n_var)`` matrix per lane of
        ``x (..., n_var)``."""
        eye = self.process_noise * torch.eye(self.n_var, device=x.device)
        return eye.expand(x.shape[:-1] + eye.shape)

    def f_obs(self, keys: torch.Tensor, t, x: torch.Tensor) -> torch.Tensor:
        """``C x + noise W`` ``(..., n_obs)`` of ``x (..., n_var)``: ``C`` the
        first ``n_obs`` rows of the identity, ``W = obs_noise * I``."""
        w = self.obs_noise * torch.eye(self.n_obs)
        return x[..., : self.n_obs] + _noise_term(obs_noise_at(keys, t, self.n_obs), w)


def time_varying(param: torch.Tensor, ts: torch.Tensor, t) -> torch.Tensor:
    """A parameter at solver time ``t``: per-trajectory values ``(B,)`` pass
    through; series ``(B, T)`` are linearly interpolated (the role of
    ``diffrax.LinearInterpolation`` in the Switch/Decay modes). ``t`` is a
    float or per-lane times that broadcast against ``(B,)``."""
    if param.dim() < 2:
        return param
    return linear_interp(ts, param.transpose(0, 1), t)


class ControlEnvironmentBase(abc.ABC):
    """Controlled ODE environment.

    The seven built-in classes (``control_envs.py``) run hand-written device
    plants in the policy kernels #6/#7 (``csrc/control_envs.cuh``, keyed by
    exact class in ``core/cuda_policy.ENV_IDS``). Any other environment that
    sets ``tile_safe_drift = True`` runs there too: ``core/user_envs.py``
    traces its ``drift``, ``cond_alive``, ``obs`` and ``obs_noisy`` (the
    roles of JAX's ``obs_tiles`` / ``obs_tiles_noisy``) into device code of
    its own build. A tile-safe environment's methods are elementwise
    float32 ops over the lanes of indexed state (``x[..., i]``,
    ``x.unbind(-1)``, slices of the last axis, ``torch.stack`` / ``torch.cat``
    along it); they do not depend on ``t`` (the kernels pass 0, as JAX's
    do); they read the physics through ``params`` only (numbers read from
    ``self`` are baked into the generated code when it is traced); and they
    hold no tensor constant (no matmul with a constant matrix), no reduction,
    no random draw and no Python control flow on values. A trace that breaks
    these rules is refused with its reason, and the evaluators then take the
    general path (``StaticPolicyEvaluator.env_refusal`` keeps the reason).
    With ``tile_safe_drift = False`` (the default, as in JAX) the evaluators
    always take the general path."""

    n_targets: int = 0
    # the tile protocol's flag (JAX ``ControlEnvironmentBase.tile_safe_drift``):
    # True admits the environment into the fused policy kernels
    tile_safe_drift: bool = False

    def __init__(self, process_noise: float, obs_noise: float, n_var: int, n_control: int,
                 n_dim: int, n_obs: int):
        self.process_noise = process_noise
        self.obs_noise = obs_noise
        self.n_var = n_var
        self.n_control = n_control
        self.n_dim = n_dim
        self.n_obs = n_obs

    @property
    def latent_size(self) -> int:
        return self.n_var * self.n_dim

    @abc.abstractmethod
    def sample_init_states(self, batch_size: int, generator: torch.Generator
                           ) -> Tuple[torch.Tensor, torch.Tensor]:
        """``(x0 (B, latent), targets (B, n_targets))``."""

    @abc.abstractmethod
    def sample_params(self, batch_size: int, mode: str, ts: torch.Tensor,
                      generator: torch.Generator) -> Tuple[torch.Tensor, ...]:
        """Per-trajectory physics parameters; modes Constant / Different /
        Switch / Decay."""

    def prepare_params(self, params, ts: torch.Tensor):
        """Hook for precomputing interpolation tables. Default: identity."""
        return params

    def params_at(self, params, ts: torch.Tensor, t):
        """The parameters at solver time ``t``. Default: identity (constant
        physics)."""
        return params

    @abc.abstractmethod
    def drift(self, t, x: torch.Tensor, u: torch.Tensor, params) -> torch.Tensor:
        """Batched controlled drift: ``x (..., latent)``, ``u (..., n_control)``,
        params broadcasting against ``x.shape[:-1]``."""

    def diffusion(self, t, x: torch.Tensor, u: torch.Tensor, params) -> torch.Tensor:
        return self.process_noise * torch.eye(self.latent_size, device=x.device)

    def _obs_matrices(self, params) -> Tuple[torch.Tensor, torch.Tensor]:
        c = torch.eye(self.latent_size)[: self.n_obs]
        w = self.obs_noise * torch.eye(self.n_obs)
        return c, w

    def obs_noise_term(self, keys: torch.Tensor, t, params) -> torch.Tensor:
        """The additive term ``noise @ W`` of the observation at time ``t``
        (as :func:`obs_noise_at`): ``(..., B, n_obs)``, already scaled."""
        _c, w = self._obs_matrices(params)
        return _noise_term(obs_noise_at(keys, t, self.n_obs), w)

    def f_obs(self, keys, t, x: torch.Tensor, params) -> torch.Tensor:
        """The observation ``C x + noise W`` ``(..., B, n_obs)`` of ``x (...,
        B, latent)`` at time ``t`` (a float, or times broadcasting against
        ``(..., B)``); keys ``(B, 2)``. Without observation noise no draw is
        made."""
        if self.obs_noise == 0.0:
            return self.obs(x)
        return self.obs_noisy(x, self.obs_noise_term(keys, t, params))

    def obs(self, x: torch.Tensor) -> torch.Tensor:
        """Noise-free observation ``(..., n_obs)`` of ``x (..., latent)``
        (JAX's ``obs_tiles``; ``n_obs`` may exceed the latent size, e.g.
        ``[cos, sin]`` of an angle). Override alongside ``obs_noisy`` (e.g.
        angle wrapping)."""
        return x[..., : self.n_obs]

    def obs_noisy(self, x: torch.Tensor, noise: torch.Tensor) -> torch.Tensor:
        """The observation with the additive, already scaled draw ``noise
        (..., n_obs)`` (the rows the fused kernels are given; JAX's
        ``obs_tiles_noisy``)."""
        return self.obs(x) + noise

    @abc.abstractmethod
    def fitness(self, xs: torch.Tensor, us: torch.Tensor, targets: torch.Tensor,
                ts: torch.Tensor, params) -> torch.Tensor:
        """Cost ``(...)`` of trajectories ``xs (..., T, latent)`` and controls
        ``us (..., T, n_control)``; ``targets (B, n_targets)`` and the
        params broadcast against the leading dims (whose last is B)."""

    def cond_alive(self, t, x: torch.Tensor) -> torch.Tensor:
        """Extra liveness predicate ``(...)`` of ``x (..., latent)`` (True =
        keep integrating); the integrator already checks finiteness."""
        return torch.ones(x.shape[:-1], dtype=torch.bool, device=x.device)
