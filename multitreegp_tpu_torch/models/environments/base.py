"""Environment bases (PyTorch).

Ports of ``SREnvironmentBase`` and ``ControlEnvironmentBase``
(``multitreegp_tpu/models/environments/base.py``): an environment holds
static configuration and samples its data from a ``torch.Generator``; per
trajectory physics parameters are explicit tuples of tensors, ``(B,)`` per
trajectory or ``(B, T)`` series over the save grid. Every function is
batched over leading dimensions (the JAX ones are per lane under ``vmap``).

Observation noise is not ported yet: its draws are ``normal(fold_in(key,
bitcast(t)))``, and reproducing them needs JAX's generator in torch (ROADMAP
Queue 1 #15). ``f_obs`` is the noise-free observation, and raises for an
environment with ``obs_noise != 0``.
"""
from __future__ import annotations

import abc
from typing import Tuple

import torch

from ..integrators import linear_interp


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


def time_varying(param: torch.Tensor, ts: torch.Tensor, t) -> torch.Tensor:
    """A parameter at solver time ``t``: per-trajectory values ``(B,)`` pass
    through; series ``(B, T)`` are linearly interpolated (the role of
    ``diffrax.LinearInterpolation`` in the Switch/Decay modes). ``t`` is a
    float or per-lane times that broadcast against ``(B,)``."""
    if param.dim() < 2:
        return param
    return linear_interp(ts, param.transpose(0, 1), t)


class ControlEnvironmentBase(abc.ABC):
    """Controlled ODE environment. ``id`` names the device drift of
    ``csrc/control_envs.cuh`` (the environment ids of
    ``core/cuda_policy.ENV_IDS``)."""

    n_targets: int = 0

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

    def _require_noise_free(self) -> None:
        if self.obs_noise != 0.0:
            raise NotImplementedError(
                "observation noise (obs_noise != 0) is not ported yet: its draws need JAX's "
                "threefry generator in torch, ROADMAP Queue 1 #15")

    def f_obs(self, keys, t, x: torch.Tensor, params) -> torch.Tensor:
        """The observation ``C x`` of ``x (..., latent)``; ``keys``, ``t`` and
        ``params`` only matter for the noise, which is not ported yet."""
        self._require_noise_free()
        return self.obs(x)

    def obs(self, x: torch.Tensor) -> torch.Tensor:
        """Noise-free observation ``(..., n_obs)`` of ``x (..., latent)``.
        Override alongside ``obs_noisy`` (e.g. angle wrapping)."""
        return x[..., : self.n_obs]

    def obs_noisy(self, x: torch.Tensor, noise: torch.Tensor) -> torch.Tensor:
        """The observation with the additive, already scaled draw ``noise
        (..., n_obs)`` (the rows the fused kernels are given)."""
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
