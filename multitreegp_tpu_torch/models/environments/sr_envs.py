"""Symbolic-regression environments (PyTorch ports of
``multitreegp_tpu/models/environments/sr_envs.py``), with the same constants
and the same expression order in every drift."""
from __future__ import annotations

import torch

from .base import SREnvironmentBase


class LotkaVolterra(SREnvironmentBase):
    """Predator-prey dynamics."""

    def __init__(self, process_noise: float = 0.0, obs_noise: float = 0.0, n_obs: int = 2):
        super().__init__(process_noise, obs_noise, n_var=2, n_obs=n_obs)
        self.alpha, self.beta, self.delta, self.gamma = 1.1, 0.4, 0.1, 0.4

    def sample_init_states(self, batch_size: int, generator: torch.Generator) -> torch.Tensor:
        u = torch.rand((batch_size, 2), generator=generator, device=generator.device)
        return 5.0 + u * 10.0

    def drift(self, t, x):
        prey, pred = x[..., 0], x[..., 1]
        return torch.stack(
            [
                self.alpha * prey - self.beta * prey * pred,
                self.delta * prey * pred - self.gamma * pred,
            ],
            dim=-1,
        )


class LorenzAttractor(SREnvironmentBase):
    """Chaotic Lorenz system."""

    def __init__(self, process_noise: float = 0.0, obs_noise: float = 0.0, n_obs: int = 3):
        super().__init__(process_noise, obs_noise, n_var=3, n_obs=n_obs)
        self.sigma, self.rho, self.beta = 10.0, 28.0, 8.0 / 3.0

    def sample_init_states(self, batch_size: int, generator: torch.Generator) -> torch.Tensor:
        z = torch.randn((batch_size, 3), generator=generator, device=generator.device)
        return 1.0 + 1.0 * z

    def drift(self, t, x):
        x0, x1, x2 = x[..., 0], x[..., 1], x[..., 2]
        return torch.stack(
            [self.sigma * (x1 - x0), x0 * (self.rho - x2) - x1, x0 * x1 - self.beta * x2],
            dim=-1,
        )


class VanDerPolOscillator(SREnvironmentBase):
    """Van der Pol oscillator, mu = 1: the SymbolicRegression notebook's
    benchmark system."""

    def __init__(self, process_noise: float = 0.0, obs_noise: float = 0.0, n_obs: int = 2):
        super().__init__(process_noise, obs_noise, n_var=2, n_obs=n_obs)
        self.mu = 1.0

    def sample_init_states(self, batch_size: int, generator: torch.Generator) -> torch.Tensor:
        z = torch.randn((batch_size, 2), generator=generator, device=generator.device)
        return 0.0 + 1.0 * z

    def drift(self, t, x):
        x0, x1 = x[..., 0], x[..., 1]
        return torch.stack([x1, self.mu * (1.0 - x0**2) * x1 - x0], dim=-1)
