"""Symbolic-regression environment base (PyTorch).

Port of ``SREnvironmentBase`` (``multitreegp_tpu/models/environments/
base.py``): an environment holds static configuration, samples initial
states from a ``torch.Generator`` and defines a batched drift. The control
environments are not ported yet (ROADMAP Queue 1 #16).
"""
from __future__ import annotations

import abc

import torch


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
