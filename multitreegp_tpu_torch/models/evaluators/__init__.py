from typing import Tuple

import torch

from .dynamic_policy import DynamicPolicyEvaluator
from .sr import SREvaluator, generate_sr_data, sr_trajectories
from .static_policy import StaticPolicyEvaluator


def generate_control_data(env, generator: torch.Generator, ts: torch.Tensor, batch_size: int = 16,
                          param_mode: str = "Constant") -> Tuple:
    """A control task batch (the role of the notebooks' ``get_data``): the
    evaluators' data tuple ``(x0, ts, targets, process_noise_keys,
    obs_noise_keys, params)``. The keys are ``(B, 2)`` uint32-valued int64
    tensors in JAX's raw key layout, drawn from ``generator``: the noise of
    trajectory ``b`` is drawn from its keys (``core/prng.py``)."""
    x0, targets = env.sample_init_states(batch_size, generator)
    dev = generator.device
    keys = lambda: torch.randint(0, 2**32, (batch_size, 2), generator=generator, device=dev)
    process_noise_keys, obs_noise_keys = keys(), keys()
    params = env.prepare_params(env.sample_params(batch_size, param_mode, ts, generator), ts)
    return x0, ts, targets, process_noise_keys, obs_noise_keys, params


__all__ = ["DynamicPolicyEvaluator", "SREvaluator", "StaticPolicyEvaluator",
           "generate_control_data", "generate_sr_data", "sr_trajectories"]
