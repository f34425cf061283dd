"""Per-candidate tree masks for crossover and mutation.

Only ``forced_bernoulli_mask`` is ported so far; the per-tree crossover of
``multitreegp_tpu/ops/crossover.py`` runs inside the fused reproduction
(``core/cuda_reproduction.py``).
"""
from __future__ import annotations

import torch


def forced_bernoulli_mask(p: torch.Tensor, m: int, shape, generator: torch.Generator) -> torch.Tensor:
    """Bernoulli(p) masks over ``m`` trees with at least one success.

    ``p`` broadcasts against ``shape``; returns bool ``shape + (m,)``. An
    all-zero draw is replaced by one uniformly chosen tree (the JAX package's
    bounded version of the reference's resample-until-non-zero).
    """
    dev = generator.device
    shape = tuple(shape)
    mask = torch.rand(shape + (m,), generator=generator, device=dev) < p[..., None]
    pick = torch.randint(0, m, shape, generator=generator, device=dev)
    force = torch.nn.functional.one_hot(pick, m).to(torch.bool)
    return torch.where(mask.any(dim=-1, keepdim=True), mask, force)
