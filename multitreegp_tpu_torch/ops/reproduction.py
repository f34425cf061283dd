"""Selection, ring migration and per-island hyperparameters.

Ports of ``tournament_select``, ``migrate_ring`` and ``island_hyperparams``
of ``multitreegp_tpu/ops/reproduction.py`` (reference
``genetic_operators/reproduction.py`` and ``genetic_programming.py:113-119``).
"""
from __future__ import annotations

from typing import Tuple

import torch

from ..core.trees import TreeTensors


def tournament_select(
    fitness: torch.Tensor,
    tournament_probabilities: torch.Tensor,
    tournament_size: int,
    num: int,
    generator: torch.Generator,
) -> torch.Tensor:
    """``num`` tournament winners per island: indices ``(islands, num)``.

    Each tournament draws ``tournament_size`` candidates uniformly WITH
    replacement, ranks them by fitness (stable) and picks rank ``r`` with the
    island's probability ``tournament_probabilities[r]``.
    """
    islands, pop = fitness.shape
    dev = fitness.device
    idx = torch.randint(0, pop, (islands, num, tournament_size), generator=generator, device=dev)
    f = torch.gather(fitness, 1, idx.reshape(islands, -1)).reshape(idx.shape)
    ranked = torch.gather(idx, -1, torch.argsort(f, dim=-1, stable=True))
    probs = tournament_probabilities[:, None, :].expand(islands, num, tournament_size)
    rank = torch.multinomial(probs.reshape(-1, tournament_size), 1, generator=generator)
    return torch.gather(ranked, -1, rank.reshape(islands, num, 1))[..., 0]


def take_rows(populations: TreeTensors, idx: torch.Tensor) -> TreeTensors:
    """Per-island candidate rows: ``populations (I, P, ...)``, ``idx (I, k)``."""
    isl = torch.arange(idx.shape[0], device=idx.device)[:, None]
    return populations.map(lambda x: x[isl, idx])


def migrate_ring(
    populations: TreeTensors, fitness: torch.Tensor, migration_size: int
) -> Tuple[TreeTensors, torch.Tensor]:
    """Ring migration over the island axis: each island's worst
    ``migration_size`` candidates are replaced by the best of the island
    before it (``roll`` by one). Returns the migrated populations and
    fitness; row order is the JAX package's (receivers sorted worst first,
    the migrants in front)."""
    recv_order = torch.argsort(fitness, dim=1, descending=True, stable=True)
    send_order = torch.argsort(fitness, dim=1, stable=True)
    recv_pop = take_rows(populations, recv_order)
    send_pop = take_rows(populations, send_order).map(lambda x: torch.roll(x, 1, dims=0))
    recv_fit = torch.gather(fitness, 1, recv_order)
    send_fit = torch.roll(torch.gather(fitness, 1, send_order), 1, dims=0)
    keep = torch.arange(fitness.shape[1], device=fitness.device) < migration_size

    def mix(s, r):
        return torch.where(keep.reshape((1, -1) + (1,) * (s.ndim - 2)), s, r)

    out_pop = TreeTensors(*(mix(s, r) for s, r in zip(send_pop, recv_pop)))
    return out_pop, torch.where(keep[None, :], send_fit, recv_fit)


def island_hyperparams(
    num_islands: int,
    tournament_size: int,
    selection_pressure_factors: Tuple[float, float],
    reproduction_probability_factors: Tuple[float, float],
    crossover_probability_factors: Tuple[float, float],
    mutation_probability_factors: Tuple[float, float],
    sample_probability_factors: Tuple[float, float],
    device=None,
):
    """Per-island linspace schedules: ``(tournament_probabilities (I, t),
    reproduction_type_probabilities (I, 3), reproduction_probabilities (I,))``
    float32; tournament rank ``r`` of island ``i`` has weight
    ``sp_i * (1 - sp_i) ** r``."""

    def lin(factors):
        return torch.linspace(*factors, num_islands, dtype=torch.float32, device=device)

    sp = lin(selection_pressure_factors)[:, None]
    ranks = torch.arange(tournament_size, device=device)
    tournament_probabilities = sp * (1 - sp) ** ranks
    reproduction_type_probabilities = torch.stack(
        [lin(crossover_probability_factors), lin(mutation_probability_factors),
         lin(sample_probability_factors)],
        dim=1,
    )
    return tournament_probabilities, reproduction_type_probabilities, lin(reproduction_probability_factors)
