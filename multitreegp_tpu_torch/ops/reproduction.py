"""Selection, the generation step without the fused kernel, ring migration
and per-island hyperparameters.

Ports of ``tournament_select``, ``make_evolve_island``, ``migrate_ring``,
``make_evolve_populations`` and ``island_hyperparams`` of
``multitreegp_tpu/ops/reproduction.py`` (reference
``genetic_operators/reproduction.py`` and ``genetic_programming.py:113-119``).
The generation step runs over all islands at once (JAX maps it over the
island axis): elitism, tournament selection, and per pair one of crossover,
mutation or a fresh sample, drawn with the island's probabilities. As JAX's
``lax.switch`` under ``vmap`` does, every branch is computed for every pair
and each pair keeps its own; the fresh samples ignore their parents.
"""
from __future__ import annotations

from typing import Callable, Tuple

import torch

from ..core.registry import FunctionSet
from ..core.trees import TreeTensors
from .crossover import crossover_candidates


def categorical(probs: torch.Tensor, generator: torch.Generator) -> torch.Tensor:
    """One category per row of ``probs (R, K)`` (weights, any positive sum):
    int64 ``(R, 1)``. The draw ``torch.multinomial(probs, 1, generator=
    generator)`` makes, an exponential race (its single-sample path): the
    same indices, and the generator left in the same state, without that
    path's host read of the weights' validity (which a CUDA graph cannot
    capture)."""
    race = torch.empty_like(probs).exponential_(1, generator=generator)
    return torch.argmax(probs / race, dim=-1, keepdim=True)


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
    rank = categorical(probs.reshape(-1, tournament_size), generator)
    return torch.gather(ranked, -1, rank.reshape(islands, num, 1))[..., 0]


def take_rows(populations: TreeTensors, idx: torch.Tensor) -> TreeTensors:
    """Per-island candidate rows: ``populations (I, P, ...)``, ``idx (I, k)``."""
    isl = torch.arange(idx.shape[0], device=idx.device)[:, None]
    return populations.map(lambda x: x[isl, idx])


def make_evolve_island(
    fset: FunctionSet,
    mutate_candidate: Callable,
    sample_candidate: Callable,
    population_size: int,
    elite_size: int,
    tournament_size: int,
):
    """Build ``evolve_island(populations (I, P, m, N), fitness (I, P),
    generator, rtp (I, 3), rp (I,), tp (I, tournament_size)) ->
    populations``, every island's generation step with its own
    hyperparameter rows. ``mutate_candidate(trees, generator,
    reproduction_probability, variable_mask)`` comes from
    :func:`~.mutation.make_mutators`, ``sample_candidate(generator, shape)``
    draws fresh candidates of batch ``shape``."""
    num_pairs = (population_size - elite_size) // 2

    def evolve_island(populations: TreeTensors, fitness: torch.Tensor, generator: torch.Generator,
                      rtp: torch.Tensor, rp: torch.Tensor, tp: torch.Tensor) -> TreeTensors:
        islands = fitness.shape[0]
        elite = take_rows(populations, torch.argsort(fitness, dim=1, stable=True)[:, :elite_size])
        left = take_rows(populations, tournament_select(fitness, tp, tournament_size, num_pairs, generator))
        right = take_rows(populations, tournament_select(fitness, tp, tournament_size, num_pairs, generator))
        repro_type = torch.multinomial(rtp, num_pairs, replacement=True, generator=generator)
        p = rp[:, None].expand(islands, num_pairs)

        cx = crossover_candidates(left, right, generator, p, fset)
        # both parents of every pair mutate independently: one batch
        both = TreeTensors(*(torch.cat([a, b], dim=1) for a, b in zip(left, right)))
        mutated = mutate_candidate(both, generator, torch.cat([p, p], dim=1), fset.variable_mask)
        fresh = sample_candidate(generator, (islands, 2 * num_pairs))
        halves = lambda t: (t.map(lambda a: a[:, :num_pairs]), t.map(lambda a: a[:, num_pairs:]))

        def pick(c, m, f):
            t = repro_type.reshape(repro_type.shape + (1,) * (c.ops.ndim - 2))
            return TreeTensors(*(torch.where(t == 0, a, torch.where(t == 1, b, d))
                                 for a, b, d in zip(c, m, f)))

        (m1, m2), (f1, f2) = halves(mutated), halves(fresh)
        c_left, c_right = pick(cx[0], m1, f1), pick(cx[1], m2, f2)
        return TreeTensors(*(torch.cat([e, a, b], dim=1) for e, a, b in zip(elite, c_left, c_right)))

    return evolve_island


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


def migration_due(islands: int, migration_period: int, generation: int) -> bool:
    """Whether ``generation`` migrates: every ``migration_period``
    generations, with more than one island."""
    return islands > 1 and (generation + 1) % migration_period == 0


def make_evolve_populations(
    evolve_island: Callable,
    migration_period: int,
    migration_size: int,
    reproduction_type_probabilities: torch.Tensor,  # (islands, 3)
    reproduction_probabilities: torch.Tensor,  # (islands,)
    tournament_probabilities: torch.Tensor,  # (islands, tournament_size)
):
    """``evolve(populations, fitness, generator, generation) -> populations``:
    ring migration every ``migration_period`` generations (more than one
    island), then :func:`make_evolve_island`'s step (reference
    ``evolve_populations``, :133-176)."""

    def evolve_populations(populations: TreeTensors, fitness: torch.Tensor,
                           generator: torch.Generator, generation: int) -> TreeTensors:
        if migration_due(fitness.shape[0], migration_period, generation):
            populations, fitness = migrate_ring(populations, fitness, migration_size)
        return evolve_island(populations, fitness, generator, reproduction_type_probabilities,
                             reproduction_probabilities, tournament_probabilities)

    return evolve_populations


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
