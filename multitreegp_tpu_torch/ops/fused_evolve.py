"""Generation step backed by the fused reproduction kernel.

Counterpart of ``multitreegp_tpu/ops/pallas_evolve.py``: selection, elitism,
migration gating and the per-pair branch draws run in plain PyTorch (small
tensor ops); all tree surgery of a generation is one call of
``core.cuda_reproduction.reproduce_pairs`` (one kernel launch on CUDA).

Per pair, the branch is crossover / mutation / fresh sample with the
island's probabilities; per tree slot, forced-Bernoulli masks decide which
trees cross or mutate. They are encoded as per-lane actions: ``cxflag`` for
crossover, otherwise ``act`` 1 = mutate, 2 = fresh, 0 = copy the parent.
"""
from __future__ import annotations

import torch

from ..core import tile_surgery as ts
from ..core.cuda_reproduction import reproduce_pairs
from ..core.registry import FunctionSet
from ..core.trees import TreeTensors
from .crossover import forced_bernoulli_mask
from .reproduction import make_evolve_populations, take_rows, tournament_select


def make_reproduce_islands(
    fset: FunctionSet,
    population_size: int,
    elite_size: int,
    tournament_size: int,
    max_nodes: int,
    max_init_depth: int,
    coefficient_sd: float = 1.0,
):
    """Build ``reproduce(populations, fitness, generator, rtp, rp, tp) ->
    populations``: elitism + tournament selection + the fused reproduction
    over all islands. ``rtp`` (I, 3), ``rp`` (I,), ``tp`` (I, tournament_size)
    are the per-island hyperparameter rows."""
    num_pairs = (population_size - elite_size) // 2
    cfg = ts.make_config(fset, max_nodes, max_init_depth, coefficient_sd)
    m = fset.num_trees

    def reproduce(populations: TreeTensors, fitness: torch.Tensor, generator: torch.Generator,
                  rtp: torch.Tensor, rp: torch.Tensor, tp: torch.Tensor) -> TreeTensors:
        islands = fitness.shape[0]
        elite = take_rows(populations, torch.argsort(fitness, dim=1, stable=True)[:, :elite_size])
        left = take_rows(populations, tournament_select(fitness, tp, tournament_size, num_pairs, generator))
        right = take_rows(populations, tournament_select(fitness, tp, tournament_size, num_pairs, generator))

        repro_type = torch.multinomial(rtp, num_pairs, replacement=True, generator=generator)
        pair_shape = (islands, num_pairs)
        p = rp[:, None].expand(pair_shape)
        cx_mask = forced_bernoulli_mask(p, m, pair_shape, generator)
        m1 = forced_bernoulli_mask(p, m, pair_shape, generator)
        m2 = forced_bernoulli_mask(p, m, pair_shape, generator)
        is_cx = (repro_type == 0)[..., None]
        is_mut = (repro_type == 1)[..., None]
        fresh = torch.where((repro_type == 2)[..., None], 2, 0)
        cxflag = is_cx & cx_mask
        act1 = torch.where(is_mut & m1, 1, 0) + fresh
        act2 = torch.where(is_mut & m2, 1, 0) + fresh

        flat = lambda x: x.reshape((islands * num_pairs,) + x.shape[2:])
        c1, c2 = reproduce_pairs(
            left.map(flat), right.map(flat), flat(cxflag), flat(act1), flat(act2),
            fset, cfg, generator,
        )
        unflat = lambda x: x.reshape((islands, num_pairs) + x.shape[1:])
        c1, c2 = c1.map(unflat), c2.map(unflat)
        return TreeTensors(*(torch.cat([e, a, b], dim=1) for e, a, b in zip(elite, c1, c2)))

    return reproduce


def make_evolve_populations_fused(
    fset: FunctionSet,
    population_size: int,
    elite_size: int,
    tournament_size: int,
    migration_period: int,
    migration_size: int,
    reproduction_type_probabilities: torch.Tensor,  # (islands, 3)
    reproduction_probabilities: torch.Tensor,  # (islands,)
    tournament_probabilities: torch.Tensor,  # (islands, tournament_size)
    max_nodes: int,
    max_init_depth: int,
    coefficient_sd: float = 1.0,
):
    """``evolve(populations, fitness, generator, generation) -> populations``:
    ring migration every ``migration_period`` generations, then
    :func:`make_reproduce_islands`."""
    reproduce = make_reproduce_islands(
        fset, population_size, elite_size, tournament_size, max_nodes, max_init_depth, coefficient_sd,
    )
    return make_evolve_populations(reproduce, migration_period, migration_size,
                                   reproduction_type_probabilities, reproduction_probabilities,
                                   tournament_probabilities)
