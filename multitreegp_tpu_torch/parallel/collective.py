"""The generation step with its communication written out, over the ranks of
a mesh (``torch.distributed``).

Port of ``multitreegp_tpu/parallel/collective.py``. Every rank holds its
contiguous block of ``k = islands / W`` islands (``parallel.mesh``) and runs
the same program on it:

* each rank evaluates and evolves its islands on its own device (the fused
  kernels #1 and #2, the interpreter kernels #8/#9 in constant
  optimisation), independently of the others;
* ring migration sends ONE island's migrant block per rank boundary, the
  last local island's to rank ``r + 1``, as one ``batch_isend_irecv`` (the
  role of JAX's ``ppermute``); the other islands shift locally, and at one
  rank the ring is a local roll;
* the global best is an ``all_gather`` of each rank's best and a
  ``broadcast`` of the winner's candidate;
* constant optimisation gathers each rank's local top-k, refines the merged
  winners in slices, one per rank, and sends each refined candidate back to
  the rank that owns it.

Migration places the candidates as ``ops.reproduction.migrate_ring`` does
(each island sorted worst first, the migrants in front), so a sharded run
of any ``W`` evolves the same populations as the unsharded ring wherever
the ranks' random draws agree; at ``W = 1`` it is the unsharded step.
Every sort is stable, as JAX's ``argsort``.
"""
from __future__ import annotations

from typing import Callable, List, Sequence

import torch
import torch.distributed as dist

from ..core.trees import TreeTensors
from ..ops.reproduction import take_rows
from .mesh import Mesh, all_gather_cat


def _pack(tensors: Sequence[torch.Tensor]) -> torch.Tensor:
    """One flat int32 buffer of int32 and float32 tensors (their bits), so a
    block crosses a rank boundary as one message."""
    return torch.cat([t.contiguous().view(torch.int32).reshape(-1) for t in tensors])


def _unpack(buf: torch.Tensor, like: Sequence[torch.Tensor]) -> List[torch.Tensor]:
    out, at = [], 0
    for t in like:
        n = t.numel()
        out.append(buf[at:at + n].view(t.dtype).reshape(t.shape))
        at += n
    return out


def _sorted_blocks(populations: TreeTensors, fitness: torch.Tensor, migration_size: int):
    """Each island's migrants: its best ``migration_size`` candidates (the
    send block, best first) and their fitness."""
    send_order = torch.argsort(fitness, dim=1, stable=True)[:, :migration_size]
    return take_rows(populations, send_order), torch.gather(fitness, 1, send_order)


def _ring_shift_islands(blocks: Sequence[torch.Tensor], mesh: Mesh) -> List[torch.Tensor]:
    """Shift island-major tensors ``(local_islands, ...)`` by +1 along the
    global island ring: the last local island's entry goes to the next rank
    and the previous rank's comes in front; the rest shift locally."""
    if mesh.size == 1 or all(b.numel() == 0 for b in blocks):
        return [torch.roll(b, 1, dims=0) for b in blocks]
    boundary = [b[-1:] for b in blocks]
    send = _pack(boundary)
    recv = torch.empty_like(send)
    ops = [dist.P2POp(dist.isend, send, (mesh.rank + 1) % mesh.size, mesh.group),
           dist.P2POp(dist.irecv, recv, (mesh.rank - 1) % mesh.size, mesh.group)]
    for req in dist.batch_isend_irecv(ops):
        req.wait()
    received = _unpack(recv, boundary)
    return [torch.cat([r, b[:-1]]) for r, b in zip(received, blocks)]


def _apply_migration(populations: TreeTensors, fitness: torch.Tensor, recv_pop: TreeTensors,
                     recv_fit: torch.Tensor, do_migrate: bool, migration_size: int):
    """Replace each island's worst ``migration_size`` candidates with the
    received blocks (when ``do_migrate``): the island sorted worst first,
    the received migrants in front, as ``migrate_ring``."""
    if not do_migrate:
        return populations, fitness
    worst_first = torch.argsort(fitness, dim=1, descending=True, stable=True)
    kept = take_rows(populations, worst_first)
    kept_fit = torch.gather(fitness, 1, worst_first)
    m = migration_size
    pop = TreeTensors(*(torch.cat([r, k[:, m:]], dim=1) for r, k in zip(recv_pop, kept)))
    return pop, torch.cat([recv_fit, kept_fit[:, m:]], dim=1)


def _collective_step(local_step: Callable, mesh: Mesh, migration_period: int, migration_size: int,
                     reproduction_type_probabilities, reproduction_probabilities,
                     tournament_probabilities):
    def step(populations: TreeTensors, fitness: torch.Tensor, generator: torch.Generator,
             generation: int) -> TreeTensors:
        local = fitness.shape[0]
        block = slice(mesh.rank * local, (mesh.rank + 1) * local)
        if local * mesh.size > 1 and (generation + 1) % migration_period == 0:
            send_pop, send_fit = _sorted_blocks(populations, fitness, migration_size)
            *recv, recv_fit = _ring_shift_islands([*send_pop, send_fit], mesh)
            populations, fitness = _apply_migration(populations, fitness, TreeTensors(*recv),
                                                    recv_fit, True, migration_size)
        return local_step(populations, fitness, generator,
                          reproduction_type_probabilities[block], reproduction_probabilities[block],
                          tournament_probabilities[block])

    return step


def make_evolve_populations_collective(
    evolve_island: Callable,
    mesh: Mesh,
    migration_period: int,
    migration_size: int,
    reproduction_type_probabilities: torch.Tensor,  # (islands, 3)
    reproduction_probabilities: torch.Tensor,  # (islands,)
    tournament_probabilities: torch.Tensor,  # (islands, tournament_size)
):
    """The sharded generation step around the per-tree operators
    (``ops/reproduction.make_evolve_island``): ``step(populations, fitness,
    generator, generation) -> populations``, each of this rank's block of
    islands, ring migration every ``migration_period`` generations (more
    than one island in all), then the island step with the block's
    hyperparameter rows and this rank's generator."""
    return _collective_step(evolve_island, mesh, migration_period, migration_size,
                            reproduction_type_probabilities, reproduction_probabilities,
                            tournament_probabilities)


def make_evolve_populations_collective_fused(
    reproduce_islands: Callable,
    mesh: Mesh,
    migration_period: int,
    migration_size: int,
    reproduction_type_probabilities: torch.Tensor,
    reproduction_probabilities: torch.Tensor,
    tournament_probabilities: torch.Tensor,
):
    """The same around the fused reproduction (``ops/fused_evolve.
    make_reproduce_islands``): each rank launches kernel #2 on its own
    islands' lanes."""
    return _collective_step(reproduce_islands, mesh, migration_period, migration_size,
                            reproduction_type_probabilities, reproduction_probabilities,
                            tournament_probabilities)


def make_sharded_evaluator(eval_islands: Callable, mesh: Mesh):
    """``evaluate(populations) -> fitness``, island-major, of this rank's
    block of islands: ``eval_islands`` on the rank's own device (its
    kernels launched on its islands only), no communication."""

    def evaluate(populations: TreeTensors) -> torch.Tensor:
        fitness = eval_islands(populations)
        if fitness.shape[0] != populations.ops.shape[0]:
            raise ValueError("the evaluator must return island-major fitness")
        return fitness

    return evaluate


def evaluate_flat_sharded(eval_flat: Callable, flat: TreeTensors, mesh: Mesh) -> torch.Tensor:
    """Fitness ``(n,)`` of all ``n`` flattened candidates, on every rank: each
    rank evaluates its contiguous slice of ``ceil(n / W)`` (the last ones
    fewer) and ``all_gather`` puts the fitness back together. For island
    counts that do not divide over the ranks."""
    n = flat.ops.shape[0]
    chunk = -(-n // mesh.size)
    lo, hi = min(mesh.rank * chunk, n), min((mesh.rank + 1) * chunk, n)
    mine = eval_flat(flat.map(lambda x: x[lo:hi]))
    padded = torch.full((chunk,), float("inf"), dtype=mine.dtype, device=mine.device)
    padded[: hi - lo] = mine
    return all_gather_cat(padded, mesh)[:n]


def make_constant_opt_collective(optimise: Callable, mesh: Mesh, top_k: int):
    """Distributed top-k constant optimisation: ``step(populations, fitness)
    -> (populations, fitness)`` of this rank's block.

    * each rank contributes its local top ``min(k, local_pop)`` candidates
      (the exact global top-k lies in their union) through ``all_gather``;
    * the merged top ``ceil(k / W) * W`` (capped at W times the local pool,
      a superset of the top-k: refinement never hurts) is computed on every
      rank;
    * each rank refines its slice of the winners (``optimise(candidates) ->
      (fitness, candidates)``);
    * the refined slices are gathered, and each rank writes back only the
      winners it owns.
    """

    def step(populations: TreeTensors, fitness: torch.Tensor):
        islands = fitness.shape[0]
        flat_fit = fitness.reshape(-1)
        flat_pop = populations.map(lambda x: x.reshape((-1,) + x.shape[2:]))
        n_local = flat_fit.shape[0]
        k_contrib = min(top_k, n_local)
        # each rank's share, capped at the local pool: each contributes only
        # k_contrib candidates, so an uncapped share would make the winners
        # outnumber the gathered pool
        k_local = min(-(-top_k // mesh.size), n_local)
        k_pad = k_local * mesh.size

        local_idx = torch.argsort(flat_fit, stable=True)[:k_contrib]
        local_cands = flat_pop[local_idx]
        gath_fit = all_gather_cat(flat_fit[local_idx], mesh)  # (W * kc,)
        gath_idx = all_gather_cat(local_idx, mesh)
        gath = TreeTensors(*(all_gather_cat(x, mesh) for x in local_cands))
        order = torch.argsort(gath_fit, stable=True)[:k_pad]  # winners first
        winners = gath[order]
        mine = winners.map(lambda x: x[mesh.rank * k_local:(mesh.rank + 1) * k_local])
        opt_fit, opt_cands = optimise(mine)

        all_fit = all_gather_cat(opt_fit, mesh)
        all_cands = TreeTensors(*(all_gather_cat(x, mesh) for x in opt_cands))
        owned = (order // k_contrib) == mesh.rank  # gathered row -> owning rank
        tgt = gath_idx[order][owned]
        flat_pop = TreeTensors(*(x.clone() for x in flat_pop))
        for x, o in zip(flat_pop, all_cands):
            x[tgt] = o[owned]
        flat_fit = flat_fit.clone()
        flat_fit[tgt] = all_fit[owned]
        pop = flat_pop.map(lambda x: x.reshape((islands, -1) + x.shape[1:]))
        return pop, flat_fit.reshape(islands, -1)

    return step


def global_best(fitness: torch.Tensor, populations: TreeTensors, mesh: Mesh):
    """``(best fitness, best candidate)`` over every rank's islands, on every
    rank: ``all_gather`` of each rank's best, then a ``broadcast`` of the
    winner's candidate from its rank. Ties go to the lowest rank, then the
    lowest index: the unsharded ``argmin``."""
    flat_fit = fitness.reshape(-1)
    idx = torch.argmin(flat_fit)
    cand = populations.map(lambda x: x.reshape((-1,) + x.shape[2:])[idx])
    if mesh.size == 1:
        return flat_fit[idx], cand
    all_best = all_gather_cat(flat_fit[idx].reshape(1), mesh)
    winner = int(torch.argmin(all_best))
    buf = _pack(list(cand))
    dist.broadcast(buf, src=winner, group=mesh.group)
    return all_best[winner], TreeTensors(*_unpack(buf, list(cand)))
