"""Observability: population statistics, and the node-evaluation counts
behind node-evals/s (port of ``multitreegp_tpu/utils/metrics.py`` and of the
adaptive work counts in ``bench.py``)."""
from __future__ import annotations

from typing import Dict

import torch

from ..core.trees import TreeTensors, tree_sizes

_HASH_MIX = 1000003
_U32 = 0xFFFFFFFF


def population_stats(populations: TreeTensors, fitness: torch.Tensor) -> Dict[str, torch.Tensor]:
    """Fitness, size and diversity summary of ``populations`` (batch ``(...,
    m)``, e.g. ``(islands, pop, m)``) and their ``fitness`` (``(...)``): 0-d
    float32 tensors ``fitness_min``, ``fitness_median`` (the mean of the two
    middle values at an even count, as ``jnp.median``), ``fitness_mean``,
    ``size_mean`` and ``size_max`` (rows per candidate) and
    ``unique_fraction``: distinct hashes of each candidate's ``m * N``
    opcodes over the number of candidates. The hash is JAX's ``uint32``
    recurrence ``h = h * 1000003 + op``, kept in int64 and masked to 32 bits
    after each step (``h < 2**32`` times 1000003 stays below ``2**52``)."""
    flat_fit = fitness.reshape(-1)
    sizes = tree_sizes(populations).sum(dim=-1).reshape(-1).to(torch.float32)
    ops = populations.ops.reshape(-1, populations.ops.shape[-2] * populations.ops.shape[-1])
    ops = ops.to(torch.int64) & _U32
    h = torch.zeros(ops.shape[0], dtype=torch.int64, device=ops.device)
    for i in range(ops.shape[1]):
        h = (h * _HASH_MIX + ops[:, i]) & _U32
    k = flat_fit.numel()
    ordered = torch.sort(flat_fit).values
    mid = (ordered[(k - 1) // 2] + ordered[k // 2]) * 0.5
    mid = torch.where(torch.isnan(flat_fit).any(), float("nan"), mid)  # as jnp.median
    unique = torch.tensor(float(torch.unique(h).numel()), device=h.device)
    return {
        "fitness_min": flat_fit.min(),
        "fitness_median": mid,
        "fitness_mean": _mean(flat_fit),
        "size_mean": _mean(sizes),
        "size_max": sizes.max(),
        "unique_fraction": unique * _reciprocal(h.numel(), unique.device),
    }


def _reciprocal(n: int, device) -> torch.Tensor:
    """``1 / n`` rounded to float32: XLA's CPU backend divides by a constant
    as a multiplication by its reciprocal, so ``jnp.mean`` does."""
    return torch.tensor(1.0 / n, dtype=torch.float32, device=device)


def _mean(x: torch.Tensor) -> torch.Tensor:
    """``jnp.mean`` of a float32 vector: the sum times ``1 / n`` (the sum's
    order is PyTorch's, not XLA's: equal wherever the sum is exact)."""
    return x.sum() * _reciprocal(x.numel(), x.device)


RK_STAGES = {"euler": 1, "heun": 2, "rk4": 4}
# tree evaluations per attempted adaptive step: the stages after the first,
# which the first-same-as-last carry supplies
ADAPTIVE_DRIFTS_PER_STEP = {"dopri5": 6, "bosh3": 3}


def node_evals_per_evaluation(
    population_size: int,
    num_trees: int,
    max_nodes: int,
    batch_size: int,
    num_save_points: int,
    substeps: int,
    method: str = "rk4",
    replay_trees: int | None = None,
) -> int:
    """Interpreter row-steps of one population evaluation: lanes x max_nodes
    per tree evaluation, ``(T-1) x substeps x stages`` drift calls, plus the
    policy evaluators' control replay at the T save points
    (``replay_trees`` trees per lane; None = no replay)."""
    drift_calls = (num_save_points - 1) * substeps * RK_STAGES[method]
    lanes = population_size * batch_size * num_trees
    total = drift_calls * lanes * max_nodes
    if replay_trees is not None:
        total += num_save_points * population_size * batch_size * replay_trees * max_nodes
    return int(total)


def adaptive_node_evals(lane_steps, method: str, num_trees: int, max_nodes: int) -> int:
    """Interpreter row-steps of one adaptive evaluation from its attempted
    steps per lane (``lane_steps``, any shape, e.g. ``(P, B)``): per lane
    ``steps x drifts per step + 1`` drift calls (the ``+ 1`` is the up-front
    evaluation the first-same-as-last carry starts from), each ``num_trees x
    max_nodes`` rows. The JAX bench counts steps per lane tile, as a TPU tile
    steps while any of its lanes is active; a GPU thread stops when its own
    lane is done, so the count is taken per lane."""
    drifts = int(lane_steps.sum()) * ADAPTIVE_DRIFTS_PER_STEP[method] + lane_steps.numel()
    return drifts * num_trees * max_nodes


def policy_adaptive_node_evals(lane_steps, method: str, num_trees: int, max_nodes: int,
                               num_save_points: int) -> int:
    """Interpreter row-steps of one adaptive policy evaluation (kernel #7)
    from its attempted steps per lane (``lane_steps``, e.g. ``(P, B)``): per
    lane ``steps x drifts per step`` drift calls, the one up-front drift,
    and a control evaluation at each of the T save points, each
    ``num_trees x max_nodes`` rows (``bench.py``'s count, taken per lane)."""
    lanes = lane_steps.numel()
    drifts = int(lane_steps.sum()) * ADAPTIVE_DRIFTS_PER_STEP[method] + lanes
    return (drifts + lanes * num_save_points) * num_trees * max_nodes
