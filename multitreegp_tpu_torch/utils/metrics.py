"""Throughput accounting: the node-evaluation counts behind node-evals/s
(port of ``multitreegp_tpu/utils/metrics.node_evals_per_evaluation`` and of
the adaptive work counts in ``bench.py``)."""
from __future__ import annotations

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
