"""Throughput accounting: the node-evaluation count behind node-evals/s
(port of ``multitreegp_tpu/utils/metrics.node_evals_per_evaluation``)."""
from __future__ import annotations

RK_STAGES = {"euler": 1, "heun": 2, "rk4": 4}


def node_evals_per_evaluation(
    population_size: int,
    num_trees: int,
    max_nodes: int,
    batch_size: int,
    num_save_points: int,
    substeps: int,
    method: str = "rk4",
) -> int:
    """Interpreter row-steps of one population evaluation: lanes x max_nodes
    per tree evaluation, ``(T-1) x substeps x stages`` drift calls."""
    drift_calls = (num_save_points - 1) * substeps * RK_STAGES[method]
    lanes = population_size * batch_size * num_trees
    return int(drift_calls * lanes * max_nodes)
