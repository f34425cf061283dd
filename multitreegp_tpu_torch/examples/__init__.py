"""The reference notebooks as examples of the port, each runnable with
``python -m multitreegp_tpu_torch.examples.<name>``: ``symbolic_regression``
(Van der Pol), ``static_policy`` and ``dynamic_policy`` (Acrobot swing-up).
Each module has ``build`` (the notebook's configuration) and ``main`` (the
evolution loop); :func:`run` is the loop they share."""
from __future__ import annotations

from typing import Callable, Optional, Tuple

import torch

from ..core.trees import TreeTensors
from ..utils.profiling import PhaseTimer

# log(generation, best fitness, best candidate rendered)
LogFn = Callable[[int, float, str], None]


def require_device(device) -> torch.device:
    """``device`` as a ``torch.device``; raises when it is a CUDA device and
    no GPU is present (the examples never fall back to the CPU)."""
    device = torch.device(device)
    if device.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError("no CUDA device: this example runs on an NVIDIA GPU (--device cpu runs "
                           "the plain PyTorch versions instead)")
    return device


def run(strategy, data, generator: torch.Generator, fused: bool = False,
        timer: Optional[PhaseTimer] = None,
        log: Optional[LogFn] = None) -> Tuple[torch.Tensor, TreeTensors]:
    """Evolve for ``strategy.num_generations`` generations from a fresh
    population drawn from ``generator``: the host loop
    (``evaluate_population`` then ``evolve``, timed as the phases
    ``evaluate`` and ``evolve`` of ``timer``), or ``fit()`` (``fused``,
    timed as one phase ``fit``). ``log`` gets every fifth generation's best
    and the last. Returns the best fitness per generation ``(G,)`` and the
    last populations."""
    timer = timer if timer is not None else PhaseTimer()
    g = strategy.num_generations
    shown = [gen for gen in range(g) if gen % 5 == 0 or gen == g - 1]
    if fused:
        with timer.phase("fit", sync=data):
            best_fit, best_sol, populations, _ = strategy.fit(generator, data)
        if log is not None:
            for gen in shown:
                log(gen, float(best_fit[gen]), strategy.to_string(best_sol[gen]))
        return best_fit, populations
    populations = strategy.initialize_population(generator)
    for gen in range(g):
        with timer.phase("evaluate", sync=populations):
            fitness, populations = strategy.evaluate_population(populations, data)
        with timer.phase("evolve", sync=populations):
            populations = strategy.evolve(populations, fitness, generator)
        if log is not None and gen in shown:
            best_fit, best_sol = strategy.get_statistics(gen)
            log(gen, float(best_fit), strategy.to_string(best_sol))
    return strategy.best_fitnesses, populations
