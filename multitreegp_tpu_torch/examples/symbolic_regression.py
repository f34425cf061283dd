"""Symbolic regression of the Van der Pol oscillator, on the port.

The reference's ``examples/SymbolicRegression.ipynb`` as the JAX package's
``examples/symbolic_regression.py`` runs it: 100 candidates x 10 islands,
100 generations, operators ``+ - * /`` at the notebook's probabilities (0.5,
0.1, 0.5, 0.1), ``layer_sizes=[2]``, ``max_nodes=30``, trees grown to depth
4, 16 trajectories of 100 saved points (``arange(0, 20, 0.2)``), RK4 with 4
substeps (kernel #1, reproduction by kernel #2). ``--fused`` runs the same
through ``fit()``; ``--adaptive`` takes the notebook's own solver, Dormand-
Prince with ``rtol=atol=1e-6`` and a whole-solve budget of 500 steps (kernel
#5). Run::

    python -m multitreegp_tpu_torch.examples.symbolic_regression [--device cpu]
"""
from __future__ import annotations

import argparse

import torch

from .. import GeneticProgramming
from ..core.registry import default_sr_operators
from ..models.environments import VanDerPolOscillator
from ..models.evaluators import SREvaluator, generate_sr_data
from ..utils.profiling import PhaseTimer
from . import require_device, run


def build(seed: int = 0, device="cuda", generations: int = 100, population: int = 100,
          islands: int = 10, adaptive: bool = False):
    """``(strategy, data, generator)`` of the notebook's configuration: the
    data drawn from ``generator`` (seeded with ``seed``), which then draws
    the population and the evolution. The sizes (``generations``,
    ``population``, ``islands``) default to the notebook's."""
    device = require_device(device)
    generator = torch.Generator(device=device).manual_seed(seed)
    env = VanDerPolOscillator(process_noise=0.0, obs_noise=0.0)
    ts = torch.arange(0.0, 20.0, 0.2, device=device)  # 100 save points at T = 20
    data = generate_sr_data(env, generator, ts, batch_size=16)
    evaluator = (SREvaluator(method="adaptive", adaptive_method="dopri5", rtol=1e-6, atol=1e-6,
                             adaptive_budget=500)
                 if adaptive else SREvaluator(substeps=4))
    strategy = GeneticProgramming(
        num_generations=generations,
        population_size=population,
        fitness_function=evaluator,
        operator_list=default_sr_operators(),
        variable_list=[["x0", "x1"]],
        layer_sizes=[2],
        num_populations=islands,
        max_init_depth=4,
        max_nodes=30,
        device=device,
    )
    return strategy, data, generator


def main(generations: int = 100, population: int = 100, islands: int = 10, seed: int = 0,
         fused: bool = False, adaptive: bool = False, device="cuda",
         timer: PhaseTimer | None = None, verbose: bool = True) -> torch.Tensor:
    """Run the notebook; returns the best fitness per generation (CPU)."""
    strategy, data, generator = build(seed, device, generations, population, islands, adaptive)
    log = (lambda gen, best, expr: print(f"gen {gen:4d}  best fitness {best:.6f}  {expr}")) \
        if verbose else None
    history, _ = run(strategy, data, generator, fused=fused, timer=timer, log=log)
    return history.cpu()


if __name__ == "__main__":
    p = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    p.add_argument("--generations", type=int, default=100)
    p.add_argument("--population", type=int, default=100)
    p.add_argument("--islands", type=int, default=10)
    p.add_argument("--seed", type=int, default=0)
    p.add_argument("--fused", action="store_true", help="run the whole evolution through fit()")
    p.add_argument("--adaptive", action="store_true",
                   help="the notebook's Dormand-Prince solver with step control (kernel #5)")
    p.add_argument("--device", default="cuda", help="cuda (default) or cpu")
    a = p.parse_args()
    t = PhaseTimer()
    main(a.generations, a.population, a.islands, a.seed, a.fused, a.adaptive, a.device, t)
    print(t)
