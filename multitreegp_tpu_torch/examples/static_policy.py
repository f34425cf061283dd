"""A static symbolic feedback controller for the Acrobot swing-up, on the port.

The reference's ``examples/StaticPolicy.ipynb`` as the JAX package's
``examples/static_policy.py`` runs it: 100 policies x 5 islands, 50
generations, operators ``+ - * sin cos``, one tree per control reading the
observations ``y0..y3``, ``max_nodes=30``, ``size_parsimony=1``, 16 rollouts
of 250 saved points (``arange(0, 50, 0.2)``), RK4 with 4 substeps (kernel
#6). ``--adaptive`` takes the notebook's own solver, Dormand-Prince with
``rtol=atol=1e-4`` and 8 steps per save interval (kernel #7). Run::

    python -m multitreegp_tpu_torch.examples.static_policy [--device cpu]
"""
from __future__ import annotations

import argparse

import torch

from .. import GeneticProgramming
from ..models.environments import Acrobot
from ..models.evaluators import StaticPolicyEvaluator, generate_control_data
from ..utils.profiling import PhaseTimer
from . import require_device, run

OPERATORS = [
    ("+", torch.add, 2),
    ("-", torch.subtract, 2),
    ("*", torch.multiply, 2),
    ("sin", torch.sin, 1),
    ("cos", torch.cos, 1),
]


def build(seed: int = 0, device="cuda", generations: int = 50, population: int = 100,
          islands: int = 5, adaptive: bool = False):
    """``(strategy, data, generator)`` of the notebook's configuration: the
    data drawn from ``generator`` (seeded with ``seed``), which then draws
    the population and the evolution. The sizes (``generations``,
    ``population``, ``islands``) default to the notebook's."""
    device = require_device(device)
    generator = torch.Generator(device=device).manual_seed(seed)
    env = Acrobot(process_noise=0.0, obs_noise=0.0)
    ts = torch.arange(0.0, 50.0, 0.2, device=device)  # 250 save points at T = 50
    data = generate_control_data(env, generator, ts, batch_size=16)
    evaluator = (StaticPolicyEvaluator(env, method="adaptive", adaptive_method="dopri5", rtol=1e-4,
                                       atol=1e-4, substeps=8)
                 if adaptive else StaticPolicyEvaluator(env, substeps=4))
    strategy = GeneticProgramming(
        num_generations=generations,
        population_size=population,
        fitness_function=evaluator,
        operator_list=OPERATORS,
        # the policy sees the wrapped observations (Acrobot has no target)
        variable_list=[[f"y{i}" for i in range(env.n_obs)]],
        layer_sizes=[env.n_control],
        num_populations=islands,
        max_init_depth=4,
        max_nodes=30,
        size_parsimony=1.0,
        device=device,
    )
    return strategy, data, generator


def main(generations: int = 50, population: int = 100, islands: int = 5, seed: int = 0,
         adaptive: bool = False, device="cuda", timer: PhaseTimer | None = None,
         verbose: bool = True) -> torch.Tensor:
    """Run the notebook; returns the best fitness per generation (CPU)."""
    strategy, data, generator = build(seed, device, generations, population, islands, adaptive)
    log = (lambda gen, best, expr: print(f"gen {gen:4d}  best fitness {best:.4f}  u = {expr}")) \
        if verbose else None
    history, _ = run(strategy, data, generator, timer=timer, log=log)
    return history.cpu()


if __name__ == "__main__":
    p = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    p.add_argument("--generations", type=int, default=50)
    p.add_argument("--population", type=int, default=100)
    p.add_argument("--islands", type=int, default=5)
    p.add_argument("--seed", type=int, default=0)
    p.add_argument("--adaptive", action="store_true",
                   help="the notebook's Dormand-Prince solver with step control (kernel #7)")
    p.add_argument("--device", default="cuda", help="cuda (default) or cpu")
    a = p.parse_args()
    t = PhaseTimer()
    main(a.generations, a.population, a.islands, a.seed, a.adaptive, a.device, t)
    print(t)
