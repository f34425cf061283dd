"""A dynamic (stateful) symbolic policy for the Acrobot swing-up, on the port.

The reference's ``examples/DynamicPolicy.ipynb`` as the JAX package's
``examples/dynamic_policy.py`` runs it: each candidate holds
``layer_sizes=[state_size, n_control]`` trees with distinct variables.
Layer 0, the hidden state's equations, reads the observations, the hidden
state and the control ``[y0..y3, a0, a1, u0]``; layer 1, the readout, reads
only the hidden state ``[a0, a1]`` (the reference's information
bottleneck). ``state_size=2``, 100 policies x 5 islands, 50 generations,
operators ``+ - * sin cos``, ``max_nodes=30``, ``size_parsimony=1``, 16
rollouts of 250 saved points, RK4 with 4 substeps (kernel #6). Run::

    python -m multitreegp_tpu_torch.examples.dynamic_policy [--device cpu]
"""
from __future__ import annotations

import argparse

import torch

from .. import GeneticProgramming
from ..models.environments import Acrobot
from ..models.evaluators import DynamicPolicyEvaluator, generate_control_data
from ..utils.profiling import PhaseTimer
from . import require_device, run
from .static_policy import OPERATORS

STATE_SIZE = 2


def build(seed: int = 0, device="cuda", generations: int = 50, population: int = 100,
          islands: int = 5):
    """``(strategy, data, generator)`` of the notebook's configuration: the
    data drawn from ``generator`` (seeded with ``seed``), which then draws
    the population and the evolution. The sizes (``generations``,
    ``population``, ``islands``) default to the notebook's."""
    device = require_device(device)
    generator = torch.Generator(device=device).manual_seed(seed)
    env = Acrobot(process_noise=0.0, obs_noise=0.0)
    ts = torch.arange(0.0, 50.0, 0.2, device=device)  # 250 save points at T = 50
    data = generate_control_data(env, generator, ts, batch_size=16)
    obs_vars = [f"y{i}" for i in range(env.n_obs)]
    hidden_vars = [f"a{i}" for i in range(STATE_SIZE)]
    control_vars = [f"u{i}" for i in range(env.n_control)]
    strategy = GeneticProgramming(
        num_generations=generations,
        population_size=population,
        fitness_function=DynamicPolicyEvaluator(env, state_size=STATE_SIZE, substeps=4),
        operator_list=OPERATORS,
        variable_list=[
            obs_vars + hidden_vars + control_vars,  # layer 0: the state equations
            hidden_vars,  # layer 1: the readout sees only the hidden state
        ],
        layer_sizes=[STATE_SIZE, env.n_control],
        num_populations=islands,
        max_init_depth=4,
        max_nodes=30,
        size_parsimony=1.0,
        device=device,
    )
    return strategy, data, generator


def main(generations: int = 50, population: int = 100, islands: int = 5, seed: int = 0,
         device="cuda", timer: PhaseTimer | None = None, verbose: bool = True) -> torch.Tensor:
    """Run the notebook; returns the best fitness per generation (CPU)."""
    strategy, data, generator = build(seed, device, generations, population, islands)
    log = (lambda gen, best, expr: print(f"gen {gen:4d}  best fitness {best:.4f}  {expr}")) \
        if verbose else None
    history, _ = run(strategy, data, generator, timer=timer, log=log)
    return history.cpu()


if __name__ == "__main__":
    p = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    p.add_argument("--generations", type=int, default=50)
    p.add_argument("--population", type=int, default=100)
    p.add_argument("--islands", type=int, default=5)
    p.add_argument("--seed", type=int, default=0)
    p.add_argument("--device", default="cuda", help="cuda (default) or cpu")
    a = p.parse_args()
    t = PhaseTimer()
    main(a.generations, a.population, a.islands, a.seed, a.device, t)
    print(t)
