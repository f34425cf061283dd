"""Top-level strategy: ``GeneticProgramming`` on PyTorch.

Port of the host-loop API of ``multitreegp_tpu/strategy.py``: the same
constructor keywords and the same loop methods — ``initialize_population`` /
``evaluate_population`` / ``evolve`` / ``get_statistics`` / ``to_string``.
PyTorch runs eagerly, so there are no compiled-program caches. Randomness
comes from explicit ``torch.Generator``s, and every tensor lives on the
``device`` given to the constructor.

Not ported yet (they raise ``NotImplementedError``): ``fit()``, constant
optimisation, meshes/sharding, the non-fused reproduction path and
``to_callable`` (ROADMAP Queue 1 #11, #12 and #18).
"""
from __future__ import annotations

from typing import Optional, Sequence, Tuple

import torch

from .core.interpreter import make_candidate_evaluator
from .core.registry import FunctionSet, build_function_set
from .core.trees import TreeTensors, tree_sizes
from .ops.fused_evolve import make_evolve_populations_fused
from .ops.initialization import make_population_sampler
from .ops.reproduction import island_hyperparams
from .utils.render import candidate_to_string


class GeneticProgramming:
    """Genetic programming over multi-tree symbolic expressions on a GPU."""

    def __init__(
        self,
        num_generations: int,
        population_size: int,
        fitness_function,  # evaluator with .evaluate_population(pop, data)
        operator_list: Sequence[Tuple],
        variable_list: Sequence[Sequence[str]],
        layer_sizes: Sequence[int],
        num_populations: int = 1,
        max_init_depth: int = 4,
        max_nodes: int = 30,
        device_type: Optional[str] = None,  # accepted for API parity; `device` decides
        tournament_size: int = 7,
        size_parsimony: float = 0.0,
        coefficient_sd: float = 1.0,
        migration_period: int = 10,
        migration_percentage: float = 0.1,
        elite_percentage: float = 0.1,
        coefficient_optimisation: bool = False,
        gradient_steps: int = 10,
        optimiser=None,
        coefficient_opt_top_k: int = 50,
        selection_pressure_factors: Tuple[float, float] = (0.6, 0.9),
        reproduction_probability_factors: Tuple[float, float] = (1.0, 0.5),
        crossover_probability_factors: Tuple[float, float] = (0.9, 0.4),
        mutation_probability_factors: Tuple[float, float] = (0.1, 0.5),
        sample_probability_factors: Tuple[float, float] = (0.0, 0.1),
        mesh=None,
        fused_reproduction: Optional[bool] = None,
        device="cuda",
        **kwargs,
    ) -> None:
        if "size_parsinomy" in kwargs:  # the reference's spelling
            size_parsimony = kwargs.pop("size_parsinomy")
        if kwargs:
            raise TypeError(f"unknown arguments: {sorted(kwargs)}")
        if coefficient_optimisation:
            raise NotImplementedError("constant optimisation is ROADMAP Queue 1 #12")
        if mesh is not None:
            raise NotImplementedError("meshes and sharding are ROADMAP Queue 1 #18")
        if fused_reproduction is False:
            raise NotImplementedError("the port has the fused reproduction path only")
        checks = (
            (num_populations > 0, "num_populations must be positive"),
            (population_size > 0 and population_size % 2 == 0,
             "population_size must be positive and even"),
            (max_init_depth > 0 and max_nodes > 0, "max_init_depth and max_nodes must be positive"),
            (migration_period > 1, "migration_period must be > 1"),
            (tournament_size > 1, "tournament_size must be > 1"),
        )
        for ok, msg in checks:
            if not ok:
                raise ValueError(msg)

        self.device = torch.device(device)
        self.num_generations = num_generations
        self.population_size = population_size
        self.num_populations = num_populations
        self.max_init_depth = max_init_depth
        self.max_nodes = max_nodes
        self.tournament_size = tournament_size
        self.size_parsimony = float(size_parsimony)
        self.coefficient_sd = coefficient_sd
        self.migration_period = migration_period
        self.migration_size = max(0, min(int(round(migration_percentage * population_size)),
                                         population_size))
        # rounded down to even so the non-elite remainder stays pair-producible
        self.elite_size = (int(elite_percentage * population_size) // 2) * 2

        self.fset: FunctionSet = build_function_set(operator_list, variable_list, layer_sizes)
        self.num_trees = self.fset.num_trees
        self.evaluator = fitness_function
        if getattr(self.evaluator, "fset", None) is None:
            self.evaluator.fset = self.fset

        self.sample_population = make_population_sampler(
            self.fset, max_init_depth, max_nodes, coefficient_sd
        )
        (
            self.tournament_probabilities,
            self.reproduction_type_probabilities,
            self.reproduction_probabilities,
        ) = island_hyperparams(
            num_populations, tournament_size, selection_pressure_factors,
            reproduction_probability_factors, crossover_probability_factors,
            mutation_probability_factors, sample_probability_factors, device=self.device,
        )
        self._evolve_populations = make_evolve_populations_fused(
            self.fset, population_size, self.elite_size, tournament_size, migration_period,
            self.migration_size, self.reproduction_type_probabilities,
            self.reproduction_probabilities, self.tournament_probabilities, max_nodes,
            max_init_depth, coefficient_sd,
        )

        # best-so-far history
        self.current_generation = 0
        self.best_fitnesses = torch.full((num_generations,), float("inf"), device=self.device)
        self.best_solutions: Optional[TreeTensors] = None
        # the reference-style per-candidate tree evaluator handed to users
        self.tree_evaluator = make_candidate_evaluator(self.fset)

    # ------------------------------------------------------------------ API

    def initialize_population(self, generator: torch.Generator) -> TreeTensors:
        """``(islands, pop, trees, nodes)`` tree tensors."""
        return self.sample_population(generator, self.population_size, self.num_populations)

    def evaluate_population(self, populations: TreeTensors, data) -> Tuple[torch.Tensor, TreeTensors]:
        """Fitness ``(islands, pop)`` of every candidate (plus
        ``size_parsimony`` x node count) and the populations; records the
        generation's best candidate."""
        islands = populations.ops.shape[0]
        flat = populations.map(lambda x: x.reshape((-1,) + x.shape[2:]))
        fitness = self.evaluator.evaluate_population(flat, data)
        if self.size_parsimony:
            fitness = fitness + self.size_parsimony * tree_sizes(flat).sum(dim=-1)
        fitness = fitness.reshape(islands, -1)

        flat_fit = fitness.reshape(-1)
        best = int(torch.argmin(flat_fit))
        best_solution = flat[best]
        if self.best_solutions is None:
            self.best_solutions = best_solution.map(
                lambda x: torch.zeros((self.num_generations,) + x.shape, dtype=x.dtype, device=x.device)
            )
        gen = min(self.current_generation, self.num_generations - 1)
        self.best_fitnesses[gen] = flat_fit[best]
        for hist, value in zip(self.best_solutions, best_solution):
            hist[gen] = value
        return fitness, populations

    def evolve(self, populations: TreeTensors, fitness: torch.Tensor,
               generator: torch.Generator) -> TreeTensors:
        """One generation: migration (every ``migration_period``), elitism,
        selection and the fused reproduction."""
        out = self._evolve_populations(populations, fitness, generator, self.current_generation)
        self.current_generation += 1
        return out

    def get_statistics(self, generation: Optional[int] = None):
        if generation is not None:
            return self.best_fitnesses[generation], self.best_solutions[generation]
        return self.best_fitnesses, self.best_solutions

    def to_string(self, candidate: TreeTensors) -> str:
        return candidate_to_string(candidate, self.fset)

    def fit(self, *args, **kwargs):
        raise NotImplementedError("fit() (whole run on the device) is ROADMAP Queue 1 #11")

    def optimise(self, *args, **kwargs):
        raise NotImplementedError("constant optimisation is ROADMAP Queue 1 #12")

    def to_callable(self, *args, **kwargs):
        raise NotImplementedError("to_callable is not ported yet (ROADMAP Queue 1 #11)")
