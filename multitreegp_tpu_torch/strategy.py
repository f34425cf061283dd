"""Top-level strategy: ``GeneticProgramming`` on PyTorch.

Port of ``multitreegp_tpu/strategy.py``: the same constructor keywords, the
host-loop methods — ``initialize_population`` / ``evaluate_population`` /
``evolve`` / ``get_statistics`` / ``to_string`` — constant optimisation of
the top-k candidates (``coefficient_optimisation``, ``optimise``), ``fit()``
with checkpoint/resume, and ``to_callable``. Where JAX runs ``fit()`` as one
jitted ``lax.scan``, the port runs it as one generation step over device
state (``fit_step``), captured in CUDA graphs and replayed once a generation
on the card; the configurations the graphs do not take, and the CPU, run
the step eagerly (``fit_refusal`` says why). Randomness comes from
explicit ``torch.Generator``s, and every tensor lives on the ``device`` given
to the constructor.

Reproduction takes JAX's routing: the fused kernel path (#2,
``ops/fused_evolve``) where ``max_nodes <= 256``, the per-tree operators
(``ops/reproduction.make_evolve_island``) above it or with
``fused_reproduction=False``.

``fit(shard=True)`` runs the evolution over the ranks of a mesh
(``parallel.mesh``, ``mesh=`` or a one-rank mesh made on first use): each
rank evaluates, evolves and refines its block of islands, ring migration
and the global best cross the ranks (``parallel.collective``). As in JAX,
only ``fit(shard=True)`` uses the mesh; the host-loop methods do not.
"""
from __future__ import annotations

from typing import Optional, Sequence, Tuple

import torch

from .core.interpreter import check_impl, evaluate_trees, make_candidate_evaluator
from .core.registry import FunctionSet, build_function_set
from .core.cuda_reproduction import MAX_NODES as MAX_KERNEL_NODES
from .core.trees import TreeTensors, tree_sizes
from .fit_step import GraphedRun, generation_step, new_state, record_best, step_refusal
from .ops.constant_opt import make_constant_optimiser
from .ops.fused_evolve import make_reproduce_islands
from .ops.initialization import make_population_sampler, make_tree_sampler
from .ops.mutation import make_mutators
from .ops.reproduction import island_hyperparams, make_evolve_island, make_evolve_populations
from .parallel import collective
from .parallel.mesh import gather_population, island_sharding, make_mesh
from .utils.checkpoint import load_checkpoint, save_checkpoint
from .utils.render import candidate_to_string


MAX_GRAPHED_RUNS = 4  # the graphed runs a GeneticProgramming keeps (data x length)


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
        optimiser=None,  # ops.optim.GradientTransformation; default Adam at 1e-3
        coefficient_opt_top_k: int = 50,
        selection_pressure_factors: Tuple[float, float] = (0.6, 0.9),
        reproduction_probability_factors: Tuple[float, float] = (1.0, 0.5),
        crossover_probability_factors: Tuple[float, float] = (0.9, 0.4),
        mutation_probability_factors: Tuple[float, float] = (0.1, 0.5),
        sample_probability_factors: Tuple[float, float] = (0.0, 0.1),
        mesh=None,
        fused_reproduction: Optional[bool] = None,
        device=None,
        **kwargs,
    ) -> None:
        if "size_parsinomy" in kwargs:  # the reference's spelling
            size_parsimony = kwargs.pop("size_parsinomy")
        if kwargs:
            raise TypeError(f"unknown arguments: {sorted(kwargs)}")
        if mesh is not None and device is not None:
            want = torch.device(device)
            if want.type != mesh.device.type or want.index not in (None, mesh.device.index):
                raise ValueError(f"device {want} conflicts with this rank's mesh device {mesh.device}")
        if fused_reproduction is None:  # JAX's routing
            fused_reproduction = max_nodes <= MAX_KERNEL_NODES
        if fused_reproduction and max_nodes > MAX_KERNEL_NODES:
            raise NotImplementedError(
                f"fused_reproduction=True at max_nodes {max_nodes}: the reproduction kernel takes "
                f"at most {MAX_KERNEL_NODES} rows; leave it None or pass False")
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

        # with a mesh, every tensor lives on this rank's device
        self.mesh = mesh
        self.device = mesh.device if mesh is not None else torch.device(device or "cuda")
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
        self.coefficient_optimisation = coefficient_optimisation
        self.gradient_steps = gradient_steps
        self.coefficient_opt_top_k = min(coefficient_opt_top_k, num_populations * population_size)

        self.fset: FunctionSet = build_function_set(operator_list, variable_list, layer_sizes)
        self.num_trees = self.fset.num_trees
        self.evaluator = fitness_function
        if getattr(self.evaluator, "fset", None) is None:
            self.evaluator.fset = self.fset

        self.sample_tree = make_tree_sampler(self.fset, max_init_depth, max_nodes, coefficient_sd)
        self.sample_population = make_population_sampler(
            self.fset, max_init_depth, max_nodes, coefficient_sd
        )
        self.mutate_candidate, self.mutate_tree, _ = make_mutators(
            self.fset, self.sample_tree, max_nodes, max_init_depth, coefficient_sd
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
        self.fused_reproduction = bool(fused_reproduction)
        # every island's step with its hyperparameter rows: the fused kernel
        # path (ops/fused_evolve) or the per-tree operators
        if self.fused_reproduction:
            self._evolve_island = make_reproduce_islands(
                self.fset, population_size, self.elite_size, tournament_size, max_nodes,
                max_init_depth, coefficient_sd,
            )
        else:
            self._evolve_island = make_evolve_island(
                self.fset, self.mutate_candidate, self._sample_candidate, population_size,
                self.elite_size, tournament_size,
            )
        self._evolve_populations = make_evolve_populations(
            self._evolve_island, migration_period, self.migration_size,
            self.reproduction_type_probabilities, self.reproduction_probabilities,
            self.tournament_probabilities,
        )
        self._optimise = make_constant_optimiser(
            lambda pop, data: self.evaluator.evaluate_population(pop, data),
            optimiser, gradient_steps,
        )

        # best-so-far history
        self.current_generation = 0
        self.best_fitnesses = torch.full((num_generations,), float("inf"), device=self.device)
        self.best_solutions: Optional[TreeTensors] = None
        # the reference-style per-candidate tree evaluator handed to users
        self.tree_evaluator = make_candidate_evaluator(self.fset)
        # why the last fit() ran without CUDA graphs (None: it replayed them)
        self.fit_refusal: Optional[str] = None
        self._graph_runs = {}

    def _sample_candidate(self, generator: torch.Generator, shape=()) -> TreeTensors:
        """Fresh candidates of batch ``shape``: each tree grown to
        ``max_init_depth`` with its layer's variables."""
        vmask = self.fset.variable_mask.to(generator.device)
        return self.sample_tree(generator, self.max_init_depth,
                                vmask.expand(tuple(shape) + tuple(vmask.shape)))

    # ------------------------------------------------------------------ API

    def initialize_population(self, generator: torch.Generator) -> TreeTensors:
        """``(islands, pop, trees, nodes)`` tree tensors."""
        return self.sample_population(generator, self.population_size, self.num_populations)

    def _evaluate(self, populations: TreeTensors, data) -> torch.Tensor:
        """Fitness ``(islands, pop)``: the evaluator's plus ``size_parsimony``
        x node count."""
        islands = populations.ops.shape[0]
        flat = populations.map(lambda x: x.reshape((-1,) + x.shape[2:]))
        fitness = self.evaluator.evaluate_population(flat, data)
        if self.size_parsimony:
            fitness = fitness + self.size_parsimony * tree_sizes(flat).sum(dim=-1)
        return fitness.reshape(islands, -1)

    def _optimise_with_parsimony(self, cands: TreeTensors, data):
        """Refine constants, then re-add the parsimony term (the optimiser's
        loss is the raw evaluator fitness; tree sizes do not change), so
        refined entries stay comparable with the rest of the population."""
        opt_fit, opt_cands = self._optimise(cands, data)
        if self.size_parsimony:
            opt_fit = opt_fit + self.size_parsimony * tree_sizes(cands).sum(dim=-1)
        return opt_fit, opt_cands

    def _optimise_core(self, populations: TreeTensors, fitness: torch.Tensor, data):
        """Refine the constants of the global top-k and splice the results
        back (reference :418-422). The best epoch includes the unrefined
        constants, so no fitness gets worse."""
        flat_pop = populations.map(lambda x: x.reshape((-1,) + x.shape[2:]))
        flat_fit = fitness.reshape(-1)
        best_idx = torch.argsort(flat_fit, stable=True)[: self.coefficient_opt_top_k]
        opt_fit, opt_cands = self._optimise_with_parsimony(flat_pop[best_idx], data)

        def splice(x, o):
            x = x.clone()
            x[best_idx] = o
            return x.reshape(populations.ops.shape[:2] + x.shape[1:])

        pop = TreeTensors(*(splice(x, o) for x, o in zip(flat_pop, opt_cands)))
        return pop, splice(flat_fit, opt_fit)

    def _optimise_due(self, generation: int) -> bool:
        """The reference's schedule: after generation 10, every 5th."""
        return self.coefficient_optimisation and generation > 10 and (generation + 1) % 5 == 0

    def evaluate_population(self, populations: TreeTensors, data) -> Tuple[torch.Tensor, TreeTensors]:
        """Fitness ``(islands, pop)`` of every candidate (plus
        ``size_parsimony`` x node count) and the populations, whose top-k
        constants are refined on the constant-optimisation schedule; records
        the generation's best candidate."""
        return self._refine_and_record(populations, self._evaluate(populations, data), data)

    def _refine_and_record(self, populations: TreeTensors, fitness: torch.Tensor, data):
        """The rest of a generation's evaluation: the constant-optimisation
        round when scheduled, then the best candidate recorded."""
        if self._optimise_due(self.current_generation):
            populations, fitness = self._optimise_core(populations, fitness, data)
        self._history(populations.map(lambda x: x[0, 0]))
        at = torch.full((1,), self._history_at(), dtype=torch.int64, device=fitness.device)
        record_best(self.best_fitnesses, self.best_solutions, at, populations, fitness)
        return fitness, populations

    def _history(self, candidate: TreeTensors) -> None:
        """Allocate the best-solution history, of ``candidate``'s shape,
        where there is none."""
        if self.best_solutions is None:
            history = self.best_fitnesses.shape[0]
            self.best_solutions = candidate.map(
                lambda x: torch.zeros((history,) + x.shape, dtype=x.dtype, device=x.device))

    def _history_at(self) -> int:
        """The history index of the current generation (the last one past
        the history's end)."""
        return min(self.current_generation, self.best_fitnesses.shape[0] - 1)

    def _record_best(self, best_fitness: torch.Tensor, best_solution: TreeTensors) -> None:
        self._history(best_solution)
        gen = self._history_at()
        self.best_fitnesses[gen] = best_fitness
        for hist, value in zip(self.best_solutions, best_solution):
            hist[gen] = value

    def evolve(self, populations: TreeTensors, fitness: torch.Tensor,
               generator: torch.Generator) -> TreeTensors:
        """One generation: migration (every ``migration_period``), elitism,
        selection and reproduction (the fused kernel, or the per-tree
        operators)."""
        out = self._evolve_populations(populations, fitness, generator, self.current_generation)
        self.current_generation += 1
        return out

    def get_statistics(self, generation: Optional[int] = None):
        if generation is not None:
            return self.best_fitnesses[generation], self.best_solutions[generation]
        return self.best_fitnesses, self.best_solutions

    def to_string(self, candidate: TreeTensors) -> str:
        return candidate_to_string(candidate, self.fset)

    def optimise(self, candidates: TreeTensors, data) -> Tuple[torch.Tensor, TreeTensors]:
        """Constant optimisation of ``candidates`` (batch ``(K, trees)``):
        ``(best fitness (K,), refined candidates)`` (reference :454-473)."""
        return self._optimise(candidates, data)

    def to_callable(self, candidate: TreeTensors, impl: str = "auto"):
        """``f(data (..., V)) -> (..., num_trees)`` root values of an evolved
        candidate, through the interpreter (its kernel on CUDA tensors;
        differentiable in ``data``). ``impl`` is JAX's keyword
        (:func:`~.core.interpreter.evaluate_trees`)."""
        fset = self.fset
        check_impl(impl)

        def f(data: torch.Tensor) -> torch.Tensor:
            return evaluate_trees(candidate, data[..., None, :], fset, impl=impl)

        return f

    def fit(
        self,
        generator: torch.Generator,
        data,
        num_generations: Optional[int] = None,
        shard: bool = False,
        checkpoint_path: Optional[str] = None,
        checkpoint_every: int = 10,
        resume_from: Optional[str] = None,
    ):
        """Run the whole evolution: per generation evaluate, refine constants
        when scheduled, record the best, evolve (and checkpoint).

        Each generation is :func:`~.fit_step.generation_step`. On a CUDA
        device, for the symbolic-regression evaluator with a fixed-step
        method and no process noise on its fused kernel, with the fused
        reproduction, the step of each schedule variant (migration x round)
        runs eagerly at the variant's first generation, is captured as a
        CUDA graph at its second and replayed from then on; the graphs are
        cached per data and length, and the evaluator's Python code runs at
        the eager step and the capture, not at every generation. Every
        other configuration, and the CPU, runs the step eagerly;
        ``fit_refusal`` holds why the run was not graphed. Both give the
        host loop's (``evaluate_population`` + ``evolve``) results bit for
        bit.

        Returns ``(best_fitness_per_gen (G,), best_solutions (G, trees, N),
        final_populations, final_fitness)``; ``final_fitness`` is the last
        evaluated generation's. With ``checkpoint_path`` (``"{gen}"`` in it
        keeps every snapshot) the run state — the evolved populations, the
        generator's state, the next generation and the histories — is saved
        every ``checkpoint_every`` generations; ``resume_from`` restarts from
        such a file, and the resumed run equals the uninterrupted one.

        ``shard=True`` runs over the ranks of the mesh (``mesh=``, or a
        one-rank mesh on this device); every rank calls ``fit`` with the
        same seeded ``generator`` and data on its own device, and gets the
        same four outputs at the global shapes. Where the ranks ``W`` divide
        the islands, each rank evaluates, refines (the distributed top-k)
        and evolves its block of islands, with ring migration across the
        ranks and the global best gathered every generation. Randomness: the
        population is initialised from ``generator`` on every rank; at
        ``W = 1`` the rank evolves with ``generator`` itself, so the run
        equals ``fit()`` bit for bit; at ``W > 1`` every rank draws ``W``
        seeds from ``generator`` each generation (which keeps the ranks'
        generators in step) and evolves its islands with a generator seeded
        by its own. Where ``W`` does not divide the islands, each rank
        evaluates a contiguous slice of the flattened candidates, the
        fitness is gathered, and the rest runs replicated from
        ``generator``: the run equals ``fit()`` bit for bit. Rank 0 writes
        the checkpoints, of the gathered populations; resuming one with the
        same ``W`` reproduces the uninterrupted run.
        """
        g = num_generations or self.num_generations
        populations, start = self._start_run(generator, g, resume_from)
        if start >= g:  # a completed run: return its state
            self.current_generation = g
            return self.best_fitnesses, self.best_solutions, populations, self._evaluate(populations, data)
        if shard:
            self.fit_refusal = ("shard=True: the ranks' collectives (NCCL inside graphs) run on the "
                                "host loop")
            return self._fit_sharded(generator, data, populations, start, g, checkpoint_path,
                                     checkpoint_every)
        refusal = step_refusal(self, data)
        if refusal is None and self.device.type != "cuda":
            refusal = f"{self.device}: no CUDA graphs off the card; the generation step runs eagerly"
        self.fit_refusal = refusal
        if refusal is None:
            run = self._graphed_run(data, g, populations)
            state, rng, step = run.state, run.generator, run.step
            state.load(populations, start, self.best_fitnesses, self.best_solutions)
            rng.set_state(generator.get_state())
        else:
            state, rng = new_state(populations, start, self.best_fitnesses, self.best_solutions), generator
            step = lambda gen: generation_step(self, data, state, generator, gen)
        self.best_fitnesses, self.best_solutions = state.best_fitnesses, state.best_solutions
        for gen in range(start, g):
            self.current_generation = gen
            step(gen)
            self._checkpoint(checkpoint_path, checkpoint_every, gen, state.populations, rng)
        self.current_generation = g
        if refusal is None:  # the caller's generator where the eager step leaves it; outputs of their own
            generator.set_state(rng.get_state())
            state = state.clone()
            self.best_fitnesses, self.best_solutions = state.best_fitnesses, state.best_solutions
        return self.best_fitnesses, self.best_solutions, state.populations, state.fitness

    def _graphed_run(self, data, g: int, populations: TreeTensors) -> GraphedRun:
        """The :class:`~.fit_step.GraphedRun` of a run of ``g`` generations on
        ``data``, cached as the JAX package caches its compiled run (the
        data's tensors by identity and version; at most
        :data:`MAX_GRAPHED_RUNS`, the oldest dropped first)."""
        key = (g,) + tuple((id(t), t._version) if isinstance(t, torch.Tensor) else id(t) for t in data)
        run = self._graph_runs.get(key)
        if run is None:
            if len(self._graph_runs) >= MAX_GRAPHED_RUNS:
                del self._graph_runs[next(iter(self._graph_runs))]
            state = new_state(populations, 0, self.best_fitnesses, self.best_solutions)
            run = self._graph_runs[key] = GraphedRun(self, data, state)
        return run

    def _start_run(self, generator: torch.Generator, g: int, resume_from: Optional[str]):
        """``(populations, first generation)`` of a run of ``g`` generations,
        fresh or from a checkpoint, with the histories set up."""
        start = 0
        best_fit = best_sol = None
        if resume_from is not None:
            ck = load_checkpoint(resume_from, self.device)
            populations, start = ck["populations"], ck["generation"]
            if start > g:
                raise ValueError(f"checkpoint at generation {start} but the run is {g} long")
            generator.set_state(ck["key"])
            best_fit, best_sol = ck.get("best_fitnesses"), ck.get("best_solutions")
            if best_fit is not None and best_fit.shape[0] != g:
                best_fit = None
            if best_sol is not None and best_sol.ops.shape[0] != g:
                best_sol = None
        else:
            populations = self.initialize_population(generator)
        if best_fit is None:
            best_fit = torch.full((g,), float("inf"), device=self.device)
        if best_sol is None:
            best_sol = populations.map(
                lambda x: torch.zeros((g,) + x.shape[2:], dtype=x.dtype, device=x.device))
        self.best_fitnesses, self.best_solutions = best_fit, best_sol
        return populations, start

    def _checkpoint(self, path: Optional[str], every: int, gen: int, populations: TreeTensors,
                    generator: torch.Generator) -> None:
        if path is not None and (gen + 1) % every == 0:
            save_checkpoint(path.format(gen=gen + 1), populations, generator.get_state(), gen + 1,
                            self.best_fitnesses, self.best_solutions)

    def _fit_sharded(self, generator: torch.Generator, data, populations: TreeTensors, start: int,
                     g: int, checkpoint_path: Optional[str], checkpoint_every: int):
        """``fit(shard=True)`` from ``populations`` (the full run state, the
        same on every rank) at generation ``start``."""
        import torch.distributed as dist

        if self.mesh is None:
            self.mesh = make_mesh(device=self.device)
        mesh = self.mesh
        w = mesh.size

        def checkpoint(gen, full_pops):
            if checkpoint_path is not None and (gen + 1) % checkpoint_every == 0:
                if mesh.rank == 0:
                    self._checkpoint(checkpoint_path, checkpoint_every, gen, full_pops, generator)
                dist.barrier(group=mesh.group)  # the file is whole before any rank reads it

        if self.num_populations % w:  # replicated, the evaluation sharded over flat slices
            flat_eval = lambda flat: self._evaluate_flat(flat, data)
            for gen in range(start, g):
                self.current_generation = gen
                flat = populations.map(lambda x: x.reshape((-1,) + x.shape[2:]))
                fitness = collective.evaluate_flat_sharded(flat_eval, flat, mesh).reshape(
                    self.num_populations, -1)
                fitness, populations = self._refine_and_record(populations, fitness, data)
                populations = self.evolve(populations, fitness, generator)
                checkpoint(gen, populations)
            return self.best_fitnesses, self.best_solutions, populations, fitness

        local = populations.map(lambda x: x[island_sharding(mesh, self.num_populations)])
        hp = (self.migration_period, self.migration_size, self.reproduction_type_probabilities,
              self.reproduction_probabilities, self.tournament_probabilities)
        make_step = (collective.make_evolve_populations_collective_fused if self.fused_reproduction
                     else collective.make_evolve_populations_collective)
        evolve = make_step(self._evolve_island, mesh, *hp)
        evaluate = collective.make_sharded_evaluator(lambda p: self._evaluate(p, data), mesh)
        optimise = collective.make_constant_opt_collective(
            lambda c: self._optimise_with_parsimony(c, data), mesh, self.coefficient_opt_top_k)
        for gen in range(start, g):
            self.current_generation = gen
            fitness = evaluate(local)
            if self._optimise_due(gen):
                local, fitness = optimise(local, fitness)
            self._record_best(*collective.global_best(fitness, local, mesh))
            if w == 1:
                rank_generator = generator
            else:  # W seeds from the shared generator every generation
                seeds = torch.randint(0, 2**62, (w,), generator=generator, device=generator.device)
                rank_generator = torch.Generator(device=self.device).manual_seed(
                    int(seeds[mesh.rank]))
            local = evolve(local, fitness, rank_generator, gen)
            if checkpoint_path is not None and (gen + 1) % checkpoint_every == 0:
                checkpoint(gen, gather_population(local, None, mesh))
        self.current_generation = g
        populations, fitness = gather_population(local, fitness, mesh)
        return self.best_fitnesses, self.best_solutions, populations, fitness

    def _evaluate_flat(self, flat: TreeTensors, data) -> torch.Tensor:
        """Fitness ``(n,)`` of flattened candidates, with the parsimony term."""
        fitness = self.evaluator.evaluate_population(flat, data)
        if self.size_parsimony:
            fitness = fitness + self.size_parsimony * tree_sizes(flat).sum(dim=-1)
        return fitness
