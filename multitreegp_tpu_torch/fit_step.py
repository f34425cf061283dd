"""``GeneticProgramming.fit()``'s generation as one step over device state,
and that step captured in CUDA graphs.

Counterpart of the JAX package's ``fit()``, which runs the whole evolution
as one jitted ``lax.scan`` over ``generation`` (``multitreegp_tpu/
strategy.py``). :func:`generation_step` is that scan's body: it evaluates
the populations, refines the top-k constants when the round is scheduled,
records the best candidate at the device generation counter (``argmin``,
``index_select``, ``index_copy_``: no host read), migrates when scheduled,
and selects and reproduces (kernel #2). It reads and writes a
:class:`RunState` in place, copying its outputs into its inputs, so that
each step starts where the last one ended.

On a CUDA device :class:`GraphedRun` captures the step into one
``torch.cuda.CUDAGraph`` per schedule variant (migration x round: the
schedule is a function of the generation number alone, :func:`schedule`),
all in one memory pool, and ``fit()`` replays one graph a generation: the
host issues one launch a generation. A variant's first generation runs the
step eagerly, which fills every cache the capture must not fill; its second
captures it. The graphs draw from the run's own generator, registered with
each of them; ``fit()`` copies the caller's generator state into it before
the run and back after it, so the caller's generator ends where the eager
step leaves it. A failing capture or replay raises; nothing falls back to
the eager step. An evaluator's Python code runs at the eager step and the
capture, not at every generation, as under JAX's trace.

:func:`step_refusal` says which configurations the graphs take: the
symbolic-regression evaluator with a fixed-step method and without process
noise on its fused kernel (#1), and the fused reproduction (#2). Every
other configuration, and every configuration on the CPU, runs the step
eagerly.
"""
from __future__ import annotations

from typing import Dict, NamedTuple, Optional, Set, Tuple

import torch

from .core import cuda_rollout as cf
from .core.trees import TreeTensors
from .models.evaluators import SREvaluator
from .ops.reproduction import migration_due

Variant = Tuple[bool, bool]  # (migration, constant-optimisation round)


class RunState(NamedTuple):
    """What a run carries from one generation to the next, on the device."""

    populations: TreeTensors  # (islands, pop, trees, N)
    fitness: torch.Tensor  # (islands, pop): the last evaluated generation's
    generation: torch.Tensor  # int64 (1,): the generation the next step runs
    best_fitnesses: torch.Tensor  # (G,)
    best_solutions: TreeTensors  # (G, trees, N)

    def clone(self) -> "RunState":
        return RunState(*(x.map(torch.clone) if isinstance(x, TreeTensors) else x.clone()
                          for x in self))

    def load(self, populations: TreeTensors, generation: int, best_fitnesses: torch.Tensor,
             best_solutions: TreeTensors) -> None:
        """Copy a run's state into this one's memory."""
        for dst, src in zip(self.populations + self.best_solutions, populations + best_solutions):
            dst.copy_(src)
        self.generation.fill_(generation)
        self.best_fitnesses.copy_(best_fitnesses)


def new_state(populations: TreeTensors, generation: int, best_fitnesses: torch.Tensor,
              best_solutions: TreeTensors) -> RunState:
    """A :class:`RunState` holding copies of these, at ``generation``."""
    dev = populations.ops.device
    return RunState(populations.map(torch.clone),
                    torch.full(populations.ops.shape[:2], float("inf"), device=dev),
                    torch.full((1,), generation, dtype=torch.int64, device=dev),
                    best_fitnesses.clone(), best_solutions.map(torch.clone))


def schedule(gp, generation: int) -> Variant:
    """``generation``'s variant of the step: whether it migrates, and
    whether it runs the constant-optimisation round."""
    return (migration_due(gp.num_populations, gp.migration_period, generation),
            gp._optimise_due(generation))


def record_best(best_fitnesses: torch.Tensor, best_solutions: TreeTensors, at: torch.Tensor,
                populations: TreeTensors, fitness: torch.Tensor) -> None:
    """Write the best candidate of ``populations`` (the first minimum of
    ``fitness``) and its fitness into the histories at ``at`` (int64 (1,),
    on the device): ``argmin``, ``index_select``, ``index_copy_``, no host
    read."""
    flat_fit = fitness.reshape(-1)
    best = torch.argmin(flat_fit).reshape(1)
    best_fitnesses.index_copy_(0, at, flat_fit.index_select(0, best))
    for hist, x in zip(best_solutions, populations):
        hist.index_copy_(0, at, x.reshape((-1,) + x.shape[2:]).index_select(0, best))


def generation_step(gp, data, state: RunState, generator: torch.Generator, generation: int) -> None:
    """One generation of ``gp.fit()`` on ``state``, in place: evaluate, the
    round when scheduled, the best recorded at ``state.generation``,
    migration when scheduled, selection and reproduction from
    ``generator``. ``generation`` picks the variant (:func:`schedule`) and
    nothing else, so a capture serves every generation of its variant."""
    populations = state.populations
    fitness = gp._evaluate(populations, data)
    if gp._optimise_due(generation):
        populations, fitness = gp._optimise_core(populations, fitness, data)
    record_best(state.best_fitnesses, state.best_solutions, state.generation, populations, fitness)
    evolved = gp._evolve_populations(populations, fitness, generator, generation)
    for dst, src in zip(state.populations, evolved):
        dst.copy_(src)
    state.fitness.copy_(fitness)
    state.generation.add_(1)


def step_refusal(gp, data) -> Optional[str]:
    """Why ``gp``'s configuration on ``data`` is not captured in graphs
    (``fit()`` then runs :func:`generation_step` eagerly), or None where it
    is."""
    ev = gp.evaluator
    if not gp.fused_reproduction:
        return ("the per-tree reproduction operators (fused_reproduction=False, or max_nodes > "
                "256) run eagerly")
    if not isinstance(ev, SREvaluator):
        return (f"{type(ev).__name__}: the graphs take the symbolic-regression evaluator; the policy "
                "evaluators (#6/#7) run eagerly")
    if ev.method not in cf.METHODS:  # the fixed-step methods
        return f"method {ev.method!r}: adaptive SR (#5) runs eagerly"
    x0s, keys = data[0], data[3]
    if ev._sde(keys):
        return "process noise: the SDE's kick rows run eagerly"
    if ev.interpreter not in ("auto", "pallas"):
        return f"interpreter={ev.interpreter!r}: the general path runs eagerly"
    reason = cf.lanes_refusal(gp.num_trees, gp.max_nodes, x0s.shape[1], x0s.shape[0])
    if reason is not None:
        return f"the general path ({reason}) runs eagerly"
    return None


class GraphedRun:
    """One run's CUDA graphs: :func:`generation_step` of each variant that
    has come up twice, captured on ``state`` (whose buffers every replay
    reads and writes) with ``generator`` (the run's own) registered, in one
    memory pool. A variant's first generation runs the step eagerly on the
    same state and generator: it builds and loads the kernels' libraries and
    fills the kernel tables and the interpreter's layouts, so that nothing is
    built, loaded or copied from the host during a capture (a miss there
    raises, ``_build.refuse_in_capture``). Its second generation captures
    the step and replays it; every later one replays it. A variant that
    comes up once is never captured. ``keep_graph`` keeps each graph's
    ``cudaGraph_t`` after its capture, for inspection."""

    keep_graph = False

    def __init__(self, gp, data, state: RunState):
        self.gp, self.data, self.state = gp, data, state
        self.device = state.fitness.device
        self.generator = torch.Generator(device=self.device)
        self.pool = torch.cuda.graph_pool_handle()
        self.graphs: Dict[Variant, torch.cuda.CUDAGraph] = {}
        self.seen: Set[Variant] = set()

    def step(self, generation: int) -> None:
        """Run ``generation``: eagerly at its variant's first generation,
        else by its variant's graph (captured at the second)."""
        variant = schedule(self.gp, generation)
        graph = self.graphs.get(variant)
        if graph is None:
            if variant not in self.seen:
                self.seen.add(variant)
                generation_step(self.gp, self.data, self.state, self.generator, generation)
                return
            graph = self.graphs[variant] = self._capture(generation)
        graph.replay()

    def _capture(self, generation: int) -> torch.cuda.CUDAGraph:
        """The step of ``generation``'s variant as a graph. The capture
        records the step and runs nothing: the generator moves at replays."""
        graph = torch.cuda.CUDAGraph(keep_graph=self.keep_graph)
        graph.register_generator_state(self.generator)
        with torch.cuda.graph(graph, pool=self.pool):
            generation_step(self.gp, self.data, self.state, self.generator, generation)
        if self.keep_graph:
            graph.instantiate()
        return graph
