"""PyTorch port: ``fit()`` as one generation step over device state
(``multitreegp_tpu_torch/fit_step.py``), replayed as CUDA graphs on the card.

CPU (2 islands x 16, N = 16, T = 10, B = 4, 20 generations, rounds at 14
and 19, migration at 9 and 19: all four variants of the step):

* (a) ``fit()``, which on the CPU runs the step eagerly with its static
  buffers and device generation counter, equals the host loop
  (``evaluate_population`` + ``evolve``) bit for bit: histories, best
  solutions, final populations, final fitness, and the generator's state.
* (b) A warm step of each variant reads nothing back to the host: during the
  step ``Tensor.item``, ``__bool__``, ``__int__``, ``__float__``,
  ``__index__``, ``tolist`` and ``numpy`` raise, but inside the kernels'
  plain versions, which stand for the kernels. Nor does the host loop's
  ``evaluate_population``, whose record of the best is the step's.
* (c) ``ops.reproduction.categorical`` draws what ``torch.multinomial(p,
  1)`` draws and leaves the generator in the same state.
* (d) The first generation's best of JAX's ``fit()`` (resumed from the
  port's initial population written as a JAX checkpoint at generation 0)
  equals the port's, to 1e-6 relative.
* (e) ``fit_refusal`` names the reason for each configuration the graphs
  do not take, and the CPU's; such a configuration runs the step eagerly,
  equal to the host loop.

On the card (marker ``cuda``): the graphed ``fit()`` against the host loop
(the first run captures the variant that comes up twice, the second the
rest, the third only replays) and a resumed graphed run against the
uninterrupted one, bit for bit; a capture leaves the generators where they
were; a warm step
of each variant under ``torch.cuda.set_sync_debug_mode("error")``; a
capture that meets a host read raises; the categorical helper on CUDA
tensors.
"""
import contextlib

import numpy as np
import pytest
import torch

from multitreegp_tpu_torch import GeneticProgramming
from multitreegp_tpu_torch.core import cuda_reproduction as cr
from multitreegp_tpu_torch.core import cuda_rollout as cf
from multitreegp_tpu_torch.core import interpreter as interp
from multitreegp_tpu_torch.fit_step import GraphedRun, generation_step, new_state, schedule, step_refusal
from multitreegp_tpu_torch.models.environments import Acrobot, VanDerPolOscillator
from multitreegp_tpu_torch.models.evaluators import SREvaluator, StaticPolicyEvaluator, generate_sr_data
from multitreegp_tpu_torch.ops.reproduction import categorical, island_hyperparams

torch.set_num_threads(1)

OPS = [("+", 2, 0.5), ("-", 2, 0.1), ("*", 2, 0.5), ("/", 2, 0.1)]
GENERATIONS = 20
# one generation of each variant (migration, round) with migration every 10
VARIANT_GENERATIONS = {(False, False): 0, (True, False): 9, (False, True): 14, (True, True): 19}


def make_gp(device="cpu", evaluator=None, **kwargs):
    config = dict(num_generations=GENERATIONS, population_size=16, num_populations=2,
                  operator_list=OPS, variable_list=[["x0", "x1"]], layer_sizes=[2], max_nodes=16,
                  max_init_depth=3, elite_percentage=0.25, coefficient_optimisation=True,
                  gradient_steps=2, coefficient_opt_top_k=4, migration_period=10)
    config.update(kwargs)
    return GeneticProgramming(fitness_function=evaluator or SREvaluator(substeps=1), device=device,
                              **config)


def make_data(device="cpu"):
    g = torch.Generator(device=device).manual_seed(0)
    return generate_sr_data(VanDerPolOscillator(), g, torch.arange(0.0, 2.0, 0.2, device=device),
                            batch_size=4)


@pytest.fixture(scope="module")
def data():
    return make_data()


def host_loop(gp, data, generator):
    """The host loop ``fit()`` ran before the step: its four outputs."""
    pops = gp.initialize_population(generator)
    for _ in range(GENERATIONS):
        fitness, pops = gp.evaluate_population(pops, data)
        pops = gp.evolve(pops, fitness, generator)
    return gp.best_fitnesses, gp.best_solutions, pops, fitness


def flat(out):
    best, sols, pops, fitness = out
    return [best, *sols, *pops, fitness]


def assert_same(got, want):
    for a, b in zip(flat(got), flat(want)):
        assert a.shape == b.shape and torch.equal(a, b)


def test_schedule_covers_every_variant():
    gp = make_gp()
    assert {schedule(gp, gen): gen for gen in VARIANT_GENERATIONS.values()} == VARIANT_GENERATIONS
    assert sorted({schedule(gp, gen) for gen in range(GENERATIONS)}) == sorted(VARIANT_GENERATIONS)


def test_step_equals_host_loop(data):
    """(a)"""
    g_fit, g_loop = torch.Generator().manual_seed(1), torch.Generator().manual_seed(1)
    gp = make_gp()
    got = gp.fit(g_fit, data)
    assert gp.fit_refusal.startswith("cpu: no CUDA graphs")
    assert gp.current_generation == GENERATIONS
    want = host_loop(make_gp(), data, g_loop)
    assert_same(got, want)
    assert torch.equal(g_fit.get_state(), g_loop.get_state())
    best = got[0]
    assert bool(torch.isfinite(best).all()) and bool((best[1:] <= best[:-1]).all())


def state_tensors(state):
    return [*state.populations, state.fitness, state.generation, state.best_fitnesses,
            *state.best_solutions]


@contextlib.contextmanager
def no_host_reads(monkeypatch):
    """Make every host read of a tensor raise, but inside the kernels'
    plain versions (the kernels on the card)."""
    inside = [0]

    def guarded(name, method):
        def read(self, *args, **kwargs):
            if not inside[0]:
                raise AssertionError(f"Tensor.{name} inside the step")
            return method(self, *args, **kwargs)
        return read

    def plain(fn):
        def run(*args, **kwargs):
            inside[0] += 1
            try:
                return fn(*args, **kwargs)
            finally:
                inside[0] -= 1
        return run

    with monkeypatch.context() as m:
        for name in ("item", "__bool__", "__int__", "__float__", "__index__", "tolist", "numpy"):
            m.setattr(torch.Tensor, name, guarded(name, getattr(torch.Tensor, name)))
        m.setattr(cf, "sr_fitness_plain", plain(cf.sr_fitness_plain))
        m.setattr(cr, "reproduce_lanes_plain", plain(cr.reproduce_lanes_plain))
        m.setattr(interp, "evaluate_trees_plain", plain(interp.evaluate_trees_plain))
        yield


@pytest.mark.parametrize("variant", sorted(VARIANT_GENERATIONS))
def test_warm_step_reads_nothing_back(data, monkeypatch, variant):
    """(b)"""
    gen = VARIANT_GENERATIONS[variant]
    gp = make_gp()
    g = torch.Generator().manual_seed(3)
    pops = gp.initialize_population(g)
    hist = torch.full((GENERATIONS,), float("inf"))
    sols = pops.map(lambda x: torch.zeros((GENERATIONS,) + x.shape[2:], dtype=x.dtype))
    state = new_state(pops, gen, hist, sols)
    warm = state.clone()
    generation_step(gp, data, warm, torch.Generator().set_state(g.get_state()), gen)
    with no_host_reads(monkeypatch):
        generation_step(gp, data, state, g, gen)
    for a, b in zip(state_tensors(warm), state_tensors(state)):
        assert torch.equal(a, b)
    assert int(state.generation) == gen + 1 and float(state.best_fitnesses[gen]) == float(state.fitness.min())
    gp.current_generation = gen
    with no_host_reads(monkeypatch):
        fitness, _ = gp.evaluate_population(pops, data)
    assert torch.equal(fitness, state.fitness)
    assert torch.equal(gp.best_fitnesses[gen], state.best_fitnesses[gen])
    for a, b in zip(gp.best_solutions, state.best_solutions):
        assert torch.equal(a[gen], b[gen])


@pytest.mark.parametrize("islands,num,seed", [(1, 5, 0), (4, 6, 1), (8, 231, 2)])
def test_categorical_matches_multinomial(islands, num, seed):
    """(c) over the tournament rows of several islands."""
    tp, _, _ = island_hyperparams(islands, 7, (0.6, 0.9), (1.0, 0.5), (0.9, 0.4), (0.1, 0.5), (0.0, 0.1))
    probs = tp[:, None, :].expand(islands, num, 7).reshape(-1, 7)
    g1, g2 = torch.Generator().manual_seed(seed), torch.Generator().manual_seed(seed)
    want = torch.multinomial(probs, 1, generator=g1)
    got = categorical(probs, g2)
    assert got.dtype == want.dtype and torch.equal(got, want)
    assert torch.equal(g1.get_state(), g2.get_state())


def test_first_generation_best_matches_jax(tmp_path):
    """(d) JAX's gather interpreter, its fit() jitted (~40 s of XLA compile,
    most of it the evolve)."""
    import jax.numpy as jnp
    import jax.random as jr

    from multitreegp_tpu import GeneticProgramming as JaxGP
    from multitreegp_tpu.core.trees import TreeTensors as JaxTrees
    from multitreegp_tpu.models.environments import VanDerPolOscillator as JaxVdP
    from multitreegp_tpu.models.evaluators import SREvaluator as JaxSREvaluator
    from multitreegp_tpu.models.evaluators import generate_sr_data as jax_generate
    from multitreegp_tpu.utils.checkpoint import save_checkpoint
    from multitreegp_tpu_torch.convert import sr_data_from_numpy, trees_to_numpy

    jax_ops = [("+", jnp.add, 2, 0.5), ("-", jnp.subtract, 2, 0.1), ("*", jnp.multiply, 2, 0.5),
               ("/", jnp.divide, 2, 0.1)]
    jdata = jax_generate(JaxVdP(0.0, 0.0), jr.PRNGKey(0), jnp.arange(0.0, 2.0, 0.2), batch_size=4,
                         substeps=8)
    data = sr_data_from_numpy(*(np.asarray(a) for a in jdata[:3]))
    gp = make_gp(num_generations=1)
    pops = gp.initialize_population(torch.Generator().manual_seed(5))
    path = str(tmp_path / "ck0.npz")
    save_checkpoint(path, JaxTrees(*(jnp.asarray(a) for a in trees_to_numpy(pops))), jr.PRNGKey(0), 0)
    jgp = JaxGP(num_generations=1, population_size=16, num_populations=2,
                fitness_function=JaxSREvaluator(substeps=1, interpreter="gather"), operator_list=jax_ops,
                variable_list=[["x0", "x1"]], layer_sizes=[2], max_nodes=16, max_init_depth=3,
                elite_percentage=0.25, migration_period=10, fused_reproduction=False)
    jbest, jsols, _, _ = jgp.fit(jr.PRNGKey(0), jdata, num_generations=1, resume_from=path)

    best, sols, _, _ = gp.fit(torch.Generator().manual_seed(5), data, num_generations=1)
    assert best.shape == (1,) and gp.fit_refusal.startswith("cpu")
    want = float(np.asarray(jbest)[0])
    assert abs(float(best[0]) - want) <= 1e-6 * abs(want), (float(best[0]), want)
    for a, b in zip(trees_to_numpy(sols), jsols):
        np.testing.assert_array_equal(a[0], np.asarray(b)[0])


REFUSED = {  # name: (make_gp's arguments, the reason's words)
    "non_fused": (lambda: dict(fused_reproduction=False), "per-tree reproduction"),
    "adaptive": (lambda: dict(evaluator=SREvaluator(method="adaptive")), "adaptive SR (#5)"),
    "sde": (lambda: dict(evaluator=SREvaluator(substeps=1, process_noise=0.05)), "process noise"),
    "gather": (lambda: dict(evaluator=SREvaluator(substeps=1, interpreter="gather")), "general path"),
    "policy": (lambda: dict(evaluator=StaticPolicyEvaluator(Acrobot())), "policy evaluators"),
}


@pytest.mark.parametrize("name", sorted(REFUSED))
def test_step_refusals(data, name):
    """(e) each refused configuration's reason; the slice's takes the step."""
    kwargs, reason = REFUSED[name]
    gp = make_gp(**kwargs())
    assert reason in step_refusal(gp, data)
    assert step_refusal(make_gp(), data) is None


def test_fit_refusal_off_the_step(data, monkeypatch):
    """(e) through ``fit()``: a refused configuration runs the step eagerly,
    equal to the host loop, and keeps its reason; ``shard=True`` its own;
    two state dimensions on three trees take the general path."""
    gp = make_gp(fused_reproduction=False, num_generations=2)
    g_fit, g_loop = torch.Generator().manual_seed(1), torch.Generator().manual_seed(1)
    got = gp.fit(g_fit, data)
    assert "per-tree reproduction" in gp.fit_refusal
    loop = make_gp(fused_reproduction=False, num_generations=2)
    pops = loop.initialize_population(g_loop)
    for _ in range(2):
        fitness, pops = loop.evaluate_population(pops, data)
        pops = loop.evolve(pops, fitness, g_loop)
    assert_same(got, (loop.best_fitnesses, loop.best_solutions, pops, fitness))
    assert torch.equal(g_fit.get_state(), g_loop.get_state())

    sharded = make_gp()
    monkeypatch.setattr(sharded, "_fit_sharded", lambda *a: "sharded")
    assert sharded.fit(torch.Generator().manual_seed(1), data, shard=True) == "sharded"
    assert sharded.fit_refusal.startswith("shard=True")

    three = GeneticProgramming(
        num_generations=2, population_size=16, fitness_function=SREvaluator(substeps=1),
        operator_list=OPS, variable_list=[["x0", "x1"]], layer_sizes=[3], max_nodes=16, device="cpu")
    assert "the general path (3 trees per candidate" in step_refusal(three, data)


# ------------------------------------------------------------------ on the card


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU (CUDA graphs and the kernels)")
    return torch.device("cuda")


@pytest.mark.cuda
def test_graphed_fit_equals_host_loop_on_card(cuda):
    data = make_data(cuda)
    g_fit, g_loop = (torch.Generator(device=cuda).manual_seed(1) for _ in range(2))
    gp = make_gp(cuda)
    got = gp.fit(g_fit, data)
    assert gp.fit_refusal is None
    (run,) = gp._graph_runs.values()
    assert set(run.seen) == set(VARIANT_GENERATIONS) and set(run.graphs) == {(False, False)}
    want = host_loop(make_gp(cuda), data, g_loop)
    assert_same(got, want)
    assert torch.equal(g_fit.get_state(), g_loop.get_state())
    for _ in range(2):  # the cached run: its other variants captured, then replays only
        again = gp.fit(torch.Generator(device=cuda).manual_seed(1), data)
        assert set(run.graphs) == set(VARIANT_GENERATIONS)
        assert_same(again, want)
    assert_same(got, want)  # the first run's outputs are its own


@pytest.mark.cuda
def test_graphed_resume_equals_uninterrupted_on_card(cuda, tmp_path):
    data = make_data(cuda)
    path = str(tmp_path / "ck_{gen}.npz")
    want = make_gp(cuda).fit(torch.Generator(device=cuda).manual_seed(1), data, checkpoint_path=path,
                             checkpoint_every=10)
    gp = make_gp(cuda)
    got = gp.fit(torch.Generator(device=cuda).manual_seed(99), data, resume_from=path.format(gen=10))
    assert gp.fit_refusal is None and set(next(iter(gp._graph_runs.values())).graphs) == {(False, False)}
    assert_same(got, want)


@pytest.mark.cuda
def test_capture_leaves_the_generators_on_card(cuda):
    data = make_data(cuda)
    gp = make_gp(cuda)
    user = torch.Generator(device=cuda).manual_seed(7)
    pops = gp.initialize_population(user)
    hist = torch.full((GENERATIONS,), float("inf"), device=cuda)
    sols = pops.map(lambda x: torch.zeros((GENERATIONS,) + x.shape[2:], dtype=x.dtype, device=cuda))
    run = GraphedRun(gp, data, new_state(pops, 0, hist, sols))
    run.generator.set_state(user.get_state())
    user_before = user.get_state()
    for gen in VARIANT_GENERATIONS.values():
        run.step(gen)  # the variant's first generation: eager, filling the caches
        before = run.generator.get_state()
        run._capture(gen)
        assert torch.equal(run.generator.get_state(), before)
    assert torch.equal(user.get_state(), user_before)


@pytest.mark.cuda
@pytest.mark.parametrize("variant", sorted(VARIANT_GENERATIONS))
def test_warm_step_does_not_sync_on_card(cuda, variant):
    gen = VARIANT_GENERATIONS[variant]
    data = make_data(cuda)
    gp = make_gp(cuda)
    g = torch.Generator(device=cuda).manual_seed(3)
    pops = gp.initialize_population(g)
    hist = torch.full((GENERATIONS,), float("inf"), device=cuda)
    sols = pops.map(lambda x: torch.zeros((GENERATIONS,) + x.shape[2:], dtype=x.dtype, device=cuda))
    state = new_state(pops, gen, hist, sols)
    generation_step(gp, data, state.clone(), g, gen)
    torch.cuda.synchronize()
    torch.cuda.set_sync_debug_mode("error")
    try:
        generation_step(gp, data, state, g, gen)
    finally:
        torch.cuda.set_sync_debug_mode("default")
    assert int(state.generation) == gen + 1


class ReadingEvaluator(SREvaluator):
    def evaluate_population(self, population, data):
        fitness = super().evaluate_population(population, data)
        return fitness + 0 * float(fitness.sum())  # a host read


@pytest.mark.cuda
def test_capture_with_a_host_read_raises_on_card(cuda):
    data = make_data(cuda)
    gp = make_gp(cuda, evaluator=ReadingEvaluator(substeps=1))
    with pytest.raises(RuntimeError):
        gp.fit(torch.Generator(device=cuda).manual_seed(1), data, num_generations=2)


@pytest.mark.cuda
@pytest.mark.parametrize("islands,num,seed", [(1, 5, 0), (8, 231, 2)])
def test_categorical_matches_multinomial_on_card(cuda, islands, num, seed):
    tp, _, _ = island_hyperparams(islands, 7, (0.6, 0.9), (1.0, 0.5), (0.9, 0.4), (0.1, 0.5), (0.0, 0.1),
                                  device=cuda)
    probs = tp[:, None, :].expand(islands, num, 7).reshape(-1, 7)
    g1, g2 = (torch.Generator(device=cuda).manual_seed(seed) for _ in range(2))
    assert torch.equal(categorical(probs, g2), torch.multinomial(probs, 1, generator=g1))
    assert torch.equal(g1.get_state(), g2.get_state())
