"""PyTorch port: the generation step without the fused kernel against the
JAX package (CPU).

* ``make_evolve_island``: 3 islands x 16 candidates of 2 trees (N = 32 and
  N = 300); the output keeps the populations' shapes; its first
  ``elite_size`` rows are the island's best, in the order of JAX's
  ``jnp.argsort`` on the same fitness (made with numpy), exactly; every
  child is valid, of at most N rows and in its layer's variables. Control:
  the same comparison against the island's worst fails.
* ``make_evolve_populations``: the migration gate, with a step that returns
  its input, against JAX's on the same populations and fitness, exactly:
  at generation ``migration_period - 1`` both migrate (each island's worst
  replaced by its ring neighbour's best), at generation 0 neither does;
  control: the two generations' outputs differ.
* ``GeneticProgramming`` routes reproduction as JAX does: the fused kernel
  path iff ``max_nodes <= 256`` by default, the per-tree operators with
  ``fused_reproduction=False`` at any N, a clear ``NotImplementedError``
  for ``fused_reproduction=True`` past 256 rows; the host loop on the
  non-fused path keeps its best (elitism) over generations at N = 300.
"""
import jax
import jax.numpy as jnp
import jax.random as jr
import numpy as np
import pytest
import torch

from multitreegp_tpu.core.registry import build_function_set as jax_function_set
from multitreegp_tpu.core.trees import TreeTensors as JaxTrees
from multitreegp_tpu.ops.initialization import make_population_sampler as jax_sampler
from multitreegp_tpu.ops.reproduction import make_evolve_populations as jax_evolve_populations
from multitreegp_tpu_torch import GeneticProgramming
from multitreegp_tpu_torch.convert import function_set_from_jax, trees_from_numpy
from multitreegp_tpu_torch.core.trees import EMPTY, validate_host
from multitreegp_tpu_torch.models.environments import VanDerPolOscillator
from multitreegp_tpu_torch.models.evaluators import SREvaluator, generate_sr_data
from multitreegp_tpu_torch.ops.initialization import make_tree_sampler
from multitreegp_tpu_torch.ops.mutation import make_mutators
from multitreegp_tpu_torch.ops.reproduction import (
    island_hyperparams, make_evolve_island, make_evolve_populations,
)

torch.set_num_threads(1)

JAX_OPS = [("+", jnp.add, 2, 0.5), ("-", jnp.subtract, 2, 0.1), ("*", jnp.multiply, 2, 0.5),
           ("/", jnp.divide, 2, 0.1), ("sin", jnp.sin, 1, 0.3)]
OPS = [("+", 2, 0.5), ("-", 2, 0.1), ("*", 2, 0.5), ("/", 2, 0.1)]
ISLANDS, POP, ELITE, TOURNAMENT = 3, 16, 4, 3


def populations(n, depth, seed=0):
    """``(jax fset, port fset, numpy populations (3, 16, 2, n), fitness
    (3, 16))``: JAX-grown candidates (tree 0 over x0, x1; tree 1 over a0)
    and numpy fitness with ties."""
    jf = jax_function_set(JAX_OPS, [["x0", "x1"], ["a0"]], [1, 1])
    pops = jax.vmap(lambda k: jax_sampler(jf, depth, n)(k, POP))(jr.split(jr.PRNGKey(seed), ISLANDS))
    rng = np.random.default_rng(seed)
    fitness = rng.integers(0, 40, (ISLANDS, POP)).astype(np.float32) / 4
    return jf, function_set_from_jax(jf), [np.asarray(a) for a in pops], fitness


def hyperparams(device="cpu"):
    return island_hyperparams(ISLANDS, TOURNAMENT, (0.6, 0.9), (1.0, 0.5), (0.9, 0.4), (0.1, 0.5),
                              (0.0, 0.1), device=device)


@pytest.mark.parametrize("n,depth", [(32, 4), (300, 7)])
def test_evolve_island_shapes_and_elite(n, depth):
    jf, pf, pops, fitness = populations(n, depth)
    sample_tree = make_tree_sampler(pf, depth, n)
    mutate_candidate, _, _ = make_mutators(pf, sample_tree, n, depth)
    vmask = pf.variable_mask

    def sample_candidate(generator, shape):
        return sample_tree(generator, depth, vmask.expand(tuple(shape) + tuple(vmask.shape)))

    evolve = make_evolve_island(pf, mutate_candidate, sample_candidate, POP, ELITE, TOURNAMENT)
    tp, rtp, rp = hyperparams()
    rtp = torch.tensor([[0.4, 0.4, 0.2]] * ISLANDS)  # every branch on every island
    out = evolve(trees_from_numpy(*pops), torch.from_numpy(fitness), torch.Generator().manual_seed(3),
                 rtp, rp, tp)
    assert out.ops.shape == (ISLANDS, POP, 2, n)
    order = np.asarray(jnp.argsort(jnp.asarray(fitness), axis=1))
    elite = lambda order: [np.take_along_axis(a, order[:, :ELITE].reshape(
        (ISLANDS, ELITE) + (1,) * (a.ndim - 2)), axis=1) for a in pops]
    for got, want in zip(out, elite(order)):
        np.testing.assert_array_equal(got[:, :ELITE].numpy(), want)
    worst = np.asarray(jnp.argsort(-jnp.asarray(fitness), axis=1))
    assert any(not np.array_equal(g[:, :ELITE].numpy(), w) for g, w in zip(out, elite(worst)))
    validate_host(out, pf.slots())
    assert int((out.ops != EMPTY).sum(-1).max()) <= n
    assert not bool((out.ops[:, :, 0] == pf.var_start + 2).any())
    assert not bool((out.ops[:, :, 1] == pf.var_start).any())
    children = out.map(lambda a: a[:, ELITE:])
    parents = trees_from_numpy(*pops)
    assert not torch.equal(children.ops, parents.ops[:, ELITE:])


def test_migration_gate_matches_jax():
    jf, pf, pops, fitness = populations(32, 4)
    tp, rtp, rp = hyperparams()
    period, size = 4, 3
    port = make_evolve_populations(lambda p, f, g, a, b, c: p, period, size, rtp, rp, tp)
    jax_step = jax_evolve_populations(lambda p, f, k, a, b, c: p, period, size,
                                      jnp.asarray(rtp.numpy()), jnp.asarray(rp.numpy()),
                                      jnp.asarray(tp.numpy()))
    jpops = JaxTrees(*(jnp.asarray(a) for a in pops))
    outs = {}
    for gen in (0, period - 1):
        got = port(trees_from_numpy(*pops), torch.from_numpy(fitness), torch.Generator(), gen)
        want = jax_step(jpops, jnp.asarray(fitness), jr.PRNGKey(0), jnp.int32(gen))
        for a, b in zip(got, want):
            np.testing.assert_array_equal(a.numpy(), np.asarray(b))
        outs[gen] = got
    for a, b in zip(outs[0], pops):
        np.testing.assert_array_equal(a.numpy(), b)
    assert not torch.equal(outs[0].ops, outs[period - 1].ops)
    # one island: never migrates
    one = port(trees_from_numpy(*pops).map(lambda a: a[:1]), torch.from_numpy(fitness[:1]),
               torch.Generator(), period - 1)
    np.testing.assert_array_equal(one.ops.numpy(), pops[0][:1])


def make_gp(n, depth, **kwargs):
    return GeneticProgramming(
        num_generations=3, population_size=POP, fitness_function=SREvaluator(substeps=1),
        operator_list=OPS, variable_list=[["x0", "x1"]], layer_sizes=[2], num_populations=2,
        max_nodes=n, max_init_depth=depth, elite_percentage=0.25, migration_period=2,
        device="cpu", **kwargs)


def test_routing_follows_jax():
    assert make_gp(32, 4).fused_reproduction
    assert make_gp(256, 4).fused_reproduction
    assert not make_gp(257, 4).fused_reproduction
    assert not make_gp(32, 4, fused_reproduction=False).fused_reproduction
    with pytest.raises(NotImplementedError, match="256"):
        make_gp(300, 4, fused_reproduction=True)


def test_host_loop_non_fused_deep_keeps_elite():
    """Default routing at N = 300: three generations of the host loop on the
    non-fused path; every tree valid, the best fitness never increases."""
    g = torch.Generator().manual_seed(0)
    data = generate_sr_data(VanDerPolOscillator(), g, torch.arange(0.0, 1.0, 0.2), batch_size=4)
    gp = make_gp(300, 5)
    assert not gp.fused_reproduction
    pops = gp.initialize_population(g)
    best = []
    for _ in range(3):
        fitness, pops = gp.evaluate_population(pops, data)
        best.append(float(fitness.min()))
        pops = gp.evolve(pops, fitness, g)
        validate_host(pops, gp.fset.slots())
        assert pops.ops.shape == (2, POP, 2, 300)
    assert best[1] <= best[0] and best[2] <= best[1]
