"""PyTorch port: selection, migration, hyperparameters and the sampler (CPU).

Deterministic pieces are compared with the JAX package exactly
(``migrate_ring``) or to float32 rounding (``island_hyperparams``: the two
``linspace`` formulas differ in the last bit). Random pieces draw from a
``torch.Generator`` where JAX draws from threefry, so they are compared by
law: histograms against the JAX package's or against the exact probability,
with bounds of about five standard errors of the sample.
"""
import jax
import jax.numpy as jnp
import jax.random as jr
import numpy as np
import pytest
import torch

from multitreegp_tpu.core.registry import build_function_set as jax_function_set
from multitreegp_tpu.core.trees import tree_sizes as jax_tree_sizes
from multitreegp_tpu.ops.initialization import make_population_sampler as jax_sampler
from multitreegp_tpu.ops.reproduction import island_hyperparams as jax_hyperparams
from multitreegp_tpu.ops.reproduction import migrate_ring as jax_migrate
from multitreegp_tpu.ops.reproduction import tournament_select as jax_tournament
from multitreegp_tpu_torch.convert import function_set_from_jax, trees_from_numpy, trees_to_numpy
from multitreegp_tpu_torch.core.trees import tree_sizes, validate_host
from multitreegp_tpu_torch.ops.crossover import forced_bernoulli_mask
from multitreegp_tpu_torch.ops.initialization import make_population_sampler
from multitreegp_tpu_torch.ops.reproduction import island_hyperparams, migrate_ring, tournament_select

torch.set_num_threads(1)

OPS = [("+", jnp.add, 2, 0.5), ("-", jnp.subtract, 2, 0.1), ("*", jnp.multiply, 2, 0.5),
       ("/", jnp.divide, 2, 0.1), ("sin", jnp.sin, 1, 0.3)]


@pytest.fixture(scope="module")
def fsets():
    jf = jax_function_set(OPS, [["x0", "x1"], ["x1"]], [2, 1])
    return jf, function_set_from_jax(jf)


def test_migrate_ring_exact(fsets):
    jf, tf = fsets
    pops = jax_sampler(jf, 3, 16)(jr.PRNGKey(0), 4 * 10)
    pops = jax.tree_util.tree_map(lambda x: x.reshape((4, 10) + x.shape[1:]), pops)
    rng = np.random.default_rng(0)
    fitness = rng.random((4, 10)).astype(np.float32)
    fitness[:, ::3] = 1e5  # ties, as clamped candidates produce
    jp, jfit = jax_migrate(pops, jnp.asarray(fitness), 3)
    tp, tfit = migrate_ring(trees_from_numpy(*[np.asarray(a) for a in pops]), torch.from_numpy(fitness), 3)
    np.testing.assert_array_equal(tfit.numpy(), np.asarray(jfit))
    for a, b in zip(trees_to_numpy(tp), jp):
        np.testing.assert_array_equal(a, np.asarray(b))


def test_island_hyperparams_close():
    args = (5, 7, (0.6, 0.9), (1.0, 0.5), (0.9, 0.4), (0.1, 0.5), (0.0, 0.1))
    for a, b in zip(island_hyperparams(*args), jax_hyperparams(*args)):
        np.testing.assert_allclose(a.numpy(), np.asarray(b), rtol=1e-6, atol=1e-7)


def test_tournament_select_law():
    """Winner histogram of the port vs the JAX package on one island."""
    pop, t, draws = 12, 4, 20000
    fitness = np.random.default_rng(1).permutation(pop).astype(np.float32)
    tp, _, _ = island_hyperparams(1, t, (0.6, 0.6), (1, 1), (1, 1), (0, 0), (0, 0))
    g = torch.Generator().manual_seed(2)
    won = tournament_select(torch.from_numpy(fitness)[None], tp, t, draws, g)[0].numpy()
    pool = jnp.arange(pop)
    jwon = jax.vmap(lambda k: jax_tournament(pool, jnp.asarray(fitness), k, jnp.asarray(tp[0].numpy()), t))(
        jr.split(jr.PRNGKey(3), draws))
    h = np.bincount(won, minlength=pop) / draws
    jh = np.bincount(np.asarray(jwon), minlength=pop) / draws
    assert np.abs(h - jh).max() < 0.015, (h, jh)
    assert h[np.argmin(fitness)] > h[np.argmax(fitness)] * 5  # selection pressure


@pytest.mark.parametrize("p", [0.0, 0.3, 0.9])
def test_forced_bernoulli_mask_law(p):
    m, n = 3, 40000
    g = torch.Generator().manual_seed(4)
    mask = forced_bernoulli_mask(torch.full((n,), p), m, (n,), g).numpy()
    assert mask.shape == (n, m) and mask.any(axis=1).all()
    # P(tree i) = p + (1 - p)^m / m: the Bernoulli draw, or the forced pick
    expect = p + (1 - p) ** m / m
    assert np.abs(mask.mean(axis=0) - expect).max() < 0.012


def test_sampler_valid_and_same_law_as_jax(fsets):
    jf, tf = fsets
    n, depth, pop = 16, 4, 600
    got = make_population_sampler(tf, depth, n)(torch.Generator().manual_seed(5), pop, 2)
    assert got.ops.shape == (2, pop, 3, n)
    validate_host(got, tf.slots())
    ref = jax_sampler(jf, depth, n)(jr.PRNGKey(6), 2 * pop)
    sizes = tree_sizes(got).reshape(-1, 3).numpy()
    jsizes = np.asarray(jax_tree_sizes(ref))
    for slot in range(3):
        assert abs(sizes[:, slot].mean() - jsizes[:, slot].mean()) < 0.08 * jsizes[:, slot].mean()
        h = np.bincount(sizes[:, slot], minlength=n + 1) / sizes.shape[0]
        jh = np.bincount(jsizes[:, slot], minlength=n + 1) / jsizes.shape[0]
        assert np.abs(h - jh).sum() < 0.12
    # opcode frequencies over all rows; the last layer never uses x0
    ops = got.ops.numpy()
    jops = np.asarray(ref.ops)
    f = np.bincount(ops[ops > 0], minlength=tf.num_opcodes) / (ops > 0).sum()
    jfreq = np.bincount(jops[jops > 0], minlength=tf.num_opcodes) / (jops > 0).sum()
    assert np.abs(f - jfreq).max() < 0.03
    assert not (ops[:, :, 2] == tf.string_to_op["x0"]).any()
