"""PyTorch port: the small utilities against the JAX package, on the same
numpy arrays (CPU).

* ``utils.metrics.population_stats``: every statistic equal to JAX's, bit
  for bit, on a sampled population with dyadic fitness values (every sum
  exact in any order), on the clone-everything population of
  ``tests/test_utils.py`` (unique fraction 1/16) and on an even-length
  fitness vector (the median averages the two middle values); on uniform
  random fitness the mean is a float32 sum in another order than XLA's, so
  it is held to rtol 1e-6 there and every other statistic stays exact;
* ``core.trees.pack`` / ``unpack``: equal to JAX's bit for bit, a round
  trip, and the reference's float64 layout;
* ``core.registry.default_sr_operators`` and ``FunctionSet``'s
  ``operator_indices`` / ``variable_indices`` / ``data_layout``: the same
  opcodes, probabilities and names as JAX's;
* ``utils.profiling``: ``PhaseTimer`` with the semantics of
  ``tests/test_utils.py``, ``sync=`` over a nesting of CPU tensors, ``trace``
  writing a trace file, ``annotate`` inside it;
* ``utils.checkpoint``: ``extra=`` arrays through a round trip;
* ``utils.render.tree_to_string(..., root=)``: the same string as JAX's for
  every row of a tree.
"""
import json
import os

import jax.numpy as jnp
import jax.random as jr
import numpy as np
import pytest
import torch

from multitreegp_tpu.core.registry import build_function_set as jax_function_set
from multitreegp_tpu.core.registry import default_sr_operators as jax_default_sr_operators
from multitreegp_tpu.core.trees import TreeTensors as JaxTrees
from multitreegp_tpu.core.trees import pack as jax_pack
from multitreegp_tpu.core.trees import unpack as jax_unpack
from multitreegp_tpu.ops.initialization import make_population_sampler as jax_sampler
from multitreegp_tpu.utils.metrics import population_stats as jax_population_stats
from multitreegp_tpu.utils.render import tree_to_string as jax_tree_to_string
from multitreegp_tpu_torch.convert import function_set_from_jax, trees_from_numpy
from multitreegp_tpu_torch.core.registry import build_function_set, default_sr_operators
from multitreegp_tpu_torch.core.trees import pack, unpack
from multitreegp_tpu_torch.utils.checkpoint import load_checkpoint, save_checkpoint
from multitreegp_tpu_torch.utils.metrics import population_stats
from multitreegp_tpu_torch.utils.profiling import PhaseTimer, annotate, trace
from multitreegp_tpu_torch.utils.render import tree_to_string

torch.set_num_threads(1)

STATS = ("fitness_min", "fitness_median", "fitness_mean", "size_mean", "size_max",
         "unique_fraction")


def _jax_fset():
    return jax_function_set(jax_default_sr_operators(), [["x0", "x1"]], [2])


def _population(islands, pop, n=16, depth=3, seed=0):
    """JAX-sampled populations ``(islands, pop, 2, n)`` as numpy arrays."""
    flat = jax_sampler(_jax_fset(), depth, n)(jr.PRNGKey(seed), islands * pop)
    return [np.asarray(a).reshape((islands, pop) + a.shape[1:]) for a in flat]


def _stats_both(pop, fitness):
    want = jax_population_stats(JaxTrees(*(jnp.asarray(a) for a in pop)), jnp.asarray(fitness))
    got = population_stats(trees_from_numpy(*pop), torch.from_numpy(fitness))
    assert set(got) == set(want) == set(STATS)
    for k in STATS:
        assert got[k].dtype == torch.float32 and got[k].shape == ()
    return {k: got[k].numpy() for k in STATS}, {k: np.asarray(want[k]) for k in STATS}


@pytest.mark.parametrize("islands,pop", [(2, 16), (1, 15), (3, 8)])
def test_population_stats_equal_jax(islands, pop):
    """Dyadic fitness (multiples of 1/8 below 2^10): every statistic bit for
    bit; (1, 15) is an odd count, (2, 16) and (3, 8) even ones."""
    population = _population(islands, pop, seed=islands)
    rng = np.random.default_rng(pop)
    fitness = (rng.integers(0, 8 * 1024, (islands, pop)) / 8).astype(np.float32)
    got, want = _stats_both(population, fitness)
    for k in STATS:
        np.testing.assert_array_equal(got[k], want[k], err_msg=k)
    assert 0 < got["unique_fraction"] <= 1 and got["size_max"] >= got["size_mean"]


def test_population_stats_even_median_averages():
    """An even count: the mean of the two middle values, as ``jnp.median``
    (``torch.median`` would give the lower one)."""
    population = _population(1, 4)
    fitness = np.array([[4.0, 1.0, 3.0, 2.0]], np.float32)
    got, want = _stats_both(population, fitness)
    assert float(got["fitness_median"]) == float(want["fitness_median"]) == 2.5
    assert float(torch.median(torch.from_numpy(fitness))) == 2.0


def test_population_stats_clones_and_nan():
    """``tests/test_utils.py``'s clone case: candidate 0 everywhere, unique
    fraction 1/16, exactly JAX's; a NaN fitness makes the median NaN in both."""
    population = [np.broadcast_to(a[:, :1], a.shape).copy() for a in _population(1, 16)]
    got, want = _stats_both(population, np.zeros((1, 16), np.float32))
    for k in STATS:
        np.testing.assert_array_equal(got[k], want[k], err_msg=k)
    assert float(got["unique_fraction"]) == np.float32(1 / 16)
    fitness = np.arange(16, dtype=np.float32).reshape(1, 16)
    fitness[0, 3] = np.nan
    got, want = _stats_both(population, fitness)
    assert np.isnan(got["fitness_median"]) and np.isnan(want["fitness_median"])


def test_population_stats_random_fitness():
    """Uniform float fitness: the mean's float32 sum runs in another order
    than XLA's (rtol 1e-6); the rest bit for bit."""
    population = _population(4, 32, n=32, depth=4, seed=5)
    fitness = np.random.default_rng(6).uniform(0, 1e3, (4, 32)).astype(np.float32)
    got, want = _stats_both(population, fitness)
    for k in STATS:
        if k == "fitness_mean":
            np.testing.assert_allclose(got[k], want[k], rtol=1e-6)
        else:
            np.testing.assert_array_equal(got[k], want[k], err_msg=k)


def test_pack_unpack_equal_jax():
    population = _population(2, 8, n=32, depth=4, seed=3)
    trees = trees_from_numpy(*population)
    packed = pack(trees)
    want = np.asarray(jax_pack(JaxTrees(*(jnp.asarray(a) for a in population))))
    assert packed.dtype == torch.float32 and packed.shape == trees.ops.shape + (4,)
    np.testing.assert_array_equal(packed.numpy(), want)
    for got, ref, a in zip(unpack(packed), jax_unpack(jnp.asarray(want)), population):
        ref = np.array(ref)
        assert got.dtype == torch.from_numpy(ref).dtype
        np.testing.assert_array_equal(got.numpy(), ref)
        np.testing.assert_array_equal(got.numpy(), a)  # the round trip
    # the reference's tensors are float64
    ref64 = unpack(torch.from_numpy(want.astype(np.float64)))
    assert all(torch.equal(x, y) for x, y in zip(ref64, trees))


def test_default_sr_operators_and_indices_equal_jax():
    jops = jax_default_sr_operators()
    tops = default_sr_operators()
    assert [(o[0], o[2], o[3]) for o in tops] == [(o[0], o[2], o[3]) for o in jops]
    assert all(callable(o[1]) for o in tops)
    layers = [["x0", "x1", "u0"], ["x1"]]
    jf = jax_function_set(jops, layers, [2, 1])
    tf = build_function_set(tops, layers, [2, 1])
    assert tf.string_to_op == dict(jf.string_to_op)
    np.testing.assert_array_equal(tf.probs().numpy(), np.asarray(jf.operator_probs))
    assert tf.arities == tuple(np.asarray(jf.arities).tolist())
    np.testing.assert_array_equal(tf.variable_mask.numpy(), np.asarray(jf.variable_mask))
    for name in ("operator_indices", "variable_indices"):
        got = getattr(tf, name)(device="cpu")
        assert got.dtype == torch.int64 and got.device.type == "cpu"
        np.testing.assert_array_equal(got.numpy(), np.asarray(getattr(jf, name)))
    assert tf.data_layout == tuple(jf.data_layout) == ("x0", "x1", "u0")
    x = torch.tensor([6.0]), torch.tensor([4.0])
    assert [float(fn(*x)) for _, fn, _, _ in tops] == [10.0, 2.0, 24.0, 1.5]


def test_phase_timer():
    t = PhaseTimer()
    with t.phase("a"):
        sum(range(1000))
    with t.phase("a", sync=[torch.ones(3), {"b": (torch.zeros(2),)}]):  # CPU: no sync
        pass
    t.record("b", 0.25)
    s = t.summary()
    assert s["a"]["count"] == 2 and s["a"]["total_s"] > 0
    assert s["b"] == {"total_s": 0.25, "count": 1, "mean_s": 0.25}
    assert "a" in str(t) and str(t).splitlines()[1].startswith("b")  # sorted by total
    with pytest.raises(ValueError):
        with t.phase("c"):
            raise ValueError("the phase still counts")
    assert t.summary()["c"]["count"] == 1


def test_trace_writes_a_trace_file(tmp_path):
    log_dir = tmp_path / "trace"
    with trace(str(log_dir)):
        with annotate("matmul"):
            torch.ones(8, 8) @ torch.ones(8, 8)
    files = [f for f in os.listdir(log_dir) if f.endswith(".json")]
    assert len(files) == 1
    with open(log_dir / files[0]) as f:
        events = json.load(f)["traceEvents"]
    assert any(e.get("name") == "matmul" for e in events)


def test_checkpoint_extra_round_trip(tmp_path):
    trees = trees_from_numpy(*_population(1, 8))
    path = str(tmp_path / "ckpt.npz")
    extra = {"note": np.asarray(42), "losses": torch.tensor([1.5, 0.5]), "tag": np.arange(3)}
    save_checkpoint(path, trees, torch.Generator().manual_seed(3).get_state(), 7,
                    best_fitnesses=torch.tensor([3.0, 2.0]), extra=extra)
    state = load_checkpoint(path)
    assert state["generation"] == 7 and set(state["extra"]) == {"note", "losses", "tag"}
    assert int(state["extra"]["note"]) == 42
    np.testing.assert_array_equal(state["extra"]["losses"], [1.5, 0.5])
    np.testing.assert_array_equal(state["extra"]["tag"], [0, 1, 2])
    assert all(torch.equal(a, b) for a, b in zip(state["populations"], trees))
    assert not os.path.exists(path + ".tmp")
    save_checkpoint(path, trees, torch.Generator().get_state(), 1)
    assert load_checkpoint(path)["extra"] == {}


def test_tree_to_string_root_equal_jax():
    jf = _jax_fset()
    tf = function_set_from_jax(jf)
    population = _population(1, 4, n=16, depth=3, seed=9)
    for c in range(4):
        for t in range(2):
            arrays = [a[0, c, t] for a in population]
            jtree, ttree = JaxTrees(*(jnp.asarray(a) for a in arrays)), trees_from_numpy(*arrays)
            assert tree_to_string(ttree, tf) == jax_tree_to_string(jtree, jf)
            for root in range(16):
                if arrays[0][root] != 0:
                    want = jax_tree_to_string(jtree, jf, root=root)
                    assert tree_to_string(ttree, tf, root=root) == want
