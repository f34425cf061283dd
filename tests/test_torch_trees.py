"""PyTorch port: tree tensors and registry against the JAX package (CPU).

Inputs are JAX-sampled populations carried over as numpy arrays; the port's
tree utilities must reproduce the JAX ones exactly (integer outputs).
"""
import jax.numpy as jnp
import jax.random as jr
import numpy as np
import pytest
import torch

from multitreegp_tpu.core import trees as jtrees
from multitreegp_tpu.core.registry import build_function_set as jax_function_set
from multitreegp_tpu.ops.initialization import make_population_sampler as jax_sampler
from multitreegp_tpu_torch.convert import function_set_from_jax, trees_from_numpy, trees_to_numpy
from multitreegp_tpu_torch.core import trees as ttrees
from multitreegp_tpu_torch.core.registry import build_function_set

torch.set_num_threads(1)

OPS = [("+", jnp.add, 2, 0.5), ("-", jnp.subtract, 2, 0.1), ("*", jnp.multiply, 2, 0.5),
       ("/", jnp.divide, 2, 0.1), ("sin", jnp.sin, 1, 0.3)]


@pytest.fixture(scope="module")
def population():
    jf = jax_function_set(OPS, [["x0", "x1"], ["x1"]], [2, 1])
    pop = jax_sampler(jf, 4, 32)(jr.PRNGKey(0), 24)
    return jf, function_set_from_jax(jf), pop


def test_round_trip_and_sizes(population):
    jf, tf, pop = population
    arrays = [np.asarray(a) for a in pop]
    t = trees_from_numpy(*arrays)
    for a, b in zip(arrays, trees_to_numpy(t)):
        np.testing.assert_array_equal(a, b)
    assert t.ops.dtype == torch.int32 and t.const.dtype == torch.float32
    np.testing.assert_array_equal(ttrees.tree_sizes(t).numpy(), np.asarray(jtrees.tree_sizes(pop)))


def test_rebuild_pointers_and_spans_match_jax(population):
    jf, tf, pop = population
    t = trees_from_numpy(*[np.asarray(a) for a in pop])
    slots = tf.slots()
    np.testing.assert_array_equal(slots.numpy(), np.asarray(jf.slots))
    np.testing.assert_array_equal(
        ttrees.subtree_spans(t.ops, slots).numpy(), np.asarray(jtrees.subtree_spans(pop.ops, jf.slots))
    )
    c1, c2 = ttrees.rebuild_pointers(t.ops, slots)
    jc1, jc2 = jtrees.rebuild_pointers(pop.ops, jf.slots)
    np.testing.assert_array_equal(c1.numpy(), np.asarray(jc1))
    np.testing.assert_array_equal(c2.numpy(), np.asarray(jc2))


def test_validate_host_agrees_with_jax(population):
    jf, tf, pop = population
    t = trees_from_numpy(*[np.asarray(a) for a in pop])
    ttrees.validate_host(t, tf.slots())
    jtrees.validate_host(pop, jf.slots)
    # a hole inside a tree is refused by both
    ops = np.asarray(pop.ops).copy()
    size = int((ops[0, 0] != 0).sum())
    ops[0, 0, 32 - size + (size // 2)] = 0
    bad = trees_from_numpy(ops, np.asarray(pop.c1), np.asarray(pop.c2), np.asarray(pop.const))
    with pytest.raises(ValueError):
        ttrees.validate_host(bad, tf.slots())
    with pytest.raises(AssertionError):
        jtrees.validate_host(pop._replace(ops=jnp.asarray(ops)), jf.slots)


def test_function_set_matches_jax_numbering(population):
    jf, tf, _ = population
    assert tf.operator_names == jf.operator_names
    assert tf.variable_names == jf.variable_names
    assert tf.var_start == jf.var_start and tf.num_opcodes == jf.num_opcodes
    assert tf.string_to_op == jf.string_to_op
    np.testing.assert_array_equal(tf.variable_mask.numpy(), np.asarray(jf.variable_mask))
    np.testing.assert_array_equal(np.float32(tf.operator_probs), np.asarray(jf.operator_probs))
    # device op ids: the four arithmetic operators and sin
    assert tf.device_op_ids == (0, 1, 2, 3, 4)
    tf.require_device_ops()
    # an operator outside DEVICE_OPS (a user's callable under its own name)
    # is traced into a user operator, or has none where the emitter refuses
    # it (a reduction over the lanes), and the kernels refuse it
    user_set = build_function_set([("+", 2), ("softsign", lambda x: x / (1 + x.abs()), 1)],
                                  [["x0"]], [1])
    assert user_set.device_op_ids == (0, 17) and user_set.extended
    user_set.require_device_ops()
    refused = build_function_set([("+", 2), ("centred", lambda x: x - x.mean(), 1)], [["x0"]], [1])
    assert refused.device_op_ids == (0, -1) and not refused.extended
    with pytest.raises(NotImplementedError, match="reduces"):
        refused.require_device_ops()


def test_unknown_operator_needs_a_function():
    with pytest.raises(ValueError):
        build_function_set([("hypot", 2)], [["x"]], [1])
    # given one, it is traced into a user operator (hypot is in the
    # emitter's table), or refused by the emitter (heaviside: no derivative)
    fs = build_function_set([("hypot", torch.hypot, 2)], [["x"]], [1])
    assert fs.device_op_ids == (17,)
    fs = build_function_set([("heaviside", torch.heaviside, 2)], [["x"]], [1])
    assert fs.device_op_ids == (-1,)
    # a name in OPERATORS needs none: its torch function and device op id
    fs = build_function_set([("pow", 2)], [["x"]], [1])
    assert fs.device_op_ids == (14,) and fs.extended
