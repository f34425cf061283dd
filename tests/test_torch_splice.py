"""PyTorch port: the subtree surgery and its row statistics against the JAX
package, exactly (CPU).

The same trees (grown by the JAX package's sampler, N = 32 at depth 4 and
N = 300 at depth 7, with chains of N - 1 rows among them), the same rows and
sizes (drawn with numpy from a seed) go through both packages; the outputs
must be equal, tolerance 0: ``empty_trees``, ``subtree_span_at``,
``extract_subtree``, ``splice`` (every pair of subtrees, those that do not
fit included), ``leaf_block``, ``compose1``, ``compose2``,
``crossover._node_probs``, ``crossover._subtrees_equal`` (with equal
subtrees among the pairs) and the mutation table ``get_mutation_probs`` (on
trees of every size from 1 to N). These functions draw nothing, so nothing
may differ.
"""
import importlib

import jax
import jax.numpy as jnp
import jax.random as jr
import numpy as np
import pytest
import torch

from multitreegp_tpu.core import trees as jax_trees
from multitreegp_tpu.core.registry import build_function_set as jax_function_set
from multitreegp_tpu.ops.initialization import make_tree_sampler as jax_tree_sampler
from multitreegp_tpu.ops.mutation import make_mutators as jax_mutators
from multitreegp_tpu_torch.convert import function_set_from_jax, trees_from_numpy
from multitreegp_tpu_torch.core import trees as pt_trees
from multitreegp_tpu_torch.core.trees import CONST, EMPTY, OP_START, TreeTensors, validate_host
from multitreegp_tpu_torch.ops import crossover as pt_cx
from multitreegp_tpu_torch.ops import splice as pt_splice
from multitreegp_tpu_torch.ops.mutation import get_mutation_probs
from test_torch_kernels import chain_rows

torch.set_num_threads(1)

# the modules (``multitreegp_tpu.ops`` exports functions of the same names)
jax_cx = importlib.import_module("multitreegp_tpu.ops.crossover")
jax_splice = importlib.import_module("multitreegp_tpu.ops.splice")

JAX_OPS = [("+", jnp.add, 2, 0.5), ("-", jnp.subtract, 2, 0.1), ("*", jnp.multiply, 2, 0.5),
           ("/", jnp.divide, 2, 0.1), ("sin", jnp.sin, 1, 0.3)]
SIZES = [(32, 4), (300, 7)]
COUNT = 48


def case(n, depth, seed=0):
    """``(jax fset, port fset, numpy trees (COUNT, n), rng)``: trees grown by
    the JAX sampler, the first one a chain of n - 1 rows."""
    jf = jax_function_set(JAX_OPS, [["x0", "x1"]], [1])
    sample = jax_tree_sampler(jf, depth, n)
    keys = jr.split(jr.PRNGKey(seed), COUNT)
    t = jax.vmap(lambda k: sample(k, jnp.int32(depth), jf.variable_mask[0]))(keys)
    t = [np.array(a) for a in t]
    ops = np.array(chain_rows(n, n - 1, jf.var_start), np.int32)
    c1, c2 = jax_trees.rebuild_pointers(jnp.asarray(ops), jf.slots)
    t[0][0], t[1][0], t[2][0] = ops, np.asarray(c1), np.asarray(c2)
    t[3][0] = np.where(ops == CONST, 0.5, 0.0).astype(np.float32)
    return jf, function_set_from_jax(jf), t, np.random.default_rng(seed)


def to_jax(t):
    return jax_trees.TreeTensors(*[jnp.asarray(a) for a in t])


def to_port(t):
    return trees_from_numpy(*t)


def assert_same(pt, jx):
    """Every field equal: a port tree tuple against a JAX one, or arrays."""
    if isinstance(pt, TreeTensors):
        for name, a, b in zip(pt._fields, pt, jx):
            np.testing.assert_array_equal(a.numpy(), np.asarray(b), err_msg=name)
    else:
        np.testing.assert_array_equal(pt.numpy(), np.asarray(jx))


def live_rows(ops, rng, internal=False, var_start=None):
    """A random non-empty (or operator) row per tree, numpy int32."""
    out = []
    for row in ops:
        cand = np.nonzero((row >= OP_START) & (row < var_start) if internal else row != EMPTY)[0]
        out.append(rng.choice(cand) if len(cand) else len(row) - 1)
    return np.asarray(out, np.int32)


def spans(jf, t, rows):
    return np.asarray(jax.vmap(lambda o, r: jax_trees.subtree_span_at(o, jf.slots, r))(
        jnp.asarray(t[0]), jnp.asarray(rows)))


@pytest.mark.parametrize("n,depth", SIZES)
def test_empty_trees_and_spans_match_jax(n, depth):
    assert_same(pt_trees.empty_trees((3, 2), n), jax_trees.empty_trees((3, 2), n))
    jf, pf, t, rng = case(n, depth)
    rows = live_rows(t[0], rng)
    got = pt_trees.subtree_span_at(torch.from_numpy(t[0]), pf.slots(), torch.from_numpy(rows))
    assert_same(got, spans(jf, t, rows))
    assert int(got[0]) == n - 1 or rows[0] != n - 1
    # R rows of each tree at once, as the crossover asks
    many = np.stack([live_rows(t[0], rng) for _ in range(4)], axis=-1)
    got = pt_trees.subtree_span_at(torch.from_numpy(t[0])[:, None, :], pf.slots(),
                                   torch.from_numpy(many))
    assert_same(got, np.stack([spans(jf, t, many[:, r]) for r in range(4)], axis=-1))


@pytest.mark.parametrize("n,depth", SIZES)
def test_extract_and_splice_match_jax(n, depth):
    jf, pf, t, rng = case(n, depth)
    jt, pt = to_jax(t), to_port(t)
    n1 = live_rows(t[0], rng)
    n1[0] = n - 1  # the chain's whole n - 1 rows: fits in no other tree
    s1 = spans(jf, t, n1)
    block = pt_splice.extract_subtree(pt, torch.from_numpy(n1), torch.from_numpy(s1))
    jblock = jax.vmap(jax_splice.extract_subtree)(jt, jnp.asarray(n1), jnp.asarray(s1))
    assert_same(block, jblock)
    validate_host(block, pf.slots())
    # every tree's subtree spliced into the next tree, whether it fits or not
    perm = np.roll(np.arange(COUNT), 1)
    n2 = live_rows(t[0], rng)
    s2 = spans(jf, t, n2)
    got = pt_splice.splice(pt, torch.from_numpy(n2), torch.from_numpy(s2), block[perm],
                           torch.from_numpy(s1[perm]))
    want = jax.vmap(jax_splice.splice)(jt, jnp.asarray(n2), jnp.asarray(s2),
                                       jax.tree_util.tree_map(lambda a: a[perm], jblock),
                                       jnp.asarray(s1[perm]))
    assert_same(got, want)
    sizes = (t[0] != EMPTY).sum(-1)
    fits = s1[perm] - s2 <= n - sizes
    assert fits.any() and (~fits).any()
    validate_host(got[torch.from_numpy(fits)], pf.slots())


@pytest.mark.parametrize("n,depth", SIZES)
def test_compose_and_leaf_block_match_jax(n, depth):
    jf, pf, t, rng = case(n, depth)
    jt, pt = to_jax(t), to_port(t)
    size = (t[0] != EMPTY).sum(-1).astype(np.int32)
    unary = jf.var_start - 1  # sin
    ops = np.full(COUNT, unary, np.int32)
    got = pt_splice.compose1(torch.from_numpy(ops), pt, torch.from_numpy(size))
    want = jax.vmap(jax_splice.compose1)(jnp.asarray(ops), jt, jnp.asarray(size))
    assert_same(got[0], want[0])
    assert_same(got[1], want[1])
    validate_host(got[0][torch.from_numpy(size < n)], pf.slots())
    ops = rng.integers(OP_START, unary, COUNT).astype(np.int32)  # + - * /
    perm = rng.permutation(COUNT)
    got = pt_splice.compose2(torch.from_numpy(ops), pt, torch.from_numpy(size), pt[perm],
                             torch.from_numpy(size[perm]))
    want = jax.vmap(jax_splice.compose2)(jnp.asarray(ops), jt, jnp.asarray(size),
                                         jax.tree_util.tree_map(lambda a: a[perm], jt),
                                         jnp.asarray(size[perm]))
    assert_same(got[0], want[0])
    assert_same(got[1], want[1])
    fits = size + size[perm] + 1 <= n
    validate_host(got[0][torch.from_numpy(fits)], pf.slots())
    leaf_ops = rng.choice([CONST, jf.var_start, jf.var_start + 1], COUNT).astype(np.int32)
    consts = rng.normal(size=COUNT).astype(np.float32)
    got = pt_splice.leaf_block(n, torch.from_numpy(leaf_ops), torch.from_numpy(consts))
    want = jax.vmap(lambda o, c: jax_splice.leaf_block(n, o, c))(jnp.asarray(leaf_ops),
                                                                 jnp.asarray(consts))
    assert_same(got, want)


@pytest.mark.parametrize("n,depth", SIZES)
def test_crossover_row_statistics_match_jax(n, depth):
    jf, pf, t, rng = case(n, depth)
    jt, pt = to_jax(t), to_port(t)
    assert_same(pt_cx._node_probs(pt.ops, pf.var_start),
                jax.vmap(lambda o: jax_cx._node_probs(o, jf.var_start))(jt.ops))
    # pairs: a tree against itself at one row (equal), against a copy with
    # one constant moved, and against the next tree (equal leaves among them)
    n1 = live_rows(t[0], rng)
    n2 = live_rows(t[0], rng)
    moved = [a.copy() for a in t]
    moved[3] = np.where(moved[0] == CONST, moved[3] + 1.0, 0.0).astype(np.float32)
    perm = np.roll(np.arange(COUNT), 1)
    for other, rows in ((t, n1), (moved, n1), ([a[perm] for a in t], n2)):
        s1, s2 = spans(jf, t, n1), spans(jf, other, rows)
        got = pt_cx._subtrees_equal(pt, torch.from_numpy(n1), torch.from_numpy(s1),
                                    to_port(other), torch.from_numpy(rows), torch.from_numpy(s2))
        want = jax.vmap(jax_cx._subtrees_equal)(jt, jnp.asarray(n1), jnp.asarray(s1),
                                                to_jax(other), jnp.asarray(rows), jnp.asarray(s2))
        assert_same(got, want)
    s1 = spans(jf, t, n1)
    equal = lambda other: pt_cx._subtrees_equal(pt, torch.from_numpy(n1), torch.from_numpy(s1),
                                                to_port(other), torch.from_numpy(n1),
                                                torch.from_numpy(s1))
    assert bool(equal(t).all())
    has_const = [bool((t[0][i, n1[i] - s1[i] + 1:n1[i] + 1] == CONST).any()) for i in range(COUNT)]
    assert torch.equal(equal(moved), ~torch.tensor(has_const)) and any(has_const)


@pytest.mark.parametrize("n,depth", SIZES)
def test_mutation_table_matches_jax(n, depth):
    """``get_mutation_probs`` on trees of every size 1..N (the JAX package
    keeps it inside ``make_mutators``; the test reads it from there)."""
    jf, pf, _, _ = case(n, depth)
    _, mutate_tree, _ = jax_mutators(jf, jax_tree_sampler(jf, depth, n), n, depth)
    jax_probs = mutate_tree.__closure__[mutate_tree.__code__.co_freevars.index(
        "get_mutation_probs")].cell_contents
    sizes = np.arange(1, n + 1)
    ops = np.where(np.arange(n)[None, :] >= n - sizes[:, None], CONST, EMPTY).astype(np.int32)
    minus = np.full(ops.shape, -1, np.int32)
    t = [ops, minus, minus, np.zeros(ops.shape, np.float32)]
    got = get_mutation_probs(to_port(t))
    assert_same(got, jax.vmap(jax_probs)(to_jax(t)))
    assert got.shape == (n, 7) and len({tuple(r) for r in got.tolist()}) == 4
