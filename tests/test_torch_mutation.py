"""PyTorch port: crossover, the seven mutations and the tree sampler against
the JAX package, by law and by tree invariants (CPU).

The two packages draw from different generators (``torch.Generator``
against JAX keys), so their children can only agree in law. The parents are
the same: 16 trees of N = 32 grown by the JAX sampler (depth 4), each
repeated 512 times, so each package makes 8,192 children of them. A child is
summarised by its size change (clipped to +-6), the rows whose opcode or
constant changed (clipped to 4) and whether its root changed, and for the
two mutations that put the old subtree on a coin-flipped side, the rows
that sit one row lower in the child than in the parent (clipped to 3); the
law tests bound the total-variation distance between the two packages'
histograms of that summary by ``TV_BOUND`` = 0.06 (the port against JAX:
at most 0.038, at crossover; two runs of the port on the same parents: at
most 0.042, at ``replace_tree``). Each law test has a negative control that
must exceed the bound: the port with one detail of that operator's own law
perturbed (``PERTURBED``; crossover: operators weighted 1:1 with leaves;
``mutate_tree``: one entry of the applicability table; the sampler: the
grow probability one level too deep). The controls read 0.11-0.58.

Invariants, on every child of the port (N = 32, and N = 300 at depth 7):
``validate_host``, size <= N, the layer's variables only; crossover
conserves the pair's rows; ``mutate_leaf`` changes one leaf and nothing
else.
"""
import jax
import jax.numpy as jnp
import jax.random as jr
import numpy as np
import pytest
import torch

from multitreegp_tpu.core.registry import build_function_set as jax_function_set
from multitreegp_tpu.core.trees import TreeTensors as JaxTrees
from multitreegp_tpu.ops.crossover import crossover_trees as jax_crossover_trees
from multitreegp_tpu.ops.initialization import make_tree_sampler as jax_tree_sampler
from multitreegp_tpu.ops.mutation import make_mutators as jax_mutators
from multitreegp_tpu_torch.convert import function_set_from_jax, trees_from_numpy
from multitreegp_tpu_torch.core.trees import EMPTY, TreeTensors, validate_host
from multitreegp_tpu_torch.ops import crossover, initialization, mutation
from multitreegp_tpu_torch.ops.crossover import crossover_candidates, crossover_trees
from multitreegp_tpu_torch.ops.initialization import make_tree_sampler
from multitreegp_tpu_torch.ops.mutation import make_mutators

torch.set_num_threads(1)

JAX_OPS = [("+", jnp.add, 2, 0.5), ("-", jnp.subtract, 2, 0.1), ("*", jnp.multiply, 2, 0.5),
           ("/", jnp.divide, 2, 0.1), ("sin", jnp.sin, 1, 0.3)]
N, DEPTH, PARENTS, REPEATS = 32, 4, 16, 512
TV_BOUND = 0.06
# per mutation, one detail of its own law perturbed: (module, name, the
# replacement made of the original)
_DEEPER = (initialization, "_grow_probability", lambda orig: lambda depth: 0.7 ** (depth + 1))
_LEAVES_AS_OPERATORS = (mutation, "_operator_rows", lambda orig: lambda ops, var_start: ops != EMPTY)
_ALWAYS_SECOND = (mutation, "_side_coin", lambda orig: lambda shape, g: torch.ones(shape, dtype=torch.bool))
PERTURBED = {
    0: _DEEPER,  # the fresh depth-2 subtree grown with 0.7 ** (depth + 1)
    1: (mutation, "_sample_leaf",  # the old variable left in the draw
        lambda orig: lambda g, fset, vmask, sd, exclude_var=None: orig(g, fset, vmask, sd)),
    2: _LEAVES_AS_OPERATORS,  # a leaf may be drawn as the operator to change
    3: _LEAVES_AS_OPERATORS,  # a leaf may be drawn as the operator to delete
    4: _ALWAYS_SECOND,  # the side coin always puts the old tree second
    5: _ALWAYS_SECOND,
    6: _DEEPER,  # the new tree grown with 0.7 ** (depth + 1)
}


class Setup:
    def __init__(self, n=N, depth=DEPTH):
        # two layers: the second tree may use only a0, the first never
        self.jf = jax_function_set(JAX_OPS, [["x0", "x1"], ["a0"]], [1, 1])
        self.pf = function_set_from_jax(self.jf)
        self.n, self.depth = n, depth
        self.jax_sample = jax_tree_sampler(self.jf, depth, n)
        self.jax_mutators = jax_mutators(self.jf, self.jax_sample, n, depth)
        self.sample = make_tree_sampler(self.pf, depth, n)
        self.mutate_candidate, self.mutate_tree, self.mutators = make_mutators(
            self.pf, self.sample, n, depth)
        parents = jax.vmap(lambda k: self.jax_sample(k, jnp.int32(depth), self.jf.variable_mask[0]))(
            jr.split(jr.PRNGKey(0), PARENTS))
        self.parents = [np.repeat(np.asarray(a), REPEATS, axis=0) for a in parents]
        self.vmask = torch.ones(PARENTS * REPEATS, 1) * self.pf.variable_mask[0]

    def jax_parents(self, perm=None):
        t = self.parents if perm is None else [a[perm] for a in self.parents]
        return JaxTrees(*(jnp.asarray(a) for a in t))

    def port_parents(self, perm=None):
        return trees_from_numpy(*(self.parents if perm is None else [a[perm] for a in self.parents]))


@pytest.fixture(scope="module")
def setup():
    return Setup()


@pytest.fixture(scope="module")
def deep():
    return Setup(n=300, depth=7)


def numpy_trees(t):
    return [np.asarray(a) for a in t]


def summary(child, parent, side=False):
    """Per child: size change (clipped to +-6), changed rows (clipped to 4)
    and whether the root changed, as one integer; with ``side``, also the
    parent's rows found one row lower in the child (clipped to 3), which
    tells on which side of a new operator the old subtree went."""
    size = lambda t: (t[0] != EMPTY).sum(-1)
    delta = np.clip(size(child) - size(parent), -6, 6)
    changed = np.clip(((child[0] != parent[0]) | (child[3] != parent[3])).sum(-1), 0, 4)
    out = delta * 100 + changed * 10 + (child[0][:, -1] != parent[0][:, -1])
    if not side:
        return out
    lower = ((child[0][:, :-1] == parent[0][:, 1:]) & (parent[0][:, 1:] != EMPTY)).sum(-1)
    return out * 10 + np.clip(lower, 0, 3)


def tv(a, b) -> float:
    """Total-variation distance between the histograms of ``a`` and ``b``."""
    keys = np.union1d(a, b)
    pa = np.array([(a == k).mean() for k in keys])
    pb = np.array([(b == k).mean() for k in keys])
    return 0.5 * float(np.abs(pa - pb).sum())


def check_children(trees: TreeTensors, fset, n, layer=0):
    validate_host(trees, fset.slots())
    assert int((trees.ops != EMPTY).sum(-1).max()) <= n
    banned = fset.var_start + 2 if layer == 0 else fset.var_start  # a0 / x0
    assert not bool((trees.ops == banned).any())


def test_crossover_law_matches_jax(setup, monkeypatch):
    perm = np.roll(np.arange(PARENTS * REPEATS), REPEATS)
    keys = jr.split(jr.PRNGKey(1), PARENTS * REPEATS)
    j1, j2 = jax.jit(jax.vmap(lambda a, b, k: jax_crossover_trees(a, b, k, setup.jf)))(
        setup.jax_parents(), setup.jax_parents(perm), keys)
    p1, p2 = setup.port_parents(), setup.port_parents(perm)
    c1, c2 = crossover_trees(p1, p2, torch.Generator().manual_seed(1), setup.pf)
    for c in (c1, c2):
        check_children(c, setup.pf, N)
    size = lambda t: (t.ops != EMPTY).sum(-1)
    assert torch.equal(size(c1) + size(c2), size(p1) + size(p2))
    want = summary(numpy_trees(j1), setup.parents)
    got = summary(numpy_trees(c1), setup.parents)
    assert tv(got, want) <= TV_BOUND, tv(got, want)
    # control: crossover points drawn with operators weighted 1:1 with leaves
    monkeypatch.setattr(crossover, "_node_probs", lambda ops, var_start: (ops != EMPTY).to(torch.float32))
    other, _ = crossover_trees(p1, p2, torch.Generator().manual_seed(1), setup.pf)
    assert tv(summary(numpy_trees(other), setup.parents), want) > TV_BOUND


def test_crossover_candidates_mask(setup):
    """Candidates of two trees, each tree of its layer: valid children, and
    at least one tree per candidate crossed in most pairs."""
    g = torch.Generator().manual_seed(2)
    vm = setup.pf.variable_mask
    cands = lambda: setup.sample(g, DEPTH, vm.expand(64, 2, -1))
    p1, p2 = cands(), cands()
    c1, c2 = crossover_candidates(p1, p2, g, torch.full((64,), 0.5), setup.pf)
    for c in (c1, c2):
        validate_host(c, setup.pf.slots())
        assert not bool((c.ops[:, 0] == setup.pf.var_start + 2).any())
        assert not bool((c.ops[:, 1] == setup.pf.var_start).any())
    diff = (c1.ops != p1.ops).any(-1).any(-1)
    assert float(diff.float().mean()) > 0.8


@pytest.mark.parametrize("k", range(7))
def test_mutation_law_matches_jax(setup, k, monkeypatch):
    """Mutation ``k`` on the same parents: the port's children valid, in the
    layer's variables, and of JAX's law; the control, the port with
    ``PERTURBED[k]``, is not."""
    keys = jr.split(jr.PRNGKey(10 + k), PARENTS * REPEATS)
    fn = setup.jax_mutators[2][k]
    want = jax.jit(jax.vmap(lambda t, key: fn(t, key, setup.jf.variable_mask[0])))(
        setup.jax_parents(), keys)
    g = torch.Generator().manual_seed(10 + k)
    got = setup.mutators[k](setup.port_parents(), g, setup.vmask)
    check_children(got, setup.pf, N)
    side = k in (4, 5)
    want = summary(numpy_trees(want), setup.parents, side)
    assert tv(summary(numpy_trees(got), setup.parents, side), want) <= TV_BOUND
    module, name, perturb = PERTURBED[k]
    monkeypatch.setattr(module, name, perturb(getattr(module, name)))
    other = setup.mutators[k](setup.port_parents(), torch.Generator().manual_seed(10 + k), setup.vmask)
    assert tv(summary(numpy_trees(other), setup.parents, side), want) > TV_BOUND


def test_mutate_leaf_changes_one_leaf(setup):
    parents = setup.port_parents()
    out = setup.mutators[1](parents, torch.Generator().manual_seed(20), setup.vmask)
    assert torch.equal((out.ops != EMPTY).sum(-1), (parents.ops != EMPTY).sum(-1))
    ops_diff = (out.ops != parents.ops).sum(-1)
    rows = (out.ops != parents.ops) | (out.const != parents.const)
    assert bool((ops_diff <= 1).all()) and bool((rows.sum(-1) <= 1).all())
    assert float((rows.sum(-1) == 1).float().mean()) > 0.95
    leaf = lambda o: (o == 1) | (o >= setup.pf.var_start)
    assert bool(leaf(parents.ops)[rows].all()) and bool(leaf(out.ops)[rows].all())


def test_mutate_tree_law_matches_jax(setup, monkeypatch):
    """The mutation drawn per tree by the applicability tables, then run:
    JAX's law on the same parents; the control, the port with
    ``add_subtree`` left out of the default table, is not."""
    keys = jr.split(jr.PRNGKey(30), PARENTS * REPEATS)
    mutate_tree = setup.jax_mutators[1]
    want = jax.jit(jax.vmap(lambda t, key: mutate_tree(t, key, setup.jf.variable_mask[0])))(
        setup.jax_parents(), keys)
    want = summary(numpy_trees(want), setup.parents)
    g = torch.Generator().manual_seed(30)
    got = setup.mutate_tree(setup.port_parents(), g, setup.vmask)
    check_children(got, setup.pf, N)
    assert tv(summary(numpy_trees(got), setup.parents), want) <= TV_BOUND
    monkeypatch.setattr(mutation, "_PROBS_DEFAULT", (0.0, 1.0, 1.0, 1.0, 1.0, 1.0, 1.0))
    other = setup.mutate_tree(setup.port_parents(), torch.Generator().manual_seed(30), setup.vmask)
    assert tv(summary(numpy_trees(other), setup.parents), want) > TV_BOUND


def test_mutate_candidate_forced_mask(setup):
    g = torch.Generator().manual_seed(40)
    vm = setup.pf.variable_mask
    pop = setup.sample(g, DEPTH, vm.expand(64, 2, -1))
    out = setup.mutate_candidate(pop, g, torch.full((64,), 0.3), vm)
    validate_host(out, setup.pf.slots())
    assert not bool((out.ops[:, 0] == setup.pf.var_start + 2).any())
    assert not bool((out.ops[:, 1] == setup.pf.var_start).any())
    changed = ((out.ops != pop.ops) | (out.const != pop.const)).any(-1)
    assert float(changed.any(-1).float().mean()) > 0.9


def depths(t) -> np.ndarray:
    """Depth of every tree (a root-only tree has depth 1), from its pointers."""
    ops, c1, c2 = (np.asarray(a) for a in t[:3])
    out = []
    for o, a, b in zip(ops, c1, c2):
        d = np.zeros(len(o), int)
        for i in range(len(o)):
            if o[i] != EMPTY:
                d[i] = 1 + max([d[c] for c in (a[i], b[i]) if c >= 0], default=0)
        out.append(d[-1])
    return np.asarray(out)


@pytest.mark.parametrize("limit", [2, 4, "per_tree"])
def test_tree_sampler_law_matches_jax(setup, limit, monkeypatch):
    """Sizes and depths of 8,192 trees grown to a depth limit (an int, or
    per tree 1-4 as a tensor) in both packages: within ``TV_BOUND``; the
    control, the port drawing an operator with probability ``0.7 ** (depth
    + 1)`` in place of ``0.7 ** depth``, is not."""
    count = PARENTS * REPEATS
    rng = np.random.default_rng(50)
    lim = rng.integers(1, DEPTH + 1, count).astype(np.int32) if limit == "per_tree" else None
    jax_limit = jnp.asarray(lim) if lim is not None else jnp.full(count, limit, jnp.int32)
    want = jax.jit(jax.vmap(lambda k, d: setup.jax_sample(k, d, setup.jf.variable_mask[0])))(
        jr.split(jr.PRNGKey(50), count), jax_limit)
    want = numpy_trees(want)
    g = torch.Generator().manual_seed(50)
    vm = setup.vmask
    port_limit = torch.from_numpy(lim) if lim is not None else limit
    got = setup.sample(g, port_limit, vm)
    check_children(got, setup.pf, N)
    monkeypatch.setattr(initialization, "_grow_probability", PERTURBED[0][2](None))
    other = numpy_trees(setup.sample(torch.Generator().manual_seed(50), port_limit, vm))
    stat = lambda t: (t[0] != EMPTY).sum(-1) * 10 + depths(t)
    assert tv(stat(numpy_trees(got)), stat(want)) <= TV_BOUND
    assert tv(stat(other), stat(want)) > TV_BOUND


@pytest.mark.parametrize("k", range(7))
def test_children_valid_at_300_rows(deep, k):
    """Every mutation and crossover at N = 300, depth 7 (past the fused
    kernel's 256 rows): valid children of at most N rows."""
    s = deep
    g = torch.Generator().manual_seed(60 + k)
    parents = s.sample(g, 7, s.vmask[:64])
    check_children(s.mutators[k](parents, g, s.vmask[:64]), s.pf, 300)
    if k == 0:
        for c in crossover_trees(parents, parents.map(lambda a: a.roll(1, 0)), g, s.pf):
            check_children(c, s.pf, 300)
