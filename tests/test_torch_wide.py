"""PyTorch port: the interpreter past its fixed instances against the JAX
package (CPU).

The interpreter kernels #8/#9 run any tree size, data width and function set
(``csrc/interpreter.cu``'s wide instance, past 1024 rows, 63 variables or 32
operators). Here their host build (``g++``, the same per-lane code the card
runs) and the port's plain versions are held against JAX's
``evaluate_trees(impl="gather")`` and its ``jax.vjp``, on the same numpy-made
inputs:

* roots and per-lane cotangents (every tree and data vector expanded to one
  per lane, so no sum reorders them) at N = 2048 (JAX-grown trees of depth
  10 and a chain of 2047 rows) and on data of 40 variables (N = 32 and
  1025): roots within 1e-6 relative (atol 1e-6) and the same entries finite;
  ``dconst`` and ``ddata`` the same, within 1e-6 of the lane's largest
  cotangent where the plain sums cancel;
* ``SREvaluator.evaluate_population`` at ``max_nodes=2048`` (6 candidates
  grown to depth 10, 4 trajectories, T = 6; the general path; its
  ill-conditioned candidates held to their float64 envelope,
  ``test_torch_deep.ill_conditioned``) and on
  Lorenz-96 data (Lorenz 1996, ``dx_i/dt = (x_{i+1} - x_{i-2}) x_{i-1} - x_i
  + F``, F = 8, 40 states; 40 trees a candidate, 4 candidates of depth 2, 2
  trajectories, T = 6; the port's fused path, kernel #1's wide instance on
  the card, and its general path), fixed-step RK4, against JAX's with
  ``interpreter="gather"``: ``ROADMAP.md``'s rule for rollouts
  (``test_torch_deep.assert_fitness_close``: the same candidates clamped,
  median relative error <= 1e-6 and the largest <= 1e-4; XLA:CPU contracts
  the RK updates into FMAs, the port does not);
* ``GeneticProgramming`` with 40 trees a candidate on Lorenz-96 data
  (``fused_reproduction`` on): the fused reproduction's plain version takes
  40 trees and 40 variables, every child valid.

The same paths on the card are in ``test_torch_kernels.py`` (marker
``cuda``).
"""
import shutil

import jax
import jax.numpy as jnp
import jax.random as jr
import numpy as np
import pytest
import torch

from multitreegp_tpu.core.interpreter import evaluate_trees as jax_evaluate_trees
from multitreegp_tpu.core.registry import build_function_set as jax_function_set
from multitreegp_tpu.core.trees import TreeTensors as JaxTrees
from multitreegp_tpu.core.trees import rebuild_pointers as jax_rebuild_pointers
from multitreegp_tpu.models.evaluators import SREvaluator as JaxSREvaluator
from multitreegp_tpu.ops.initialization import make_population_sampler as jax_sampler
from multitreegp_tpu_torch import GeneticProgramming, _build
from multitreegp_tpu_torch.convert import function_set_from_jax, sr_data_from_numpy, trees_from_numpy
from multitreegp_tpu_torch.core import cuda_interpreter as ci
from multitreegp_tpu_torch.core.trees import CONST, validate_host
from multitreegp_tpu_torch.models.evaluators import SREvaluator
from test_torch_deep import assert_close_within_envelope, assert_fitness_close, float64_envelope, float64_fitness
from test_torch_kernels import chain_rows, lorenz96_data, per_lane_operands

torch.set_num_threads(1)

OPS = [("+", jnp.add, 2, 0.5), ("-", jnp.subtract, 2, 0.1), ("*", jnp.multiply, 2, 0.5),
       ("/", jnp.divide, 2, 0.1)]
PORT_OPS = [("+", 2, 0.5), ("-", 2, 0.1), ("*", 2, 0.5), ("/", 2, 0.1)]


@pytest.fixture(scope="module")
def host_lib(tmp_path_factory):
    if shutil.which("g++") is None and shutil.which("c++") is None:
        pytest.skip("no host C++ compiler")
    return _build.build_host("interpreter", tmp_path_factory.mktemp("wide_jax"))


def jax_population(jf, n, depth, count, chain=True, seed=1):
    """JAX-grown candidates as numpy arrays ``(count, m, n)``; with
    ``chain``, candidate 0's first tree a chain of ``n - 1`` rows (``n - 2``
    at odd n; ``+``/``-`` over leaves, constants 0.5)."""
    pop = [np.array(a) for a in jax_sampler(jf, depth, n)(jr.PRNGKey(seed), count)]
    if chain:
        ops = np.array(chain_rows(n, n - 1, jf.var_start), np.int32)
        c1, c2 = jax_rebuild_pointers(jnp.asarray(ops)[None], jf.slots)
        pop[0][0, 0], pop[1][0, 0], pop[2][0, 0] = ops, np.asarray(c1)[0], np.asarray(c2)[0]
        pop[3][0, 0] = np.where(ops == CONST, 0.5, 0.0)
    return pop


def assert_close_finite(got, want, rtol, atol):
    got, want = np.asarray(got), np.asarray(want)
    assert got.shape == want.shape
    np.testing.assert_array_equal(np.isfinite(got), np.isfinite(want))
    fin = np.isfinite(want)
    np.testing.assert_allclose(got[fin], want[fin], rtol=rtol, atol=atol)


@pytest.mark.parametrize("n,nvar,depth", [(2048, 2, 10), (32, 40, 4), (1025, 40, 7)])
def test_wide_interpreter_matches_jax(host_lib, n, nvar, depth):
    """#8/#9's host build past the fixed instances (and the fixed one at 40
    variables, N = 32) against ``evaluate_trees(impl="gather")`` and
    ``jax.vjp``, per lane; the port's plain version on the same lanes gives
    the host build's bits (``test_torch_interpreter_kernel.py``)."""
    jf = jax_function_set(OPS, [[f"x{i}" for i in range(nvar)]], [2])
    pf = function_set_from_jax(jf)
    pop = jax_population(jf, n, depth, 6)
    rng = np.random.default_rng(n + nvar)
    data = rng.normal(size=(6, 3, 1, nvar)).astype(np.float32)
    g = rng.normal(size=(6, 3, 2)).astype(np.float32)
    trees, x = per_lane_operands(trees_from_numpy(*pop).map(lambda a: a[:, None]), torch.from_numpy(data))
    jtrees = JaxTrees(*(jnp.asarray(a.numpy()) for a in trees))
    assert ci._operands(trees, x, pf)[-1].wide == (n > ci.FIXED_ROWS)

    def fwd(const, d):
        return jax_evaluate_trees(jtrees._replace(const=const), d, jf, impl="gather")

    want, vjp = jax.vjp(jax.jit(fwd), jtrees.const, jnp.asarray(x.numpy()))
    want_c, want_d = vjp(jnp.asarray(g))
    status, got = ci.run_forward(host_lib.interpret_fwd, trees, x, pf)
    assert status == 0
    assert_close_finite(got, want, rtol=1e-6, atol=1e-6)
    status, got_c, got_d = ci.run_backward(host_lib.interpret_bwd, trees, x, torch.from_numpy(g), pf)
    assert status == 0
    # each lane's cotangents: per entry 1e-6 relative, or 1e-6 of the lane's
    # largest where a sum of its terms cancels
    for got_t, want_t in ((got_c, want_c), (got_d, want_d)):
        want_t = np.asarray(want_t)
        scale = np.nanmax(np.where(np.isfinite(want_t), np.abs(want_t), np.nan), axis=-1, keepdims=True)
        got_t = got_t.numpy()
        np.testing.assert_array_equal(np.isfinite(got_t), np.isfinite(want_t))
        fin = np.isfinite(want_t)
        err = np.abs(got_t - want_t)[fin]
        bound = np.maximum(1e-6 * np.abs(want_t), 1e-6 * np.nan_to_num(scale))[fin]
        assert (err <= bound).all(), float((err / np.maximum(bound, 1e-30)).max())
    assert np.abs(np.asarray(want_c)).max() > 0 and np.isfinite(np.asarray(want)).mean() > 0.5
    if nvar > 32:
        assert (np.asarray(want_d)[..., 32:] != 0).any()


def test_sr_evaluator_matches_jax_n2048():
    """``max_nodes=2048``: the general path on both, trees grown to depth
    10."""
    jf = jax_function_set(OPS, [["x0", "x1"]], [2])
    pop = jax_population(jf, 2048, 10, 6, chain=False)
    rng = np.random.default_rng(4)
    x0s = rng.uniform(-1.0, 1.0, (4, 2)).astype(np.float32)
    ts = (np.arange(6) * 0.2).astype(np.float32)
    ys = rng.uniform(-1.0, 1.0, (4, 6, 2)).astype(np.float32)
    jdata = (jnp.asarray(x0s), jnp.asarray(ts), jnp.asarray(ys), None)
    ref = np.asarray(jax.jit(JaxSREvaluator(jf, substeps=1, interpreter="gather").evaluate_population)(
        JaxTrees(*(jnp.asarray(a) for a in pop)), jdata))
    ev = SREvaluator(function_set_from_jax(jf), substeps=1)
    trees, tdata = trees_from_numpy(*pop), sr_data_from_numpy(x0s, ts, ys)
    assert not ev._fused(trees, tdata[0])
    truth, env = float64_envelope(
        lambda p, x: float64_fitness(jf, p, (x, ts, ys), 1, "rk4"), pop, x0s)
    assert_close_within_envelope(ev.evaluate_population(trees, tdata).numpy(), ref, truth, env)


def lorenz96_case(count, depth=2, seed=7):
    """JAX's 40-variable, 40-tree set, a JAX-grown population and the
    Lorenz-96 data (``test_torch_kernels.lorenz96_data``: 2 trajectories, T
    = 6) as numpy arrays."""
    names = [f"x{i}" for i in range(40)]
    jf = jax_function_set(OPS, [names], [40])
    pop = jax_population(jf, 32, depth, count, chain=False, seed=seed)
    x0s, ts, ys = (t.numpy() for t in lorenz96_data(2, 6, seed=seed))
    return jf, pop, (x0s, ts, ys)


@pytest.mark.parametrize("interpreter", ["auto", "gather"])
def test_sr_evaluator_matches_jax_lorenz96(interpreter):
    """Lorenz-96 with 40 states: 40 trees a candidate; with
    ``interpreter="auto"`` the port's fused path (kernel #1's wide instance on
    the card, its plain version here), with ``"gather"`` the general path;
    JAX's general path the reference."""
    jf, pop, (x0s, ts, ys) = lorenz96_case(4)
    jdata = (jnp.asarray(x0s), jnp.asarray(ts), jnp.asarray(ys), None)
    ref = np.asarray(jax.jit(JaxSREvaluator(jf, substeps=1, interpreter="gather").evaluate_population)(
        JaxTrees(*(jnp.asarray(a) for a in pop)), jdata))
    ev = SREvaluator(function_set_from_jax(jf), substeps=1, interpreter=interpreter)
    trees, tdata = trees_from_numpy(*pop), sr_data_from_numpy(x0s, ts, ys)
    assert trees.ops.shape == (4, 40, 32) and ev._fused(trees, tdata[0]) == (interpreter == "auto")
    assert_fitness_close(ev.evaluate_population(trees, tdata).numpy(), ref)


def test_lorenz96_generation_with_forty_trees():
    """One generation of the host loop with 40 trees a candidate on
    Lorenz-96 data: the fused reproduction's plain version (``max_nodes=32``)
    takes 40 trees and 40 variables; every child valid, fitness finite."""
    x0s, ts, ys = lorenz96_data(2, 6, seed=3)
    gp = GeneticProgramming(
        num_generations=1, population_size=16, fitness_function=SREvaluator(substeps=1),
        operator_list=PORT_OPS, variable_list=[[f"x{i}" for i in range(40)]], layer_sizes=[40],
        num_populations=2, max_nodes=32, max_init_depth=2, device="cpu")
    assert gp.fused_reproduction
    g = torch.Generator().manual_seed(3)
    pops = gp.initialize_population(g)
    fitness, pops = gp.evaluate_population(pops, (x0s, ts, ys, None))
    children = gp.evolve(pops, fitness, g)
    assert children.ops.shape == (2, 16, 40, 32) and bool(torch.isfinite(fitness).all())
    validate_host(children.map(lambda a: a.reshape(-1, 32)), gp.fset.slots())
