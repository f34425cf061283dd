"""PyTorch port: deep trees end to end against the JAX package (CPU).

Past the fused kernels' 256 rows every evaluator takes its general path
(the integrator with the interpreter as the drift), as JAX's does; on the
card that path runs #8/#9's instance past 256 rows. Here, on the CPU, the
port's plain versions are held against JAX's gather interpreter, on the same
numpy-made inputs:

* ``evaluate_trees`` at N = 300 (trees grown to depth 7, a chain of 299
  rows among them) and its gradient in ``const`` and ``data``: forward rtol
  1e-6, gradients rtol 1e-5 (atol 1e-5 x the largest entry), the same
  entries finite; with each of JAX's ``impl`` values;
* ``SREvaluator.evaluate_population`` at N = 300 (the general path, the
  gate refuses N > 256) and at N = 128, depth 7 (the deep workload of
  ``bench.py``, fused on the port; its CPU dispatch is #1's plain
  version), fixed-step RK4, against JAX's with ``interpreter="gather"``:
  lanes clamped to ``max_fitness`` agree exactly, elsewhere median relative
  error <= 1e-6 and the largest <= 1e-4 (XLA:CPU contracts the RK updates
  into FMAs, the port does not; ``test_torch_gates.py``'s bound);
* ``StaticPolicyEvaluator.evaluate_population`` at N = 300 (its general
  path): fitness rel <= 1e-4 below ``max_fitness`` (``test_torch_policy.py``'s
  bound).

``fit()`` on the non-fused path (asked for at N = 32, by default routing at
N = 300; the host loop at N = 300 is in ``test_torch_evolve_island.py``):
every tree valid, the best fitness never increasing.
"""
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
from multitreegp_tpu.models import environments as jenvs
from multitreegp_tpu.models.evaluators import SREvaluator as JaxSREvaluator
from multitreegp_tpu.models.evaluators import StaticPolicyEvaluator as JaxStatic
from multitreegp_tpu.models.evaluators import generate_control_data as jax_generate_control
from multitreegp_tpu.ops.initialization import make_population_sampler as jax_sampler
from multitreegp_tpu_torch import GeneticProgramming
from multitreegp_tpu_torch.convert import (
    control_data_from_numpy, function_set_from_jax, sr_data_from_numpy, trees_from_numpy,
)
from multitreegp_tpu_torch.core.interpreter import IMPLS, evaluate_trees
from multitreegp_tpu_torch.core.trees import CONST, validate_host
from multitreegp_tpu_torch.models import environments as tenvs
from multitreegp_tpu_torch.models.evaluators import SREvaluator, StaticPolicyEvaluator
from multitreegp_tpu_torch.models.evaluators import generate_sr_data
from multitreegp_tpu_torch.models.environments import VanDerPolOscillator
from test_torch_kernels import chain_rows

torch.set_num_threads(1)

OPS = [("+", jnp.add, 2, 0.5), ("-", jnp.subtract, 2, 0.1), ("*", jnp.multiply, 2, 0.5),
       ("/", jnp.divide, 2, 0.1)]
PORT_OPS = [("+", 2, 0.5), ("-", 2, 0.1), ("*", 2, 0.5), ("/", 2, 0.1)]


def population(jf, n, depth, count, seed=1):
    """JAX-grown candidates ``(count, m, n)``; the first tree a chain of
    n - 1 rows (``+``/``-`` over leaves, constants 0.5)."""
    pop = [np.array(a) for a in jax_sampler(jf, depth, n)(jr.PRNGKey(seed), count)]
    ops = np.array(chain_rows(n, n - 1, jf.var_start), np.int32)
    c1, c2 = jax_rebuild_pointers(jnp.asarray(ops), jf.slots)
    pop[0][0, 0], pop[1][0, 0], pop[2][0, 0] = ops, np.asarray(c1), np.asarray(c2)
    pop[3][0, 0] = np.where(ops == CONST, 0.5, 0.0)
    return pop


def test_evaluate_trees_and_gradient_match_jax_n300():
    jf = jax_function_set(OPS, [["x0", "x1"]], [2])
    pf = function_set_from_jax(jf)
    pop = population(jf, 300, 7, 6)
    rng = np.random.default_rng(2)
    data = rng.normal(size=(6, 3, 1, 2)).astype(np.float32)
    jpop = JaxTrees(*(jnp.asarray(a)[:, None] for a in pop))
    tpop = trees_from_numpy(*pop).map(lambda a: a[:, None])

    def loss(const, d):
        out = jax_evaluate_trees(jpop._replace(const=const), d, jf, impl="gather")
        return jnp.sum(jnp.where(jnp.isfinite(out), out, 0.0)), out

    (_, want), (want_c, want_d) = jax.jit(jax.value_and_grad(loss, argnums=(0, 1), has_aux=True))(
        jpop.const, jnp.asarray(data))
    for impl in IMPLS:
        const = tpop.const.clone().requires_grad_(True)
        x = torch.from_numpy(data).requires_grad_(True)
        out = evaluate_trees(tpop._replace(const=const), x, pf, impl=impl)
        np.testing.assert_allclose(out.detach().numpy(), np.asarray(want), rtol=1e-6, atol=1e-6)
        got_c, got_d = torch.autograd.grad(torch.where(torch.isfinite(out), out, 0.0).sum(), (const, x))
        for got, ref in ((got_c, want_c), (got_d, want_d)):
            got, ref = got.numpy(), np.asarray(ref)
            np.testing.assert_array_equal(np.isfinite(got), np.isfinite(ref))
            fin = np.isfinite(ref)
            np.testing.assert_allclose(got[fin], ref[fin], rtol=1e-5,
                                       atol=1e-5 * np.abs(ref[fin]).max())
    assert np.abs(np.asarray(want_c)).max() > 0
    with pytest.raises(ValueError):
        evaluate_trees(tpop, torch.from_numpy(data), pf, impl="unrolled")


def assert_fitness_close(got, ref, max_rel=1e-4):
    assert got.shape == ref.shape and np.isfinite(got).all()
    clamped = ref == 1e5
    np.testing.assert_array_equal(got == 1e5, clamped)
    ok = ~clamped
    assert ok.any()
    rel = np.abs(got[ok] - ref[ok]) / np.maximum(np.abs(ref[ok]), 1e-12)
    assert np.median(rel) <= 1e-6 and rel.max() <= max_rel, rel


@pytest.mark.parametrize("n,depth,fused", [(300, 7, False), (128, 7, True)])
def test_sr_evaluator_matches_jax_deep(n, depth, fused):
    jf = jax_function_set(OPS, [["x0", "x1"]], [2])
    pop = population(jf, n, depth, 12)
    rng = np.random.default_rng(3)
    x0s = rng.uniform(-1.0, 1.0, (4, 2)).astype(np.float32)
    ts = (np.arange(5) * 0.2).astype(np.float32)
    ys = rng.uniform(-1.0, 1.0, (4, 5, 2)).astype(np.float32)
    jdata = (jnp.asarray(x0s), jnp.asarray(ts), jnp.asarray(ys), None)
    ref = np.asarray(jax.jit(JaxSREvaluator(jf, substeps=1, interpreter="gather").evaluate_population)(
        JaxTrees(*(jnp.asarray(a) for a in pop)), jdata))
    ev = SREvaluator(function_set_from_jax(jf), substeps=1)
    trees, tdata = trees_from_numpy(*pop), sr_data_from_numpy(x0s, ts, ys)
    assert ev._fused(trees, tdata[0]) == fused
    assert_fitness_close(ev.evaluate_population(trees, tdata).numpy(), ref)


def test_static_policy_evaluator_matches_jax_n300():
    jenv, tenv = jenvs.HarmonicOscillator(), tenvs.HarmonicOscillator()
    names = [f"y{i}" for i in range(jenv.n_obs)] + [f"tgt{i}" for i in range(jenv.n_targets)]
    jf = jax_function_set(OPS[:3], [names], [jenv.n_control])
    tf = function_set_from_jax(jf)
    jdata = jax_generate_control(jenv, jr.PRNGKey(0), jnp.arange(0.0, 1.2, 0.2), batch_size=4)
    pop = [np.array(a) for a in jax_sampler(jf, 7, 300)(jr.PRNGKey(1), 8)]
    want = jax.jit(JaxStatic(jenv, jf, substeps=2, interpreter="gather").evaluate_population)(
        JaxTrees(*(jnp.asarray(a) for a in pop)), jdata)
    ev = StaticPolicyEvaluator(tenv, tf, substeps=2)
    to_numpy = lambda t: tuple(to_numpy(a) for a in t) if isinstance(t, tuple) else np.asarray(t)
    tdata = control_data_from_numpy(*to_numpy(jdata))
    tpop = trees_from_numpy(*pop)
    assert ev._fused_kind(tpop, tdata) is None
    got = ev.evaluate_population(tpop, tdata).numpy()
    want = np.asarray(want)
    assert np.isfinite(got).all() and ((got >= 0) & (got <= 1e4)).all()
    ok = (got < 1e4) & (want < 1e4)
    assert ok.any()
    rel = np.abs(got[ok] - want[ok]) / np.maximum(np.abs(want[ok]), 1e-12)
    assert rel.max() <= 1e-4, rel.max()


@pytest.mark.parametrize("n,depth,fused", [(32, 4, False), (300, 5, None)])
def test_fit_non_fused_path(n, depth, fused):
    """``fit()`` on the non-fused path, asked for at N = 32 and by default
    routing at N = 300, with a constant-optimisation round: every tree
    valid, the best never increases."""
    g = torch.Generator().manual_seed(0)
    data = generate_sr_data(VanDerPolOscillator(), g, torch.arange(0.0, 1.0, 0.2), batch_size=4)
    gp = GeneticProgramming(
        num_generations=5, population_size=8, fitness_function=SREvaluator(substeps=1),
        operator_list=PORT_OPS, variable_list=[["x0", "x1"]], layer_sizes=[2], num_populations=2,
        max_nodes=n, max_init_depth=depth, elite_percentage=0.25, coefficient_optimisation=True,
        gradient_steps=2, coefficient_opt_top_k=4, fused_reproduction=fused, device="cpu")
    gp._optimise_due = lambda gen: gen == 3
    assert not gp.fused_reproduction
    best, sols, pops, fitness = gp.fit(g, data)
    assert torch.isfinite(best).all() and bool((best[1:] <= best[:-1]).all()), best
    validate_host(pops, gp.fset.slots())
    assert pops.ops.shape == (2, 8, 2, n) and sols.ops.shape == (5, 2, n)
