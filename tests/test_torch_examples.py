"""PyTorch port: the notebook examples (``multitreegp_tpu_torch/examples``)
against the JAX package's ``examples/*.py``, at a tiny size on the CPU.

* Each example's ``build`` holds the JAX example's configuration, rebuilt
  here from the literals of ``examples/*.py`` (the JAX ``GeneticProgramming``
  with the same arguments): the same function set (opcodes, probabilities,
  per-tree variables), sizes, parsimony and evaluator settings. One numpy
  population and JAX's data (its grid cut to 6 save points), passed through
  ``convert.py``, go through both evaluators (JAX's general path with
  ``interpreter="gather"``, the port's fused plain version) and agree within
  the tolerance of the path's existing test: fixed-step SR as
  ``test_torch_deep.assert_fitness_close`` (the same candidates clamped,
  median rel 1e-6, max 1e-4; an ill-conditioned lane, one that one-ulp
  nudges of its inputs move by more than 2.5e-5 in float64, within 4x that
  envelope of JAX and of the float64 result: ``test_torch_deep.
  assert_close_within_envelope``), adaptive SR rtol 1e-4 below ``max_fitness``
  in both (``test_torch_adaptive.py``), the policies rel 1e-4 below
  ``max_fitness`` (``test_torch_policy.assert_fitness_agree``).
* ``main(device="cpu")`` for 3 generations of 20 x 2 candidates (2 elites
  an island; 8 would keep none; the save grid cut to 5 points): a finite
  best-fitness history in ``[0, max_fitness + size_parsimony * m * N]``
  that never increases, equal to the shared loop ``run`` on ``build``'s
  objects; the last population valid; ``fit()`` for ``--fused``; the
  dynamic example's readout trees holding only ``a0``/``a1`` after 5
  generations.
* ``python -m multitreegp_tpu_torch.examples.symbolic_regression --device
  cpu --generations 2 --population 8 --islands 2`` (at the notebook's full
  horizon) and ``python -m ...static_policy --help`` / ``...dynamic_policy
  --help`` (their plain rollouts take 18 s and 38 s an evaluation on the CPU
  at the full horizon), in parallel subprocesses, exit 0, and no module of
  ``jax`` is imported (``-X importtime``).
"""
import os
import subprocess
import sys
from pathlib import Path

import jax
import jax.numpy as jnp
import jax.random as jr
import numpy as np
import pytest
import torch

from chip_smoke import cut_grid
from multitreegp_tpu import GeneticProgramming as JaxGP
from multitreegp_tpu.core.trees import TreeTensors as JaxTrees
from multitreegp_tpu.models.environments import Acrobot as JaxAcrobot
from multitreegp_tpu.models.environments import VanDerPolOscillator as JaxVdP
from multitreegp_tpu.models.evaluators import DynamicPolicyEvaluator as JaxDynamic
from multitreegp_tpu.models.evaluators import SREvaluator as JaxSR
from multitreegp_tpu.models.evaluators import StaticPolicyEvaluator as JaxStatic
from multitreegp_tpu.models.evaluators import generate_control_data as jax_control_data
from multitreegp_tpu.models.evaluators import generate_sr_data as jax_sr_data
from multitreegp_tpu.ops.initialization import make_population_sampler as jax_sampler
from multitreegp_tpu_torch.convert import (
    control_data_from_numpy, sr_data_from_numpy, trees_from_numpy,
)
from multitreegp_tpu_torch.core.trees import validate_host
from multitreegp_tpu_torch.examples import dynamic_policy, run, static_policy, symbolic_regression
from test_torch_deep import assert_close_within_envelope, float64_envelope, float64_fitness
from test_torch_policy import assert_fitness_agree, to_numpy

torch.set_num_threads(1)

ROOT = Path(__file__).resolve().parents[1]
TRIG = [("+", jnp.add, 2), ("-", jnp.subtract, 2), ("*", jnp.multiply, 2), ("sin", jnp.sin, 1),
        ("cos", jnp.cos, 1)]


def jax_example(name, adaptive=False):
    """The JAX example's strategy and data, from the literals of
    ``examples/<name>.py`` (3 generations of 8 x 2, the grid cut to 6
    points)."""
    key = jr.PRNGKey(0)
    if name == "symbolic_regression":
        data = jax_sr_data(JaxVdP(process_noise=0.0, obs_noise=0.0), key,
                           jnp.arange(0.0, 20.0, 0.2)[:6], batch_size=16)
        ev = (JaxSR(method="adaptive", adaptive_method="dopri5", rtol=1e-6, atol=1e-6,
                    adaptive_budget=500) if adaptive else JaxSR(substeps=4))
        kw = dict(operator_list=[("+", jnp.add, 2, 0.5), ("-", jnp.subtract, 2, 0.1),
                                 ("*", jnp.multiply, 2, 0.5), ("/", jnp.divide, 2, 0.1)],
                  variable_list=[["x0", "x1"]], layer_sizes=[2])
    else:
        env = JaxAcrobot(process_noise=0.0, obs_noise=0.0)
        data = jax_control_data(env, key, jnp.arange(0.0, 50.0, 0.2)[:6], batch_size=16)
        ys = [f"y{i}" for i in range(env.n_obs)]
        if name == "static_policy":
            ev = (JaxStatic(env, method="adaptive", adaptive_method="dopri5", rtol=1e-4,
                            atol=1e-4, substeps=8) if adaptive else JaxStatic(env, substeps=4))
            kw = dict(variable_list=[ys], layer_sizes=[env.n_control])
        else:
            ev = JaxDynamic(env, state_size=2, substeps=4)
            hidden, controls = ["a0", "a1"], [f"u{i}" for i in range(env.n_control)]
            kw = dict(variable_list=[ys + hidden + controls, hidden],
                      layer_sizes=[2, env.n_control])
        kw.update(operator_list=TRIG, size_parsimony=1.0)
    gp = JaxGP(num_generations=3, population_size=8, fitness_function=ev, num_populations=2,
               max_init_depth=4, max_nodes=30, **kw)
    return gp, data


CASES = [("symbolic_regression", False), ("symbolic_regression", True), ("static_policy", False),
         ("static_policy", True), ("dynamic_policy", False)]
MODULES = {"symbolic_regression": symbolic_regression, "static_policy": static_policy,
           "dynamic_policy": dynamic_policy}


def port_build(name, adaptive, **sizes):
    kw = {} if name == "dynamic_policy" else dict(adaptive=adaptive)
    return MODULES[name].build(0, "cpu", 3, 8, 2, **kw, **sizes)


@pytest.mark.parametrize("name,adaptive", CASES)
def test_build_holds_jax_example_configuration(name, adaptive):
    jgp, jdata = jax_example(name, adaptive)
    gp, _, _ = port_build(name, adaptive)
    for attr in ("num_generations", "population_size", "num_populations", "max_init_depth",
                 "max_nodes", "size_parsimony", "num_trees", "elite_size", "migration_size"):
        assert getattr(gp, attr) == getattr(jgp, attr), attr
    jf, tf = jgp.fset, gp.fset
    assert tf.string_to_op == dict(jf.string_to_op) and tf.layer_sizes == tuple(jf.layer_sizes)
    np.testing.assert_array_equal(tf.probs().numpy(), np.asarray(jf.operator_probs))
    np.testing.assert_array_equal(tf.variable_mask.numpy(), np.asarray(jf.variable_mask))
    jev, ev = jgp.evaluator, gp.evaluator
    assert type(ev).__name__ == type(jev).__name__
    for attr in ("method", "substeps", "rtol", "atol", "adaptive_method", "adaptive_budget",
                 "max_fitness", "interpreter", "process_noise", "stochastic"):
        assert getattr(ev, attr, None) == getattr(jev, attr, None), attr
    if name != "symbolic_regression":  # the port's static evaluator has state_size 0
        assert ev.state_size == getattr(jev, "state_size", 0)

    # one numpy population and JAX's data through both evaluators
    pop = [np.asarray(a) for a in jax_sampler(jf, 4, 30)(jr.PRNGKey(1), 16)]
    jev.interpreter = "gather"  # JAX's general path, jitted
    want = np.asarray(jax.jit(jev.evaluate_population)(JaxTrees(*(jnp.asarray(a) for a in pop)),
                                                       jdata))
    trees = trees_from_numpy(*pop)
    if name == "symbolic_regression":
        tdata = sr_data_from_numpy(*jdata)
        assert ev._fused(trees, tdata[0])  # the port's #1 / #5 plain version
        got = ev.evaluate_population(trees, tdata).numpy()
        if adaptive:
            ok = (got < 1e5) & (want < 1e5)
            assert ok.sum() >= 4
            np.testing.assert_allclose(got[ok], want[ok], rtol=1e-4)
        else:  # a few lanes are ill-conditioned (test_torch_deep.ill_conditioned)
            truth, env = float64_envelope(
                lambda p, x0s: float64_fitness(jf, p, (x0s,) + tuple(jdata[1:]), 4, "rk4"),
                pop, np.asarray(jdata[0]))
            assert_close_within_envelope(got, want, truth, env)
    else:
        tdata = control_data_from_numpy(*to_numpy(jdata))
        assert ev._fused_kind(trees, tdata) == ("adaptive" if adaptive else "fixed")  # #7 / #6
        assert_fitness_agree(ev.evaluate_population(trees, tdata), want)


def fitness_bound(strategy):
    """The largest fitness a candidate can have: the evaluator's clamp plus
    the parsimony term of a full tree per tree."""
    return (strategy.evaluator.max_fitness
            + strategy.size_parsimony * strategy.num_trees * strategy.max_nodes)


def check_history(history, strategy):
    assert history.shape == (strategy.num_generations,) and bool(torch.isfinite(history).all())
    assert bool(((history >= 0) & (history <= fitness_bound(strategy))).all())
    assert bool((history[1:] <= history[:-1]).all()), history


def cut(built, k=5):
    """``build``'s ``(strategy, data, generator)`` with the data on the first
    ``k`` points of its save grid."""
    strategy, data, generator = built
    return strategy, cut_grid(data, k), generator


@pytest.mark.parametrize("name,adaptive", [("symbolic_regression", False), ("static_policy", True),
                                           ("dynamic_policy", False)])
def test_main_and_loop_on_cpu(name, adaptive, monkeypatch):
    """20 x 2 candidates: the default ``elite_percentage`` keeps 2 elites an
    island (none at 8), so the best never increases. ``main`` runs with
    ``build`` cutting the save grid."""
    mod = MODULES[name]
    kw = {} if name == "dynamic_policy" else dict(adaptive=adaptive)
    build = mod.build
    monkeypatch.setattr(mod, "build", lambda *a, **k: cut(build(*a, **k)))
    history = mod.main(3, 20, 2, 0, device="cpu", verbose=False, **kw)
    strategy, data, generator = cut(build(0, "cpu", 3, 20, 2, **kw))
    assert strategy.elite_size == 2 and data[1].shape == (5,)
    check_history(history, strategy)
    again, populations = run(strategy, data, generator)
    assert torch.equal(again.cpu(), history)  # main is build + run, from the seed
    validate_host(populations, strategy.fset.slots())
    assert populations.ops.shape == (2, 20, strategy.num_trees, 30)


def test_sr_fused_runs_fit():
    strategy, data, generator = cut(symbolic_regression.build(1, "cpu", 3, 20, 2))
    lines = []
    history, populations = run(strategy, data, generator, fused=True,
                               log=lambda gen, best, expr: lines.append((gen, best, expr)))
    check_history(history, strategy)
    validate_host(populations, strategy.fset.slots())
    assert [g for g, _, _ in lines] == [0, 2] and lines[-1][1] == float(history[-1])


def test_dynamic_readout_reads_only_the_hidden_state():
    strategy, data, generator = cut(dynamic_policy.build(2, "cpu", 5, 20, 2))
    history, populations = run(strategy, data, generator)
    check_history(history, strategy)
    fset = strategy.fset
    readout = populations.ops[:, :, 2]  # layer 1: the control's tree
    variables = readout[readout >= fset.var_start]
    allowed = torch.tensor([fset.string_to_op["a0"], fset.string_to_op["a1"]], dtype=torch.int32)
    assert variables.numel() > 0 and bool(torch.isin(variables, allowed).all())
    state_eq = populations.ops[:, :, :2]
    assert bool((state_eq >= fset.var_start).any())


FLAGS = {"symbolic_regression": ["--device", "cpu", "--generations", "2", "--population", "8",
                                  "--islands", "2"],
         "static_policy": ["--help"], "dynamic_policy": ["--help"]}


def test_examples_run_as_modules_without_jax():
    """SR runs as a module; the policies' modules (whose loops
    ``test_main_and_loop_on_cpu`` runs through ``main``) print their flags:
    each exits 0 having imported no module of ``jax``."""
    env = dict(os.environ, OMP_NUM_THREADS="1", PYTHONPATH=str(ROOT))
    procs = {name: subprocess.Popen(
        [sys.executable, "-X", "importtime", "-m", f"multitreegp_tpu_torch.examples.{name}", *flags],
        cwd=ROOT, env=env, stdout=subprocess.PIPE, stderr=subprocess.PIPE, text=True)
        for name, flags in FLAGS.items()}
    for name, proc in procs.items():
        out, err = proc.communicate(timeout=600)
        assert proc.returncode == 0, (name, err[-2000:])
        imported = {line.rsplit("|", 1)[-1].strip() for line in err.splitlines()
                    if line.startswith("import time:")}
        assert "torch" in imported and not any(m == "jax" or m.startswith("jax.") for m in imported)
        if name == "symbolic_regression":
            assert "gen    1  best fitness" in out and "evaluate" in out, out
        else:
            flags = ["--generations", "--population", "--islands", "--seed", "--device"]
            flags += ["--adaptive"] if name == "static_policy" else []
            assert all(f in out for f in flags), out
