"""PyTorch port: the closed-loop policy path's evaluators (static and
dynamic), their gradient and host loop, against the JAX package.

Tolerances, and why:

* the evaluators' general path and fitness against JAX's (``interpreter=
  "gather"``), T = 11, 2 substeps, ``+ - * sin cos``: identical alive on
  >= 98% of lanes; on lanes alive in both, the largest state difference
  within 1e-4 of the lane's largest |state|; fitness rel <= 1e-4 on
  candidates below ``max_fitness`` in both. XLA:CPU contracts updates into
  FMAs and has its own ``sin``/``cos``, and the plants amplify ulps.
* the gradient of the summed fitness through ``PolicyRollout`` against
  ``jax.grad`` of the JAX evaluator (harmonic oscillator, ``+ - *``,
  T = 6): the same entries finite, rtol 1e-3 where finite.

The kernels' plain versions and host build are checked in
``test_torch_policy_kernel.py``, and on the card in ``test_torch_kernels.py``.
"""
import jax
import jax.numpy as jnp
import jax.random as jr
import numpy as np
import pytest
import torch

from multitreegp_tpu.core.registry import build_function_set as jax_function_set
from multitreegp_tpu.models import environments as jenvs
from multitreegp_tpu.models.evaluators import DynamicPolicyEvaluator as JaxDynamic
from multitreegp_tpu.models.evaluators import StaticPolicyEvaluator as JaxStatic
from multitreegp_tpu.models.evaluators import generate_control_data as jax_generate
from multitreegp_tpu.ops.initialization import make_population_sampler as jax_sampler
from multitreegp_tpu_torch import GeneticProgramming
from multitreegp_tpu_torch.convert import (
    control_data_from_numpy, function_set_from_jax, trees_from_numpy,
)
from multitreegp_tpu_torch.core import cuda_policy as cp
from multitreegp_tpu_torch.models import environments as tenvs
from multitreegp_tpu_torch.models.evaluators import (
    DynamicPolicyEvaluator, StaticPolicyEvaluator, generate_control_data,
)

torch.set_num_threads(1)

OPS = [("+", jnp.add, 2, 0.5), ("-", jnp.subtract, 2, 0.1), ("*", jnp.multiply, 2, 0.5),
       ("sin", jnp.sin, 1, 0.3), ("cos", jnp.cos, 1, 0.3)]


def to_numpy(tree):
    return tuple(to_numpy(a) for a in tree) if isinstance(tree, tuple) else np.asarray(tree)


def case(name, mode="Constant", state_size=0, pop=16, b=4, t_end=2.2, nodes=16, ops=OPS, seed=0,
         **env_kw):
    """The JAX and torch environment, function set, data and population."""
    jenv, tenv = getattr(jenvs, name)(**env_kw), getattr(tenvs, name)(**env_kw)
    ys = [f"y{i}" for i in range(jenv.n_obs)]
    tg = [f"tgt{i}" for i in range(jenv.n_targets)]
    if state_size:
        a = [f"a{i}" for i in range(state_size)]
        u = [f"u{i}" for i in range(jenv.n_control)]
        jf = jax_function_set(ops, [ys + a + u + tg, a + tg], [state_size, jenv.n_control])
    else:
        jf = jax_function_set(ops, [ys + tg], [jenv.n_control])
    ts = jnp.arange(0.0, t_end, 0.2)
    jdata = jax_generate(jenv, jr.PRNGKey(seed), ts, batch_size=b, param_mode=mode)
    jpop = jax_sampler(jf, 3, nodes)(jr.PRNGKey(seed + 1), pop)
    tdata = control_data_from_numpy(*to_numpy(jdata))
    tpop = trees_from_numpy(*[np.asarray(x) for x in jpop])
    return jenv, tenv, jf, function_set_from_jax(jf), jdata, tdata, jpop, tpop


def evaluators(jenv, tenv, jf, tf, state_size, **kw):
    if state_size:
        return (JaxDynamic(jenv, jf, state_size=state_size, interpreter="gather", **kw),
                DynamicPolicyEvaluator(tenv, tf, state_size=state_size, **kw))
    return JaxStatic(jenv, jf, interpreter="gather", **kw), StaticPolicyEvaluator(tenv, tf, **kw)


def assert_lanes_agree(xs, alive, ref_xs, ref_alive, share=0.98, tol=1e-4):
    """Identical final alive on ``share`` of the lanes; on lanes alive in
    both, the largest state difference within ``tol`` of the lane's largest
    |state|. xs ``(T, P, B, d)``, alive ``(T, P, B)``."""
    a, r = np.asarray(alive)[-1], np.asarray(ref_alive)[-1]
    assert (a == r).mean() >= share, (a == r).mean()
    both = a & r
    assert both.any()
    x, rx = np.asarray(xs)[:, both], np.asarray(ref_xs)[:, both]
    lane_rel = np.abs(x - rx).max(axis=(0, 2)) / np.maximum(np.abs(rx).max(axis=(0, 2)), 1e-6)
    assert lane_rel.max() <= tol, lane_rel.max()


def assert_fitness_agree(got, want, max_fitness=1e4, tol=1e-4):
    got, want = np.asarray(got), np.asarray(want)
    assert np.isfinite(got).all() and ((got >= 0) & (got <= max_fitness)).all()
    ok = (got < max_fitness) & (want < max_fitness)
    assert ok.any()
    rel = np.abs(got[ok] - want[ok]) / np.maximum(np.abs(want[ok]), 1e-12)
    assert rel.max() <= tol, rel.max()


GENERAL_CASES = [("Acrobot", "Constant"), ("HarmonicOscillator", "Constant"),
                 ("HarmonicOscillator", "Switch"), ("HarmonicOscillator", "Decay"),
                 ("HarmonicOscillator2", "Constant"), ("CartPole", "Constant")]


# -------------------------------------------- (a) the evaluators against JAX

@pytest.mark.parametrize("state_size", [0, 2])
@pytest.mark.parametrize("name,mode", GENERAL_CASES)
def test_evaluator_matches_jax(name, mode, state_size):
    jenv, tenv, jf, tf, jdata, tdata, jpop, tpop = case(name, mode, state_size)
    jev, tev = evaluators(jenv, tenv, jf, tf, state_size, substeps=2)
    (jxs, jal), jfit = jax.jit(lambda p, d: (jev._rollout_general(p, d),
                                             jev.evaluate_population(p, d)))(jpop, jdata)
    txs, tal = tev._rollout_general(tpop, tdata)
    assert_lanes_agree(txs, tal, jxs, jal)
    assert_fitness_agree(tev.evaluate_population(tpop, tdata), jfit)  # the fused plain path


# ------------------------------------------------------- (f) the gradient

def test_policy_gradient_matches_jax():
    ops = OPS[:3]
    jenv, tenv, jf, tf, jdata, tdata, jpop, tpop = case("HarmonicOscillator", pop=8, t_end=1.2,
                                                        ops=ops)
    jev = JaxStatic(jenv, jf, substeps=2, interpreter="gather")
    jgrad = jax.jit(jax.grad(lambda c: jev.evaluate_population(jpop._replace(const=c), jdata).sum()))
    want = np.asarray(jgrad(jpop.const))
    ev = StaticPolicyEvaluator(tenv, tf, substeps=2)
    const = tpop.const.clone().requires_grad_(True)
    (got,) = torch.autograd.grad(ev.evaluate_population(tpop._replace(const=const), tdata).sum(),
                                 (const,))
    got = got.numpy()
    fin = np.isfinite(want)
    np.testing.assert_array_equal(np.isfinite(got), fin)
    assert np.abs(want[fin]).max() > 0
    np.testing.assert_allclose(got[fin], want[fin], rtol=1e-3, atol=1e-6 * np.abs(want[fin]).max())


@pytest.mark.parametrize("state_size", [0, 1])
def test_optimise_with_policy_evaluator_never_worse(state_size):
    _, tenv, _, tf, _, tdata, _, tpop = case("HarmonicOscillator", state_size=state_size, pop=8,
                                              t_end=1.2, ops=OPS[:3])
    names = list(tf.variable_names)
    layers = ([names] if not state_size else
              [names, [n for n in names if n.startswith(("a", "tgt"))]])
    gp = GeneticProgramming(
        num_generations=1, population_size=8, operator_list=[("+", 2), ("-", 2), ("*", 2)],
        fitness_function=evaluators(None, tenv, None, None, state_size, substeps=2)[1],
        variable_list=layers, layer_sizes=list(tf.layer_sizes), max_nodes=16, gradient_steps=3,
        device="cpu")
    before = gp.evaluator.evaluate_population(tpop, tdata)
    after, refined = gp.optimise(tpop, tdata)
    assert bool((after <= before).all()) and bool((after < before).any())
    torch.testing.assert_close(gp.evaluator.evaluate_population(refined, tdata), after, rtol=0,
                               atol=0)


# -------------------------------------------------------------- (g) noise

def test_evaluators_refuse_noise():
    """The noisy evaluators match JAX; the name is kept from when they
    refused noise. Observation noise and ``stochastic=True``, fixed step and
    adaptive (``tests/test_torch_sde_policy.py`` holds the paths' states).
    The adaptive method with observation noise draws at per-lane solver
    times that part from JAX's by ulps, so its fitness is held within 5%
    here and its first step exactly there."""
    for kw, ev_kw in ((dict(obs_noise=0.1), {}), (dict(process_noise=0.1), dict(stochastic=True))):
        jenv, tenv, jf, tf, jdata, tdata, jpop, tpop = case("HarmonicOscillator", pop=4, t_end=0.6,
                                                            **kw)
        for method in ("rk4", "adaptive"):
            jev, tev = evaluators(jenv, tenv, jf, tf, 0, method=method, **ev_kw)
            want = jax.jit(jev.evaluate_population)(jpop, jdata)
            tol = 5e-2 if method == "adaptive" and "obs_noise" in kw else 1e-4
            assert_fitness_agree(tev.evaluate_population(tpop, tdata), want, tol=tol)
    # process noise without stochastic=True is the deterministic rollout
    _, tenv, _, tf, _, tdata, _, tpop = case("HarmonicOscillator", pop=4, t_end=0.6,
                                              process_noise=0.1)
    assert StaticPolicyEvaluator(tenv, tf).evaluate_population(tpop, tdata).shape == (4,)


def test_dispatch_follows_configuration(monkeypatch):
    """#6 for a fixed-step method with the data vector's variables and
    N <= 256; #7 for the adaptive method with per-trajectory parameters;
    the general path otherwise (``interpreter="gather"``, series parameters
    in the adaptive method, a variable set of another width)."""
    calls = []
    for name in ("policy_rollout_plain", "policy_rollout_adaptive_plain"):
        fn = getattr(cp, name)
        monkeypatch.setattr(cp, name, lambda *a, _n=name, _f=fn, **k: calls.append(_n) or _f(*a, **k))
    _, tenv, _, tf, _, tdata, _, tpop = case("HarmonicOscillator", "Switch", pop=4, t_end=0.6)
    _, _, _, _, _, tdata_c, _, _ = case("HarmonicOscillator", pop=4, t_end=0.6)
    StaticPolicyEvaluator(tenv, tf).evaluate_population(tpop, tdata)
    StaticPolicyEvaluator(tenv, tf, method="adaptive").evaluate_population(tpop, tdata_c)
    assert calls == ["policy_rollout_plain", "policy_rollout_adaptive_plain"]
    StaticPolicyEvaluator(tenv, tf, interpreter="gather").evaluate_population(tpop, tdata)
    StaticPolicyEvaluator(tenv, tf, method="adaptive").evaluate_population(tpop, tdata)
    wide = function_set_from_jax(jax_function_set(OPS, [["y0", "y1", "tgt0", "extra"]], [1]))
    StaticPolicyEvaluator(tenv, wide).evaluate_population(tpop, tdata_c)
    assert len(calls) == 2


# ------------------------------------------------------ (h) the host loop

@pytest.mark.parametrize("state_size", [0, 2])
def test_host_loop_improves_and_renders_trig(state_size):
    env = tenvs.Acrobot()
    ys = [f"y{i}" for i in range(4)]
    ops = [("+", 2), ("-", 2), ("*", 2), ("sin", 1), ("cos", 1)]
    if state_size:
        ev = DynamicPolicyEvaluator(env, state_size=2, substeps=2)
        layers, sizes = [ys + ["a0", "a1", "u0"], ["a0", "a1"]], [2, 1]
    else:
        ev, layers, sizes = StaticPolicyEvaluator(env, substeps=2), [ys], [1]
    gp = GeneticProgramming(num_generations=4, population_size=16, fitness_function=ev,
                            operator_list=ops, variable_list=layers, layer_sizes=sizes,
                            num_populations=2, max_nodes=16, max_init_depth=3, device="cpu")
    g = torch.Generator().manual_seed(0)
    data = generate_control_data(env, g, torch.arange(0.0, 2.2, 0.2), batch_size=4)
    pops = gp.initialize_population(g)
    best = []
    for _ in range(4):
        fitness, pops = gp.evaluate_population(pops, data)
        assert bool(((fitness >= 0) & (fitness <= 1e4)).all())
        best.append(float(fitness.min()))
        pops = gp.evolve(pops, fitness, g)
    assert all(b1 <= b0 for b0, b1 in zip(best, best[1:]))
    sin, cos = gp.fset.string_to_op["sin"], gp.fset.string_to_op["cos"]
    flat = pops.ops.reshape(-1, pops.ops.shape[-2], 16)
    cand = next(i for i in range(flat.shape[0])
                if bool(((flat[i] == sin) | (flat[i] == cos)).any()))
    text = gp.to_string(pops.map(lambda a: a.reshape((-1,) + a.shape[2:]))[cand])
    assert "sin" in text or "cos" in text
