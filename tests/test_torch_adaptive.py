"""PyTorch port: adaptive SR (Dopri5/Bosh3 + step control) against the JAX
package, and the adaptive kernels' host build against their plain versions.

Tolerances, and why:

* ``integrate_adaptive`` on analytic drifts (``dx = -x``, a harmonic
  oscillator): rtol 1e-5 against JAX's. On sampled Van der Pol candidates
  (T = 5): identical alive on >= 98% of lanes and, on lanes alive in both,
  the largest state difference within 1e-4 of the lane's largest |state|. XLA:CPU contracts the stage updates into FMAs and the port
  does not, and an ulp in ``dt`` can flip an accept near ``err = 1``.
* host build of ``csrc/sr_adaptive.cu`` against the plain versions of
  kernels #5 and #4: with the plain versions' ``torch.pow`` replaced by the
  host's ``powf`` (glibc) and ``torch.sqrt`` by a correctly rounded one,
  every output bit for bit. With PyTorch's own CPU functions: identical
  alive on >= 99.5% of lanes and rel <= 1e-3 on lanes alive in both. Both
  differ from the host's by an ulp on some inputs: ``pow`` on about 1% of
  inputs at the controller's exponents -0.2 and -1/3, ``sqrt`` (not
  correctly rounded on the CPU) on about 0.7%; an ulp in ``err`` moves the
  next ``dt``.
* the two plain versions when neither budget binds: bit for bit.
* the plain version of #5 against JAX's ``rollout_sr_fitness_adaptive_global_pallas``
  in interpret mode: identical alive, mse rel <= 1e-5 on lanes alive in both.
* the evaluator against JAX's: rtol 1e-4 on candidates below ``max_fitness``
  in both; the gradient of the summed fitness: the same entries non-finite
  (every constant that reaches the rollout, in both; see the test), rtol
  1e-3 where both are finite.

The same checks on the card are in ``test_torch_kernels.py`` (marker
``cuda``), which imports no JAX.
"""
import ctypes

import jax
import jax.numpy as jnp
import jax.random as jr
import numpy as np
import pytest
import torch
from jax.experimental.pallas import tpu as pltpu

from multitreegp_tpu.core import pallas_rollout as jax_rollout
from multitreegp_tpu.core.interpreter import evaluate_trees as jax_evaluate
from multitreegp_tpu.core.registry import build_function_set as jax_function_set
from multitreegp_tpu.models.environments import VanDerPolOscillator as JaxVdP
from multitreegp_tpu.models.evaluators import SREvaluator as JaxSREvaluator
from multitreegp_tpu.models.evaluators import generate_sr_data as jax_generate
from multitreegp_tpu.models.integrators import integrate_adaptive as jax_integrate_adaptive
from multitreegp_tpu.ops.initialization import make_population_sampler as jax_sampler
from multitreegp_tpu_torch import GeneticProgramming, _build
from multitreegp_tpu_torch.convert import function_set_from_jax, sr_data_from_numpy, trees_from_numpy
from multitreegp_tpu_torch.core import cuda_adaptive as ca
from multitreegp_tpu_torch.core.interpreter import evaluate_trees
from multitreegp_tpu_torch.models.evaluators import SREvaluator
from multitreegp_tpu_torch.models.integrators import adaptive_step_budget, integrate_adaptive
from test_torch_kernels import ARITH, TRIG, fitness_case, patch_host_math, state4_case

torch.set_num_threads(1)

OPS = [("+", jnp.add, 2, 0.5), ("-", jnp.subtract, 2, 0.1), ("*", jnp.multiply, 2, 0.5),
       ("/", jnp.divide, 2, 0.1)]
METHODS = ["bosh3", "dopri5"]


def vdp_case(t_end=1.0, batch=4, pop=24, nodes=16, seed=1, ops=OPS):
    """JAX function set, data and population, and the same as torch objects."""
    jf = jax_function_set(ops, [["x0", "x1"]], [2])
    ts = jnp.arange(0.0, t_end, 0.2)
    data = jax_generate(JaxVdP(0.0, 0.0), jr.PRNGKey(0), ts, batch_size=batch, substeps=8)
    jpop = jax_sampler(jf, 3, nodes)(jr.PRNGKey(seed), pop)
    tdata = sr_data_from_numpy(*data[:3])
    tpop = trees_from_numpy(*[np.asarray(a) for a in jpop])
    return jf, data, jpop, function_set_from_jax(jf), tdata, tpop


def rel(a, b):
    return np.abs(a - b) / np.maximum(np.abs(b), 1e-12)


# ------------------------------------------------------- (a) the integrator

def exp_drift(t, x):
    return -x


def harmonic(xp):
    def drift(t, x):
        return xp.stack([x[..., 1], -36.0 * x[..., 0]], axis=-1)
    return drift


@pytest.mark.parametrize("method", METHODS)
@pytest.mark.parametrize("case", ["exponential", "harmonic"])
def test_integrate_adaptive_analytic_matches_jax(method, case):
    if case == "exponential":
        ts = np.arange(0.0, 3.01, 0.5, dtype=np.float32)
        x0 = np.asarray([[1.0], [2.0], [-0.5]], np.float32)
        jdrift, tdrift, kw = exp_drift, exp_drift, dict(rtol=1e-5, atol=1e-8)
    else:
        ts = np.arange(0.0, 2.01, 0.25, dtype=np.float32)
        x0 = np.asarray([[1.0, 0.0], [0.5, 1.0]], np.float32)
        jdrift, tdrift = harmonic(jnp), harmonic(torch)
        # solver rtol 1e-5: at 1e-6 bosh3 takes ~200 steps per interval and
        # XLA's FMA roundings add up to 1.1e-5 relative
        kw = dict(rtol=1e-5, atol=1e-7, max_steps_per_interval=256 if method == "bosh3" else 64)
    jxs, jalive = jax.jit(lambda x, t: jax_integrate_adaptive(jdrift, x, t, method=method, **kw))(
        jnp.asarray(x0), jnp.asarray(ts))
    xs, alive = integrate_adaptive(tdrift, torch.from_numpy(x0), torch.from_numpy(ts),
                                   method=method, **kw)
    assert bool(alive.all()) and bool(np.asarray(jalive).all())
    np.testing.assert_allclose(xs.numpy(), np.asarray(jxs), rtol=1e-5, atol=1e-7)


@pytest.mark.parametrize("method", METHODS)
def test_integrate_adaptive_candidates_match_jax(method):
    """Per lane, rel is the largest state difference over the lane's largest
    |state|: an elementwise ratio blows up where a component crosses 0."""
    jf, data, jpop, tf, tdata, tpop = vdp_case(t_end=1.0, pop=64, seed=2)
    x0 = np.broadcast_to(np.asarray(data[0])[None], (64, 4, 2))
    jtrees = jpop[:, None]

    @jax.jit
    def jrun(x, t):
        drift = lambda tt, xx: jax_evaluate(jtrees, xx[:, :, None, :], jf, impl="gather")
        return jax_integrate_adaptive(drift, x, t, max_steps_per_interval=16, method=method)

    jxs, jalive = jrun(jnp.asarray(x0), data[1])
    ttrees = tpop.map(lambda a: a[:, None])
    xs, alive = integrate_adaptive(
        lambda t, x: evaluate_trees(ttrees, x[:, :, None, :], tf), torch.from_numpy(x0.copy()),
        tdata[1], max_steps_per_interval=16, method=method)
    ja, ta = np.asarray(jalive[-1]), alive[-1].numpy()
    assert (ja == ta).mean() >= 0.98 and ta.any() and (~ta).any()
    both = ja & ta
    jx, tx = np.asarray(jxs)[:, both], xs.numpy()[:, both]  # (T, lanes, d)
    lane_rel = np.abs(tx - jx).max(axis=(0, 2)) / np.abs(jx).max(axis=(0, 2))
    assert lane_rel.max() <= 1e-4


def test_adaptive_step_budget():
    assert adaptive_step_budget(4) == 32 and adaptive_step_budget(8) == 8
    assert adaptive_step_budget(1, floor=16) == 16


# ------------------------------------------- (b) host build of #5 and #4

@pytest.fixture(scope="module")
def adaptive_host(tmp_path_factory):
    return _build.build_host("sr_adaptive", tmp_path_factory.mktemp("adaptive_host"))


def host_run(lib, kind, trees, x0s, ts, ys, fset, budget, method, rtol=1e-4, atol=1e-6):
    p, d, n = trees.ops.shape
    b = x0s.shape[0]
    err, alive, steps = np.zeros((p, b), np.float32), np.zeros((p, b), np.uint8), np.zeros((p, b), np.int32)
    arrays = [np.ascontiguousarray(a.numpy()) for a in (trees.ops, trees.const, fset.device_ops(),
                                                        x0s, ts, ys)]
    fn = lib.sr_adaptive_host
    fn.argtypes = [ctypes.c_int] + [ctypes.c_void_p] * 9 + [ctypes.c_int] * 9 + [ctypes.c_float] * 3
    status = fn(kind, *(a.ctypes.data for a in arrays), err.ctypes.data, alive.ctypes.data,
                steps.ctypes.data, p, d, n, b, ts.shape[0], fset.var_start, fset.has_unary,
                ca.METHODS[method], budget, rtol, atol, 0.9)
    assert status == 0
    return err / np.float32(ts.shape[0]), alive.astype(bool), steps


def same_bits(a, b):
    return bool(((a == b) | (np.isnan(a) & np.isnan(b))).all())


# kind: (the budget's kind, its steps). The sampled VdP population (N = 16) at budgets that
# bind, and at 1 and 2 steps per interval, where intervals close on their
# budget (the flat loop's order); N = 128 and 256 (chains of 255 / 127 / 63
# rows, the deepest stacks, then trees grown to depth 7), and d = 4 at N = 256
# (the shape whose block of decoded trees passes 48 KB of shared memory).
HOST_CASES = {
    "global": (ca.GLOBAL, 60), "interval": (ca.INTERVAL, 8),
    "interval1": (ca.INTERVAL, 1), "interval2": (ca.INTERVAL, 2),
    "global_n128": (ca.GLOBAL, 40), "interval_n128": (ca.INTERVAL, 8),
    "global_n256": (ca.GLOBAL, 40), "interval_n256": (ca.INTERVAL, 8),
    "global_d4_n256": (ca.GLOBAL, 40), "interval_d4_n256": (ca.INTERVAL, 8),
}


def host_case(kind, trig=False):
    """``(fset, x0s, ts, ys, trees)`` of a ``HOST_CASES`` kind: VdP data and
    a sampled population of 32 (N = 16); at N = 128 / 256, 6 candidates of
    2 trees x 2 VdP trajectories at T = 4 (``test_torch_kernels.fitness_case``);
    with ``d4``, 6 candidates of 4 trees x 2 trajectories of numpy data made
    from a seed (``test_torch_kernels.state4_case``). ``trig`` adds ``sin``
    and ``cos``."""
    if "_n" not in kind:
        ops = OPS + [("sin", jnp.sin, 1, 0.3), ("cos", jnp.cos, 1, 0.3)] if trig else OPS
        jf, data, jpop, tf, (x0s, ts, ys, _), trees = vdp_case(t_end=1.4, pop=32, ops=ops)
        return tf, x0s, ts, ys, trees
    n = int(kind[-3:])
    ops = ARITH + TRIG if trig else ARITH
    fset, trees, x0s, ts, ys = (fitness_case(pop=6, b=2, t_end=0.8, ops=ops, n=n, depth=7)
                                if "_d4_" not in kind else state4_case(n=n, ops=ops))
    return fset, x0s, ts, ys, trees


def host_matches_plain(lib, kind, method, monkeypatch, trig=False):
    """Kernel #5 or #4's host build against its plain version with the
    host's ``powf`` (and ``sinf``/``cosf``) and an IEEE square root
    (``patch_host_math``): every lane's error sum, alive and attempted steps
    bit for bit. Returns the host build's outputs and the case."""
    k, budget = HOST_CASES[kind]
    plain = ca.sr_fitness_adaptive_global_plain if k == ca.GLOBAL else ca.sr_fitness_adaptive_interval_plain
    tf, x0s, ts, ys, trees = case = host_case(kind, trig)
    h_mse, h_alive, h_steps = host_run(lib, k, trees, x0s, ts, ys, tf, budget, method)
    with monkeypatch.context() as m:
        patch_host_math(m)
        mse, alive, steps = plain(trees, x0s, ts, ys, tf, 1e-4, 1e-6, budget, method)
    np.testing.assert_array_equal(alive.numpy(), h_alive)
    np.testing.assert_array_equal(steps.numpy(), h_steps)
    assert same_bits(mse.numpy(), h_mse)
    return (h_mse, h_alive, h_steps), case, plain


@pytest.mark.parametrize("method", METHODS)
@pytest.mark.parametrize("kind", list(HOST_CASES))
def test_adaptive_host_build_matches_plain(adaptive_host, monkeypatch, kind, method):
    (h_mse, h_alive, h_steps), (tf, x0s, ts, ys, trees), plain = host_matches_plain(
        adaptive_host, kind, method, monkeypatch)
    budget = HOST_CASES[kind][1]
    if "_n" in kind:  # trees of more than 32 rows, every lane stepping
        assert int((trees.ops != 0).sum(-1).max()) > 32 and h_steps.min() > 0
        return
    if budget == 1:  # one step never reaches a save point: every lane dies in its first interval
        assert not h_alive.any() and (h_steps == 1).all()
        return
    assert h_alive.any() and (~h_alive).any() and (h_steps >= budget).any()
    if kind not in ("global", "interval"):
        return
    # with PyTorch's own CPU pow
    mse, alive, steps = plain(trees, x0s, ts, ys, tf, 1e-4, 1e-6, budget, method)
    a = alive.numpy()
    assert (a == h_alive).mean() >= 0.995
    both = a & h_alive
    assert rel(h_mse[both], mse.numpy()[both]).max() <= 1e-3


@pytest.mark.parametrize("kind", ["global", "interval", "interval1", "interval2", "global_n256",
                                  "interval_n256"])
def test_adaptive_host_build_trig_matches_plain(adaptive_host, monkeypatch, kind):
    """Kernels #5 and #4 with ``sin``/``cos`` rows (dopri5): every output bit
    for bit, with the host's ``powf``, ``sinf``, ``cosf`` and an IEEE square
    root in the plain version."""
    (h_mse, h_alive, h_steps), (tf, _, _, _, trees), _ = host_matches_plain(
        adaptive_host, kind, "dopri5", monkeypatch, trig=True)
    unary = (trees.ops == tf.string_to_op["sin"]) | (trees.ops == tf.string_to_op["cos"])
    assert bool(unary.any()) and (h_alive.any() or HOST_CASES[kind][1] == 1)


# ------------------------------------------ (c) global == per-interval plain

@pytest.mark.parametrize("method", METHODS)
def test_global_budget_equals_interval_when_not_binding(method):
    jf, data, jpop, tf, (x0s, ts, ys, _), trees = vdp_case(t_end=1.2, batch=2, pop=16, seed=5)
    per_interval = 32  # no sound lane exhausts it
    t_steps = ts.shape[0]
    mse_i, alive_i, steps_i = ca.sr_fitness_adaptive_interval_plain(
        trees, x0s, ts, ys, tf, 1e-3, 1e-5, per_interval, method)
    mse_g, alive_g, steps_g = ca.sr_fitness_adaptive_global_plain(
        trees, x0s, ts, ys, tf, 1e-3, 1e-5, per_interval * (t_steps - 1), method)
    assert torch.equal(alive_g, alive_i) and alive_i.any()
    assert torch.equal(mse_g[alive_i], mse_i[alive_i])
    assert torch.equal(steps_g[alive_i], steps_i[alive_i])
    # a budget below the attainable minimum (5 intervals need >= 6 attempts)
    mse_t, alive_t, steps_t = ca.sr_fitness_adaptive_global_plain(
        trees, x0s, ts, ys, tf, 1e-3, 1e-5, 5, method)
    assert not bool(alive_t.any()) and int(steps_t.max()) <= 5
    assert bool(torch.isfinite(mse_t[alive_i]).all())


# ------------------------------------ (d) #5 against the JAX kernel, interpret

@pytest.mark.parametrize("budget", [5, 40])
def test_global_plain_matches_jax_interpret(budget):
    jf, data, jpop, tf, (x0s, ts, ys, _), trees = vdp_case(t_end=0.8, pop=6, nodes=8, seed=5)
    x0 = jnp.broadcast_to(data[0][None], (6, 4, 2))
    with pltpu.force_tpu_interpret_mode():
        jmse, jalive = jax_rollout.rollout_sr_fitness_adaptive_global_pallas(
            jpop, x0, data[1], data[2], jf, budget=budget, method="dopri5")
    mse, alive, _ = ca.sr_fitness_adaptive_global_plain(trees, x0s, ts, ys, tf, budget=budget)
    ja = np.asarray(jalive)
    np.testing.assert_array_equal(alive.numpy(), ja)
    assert rel(mse.numpy()[ja], np.asarray(jmse)[ja]).max() <= 1e-5


# ------------------------------------------------------- (e) the evaluator

@pytest.mark.parametrize("method", METHODS)
def test_evaluator_adaptive_matches_jax(method):
    jf, data, jpop, tf, tdata, tpop = vdp_case(t_end=1.4, pop=24)
    budget = 40 * (data[1].shape[0] - 1)  # binds for no sound lane
    jev = JaxSREvaluator(jf, method="adaptive", adaptive_method=method, adaptive_budget=budget,
                         interpreter="gather")
    ref = np.asarray(jax.jit(jev.evaluate_population)(jpop, data))
    ev = SREvaluator(tf, method="adaptive", adaptive_method=method, adaptive_budget=budget)
    got = ev.evaluate_population(tpop, tdata).numpy()
    assert got.shape == (24,) and np.isfinite(got).all() and ((got >= 0) & (got <= 1e5)).all()
    ok = (got < 1e5) & (ref < 1e5)
    assert ok.sum() >= 8
    np.testing.assert_allclose(got[ok], ref[ok], rtol=1e-4)


def test_evaluator_takes_global_budget_past_jax_vmem_gate(monkeypatch):
    """Recorded decision: the port's evaluator always runs the global budget,
    also on a grid where JAX's VMEM gate would send it to the per-interval
    kernel (T = 1,200 save points at d = 2, N = 32)."""
    jf = jax_function_set(OPS, [["x0", "x1"]], [2])
    jpop = jax_sampler(jf, 3, 32)(jr.PRNGKey(1), 2)
    ts = jnp.arange(1200, dtype=jnp.float32) * 0.01
    assert not jax_rollout.adaptive_global_available(jf, jpop, 2, 1200)
    calls = []
    for name in ("sr_fitness_adaptive_global_plain", "sr_fitness_adaptive_interval_plain"):
        fn = getattr(ca, name)
        monkeypatch.setattr(ca, name, lambda *a, _n=name, _f=fn, **k: calls.append(_n) or _f(*a, **k))
    tdata = (torch.zeros((1, 2)) + 0.5, torch.from_numpy(np.array(ts)), torch.zeros((1, 1200, 2)), None)
    ev = SREvaluator(function_set_from_jax(jf), method="adaptive", adaptive_budget=3)
    fit = ev.evaluate_population(trees_from_numpy(*[np.asarray(a) for a in jpop]), tdata)
    assert calls == ["sr_fitness_adaptive_global_plain"]
    assert torch.equal(fit, torch.full((2,), 1e5))  # 3 steps cannot reach 1,199 saves


def test_adaptive_evaluator_rollout_and_call():
    """``_rollout`` / ``evaluate_candidate`` / ``__call__`` with
    ``method="adaptive"`` follow JAX's ``integrate_adaptive`` with its
    per-interval budget: ``adaptive_step_budget(substeps)``, or
    ``adaptive_budget // (T-1)`` when a budget is set."""
    jf, data, jpop, tf, tdata, tpop = vdp_case(t_end=1.0, pop=3)
    for i, kwargs in enumerate(({"substeps": 8}, {"adaptive_budget": 40})):
        jev = JaxSREvaluator(jf, method="adaptive", interpreter="gather", **kwargs)
        ev = SREvaluator(tf, method="adaptive", **kwargs)
        jfit, jpred = jax.jit(jev.evaluate_candidate)(jpop[i], data)
        fit, pred = ev.evaluate_candidate(tpop[i], tdata)
        np.testing.assert_allclose(fit.numpy(), np.asarray(jfit), rtol=1e-4)
        np.testing.assert_allclose(pred.numpy(), np.asarray(jpred), rtol=1e-4, atol=1e-5)
        np.testing.assert_allclose(float(ev(tpop[2], tdata)), float(jax.jit(jev)(jpop[2], data)),
                                   rtol=1e-4)


# ------------------------------------------------------ (f) the gradient

def test_adaptive_gradient_matches_jax():
    """d sum(fitness) / d const through ``SRFitnessAdaptive`` against
    ``jax.grad`` of the JAX evaluator: the same entries are non-finite, and
    the finite ones agree at rtol 1e-3.

    Both packages give NaN on every constant that reaches the rollout: a lane
    that has reached its save point still runs the rest of the interval's
    iterations with ``dt_c = t1 - t = 0``, so ``err = 0``, and the unselected
    ``pow(err, e)`` of the step controller has the cotangent ``0 * inf``. The
    optimiser zeroes non-finite gradients, so constant optimisation with the
    adaptive evaluator leaves the constants where they are, in both."""
    jf, data, jpop, tf, tdata, tpop = vdp_case(t_end=0.8, pop=8, seed=3)
    budget = 40 * (data[1].shape[0] - 1)
    jev = JaxSREvaluator(jf, method="adaptive", adaptive_method="dopri5", adaptive_budget=budget,
                         interpreter="gather")
    jgrad = jax.jit(jax.grad(lambda c: jev.evaluate_population(jpop._replace(const=c), data).sum()))
    want = np.asarray(jgrad(jpop.const))
    ev = SREvaluator(tf, method="adaptive", adaptive_method="dopri5", adaptive_budget=budget)
    const = tpop.const.clone().requires_grad_(True)
    fit = ev.evaluate_population(tpop._replace(const=const), tdata)
    (got,) = torch.autograd.grad(fit.sum(), (const,))
    got = got.numpy()
    np.testing.assert_array_equal(np.isfinite(got), np.isfinite(want))
    used = tpop.ops.numpy() == 1  # CONST rows
    assert not np.isfinite(want[used]).any()
    fin = np.isfinite(want)
    np.testing.assert_allclose(got[fin], want[fin], rtol=1e-3, atol=0)


@pytest.mark.parametrize("global_budget", [True, False])
def test_sr_fitness_adaptive_function(global_budget):
    """``SRFitnessAdaptive`` on either budget: its forward is the dispatcher
    (the plain version on CPU tensors) and its backward the gradient of the
    unfused recompute at ``recompute_steps`` per interval."""
    jf, data, jpop, tf, (x0s, ts, ys, _), tpop = vdp_case(t_end=0.8, pop=6, seed=4)
    config = ca.AdaptiveConfig(global_budget, 30 if global_budget else 10, "bosh3")  # T = 4
    assert config.recompute_steps(ts.shape[0]) == 10
    const = tpop.const.clone().requires_grad_(True)
    mse, alive = ca.SRFitnessAdaptive.apply(tpop.ops, tpop.c1, tpop.c2, const, x0s, ts, ys, tf, config)
    ref = config.forward(tpop, x0s, ts, ys, tf)
    assert torch.equal(mse, ref[0]) and torch.equal(alive, ref[1])
    g = torch.from_numpy(np.random.default_rng(0).normal(size=mse.shape).astype(np.float32))
    (got,) = torch.autograd.grad(mse, (const,), g)
    const2 = tpop.const.clone().requires_grad_(True)
    rec = ca.adaptive_mse_unfused(tpop._replace(const=const2), x0s, ts, ys, tf, config)
    (want,) = torch.autograd.grad(rec, (const2,), g)
    assert torch.equal(torch.isnan(got), torch.isnan(want))
    assert torch.equal(got[~torch.isnan(got)], want[~torch.isnan(want)])


def test_optimise_with_adaptive_evaluator_never_worse():
    jf, data, jpop, tf, tdata, tpop = vdp_case(t_end=1.0, pop=8, seed=2)
    gp = GeneticProgramming(
        num_generations=1, population_size=8, operator_list=[(n, 2, 0.25) for n in "+-*/"],
        fitness_function=SREvaluator(method="adaptive", adaptive_method="dopri5",
                                     adaptive_budget=40),
        variable_list=[["x0", "x1"]], layer_sizes=[2], max_nodes=16, gradient_steps=2,
        device="cpu")
    before = gp.evaluator.evaluate_population(tpop, tdata)
    after, refined = gp.optimise(tpop, tdata)
    assert bool((after <= before).all()) and bool(torch.isfinite(after).all())
    torch.testing.assert_close(gp.evaluator.evaluate_population(refined, tdata), after, rtol=0, atol=0)
