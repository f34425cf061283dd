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
  bound);
* the fixed-step SR evaluator also at N = 256 (the fused gate's edge,
  ``lanes_refusal``) and N = 257 (the general path), with the same bound;
* at N = 128, trees grown to depth 7 (a chain of 127 rows among them),
  against JAX's general path with ``interpreter="gather"``: the adaptive SR
  evaluator (the port's #5 plain version; rtol 1e-4 on candidates below
  ``max_fitness`` in both, ``test_torch_adaptive.py``'s bound, with a budget
  that binds for no sound lane); the SDE SR evaluator at 1, 2 and 4
  substeps (#1's plain version with kick rows; ``test_torch_sde.py``'s
  bound: the same candidates clamped, median rel 1e-6, max 1e-4, but for
  ill-conditioned lanes, below); the
  dynamic policy evaluator at ``state_size=2`` (#6's plain version; fitness
  rel 1e-4 below ``max_fitness``, and the general path's states within 1e-4
  of each lane's scale on 98% of lanes alive in both, ``test_torch_policy.py``'s
  bounds); ``SREvaluator.evaluate_candidate`` past ``ROLLOUT_MAX_NODES``
  (the integrator with the interpreter: fitness rtol 1e-4, predictions rtol
  1e-4 / atol 1e-5 on live trajectories, ``test_torch_sde.py``'s bound, but
  for ill-conditioned trajectories).

Ill-conditioned lanes (``ill_conditioned``): at depth a few SR lanes move by
more than a quarter of the tolerance when their initial states and
constants move by one float32 ulp, measured in float64 by a plain numpy
evaluator of JAX's gather semantics (``float64_sr``; a condition number
above ~210). Two float32 implementations (XLA contracts FMAs, the port does
not) part there by that much. Such lanes, at most a quarter, are held
within 4x their float64 envelope of JAX and of the float64 result, as JAX
is of the float64 result; on every other lane JAX is within the tolerance of
the float64 result.

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
from multitreegp_tpu.core.trees import OP_START
from multitreegp_tpu.core.trees import TreeTensors as JaxTrees
from multitreegp_tpu.core.trees import rebuild_pointers as jax_rebuild_pointers
from multitreegp_tpu.models import environments as jenvs
from multitreegp_tpu.models.environments import VanDerPolOscillator as JaxVdP
from multitreegp_tpu.models.evaluators import DynamicPolicyEvaluator as JaxDynamic
from multitreegp_tpu.models.evaluators import SREvaluator as JaxSREvaluator
from multitreegp_tpu.models.evaluators import StaticPolicyEvaluator as JaxStatic
from multitreegp_tpu.models.evaluators import generate_control_data as jax_generate_control
from multitreegp_tpu.models.evaluators import generate_sr_data as jax_generate_sr
from multitreegp_tpu.ops.initialization import make_population_sampler as jax_sampler
from multitreegp_tpu_torch import GeneticProgramming
from multitreegp_tpu_torch.convert import (
    control_data_from_numpy, function_set_from_jax, sr_data_from_numpy, trees_from_numpy,
)
from multitreegp_tpu_torch.core.interpreter import IMPLS, evaluate_trees
from multitreegp_tpu_torch.core.trees import CONST, validate_host
from multitreegp_tpu_torch.models import environments as tenvs
from multitreegp_tpu_torch.models.evaluators import (
    DynamicPolicyEvaluator, SREvaluator, StaticPolicyEvaluator,
)
from multitreegp_tpu_torch.models.evaluators.sr import ROLLOUT_MAX_NODES
from multitreegp_tpu_torch.models.evaluators import generate_sr_data
from multitreegp_tpu_torch.models.environments import VanDerPolOscillator
from test_torch_kernels import chain_rows
from test_torch_policy import assert_fitness_agree, assert_lanes_agree, to_numpy

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


@pytest.mark.parametrize("n,depth,fused", [(300, 7, False), (128, 7, True), (256, 7, True),
                                           (257, 7, False)])
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


def vdp_deep_case(n=128, depth=7, pop=12, b=4, t_end=1.0, process_noise=0.0):
    """JAX's VdP data (ground truth, keys) on ``arange(0, t_end, 0.2)`` and a
    population grown to ``depth`` with a chain of ``n - 1`` rows, as JAX and
    port objects."""
    jf = jax_function_set(OPS, [["x0", "x1"]], [2])
    data = jax_generate_sr(JaxVdP(process_noise, 0.0), jr.PRNGKey(0), jnp.arange(0.0, t_end, 0.2),
                           batch_size=b, substeps=8)
    pop = population(jf, n, depth, pop)
    return (jf, JaxTrees(*(jnp.asarray(a) for a in pop)), data, function_set_from_jax(jf),
            trees_from_numpy(*pop), sr_data_from_numpy(*data))


NP_OPS = {"+": np.add, "-": np.subtract, "*": np.multiply, "/": np.divide}


def float64_trees(jf, pop, x):
    """Root values ``(P, B, m)`` in float64 of the candidates ``pop`` (numpy
    ``ops, c1, c2, const``, each ``(P, m, N)``) at the states ``x (P, B, d)``,
    the rows read in order as JAX's gather interpreter reads them: an
    operator over its children's values, a constant or a variable. Plain
    numpy, shared with neither implementation under test."""
    ops, c1, c2, const = (a[:, None] for a in pop)  # (P, 1, m, N)
    shape = (x.shape[0], x.shape[1], ops.shape[2])
    names = {op: name for name, op in jf.string_to_op.items() if OP_START <= op < jf.var_start}
    leaves = np.broadcast_to(x[:, :, None, :], shape + x.shape[-1:])
    vals = np.zeros(shape + (ops.shape[-1],))
    for i in range(ops.shape[-1]):
        row = lambda a: np.broadcast_to(a[..., i], shape)
        op = row(ops)
        child = lambda c: np.take_along_axis(vals, np.maximum(row(c), 0)[..., None], -1)[..., 0]
        a, b = child(c1), child(c2)
        v = np.where(op == CONST, row(const), 0.0)
        for code, name in names.items():
            v = np.where(op == code, NP_OPS[name](a, b), v)
        var = np.clip(op - jf.var_start, 0, x.shape[-1] - 1)[..., None]
        vals[..., i] = np.where(op >= jf.var_start, np.take_along_axis(leaves, var, -1)[..., 0], v)
    return vals[..., -1]


def sde_kicks(process_noise, ts, keys, substeps, d):
    """``(T-1, substeps, B, d)`` float32 Euler-Maruyama kicks as JAX's
    ``integrate_sde`` draws them: ``process_noise * normal(fold_in(key,
    bitcast(tau)), (d,)) * sqrt(|dt|)`` at ``tau = t0 + i*dt`` rounded once
    (XLA contracts it into a fused multiply-add)."""
    ts = np.asarray(ts)
    dt = (ts[1:] - ts[:-1]) / np.float32(substeps)
    taus = (ts[:-1, None].astype(np.float64)
            + np.arange(substeps) * dt[:, None].astype(np.float64)).astype(np.float32)
    bits = jax.lax.bitcast_convert_type(jnp.asarray(taus), jnp.int32)
    draw = lambda bit: jax.vmap(lambda k: jr.normal(jr.fold_in(k, bit), (d,)))(jnp.asarray(keys))
    z = jax.vmap(jax.vmap(draw))(bits)  # (T-1, S, B, d)
    w = z * jnp.sqrt(jnp.abs(jnp.asarray(dt)))[:, None, None, None]
    return np.asarray(jnp.float32(process_noise) * w)


def float64_sr(jf, pop, data, substeps, method, kicks=None, max_fitness=1e5):
    """Per (candidate, trajectory) fitness ``(P, B)`` of ``pop`` on SR data
    ``(x0s, ts, ys, ...)`` in float64: the fixed-step integrator
    (``"euler"`` or ``"rk4"``, ``substeps`` a save interval, plus ``kicks``
    after each substep), a lane frozen once a state is not finite or passes
    1e8, the MSE over the save points, ``max_fitness`` where it diverged."""
    x0s, ts, ys = (np.asarray(a, np.float64) for a in data[:3])
    f = lambda x: float64_trees(jf, pop, x)
    x = np.broadcast_to(x0s, (pop[0].shape[0],) + x0s.shape)
    sound = lambda x: np.all(np.isfinite(x) & (np.abs(x) < 1e8), axis=-1)
    alive, xs = sound(x), [x]
    with np.errstate(all="ignore"):
        for t in range(ts.shape[0] - 1):
            dt = (ts[t + 1] - ts[t]) / substeps
            for s in range(substeps):
                if method == "euler":
                    new = x + dt * f(x)
                else:
                    k1 = f(x)
                    k2 = f(x + 0.5 * dt * k1)
                    k3 = f(x + 0.5 * dt * k2)
                    k4 = f(x + dt * k3)
                    new = x + dt / 6 * (k1 + 2 * k2 + 2 * k3 + k4)
                if kicks is not None:
                    new = new + kicks[t, s]
                alive = alive & sound(new)
                x = np.where(alive[..., None], new, x)
            xs.append(x)
        mse = np.mean(np.sum(np.square(np.stack(xs) - ys.transpose(1, 0, 2)[:, None]), -1), 0)
    return np.where(alive & np.isfinite(mse), mse, max_fitness)


def float64_fitness(*args, max_fitness=1e5, **kw):
    """``float64_sr`` averaged over the trajectories and clamped, as the
    evaluators' ``evaluate_population``."""
    return np.clip(float64_sr(*args, max_fitness=max_fitness, **kw).mean(-1), 0.0, max_fitness)


def rel_err(a, b):
    return np.abs(a - b) / np.maximum(np.abs(b), 1e-12)


def float64_envelope(fn, pop, x0s, draws=4):
    """``(fn(pop, x0s), envelope)``: the float64 result and, per output, the
    largest relative change when the constants and the initial states each
    move by one float32 ulp in a random direction. A one-ulp move is at most
    2**-23 relative, so the envelope times 2**23 bounds the lane's condition
    number from below."""
    base = fn(pop, x0s)
    env = np.zeros_like(base)
    rng = np.random.default_rng(7)
    nudge = lambda a: np.nextafter(
        a, np.where(rng.random(a.shape) < 0.5, -np.inf, np.inf).astype(np.float32))
    for _ in range(draws):
        env = np.maximum(env, rel_err(fn(list(pop[:3]) + [nudge(pop[3])], nudge(x0s)), base))
    return base, env


def ill_conditioned(got, ref, truth, env, max_rel=1e-4):
    """The lanes exempt from ``max_rel``: those whose float64 envelope
    passes ``max_rel / 4`` (a condition number above ~210), at most a quarter
    of them. There the port (``got``) is held within 4x the envelope of
    JAX (``ref``) and of the float64 result (``truth``), as JAX is of the
    float64 result; on every other lane JAX is within ``max_rel`` of the
    float64 result. Returns the exempt lanes."""
    loose = env > max_rel / 4
    assert loose.sum() <= got.size // 4, env
    assert (rel_err(ref, truth)[~loose] <= max_rel).all(), (ref, truth)
    for r in (rel_err(got, ref), rel_err(got, truth), rel_err(ref, truth)):
        assert (r[loose] <= 4 * env[loose]).all(), (r[loose], env[loose] * 2.0**23)
    return loose


def assert_close_within_envelope(got, ref, truth, env, max_rel=1e-4):
    """``assert_fitness_close``'s bounds on all but the ill-conditioned
    lanes (``ill_conditioned``)."""
    loose = ill_conditioned(got, ref, truth, env, max_rel)
    assert_fitness_close(np.where(loose, ref, got), ref, max_rel)


def test_adaptive_sr_evaluator_matches_jax_deep():
    jf, jpop, data, tf, trees, tdata = vdp_deep_case(t_end=1.2)
    budget = 20 * (data[1].shape[0] - 1)  # sound lanes take <= 21 steps; JAX: 20 an interval
    kw = dict(method="adaptive", adaptive_method="dopri5", adaptive_budget=budget)
    ref = np.asarray(jax.jit(JaxSREvaluator(jf, interpreter="gather", **kw).evaluate_population)(
        jpop, data))
    ev = SREvaluator(tf, **kw)
    assert ev._fused(trees, tdata[0])  # #5's plain version on the CPU
    got = ev.evaluate_population(trees, tdata).numpy()
    assert np.isfinite(got).all() and ((got >= 0) & (got <= 1e5)).all()
    ok = (got < 1e5) & (ref < 1e5)
    assert ok.sum() >= 4, (got, ref)
    np.testing.assert_allclose(got[ok], ref[ok], rtol=1e-4)


@pytest.mark.parametrize("substeps", [1, 2, 4])
def test_sde_sr_evaluator_matches_jax_deep(substeps):
    jf, jpop, data, tf, trees, tdata = vdp_deep_case(process_noise=0.15)
    jev = JaxSREvaluator(jf, substeps=substeps, process_noise=0.15, interpreter="gather")
    ref = np.asarray(jax.jit(jev.evaluate_population)(jpop, data))
    ev = SREvaluator(tf, substeps=substeps, process_noise=0.15)
    assert ev._fused(trees, tdata[0])  # #1's plain version with kick rows
    kicks = sde_kicks(0.15, data[1], data[3], substeps, 2)
    truth, env = float64_envelope(
        lambda pop, x0s: float64_fitness(jf, pop, (x0s,) + data[1:], substeps, "euler", kicks),
        [np.asarray(a) for a in jpop], np.asarray(data[0]))
    assert_close_within_envelope(ev.evaluate_population(trees, tdata).numpy(), ref, truth, env)


def test_dynamic_policy_evaluator_matches_jax_deep():
    jenv, tenv = jenvs.Acrobot(), tenvs.Acrobot()
    ys = [f"y{i}" for i in range(jenv.n_obs)]
    acts, us = ["a0", "a1"], [f"u{i}" for i in range(jenv.n_control)]
    jops = [("+", jnp.add, 2), ("-", jnp.subtract, 2), ("*", jnp.multiply, 2), ("sin", jnp.sin, 1),
            ("cos", jnp.cos, 1)]
    jf = jax_function_set(jops, [ys + acts + us, acts], [2, jenv.n_control])
    tf = function_set_from_jax(jf)
    jdata = jax_generate_control(jenv, jr.PRNGKey(0), jnp.arange(0.0, 1.2, 0.2), batch_size=4)
    pop = population(jf, 128, 7, 12)
    jpop = JaxTrees(*(jnp.asarray(a) for a in pop))
    jev = JaxDynamic(jenv, jf, state_size=2, substeps=2, interpreter="gather")
    (jxs, jal), want = jax.jit(lambda p, d: (jev._rollout_general(p, d),
                                             jev.evaluate_population(p, d)))(jpop, jdata)
    ev = DynamicPolicyEvaluator(tenv, tf, state_size=2, substeps=2)
    tdata, tpop = control_data_from_numpy(*to_numpy(jdata)), trees_from_numpy(*pop)
    assert ev._fused_kind(tpop, tdata) == "fixed"  # #6's plain version
    assert_lanes_agree(*ev._rollout_general(tpop, tdata), jxs, jal)
    assert_fitness_agree(ev.evaluate_population(tpop, tdata), want)


def test_evaluate_candidate_general_path_matches_jax_deep():
    jf, jpop, data, tf, trees, tdata = vdp_deep_case()
    assert trees.max_nodes > ROLLOUT_MAX_NODES  # past the trajectory kernel's gate
    jev = JaxSREvaluator(jf, substeps=1, interpreter="gather")
    ev = SREvaluator(tf, substeps=1)
    run = jax.jit(jev.evaluate_candidate)
    truth, env = float64_envelope(lambda pop, x0s: float64_sr(jf, pop, (x0s,) + data[1:], 1, "rk4"),
                                  [np.asarray(a)[:4] for a in jpop], np.asarray(data[0]))
    fits, jfits, live_total = [], [], 0
    for i in range(4):
        jfit, jpred = (np.asarray(a) for a in run(jax.tree_util.tree_map(lambda a: a[i], jpop), data))
        fit, pred = ev.evaluate_candidate(trees.map(lambda a: a[i]), tdata)
        fits.append(fit.numpy())
        jfits.append(jfit)
        live = np.isfinite(jpred).all(axis=(1, 2)) & (jfit < 1e5) & (env[i] <= 1e-4 / 4)
        live_total += int(live.sum())
        np.testing.assert_allclose(pred.numpy()[live], jpred[live], rtol=1e-4, atol=1e-5)
    got, ref = np.stack(fits), np.stack(jfits)
    loose = ill_conditioned(got, ref, truth, env)  # of 16 trajectories
    assert (rel_err(got, ref)[~loose] <= 1e-4).all()
    assert live_total >= 8


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
