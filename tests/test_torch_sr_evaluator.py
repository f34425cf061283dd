"""PyTorch port: SR evaluation against the JAX ``SREvaluator`` (CPU).

Follows ``tests/test_rollout_interpret.py``: the same JAX-sampled population
and the same JAX-generated data go through JAX's general path
(``interpreter="ladder"``) and through the port's ``evaluate_population``,
which on CPU tensors runs the fitness kernel's plain version.

Tolerances: lanes clamped to ``max_fitness`` must agree exactly; elsewhere
the median relative fitness error must stay <= 1e-6 and the largest <= 1e-4.
Two rounding differences are expected: XLA:CPU contracts the RK updates into
fused multiply-adds (the port does not, to match its -fmad=false kernel), and
the port sums the squared error step by step as the kernel does where JAX
sums after the rollout. Over T = 10 they reach ~2e-5 relative on the few
chaotic candidates and stay ~1e-7 on the rest.
"""
import jax
import jax.numpy as jnp
import jax.random as jr
import numpy as np
import pytest
import torch

from multitreegp_tpu.core.registry import build_function_set as jax_function_set
from multitreegp_tpu.models.environments import (
    LorenzAttractor as JaxLorenz, LotkaVolterra as JaxLV, VanDerPolOscillator as JaxVdP,
)
from multitreegp_tpu.models.evaluators import SREvaluator as JaxSREvaluator
from multitreegp_tpu.models.evaluators import generate_sr_data as jax_generate
from multitreegp_tpu.ops.initialization import make_population_sampler as jax_sampler
from multitreegp_tpu_torch.convert import function_set_from_jax, sr_data_from_numpy, trees_from_numpy
from multitreegp_tpu_torch.core.cuda_rollout import sr_fitness, sr_fitness_plain
from multitreegp_tpu_torch.models.environments import LorenzAttractor, LotkaVolterra, VanDerPolOscillator
from multitreegp_tpu_torch.models.evaluators import SREvaluator, generate_sr_data, sr_trajectories

torch.set_num_threads(1)

OPS = [("+", jnp.add, 2, 0.5), ("-", jnp.subtract, 2, 0.1), ("*", jnp.multiply, 2, 0.5),
       ("/", jnp.divide, 2, 0.1)]


@pytest.fixture(scope="module")
def setup():
    jf = jax_function_set(OPS, [["x0", "x1"]], [2])
    env = JaxVdP(0.0, 0.0)
    ts = jnp.arange(0.0, 2.0, 0.2)  # T = 10
    data = jax_generate(env, jr.PRNGKey(0), ts, batch_size=4, substeps=8)
    pop = jax_sampler(jf, 3, 8)(jr.PRNGKey(1), 16)
    return jf, data, pop


@pytest.mark.parametrize("method,substeps", [("rk4", 1), ("rk4", 2), ("heun", 1), ("euler", 2)])
def test_evaluate_population_matches_jax(setup, method, substeps):
    jf, data, pop = setup
    ref = np.asarray(JaxSREvaluator(jf, method=method, substeps=substeps, interpreter="ladder")
                     .evaluate_population(pop, data))
    x0s, ts, ys, _ = data
    tdata = sr_data_from_numpy(x0s, ts, ys)
    ev = SREvaluator(function_set_from_jax(jf), method=method, substeps=substeps)
    got = ev.evaluate_population(trees_from_numpy(*[np.asarray(a) for a in pop]), tdata).numpy()
    assert got.shape == (16,) and np.isfinite(got).all()
    assert ((got >= 0) & (got <= 1e5)).all()
    clamped = ref == 1e5
    np.testing.assert_array_equal(got == 1e5, clamped)
    ok = ~clamped
    rel = np.abs(got[ok] - ref[ok]) / np.maximum(np.abs(ref[ok]), 1e-12)
    assert np.median(rel) <= 1e-6 and rel.max() <= 1e-4, rel


def test_fitness_plain_matches_rollout_and_dispatch(setup):
    """The fused plain version equals rollout + MSE from the trajectory, and
    the CPU dispatch of ``sr_fitness`` is the plain version."""
    jf, data, pop = setup
    tf = function_set_from_jax(jf)
    x0s, ts, ys, _ = sr_data_from_numpy(*data[:3])
    trees = trees_from_numpy(*[np.asarray(a) for a in pop])
    mse, alive = sr_fitness_plain(trees, x0s, ts, ys, tf, "rk4", 1)
    mse2, alive2 = sr_fitness(trees, x0s, ts, ys, tf, "rk4", 1)
    assert torch.equal(mse, mse2) and torch.equal(alive, alive2)
    xs, alive_t = SREvaluator(tf, substeps=1)._rollout(trees, x0s, ts)
    ref = ((xs - ys.transpose(0, 1)[:, None]) ** 2).sum(-1).mean(0)
    assert torch.equal(alive, alive_t[-1])
    np.testing.assert_allclose(mse[alive].numpy(), ref[alive].numpy(), rtol=1e-5)


def test_evaluate_candidate_and_unsupported(setup):
    jf, data, pop = setup
    tf = function_set_from_jax(jf)
    tdata = sr_data_from_numpy(*data[:3])
    cand = trees_from_numpy(*[np.asarray(a)[0] for a in pop])
    fit, pred = SREvaluator(tf, substeps=1).evaluate_candidate(cand, tdata)
    jfit, jpred = JaxSREvaluator(jf, substeps=1, interpreter="ladder").evaluate_candidate(pop[0], data)
    assert pred.shape == (4, 10, 2)
    np.testing.assert_allclose(fit.numpy(), np.asarray(jfit), rtol=1e-4)
    # adaptive SR is ported (tests/test_torch_adaptive.py), and SDE SR
    # (tests/test_torch_sde.py): with the data's keys, the JAX package's SDE
    fit = SREvaluator(tf, method="adaptive").evaluate_population(cand.map(lambda a: a[None]), tdata)
    assert fit.shape == (1,) and bool(torch.isfinite(fit).all())
    sde = SREvaluator(tf, process_noise=0.1).evaluate_population(
        cand.map(lambda a: a[None]), sr_data_from_numpy(*data))
    want = JaxSREvaluator(jf, process_noise=0.1, interpreter="gather").evaluate_population(
        jax.tree_util.tree_map(lambda a: a[:1], pop), data)
    np.testing.assert_allclose(sde.numpy(), np.asarray(want), rtol=1e-4)


@pytest.mark.parametrize(
    "jax_env,torch_env", [(JaxVdP, VanDerPolOscillator), (JaxLV, LotkaVolterra), (JaxLorenz, LorenzAttractor)]
)
def test_ground_truth_matches_jax(jax_env, torch_env):
    ts = jnp.arange(0.0, 1.0, 0.1)
    x0s, _, ys, _ = jax_generate(jax_env(0.0, 0.0), jr.PRNGKey(2), ts, batch_size=3, substeps=10)
    got = sr_trajectories(torch_env(), torch.from_numpy(np.array(x0s)), torch.from_numpy(np.array(ts)),
                          substeps=10)
    np.testing.assert_allclose(got.numpy(), np.asarray(ys), rtol=1e-5, atol=1e-6)
    g = torch.Generator().manual_seed(0)
    x0, ts_t, ys_t, keys = generate_sr_data(torch_env(), g, torch.from_numpy(np.asarray(ts)), batch_size=5)
    assert x0.shape == (5, torch_env().n_var) and ys_t.shape == (5, 10, torch_env().n_var)
    assert keys.shape == (5, 2) and keys.dtype == torch.int64 and torch.isfinite(ys_t).all()
