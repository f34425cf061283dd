"""PyTorch port: SDE symbolic regression end to end, against the JAX package
on the same numpy keys, states and candidates.

* Kernel #1's Euler-Maruyama leg: the host build of ``csrc/sr_fitness.cu``
  with kick rows equals the plain version bit for bit; the plain version
  with the JAX-built rows matches the TPU kernel run in interpret mode
  (rel 1e-5 on lanes alive in both: the TPU kernel steps by one ``dt`` for
  the grid, the port per interval in float32).
* ``SREvaluator(process_noise=...)``: fitness as ``test_torch_sr_evaluator``
  (the same candidates clamped, median rel 1e-6 and max 1e-4 elsewhere), its
  gradient rtol 1e-4 on candidates below 1e3 in both, ``evaluate_candidate``
  rtol 1e-4; ``generate_sr_data``'s SDE ground truth given JAX's keys rtol
  1e-5.

The noisy and stochastic policies are in ``test_torch_sde_policy.py``.
"""
import jax
import jax.numpy as jnp
import jax.random as jr
import numpy as np
import pytest
import torch

from multitreegp_tpu.core.registry import build_function_set as jax_function_set
from multitreegp_tpu.models.environments import VanDerPolOscillator as JaxVdP
from multitreegp_tpu.models.evaluators import SREvaluator as JaxSREvaluator
from multitreegp_tpu.models.evaluators import generate_sr_data as jax_generate_sr
from multitreegp_tpu.models.evaluators.noise import make_sr_kick_rows as jax_kick_rows
from multitreegp_tpu.ops.initialization import make_population_sampler as jax_sampler
from multitreegp_tpu_torch import _build
from multitreegp_tpu_torch.convert import function_set_from_jax, sr_data_from_numpy, trees_from_numpy
from multitreegp_tpu_torch.core import cuda_rollout as cro
from multitreegp_tpu_torch.models.environments import VanDerPolOscillator
from multitreegp_tpu_torch.models.evaluators import SREvaluator, generate_sr_data, sr_trajectories
from multitreegp_tpu_torch.models.evaluators.noise import make_sr_kick_rows
from test_torch_kernels import fitness_case, fitness_host

torch.set_num_threads(1)

OPS = [("+", jnp.add, 2, 0.5), ("-", jnp.subtract, 2, 0.1), ("*", jnp.multiply, 2, 0.5),
       ("/", jnp.divide, 2, 0.1)]
PN = 0.15


@pytest.fixture(scope="module")
def host_fitness(tmp_path_factory):
    return _build.build_host("sr_fitness", tmp_path_factory.mktemp("host_sde"))


@pytest.mark.parametrize("method,substeps", [("euler", 2), ("euler", 4), ("rk4", 1)])
def test_fitness_host_build_with_kicks_bit_exact(host_fitness, method, substeps):
    fset, trees, x0s, ts, ys = fitness_case()
    keys = generate_sr_data(VanDerPolOscillator(), torch.Generator().manual_seed(4), ts,
                            batch_size=x0s.shape[0])[3]
    kicks = make_sr_kick_rows(0.3, ts, keys, substeps, 2)
    mse, alive = cro.sr_fitness_plain(trees, x0s, ts, ys, fset, method, substeps, kicks)
    err, alive_h = fitness_host(host_fitness, trees, x0s, ts, ys, fset, method, substeps, kicks)
    np.testing.assert_array_equal(alive_h, alive.numpy())
    np.testing.assert_array_equal(err, mse.numpy())
    assert (~alive.numpy()).any() and alive.numpy().any()
    # the kicks move the rollout; without them it is the ODE's
    ode, _ = cro.sr_fitness_plain(trees, x0s, ts, ys, fset, method, substeps)
    assert not torch.equal(torch.where(alive, mse, 0.0), torch.where(alive, ode, 0.0))
    with pytest.raises(ValueError, match="kick rows"):
        cro.sr_fitness(trees, x0s, ts, ys, fset, method, substeps + 1, kicks)


@pytest.fixture(scope="module")
def sde_setup():
    jf = jax_function_set(OPS, [["x0", "x1"]], [2])
    ts = jnp.arange(0.0, 2.0, 0.2)  # T = 10
    data = jax_generate_sr(JaxVdP(PN, 0.0), jr.PRNGKey(0), ts, batch_size=4, substeps=8)
    pop = jax_sampler(jf, 3, 8)(jr.PRNGKey(1), 16)
    return jf, data, pop, sr_data_from_numpy(*data), trees_from_numpy(*[np.asarray(a) for a in pop])


def test_plain_kick_leg_matches_tpu_kernel_interpret(sde_setup):
    from jax.experimental.pallas import tpu as pltpu

    from multitreegp_tpu.core.pallas_rollout import rollout_sr_fitness_pallas

    jf, data, pop, tdata, trees = sde_setup
    x0s, ts, ys, keys = data
    ts, ys = ts[:5], ys[:, :5]  # T = 5
    kicks = jax_kick_rows(PN, ts, keys, 2, 2)
    with pltpu.force_tpu_interpret_mode():
        want, want_alive = rollout_sr_fitness_pallas(
            pop, jnp.broadcast_to(x0s[None], (16, 4, 2)), ts, ys, jf, substeps=2, method="euler",
            process_noise_rows=kicks)
    got, alive = cro.sr_fitness_plain(trees, tdata[0], tdata[1][:5], tdata[2][:, :5],
                                      function_set_from_jax(jf), "euler", 2,
                                      torch.from_numpy(np.array(kicks)))
    np.testing.assert_array_equal(alive.numpy(), np.asarray(want_alive))
    both = alive.numpy()
    assert both.any()
    rel = np.abs(got.numpy()[both] - np.asarray(want)[both]) / (np.abs(np.asarray(want)[both]) + 1e-9)
    assert rel.max() < 1e-5, rel.max()


def test_sde_evaluate_population_matches_jax(sde_setup):
    jf, data, pop, tdata, trees = sde_setup
    jev = JaxSREvaluator(jf, substeps=2, process_noise=PN, interpreter="gather")
    ref = np.asarray(jax.jit(jev.evaluate_population)(pop, data))
    ev = SREvaluator(function_set_from_jax(jf), substeps=2, process_noise=PN)
    got = ev.evaluate_population(trees, tdata).numpy()
    clamped = ref == 1e5
    np.testing.assert_array_equal(got == 1e5, clamped)
    ok = ~clamped
    assert ok.sum() >= 8
    rel = np.abs(got[ok] - ref[ok]) / np.maximum(np.abs(ref[ok]), 1e-12)
    assert np.median(rel) <= 1e-6 and rel.max() <= 1e-4, rel
    # the noise matters, and without keys the evaluator integrates the ODE
    # by its own method
    euler = SREvaluator(function_set_from_jax(jf), substeps=2, method="euler")
    assert not np.array_equal(euler.evaluate_population(trees, tdata).numpy()[ok], got[ok])
    ode = SREvaluator(function_set_from_jax(jf), substeps=2)
    no_keys = tdata[:3] + (None,)
    assert torch.equal(ev.evaluate_population(trees, no_keys), ode.evaluate_population(trees, tdata))


def test_sde_gradient_matches_jax(sde_setup):
    """The gradient of the summed SDE fitness: kernel #1 forward with kicks,
    the recompute through ``integrate_sde`` backward (JAX's ``unfused_mse``)."""
    jf, data, pop, tdata, trees = sde_setup
    jev = JaxSREvaluator(jf, substeps=2, process_noise=PN, interpreter="gather")
    want_fit = np.asarray(jax.jit(jev.evaluate_population)(pop, data))
    loss = lambda c: jnp.sum(jev.evaluate_population(pop._replace(const=c), data))
    want = np.asarray(jax.jit(jax.grad(loss))(pop.const))
    const = trees.const.clone().requires_grad_(True)
    ev = SREvaluator(function_set_from_jax(jf), substeps=2, process_noise=PN)
    fit = ev.evaluate_population(trees._replace(const=const), tdata)
    (got,) = torch.autograd.grad(fit.sum(), (const,))
    alive = (want_fit < 1e3) & (fit.detach().numpy() < 1e3)
    assert alive.sum() >= 6, want_fit
    assert np.abs(want[alive]).max() > 1e-3
    np.testing.assert_allclose(got.numpy()[alive], want[alive], rtol=1e-4,
                               atol=1e-6 * np.abs(want[alive]).max())


def test_sde_evaluate_candidate_matches_jax(sde_setup):
    jf, data, pop, tdata, trees = sde_setup
    jev = JaxSREvaluator(jf, substeps=2, process_noise=PN, interpreter="gather")
    ev = SREvaluator(function_set_from_jax(jf), substeps=2, process_noise=PN)
    for i in range(3):
        cand = jax.tree_util.tree_map(lambda a: a[i], pop)
        jfit, jpred = jax.jit(jev.evaluate_candidate)(cand, data)
        fit, pred = ev.evaluate_candidate(trees.map(lambda a: a[i]), tdata)
        np.testing.assert_allclose(fit.numpy(), np.asarray(jfit), rtol=1e-4)
        live = np.isfinite(np.asarray(jpred)).all(axis=(1, 2)) & (np.asarray(jfit) < 1e5)
        np.testing.assert_allclose(pred.numpy()[live], np.asarray(jpred)[live], rtol=1e-4, atol=1e-5)
        assert float(ev(trees.map(lambda a: a[i]), tdata)) == pytest.approx(
            float(np.clip(np.mean(np.asarray(jfit)), 0, 1e5)), rel=1e-4)


def test_sde_ground_truth_matches_jax(sde_setup):
    _, data, _, tdata, _ = sde_setup
    x0s, ts, ys, keys = tdata
    got = sr_trajectories(VanDerPolOscillator(PN), x0s, ts, substeps=8, keys=keys)
    np.testing.assert_allclose(got.numpy(), np.asarray(data[2]), rtol=1e-5, atol=1e-5)
    # generate_sr_data draws its keys and rolls the SDE out with them
    g = torch.Generator().manual_seed(0)
    x0, ts_t, ys_t, keys_t = generate_sr_data(VanDerPolOscillator(PN), g, ts, batch_size=5, substeps=4)
    assert keys_t.shape == (5, 2) and keys_t.dtype == torch.int64
    assert bool((keys_t >= 0).all()) and bool((keys_t < 2**32).all())
    assert torch.equal(ys_t, sr_trajectories(VanDerPolOscillator(PN), x0, ts, substeps=4, keys=keys_t))
    ode = sr_trajectories(VanDerPolOscillator(), x0, ts, method="euler", substeps=4)
    assert not torch.equal(ys_t, ode)
