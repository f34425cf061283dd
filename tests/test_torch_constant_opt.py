"""PyTorch port: constant optimisation against the JAX package (CPU).

* ``optim.adam`` against ``optax.adam`` on the same gradients for 10 steps:
  rtol 1e-6 (same float32 expressions; XLA may fuse a moment update into an
  FMA).
* ``d sum(fitness) / d const`` through ``SRFitness`` (the plain fitness
  forward, the unfused recompute backward) against ``jax.grad`` of the JAX
  evaluator on the same candidates, T = 10: rtol 1e-4 on candidates whose
  trajectories all stay alive in both (fitness below 1e3; a dead trajectory
  alone adds 1e5 / B). XLA:CPU contracts the RK updates into FMAs, so
  gradients through a rollout agree to a tolerance, not bit for bit.
* the port of ``tests/test_constant_opt.py``: refinement never hurts, helps
  candidate 0 by at least 30%, leaves the opcodes alone and moves the
  constant toward its true value 1.0.
* ``GeneticProgramming.optimise`` against the JAX package's on the same
  K = 4 candidates: the same best epoch per candidate, fitness rtol 1e-4.
"""
import jax
import jax.numpy as jnp
import jax.random as jr
import numpy as np
import optax
import pytest
import torch

from multitreegp_tpu import GeneticProgramming as JaxGP
from multitreegp_tpu.core.registry import build_function_set as jax_function_set
from multitreegp_tpu.core.registry import default_sr_operators
from multitreegp_tpu.core.trees import TreeTensors as JaxTrees
from multitreegp_tpu.models.environments import VanDerPolOscillator as JaxVdP
from multitreegp_tpu.models.evaluators import SREvaluator as JaxSREvaluator
from multitreegp_tpu.models.evaluators import generate_sr_data as jax_generate
from multitreegp_tpu.ops.initialization import make_population_sampler as jax_sampler
from multitreegp_tpu_torch import GeneticProgramming
from multitreegp_tpu_torch.convert import function_set_from_jax, sr_data_from_numpy, trees_from_numpy
from multitreegp_tpu_torch.models.evaluators import SREvaluator
from multitreegp_tpu_torch.ops.constant_opt import make_constant_optimiser
from multitreegp_tpu_torch.ops.optim import adam, apply_updates

torch.set_num_threads(1)

JAX_OPS = [("+", jnp.add, 2, 0.5), ("-", jnp.subtract, 2, 0.1), ("*", jnp.multiply, 2, 0.5),
           ("/", jnp.divide, 2, 0.1)]
N = 32


def test_adam_matches_optax():
    rng = np.random.default_rng(0)
    params = rng.normal(size=(5, 2, 8)).astype(np.float32)
    grads = [(rng.normal(size=params.shape) * 10.0 ** rng.integers(-3, 3)).astype(np.float32)
             for _ in range(10)]
    ref = optax.adam(learning_rate=1e-3, b1=0.9, b2=0.999, eps=1e-8)
    opt = adam(learning_rate=1e-3, b1=0.9, b2=0.999, eps=1e-8)
    jp, js = jnp.asarray(params), ref.init(jnp.asarray(params))
    tp = torch.from_numpy(params)
    ts = opt.init(tp)
    for g in grads:
        ju, js = ref.update(jnp.asarray(g), js, jp)
        jp = optax.apply_updates(jp, ju)
        tu, ts = opt.update(torch.from_numpy(g), ts, tp)
        tp = apply_updates(tp, tu)
        np.testing.assert_allclose(tu.numpy(), np.asarray(ju), rtol=1e-6, atol=0)
        np.testing.assert_allclose(tp.numpy(), np.asarray(jp), rtol=1e-6, atol=0)
    assert ts.count == int(js[0].count) == 10
    np.testing.assert_allclose(ts.nu.numpy(), np.asarray(js[0].nu), rtol=1e-6, atol=0)


def sr_case(t_end=2.0, batch=4, substeps=1):
    """JAX VdP data and the same data as torch tensors."""
    ts = jnp.arange(0.0, t_end, 0.2)
    data = jax_generate(JaxVdP(0.0, 0.0), jr.PRNGKey(0), ts, batch_size=batch, substeps=8)
    return data, sr_data_from_numpy(*data[:3])


def test_fitness_gradient_matches_jax():
    jf = jax_function_set(JAX_OPS, [["x0", "x1"]], [2])
    pop = jax_sampler(jf, 3, 16)(jr.PRNGKey(2), 16)
    jdata, tdata = sr_case()  # T = 10
    jev = JaxSREvaluator(jf, substeps=1, interpreter="gather")
    loss = lambda c: jnp.sum(jev.evaluate_population(pop._replace(const=c), jdata))
    want_fit = np.asarray(jax.jit(jev.evaluate_population)(pop, jdata))
    want = np.asarray(jax.jit(jax.grad(loss))(pop.const))

    trees = trees_from_numpy(*[np.asarray(a) for a in pop])
    const = trees.const.clone().requires_grad_(True)
    fit = SREvaluator(function_set_from_jax(jf), substeps=1).evaluate_population(
        trees._replace(const=const), tdata)
    (got,) = torch.autograd.grad(fit.sum(), (const,))

    alive = (want_fit < 1e3) & (fit.detach().numpy() < 1e3)
    assert alive.sum() >= 8, want_fit
    np.testing.assert_allclose(fit.detach().numpy()[alive], want_fit[alive], rtol=1e-5)
    assert np.abs(want[alive]).max() > 1e-3
    np.testing.assert_allclose(got.numpy()[alive], want[alive], rtol=1e-4,
                               atol=1e-6 * np.abs(want[alive]).max())


def _tree(rows, n=N):
    pad = n - len(rows)
    return (
        [0] * pad + [r[0] for r in rows],
        [-1] * pad + [r[1] + pad if r[1] >= 0 else -1 for r in rows],
        [-1] * pad + [r[2] + pad if r[2] >= 0 else -1 for r in rows],
        [0.0] * pad + [r[3] for r in rows],
    )


def vdp_candidates(coefs):
    """K candidates ``dx0 = c * x1`` (truth: c = 1) with the true ``dx1``
    (opcodes of ``default_sr_operators`` + x0, x1), as numpy field arrays."""
    t1 = _tree([(6, -1, -1, 0.0), (6, -1, -1, 0.0), (6, -1, -1, 0.0), (4, 2, 1, 0.0),
                (1, -1, -1, 1.0), (3, 4, 3, 0.0), (7, -1, -1, 0.0), (4, 6, 5, 0.0), (3, 7, 0, 0.0)])
    fields = []
    for c in coefs:
        t0 = _tree([(7, -1, -1, 0.0), (1, -1, -1, c), (4, 1, 0, 0.0)])
        fields.append([np.stack([np.asarray(a), np.asarray(b)]) for a, b in zip(t0, t1)])
    return [np.stack([f[i] for f in fields]).astype(dt)
            for i, dt in enumerate((np.int32, np.int32, np.int32, np.float32))]


def sr_function_sets():
    jf = jax_function_set(default_sr_operators(), [["x0", "x1"]], [2])
    return jf, function_set_from_jax(jf)


def test_constant_opt_improves_and_never_hurts():
    jf, fset = sr_function_sets()
    _, data = sr_case(t_end=3.0)
    ev = SREvaluator(fset, substeps=2)
    pop = trees_from_numpy(*vdp_candidates([0.8, 0.8]))  # K = 2
    base_fit = ev.evaluate_population(pop, data)
    optimise = make_constant_optimiser(ev.evaluate_population, adam(3e-2), gradient_steps=20)
    opt_fit, opt_pop = optimise(pop, data)
    assert (opt_fit <= base_fit + 1e-6).all()
    assert float(opt_fit[0]) < float(base_fit[0]) * 0.7  # real improvement
    assert torch.equal(opt_pop.ops, pop.ops)  # structure untouched: only consts changed
    c_row = opt_pop.const[0, 0]
    c_val = c_row[c_row != 0.0]
    assert len(c_val) == 1 and 0.8 < float(c_val[0]) <= 1.1


class RecordingEvaluator(SREvaluator):
    """Keeps the constants and fitness of every call (one per epoch)."""

    def __init__(self, *args, **kwargs):
        super().__init__(*args, **kwargs)
        self.calls = []

    def evaluate_population(self, population, data):
        fitness = super().evaluate_population(population, data)
        self.calls.append((population.const.detach().clone(), fitness.detach().clone()))
        return fitness


def test_optimise_matches_jax():
    jf, fset = sr_function_sets()
    jdata, data = sr_case(t_end=3.0)
    fields = vdp_candidates([0.8, 0.9, 1.05, 1.3])  # K = 4: the best epochs differ
    common = dict(num_generations=2, population_size=4, variable_list=[["x0", "x1"]],
                  layer_sizes=[2], max_nodes=N, gradient_steps=10)
    jgp = JaxGP(fitness_function=JaxSREvaluator(jf, substeps=2, interpreter="gather"),
                operator_list=default_sr_operators(), optimiser=optax.adam(3e-2), **common)
    want_fit, want = jax.jit(jgp.optimise)(JaxTrees(*map(jnp.asarray, fields)), jdata)
    want_fit, want_const = np.asarray(want_fit), np.asarray(want.const)

    ev = RecordingEvaluator(fset, substeps=2)
    gp = GeneticProgramming(fitness_function=ev, operator_list=default_sr_operators(),
                            optimiser=adam(3e-2), device="cpu", **common)
    got_fit, got = gp.optimise(trees_from_numpy(*fields), data)
    assert len(ev.calls) == 10
    consts = torch.stack([c for c, _ in ev.calls]).numpy()  # (epochs, K, m, N)
    fits = torch.stack([f for _, f in ev.calls]).numpy()  # (epochs, K)
    port_epoch = fits.argmin(axis=0)
    # JAX's chosen epoch: the port's epoch whose constants its result matches
    jax_epoch = np.abs(consts - want_const[None]).reshape(10, 4, -1).max(axis=-1).argmin(axis=0)
    np.testing.assert_array_equal(port_epoch, jax_epoch)
    assert len(set(port_epoch.tolist())) >= 3, port_epoch
    np.testing.assert_allclose(got_fit.numpy(), want_fit, rtol=1e-4)
    np.testing.assert_allclose(got.const.numpy(), want_const, rtol=1e-4, atol=1e-6)
    assert torch.equal(got.ops, torch.from_numpy(fields[0]))


@pytest.mark.parametrize("steps", [1, 3])
def test_optimise_records_pre_update_epochs(steps):
    """Epoch 0 is the unrefined candidate, so with one step nothing moves."""
    jf, fset = sr_function_sets()
    _, data = sr_case()
    ev = SREvaluator(fset, substeps=1)
    pop = trees_from_numpy(*vdp_candidates([0.7, 1.2, 1.0]))
    base = ev.evaluate_population(pop, data)
    fit, out = make_constant_optimiser(ev.evaluate_population, adam(1e-2), steps)(pop, data)
    assert (fit <= base).all()
    if steps == 1:
        assert torch.equal(fit, base) and torch.equal(out.const, pop.const)
    else:
        assert (fit[:2] < base[:2]).all() and not torch.equal(out.const, pop.const)
