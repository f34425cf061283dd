"""PyTorch port: fixed-step integration against JAX ``integrate`` (CPU).

The drift is a JAX-sampled population of ``+ - *`` trees evaluated by each
package's interpreter (JAX's compact ``gather`` variant, same semantics as
the ladder). Tolerance on live lanes over a short horizon (T = 5): rtol 1e-5
(+ atol 1e-6); alive masks identical. The drifts agree bit for bit, but
XLA:CPU contracts ``x + dt * k`` into fused multiply-adds and the port does
not (its CUDA kernel is built with -fmad=false to match it), so about one
step in five differs by an ulp, and on fast-growing lanes those ulps reach
~2e-6 relative within four steps. Division is left out here because a
near-singular ``/`` amplifies them past any tight bound; the SR evaluator
test covers ``/`` statistically.
``test_rk_steps_bit_exact`` pins the port's own expression order exactly.
"""
import jax.numpy as jnp
import jax.random as jr
import numpy as np
import pytest
import torch

from multitreegp_tpu.core.interpreter import evaluate_trees as jax_evaluate
from multitreegp_tpu.core.registry import build_function_set as jax_function_set
from multitreegp_tpu.models.integrators import integrate as jax_integrate
from multitreegp_tpu.ops.initialization import make_population_sampler as jax_sampler
from multitreegp_tpu_torch.convert import function_set_from_jax, trees_from_numpy
from multitreegp_tpu_torch.core.interpreter import evaluate_trees
from multitreegp_tpu_torch.models.integrators import integrate

torch.set_num_threads(1)

OPS = [("+", jnp.add, 2, 0.5), ("-", jnp.subtract, 2, 0.1), ("*", jnp.multiply, 2, 0.5)]


@pytest.fixture(scope="module")
def setup():
    jf = jax_function_set(OPS, [["x0", "x1"]], [2])
    pop = jax_sampler(jf, 3, 8)(jr.PRNGKey(5), 16)
    x0 = np.random.default_rng(1).normal(size=(16, 4, 2)).astype(np.float32)
    ts = np.arange(0.0, 1.0, 0.2, dtype=np.float32)  # T = 5
    return jf, pop, x0, ts


@pytest.mark.parametrize("method", ["euler", "heun", "rk4"])
@pytest.mark.parametrize("substeps", [1, 2])
def test_integrate_matches_jax(setup, method, substeps):
    jf, pop, x0, ts = setup
    jtrees = pop[:, None]

    def jdrift(t, x):
        return jax_evaluate(jtrees, x[:, :, None, :], jf, impl="gather")

    jxs, jalive = jax_integrate(jdrift, jnp.asarray(x0), jnp.asarray(ts), method=method, substeps=substeps)

    tf = function_set_from_jax(jf)
    ttrees = trees_from_numpy(*[np.asarray(a) for a in pop]).map(lambda a: a[:, None])

    def tdrift(t, x):
        return evaluate_trees(ttrees, x[:, :, None, :], tf)

    xs, alive = integrate(tdrift, torch.from_numpy(x0), torch.from_numpy(ts), method, substeps)
    assert xs.shape == (5, 16, 4, 2) and alive.shape == (5, 16, 4)
    np.testing.assert_array_equal(alive.numpy(), np.asarray(jalive))
    live = np.asarray(jalive)[-1]
    np.testing.assert_allclose(xs.numpy()[:, live], np.asarray(jxs)[:, live], rtol=1e-5, atol=1e-6)


def _numpy_rk(method, f, x, dt):
    """float32 numpy steps in the JAX steppers' expression order, no FMA."""
    f32 = np.float32
    if method == "euler":
        return x + dt * f(x)
    k1 = f(x)
    if method == "heun":
        k2 = f(x + dt * k1)
        return x + (f32(0.5) * dt) * (k1 + k2)
    h = f32(0.5) * dt
    k2 = f(x + h * k1)
    k3 = f(x + h * k2)
    k4 = f(x + dt * k3)
    return x + (dt / f32(6.0)) * (((k1 + f32(2) * k2) + f32(2) * k3) + k4)


@pytest.mark.parametrize("method", ["euler", "heun", "rk4"])
def test_rk_steps_bit_exact(method):
    """Three substeps per interval on a nonlinear drift equal numpy float32
    evaluated in the same order — the order the CUDA kernel copies."""
    x0 = np.random.default_rng(2).normal(size=(64, 2)).astype(np.float32)
    ts = np.array([0.0, 0.3, 0.7], np.float32)

    def f(x):
        return np.stack([x[:, 1], (np.float32(1) - x[:, 0] * x[:, 0]) * x[:, 1] - x[:, 0]], -1)

    def ft(t, x):
        return torch.stack([x[:, 1], (1.0 - x[:, 0] * x[:, 0]) * x[:, 1] - x[:, 0]], -1)

    xs, _ = integrate(ft, torch.from_numpy(x0), torch.from_numpy(ts), method, substeps=3)
    x = x0
    for t in range(2):
        dt = (ts[t + 1] - ts[t]) / np.float32(3)
        for _ in range(3):
            x = _numpy_rk(method, f, x, dt)
        np.testing.assert_array_equal(xs[t + 1].numpy(), x)


def test_divergence_freezes_lane():
    # dx = x^2 / (1 - t)-like blow-up: x' = 100 x^2 leaves the 1e8 bound fast
    x0 = torch.tensor([[1.0], [0.0]])
    ts = torch.arange(0.0, 1.0, 0.1)
    xs, alive = integrate(lambda t, x: 100.0 * x * x, x0, ts, "euler", 1)
    assert not bool(alive[-1, 0]) and bool(alive[-1, 1])
    dead_at = int(torch.argmin(alive[:, 0].int()))
    assert torch.isfinite(xs[dead_at:, 0]).all()
    assert (xs[dead_at:, 0] == xs[dead_at - 1, 0]).all()  # frozen state
