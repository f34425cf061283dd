"""PyTorch port: ``SREvaluator.prepare_chained``, the split prepare/run API
for one population structure whose constants change.

* It returns None on the configurations where JAX's does (the adaptive
  method without process noise, ``interpreter="ladder"`` / ``"gather"``,
  ``m != d``, ``N > 256``), checked against JAX's own ``prepare_chained``
  in interpret mode, and where the port's ``evaluate_population`` does not
  take kernel #1 although JAX's would (a candidate's program past a block's
  shared memory: the port's own limit; d > 4 and B > 1024 take #1's wide
  instance, ``test_torch_wide_state.py``).
* ``step(const)`` equals ``evaluate_population(population._replace(const=
  const), data)`` bit for bit, fitness and gradient, for the ODE (RK4,
  Heun) and the SDE (Euler-Maruyama with the hoisted kick rows), at
  ``const0`` and at shifted constants; ``const0`` is the population's
  constants in population order.
* ``step(const0)`` against JAX's ``evaluate_population`` (``interpreter=
  "gather"``) on the same numpy-made data and candidates, to the rollout
  tests' tolerance (``test_torch_sr_evaluator.py``: the same candidates
  clamped, median relative error <= 1e-6 and the largest <= 1e-4).
* On the card (marker ``cuda``): the same bit-for-bit equality through
  kernel #1, one launch per step.

JAX is imported only inside the tests that use it, so the card's test run
(``pytest --noconftest``, no JAX there) can import this file.
"""
import numpy as np
import pytest
import torch

from multitreegp_tpu_torch.core import cuda_rollout as cro
from multitreegp_tpu_torch.core.registry import build_function_set
from multitreegp_tpu_torch.core.trees import TreeTensors
from multitreegp_tpu_torch.models.environments import VanDerPolOscillator
from multitreegp_tpu_torch.models.evaluators import SREvaluator, generate_sr_data
from multitreegp_tpu_torch.ops.initialization import make_population_sampler

torch.set_num_threads(1)

OPS = [("+", 2, 0.5), ("-", 2, 0.1), ("*", 2, 0.5), ("/", 2, 0.1)]
PN = 0.15


def port_case(device="cpu", pop=16, b=4, n=16, noise=0.0):
    fset = build_function_set(OPS, [["x0", "x1"]], [2])
    g = torch.Generator(device=device).manual_seed(4)
    trees = make_population_sampler(fset, 3, n)(g, pop)[0]
    data = generate_sr_data(VanDerPolOscillator(noise, 0.0), g,
                            torch.arange(0.0, 2.0, 0.2, device=device), batch_size=b, substeps=8)
    return fset, trees, data


def shaped(p, m, n):
    z = torch.zeros((p, m, n), dtype=torch.int32)
    return TreeTensors(z, z, z, z.float())


REFUSED = {  # name: (evaluator keywords, (m, n, d, b)), where JAX's prepare_chained is None too
    "adaptive": (dict(method="adaptive"), (2, 16, 2, 4)),
    "ladder": (dict(interpreter="ladder"), (2, 16, 2, 4)),
    "gather": (dict(interpreter="gather"), (2, 16, 2, 4)),
    "m_ne_d": ({}, (1, 16, 2, 4)),
    "n257": ({}, (2, 257, 2, 4)),
}


@pytest.mark.parametrize("name", sorted(REFUSED))
def test_prepare_chained_none_as_jax(name):
    import jax.numpy as jnp
    from jax.experimental.pallas import tpu as pltpu

    from multitreegp_tpu.core.registry import build_function_set as jax_function_set
    from multitreegp_tpu.core.trees import TreeTensors as JaxTrees
    from multitreegp_tpu.models.evaluators import SREvaluator as JaxSREvaluator

    kwargs, (m, n, d, b) = REFUSED[name]
    data = (torch.zeros((b, d)), torch.arange(0.0, 1.0, 0.2), torch.zeros((b, 5, d)), None)
    assert SREvaluator(substeps=1, **kwargs).prepare_chained(shaped(3, m, n), data) is None
    names = [f"x{i}" for i in range(d)]
    jf = jax_function_set([("+", jnp.add, 2, 0.5)], [names], [m])
    z = jnp.zeros((3, m, n), jnp.int32)
    jdata = tuple(None if a is None else jnp.asarray(a.numpy()) for a in data)
    with pltpu.force_tpu_interpret_mode():
        assert JaxSREvaluator(jf, substeps=1, **kwargs).prepare_chained(
            JaxTrees(z, z, z, z.astype(jnp.float32)), jdata) is None


@pytest.mark.parametrize("m,n,d,b", [(900, 32, 900, 4), (120, 256, 120, 4)])
def test_prepare_chained_none_past_the_port_limits(m, n, d, b):
    """A candidate's decoded program past a block's shared memory (900 trees
    of 32 rows, 120 of 256): the port's ``evaluate_population`` takes the
    general path there (``lanes_refusal``), so there is no step to prepare."""
    data = (torch.zeros((b, d)), torch.arange(0.0, 1.0, 0.2), torch.zeros((b, 5, d)), None)
    ev = SREvaluator(substeps=1)
    assert not ev._fused(shaped(3, m, n), data[0])
    assert ev.prepare_chained(shaped(3, m, n), data) is None


CHAINED = [("rk4", 1, 0.0), ("heun", 2, 0.0), ("rk4", 2, PN)]  # the last an SDE


def same(a, b) -> bool:
    """Bit for bit, NaN equal to NaN (a diverging candidate's gradient is
    NaN on the card)."""
    return a.shape == b.shape and bool(((a == b) | (a.isnan() & b.isnan())).all())


def check_step(ev, trees, data):
    """``step`` against ``evaluate_population`` bit for bit, fitness and
    gradient, at ``const0`` and at shifted constants."""
    step, const0 = ev.prepare_chained(trees, data)
    assert torch.equal(const0, trees.const)
    for shift in (0.0, 0.125):
        c = (const0 + shift).requires_grad_(True)
        got = step(c)
        (g_got,) = torch.autograd.grad(got.sum(), (c,))
        c2 = (trees.const + shift).requires_grad_(True)
        want = ev.evaluate_population(trees._replace(const=c2), data)
        (g_want,) = torch.autograd.grad(want.sum(), (c2,))
        assert same(got, want) and same(g_got, g_want)
    return step, const0


@pytest.mark.parametrize("method,substeps,noise", CHAINED)
def test_step_equals_evaluate_population(method, substeps, noise, monkeypatch):
    fset, trees, data = port_case(noise=noise)
    ev = SREvaluator(fset, method=method, substeps=substeps, process_noise=noise)
    step, const0 = check_step(ev, trees, data)
    if noise:  # the kick rows are built once, in prepare_chained
        calls, real = [], cro.SRFitness.apply
        monkeypatch.setattr(cro.SRFitness, "apply", lambda *a: calls.append(a[-1]) or real(*a))
        step(const0)
        step(const0)
        assert len(calls) == 2 and calls[0] is calls[1] and calls[0].kick_rows.is_contiguous()


@pytest.mark.parametrize("method,substeps,noise", CHAINED)
def test_step_matches_jax_evaluate_population(method, substeps, noise):
    import jax
    import jax.numpy as jnp
    import jax.random as jr

    from multitreegp_tpu.core.registry import build_function_set as jax_function_set
    from multitreegp_tpu.models.environments import VanDerPolOscillator as JaxVdP
    from multitreegp_tpu.models.evaluators import SREvaluator as JaxSREvaluator
    from multitreegp_tpu.models.evaluators import generate_sr_data as jax_generate_sr
    from multitreegp_tpu.ops.initialization import make_population_sampler as jax_sampler
    from multitreegp_tpu_torch.convert import function_set_from_jax, sr_data_from_numpy, trees_from_numpy

    jf = jax_function_set([("+", jnp.add, 2, 0.5), ("-", jnp.subtract, 2, 0.1),
                           ("*", jnp.multiply, 2, 0.5), ("/", jnp.divide, 2, 0.1)],
                          [["x0", "x1"]], [2])
    data = jax_generate_sr(JaxVdP(noise, 0.0), jr.PRNGKey(0), jnp.arange(0.0, 2.0, 0.2),
                           batch_size=4, substeps=8)
    pop = jax_sampler(jf, 3, 8)(jr.PRNGKey(1), 16)
    jev = JaxSREvaluator(jf, method=method, substeps=substeps, process_noise=noise,
                         interpreter="gather")
    ref = np.asarray(jax.jit(jev.evaluate_population)(pop, data))
    ev = SREvaluator(function_set_from_jax(jf), method=method, substeps=substeps, process_noise=noise)
    step, const0 = ev.prepare_chained(trees_from_numpy(*[np.asarray(a) for a in pop]),
                                      sr_data_from_numpy(*data))
    got = step(const0).numpy()
    clamped = ref == 1e5
    np.testing.assert_array_equal(got == 1e5, clamped)
    ok = ~clamped
    assert ok.sum() >= 8
    rel = np.abs(got[ok] - ref[ok]) / np.maximum(np.abs(ref[ok]), 1e-12)
    assert np.median(rel) <= 1e-6 and rel.max() <= 1e-4, rel


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU (CUDA kernels have no CPU mode)")
    return torch.device("cuda")


@pytest.mark.cuda
@pytest.mark.parametrize("method,substeps,noise", CHAINED)
def test_step_equals_evaluate_population_on_card(cuda, method, substeps, noise):
    fset, trees, data = port_case(cuda, pop=512, b=16, n=32, noise=noise)
    ev = SREvaluator(fset, method=method, substeps=substeps, process_noise=noise)
    before = cro.sr_fitness_cuda.launches
    step, const0 = check_step(ev, trees, data)
    torch.cuda.synchronize()
    assert cro.sr_fitness_cuda.launches == before + 4  # two steps, two evaluations
