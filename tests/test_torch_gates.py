"""PyTorch port: which path the evaluators take, against the JAX evaluator (CPU).

* The gate of the per-lane SR kernels (``core.cuda_rollout.lanes_refusal``)
  refuses one tree per state dimension short of ``m == d``, ``N > 256`` and
  a candidate's decoded program past a block's 227 KB of shared memory
  (with that reason), and admits the main path's shapes and any state dim
  and trajectory count within that (d = 5 and 40, B = 1,025 and 2,048: the
  kernels' wide instance on the card); the SR evaluator takes the general
  path where it refuses (and for ``interpreter="ladder"`` / ``"gather"``),
  and the fused one elsewhere, with the fitness of JAX's evaluator with the
  same keywords on the same population and data, made with numpy and JAX.
* ``SREvaluator`` takes JAX's ``remat`` and ``interpreter`` keywords.
* The policy evaluators' gate (``core.cuda_policy.policy_lanes_refusal``)
  admits any trajectory count (1,025), number of targets (3) and hidden
  state (3, 8, 112 at N = 256) whose candidate's decoded program fits a
  block's 227 KB of shared memory, and refuses past it (113 state trees +
  1 readout at N = 256), where the general path evaluates.

Tolerances are those of ``test_torch_sr_evaluator.py``: lanes clamped to
``max_fitness`` agree exactly; elsewhere the median relative fitness error
stays <= 1e-6 and the largest <= 1e-4 (XLA:CPU contracts the RK updates into
fused multiply-adds, the port does not), over T = 5 save points. With 1,025
random trajectories the largest is <= 2e-3: one trajectory (candidate 8,
trajectory 751) passes within ulps of a division's pole at its last step,
where a 1-ulp gap in the state moves that trajectory's MSE by 1.1e-3 and the
candidate's mean by 1.3e-4. Kernel #8's use on the card is
held in ``test_torch_kernels.py`` (``test_sr_evaluator_general_path_on_card``,
``test_policy_evaluator_general_path_on_card``).
"""
import jax
import jax.numpy as jnp
import jax.random as jr
import numpy as np
import pytest
import torch

from multitreegp_tpu.core.registry import build_function_set as jax_function_set
from multitreegp_tpu.models.evaluators import SREvaluator as JaxSREvaluator
from multitreegp_tpu.ops.initialization import make_population_sampler as jax_sampler
from multitreegp_tpu_torch.convert import function_set_from_jax, sr_data_from_numpy, trees_from_numpy
from multitreegp_tpu_torch.core.cuda_policy import policy_lanes_refusal
from multitreegp_tpu_torch.core.cuda_rollout import lanes_refusal
from multitreegp_tpu_torch.core.registry import build_function_set
from multitreegp_tpu_torch.core.trees import TreeTensors
from multitreegp_tpu_torch.models.environments import Acrobot
from multitreegp_tpu_torch.models.evaluators import (
    DynamicPolicyEvaluator, SREvaluator, StaticPolicyEvaluator, generate_control_data,
)
from multitreegp_tpu_torch.ops.initialization import make_population_sampler

torch.set_num_threads(1)

OPS = [("+", jnp.add, 2, 0.5), ("-", jnp.subtract, 2, 0.1), ("*", jnp.multiply, 2, 0.5),
       ("/", jnp.divide, 2, 0.1)]


def shaped_trees(p, m, n):
    z = torch.zeros((p, m, n), dtype=torch.int32)
    return TreeTensors(z, z, z, z.float())


@pytest.mark.parametrize("m,n,d,b,fused", [
    (2, 32, 2, 16, True),     # the main path
    (4, 256, 4, 1024, True),  # the fixed instances' limits at their edge
    (1, 32, 2, 16, False),    # m != d
    (5, 32, 5, 16, True),     # d = 5: the wide instance
    (2, 32, 2, 1025, True),   # B = 1025: the wide instance
    (2, 257, 2, 16, False),   # N = 257
    (40, 32, 40, 16, True),   # Lorenz-96's 40 states
    (2, 32, 2, 2048, True),   # 2,048 trajectories
    (894, 32, 894, 2, True),  # the largest program a block holds at N = 32
    (113, 256, 113, 2, True),  # ... at N = 256
    (895, 32, 895, 2, False),  # past a block's shared memory
    (114, 256, 114, 2, False),
])
def test_lanes_gate(m, n, d, b, fused):
    assert (lanes_refusal(m, n, d, b) is None) == fused
    if not fused and m == d and n <= 256:
        assert "shared memory" in lanes_refusal(m, n, d, b)
    x0s = torch.zeros((b, d))
    assert SREvaluator(substeps=1)._fused(shaped_trees(3, m, n), x0s) == fused
    for interp in ("ladder", "gather"):
        assert not SREvaluator(substeps=1, interpreter=interp)._fused(shaped_trees(3, m, n), x0s)


def test_sr_evaluator_takes_the_jax_keywords():
    ev = SREvaluator(None, 1e5, "rk4", 2, True, "ladder")  # JAX's positional order
    assert ev.substeps == 2 and ev.remat is True and ev.interpreter == "ladder"
    ev = SREvaluator(remat=True)
    assert ev.remat is True and ev.interpreter == "auto"
    assert SREvaluator(interpreter="gather").interpreter == "gather"


def case(m, d, b, seed=0, t_steps=5):
    """A JAX function set of ``d`` variables and ``m`` trees, its population
    of 16, and numpy-made data: x0s ``(b, d)`` in [-1, 1], ys ``(b, T, d)``."""
    names = [f"x{i}" for i in range(d)]
    jf = jax_function_set(OPS, [names], [m])
    pop = jax_sampler(jf, 3, 8)(jr.PRNGKey(seed + 1), 16)
    rng = np.random.default_rng(seed)
    x0s = rng.uniform(-1.0, 1.0, (b, d)).astype(np.float32)
    ts = (np.arange(t_steps) * 0.2).astype(np.float32)
    ys = rng.uniform(-1.0, 1.0, (b, t_steps, d)).astype(np.float32)
    return jf, pop, (jnp.asarray(x0s), jnp.asarray(ts), jnp.asarray(ys), None)


def assert_fitness_close(got, ref, max_rel=1e-4):
    assert got.shape == ref.shape and np.isfinite(got).all()
    clamped = ref == 1e5
    np.testing.assert_array_equal(got == 1e5, clamped)
    ok = ~clamped
    assert ok.any()
    rel = np.abs(got[ok] - ref[ok]) / np.maximum(np.abs(ref[ok]), 1e-12)
    assert np.median(rel) <= 1e-6 and rel.max() <= max_rel, rel


@pytest.mark.parametrize("m,d,b,kwargs", [
    (2, 2, 4, dict(interpreter="ladder")),
    (2, 2, 4, dict(interpreter="gather", method="heun")),
    (2, 2, 4, dict(remat=True)),
    (1, 2, 4, {}),      # m != d: the one tree's drift broadcasts over the state
    (5, 5, 4, {}),      # d = 5
    (2, 2, 1025, {}),   # B = 1025
])
def test_evaluate_population_matches_jax(m, d, b, kwargs):
    """The port's fitness against JAX's with the same keywords: the general
    path wherever the gate refuses or the interpreter is not the fused one,
    else the fused path, whose CPU dispatch is the plain version (``remat=
    True``; d = 5 and B = 1025, the wide instance on the card)."""
    jf, pop, data = case(m, d, b)
    jax_kwargs = dict(kwargs)
    if "interpreter" not in jax_kwargs:
        jax_kwargs["interpreter"] = "gather"  # the general path on the CPU, compiled in seconds
    ref = np.asarray(jax.jit(JaxSREvaluator(jf, substeps=1, **jax_kwargs).evaluate_population)(pop, data))
    ev = SREvaluator(function_set_from_jax(jf), substeps=1, **kwargs)
    trees = trees_from_numpy(*[np.asarray(a) for a in pop])
    tdata = sr_data_from_numpy(*[np.asarray(a) for a in data[:3]])
    fused = ev._fused(trees, tdata[0])
    assert fused == (m == d and kwargs.get("interpreter", "auto") == "auto")
    assert_fitness_close(ev.evaluate_population(trees, tdata).numpy(), ref,
                         1e-4 if b <= 16 else 2e-3)


@pytest.mark.parametrize("b,targets,state_size,n,kind", [
    (16, 0, 0, 8, "fixed"), (16, 2, 0, 8, "fixed"),
    (1025, 0, 0, 8, "fixed"),    # past 1024 trajectories: the fixed instances (gridDim.y)
    (16, 3, 0, 8, "fixed"),      # three targets: the wide instance on the card
    (16, 1, 3, 8, "fixed"),      # state_size 3 and 8: the wide instance
    (16, 1, 8, 8, "fixed"),
    (16, 1, 112, 256, "fixed"),  # the largest program a block holds at N = 256 (113 trees)
    (16, 1, 113, 256, None),     # past a block's shared memory: the general path
])
def test_policy_gate_refuses_what_check_policy_rejects(b, targets, state_size, n, kind):
    """The policy evaluators' gate (``policy_lanes_refusal``) admits any
    trajectory count, number of targets and hidden state whose candidate's
    decoded program fits a block's shared memory, and refuses past it, with
    that reason; where it refuses, the general path evaluates."""
    env = Acrobot()
    ys = [f"y{i}" for i in range(env.n_obs)]
    tg = [f"tgt{i}" for i in range(targets)]
    if state_size:
        a = [f"a{i}" for i in range(state_size)]
        fset = build_function_set([("+", 2), ("*", 2)], [ys + a + ["u0"] + tg, a + tg],
                                  [state_size, env.n_control])
        ev = DynamicPolicyEvaluator(env, fset, state_size=state_size, substeps=1)
    else:
        fset = build_function_set([("+", 2), ("*", 2)], [ys + tg], [env.n_control])
        ev = StaticPolicyEvaluator(env, fset, substeps=1)
    env.n_targets = targets  # the data vector the function set was built for
    g = torch.Generator().manual_seed(0)
    ts = torch.arange(0.0, 0.6, 0.2)
    x0, ts, _, pk, ok, par = generate_control_data(Acrobot(), g, ts, batch_size=b)
    tgt = torch.zeros((b, targets))
    trees = make_population_sampler(fset, 2, n)(g, 4)[0]
    data = (x0, ts, tgt, pk, ok, par)
    m = state_size + env.n_control
    assert ev._fused_kind(trees, data) == kind
    assert (policy_lanes_refusal(m, n) is None) == (kind is not None)
    if kind is None:  # the general path evaluates where the kernel would refuse
        assert "shared memory" in policy_lanes_refusal(m, n)
        fitness = ev.evaluate_population(trees, data)
        assert fitness.shape == (4,) and bool(((fitness >= 0) & (fitness <= 1e4)).all())
