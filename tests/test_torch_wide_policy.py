"""PyTorch port: the policy kernels' wide-state instance (#6 and #7 past
``state_size`` 2 and two targets; ``csrc/policy.cu`` built with
``-DMTGP_WIDE_STATE`` on ``csrc/tree_prog_wide.cuh``), and the fixed
instances past 1024 trajectories.

On the CPU:

* the wide host build (``g++``, the same per-lane code the card runs)
  against the plain versions, bit for bit per lane (states, controls, alive
  count, attempted steps), with the C library's math patched into PyTorch
  (``test_torch_kernels.patch_host_math``): the dynamic Acrobot at
  ``state_size`` 3, 4 and 8, ``StirredTankReactor(n_targets=3)``, 1,100
  trajectories at P = 2, observation rows (RK4) and observation plus Euler
  kick rows, series parameters, #6 (RK4 x 2) and #7 (dopri5 / bosh3, small
  budgets), T <= 6; its scratch split into several launches changes
  nothing;
* the wide host build against the fixed one at ``state_size`` 0 and 2 with
  two targets, bit for bit;
* the fixed launcher refuses ``state_size`` 3 and three targets, which
  ``run_policy(..., wide=True)`` takes;
* the evaluators against JAX's on the same inputs (JAX's generator and
  sampler, carried across by ``convert.py``): ``DynamicPolicyEvaluator(
  state_size=4)`` on Acrobot and ``StaticPolicyEvaluator`` on
  ``StirredTankReactor(n_targets=3)``, the port's fused path (the plain
  version, which the wide host build equals bit for bit) against JAX's
  general path (``interpreter="gather"``), the policy files' tolerance
  (``test_torch_policy.assert_fitness_agree``, rel <= 1e-4).

On the card (marker ``cuda``): each wide kernel against its plain version on
every lane at ``state_size`` 3, 8 and 40, three targets and 1,100
trajectories, with the dispatchers' launch counters; the wide instance
against the fixed one at ``state_size`` 0 and 2; the fixed instance at 1,100
trajectories against plain; ``policy_ext_wide`` and gplearn's user build's
wide form against plain; ``DynamicPolicyEvaluator(state_size=8)`` through
one launch of #6 wide and no #8.

JAX is imported only inside the tests that use it, so the card's run
(``pytest --noconftest -m cuda``, no JAX there) imports this file.
"""
import ctypes
import shutil

import pytest
import torch

from multitreegp_tpu_torch import _build
from multitreegp_tpu_torch.core import cuda_policy as cp
from multitreegp_tpu_torch.core import cuda_rollout as cro
from multitreegp_tpu_torch.core.registry import build_function_set, gplearn_operators
from multitreegp_tpu_torch.models import environments as tenvs
from multitreegp_tpu_torch.models.evaluators import generate_control_data
from multitreegp_tpu_torch.ops.initialization import make_population_sampler
from test_torch_kernels import patch_host_math, same_bits

torch.set_num_threads(1)

OPS = [("+", 2), ("-", 2), ("*", 2), ("/", 2, 0.2), ("sin", 1), ("cos", 1)]
WIDE = _build.widened(_build.DEFAULT)


def policy_case(name, state_size, pop=6, b=4, t_steps=5, n=30, depth=4, mode="Constant", ops=OPS,
                seed=0, **env_kw):
    """``(env, fset, data, trees)``: ``pop`` policies of ``state_size`` state
    trees and the plant's readout trees, ``n`` rows grown to ``depth``, on
    ``b`` trajectories of ``generate_control_data`` at ``ts = 0, 0.2, ...``
    (the port's generator, seeded)."""
    env = getattr(tenvs, name)(**env_kw)
    ys = [f"y{i}" for i in range(env.n_obs)]
    tg = [f"tgt{i}" for i in range(env.n_targets)]
    if state_size:
        a, u = [f"a{i}" for i in range(state_size)], [f"u{i}" for i in range(env.n_control)]
        fset = build_function_set(ops, [ys + a + u + tg, a + tg], [state_size, env.n_control])
    else:
        fset = build_function_set(ops, [ys + tg], [env.n_control])
    g = torch.Generator().manual_seed(seed)
    ts = torch.arange(t_steps, dtype=torch.float32) * 0.2
    data = generate_control_data(env, g, ts, batch_size=b, param_mode=mode)
    trees = make_population_sampler(fset, depth, n)(g, pop)[0]
    return env, fset, data, trees


def noise_rows(env, t_steps, b, substeps, stages, seed=3):
    """Observation-noise and kick rows of the kernels' widths."""
    g = torch.Generator().manual_seed(seed)
    obs = 0.1 * torch.randn((t_steps, b, substeps * stages * env.n_obs), generator=g)
    kick = 0.05 * torch.randn((t_steps, b, substeps * env.latent_size), generator=g)
    return obs, kick


@pytest.fixture(scope="module")
def host(tmp_path_factory):
    """``host(variant)``: the host build of ``csrc/policy.cu`` in
    ``variant``, built once."""
    if shutil.which("g++") is None and shutil.which("c++") is None:
        pytest.skip("no host C++ compiler")
    out = tmp_path_factory.mktemp("wide_policy_host")
    made = {}

    def get(variant):
        if variant.suffix not in made:
            lib = made[variant.suffix] = _build.build_host("policy", out, variant)
            if variant.suffix.endswith("_wide"):
                lib.policy_wide_host.argtypes = [ctypes.c_int, ctypes.c_void_p, ctypes.c_void_p,
                                                 ctypes.c_int, ctypes.c_int]
                lib.policy_wide_host.restype = ctypes.c_int
            else:
                lib.policy_host.argtypes = [ctypes.c_int, ctypes.c_void_p]
                lib.policy_host.restype = ctypes.c_int
        return made[variant.suffix]

    return get


def run_host(lib, kind, env, fset, data, trees, state_size, wide=True, **kw):
    """The host build's ``(xs, us, alive (T, P, B), steps)`` through
    ``run_policy``, the operand code the CUDA wrappers use."""
    x0, ts, tgt, _, _, par = data
    if wide:
        launch = lambda args, scratch, c0, count: lib.policy_wide_host(kind, args, scratch, c0, count)
    else:
        launch = lambda args: lib.policy_host(kind, args)
    status, xs, us, count, steps = cp.run_policy(launch, kind, trees, x0, ts, tgt, par, env, fset,
                                                 state_size, wide=wide, **kw)
    assert status == 0
    return xs, us, cp._alive_rows(count, ts.shape[0]), steps


def fixed_plain(env, fset, data, trees, state_size, method="rk4", substeps=2, rows=None):
    x0, ts, tgt, _, _, par = data
    return cp.policy_rollout_plain(trees, x0, ts, tgt, par, env, fset, substeps, method, state_size,
                                   **(rows or {}))


def adaptive_plain(env, fset, data, trees, state_size, method, budget):
    x0, ts, tgt, _, _, par = data
    return cp.policy_rollout_adaptive_plain(trees, x0, ts, tgt, par, env, fset, 1e-4, 1e-4, budget,
                                            method, 0.9, state_size)


def assert_same(got, ref):
    """Every lane identical: states, controls, alive (and attempted steps)."""
    assert same_bits(got[0], ref[0]) and same_bits(got[1], ref[1])
    assert torch.equal(got[2], ref[2])
    if len(ref) > 3:
        assert torch.equal(got[3], ref[3])


def fixed_kw(method="rk4", substeps=2, rows=None):
    return dict(method=method, substeps=substeps, **(rows or {}))


def adaptive_kw(method, budget):
    return dict(method=method, max_steps=budget, rtol=1e-4, atol=1e-4, safety=0.9)


# ------------------------------------------------ the wide host build vs plain

WIDE_CASES = [("Acrobot", 3, {}), ("Acrobot", 4, {}), ("Acrobot", 8, {}),
              ("StirredTankReactor", 0, dict(n_targets=3))]


@pytest.mark.parametrize("name,state_size,env_kw", WIDE_CASES)
def test_wide_fixed_step_host_bit_exact(host, monkeypatch, name, state_size, env_kw):
    env, fset, data, trees = policy_case(name, state_size, **env_kw)
    with monkeypatch.context() as m:
        patch_host_math(m)
        ref = fixed_plain(env, fset, data, trees, state_size)
    got = run_host(host(WIDE), cp.FIXED, env, fset, data, trees, state_size, **fixed_kw())
    assert_same(got[:3], ref)
    assert bool(ref[2][-1].any())


@pytest.mark.parametrize("name,state_size,env_kw", WIDE_CASES)
@pytest.mark.parametrize("method,budget", [("dopri5", 8), ("bosh3", 2)])
def test_wide_adaptive_host_bit_exact(host, monkeypatch, name, state_size, env_kw, method, budget):
    env, fset, data, trees = policy_case(name, state_size, t_steps=4, **env_kw)
    with monkeypatch.context() as m:
        patch_host_math(m)
        ref = adaptive_plain(env, fset, data, trees, state_size, method, budget)
    got = run_host(host(WIDE), cp.ADAPTIVE, env, fset, data, trees, state_size,
                   **adaptive_kw(method, budget))
    assert_same(got, ref)
    assert bool((ref[3] > 0).all())


@pytest.mark.parametrize("kind,state_size", [(cp.FIXED, 0), (cp.FIXED, 3), (cp.ADAPTIVE, 3)])
def test_wide_host_many_trajectories(host, monkeypatch, kind, state_size):
    """1,100 trajectories (a candidate spans gridDim.y blocks on the card)."""
    env, fset, data, trees = policy_case("Acrobot", state_size, pop=2, b=1100, t_steps=3)
    with monkeypatch.context() as m:
        patch_host_math(m)
        if kind == cp.FIXED:
            ref, kw = fixed_plain(env, fset, data, trees, state_size), fixed_kw()
        else:
            ref = adaptive_plain(env, fset, data, trees, state_size, "dopri5", 4)
            kw = adaptive_kw("dopri5", 4)
    got = run_host(host(WIDE), kind, env, fset, data, trees, state_size, **kw)
    assert_same(got if kind == cp.ADAPTIVE else got[:3], ref)


@pytest.mark.parametrize("name,state_size,method,noise,mode", [
    ("Acrobot", 3, "rk4", "obs", "Constant"),
    ("Acrobot", 5, "euler", "obs+kicks", "Constant"),
    ("ChangingHarmonicOscillator", 3, "rk4", "", "Decay"),  # series parameters, streamed
    ("StirredTankReactor", 0, "heun", "obs", "Different"),
])
def test_wide_host_rows_and_series(host, monkeypatch, name, state_size, method, noise, mode):
    env_kw = dict(n_targets=3) if name == "StirredTankReactor" else {}
    env, fset, data, trees = policy_case(name, state_size, t_steps=6, mode=mode, **env_kw)
    obs, kick = noise_rows(env, 6, 4, 2, len(cp.RK_TABLES[method][0]))
    rows = dict(obs_noise_rows=obs if "obs" in noise else None,
                process_noise_rows=kick if "kicks" in noise else None)
    with monkeypatch.context() as m:
        patch_host_math(m)
        ref = fixed_plain(env, fset, data, trees, state_size, method, rows=rows)
    got = run_host(host(WIDE), cp.FIXED, env, fset, data, trees, state_size, **fixed_kw(method, rows=rows))
    assert_same(got[:3], ref)


def test_wide_host_scratch_split(host, monkeypatch):
    """A scratch budget of a few candidates splits the launch into parts;
    every lane is the same."""
    env, fset, data, trees = policy_case("Acrobot", 4, pop=7)
    whole = run_host(host(WIDE), cp.ADAPTIVE, env, fset, data, trees, 4, **adaptive_kw("dopri5", 4))
    per_lane = cp.WIDE_VECTORS[cp.ADAPTIVE] * 8 + cp.data_width(env, 4, env.n_targets)
    monkeypatch.setattr(cro, "SCRATCH_BYTES", 3 * 4 * per_lane * 4)  # 3 candidates a part
    assert len(cro.wide_launches(7, 4, per_lane, 1)) == 3
    parts = run_host(host(WIDE), cp.ADAPTIVE, env, fset, data, trees, 4, **adaptive_kw("dopri5", 4))
    assert_same(parts, whole)


# --------------------------------------------- the wide host build vs the fixed

@pytest.mark.parametrize("kind,name,state_size,mode", [
    (cp.FIXED, "HarmonicOscillator2", 0, "Constant"), (cp.FIXED, "HarmonicOscillator2", 2, "Constant"),
    (cp.FIXED, "ChangingHarmonicOscillator", 2, "Switch"),  # series parameters
    (cp.ADAPTIVE, "HarmonicOscillator2", 0, "Constant"), (cp.ADAPTIVE, "HarmonicOscillator2", 2, "Constant"),
    (cp.ADAPTIVE, "Acrobot", 1, "Constant"),
])
def test_wide_host_equals_fixed(host, kind, name, state_size, mode):
    """Where the fixed instances run (two targets: the coupled oscillators),
    the wide one computes the same bits."""
    env, fset, data, trees = policy_case(name, state_size, mode=mode)
    assert cp.takes_fixed(env, state_size, data[2].shape[-1], fset.max_device_op)
    kw = fixed_kw() if kind == cp.FIXED else adaptive_kw("dopri5", 6)
    fixed = run_host(host(_build.DEFAULT), kind, env, fset, data, trees, state_size, wide=False, **kw)
    wide = run_host(host(WIDE), kind, env, fset, data, trees, state_size, **kw)
    assert_same(wide, fixed)


def test_fixed_launcher_refuses_past_its_limits(host):
    """The fixed instances refuse state_size 3 and three targets before
    launching; ``run_policy(..., wide=True)`` takes both."""
    for name, state_size, env_kw in (("Acrobot", 3, {}), ("StirredTankReactor", 0, dict(n_targets=3))):
        env, fset, data, trees = policy_case(name, state_size, pop=2, t_steps=3, **env_kw)
        assert not cp.takes_fixed(env, state_size, data[2].shape[-1], fset.max_device_op)
        with pytest.raises(NotImplementedError, match="fixed instances"):
            run_host(host(_build.DEFAULT), cp.FIXED, env, fset, data, trees, state_size, wide=False,
                     **fixed_kw())
        xs, us, alive, _ = run_host(host(WIDE), cp.FIXED, env, fset, data, trees, state_size,
                                    **fixed_kw())
        assert xs.shape == (3, 2, 4, env.latent_size + state_size) and us.shape[-1] == env.n_control


# -------------------------------------------------- the evaluators against JAX

@pytest.mark.parametrize("name,state_size,env_kw", [("Acrobot", 4, {}),
                                                    ("StirredTankReactor", 0, dict(n_targets=3))])
def test_evaluator_past_the_fixed_instances_matches_jax(name, state_size, env_kw):
    """The fused path (the gate admits it; on the card the wide instance)
    against JAX's evaluator on the same population and data: the rollouts,
    and the fitness where JAX's cost takes the data (its reactor cost
    squeezes the targets, so it takes one target; the port's reads the
    first)."""
    import jax

    from test_torch_policy import assert_fitness_agree, assert_lanes_agree, case, evaluators

    jenv, tenv, jf, tf, jdata, tdata, jpop, tpop = case(name, state_size=state_size, t_end=1.2,
                                                        **env_kw)
    jev, tev = evaluators(jenv, tenv, jf, tf, state_size, substeps=2)
    assert tev._fused_kind(tpop, tdata) == "fixed"
    assert not cp.takes_fixed(tenv, state_size, tdata[2].shape[-1], tf.max_device_op)
    jxs, jalive = jax.jit(jev._rollout_general)(jpop, jdata)
    xs, alive, _us = tev._rollout(tpop, tdata)
    assert_lanes_agree(xs, alive, jxs, jalive)
    if name != "StirredTankReactor":
        want = jax.jit(jev.evaluate_population)(jpop, jdata)
        assert_fitness_agree(tev.evaluate_population(tpop, tdata), want, tol=1e-4)


# ---------------------------------------------------------------- on the card


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    return torch.device("cuda")


def on(device, env, fset, data, trees):
    return env, fset, tuple(d.to(device) if torch.is_tensor(d) else
                            tuple(p.to(device) for p in d) for d in data), trees.map(lambda a: a.to(device))


def card_pairs(env, fset, data, trees, state_size):
    """(#6 via its dispatcher, #6 plain, #7 via its dispatcher, #7 plain)."""
    x0, ts, tgt, _, _, par = data
    fixed = (trees, x0, ts, tgt, par, env, fset, 2, "rk4", state_size)
    adaptive = (trees, x0, ts, tgt, par, env, fset, 1e-4, 1e-4, 8, "dopri5", 0.9, state_size)
    return ((lambda: cp.rollout_policy(*fixed), lambda: cp.policy_rollout_plain(*fixed)),
            (lambda: cp.rollout_policy_adaptive(*adaptive, return_steps=True),
             lambda: cp.policy_rollout_adaptive_plain(*adaptive)))


COUNTERS = (cp.policy_rollout_cuda, cp.policy_rollout_adaptive_cuda, cp.policy_rollout_wide_cuda,
            cp.policy_rollout_adaptive_wide_cuda)


@pytest.mark.cuda
@pytest.mark.parametrize("name,state_size,b,env_kw", [("Acrobot", 3, 16, {}), ("Acrobot", 8, 16, {}),
                                                      ("Acrobot", 40, 4, {}), ("Acrobot", 3, 1100, {}),
                                                      ("StirredTankReactor", 0, 16, dict(n_targets=3))])
def test_wide_kernels_match_plain_on_card(cuda, name, state_size, b, env_kw):
    env, fset, data, trees = on(cuda, *policy_case(name, state_size, pop=64 if b < 1000 else 2, b=b,
                                                   **env_kw))
    before = [c.launches for c in COUNTERS]
    for kernel, plain in card_pairs(env, fset, data, trees, state_size):
        got = kernel()
        torch.cuda.synchronize()
        assert_same(got, plain())
    assert [c.launches - n for c, n in zip(COUNTERS, before)] == [0, 0, 1, 1]


@pytest.mark.cuda
@pytest.mark.parametrize("name,state_size", [("HarmonicOscillator2", 0), ("Acrobot", 2)])
def test_wide_kernels_equal_fixed_on_card(cuda, name, state_size):
    env, fset, data, trees = on(cuda, *policy_case(name, state_size, pop=256, b=16, t_steps=11))
    x0, ts, tgt, _, _, par = data
    fixed = (trees, x0, ts, tgt, par, env, fset, 4, "rk4", state_size)
    adaptive = (trees, x0, ts, tgt, par, env, fset, 1e-4, 1e-4, 8, "dopri5", 0.9, state_size)
    assert_same(cp.policy_rollout_wide_cuda(*fixed), cp.policy_rollout_cuda(*fixed))
    assert_same(cp.policy_rollout_adaptive_wide_cuda(*adaptive), cp.policy_rollout_adaptive_cuda(*adaptive))


@pytest.mark.cuda
@pytest.mark.parametrize("state_size", [0, 2])
def test_fixed_kernels_past_1024_trajectories_on_card(cuda, state_size):
    env, fset, data, trees = on(cuda, *policy_case("Acrobot", state_size, pop=3, b=1100))
    before = [c.launches for c in COUNTERS]
    for kernel, plain in card_pairs(env, fset, data, trees, state_size):
        got = kernel()
        torch.cuda.synchronize()
        assert_same(got, plain())
    assert [c.launches - n for c, n in zip(COUNTERS, before)] == [1, 1, 0, 0]


@pytest.mark.cuda
@pytest.mark.parametrize("ops", ["ext", "gplearn"])
def test_wide_operator_builds_on_card(cuda, ops):
    """``policy_ext_wide`` and the wide form of gplearn's user build."""
    op_list = (OPS + [("tanh", 1, 0.3), ("exp", 1, 0.1)] if ops == "ext"
               else gplearn_operators())
    env, fset, data, trees = on(cuda, *policy_case("Acrobot", 3, pop=64, ops=op_list))
    assert fset.extended
    for kernel, plain in card_pairs(env, fset, data, trees, 3):
        got = kernel()
        torch.cuda.synchronize()
        assert_same(got, plain())
    assert _build.variant_name("policy", _build.widened(fset.variant)) in _build._loaded


@pytest.mark.cuda
def test_dynamic_evaluator_takes_the_wide_kernel_on_card(cuda):
    from multitreegp_tpu_torch.core import cuda_interpreter as ci
    from multitreegp_tpu_torch.models.evaluators import DynamicPolicyEvaluator

    env, fset, data, trees = on(cuda, *policy_case("Acrobot", 8, pop=64, b=16, t_steps=11))
    ev = DynamicPolicyEvaluator(env, fset, state_size=8, substeps=2)
    before, fwd = cp.policy_rollout_wide_cuda.launches, ci.evaluate_trees_cuda.launches
    fitness = ev.evaluate_population(trees, data)
    torch.cuda.synchronize()
    assert cp.policy_rollout_wide_cuda.launches == before + 1
    assert ci.evaluate_trees_cuda.launches == fwd
    assert bool(((fitness >= 0) & (fitness <= 1e4)).all())
