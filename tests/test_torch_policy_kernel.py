"""PyTorch port: the closed-loop policy kernels' plain versions (#6 and #7)
and the host build of ``csrc/policy.cu``, against the port's general path
and the JAX package.

Tolerances, and why:

* the plain versions of #6 and #7 against the port's general path:
  identical alive on >= 98% of lanes; on lanes alive in both, the largest
  state (and control) difference within 1e-4 of the lane's largest value.
  #6 takes one step size for the whole grid and the general path one per
  interval, and #6 interpolates series parameters between rows at the
  stage's fraction where the general path calls ``linear_interp``.
* the host build of ``csrc/policy.cu`` against both plain versions, per
  lane (N = 30, and N = 128 and 256 with chains of 255, 127 and 63 rows;
  #7 also with budgets of 1 and 2 steps per interval): states, controls,
  alive count and attempted steps bit for bit, with
  ``torch.sin``/``cos``/``exp`` (and, for #7, ``pow`` and ``sqrt``)
  computed as the host build computes them; with PyTorch's own CPU
  functions, identical alive on >= 99.5% of lanes and rel <= 1e-3.
* the noise legs: the plain version of #6 fed JAX-made observation-noise
  rows and Euler-Maruyama kicks against JAX's general path with the same
  keys (T = 6): the first criterion.
* the plain version of #6 against JAX's ``rollout_policy_pallas`` run in
  interpret mode (8 candidates x 4 trajectories, T = 5, N = 16): the first
  criterion.

The card checks are in ``test_torch_kernels.py`` (marker ``cuda``).
"""
import ctypes
import shutil

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from jax.experimental.pallas import tpu as pltpu

from multitreegp_tpu.core import pallas_policy as jax_policy
from multitreegp_tpu.models.evaluators import StaticPolicyEvaluator as JaxStatic
from multitreegp_tpu.models.evaluators.noise import make_obs_noise_rows, make_process_noise_rows
from multitreegp_tpu_torch import _build
from multitreegp_tpu_torch.core import cuda_policy as cp
from multitreegp_tpu_torch.core.registry import build_function_set
from multitreegp_tpu_torch.models import environments as tenvs
from multitreegp_tpu_torch.models.evaluators import generate_control_data
from multitreegp_tpu_torch.ops.initialization import make_population_sampler
from test_torch_kernels import patch_host_math, same_bits, with_chains
from test_torch_policy import GENERAL_CASES, assert_lanes_agree, case, evaluators

torch.set_num_threads(1)


# ------------------------------------ (b) the plain kernels vs the general path

@pytest.mark.parametrize("state_size", [0, 1])
@pytest.mark.parametrize("name,mode", GENERAL_CASES[:4])
def test_policy_plain_matches_general_path(name, mode, state_size):
    _, tenv, _, tf, _, tdata, _, tpop = case(name, mode, state_size, pop=12)
    x0, ts, tgt, _, _, par = tdata
    tev = evaluators(None, tenv, None, tf, state_size, substeps=2)[1]
    xs, us, alive = cp.rollout_policy(tpop, x0, ts, tgt, par, tenv, tf, 2, "rk4", state_size)
    gxs, galive = tev._rollout_general(tpop, tdata)
    gus = tev._replay_controls(tpop, gxs, tdata)
    assert_lanes_agree(xs, alive, gxs, galive)
    assert_lanes_agree(us, alive, gus, galive)


@pytest.mark.parametrize("method", ["dopri5", "bosh3"])
@pytest.mark.parametrize("name,state_size", [("Acrobot", 0), ("Acrobot", 2),
                                             ("HarmonicOscillator2", 0), ("CartPole", 1)])
def test_policy_adaptive_plain_matches_general_path(name, state_size, method):
    _, tenv, _, tf, _, tdata, _, tpop = case(name, "Constant", state_size, pop=12)
    x0, ts, tgt, _, _, par = tdata
    tev = evaluators(None, tenv, None, tf, state_size, substeps=8, method="adaptive",
                     adaptive_method=method)[1]
    xs, us, alive, steps = cp.rollout_policy_adaptive(
        tpop, x0, ts, tgt, par, tenv, tf, max_steps=8, method=method, state_size=state_size,
        return_steps=True)
    gxs, galive = tev._rollout_general(tpop, tdata)
    assert_lanes_agree(xs, alive, gxs, galive)
    assert_lanes_agree(us, alive, tev._replay_controls(tpop, gxs, tdata), galive)
    assert steps.shape == alive.shape[1:] and int(steps.max()) <= 8 * (ts.shape[0] - 1)


# ------------------------------------------ (c) the host build of policy.cu

@pytest.fixture(scope="module")
def policy_host(tmp_path_factory):
    if shutil.which("g++") is None and shutil.which("c++") is None:
        pytest.skip("no host C++ compiler")
    lib = _build.build_host("policy", tmp_path_factory.mktemp("policy_host"))
    lib.policy_host.argtypes = [ctypes.c_int, ctypes.c_void_p]
    lib.policy_host.restype = ctypes.c_int
    return lib


def host_case(name, mode, state_size, seed=0, n=30, t_end=2.2):
    """A torch-only case (the port's own generator), N = 30 with ``/``; at
    ``n > 32`` trees grown to depth 7 (``bench.py``'s deep setting), the
    first three candidates' trees chains of ``n - 1``, 127 and 63 rows (the
    deepest stacks)."""
    env = getattr(tenvs, name)()
    ops = [("+", 2), ("-", 2), ("*", 2), ("/", 2, 0.2), ("sin", 1), ("cos", 1)]
    ys = [f"y{i}" for i in range(env.n_obs)]
    tg = [f"tgt{i}" for i in range(env.n_targets)]
    if state_size:
        a, u = [f"a{i}" for i in range(state_size)], [f"u{i}" for i in range(env.n_control)]
        fset = build_function_set(ops, [ys + a + u + tg, a + tg], [state_size, env.n_control])
    else:
        fset = build_function_set(ops, [ys + tg], [env.n_control])
    g = torch.Generator().manual_seed(seed)
    data = generate_control_data(env, g, torch.arange(0.0, t_end, 0.2), batch_size=4, param_mode=mode)
    trees = make_population_sampler(fset, 4 if n <= 32 else 7, n)(g, 16)[0]
    if n > 32:
        trees = with_chains(trees, fset, [n - 1, min(127, n - 1), 63])
    return env, fset, data, trees


def noise_rows(env, ts, substeps, stages, seed=3):
    g = torch.Generator().manual_seed(seed)
    t_steps = ts.shape[0]
    obs = 0.1 * torch.randn((t_steps, 4, substeps * stages * env.n_obs), generator=g)
    kick = 0.05 * torch.randn((t_steps, 4, substeps * env.latent_size), generator=g)
    return obs, kick


HOST_FIXED = [("Acrobot", "Constant", 0, "rk4", ""), ("Acrobot", "Constant", 2, "rk4", ""),
              ("HarmonicOscillator", "Switch", 0, "heun", ""),
              ("ChangingHarmonicOscillator", "Decay", 1, "rk4", ""),
              ("Acrobot2", "Decay", 0, "rk4", ""), ("StirredTankReactor", "Different", 0, "rk4", ""),
              ("HarmonicOscillator2", "Constant", 2, "rk4", ""),
              ("CartPole", "Constant", 0, "euler", "obs+kicks"),
              ("Acrobot", "Constant", 1, "rk4", "obs")]
# the instances for N <= 256 (T = 6): static and dynamic, one and two
# control trees, chains of n - 1, 127 and 63 rows among the candidates
HOST_FIXED_DEEP = [("Acrobot", "Constant", 0, "rk4", "", 128), ("Acrobot", "Constant", 2, "rk4", "", 256),
                   ("Acrobot2", "Constant", 0, "rk4", "obs", 256),
                   ("CartPole", "Constant", 1, "euler", "obs+kicks", 128)]
case_id = lambda *values: "-".join(str(v) for v in values)


@pytest.mark.parametrize(
    "name,mode,state_size,method,noise,n",
    [pytest.param(*c, 30, id=case_id(*c)) for c in HOST_FIXED]
    + [pytest.param(*c, id=case_id(*c[:5], f"N{c[5]}")) for c in HOST_FIXED_DEEP])
def test_policy_host_build_bit_exact(policy_host, monkeypatch, name, mode, state_size, method,
                                     noise, n):
    env, fset, (x0, ts, tgt, _, _, par), trees = host_case(name, mode, state_size, n=n,
                                                           t_end=2.2 if n <= 32 else 1.2)
    obs, kick = noise_rows(env, ts, 2, len(cp.RK_TABLES[method][0]))
    rows = dict(obs_noise_rows=obs if "obs" in noise else None,
                process_noise_rows=kick if "kicks" in noise else None)
    with monkeypatch.context() as m:
        patch_host_math(m)
        xs, us, alive = cp.policy_rollout_plain(trees, x0, ts, tgt, par, env, fset, 2, method,
                                                state_size, **rows)
    status, hxs, hus, count, _ = cp.run_policy(
        lambda a: policy_host.policy_host(cp.FIXED, a), cp.FIXED, trees, x0, ts, tgt, par, env,
        fset, state_size, method, 2, **rows)
    assert status == 0
    assert same_bits(hxs, xs) and same_bits(hus, us)
    assert torch.equal(cp._alive_rows(count, ts.shape[0]), alive)


HOST_ADAPTIVE = [(name, state_size, method, 8, 30)
                 for name, state_size in [("Acrobot", 0), ("Acrobot", 2), ("CartPole", 0),
                                          ("HarmonicOscillator2", 1)]
                 for method in ("dopri5", "bosh3")]
# budgets that run out inside an interval (the flat loop closes it early)
HOST_ADAPTIVE_BUDGET = [("Acrobot", 0, "dopri5", 1, 30), ("Acrobot", 2, "bosh3", 2, 30),
                        ("HarmonicOscillator2", 1, "dopri5", 2, 30), ("CartPole", 0, "bosh3", 1, 30)]
# the instances for N <= 256 (T = 4), chains among the candidates
HOST_ADAPTIVE_DEEP = [("Acrobot", 0, "bosh3", 8, 128), ("Acrobot", 0, "dopri5", 8, 256),
                      ("Acrobot", 2, "dopri5", 8, 128), ("Acrobot", 2, "bosh3", 8, 256)]


@pytest.mark.parametrize(
    "name,state_size,method,max_steps,n",
    [pytest.param(*c, id=case_id(*c[:3])) for c in HOST_ADAPTIVE]
    + [pytest.param(*c, id=case_id(*c[:3], f"max_steps{c[3]}")) for c in HOST_ADAPTIVE_BUDGET]
    + [pytest.param(*c, id=case_id(*c[:3], f"N{c[4]}")) for c in HOST_ADAPTIVE_DEEP])
def test_policy_adaptive_host_build_bit_exact(policy_host, monkeypatch, name, state_size, method,
                                              max_steps, n):
    env, fset, (x0, ts, tgt, _, _, par), trees = host_case(name, "Constant", state_size, n=n,
                                                           t_end=2.2 if n <= 32 else 0.8)
    with monkeypatch.context() as m:
        patch_host_math(m)
        xs, us, alive, steps = cp.policy_rollout_adaptive_plain(
            trees, x0, ts, tgt, par, env, fset, 1e-4, 1e-4, max_steps, method, 0.9, state_size)
    status, hxs, hus, count, hsteps = cp.run_policy(
        lambda a: policy_host.policy_host(cp.ADAPTIVE, a), cp.ADAPTIVE, trees, x0, ts, tgt, par,
        env, fset, state_size, method, max_steps=max_steps, rtol=1e-4, atol=1e-4, safety=0.9)
    assert status == 0
    assert same_bits(hxs, xs) and same_bits(hus, us) and torch.equal(hsteps, steps)
    assert torch.equal(cp._alive_rows(count, ts.shape[0]), alive) and bool((steps > 0).all())
    if max_steps < 8:  # some lanes ran out of budget before the end of an interval
        assert bool((~alive[-1]).any())


@pytest.mark.parametrize("kind", [cp.FIXED, cp.ADAPTIVE])
def test_policy_host_build_without_the_swap(policy_host, kind):
    """With PyTorch's own CPU ``sin``/``cos``/``pow``/``sqrt``: identical
    alive on >= 99.5% of lanes, rel <= 1e-3 on lanes alive in both."""
    env, fset, (x0, ts, tgt, _, _, par), trees = host_case("Acrobot", "Constant", 0, seed=4)
    if kind == cp.FIXED:
        xs, _, alive = cp.policy_rollout_plain(trees, x0, ts, tgt, par, env, fset, 2, "rk4")
        kw = dict(method="rk4", substeps=2)
    else:
        xs, _, alive, _ = cp.policy_rollout_adaptive_plain(trees, x0, ts, tgt, par, env, fset,
                                                           max_steps=8)
        kw = dict(method="dopri5", max_steps=8, rtol=1e-4, atol=1e-4, safety=0.9)
    status, hxs, _, count, _ = cp.run_policy(lambda a: policy_host.policy_host(kind, a), kind,
                                             trees, x0, ts, tgt, par, env, fset, 0, **kw)
    assert status == 0
    assert_lanes_agree(hxs, cp._alive_rows(count, ts.shape[0]), xs, alive, share=0.995, tol=1e-3)


def test_policy_host_build_refuses_bad_arguments(policy_host, tmp_path):
    env, fset, (x0, ts, tgt, _, _, par), trees = host_case("Acrobot", "Constant", 0)
    launch = lambda kind: (lambda a: policy_host.policy_host(kind, a))
    with pytest.raises(ValueError):  # process noise needs euler
        cp.run_policy(launch(cp.FIXED), cp.FIXED, trees, x0, ts, tgt, par, env, fset, 0, "rk4", 2,
                      process_noise_rows=torch.zeros((ts.shape[0], 4, 8)))
    # state_size > 2: the fixed launcher refuses it, run_policy takes it to
    # the wide build (tests/test_torch_wide_policy.py holds its lanes)
    env3, fset3, (x03, ts3, tgt3, _, _, par3), trees3 = host_case("Acrobot", "Constant", 3)
    with pytest.raises(NotImplementedError):
        cp.run_policy(launch(cp.FIXED), cp.FIXED, trees3, x03, ts3, tgt3, par3, env3, fset3, 3)
    wide = _build.build_host("policy", tmp_path, _build.widened(False)).policy_wide_host
    wide.argtypes = [ctypes.c_int, ctypes.c_void_p, ctypes.c_void_p, ctypes.c_int, ctypes.c_int]
    status, xs, *_ = cp.run_policy(lambda a, *part: wide(cp.FIXED, a, *part), cp.FIXED, trees3, x03,
                                   ts3, tgt3, par3, env3, fset3, 3, wide=True)
    assert status == 0 and xs.shape[-1] == env3.latent_size + 3 and bool(torch.isfinite(xs[0]).all())
    with pytest.raises(ValueError):  # the adaptive kernel takes constant parameters
        series = tuple(p[:, None].expand(4, ts.shape[0]) for p in par)
        cp.run_policy(launch(cp.ADAPTIVE), cp.ADAPTIVE, trees, x0, ts, tgt, series, env, fset, 0,
                      "dopri5", max_steps=8)
    with pytest.raises(ValueError):  # the CUDA wrappers take CUDA tensors only
        cp.policy_rollout_cuda(trees, x0, ts, tgt, par, env, fset)


# ----------------------------------------------- (d) the noise legs vs JAX

@pytest.mark.parametrize("name,leg", [("HarmonicOscillator", "obs"), ("Acrobot", "obs"),
                                      ("HarmonicOscillator", "kicks")])
def test_noise_rows_match_jax_general_path(name, leg):
    kw = dict(obs_noise=0.1) if leg == "obs" else dict(process_noise=0.1)
    jenv, tenv, jf, tf, jdata, tdata, jpop, tpop = case(name, t_end=1.2, **kw)
    method = "rk4" if leg == "obs" else "euler"
    x0, ts, targets, pkeys, okeys, params = jdata
    jev = JaxStatic(jenv, jf, substeps=2, method=method, interpreter="gather",
                    stochastic=leg == "kicks")
    jxs, jal = jax.jit(jev._rollout_general)(jpop, jdata)
    if leg == "obs":
        rows = dict(obs_noise_rows=torch.from_numpy(np.array(
            make_obs_noise_rows(jenv, ts, params, okeys, 2, method))))
    else:
        rows = dict(process_noise_rows=torch.from_numpy(np.array(
            make_process_noise_rows(jenv, ts, params, pkeys, 2, jenv.latent_size))))
    tx0, tts, ttgt, _, _, tpar = tdata
    xs, _, alive = cp.policy_rollout_plain(tpop, tx0, tts, ttgt, tpar, tenv, tf, 2, method, 0,
                                           **rows)
    assert_lanes_agree(xs, alive, jxs, jal)
    assert np.abs(np.asarray(jxs)).max() > 0


# -------------------------------------- (e) the JAX kernel in interpret mode

def test_policy_plain_matches_jax_kernel_interpret():
    jenv, tenv, jf, tf, jdata, tdata, jpop, tpop = case("Acrobot", pop=8, t_end=1.0)
    x0, ts, targets, _, _, params = jdata
    with pltpu.force_tpu_interpret_mode():
        jxs, jus, jal = jax_policy.rollout_policy_pallas(
            jpop, x0, ts, targets, params, jenv, jf, substeps=2, method="rk4",
            stream_controls=True)
    tx0, tts, ttgt, _, _, tpar = tdata
    xs, us, alive = cp.policy_rollout_plain(tpop, tx0, tts, ttgt, tpar, tenv, tf, 2, "rk4")
    assert_lanes_agree(xs, alive, jxs, jal)
    assert_lanes_agree(us, alive, jus, jal)
