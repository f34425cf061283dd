"""PyTorch port: the tree kernels #1, #3, #4/#5, #6/#7 and #2 with user
operators (gplearn's protected set, ``test_torch_user_ops.GPLEARN``).

* the user host builds of ``sr_fitness.cu`` (#1), ``sr_rollout.cu`` (#3),
  ``sr_adaptive.cu`` (#5 global budget, #4 per interval) and ``policy.cu``
  (#6, #7), whose rows dispatch a device op id of ``USER_FROM`` or more to
  the generated code through ``tree_eval.cuh``, against their plain versions:
  bit for bit per lane, with the C library's ``expf``/``logf`` and a
  correctly rounded ``sqrt`` swapped into PyTorch (``patch_host_math``);
* #2 reads arities only: it takes an 8-operator user set unchanged, opcodes
  identical, constants within rtol 1e-6 as in ``test_torch_kernels``.

Tests that need the card carry the ``cuda`` marker: each user library against
its plain version, every lane bit for bit, and the launch counters. This file
imports no JAX.
"""
import ctypes
import shutil

import numpy as np
import pytest
import torch

from multitreegp_tpu_torch import _build
from multitreegp_tpu_torch.core import cuda_adaptive as ca
from multitreegp_tpu_torch.core import cuda_policy as cp
from multitreegp_tpu_torch.core import cuda_rollout as cr
from multitreegp_tpu_torch.core.cuda_reproduction import reproduce_lanes, reproduce_lanes_plain
from test_torch_kernels import fitness_host, patch_host_math, reproduce_case, reproduce_host, same_bits
from test_torch_operators import policy_case, sr_case
from test_torch_user_ops import GPLEARN, GPLEARN_OPS

torch.set_num_threads(1)

# the control workload's + - * sin cos with the protected division
POLICY_USER = [("+", 2), ("-", 2), ("*", 2), ("sin", 1), ("cos", 1), ("/", GPLEARN["/"][0], 2, 0.3),
               ("sig", GPLEARN["sig"][0], 1, 0.3)]


@pytest.fixture(scope="module")
def user_host(tmp_path_factory):
    if shutil.which("g++") is None and shutil.which("c++") is None:
        pytest.skip("no host C++ compiler")
    out = tmp_path_factory.mktemp("user_host")
    made = {}

    def get(name, fset):
        key = (name, fset.user_hash)
        assert fset.user_hash
        if key not in made:
            made[key] = _build.build_host(name, out, fset.variant)
        return made[key]

    return get


@pytest.mark.parametrize("method,n", [("rk4", 32), ("heun", 128)])
def test_fitness_host_build_bit_exact(user_host, monkeypatch, method, n):
    """#1 (``sr_fitness.cu``) through ``tree_prog.cuh``'s ``row_step``."""
    fset, trees, x0s, ts, ys = sr_case(n=n, depth=4 if n == 32 else 6, ops=GPLEARN_OPS)
    with monkeypatch.context() as m:
        patch_host_math(m)
        mse, alive = cr.sr_fitness_plain(trees, x0s, ts, ys, fset, method, 1)
    err, alive_h = fitness_host(user_host("sr_fitness", fset), trees, x0s, ts, ys, fset, method, 1)
    np.testing.assert_array_equal(alive_h, alive.numpy())
    np.testing.assert_array_equal(err, mse.numpy())
    assert alive.any()


def test_rollout_host_build_bit_exact(user_host, monkeypatch):
    """#3 (``sr_rollout.cu``), RK4 with 2 substeps."""
    fset, trees, x0s, ts, _ = sr_case(ops=GPLEARN_OPS)
    with monkeypatch.context() as m:
        patch_host_math(m)
        xs, alive = cr.sr_rollout_plain(trees, x0s, ts, fset, "rk4", 2)
    p, d, n = trees.ops.shape
    b, t_steps = x0s.shape[0], ts.shape[0]
    out = np.zeros((t_steps, p, b, d), np.float32)
    alive_h = np.zeros((p, b), np.uint8)
    h, h_final = cr.rollout_step(ts, "rk4", 2)
    fn = user_host("sr_rollout", fset).sr_rollout_host
    fn.argtypes = [ctypes.c_void_p] * 6 + [ctypes.c_int] * 9 + [ctypes.c_float] * 3
    arrays = [np.ascontiguousarray(a.numpy()) for a in (trees.ops, trees.const, fset.device_ops(), x0s)]
    assert fn(*(a.ctypes.data for a in arrays), out.ctypes.data, alive_h.ctypes.data, p, d, n, b,
              t_steps, fset.var_start, fset.has_unary, cr.METHODS["rk4"], 2,
              np.float32(h * 0.5), np.float32(h), h_final) == 0
    np.testing.assert_array_equal(alive_h.astype(bool), alive[-1].numpy())
    np.testing.assert_array_equal(out, xs.numpy())
    assert alive[-1].any()


@pytest.mark.parametrize("kind,budget", [(ca.GLOBAL, 40), (ca.INTERVAL, 8)])
def test_adaptive_host_build_bit_exact(user_host, monkeypatch, kind, budget):
    """#5 (global budget) and #4 (per interval), dopri5."""
    fset, trees, x0s, ts, ys = sr_case(pop=16, t_end=1.0, ops=GPLEARN_OPS)
    plain = ca.sr_fitness_adaptive_global_plain if kind == ca.GLOBAL else ca.sr_fitness_adaptive_interval_plain
    with monkeypatch.context() as m:
        patch_host_math(m)
        mse, alive, steps = plain(trees, x0s, ts, ys, fset, 1e-4, 1e-6, budget, "dopri5")
    p, b = trees.ops.shape[0], x0s.shape[0]
    err = np.zeros((p, b), np.float32)
    alive_h = np.zeros((p, b), np.uint8)
    steps_h = np.zeros((p, b), np.int32)
    arrays = [np.ascontiguousarray(a.numpy()) for a in (trees.ops, trees.const, fset.device_ops(),
                                                        x0s, ts, ys)]
    fn = user_host("sr_adaptive", fset).sr_adaptive_host
    fn.argtypes = [ctypes.c_int] + [ctypes.c_void_p] * 9 + [ctypes.c_int] * 9 + [ctypes.c_float] * 3
    assert fn(kind, *(a.ctypes.data for a in arrays), err.ctypes.data, alive_h.ctypes.data,
              steps_h.ctypes.data, p, x0s.shape[1], trees.ops.shape[-1], b, ts.shape[0],
              fset.var_start, fset.has_unary, ca.METHODS["dopri5"], budget, 1e-4, 1e-6, 0.9) == 0
    np.testing.assert_array_equal(alive_h.astype(bool), alive.numpy())
    np.testing.assert_array_equal(steps_h, steps.numpy())
    assert same_bits(torch.from_numpy(err / np.float32(ts.shape[0])), mse)
    assert alive.any()


@pytest.fixture(scope="module")
def policy_user(user_host):
    _, fset, _, _ = policy_case(0, ops=POLICY_USER)
    lib = user_host("policy", fset)
    lib.policy_host.argtypes = [ctypes.c_int, ctypes.c_void_p]
    lib.policy_host.restype = ctypes.c_int
    return lib


@pytest.mark.parametrize("state_size", [0, 2])
def test_policy_host_build_bit_exact(policy_user, monkeypatch, state_size):
    """#6 (RK4 x 2) on Acrobot policies with the protected division and the
    sigmoid beside ``+ - * sin cos``."""
    env, fset, (x0, ts, tgt, _, _, par), trees = policy_case(state_size, ops=POLICY_USER)
    with monkeypatch.context() as m:
        patch_host_math(m)
        xs, us, alive = cp.policy_rollout_plain(trees, x0, ts, tgt, par, env, fset, 2, "rk4",
                                                state_size)
    status, hxs, hus, count, _ = cp.run_policy(
        lambda a: policy_user.policy_host(cp.FIXED, a), cp.FIXED, trees, x0, ts, tgt, par, env,
        fset, state_size, "rk4", 2)
    assert status == 0
    assert same_bits(hxs, xs) and same_bits(hus, us)
    assert torch.equal(cp._alive_rows(count, ts.shape[0]), alive)


def test_policy_adaptive_host_build_bit_exact(policy_user, monkeypatch):
    """#7 (dopri5, 8 steps per interval), static."""
    env, fset, (x0, ts, tgt, _, _, par), trees = policy_case(0, t_end=1.2, ops=POLICY_USER)
    with monkeypatch.context() as m:
        patch_host_math(m)
        xs, us, alive, steps = cp.policy_rollout_adaptive_plain(
            trees, x0, ts, tgt, par, env, fset, 1e-4, 1e-4, 8, "dopri5", 0.9, 0)
    status, hxs, hus, count, hsteps = cp.run_policy(
        lambda a: policy_user.policy_host(cp.ADAPTIVE, a), cp.ADAPTIVE, trees, x0, ts, tgt, par,
        env, fset, 0, "dopri5", max_steps=8, rtol=1e-4, atol=1e-4, safety=0.9)
    assert status == 0
    assert same_bits(hxs, xs) and same_bits(hus, us) and torch.equal(hsteps, steps)
    assert torch.equal(cp._alive_rows(count, ts.shape[0]), alive)


def test_reproduce_host_build_takes_the_user_set(tmp_path):
    """#2 (tree surgery: arities and probabilities) with the 8 operators of
    the gplearn set, 5 of them user operators."""
    cfg, args = reproduce_case(ops=GPLEARN_OPS)
    assert cfg.num_operators == 8
    ref = reproduce_lanes_plain(*args, cfg)
    status, outs = reproduce_host(_build.build_host("reproduce", tmp_path), args, cfg)
    assert status == 0
    np.testing.assert_array_equal(outs[0], ref[0].numpy())
    np.testing.assert_array_equal(outs[2], ref[2].numpy())
    np.testing.assert_allclose(outs[1], ref[1].numpy(), rtol=1e-6, atol=0)
    np.testing.assert_allclose(outs[3], ref[3].numpy(), rtol=1e-6, atol=0)


# ------------------------------------------------------------------ the card

@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU (CUDA kernels have no CPU mode)")
    return torch.device("cuda")


@pytest.mark.cuda
def test_tree_kernels_match_plain_on_card(cuda):
    """#1, #3, #5 and #4 on 256 candidates of the gplearn set x 16
    trajectories; #6 and #7 on Acrobot policies with the protected division
    and the sigmoid: every lane bit for bit, launch counters."""
    fset, trees, x0s, ts, ys = sr_case(pop=256, b=16, t_end=2.0, seed=4, ops=GPLEARN_OPS)
    to = lambda t: t.to(cuda)
    trees, x0s, ts, ys = trees.map(to), to(x0s), to(ts), to(ys)
    before = cr.sr_fitness_cuda.launches
    mse, alive = cr.sr_fitness(trees, x0s, ts, ys, fset, "rk4", 1)
    ref, ref_alive = cr.sr_fitness_plain(trees, x0s, ts, ys, fset, "rk4", 1)
    xs, xs_alive = cr.sr_rollout(trees, x0s, ts, fset, "rk4", 1)
    ref_xs, ref_xs_alive = cr.sr_rollout_plain(trees, x0s, ts, fset, "rk4", 1)
    torch.cuda.synchronize()
    assert cr.sr_fitness_cuda.launches == before + 1
    assert torch.equal(alive, ref_alive) and same_bits(mse, ref) and alive.any()
    assert torch.equal(xs_alive, ref_xs_alive) and same_bits(xs, ref_xs)
    short = ts[:5], ys[:, :5].contiguous()
    for fn, plain, budget in ((ca.sr_fitness_adaptive_global_cuda, ca.sr_fitness_adaptive_global_plain, 40),
                              (ca.sr_fitness_adaptive_interval_cuda,
                               ca.sr_fitness_adaptive_interval_plain, 8)):
        got = fn(trees, x0s, *short, fset, 1e-4, 1e-6, budget, "dopri5")
        want = plain(trees, x0s, *short, fset, 1e-4, 1e-6, budget, "dopri5")
        torch.cuda.synchronize()
        assert same_bits(got[0], want[0]) and torch.equal(got[1], want[1])
        assert torch.equal(got[2], want[2])
    for state_size in (0, 2):
        env, pf, (x0, pts, tgt, _, _, par), pol = policy_case(state_size, cuda, pop=64, b=16,
                                                               ops=POLICY_USER)
        before = cp.policy_rollout_cuda.launches
        got = cp.rollout_policy(pol, x0, pts, tgt, par, env, pf, 2, "rk4", state_size)
        want = cp.policy_rollout_plain(pol, x0, pts, tgt, par, env, pf, 2, "rk4", state_size)
        torch.cuda.synchronize()
        assert cp.policy_rollout_cuda.launches == before + 1
        assert same_bits(got[0], want[0]) and same_bits(got[1], want[1])
        assert torch.equal(got[2], want[2])
    env, pf, (x0, pts, tgt, _, _, par), pol = policy_case(0, cuda, pop=64, b=16, t_end=1.2,
                                                          ops=POLICY_USER)
    got = cp.policy_rollout_adaptive_cuda(pol, x0, pts, tgt, par, env, pf, max_steps=8)
    want = cp.policy_rollout_adaptive_plain(pol, x0, pts, tgt, par, env, pf, 1e-4, 1e-4, 8)
    torch.cuda.synchronize()
    assert all(same_bits(a, b) for a, b in zip(got[:2], want[:2]))
    assert torch.equal(got[2], want[2]) and torch.equal(got[3], want[3])
    assert all(any(k.startswith(f"{lib}_u") for k in _build._loaded)
               for lib in ("sr_fitness", "sr_rollout", "sr_adaptive", "policy"))


@pytest.mark.cuda
def test_reproduce_kernel_takes_the_user_set_on_card(cuda):
    cfg, args = reproduce_case(cuda, lanes=1024, ops=GPLEARN_OPS)
    out = reproduce_lanes(*args, cfg)
    ref = reproduce_lanes_plain(*args, cfg)
    torch.cuda.synchronize()
    assert torch.equal(out[0], ref[0]) and torch.equal(out[2], ref[2])
    torch.testing.assert_close(out[1], ref[1], rtol=1e-6, atol=0)
    torch.testing.assert_close(out[3], ref[3], rtol=1e-6, atol=0)
