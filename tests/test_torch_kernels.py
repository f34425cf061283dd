"""PyTorch port: the CUDA kernels against their plain versions.

Two routes:

* host build (runs here): each ``csrc/*.cu`` also compiles for the host
  with the system C++ compiler (``-ffp-contract=off``), where its per-lane
  code runs as a plain lane loop. The fitness lanes must equal the plain
  version bit for bit (same float32 operations in the same order, no FMA);
  the reproduction lanes must give identical opcodes and constants within
  rtol 1e-6 (the host's ``logf``/``cosf`` and PyTorch's may round an ulp
  apart).
* on the card (marker ``cuda``; skipped without a GPU): the kernels through
  their wrappers, same criteria; the interpreter kernels (forward and VJP)
  through ``evaluate_trees`` and autograd, bit for bit per lane against the
  plain version on the card; the adaptive kernels (#5 global budget, #4 per
  interval) and the trajectory kernel (#3) against their plain versions,
  bit for bit per lane (the card's ``powf`` and ``sqrtf`` are PyTorch's), and
  their dispatchers' launch counters and refusals. This file imports no JAX,
  so it also runs where the card is (``pytest --noconftest``).

The host-build checks of the interpreter, adaptive and trajectory kernels are
in ``test_torch_interpreter_kernel.py``, ``test_torch_adaptive.py`` and
``test_torch_rollout_kernel.py``.
"""
import ctypes
import shutil

import numpy as np
import pytest
import torch

from multitreegp_tpu_torch import _build
from multitreegp_tpu_torch.core import tile_surgery as tts
from multitreegp_tpu_torch.core.cuda_reproduction import (
    decay_table, reproduce_lanes, reproduce_lanes_plain, rows_per_lane,
)
from multitreegp_tpu_torch.core import cuda_adaptive as ca
from multitreegp_tpu_torch.core import cuda_interpreter as ci
from multitreegp_tpu_torch.core import cuda_rollout as cro
from multitreegp_tpu_torch.core.cuda_rollout import (
    METHODS, SRFitness, sr_fitness, sr_fitness_cuda, sr_fitness_plain,
)
from multitreegp_tpu_torch.core.interpreter import (
    evaluate_trees, evaluate_trees_plain, evaluate_trees_vjp_plain,
)
from multitreegp_tpu_torch.core.registry import build_function_set
from multitreegp_tpu_torch.models.environments import VanDerPolOscillator
from multitreegp_tpu_torch.models.evaluators import generate_sr_data
from multitreegp_tpu_torch.ops.initialization import make_population_sampler

torch.set_num_threads(1)

N = 32
ARITH = [("+", 2, 0.5), ("-", 2, 0.1), ("*", 2, 0.5), ("/", 2, 0.1)]
INTERP_OPS = [("+", 2, 0.5), ("-", 2, 0.1), ("*", 2, 0.5), ("/", 2, 0.4)]


def fitness_case(device="cpu", pop=24, b=4, t_end=1.6):
    fset = build_function_set(ARITH, [["x0", "x1"]], [2])
    g = torch.Generator(device=device).manual_seed(0)
    ts = torch.arange(0.0, t_end, 0.2, device=device)
    x0s, ts, ys, _ = generate_sr_data(VanDerPolOscillator(), g, ts, batch_size=b)
    trees = make_population_sampler(fset, 4, N)(g, pop)[0]
    return fset, trees, x0s, ts, ys


def reproduce_case(device="cpu", lanes=192):
    fset = build_function_set(ARITH + [("sin", 1, 0.3)], [["x0", "x1"], ["x1"]], [1, 1])
    cfg = tts.make_config(fset, N, 4)
    g = torch.Generator(device=device).manual_seed(1)
    sample = lambda depth, k: make_population_sampler(fset, depth, N)(g, k)[0].map(
        lambda a: a.reshape(-1, N))
    parents = [sample(d, lanes // 8) for d in (1, 2, 4, 5)]  # 2 trees per candidate
    ops = torch.cat([p.ops for p in parents]).T.contiguous()
    const = torch.cat([p.const for p in parents]).T.contiguous()
    lane = torch.arange(lanes, device=device)
    cx = lane % 4 == 0
    act1 = torch.where(cx, 0, (lane // 4) % 3).to(torch.int32)
    act2 = torch.where(cx, 0, (lane // 12) % 3).to(torch.int32)
    vmask = torch.stack([torch.ones(lanes, device=device), (lane % 2 == 0).float()])
    u = torch.rand((rows_per_lane(cfg), lanes), generator=g, device=device)
    args = (ops, const, ops.roll(1, dims=1).contiguous(), const.roll(1, dims=1).contiguous(),
            cx, act1, act2, vmask, u)
    return cfg, args


def lanes_case(device="cpu", k=48, b=3, n=32, depth=5, seed=0, near_zero=True):
    """Trees ``(k, 2, n)`` and states ``(k, b, 2, 2)``, all made from
    ``seed``; with ``near_zero``, every third candidate's constants are near
    or at 0, so ``/`` makes huge, inf and NaN lanes."""
    fset = build_function_set(INTERP_OPS, [["x0", "x1"]], [2])
    g = torch.Generator(device=device).manual_seed(seed)
    pop = make_population_sampler(fset, depth, n)(g, k)[0]
    rng = np.random.default_rng(seed)
    small = rng.normal(size=pop.const.shape).astype(np.float32) * 1e-3
    small[rng.random(pop.const.shape) < 0.1] = 0.0
    every_third = torch.arange(k, device=device) % 3 == 0
    const = torch.where((pop.ops == 1) & every_third[:, None, None] & near_zero,
                        torch.from_numpy(small).to(device), pop.const)
    data = torch.from_numpy(rng.normal(size=(k, b, 2, 2)).astype(np.float32) * 2).to(device)
    g_out = torch.from_numpy(rng.normal(size=(k, b, 2)).astype(np.float32)).to(device)
    return fset, pop._replace(const=const), data, g_out


def same_bits(a: torch.Tensor, b: torch.Tensor) -> bool:
    """Equal values, NaN where the other has NaN."""
    nan = torch.isnan(a)
    return torch.equal(nan, torch.isnan(b)) and torch.equal(a[~nan], b[~nan])


@pytest.fixture(scope="module")
def host_libs(tmp_path_factory):
    if shutil.which("g++") is None and shutil.which("c++") is None:
        pytest.skip("no host C++ compiler")
    out = tmp_path_factory.mktemp("host_kernels")
    return {name: _build.build_host(name, out) for name in ("sr_fitness", "reproduce")}


@pytest.mark.parametrize("method,substeps", [("euler", 2), ("heun", 1), ("rk4", 1), ("rk4", 3)])
def test_fitness_host_build_bit_exact(host_libs, method, substeps):
    fset, trees, x0s, ts, ys = fitness_case()
    mse, alive = sr_fitness_plain(trees, x0s, ts, ys, fset, method, substeps)
    p, b = mse.shape
    err = np.zeros((p, b), np.float32)
    alive_h = np.zeros((p, b), np.uint8)
    fn = host_libs["sr_fitness"].sr_fitness_host
    fn.argtypes = [ctypes.c_void_p] * 8 + [ctypes.c_int] * 8
    arrays = [np.ascontiguousarray(a.numpy()) for a in (trees.ops, trees.const, fset.device_ops(),
                                                        x0s, ts, ys)]
    status = fn(*(a.ctypes.data for a in arrays), err.ctypes.data, alive_h.ctypes.data,
                p, 2, N, b, ts.shape[0], fset.var_start, METHODS[method], substeps)
    assert status == 0
    np.testing.assert_array_equal(alive_h.astype(bool), alive.numpy())
    np.testing.assert_array_equal(err / np.float32(ts.shape[0]), mse.numpy())
    assert (~alive.numpy()).any() and alive.numpy().any()


def test_reproduce_host_build_matches_plain(host_libs):
    cfg, args = reproduce_case()
    ref = reproduce_lanes_plain(*args, cfg)
    n, lanes = args[0].shape
    outs = [np.zeros((n, lanes), dt) for dt in (np.int32, np.float32, np.int32, np.float32)]
    ins = [np.ascontiguousarray(a.numpy().astype(np.uint8) if a.dtype == torch.bool else a.numpy())
           for a in args]
    tables = [np.asarray(cfg.slots, np.int32), np.asarray(cfg.operator_probs, np.float32),
              decay_table(cfg).numpy()]
    fn = host_libs["reproduce"].reproduce_host
    fn.argtypes = [ctypes.c_void_p] * 16 + [ctypes.c_int] * 8 + [ctypes.c_float, ctypes.c_int]
    status = fn(*(a.ctypes.data for a in ins + outs + tables), lanes, n, cfg.num_vars,
                cfg.num_operators, cfg.var_start, cfg.max_init_depth, cfg.cx_retries,
                cfg.mut_retries, cfg.coefficient_sd, args[-1].shape[0])
    assert status == 0
    np.testing.assert_array_equal(outs[0], ref[0].numpy())
    np.testing.assert_array_equal(outs[2], ref[2].numpy())
    np.testing.assert_allclose(outs[1], ref[1].numpy(), rtol=1e-6, atol=0)
    np.testing.assert_allclose(outs[3], ref[3].numpy(), rtol=1e-6, atol=0)
    # a wrong row count is refused
    assert fn(*(a.ctypes.data for a in ins + outs + tables), lanes, n, cfg.num_vars,
              cfg.num_operators, cfg.var_start, cfg.max_init_depth, cfg.cx_retries,
              cfg.mut_retries, cfg.coefficient_sd, args[-1].shape[0] - 1) != 0


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU (CUDA kernels have no CPU mode)")
    return torch.device("cuda")


@pytest.mark.cuda
def test_fitness_kernel_matches_plain_on_card(cuda):
    fset, trees, x0s, ts, ys = fitness_case(cuda, pop=512, b=16, t_end=2.0)
    before = sr_fitness_cuda.launches
    mse, alive = sr_fitness(trees, x0s, ts, ys, fset, "rk4", 1)
    ref, ref_alive = sr_fitness_plain(trees, x0s, ts, ys, fset, "rk4", 1)
    torch.cuda.synchronize()
    assert sr_fitness_cuda.launches == before + 1
    assert torch.equal(alive, ref_alive)
    both = alive & ref_alive
    rel = ((mse - ref).abs() / ref.abs().clamp(min=1e-30))[both]
    assert float(rel.max()) <= 1e-6


@pytest.mark.cuda
def test_reproduce_kernel_matches_plain_on_card(cuda):
    cfg, args = reproduce_case(cuda, lanes=1024)
    out = reproduce_lanes(*args, cfg)
    ref = reproduce_lanes_plain(*args, cfg)
    torch.cuda.synchronize()
    assert torch.equal(out[0], ref[0]) and torch.equal(out[2], ref[2])
    torch.testing.assert_close(out[1], ref[1], rtol=1e-6, atol=0)
    torch.testing.assert_close(out[3], ref[3], rtol=1e-6, atol=0)


@pytest.mark.cuda
def test_interpreter_kernels_match_plain_on_card(cuda):
    fset, pop, data, g = lanes_case(cuda, k=256, b=16)
    k, b = data.shape[:2]
    full = pop.map(lambda a: a[:, None].expand(k, b, 2, 32))
    fwd0, bwd0 = ci.evaluate_trees_cuda.launches, ci.evaluate_trees_vjp_cuda.launches
    const = full.const.contiguous().requires_grad_(True)
    x = data.clone().requires_grad_(True)
    out = evaluate_trees(full._replace(const=const), x, fset)
    dconst, ddata = torch.autograd.grad(out, (const, x), g)
    torch.cuda.synchronize()
    assert ci.evaluate_trees_cuda.launches == fwd0 + 1
    assert ci.evaluate_trees_vjp_cuda.launches == bwd0 + 1
    assert same_bits(out, evaluate_trees_plain(full, data, fset))
    ref_c, ref_d = evaluate_trees_vjp_plain(full._replace(const=const.detach()), data, g, fset)
    assert same_bits(dconst, ref_c) and same_bits(ddata, ref_d)
    with pytest.raises(NotImplementedError):
        evaluate_trees(full, data, build_function_set(INTERP_OPS + [("sin", 1, 0.1)], [["x0", "x1"]], [2]))


@pytest.mark.cuda
def test_fitness_gradient_through_kernels_on_card(cuda):
    """``SRFitness`` on the card (kernel #1 forward; the recompute through
    kernels #8 and #9 backward) against the same Function on CPU copies (the
    plain versions): the MSE rtol 1e-6 (the wrapper's division by T rounds
    by the reciprocal on the card), ``dconst`` rtol 1e-5 (the kernels'
    per-lane cotangents are summed over B in another order)."""
    fset, trees, x0s, ts, ys = fitness_case(cuda, pop=64, b=4, t_end=1.0)

    def grad(device):
        t = trees.map(lambda a: a.to(device))
        const = t.const.clone().requires_grad_(True)
        mse, alive = SRFitness.apply(t.ops, t.c1, t.c2, const, x0s.to(device), ts.to(device),
                                     ys.to(device), fset, "rk4", 1)
        (d,) = torch.autograd.grad(torch.where(alive, mse, 0.0).sum(), (const,))
        return mse.detach().cpu(), alive.cpu(), d.cpu()

    fwd0, bwd0 = ci.evaluate_trees_cuda.launches, ci.evaluate_trees_vjp_cuda.launches
    mse, alive, got = grad(cuda)
    torch.cuda.synchronize()
    drift_calls = 4 * (ts.shape[0] - 1)
    assert ci.evaluate_trees_cuda.launches == fwd0 + drift_calls
    assert ci.evaluate_trees_vjp_cuda.launches == bwd0 + drift_calls
    ref_mse, ref_alive, want = grad("cpu")
    assert torch.equal(alive, ref_alive)
    torch.testing.assert_close(mse, ref_mse, rtol=1e-6, atol=0, equal_nan=True)
    fin = torch.isfinite(want)
    assert torch.equal(torch.isfinite(got), fin) and bool((want[fin] != 0).any())
    torch.testing.assert_close(got[fin], want[fin], rtol=1e-5, atol=1e-6 * float(want[fin].abs().max()))


@pytest.mark.cuda
@pytest.mark.parametrize("method", ["bosh3", "dopri5"])
def test_adaptive_kernels_match_plain_on_card(cuda, method):
    """#5 through ``sr_fitness_adaptive_global`` and #4 through
    ``adaptive_solver_stats``: one launch each, every lane's error sum, alive
    and attempted steps equal to the plain version on the card."""
    fset, trees, x0s, ts, ys = fitness_case(cuda, pop=256, b=16, t_end=2.0)
    runs = (
        (ca.sr_fitness_adaptive_global_cuda, ca.sr_fitness_adaptive_global_plain,
         lambda: ca.sr_fitness_adaptive_global(trees, x0s, ts, ys, fset, budget=200, method=method,
                                               return_steps=True), 200),
        (ca.sr_fitness_adaptive_interval_cuda, ca.sr_fitness_adaptive_interval_plain,
         lambda: ca.adaptive_solver_stats(trees, x0s, ts, ys, fset, max_steps=16, method=method), 16),
    )
    for kernel, plain, run, budget in runs:
        before = kernel.launches
        mse, alive, steps = run()
        ref, ref_alive, ref_steps = plain(trees, x0s, ts, ys, fset, 1e-4, 1e-6, budget, method)
        torch.cuda.synchronize()
        assert kernel.launches == before + 1
        assert torch.equal(alive, ref_alive) and torch.equal(steps, ref_steps)
        assert same_bits(mse, ref) and alive.any() and (~alive).any()
    with pytest.raises(NotImplementedError):  # an operator the kernels lack
        sin_set = build_function_set(ARITH + [("sin", 1, 0.1)], [["x0", "x1"]], [2])
        ca.sr_fitness_adaptive(trees, x0s, ts, ys, sin_set)
    with pytest.raises(NotImplementedError):  # N > 256
        wide = trees.map(lambda a: torch.cat([a, a[..., :1].expand(*a.shape[:-1], 240)], -1))
        ca.sr_fitness_adaptive_global(wide, x0s, ts, ys, fset)


@pytest.mark.cuda
@pytest.mark.parametrize("method,substeps", [("euler", 2), ("heun", 1), ("rk4", 1)])
def test_rollout_kernel_matches_plain_on_card(cuda, method, substeps):
    fset, trees, x0s, ts, ys = fitness_case(cuda, pop=512, b=16, t_end=2.0)
    before = cro.sr_rollout_cuda.launches
    xs, alive = cro.sr_rollout(trees, x0s, ts, fset, method, substeps)
    ref, ref_alive = cro.sr_rollout_plain(trees, x0s, ts, fset, method, substeps)
    torch.cuda.synchronize()
    assert cro.sr_rollout_cuda.launches == before + 1
    assert torch.equal(alive, ref_alive) and same_bits(xs, ref)
