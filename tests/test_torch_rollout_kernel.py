"""PyTorch port: the trajectory-writing rollout (TPU kernel #3) and the
kernel build's source hashing (CPU).

* host build of ``csrc/sr_rollout.cu`` (``g++ -ffp-contract=off``) against
  ``sr_rollout_plain``: every state and the liveness bit for bit (the same
  float32 operations in the same order; no pow or sqrt here).
* ``sr_rollout_plain`` against JAX's ``integrate`` on the same arange grid:
  rtol 1e-5 (+ atol 1e-6) on live lanes, liveness identical. The kernel
  takes one step size ``(ts[1] - ts[0]) / substeps`` for the whole grid,
  ``integrate`` one per interval; on an arange grid they differ by ulps, and
  XLA:CPU contracts the updates into FMAs. Division is left out of the trees
  (a near-singular ``/`` amplifies ulps past any tight bound), as in
  ``test_torch_integrators.py``.
* ``SREvaluator.evaluate_candidate`` and ``__call__`` (which now go through
  the trajectory kernel's dispatcher) against the JAX evaluator's: rtol 1e-4.
* ``_build.library_path`` hashes the headers a source includes; a thread
  that asks ``_build.build`` for a library another thread is building
  waits for it (one ``nvcc``, a stand-in script here).

The card checks are in ``test_torch_kernels.py`` (marker ``cuda``).
"""
import ctypes
import shutil
import threading
import time

import jax
import jax.numpy as jnp
import jax.random as jr
import numpy as np
import pytest
import torch

from multitreegp_tpu.core.interpreter import evaluate_trees as jax_evaluate
from multitreegp_tpu.core.registry import build_function_set as jax_function_set
from multitreegp_tpu.models.environments import VanDerPolOscillator as JaxVdP
from multitreegp_tpu.models.evaluators import SREvaluator as JaxSREvaluator
from multitreegp_tpu.models.evaluators import generate_sr_data as jax_generate
from multitreegp_tpu.models.integrators import integrate as jax_integrate
from multitreegp_tpu.ops.initialization import make_population_sampler as jax_sampler
from multitreegp_tpu_torch import _build
from multitreegp_tpu_torch.convert import function_set_from_jax, sr_data_from_numpy, trees_from_numpy
from multitreegp_tpu_torch.core import cuda_rollout as cr
from multitreegp_tpu_torch.core.interpreter import evaluate_trees
from multitreegp_tpu_torch.core.registry import build_function_set
from multitreegp_tpu_torch.models.environments import VanDerPolOscillator
from multitreegp_tpu_torch.models.evaluators import SREvaluator, generate_sr_data
from multitreegp_tpu_torch.models.evaluators import sr as sr_module
from multitreegp_tpu_torch.models.integrators import integrate
from multitreegp_tpu_torch.ops.initialization import make_population_sampler
from test_torch_kernels import TRIG, fitness_case, patch_host_math, with_chains

torch.set_num_threads(1)

ARITH = [("+", 2, 0.5), ("-", 2, 0.1), ("*", 2, 0.5), ("/", 2, 0.1)]
JAX_OPS = [("+", jnp.add, 2, 0.5), ("-", jnp.subtract, 2, 0.1), ("*", jnp.multiply, 2, 0.5)]
CASES = [("euler", 1), ("euler", 2), ("heun", 1), ("heun", 2), ("rk4", 1), ("rk4", 2)]


@pytest.fixture(scope="module")
def rollout_host(tmp_path_factory):
    if shutil.which("g++") is None and shutil.which("c++") is None:
        pytest.skip("no host C++ compiler")
    return _build.build_host("sr_rollout", tmp_path_factory.mktemp("rollout_host"))


def rollout_case(ops=ARITH):
    fset = build_function_set(ops, [["x0", "x1"]], [2])
    g = torch.Generator().manual_seed(0)
    x0s, ts, _, _ = generate_sr_data(VanDerPolOscillator(), g, torch.arange(0.0, 1.6, 0.2), batch_size=4)
    return fset, x0s, ts, make_population_sampler(fset, 4, 32)(g, 24)[0]


def rollout_host_run(lib, trees, x0s, ts, fset, method, substeps):
    """The host build's ``(xs (T, P, B, d), alive (P, B))``."""
    p, d, n = trees.ops.shape
    b, t_steps = x0s.shape[0], ts.shape[0]
    out = np.zeros((t_steps, p, b, d), np.float32)
    alive = np.zeros((p, b), np.uint8)
    h, h_final = cr.rollout_step(ts, method, substeps)
    fn = lib.sr_rollout_host
    fn.argtypes = [ctypes.c_void_p] * 6 + [ctypes.c_int] * 9 + [ctypes.c_float] * 3
    arrays = [np.ascontiguousarray(a.numpy()) for a in (trees.ops, trees.const, fset.device_ops(), x0s)]
    assert fn(*(a.ctypes.data for a in arrays), out.ctypes.data, alive.ctypes.data, p, d, n, b,
              t_steps, fset.var_start, fset.has_unary, cr.METHODS[method], substeps,
              np.float32(h * 0.5), np.float32(h), h_final) == 0
    return out, alive.astype(bool)


@pytest.mark.parametrize("method,substeps", CASES)
def test_rollout_host_build_bit_exact(rollout_host, method, substeps):
    fset, x0s, ts, trees = rollout_case()
    xs, alive = cr.sr_rollout_plain(trees, x0s, ts, fset, method, substeps)
    out, alive_h = rollout_host_run(rollout_host, trees, x0s, ts, fset, method, substeps)
    np.testing.assert_array_equal(alive_h, alive[-1].numpy())
    np.testing.assert_array_equal(out, xs.numpy())  # NaN == NaN for assert_array_equal
    assert alive[-1].any() and (~alive[-1]).any()
    assert torch.equal(alive, alive[-1:].expand_as(alive))


def test_rollout_host_build_trig_bit_exact(rollout_host, monkeypatch):
    """Kernel #3 with ``sin``/``cos`` rows, RK4 with 2 substeps: bit for bit
    with the host's ``sinf``/``cosf`` in the plain version."""
    fset, x0s, ts, trees = rollout_case(ARITH + TRIG)
    with monkeypatch.context() as m:
        patch_host_math(m)
        xs, alive = cr.sr_rollout_plain(trees, x0s, ts, fset, "rk4", 2)
    out, alive_h = rollout_host_run(rollout_host, trees, x0s, ts, fset, "rk4", 2)
    np.testing.assert_array_equal(alive_h, alive[-1].numpy())
    np.testing.assert_array_equal(out, xs.numpy())
    assert alive[-1].any()


@pytest.mark.parametrize("method,substeps", [("rk4", 2), ("heun", 1)])
@pytest.mark.parametrize("trig", [False, True], ids=["arith", "trig"])
@pytest.mark.parametrize("n,depth", [(32, 4), (64, 5), (256, 7)])
def test_rollout_host_build_decoded_instances_bit_exact(rollout_host, monkeypatch, n, depth, trig,
                                                        method, substeps):
    """Kernel #3's decoded instances (trees of N <= 32 rows, and of N <= 256,
    which N = 64 takes too), with and without the unary rows' code: the
    first three candidates are chains of n - 1, 127 and 63 rows (the
    deepest stacks a tree of that many rows can hold), the rest grown to
    ``depth``; every state and liveness bit equal to the plain version's."""
    ops = ARITH + TRIG if trig else ARITH
    fset, trees, x0s, ts, _ = fitness_case(pop=12, b=4, t_end=1.6, ops=ops, n=n, depth=depth)
    trees = with_chains(trees, fset, [n - 1, min(127, n - 1), min(63, n - 1)])
    with monkeypatch.context() as m:
        patch_host_math(m)
        xs, alive = cr.sr_rollout_plain(trees, x0s, ts, fset, method, substeps)
    out, alive_h = rollout_host_run(rollout_host, trees, x0s, ts, fset, method, substeps)
    np.testing.assert_array_equal(alive_h, alive[-1].numpy())
    np.testing.assert_array_equal(out, xs.numpy())
    assert alive[-1].any()
    assert int((trees.ops[0] != 0).sum(-1).max()) == n - 1


@pytest.fixture(scope="module")
def jax_case():
    jf = jax_function_set(JAX_OPS, [["x0", "x1"]], [2])
    pop = jax_sampler(jf, 3, 16)(jr.PRNGKey(5), 16)
    x0 = np.random.default_rng(1).normal(size=(4, 2)).astype(np.float32)
    ts = np.arange(0.0, 1.0, 0.2, dtype=np.float32)  # T = 5
    return jf, pop, x0, ts


@pytest.mark.parametrize("method,substeps", CASES)
def test_rollout_plain_matches_jax_integrate(jax_case, method, substeps):
    jf, pop, x0, ts = jax_case
    jtrees = pop[:, None]

    @jax.jit
    def run(x, t):
        drift = lambda tt, xx: jax_evaluate(jtrees, xx[:, :, None, :], jf, impl="gather")
        return jax_integrate(drift, x, t, method=method, substeps=substeps)

    jxs, jalive = run(jnp.broadcast_to(jnp.asarray(x0)[None], (16, 4, 2)), jnp.asarray(ts))
    trees = trees_from_numpy(*[np.asarray(a) for a in pop])
    xs, alive = cr.sr_rollout(trees, torch.from_numpy(x0), torch.from_numpy(ts),
                              function_set_from_jax(jf), method, substeps)
    ja = np.asarray(jalive[-1])
    np.testing.assert_array_equal(alive[-1].numpy(), ja)
    np.testing.assert_allclose(xs.numpy()[:, ja], np.asarray(jxs)[:, ja], rtol=1e-5, atol=1e-6)


@pytest.mark.parametrize("method,substeps", [("rk4", 1), ("heun", 2)])
def test_evaluate_candidate_and_call_match_jax(monkeypatch, method, substeps):
    jf = jax_function_set(JAX_OPS + [("/", jnp.divide, 2, 0.1)], [["x0", "x1"]], [2])
    data = jax_generate(JaxVdP(0.0, 0.0), jr.PRNGKey(0), jnp.arange(0.0, 2.0, 0.2), batch_size=4,
                        substeps=8)
    pop = jax_sampler(jf, 3, 16)(jr.PRNGKey(1), 4)
    jev = JaxSREvaluator(jf, method=method, substeps=substeps, interpreter="gather")
    ev = SREvaluator(function_set_from_jax(jf), method=method, substeps=substeps)
    tdata = sr_data_from_numpy(*data[:3])
    tpop = trees_from_numpy(*[np.asarray(a) for a in pop])
    calls = []
    plain = cr.sr_rollout_plain
    monkeypatch.setattr(cr, "sr_rollout_plain", lambda *a: calls.append(1) or plain(*a))
    for i in range(4):
        jfit, jpred = jax.jit(jev.evaluate_candidate)(pop[i], data)
        fit, pred = ev.evaluate_candidate(tpop[i], tdata)
        assert pred.shape == (4, 10, 2) and fit.shape == (4,)
        np.testing.assert_allclose(fit.numpy(), np.asarray(jfit), rtol=1e-4)
        np.testing.assert_allclose(float(ev(tpop[i], tdata)), float(jax.jit(jev)(pop[i], data)), rtol=1e-4)
    assert len(calls) == 8  # the trajectory kernel's plain version, on CPU tensors


def test_evaluate_candidate_matches_jax_at_gate_limit(monkeypatch):
    """N = 64, the largest trees the trajectory kernel's gate takes
    (``ROLLOUT_MAX_NODES``, JAX's ``UNROLL_MAX_NODES``): candidates grown to
    depth 6 from a key drawn from a numpy seed, the first two replaced by
    chains of 63 and 31 rows, initial
    states and ground truth from the same seed. Every prediction within 1e-5
    + 1e-4 of its trajectory's scale (the largest |x| of JAX's trajectory:
    JAX's step per interval and XLA:CPU's FMAs, ROADMAP Queue 3), the
    liveness identical, the fitness to rtol 1e-4."""
    assert sr_module.ROLLOUT_MAX_NODES == 64
    rng = np.random.default_rng(64)
    jf = jax_function_set(JAX_OPS + [("/", jnp.divide, 2, 0.1)], [["x0", "x1"]], [2])
    pop = jax_sampler(jf, 6, 64)(jr.PRNGKey(int(rng.integers(2**31))), 8)
    # the first two candidates: chains of 63 and 31 rows (the deepest stacks)
    chained = with_chains(trees_from_numpy(*[np.asarray(a) for a in pop]),
                          function_set_from_jax(jf), [63, 31])
    pop = type(pop)(*(jnp.asarray(a.numpy()) for a in chained))
    x0 = rng.normal(size=(4, 2)).astype(np.float32)
    ts = np.arange(0.0, 2.0, 0.2, dtype=np.float32)
    ys = rng.normal(size=(4, ts.shape[0], 2)).astype(np.float32)
    jev = JaxSREvaluator(jf, method="rk4", substeps=2, interpreter="gather")
    ev = SREvaluator(function_set_from_jax(jf), method="rk4", substeps=2)
    tpop = trees_from_numpy(*[np.asarray(a) for a in pop])
    tdata = sr_data_from_numpy(x0, ts, ys)
    calls = []
    plain = cr.sr_rollout_plain
    monkeypatch.setattr(cr, "sr_rollout_plain", lambda *a: calls.append(1) or plain(*a))
    assert int((tpop.ops[0] != 0).sum()) == 2 * 63
    jrun = jax.jit(jev.evaluate_candidate)
    for i in range(pop.ops.shape[0]):
        jfit, jpred = (np.asarray(a) for a in jrun(pop[i], (x0, ts, ys, None)))
        fit, pred = ev.evaluate_candidate(tpop[i], tdata)
        dead = jfit == jev.max_fitness
        np.testing.assert_array_equal(fit.numpy() == ev.max_fitness, dead)
        scale = np.abs(jpred).max(axis=(1, 2), keepdims=True)
        live = ~dead
        err = np.abs(pred.numpy() - jpred)[live]
        assert (err <= 1e-5 + 1e-4 * scale[live]).all(), (i, float(err.max()))
        np.testing.assert_allclose(fit.numpy()[live], jfit[live], rtol=1e-4)
    assert len(calls) == pop.ops.shape[0]  # the trajectory kernel's plain version


def test_rollout_gradient_through_recompute():
    """``SRRollout``'s backward is autograd through ``integrate`` with the
    interpreter as the drift (the per-interval step): on CPU tensors it
    equals the gradient of that recompute."""
    fset = build_function_set(ARITH, [["x0", "x1"]], [2])
    g = torch.Generator().manual_seed(3)
    x0s, ts, _, _ = generate_sr_data(VanDerPolOscillator(), g, torch.arange(0.0, 1.0, 0.2), batch_size=3)
    trees = make_population_sampler(fset, 3, 16)(g, 6)[0]
    g_xs = torch.randn((ts.shape[0], 6, 3, 2), generator=g)
    const = trees.const.clone().requires_grad_(True)
    xs, alive = cr.SRRollout.apply(trees.ops, trees.c1, trees.c2, const, x0s, ts, fset, "rk4", 1)
    (got,) = torch.autograd.grad(xs, (const,), g_xs)
    const2 = trees.const.clone().requires_grad_(True)
    batched = trees._replace(const=const2).map(lambda a: a[:, None])
    ref, _ = integrate(lambda t, x: evaluate_trees(batched, x[:, :, None, :], fset),
                       x0s[None].expand(6, 3, 2), ts, "rk4", 1)
    (want,) = torch.autograd.grad(ref, (const2,), g_xs)
    assert torch.equal(torch.isfinite(got), torch.isfinite(want))
    fin = torch.isfinite(want)
    assert bool((want[fin] != 0).any())
    torch.testing.assert_close(got[fin], want[fin], rtol=0, atol=0)


def test_library_path_hashes_included_headers(tmp_path, monkeypatch):
    """An edited header changes the library path of every source that
    includes it, directly or through another header (so it is rebuilt), and
    of no other."""
    names = ("sr_fitness", "sr_adaptive", "sr_rollout", "interpreter", "reproduce", "policy")
    for name in names:
        shutil.copy(_build.CSRC_DIR / f"{name}.cu", tmp_path)
    for header in _build.CSRC_DIR.glob("*.cuh"):
        shutil.copy(header, tmp_path)
    monkeypatch.setattr(_build, "CSRC_DIR", tmp_path)
    assert [p.name for p in _build.source_files("sr_adaptive")] == [
        "sr_adaptive.cu", "adaptive_step.cuh", "sr_lane.cuh", "tree_prog.cuh", "tree_prog_wide.cuh",
        "tree_eval.cuh"]
    for header, touched in (("sr_lane.cuh", {"sr_fitness", "sr_adaptive", "sr_rollout"}),
                            ("tree_prog_wide.cuh", {"sr_fitness", "sr_adaptive", "sr_rollout", "policy"}),
                            ("tree_prog.cuh", {"sr_fitness", "sr_adaptive", "sr_rollout", "policy"}),
                            ("control_envs.cuh", {"policy"}),
                            ("tree_eval.cuh", set(names) - {"reproduce"})):
        before = {n: _build.library_path(n) for n in names}
        path = tmp_path / header
        path.write_text(path.read_text() + "\n// touched\n")
        after = {n: _build.library_path(n) for n in names}
        for n in names:
            includes = header in [p.name for p in _build.source_files(n)]
            assert (after[n] != before[n]) == includes, (header, n)
        assert {n for n in names if after[n] != before[n]} == touched, header


def test_concurrent_builds_of_one_library_run_one_nvcc(tmp_path, monkeypatch):
    """Two threads build the same library at once: the second waits for the
    first's compiler and finds the library, so the compiler runs once."""
    calls = tmp_path / "calls.log"
    fake = tmp_path / "nvcc"
    fake.write_text("#!/bin/sh\n"
                    f"echo run >> {calls}\n"
                    "sleep 0.5\n"
                    "prev=\"\"; for a in \"$@\"; do [ \"$prev\" = -o ] && out=\"$a\"; prev=\"$a\"; done\n"
                    "echo lib > \"$out\"\n")
    fake.chmod(0o755)
    monkeypatch.setattr(_build, "BUILD_DIR", tmp_path / "build")
    monkeypatch.setattr(_build, "find_nvcc", lambda: str(fake))
    monkeypatch.setattr(_build, "build_seconds", {})
    monkeypatch.setattr(_build, "build_logs", {})
    first = []
    worker = threading.Thread(target=lambda: first.append(_build.build("reproduce")))
    worker.start()
    while not calls.exists():  # the first build's compiler has started
        time.sleep(0.01)
    second = _build.build("reproduce")
    worker.join()
    assert first == [second] and second[0].read_text() == "lib\n"
    assert calls.read_text().splitlines() == ["run"]
