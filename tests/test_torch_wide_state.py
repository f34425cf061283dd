"""PyTorch port: the SR kernels' wide-state instance (#1, #3, #4, #5 at any
state dim and trajectory count; ``csrc/tree_prog_wide.cuh``).

On the CPU:

* the wide host build (``g++``, the same per-lane code the card runs, built
  with ``-DMTGP_WIDE_STATE``) against the plain versions, bit for bit per
  lane: #1 at euler, heun and rk4, d = 5, 40 and 70 (70 > 63: the wide row's
  slot), with and without Euler-Maruyama kick rows; #1 at B = 1,100; #3 at
  d = 5 and 40; #5 and #4 at d = 5 and 8 with small budgets; #1, #3 and #5
  with an ``_ext`` set and with gplearn's protected set at d = 5 (the host's
  ``powf``, ``expf``, ``logf`` and an IEEE square root swapped into PyTorch,
  ``test_torch_kernels.patch_host_math``); the scratch split into several
  launches (a small ``SCRATCH_BYTES``), and a NaN-filled scratch, change
  nothing;
* the wide host build against the fixed one at d = 2 and 4, bit for bit
  (#1 with and without kicks, #3, #5, #4);
* JAX's ``rollout_sr_fitness_pallas`` in interpret mode (as
  ``tests/test_rollout_interpret.py`` runs it) at d = 6 against the port's
  fused path (the plain version the CPU dispatch runs, which the wide host
  build equals bit for bit): the same lanes alive, per lane the median
  relative error <= 1e-6 and the largest <= 1e-4, the rollout tests' rule
  (``test_torch_gates.assert_fitness_close``: XLA:CPU contracts the RK
  updates into fused multiply-adds, the port does not);
* ``prepare_chained`` past the fixed instances (d = 5, B = 1,025) equals
  ``evaluate_population`` bit for bit; a wide build that fails raises.

On the card (marker ``cuda``): each wide kernel against its plain version
on every lane (d = 5, 40 and 70; B = 1,100; at d = 5 also in the ``_ext``
and gplearn's user build), against the fixed instance at d = 2 and 4, the dispatchers' launch counters, and ``SREvaluator`` on
Lorenz-96 (40 states) through #1's wide instance, one launch and no #8.

JAX is imported only inside the tests that use it, so the card's run
(``pytest --noconftest -m cuda``, no JAX there) imports this file.
"""
import ctypes
import shutil

import numpy as np
import pytest
import torch

from multitreegp_tpu_torch import _build
from multitreegp_tpu_torch.core import cuda_adaptive as ca
from multitreegp_tpu_torch.core import cuda_rollout as cro
from multitreegp_tpu_torch.core.registry import build_function_set, gplearn_operators
from multitreegp_tpu_torch.models.evaluators import SREvaluator
from multitreegp_tpu_torch.models.evaluators.noise import make_sr_kick_rows
from multitreegp_tpu_torch.ops.initialization import make_population_sampler
from test_torch_kernels import fitness_case, lorenz96_data, patch_host_math, same_bits, state4_case

torch.set_num_threads(1)

ARITH = [("+", 2, 0.5), ("-", 2, 0.1), ("*", 2, 0.5), ("/", 2, 0.1)]
EXT = ARITH + [("exp", 1, 0.1), ("sqrt", 1, 0.1), ("tanh", 1, 0.1), ("pow", 2, 0.1), ("max", 2, 0.1)]
# the C entry points' arguments before the wide ones (scratch, c0, count)
FITNESS_TYPES = [ctypes.c_void_p] * 9 + [ctypes.c_int] * 9
ROLLOUT_TYPES = [ctypes.c_void_p] * 6 + [ctypes.c_int] * 9 + [ctypes.c_float] * 3
ADAPTIVE_TYPES = [ctypes.c_int] + [ctypes.c_void_p] * 9 + [ctypes.c_int] * 9 + [ctypes.c_float] * 3


def state_case(d, pop=6, b=3, t_steps=4, n=16, depth=3, ops=ARITH, seed=0, dt=0.1):
    """``(fset, trees, x0s, ts, ys)``: ``pop`` candidates of ``d`` trees of
    ``n`` rows grown to ``depth`` over ``d`` variables, on ``b`` trajectories
    of numpy data made from ``seed`` (x0 and ground truth standard normal) at
    ``ts = 0, dt, ...``."""
    fset = build_function_set(ops, [[f"x{i}" for i in range(d)]], [d])
    g = torch.Generator().manual_seed(seed)
    trees = make_population_sampler(fset, depth, n)(g, pop)[0]
    rng = np.random.default_rng(seed)
    x0s = torch.from_numpy(rng.normal(size=(b, d)).astype(np.float32))
    ys = torch.from_numpy(rng.normal(size=(b, t_steps, d)).astype(np.float32))
    return fset, trees, x0s, torch.arange(t_steps, dtype=torch.float32) * dt, ys


def kicks_for(ts, b, d, substeps, seed=5):
    """Kick rows ``(T, B, substeps * d)`` as the SR evaluator makes them
    (``make_sr_kick_rows``), from numpy-made keys."""
    keys = torch.from_numpy(np.random.default_rng(seed).integers(0, 2**32, (b, 2), dtype=np.uint32)
                            .astype(np.int64))
    return make_sr_kick_rows(0.2, ts, keys, substeps, d)


@pytest.fixture(scope="module")
def host(tmp_path_factory):
    """``host(name, variant)``: the host build of ``csrc/<name>.cu`` in
    ``variant``, built once."""
    if shutil.which("g++") is None and shutil.which("c++") is None:
        pytest.skip("no host C++ compiler")
    out = tmp_path_factory.mktemp("wide_state_host")
    made = {}

    def get(name, variant=_build.DEFAULT):
        key = (name, _build.variant_name(name, variant))
        if key not in made:
            made[key] = _build.build_host(name, out, variant)
        return made[key]

    return get


def _arrays(*tensors):
    return [np.ascontiguousarray(t.numpy()) for t in tensors]


def _wide_calls(fn, types, p, b, d, vectors, args):
    """Call a wide host entry (its arguments ``args`` of ``types``, then the
    scratch and the part) over :func:`cro.wide_launches`'s parts with a
    NaN-filled scratch (a lane never reads what it did not write); the
    number of parts."""
    fn.argtypes = types + [ctypes.c_void_p, ctypes.c_int, ctypes.c_int]
    launches = cro.wide_launches(p, b, d, vectors)
    scratch = np.full(vectors * d * launches[0][1] * b, np.nan, np.float32)
    for c0, count in launches:
        assert fn(*args, scratch.ctypes.data, c0, count) == 0
    return len(launches)


def fitness_wide(lib, trees, x0s, ts, ys, fset, method, substeps, kick_rows=None):
    """The wide host build of #1: ``(mse, alive, parts)``."""
    p, d, n = trees.ops.shape
    b, t = x0s.shape[0], ts.shape[0]
    err, alive = np.zeros((p, b), np.float32), np.zeros((p, b), np.uint8)
    arrays = _arrays(trees.ops, trees.const, fset.device_ops(), x0s, ts, ys)
    kicks = None if kick_rows is None else _arrays(kick_rows)[0]
    args = (*(a.ctypes.data for a in arrays), None if kicks is None else kicks.ctypes.data,
            err.ctypes.data, alive.ctypes.data, p, d, n, b, t, fset.var_start, fset.has_unary,
            cro.METHODS[method], substeps)
    parts = _wide_calls(lib.sr_fitness_wide_host, FITNESS_TYPES, p, b, d, cro.FITNESS_VECTORS, args)
    return err / np.float32(t), alive.astype(bool), parts


def fitness_fixed(lib, trees, x0s, ts, ys, fset, method, substeps, kick_rows=None):
    """The fixed host build of #1: ``(mse, alive)``."""
    p, d, n = trees.ops.shape
    b, t = x0s.shape[0], ts.shape[0]
    err, alive = np.zeros((p, b), np.float32), np.zeros((p, b), np.uint8)
    arrays = _arrays(trees.ops, trees.const, fset.device_ops(), x0s, ts, ys)
    kicks = None if kick_rows is None else _arrays(kick_rows)[0]
    fn = lib.sr_fitness_host
    fn.argtypes = FITNESS_TYPES
    assert fn(*(a.ctypes.data for a in arrays), None if kicks is None else kicks.ctypes.data,
              err.ctypes.data, alive.ctypes.data, p, d, n, b, t, fset.var_start, fset.has_unary,
              cro.METHODS[method], substeps) == 0
    return err / np.float32(t), alive.astype(bool)


def _rollout_args(trees, x0s, ts, fset, method, substeps, out, alive):
    p, d, n = trees.ops.shape
    h, h_final = cro.rollout_step(ts, method, substeps)
    arrays = _arrays(trees.ops, trees.const, fset.device_ops(), x0s)
    return arrays, (*(a.ctypes.data for a in arrays), out.ctypes.data, alive.ctypes.data, p, d, n,
                    x0s.shape[0], ts.shape[0], fset.var_start, fset.has_unary, cro.METHODS[method],
                    substeps, np.float32(h * 0.5), np.float32(h), h_final)


def rollout_host(lib, trees, x0s, ts, fset, method, substeps, wide=True):
    """The host build of #3 (wide or fixed): ``(xs (T, P, B, d), alive (P, B))``."""
    p, d, _ = trees.ops.shape
    b, t = x0s.shape[0], ts.shape[0]
    out = np.zeros((t, p, b, d), np.float32)
    alive = np.zeros((p, b), np.uint8)
    keep, args = _rollout_args(trees, x0s, ts, fset, method, substeps, out, alive)
    if wide:
        _wide_calls(lib.sr_rollout_wide_host, ROLLOUT_TYPES, p, b, d, cro.ROLLOUT_VECTORS, args)
    else:
        fn = lib.sr_rollout_host
        fn.argtypes = ROLLOUT_TYPES
        assert fn(*args) == 0
    return out, alive.astype(bool)


def adaptive_host(lib, kind, trees, x0s, ts, ys, fset, budget, method, wide=True):
    """The host build of #5 (``ca.GLOBAL``) or #4 (``ca.INTERVAL``), wide or
    fixed: ``(mse, alive, steps)``."""
    p, d, n = trees.ops.shape
    b, t = x0s.shape[0], ts.shape[0]
    err, alive, steps = np.zeros((p, b), np.float32), np.zeros((p, b), np.uint8), np.zeros((p, b), np.int32)
    arrays = _arrays(trees.ops, trees.const, fset.device_ops(), x0s, ts, ys)
    args = (kind, *(a.ctypes.data for a in arrays), err.ctypes.data, alive.ctypes.data,
            steps.ctypes.data, p, d, n, b, t, fset.var_start, fset.has_unary, ca.METHODS[method],
            budget, 1e-4, 1e-6, 0.9)
    if wide:
        _wide_calls(lib.sr_adaptive_wide_host, ADAPTIVE_TYPES, p, b, d, ca.ADAPTIVE_VECTORS, args)
    else:
        fn = lib.sr_adaptive_host
        fn.argtypes = ADAPTIVE_TYPES
        assert fn(*args) == 0
    return err / np.float32(t), alive.astype(bool), steps


WIDE = _build.widened(_build.DEFAULT)


# ------------------------------------------------------- wide host vs plain


@pytest.mark.parametrize("d", [5, 40, 70])
@pytest.mark.parametrize("method,substeps,kicks", [("euler", 2, False), ("heun", 1, False),
                                                    ("rk4", 1, False), ("euler", 2, True)])
def test_fitness_wide_host_bit_exact(host, d, method, substeps, kicks):
    """#1's wide instance: every lane's error sum and liveness as the plain
    version's; at d = 70 the trees read variables past 63."""
    fset, trees, x0s, ts, ys = state_case(d)
    rows = kicks_for(ts, x0s.shape[0], d, substeps) if kicks else None
    mse, alive = cro.sr_fitness_plain(trees, x0s, ts, ys, fset, method, substeps, rows)
    err, alive_h, _ = fitness_wide(host("sr_fitness", WIDE), trees, x0s, ts, ys, fset, method,
                                   substeps, rows)
    np.testing.assert_array_equal(alive_h, alive.numpy())
    assert same_bits(torch.from_numpy(err), mse) and alive.any()
    if d == 70:
        assert bool((trees.ops >= fset.var_start + 64).any())


def test_fitness_wide_host_many_trajectories(host):
    """B = 1,100 (past the fixed instances' 1024), VdP's d = 2, RK4."""
    fset, trees, x0s, ts, ys = state_case(2, pop=3, b=1100, t_steps=3)
    mse, alive = cro.sr_fitness_plain(trees, x0s, ts, ys, fset, "rk4", 1)
    err, alive_h, _ = fitness_wide(host("sr_fitness", WIDE), trees, x0s, ts, ys, fset, "rk4", 1)
    np.testing.assert_array_equal(alive_h, alive.numpy())
    assert same_bits(torch.from_numpy(err), mse) and alive.any()


def test_wide_host_scratch_split(host, monkeypatch):
    """A scratch budget of two candidates' lanes splits #1 and #5 into several
    launches with the same lanes."""
    fset, trees, x0s, ts, ys = state_case(5, pop=5)
    lib = host("sr_fitness", WIDE)
    whole = fitness_wide(lib, trees, x0s, ts, ys, fset, "rk4", 1)
    monkeypatch.setattr(cro, "SCRATCH_BYTES", 2 * cro.FITNESS_VECTORS * 5 * x0s.shape[0] * 4)
    split = fitness_wide(lib, trees, x0s, ts, ys, fset, "rk4", 1)
    assert whole[2] == 1 and split[2] == 3
    np.testing.assert_array_equal(split[0], whole[0])
    np.testing.assert_array_equal(split[1], whole[1])
    alib = host("sr_adaptive", WIDE)
    got = adaptive_host(alib, ca.GLOBAL, trees, x0s, ts, ys, fset, 20, "dopri5")
    monkeypatch.setattr(cro, "SCRATCH_BYTES", 1 << 30)
    ref = adaptive_host(alib, ca.GLOBAL, trees, x0s, ts, ys, fset, 20, "dopri5")
    for a, b in zip(got, ref):
        np.testing.assert_array_equal(a, b)


@pytest.mark.parametrize("d,method,substeps", [(5, "rk4", 2), (40, "heun", 1), (40, "rk4", 1)])
def test_rollout_wide_host_bit_exact(host, d, method, substeps):
    """#3's wide instance: every state of every lane and the final liveness."""
    fset, trees, x0s, ts, _ = state_case(d)
    xs, alive = cro.sr_rollout_plain(trees, x0s, ts, fset, method, substeps)
    out, alive_h = rollout_host(host("sr_rollout", WIDE), trees, x0s, ts, fset, method, substeps)
    np.testing.assert_array_equal(alive_h, alive[-1].numpy())
    np.testing.assert_array_equal(out, xs.numpy())  # NaN == NaN for assert_array_equal
    assert alive[-1].any()


def adaptive_plain(kind):
    return ca.sr_fitness_adaptive_global_plain if kind == ca.GLOBAL else ca.sr_fitness_adaptive_interval_plain


@pytest.mark.parametrize("d", [5, 8])
@pytest.mark.parametrize("kind,budget,method", [(ca.GLOBAL, 30, "dopri5"), (ca.INTERVAL, 6, "dopri5"),
                                                (ca.GLOBAL, 30, "bosh3"), (ca.INTERVAL, 6, "bosh3")])
def test_adaptive_wide_host_bit_exact(host, monkeypatch, d, kind, budget, method):
    """#5 (global budget) and #4 (per interval): error sums, liveness and
    attempted steps bit for bit, the host's ``powf`` and an IEEE square root
    in the plain version."""
    fset, trees, x0s, ts, ys = state_case(d, t_steps=4, dt=0.2)
    got = adaptive_host(host("sr_adaptive", WIDE), kind, trees, x0s, ts, ys, fset, budget, method)
    with monkeypatch.context() as m:
        patch_host_math(m)
        mse, alive, steps = adaptive_plain(kind)(trees, x0s, ts, ys, fset, 1e-4, 1e-6, budget, method)
    np.testing.assert_array_equal(got[1], alive.numpy())
    np.testing.assert_array_equal(got[2], steps.numpy())
    assert same_bits(torch.from_numpy(got[0]), mse) and alive.any() and (got[2] > 1).any()


@pytest.mark.parametrize("ops", ["ext", "gplearn"])
def test_wide_host_operator_sets(host, monkeypatch, ops):
    """The wide instance in the ``_ext`` build and in the user build of
    gplearn's protected set, d = 5: #1 (RK4), #3 (RK4) and #5 (dopri5)."""
    fset, trees, x0s, ts, ys = state_case(5, ops=EXT if ops == "ext" else gplearn_operators())
    variant = _build.widened(fset.variant)
    assert variant.suffix.endswith("_wide") and variant.suffix != "_wide"
    with monkeypatch.context() as m:
        patch_host_math(m)
        mse, alive = cro.sr_fitness_plain(trees, x0s, ts, ys, fset, "rk4", 1)
        xs, r_alive = cro.sr_rollout_plain(trees, x0s, ts, fset, "rk4", 1)
        a_mse, a_alive, a_steps = ca.sr_fitness_adaptive_global_plain(trees, x0s, ts, ys, fset, budget=20)
    err, alive_h, _ = fitness_wide(host("sr_fitness", variant), trees, x0s, ts, ys, fset, "rk4", 1)
    np.testing.assert_array_equal(alive_h, alive.numpy())
    assert same_bits(torch.from_numpy(err), mse) and alive.any()
    out, r_alive_h = rollout_host(host("sr_rollout", variant), trees, x0s, ts, fset, "rk4", 1)
    np.testing.assert_array_equal(r_alive_h, r_alive[-1].numpy())
    np.testing.assert_array_equal(out, xs.numpy())
    got = adaptive_host(host("sr_adaptive", variant), ca.GLOBAL, trees, x0s, ts, ys, fset, 20, "dopri5")
    np.testing.assert_array_equal(got[1], a_alive.numpy())
    np.testing.assert_array_equal(got[2], a_steps.numpy())
    assert same_bits(torch.from_numpy(got[0]), a_mse)


# ------------------------------------------------------- wide host vs fixed


def fixed_case(d):
    """d = 2: VdP candidates of 2 trees (``test_torch_kernels.fitness_case``);
    d = 4: 4 trees of 256 rows, chains among them (``state4_case``)."""
    if d == 2:
        return fitness_case(pop=12, b=4, t_end=1.0)
    return state4_case(pop=6, b=2, n=256, t_steps=4)


@pytest.mark.parametrize("d", [2, 4])
def test_wide_host_equals_fixed(host, d):
    """At d = 2 and 4 the wide instance's lanes equal the fixed one's bit for
    bit: #1 (RK4; Euler with kicks), #3 (RK4), #5 and #4 (dopri5)."""
    fset, trees, x0s, ts, ys = fixed_case(d)
    b = x0s.shape[0]
    rows = kicks_for(ts, b, d, 2)
    for method, substeps, kicks in (("rk4", 1, None), ("euler", 2, rows)):
        wide = fitness_wide(host("sr_fitness", WIDE), trees, x0s, ts, ys, fset, method, substeps, kicks)
        fixed = fitness_fixed(host("sr_fitness"), trees, x0s, ts, ys, fset, method, substeps, kicks)
        np.testing.assert_array_equal(wide[1], fixed[1])
        assert same_bits(torch.from_numpy(wide[0]), torch.from_numpy(fixed[0]))
    assert wide[1].any()
    w_xs, w_alive = rollout_host(host("sr_rollout", WIDE), trees, x0s, ts, fset, "rk4", 1)
    f_xs, f_alive = rollout_host(host("sr_rollout"), trees, x0s, ts, fset, "rk4", 1, wide=False)
    np.testing.assert_array_equal(w_alive, f_alive)
    np.testing.assert_array_equal(w_xs, f_xs)
    for kind, budget in ((ca.GLOBAL, 30), (ca.INTERVAL, 6)):
        w = adaptive_host(host("sr_adaptive", WIDE), kind, trees, x0s, ts, ys, fset, budget, "dopri5")
        f = adaptive_host(host("sr_adaptive"), kind, trees, x0s, ts, ys, fset, budget, "dopri5", wide=False)
        np.testing.assert_array_equal(w[1], f[1])
        np.testing.assert_array_equal(w[2], f[2])
        assert same_bits(torch.from_numpy(w[0]), torch.from_numpy(f[0]))


# ------------------------------------------------------------ against JAX


def test_fused_fitness_matches_jax_interpret():
    """JAX's fused fitness kernel (``rollout_sr_fitness_pallas``, interpret
    mode) at d = 6 against the port's fused path (on the CPU its plain
    version, which the wide host build equals bit for bit: the tests above):
    the same lanes alive; per lane the median relative error <= 1e-6 and the
    largest <= 1e-4 (XLA:CPU contracts FMAs, the port does not; 8.7e-5 at
    one lane of 32 here)."""
    import jax.numpy as jnp
    import jax.random as jr
    from jax.experimental.pallas import tpu as pltpu

    from multitreegp_tpu.core.pallas_rollout import rollout_sr_fitness_pallas
    from multitreegp_tpu.core.registry import build_function_set as jax_function_set
    from multitreegp_tpu.ops.initialization import make_population_sampler as jax_sampler
    from multitreegp_tpu_torch.convert import function_set_from_jax, sr_data_from_numpy, trees_from_numpy

    d, p, b, t = 6, 8, 4, 5
    jops = [("+", jnp.add, 2, 0.5), ("-", jnp.subtract, 2, 0.1), ("*", jnp.multiply, 2, 0.5),
            ("/", jnp.divide, 2, 0.1)]
    jf = jax_function_set(jops, [[f"x{i}" for i in range(d)]], [d])
    pop = jax_sampler(jf, 3, 16)(jr.PRNGKey(1), p)
    rng = np.random.default_rng(0)
    x0s = rng.uniform(-1.0, 1.0, (b, d)).astype(np.float32)
    ts = (np.arange(t) * 0.2).astype(np.float32)
    ys = rng.uniform(-1.0, 1.0, (b, t, d)).astype(np.float32)
    with pltpu.force_tpu_interpret_mode():
        ref, ref_alive = rollout_sr_fitness_pallas(
            pop, jnp.broadcast_to(jnp.asarray(x0s)[None], (p, b, d)), jnp.asarray(ts), jnp.asarray(ys),
            jf, substeps=1)
    ref, ref_alive = np.asarray(ref), np.asarray(ref_alive)
    fset = function_set_from_jax(jf)
    trees = trees_from_numpy(*[np.asarray(a) for a in pop])
    tx0s, tts, tys, _ = sr_data_from_numpy(x0s, ts, ys)
    assert SREvaluator(fset, substeps=1)._fused(trees, tx0s)
    mse, alive = (a.numpy() for a in cro.sr_fitness(trees, tx0s, tts, tys, fset, "rk4", 1))
    np.testing.assert_array_equal(alive, ref_alive)
    both = alive & np.isfinite(ref) & np.isfinite(mse)
    assert both.mean() > 0.5
    rel = np.abs(mse[both] - ref[both]) / np.maximum(np.abs(ref[both]), 1e-30)
    assert np.median(rel) <= 1e-6 and rel.max() <= 1e-4, rel


# ------------------------------------------------------- routing, no fallback


def test_prepare_chained_past_the_fixed_instances():
    """d = 5 and B = 1,025 take kernel #1 (the wide instance on the card):
    ``prepare_chained`` returns a step equal to ``evaluate_population`` bit
    for bit."""
    for d, b in ((5, 4), (2, 1025)):
        fset, trees, x0s, ts, ys = state_case(d, pop=4, b=b, t_steps=3)
        ev = SREvaluator(fset, substeps=1)
        data = (x0s, ts, ys, None)
        assert ev._fused(trees, x0s) and not cro.takes_fixed(d, b, fset.num_variables, fset.max_device_op)
        step, const0 = ev.prepare_chained(trees, data)
        assert same_bits(step(const0), ev.evaluate_population(trees, data))


def test_fixed_wrappers_refuse_past_63_variables():
    """The fixed instances' decoded row holds variable slots up to 63:
    their operands refuse a set of more variables, so no fixed launch reads
    a wrong variable; the dispatchers route such a set to the wide one."""
    fset, trees, x0s, ts, ys = state_case(2)
    wide_set = build_function_set(ARITH, [[f"x{i}" for i in range(64)]], [2])
    assert (cro.takes_fixed(2, 4, fset.num_variables, fset.max_device_op)
            and not cro.takes_fixed(2, 4, 64, fset.max_device_op))
    with pytest.raises(NotImplementedError, match="64 variables"):
        cro.kernel_operands(trees, wide_set, ("x0s", x0s))
    cro.kernel_operands(trees, fset, ("x0s", x0s))


def test_wide_build_failure_raises(monkeypatch, tmp_path):
    """No fallback: a wide library that cannot be built raises from the
    wrapper (here ``nvcc`` is missing), it never runs a plain version."""
    def no_nvcc():
        raise RuntimeError("nvcc not found: the CUDA kernels need the CUDA toolkit")

    monkeypatch.setattr(_build, "find_nvcc", no_nvcc)
    monkeypatch.setattr(_build, "BUILD_DIR", tmp_path)
    monkeypatch.setattr(_build, "_loaded", {})
    fset, trees, x0s, ts, ys = state_case(5, pop=2)
    before = cro.sr_fitness_wide_cuda.launches, ca.sr_fitness_adaptive_global_wide_cuda.launches
    with pytest.raises(RuntimeError, match="nvcc"):
        cro.sr_fitness_wide_cuda(trees, x0s, ts, ys, fset)
    with pytest.raises(RuntimeError, match="nvcc"):
        ca.sr_fitness_adaptive_global_wide_cuda(trees, x0s, ts, ys, fset)
    assert (cro.sr_fitness_wide_cuda.launches, ca.sr_fitness_adaptive_global_wide_cuda.launches) == before


# ------------------------------------------------------------------ card


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU (CUDA kernels have no CPU mode)")
    return torch.device("cuda")


def on(device, case):
    fset, trees, *rest = case
    return (fset, trees.map(lambda a: a.to(device)), *(t.to(device) for t in rest))


@pytest.mark.cuda
@pytest.mark.parametrize("d,b", [(5, 16), (40, 16), (70, 4), (2, 1100)])
def test_wide_kernels_match_plain_on_card(cuda, d, b):
    """#1 (RK4; Euler with kicks), #3 (RK4), #5 and #4 (dopri5) through their
    dispatchers, which route to the wide instance: one launch each, every
    lane bit for bit as the plain version on the card."""
    fset, trees, x0s, ts, ys = on(cuda, state_case(d, pop=64, b=b, t_steps=5))
    rows = kicks_for(ts.cpu(), b, d, 2).to(cuda)
    checks = (
        (cro.sr_fitness_wide_cuda, lambda: cro.sr_fitness(trees, x0s, ts, ys, fset, "rk4", 1),
         lambda: cro.sr_fitness_plain(trees, x0s, ts, ys, fset, "rk4", 1)),
        (cro.sr_fitness_wide_cuda, lambda: cro.sr_fitness(trees, x0s, ts, ys, fset, "euler", 2, rows),
         lambda: cro.sr_fitness_plain(trees, x0s, ts, ys, fset, "euler", 2, rows)),
        (cro.sr_rollout_wide_cuda, lambda: cro.sr_rollout(trees, x0s, ts, fset, "rk4", 1),
         lambda: cro.sr_rollout_plain(trees, x0s, ts, fset, "rk4", 1)),
        (ca.sr_fitness_adaptive_global_wide_cuda,
         lambda: ca.sr_fitness_adaptive_global(trees, x0s, ts, ys, fset, budget=40, return_steps=True),
         lambda: ca.sr_fitness_adaptive_global_plain(trees, x0s, ts, ys, fset, budget=40)),
        (ca.sr_fitness_adaptive_interval_wide_cuda,
         lambda: ca.adaptive_solver_stats(trees, x0s, ts, ys, fset, max_steps=8, method="dopri5"),
         lambda: ca.sr_fitness_adaptive_interval_plain(trees, x0s, ts, ys, fset, max_steps=8,
                                                       method="dopri5")),
    )
    fixed = (cro.sr_fitness_cuda.launches, cro.sr_rollout_cuda.launches)
    for counter, run, plain in checks:
        before = counter.launches
        got, ref = run(), plain()
        torch.cuda.synchronize()
        assert counter.launches == before + 1
        for a, r in zip(got, ref):
            assert same_bits(a.float(), r.float())
    assert (cro.sr_fitness_cuda.launches, cro.sr_rollout_cuda.launches) == fixed


@pytest.mark.cuda
@pytest.mark.parametrize("ops", ["ext", "gplearn"])
def test_wide_operator_builds_on_card(cuda, ops):
    """The wide instances' ``_ext_wide`` build and gplearn's user build's
    wide form on the card, d = 5: #1 (RK4), #3 (RK4), #5 and #4 (dopri5)
    bit for bit as their plain versions."""
    fset, trees, x0s, ts, ys = on(cuda, state_case(5, pop=64, b=16, t_steps=5,
                                                   ops=EXT if ops == "ext" else gplearn_operators()))
    checks = (
        (lambda: cro.sr_fitness_wide_cuda(trees, x0s, ts, ys, fset, "rk4", 1),
         lambda: cro.sr_fitness_plain(trees, x0s, ts, ys, fset, "rk4", 1)),
        (lambda: cro.sr_rollout_wide_cuda(trees, x0s, ts, fset, "rk4", 1),
         lambda: cro.sr_rollout_plain(trees, x0s, ts, fset, "rk4", 1)),
        (lambda: ca.sr_fitness_adaptive_global_wide_cuda(trees, x0s, ts, ys, fset, budget=40),
         lambda: ca.sr_fitness_adaptive_global_plain(trees, x0s, ts, ys, fset, budget=40)),
        (lambda: ca.sr_fitness_adaptive_interval_wide_cuda(trees, x0s, ts, ys, fset, max_steps=8,
                                                           method="dopri5"),
         lambda: ca.sr_fitness_adaptive_interval_plain(trees, x0s, ts, ys, fset, max_steps=8,
                                                       method="dopri5")),
    )
    for run, plain in checks:
        got, ref = run(), plain()
        torch.cuda.synchronize()
        for a, r in zip(got, ref):
            assert same_bits(a.float(), r.float())
    assert _build.variant_name("sr_adaptive", _build.widened(fset.variant)) in _build._loaded


@pytest.mark.cuda
@pytest.mark.parametrize("d", [2, 4])
def test_wide_kernels_equal_fixed_on_card(cuda, d):
    """At d = 2 and 4 the wide instances' lanes equal the fixed ones' on the
    card, bit for bit (#1, #3, #5, #4)."""
    fset, trees, x0s, ts, ys = on(cuda, fixed_case(d))
    pairs = (
        (lambda: cro.sr_fitness_wide_cuda(trees, x0s, ts, ys, fset),
         lambda: cro.sr_fitness_cuda(trees, x0s, ts, ys, fset)),
        (lambda: cro.sr_rollout_wide_cuda(trees, x0s, ts, fset),
         lambda: cro.sr_rollout_cuda(trees, x0s, ts, fset)),
        (lambda: ca.sr_fitness_adaptive_global_wide_cuda(trees, x0s, ts, ys, fset, budget=30),
         lambda: ca.sr_fitness_adaptive_global_cuda(trees, x0s, ts, ys, fset, budget=30)),
        (lambda: ca.sr_fitness_adaptive_interval_wide_cuda(trees, x0s, ts, ys, fset, max_steps=6),
         lambda: ca.sr_fitness_adaptive_interval_cuda(trees, x0s, ts, ys, fset, max_steps=6)),
    )
    for wide, fixed in pairs:
        for a, r in zip(wide(), fixed()):
            assert same_bits(a.float(), r.float())


@pytest.mark.cuda
def test_lorenz96_evaluator_takes_the_wide_kernel_on_card(cuda):
    """``SREvaluator`` on Lorenz-96 (40 states, 40 trees): one launch of
    #1's wide instance an evaluation and no #8; the fitness equals the same
    evaluation on CPU copies (the plain version) within 1e-6 relative, the
    same candidates clamped (the mean over trajectories sums in another
    order on the card; per lane the kernel is bit-equal,
    ``test_wide_kernels_match_plain_on_card``)."""
    from multitreegp_tpu_torch.core import cuda_interpreter as ci

    fset = build_function_set(ARITH, [[f"x{i}" for i in range(40)]], [40])
    trees = make_population_sampler(fset, 2, 32)(torch.Generator().manual_seed(7), 64)[0]
    x0s, ts, ys = lorenz96_data(16, 6, seed=7)
    ev = SREvaluator(fset, substeps=1)
    data = (x0s.to(cuda), ts.to(cuda), ys.to(cuda), None)
    before, fwd = cro.sr_fitness_wide_cuda.launches, ci.evaluate_trees_cuda.launches
    fitness = ev.evaluate_population(trees.map(lambda a: a.to(cuda)), data)
    torch.cuda.synchronize()
    assert cro.sr_fitness_wide_cuda.launches == before + 1 and ci.evaluate_trees_cuda.launches == fwd
    cpu = ev.evaluate_population(trees, (x0s, ts, ys, None))
    assert torch.equal(fitness.cpu() == 1e5, cpu == 1e5) and bool((cpu < 1e5).any())
    torch.testing.assert_close(fitness.cpu(), cpu, rtol=1e-6, atol=0)
