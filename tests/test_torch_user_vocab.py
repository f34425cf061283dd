"""PyTorch port: the emitter's vocabulary past its first table, in every
tree kernel.

Each callable of ``registry.vocabulary_operators()`` (the sigmoid, ``erf``,
``erfc``, ``relu``, the inverse and hyperbolic functions, ``log1p``,
``log2``, ``log10``, ``expm1``, ``exp2``, ``rsqrt``, rounding, clamps, powers
by any scalar and by a tensor, ``maximum``/``minimum``, ``atan2``,
``hypot``, ``fmod``/``remainder`` by a tensor and by a scalar, rounded
divisions, comparisons cast to float32, in-place forms) and of
``registry.pysr_operators()`` traces into generated code with its VJP
(``core/user_ops.py``); a few stay refused, each with its reason.

Tolerances, and why:

* the user host builds (g++, the C library's math) of #8/#9 on six trees
  around each operator, and of #1, #3, #4/#5 and #6/#7 on one vocabulary set
  each, against the plain version: bit for bit per lane (equal values, NaN
  where the other has NaN), forward and VJP. The plain side runs with the C
  library's functions under PyTorch's CPU kernels
  (``test_torch_kernels.patch_host_math``), as the host build calls them;
  on the card both call CUDA's, which ``tools/op_sweep.py`` holds against
  PyTorch's CUDA kernels bit for bit (the ``cuda`` cases here, and
  ``chip_smoke.py`` phase 26 over all 2^32 inputs).
* against JAX (the same sets as ``jnp`` callables): roots and gradients with
  the same NaN/inf pattern; finite values within 4 ulp or 1e-6 relative,
  gradients also within 1e-6 of the tree's largest |gradient|. Where the
  two packages' gradient conventions differ, the difference itself is
  asserted on those lanes (:data:`CONVENTIONS`): a clamp at its bound
  (autograd passes the cotangent, JAX's ``minimum``/``maximum`` half of it),
  ``pow(x, y)`` at ``x == y == 0`` (autograd 0, JAX NaN), ``atan2`` where
  ``x * x + y * y`` is 0 (autograd 0, JAX non-finite), ``hypot`` at (0, 0)
  (autograd NaN, JAX a value). Where XLA's CPU math is off the correctly
  rounded value (each node in float64, rounded to float32) and the port is
  within the tolerance of it, that value decides (:data:`JAX_OFF_TRUTH`).
  The port computes with the C library's math there (``patch_host_math``):
  PyTorch's vectorised CPU ``sinh`` overflows at 89.2, where ``sinhf`` and
  the float32 result are finite.

This file imports JAX only inside the tests that compare with it.
"""
import ctypes
import dataclasses
import functools
import shutil

import numpy as np
import pytest
import torch

from multitreegp_tpu_torch import _build
from multitreegp_tpu_torch.core import cuda_adaptive as ca
from multitreegp_tpu_torch.core import cuda_interpreter as ci
from multitreegp_tpu_torch.core import cuda_policy as cp
from multitreegp_tpu_torch.core import cuda_rollout as cr
from multitreegp_tpu_torch.core import user_ops
from multitreegp_tpu_torch.core.interpreter import evaluate_trees
from multitreegp_tpu_torch.core.registry import (
    USER_FROM, build_function_set, pysr_operators, vocabulary_operators,
)
from multitreegp_tpu_torch.core.trees import TreeTensors, rebuild_pointers
from test_torch_kernels import fitness_host, patch_host_math, same_bits
from test_torch_operators import host_interpreter, policy_case, population_case, sr_case, tree_rows, ulp_gap
from test_torch_user_ops import plain_interpreter

torch.set_num_threads(1)

UNARY, BINARY = vocabulary_operators()
PYSR = pysr_operators()
ARITH = [("+", 2), ("-", 2), ("*", 2)]
# the host-build sets: + - * (the templates use * and -) and at most 29
# vocabulary operators each (within the interpreter's fixed instances, 32)
SETS = {"unary_a": ARITH + UNARY[:15], "unary_b": ARITH + UNARY[15:], "binary": ARITH + BINARY}
# every vocabulary operator in one set (user ids 17-63, the most a set holds):
# the tree kernels #1, #3, #4/#5 and #6/#7, which have no operator limit
EVERY = ARITH + UNARY + BINARY
SET_OF = {name: key for key, ops in SETS.items() for name, *_ in ops[3:]}
NAMES = tuple(SET_OF)
ARITY = {name: a for ops in SETS.values() for name, _, a in ops[3:]}

INF, NAN = float("inf"), float("nan")
# (x0, x1) at the operators' edges: zeros of both signs, the poles and
# domain ends of the inverse functions, rounding ties, x == y, the clamps'
# bounds, division by 0, overflow, infinities, NaN, a tiny product
SPECIAL = [(0.0, 0.0), (-0.0, 1.0), (1.0, 0.0), (-1.0, 2.0), (0.5, -0.5), (1.5, 2.5), (2.5, -1.5),
           (-2.5, 1.5), (2.0, 2.0), (-1.5, -1.5), (INF, 1.0), (1.0, INF), (-INF, -2.0), (NAN, 1.0),
           (1.0, NAN), (100.0, -100.0), (-100.0, 50.0), (1e-30, 1e-30), (3.0, 0.0), (-3.0, -0.0),
           (0.0, -1.0), (7.5, 2.0), (-7.5, 2.0), (0.99999994, -0.99999994), (1.0000001, 0.5),
           (10.0, 0.5), (0.5, 10.0), (-1.0, -1.0), (1.0, 1.0), (0.25, 3.0)]
L = 64
N_TEMPLATE = 8


def vocab_set(key, fns=None):
    ops = SETS[key] if fns is None else ARITH + [(n, fns[n], a) for n, _, a in SETS[key][3:]]
    return build_function_set(ops, [["x0", "x1"]], [1])


def templates(name, c):
    """Six trees around operator ``name``: its operands leaves, a product of
    a leaf, ``x0 - x1`` or a constant; its value at most multiplied once."""
    if ARITY[name] == 2:
        return [(name, "x0", "x1"), (name, "x1", c[0]), (name, c[1], "x0"), (name, "x0", "x0"),
                (name, ("*", "x0", c[2]), "x1"), ("*", c[3], (name, "x1", "x0"))]
    return [(name, "x0"), (name, ("*", "x1", c[0])), ("*", c[1], (name, "x0")),
            (name, ("-", "x0", "x1")), (name, c[2]), ("*", (name, "x1"), "x0")]


def set_case(key, fset=None, device="cpu", seed=16):
    """``(fset, trees (6 k, L, N), data (6 k, L, 2), g (6 k, L))``: the six
    templates of each of the set's k vocabulary operators (operator i's
    trees at ``6 i .. 6 i + 5``) on ``L`` data vectors, the first
    :data:`SPECIAL`, the rest half uniform on (-1.2, 1.2), half normal with
    sd 3, from ``seed`` with numpy."""
    fset = fset or vocab_set(key)
    rng = np.random.default_rng(seed)
    c = [float(v) for v in (rng.normal(size=4) * 1.5).astype(np.float32)]
    rows = [tree_rows(e, fset, N_TEMPLATE) for name, *_ in SETS[key][3:] for e in templates(name, c)]
    ops = torch.tensor([r[0] for r in rows], dtype=torch.int32)
    const = torch.tensor([r[1] for r in rows], dtype=torch.float32)
    c1, c2 = rebuild_pointers(ops, fset.slots())
    rest = L - len(SPECIAL)
    x = np.concatenate([np.asarray(SPECIAL, np.float32),
                        rng.uniform(-1.2, 1.2, size=(rest // 2, 2)).astype(np.float32),
                        (rng.normal(size=(rest - rest // 2, 2)) * 3).astype(np.float32)])
    k = len(rows)
    trees = TreeTensors(ops, c1, c2, const).map(
        lambda a: a[:, None].expand(k, L, N_TEMPLATE).contiguous().to(device))
    data = torch.from_numpy(x)[None].expand(k, L, 2).contiguous().to(device)
    g = torch.from_numpy(rng.normal(size=(k, L)).astype(np.float32)).to(device)
    return fset, trees, data, g


def trees_of(name):
    i = [n for n, *_ in SETS[SET_OF[name]][3:]].index(name)
    return slice(6 * i, 6 * i + 6)


# ------------------------------------------------------------ trace and emit

# the C expression each callable's forward must hold
FORWARD_CALL = {
    "sigmoid": "1.0f / (1.0f + expf(-x))", "erf": "erff(x)", "erfc": "erfcf(x)",
    "relu": "fmaxf(x, mtgp_user::bits(0x00000000u))", "atan": "atanf(x)", "asin": "asinf(x)",
    "acos": "acosf(x)", "asinh": "asinhf(x)", "acosh": "acoshf(x)", "atanh": "atanhf(x)",
    "sinh": "sinhf(x)", "cosh": "coshf(x)", "log1p": "log1pf(x)", "log2": "log2f(x)",
    "log10": "log10f(x)", "expm1": "expm1f(x)", "exp2": "exp2f(x)", "rsqrt": "mtgp_user::rsqrt(x)",
    "floor": "floorf(x)", "ceil": "ceilf(x)", "round": "nearbyintf(x)", "trunc": "truncf(x)",
    "clamp": "fminf(fmaxf(x, mtgp_user::bits(0xbfc00000u)), mtgp_user::bits(0x40000000u))",
    "exp_clamped": "fminf(x, mtgp_user::bits(0x41200000u))",
    "clamp_min": "fmaxf(x, mtgp_user::bits(0x3f000000u))", "sqrt_pow": "sqrtf(x)",
    "rsqrt_pow": "mtgp_user::rsqrt(x)", "inv_pow": "1.0f / x", "inv_square": "1.0f / (x * x)",
    "pow4": "powf(x, mtgp_user::bits(0x40800000u))", "pow1_5": "powf(x, mtgp_user::bits(0x3fc00000u))",
    "maximum": "fmaxf(x, y)", "minimum": "fminf(x, y)", "pow_tensor": "powf(x, y)",
    "atan2": "atan2f(x, y)", "hypot": "hypotf(x, y)", "fmod": "fmodf(x, y)",
    "remainder": "mtgp_user::remainder(x, y)", "greater": "static_cast<float>(v0)",
    "logical_or": "v0 || v1", "logical_and": "v0 && v1", "mul_inplace": "v0 * y",
    "div_floor": "mtgp_user::div_floor(x, y)", "div_trunc": "truncf(x / y)",
    "atanh_clip": "atanhf(", "fmod_scalar": "fmodf(x, mtgp_user::bits(0x3fc00000u))",
    "remainder_scalar": "mtgp_user::remainder(x, mtgp_user::bits(0xbfc00000u))",
}


@pytest.mark.parametrize("name", NAMES)
def test_vocabulary_callable_compiles(name):
    """Every vocabulary callable traces, functionalised, to nodes of the
    emitter's table: forward and VJP, no refusal; its forward is the CUDA
    call PyTorch's kernel makes."""
    fn, arity = {n: (f, a) for n, f, a in UNARY + BINARY}[name]
    op = user_ops.compile_op(name, (lambda x, y: fn(x)) if arity == 1 else fn, arity)
    assert FORWARD_CALL[name] in op.forward, op.forward
    assert "dx = " in op.vjp and "dy = " in op.vjp


def test_vocabulary_sets_take_user_ids():
    """The two sweep sets and the PySR-style set: every vocabulary operator
    a user operator (ids 17 and up), none refused, the header's prelude with
    the device/host split of ``rsqrt``."""
    unary, binary = vocabulary_operators()
    assert len(unary) <= ci.FIXED_OPS and len(binary) <= ci.FIXED_OPS
    for ops in (unary, binary):
        fset = build_function_set(ops, [["x0", "x1"]], [1])
        assert fset.refusals == ()
        assert fset.device_op_ids == tuple(range(USER_FROM, USER_FROM + len(ops)))
    fset = build_function_set(PYSR, [["x0", "x1"]], [2])
    assert fset.device_op_ids == (0, 1, 2, 3) + tuple(range(USER_FROM, USER_FROM + 7))
    assert fset.refusals == () and fset.has_unary
    assert "#ifdef __CUDA_ARCH__\n  return rsqrtf(x);\n#else\n  return 1.0f / sqrtf(x);" in fset.user_header


@pytest.mark.parametrize("exponent,expr", [
    (0, "mtgp_user::bits(0x3f800000u)"), (1, "v0 = x;"), (0.5, "sqrtf(x)"),
    (-0.5, "mtgp_user::rsqrt(x)"), (-1, "1.0f / x"), (2, "x * x"), (3, "x * x * x"),
    (-2, "1.0f / (x * x)"), (4, "powf(x, mtgp_user::bits(0x40800000u))"),
    (-3, "powf(x, mtgp_user::bits(0xc0400000u))"), (0.1, "powf(x, mtgp_user::bits(0x3dcccccdu))")])
def test_power_by_a_scalar_follows_pytorch_special_cases(exponent, expr):
    """``x ** e``: PyTorch's cases (0 fills 1, 1 copies, 0.5 sqrt, -0.5
    rsqrt, -1 the reciprocal, 2 and 3 products, -2 one over the square), any
    other exponent, rounded to float32, by ``powf``."""
    op = user_ops.compile_op("p", lambda x, y: x ** exponent, 1)
    assert expr in op.forward


def test_functionalised_forms_emit_as_their_pure_ops():
    """In-place forms (``mul_``, ``clamp_``, ``masked_fill_``) and
    ``empty_like(x).fill_(v)`` trace through ``torch.func.functionalize``:
    the pure op and a constant."""
    op = user_ops.compile_op("f", lambda x, y: x.clone().mul_(y).clamp_(min=0.0), 2)
    assert "v0 * y" in op.forward and "fmaxf(v1, mtgp_user::bits(0x00000000u))" in op.forward
    op = user_ops.compile_op("g", lambda x, y: torch.empty_like(x).fill_(2.0) - x, 2)
    assert "const float v1 = mtgp_user::bits(0x40000000u);\nconst float v2 = v1 - x;" in op.forward
    op = user_ops.compile_op("h", lambda x, y: x.clone().masked_fill_(y > 0, 1.0), 2)
    assert "? mtgp_user::bits(0x3f800000u) : " in op.forward


@pytest.mark.parametrize("fn,expr", [
    (lambda x: torch.special.i0(x), "mtgp_user::t_i0(x)"), (lambda x: torch.lgamma(x), "lgammaf(x)"),
    (lambda x: torch.digamma(x), "mtgp_user::t_digamma(x)"),
    (lambda x: torch.special.erfcx(x), "mtgp_user::t_erfcx(x)"),
    (lambda x: torch.div(x, 2.0, rounding_mode="floor"), "mtgp_user::div_floor_scalar(x, "),
    (lambda x: 2.0 ** x, "powf(mtgp_user::bits(0x40000000u), x)"),
    (lambda x: torch.clamp(x, x * 0.5, x + 1.0), "mtgp_user::clamp_tensor(x, v0, v1)"),
    (lambda x: torch.round(x, decimals=2), "nearbyintf(x * mtgp_user::bits(0x42c80000u))")])
def test_formerly_refused_forms_compile(fn, expr):
    """Forms the emitter once refused (the special functions ``i0``,
    ``lgamma``, whose VJP is ``digamma``, and ``erfcx``; a rounded division
    by a scalar; a scalar base; tensor bounds; rounding to decimals) compile
    into a user operator with its VJP."""
    fset = build_function_set([("+", 2), ("emitted", fn, 1)], [["x0"]], [1])
    assert fset.device_op_ids == (0, USER_FROM) and fset.refusals == ()
    assert expr in fset.user_header


@pytest.mark.parametrize("fn,reason", [
    (lambda x: x.mul_(2.0), "writes into its own inputs"),
    (lambda x: x // 2.0, "does not trace"),
    (lambda x: (x.double() * 2).float(), "computes in torch.float64"),
    (lambda x: (x > 0).to(torch.int32).float(), "computes in torch.int32"),
    (lambda x: x * torch.tensor([2.0] * 8), "tensor constant with a lane axis"),
    (lambda x: x * torch.tensor(2.0, dtype=torch.float64), "tensor constant of dtype torch.float64"),
    (lambda x: x - x.mean(), "reduces over the lanes"),
    (lambda x: x + torch.rand_like(x), "draws random numbers"),
    (lambda x: torch.heaviside(x, x), "derivative for aten::heaviside is not implemented"),
    (lambda x: torch.special.gammainc(x, x), "does not trace"),
    (lambda x: torch.special.zeta(x, 2.0), "does not trace"),
    (lambda x: x if bool(x.sum() > 0) else -x, "does not trace")])
def test_what_stays_refused(fn, reason):
    """What JAX or autograd cannot run either, so the plain VJP could not:
    writes into the inputs, ops without an autograd derivative (``//``,
    ``heaviside``, ``igamma``, ``zeta`` in its first argument), non-float32
    values, tensor constants with a lane axis or of another dtype,
    reductions, random draws, Python control flow on values: refused with
    the reason; the set runs on the CPU only, and the kernels raise."""
    fset = build_function_set([("+", 2), ("refused", fn, 1)], [["x0"]], [1])
    assert fset.device_op_ids == (0, -1) and fset.user_header == ""
    with pytest.raises(NotImplementedError, match="refused") as err:
        fset.require_device_ops()
    assert reason in str(err.value), str(err.value)


# ----------------------------------------------- host builds: #8/#9 bit for bit

@pytest.fixture(scope="module")
def user_host(tmp_path_factory):
    if shutil.which("g++") is None and shutil.which("c++") is None:
        pytest.skip("no host C++ compiler")
    out = tmp_path_factory.mktemp("vocab_host")
    made = {}

    def get(name, fset):
        key = (name, fset.user_hash)
        if key not in made:
            made[key] = _build.build_host(name, out, fset.variant)
        return made[key]

    return get


@pytest.fixture(scope="module")
def host_vs_plain(user_host):
    """Per set: ``(host build's (roots, dconst, ddata), plain's)`` on
    :func:`set_case`, computed once."""
    done = {}

    def get(key):
        if key not in done:
            fset, trees, data, g = set_case(key)
            got = host_interpreter(user_host("interpreter", fset), trees, data, g, fset)
            with pytest.MonkeyPatch.context() as m:
                want = plain_interpreter(trees, data, g, fset, m)
            done[key] = got, want, data
        return done[key]

    return get


@pytest.mark.parametrize("name", NAMES)
def test_interpreter_host_build_bit_exact(host_vs_plain, name):
    """#8/#9's user host build on each operator's six trees, per lane:
    roots, ``dconst`` and ``ddata`` bit for bit with autograd's formulas
    (NaN lanes as NaN)."""
    got, want, _ = host_vs_plain(SET_OF[name])
    s = trees_of(name)
    for a, b, what in zip(got, want, ("roots", "dconst", "ddata")):
        assert same_bits(a[s], b[s]), what
    assert torch.isfinite(want[0][s]).any()


@pytest.mark.parametrize("n,depth", [(32, 5), (256, 7)])
def test_interpreter_host_build_population_bit_exact(user_host, monkeypatch, n, depth):
    """The N <= 32 and N <= 256 instances on trees sampled from the
    PySR-style set, in the recompute's layout."""
    fset, trees, data, g = population_case(n, depth, k=12 if n > 32 else 24, ops=PYSR)
    got = host_interpreter(user_host("interpreter", fset), trees, data, g, fset)
    want = plain_interpreter(trees, data, g, fset, monkeypatch)
    assert all(same_bits(a, b) for a, b in zip(got, want))
    assert int((trees.ops >= fset.string_to_op["sigmoid"]).sum()) > 20


# ------------------------------------ host builds: #1, #3, #4/#5, #6/#7

def test_fitness_host_build_bit_exact(user_host, monkeypatch):
    """#1 (``sr_fitness.cu``, RK4) on every vocabulary operator."""
    fset, trees, x0s, ts, ys = sr_case(ops=EVERY)
    with monkeypatch.context() as m:
        patch_host_math(m)
        mse, alive = cr.sr_fitness_plain(trees, x0s, ts, ys, fset, "rk4", 1)
    err, alive_h = fitness_host(user_host("sr_fitness", fset), trees, x0s, ts, ys, fset, "rk4", 1)
    np.testing.assert_array_equal(alive_h, alive.numpy())
    np.testing.assert_array_equal(err, mse.numpy())
    assert alive.any()


def test_rollout_host_build_bit_exact(user_host, monkeypatch):
    """#3 (``sr_rollout.cu``, RK4 x 2) on every vocabulary operator."""
    fset, trees, x0s, ts, _ = sr_case(ops=EVERY)
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
    """#5 (global budget) and #4 (per interval), dopri5, on every
    vocabulary operator."""
    fset, trees, x0s, ts, ys = sr_case(pop=12, t_end=1.0, ops=EVERY)
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
def policy_vocab(user_host):
    _, fset, _, _ = policy_case(0, ops=EVERY)
    lib = user_host("policy", fset)
    lib.policy_host.argtypes = [ctypes.c_int, ctypes.c_void_p]
    lib.policy_host.restype = ctypes.c_int
    return lib


@pytest.mark.parametrize("kind,state_size", [(cp.FIXED, 0), (cp.FIXED, 2), (cp.ADAPTIVE, 0)])
def test_policy_host_build_bit_exact(policy_vocab, monkeypatch, kind, state_size):
    """#6 (RK4 x 2; static and dynamic) and #7 (dopri5, 8 steps per
    interval) on Acrobot policies of every vocabulary operator."""
    env, fset, (x0, ts, tgt, _, _, par), trees = policy_case(
        state_size, ops=EVERY, pop=8, t_end=1.6 if kind == cp.FIXED else 1.2)
    with monkeypatch.context() as m:
        patch_host_math(m)
        if kind == cp.FIXED:
            want = cp.policy_rollout_plain(trees, x0, ts, tgt, par, env, fset, 2, "rk4", state_size)
        else:
            want = cp.policy_rollout_adaptive_plain(trees, x0, ts, tgt, par, env, fset, 1e-4, 1e-4, 8,
                                                    "dopri5", 0.9, 0)
    args = (trees, x0, ts, tgt, par, env, fset, state_size)
    if kind == cp.FIXED:
        status, hxs, hus, count, _ = cp.run_policy(
            lambda a: policy_vocab.policy_host(kind, a), kind, *args, "rk4", 2)
    else:
        status, hxs, hus, count, hsteps = cp.run_policy(
            lambda a: policy_vocab.policy_host(kind, a), kind, *args, "dopri5", max_steps=8,
            rtol=1e-4, atol=1e-4, safety=0.9)
        assert torch.equal(hsteps, want[3])
    assert status == 0
    assert same_bits(hxs, want[0]) and same_bits(hus, want[1])
    assert torch.equal(cp._alive_rows(count, ts.shape[0]), want[2])


# ------------------------------------------------------------ against JAX

def jax_counterparts():
    """The vocabulary as ``jnp`` callables (name -> fn)."""
    import jax
    import jax.numpy as jnp
    import jax.scipy.special as jss

    f32 = lambda b: b.astype(jnp.float32)
    return {
        "sigmoid": jax.nn.sigmoid, "erf": jss.erf, "erfc": jss.erfc, "relu": jax.nn.relu,
        "atan": jnp.arctan, "asin": jnp.arcsin, "acos": jnp.arccos, "asinh": jnp.arcsinh,
        "acosh": jnp.arccosh, "atanh": jnp.arctanh, "sinh": jnp.sinh, "cosh": jnp.cosh,
        "log1p": jnp.log1p, "log2": jnp.log2, "log10": jnp.log10, "expm1": jnp.expm1,
        "exp2": jnp.exp2, "rsqrt": jax.lax.rsqrt, "floor": jnp.floor, "ceil": jnp.ceil,
        "round": jnp.round, "trunc": jnp.trunc, "clamp": lambda x: jnp.clip(x, -1.5, 2.0),
        "exp_clamped": lambda x: jnp.exp(jnp.clip(x, max=10.0)),
        # PyTorch's x ** 0.5 and x ** -0.5 are sqrt and rsqrt (NaN at -inf,
        # where an IEEE pow gives inf and 0)
        "clamp_min": lambda x: jnp.clip(x, min=0.5), "sqrt_pow": jnp.sqrt,
        "rsqrt_pow": jax.lax.rsqrt, "inv_pow": lambda x: jnp.power(x, -1),
        "inv_square": lambda x: jnp.power(x, -2), "pow4": lambda x: jnp.power(x, 4),
        "pow1_5": lambda x: jnp.power(x, 1.5), "maximum": jnp.maximum, "minimum": jnp.minimum,
        "pow_tensor": jnp.power, "atan2": jnp.arctan2, "hypot": jnp.hypot, "fmod": jnp.fmod,
        "remainder": jnp.remainder, "greater": lambda x, y: f32(x > y),
        "logical_or": lambda x, y: f32((x > 0) | (y > 0)),
        "logical_and": lambda x, y: f32((x > 0) & (y > 0)), "mul_inplace": jnp.multiply,
        # by 0 PyTorch divides (+-inf), jnp.floor_divide gives NaN; no gradient
        "div_floor": lambda x, y: jnp.where(y == 0, jax.lax.stop_gradient(x / y), jnp.floor_divide(x, y)),
        "div_trunc": lambda x, y: jnp.trunc(x / y),
        "atanh_clip": lambda x: jnp.arctanh(jnp.remainder(x + 1.0, 2.0) - 1.0),
        "fmod_scalar": lambda x: jnp.fmod(x, 1.5), "remainder_scalar": lambda x: jnp.remainder(x, -1.5),
    }


@functools.lru_cache(maxsize=None)
def jax_vs_port_case(key):
    """``(port's (roots, dconst, ddata), JAX's, data, g)`` on
    :func:`set_case` of set ``key``, the port's set converted from the JAX
    one (``convert.function_set_from_jax``)."""
    import jax
    import jax.numpy as jnp
    from multitreegp_tpu.core.interpreter import evaluate_trees as jax_evaluate
    from multitreegp_tpu.core.registry import build_function_set as jax_function_set
    from multitreegp_tpu.core.trees import TreeTensors as JaxTrees
    from multitreegp_tpu_torch.convert import function_set_from_jax

    jfns = jax_counterparts()
    base = {"+": jnp.add, "-": jnp.subtract, "*": jnp.multiply}
    jf = jax_function_set([(n, base[n], 2, 1.0) for n, _ in ARITH]
                          + [(n, jfns[n], a, 1.0) for n, _, a in SETS[key][3:]], [["x0", "x1"]], [1])
    fset = function_set_from_jax(jf, {n: f for n, f, _ in SETS[key][3:]})
    assert fset.device_op_ids == vocab_set(key).device_op_ids
    _, trees, data, g = set_case(key, fset)
    ev = jax.jit(lambda t, d: jax_evaluate(JaxTrees(*t), d, jf, impl="gather"))
    t = [np.asarray(a) for a in trees]
    d, gg = data.numpy(), g.numpy()
    grad = jax.jit(jax.grad(lambda c, d: (ev((*t[:3], c), d) * gg).sum(), argnums=(0, 1)))
    want = (np.asarray(ev(t, d)),) + tuple(np.asarray(x) for x in grad(t[3], d))
    with pytest.MonkeyPatch.context() as m:
        patch_host_math(m)
        got = value_and_grads(trees, data, g, fset)
    # every node in float64, rounded to float32: the correctly rounded
    # value of each operator on the same float32 operands (and cotangents)
    rounded = lambda f: lambda x, y: f(x, y).float().double()
    truth = value_and_grads(trees, data, g, dataclasses.replace(
        fset, operator_fns=tuple(rounded(f) for f in fset.operator_fns)), torch.float64)
    return got, want, truth, d, gg


def value_and_grads(trees, data, g, fset, dtype=torch.float32):
    """``(roots, dconst, ddata)`` of the port's plain version
    (``evaluate_trees`` and autograd) in ``dtype``."""
    const = trees.const.to(dtype).requires_grad_(True)
    x = data.to(dtype).requires_grad_(True)
    out = evaluate_trees(trees._replace(const=const), x, fset)
    grads = torch.autograd.grad(out, (const, x), g.to(dtype))
    return tuple(v.detach().numpy() for v in (out,) + grads)


@pytest.fixture(scope="module")
def jax_vs_port():
    pytest.importorskip("jax")
    return jax_vs_port_case


def template_operands(name, xs, seed=16):
    """The operands ``(u, v)`` (float32, ``(6, L)``) of operator ``name`` in
    each of its six :func:`templates` on the data ``xs (6, L, 2)`` (``v`` is
    None for a unary operator)."""
    c = (np.random.default_rng(seed).normal(size=4) * 1.5).astype(np.float32)
    x0, x1 = xs[0, :, 0], xs[0, :, 1]
    with np.errstate(all="ignore"):
        if ARITY[name] == 2:
            u = [x0, x1, np.full_like(x0, c[1]), x0, x0 * c[2], x1]
            v = [x1, np.full_like(x0, c[0]), x0, x0, x1, x0]
            return np.stack(u), np.stack(v)
        return np.stack([x0, x1 * c[0], x0, x0 - x1, np.full_like(x0, c[2]), x1]), None


# where autograd's and JAX's gradient conventions differ: operator ->
# (lanes, by the operator's operands u, v; the difference on them, port's
# cotangent p against JAX's j)
CONVENTIONS = {
    # a clamp at its bound: autograd's where(lo <= x <= hi) passes the
    # cotangent, JAX's jnp.clip (maximum / minimum) passes half of it at a tie
    "clamp": (lambda u, v: (u == np.float32(-1.5)) | (u == np.float32(2.0)), lambda p, j: close(p, 2 * j)),
    "exp_clamped": (lambda u, v: u == np.float32(10.0), lambda p, j: close(p, 2 * j)),
    "clamp_min": (lambda u, v: u == np.float32(0.5), lambda p, j: close(p, 2 * j)),
    # d pow(x, y) at x == y == 0: autograd 0 (its where(y == 0) and
    # where(x == 0 & y >= 0)), JAX NaN
    "pow_tensor": (lambda u, v: (u == 0) & (v == 0), lambda p, j: (p == 0) & np.isnan(j)),
    # atan2 where x * x + y * y is 0 in float32: autograd masks the
    # reciprocal to 0, JAX divides by 0
    "atan2": (lambda u, v: u * u + v * v == 0, lambda p, j: (p == 0) & ~np.isfinite(j)),
    # hypot at (0, 0): autograd's x / hypot is 0 / 0, JAX defines a value
    "hypot": (lambda u, v: (u == 0) & (v == 0), lambda p, j: np.isnan(p) & np.isfinite(j)),
}
# operators on whose inputs here JAX on the CPU is farther than the tolerance
# from the correctly rounded value and the port is within it: XLA flushes
# subnormal results to 0 (erfc's tail, exp of a clamp), loses a few 1e-6 in
# erfc's tail and in sinh, cosh and exp2 at large arguments, and overflows
# in hypot's gradient at (1e-30, 1e-30)
JAX_OFF_TRUTH = {"erfc", "sinh", "cosh", "exp2", "exp_clamped", "hypot"}


def close(a, b, atol=0.0):
    """Elementwise: NaN at both, equal (infinities too), or finite within 4
    ulp, 1e-6 relative or ``atol``."""
    a, b = np.asarray(a, np.float32), np.asarray(b, np.float32)
    with np.errstate(all="ignore"):
        fin = np.isfinite(a) & np.isfinite(b)
        near = fin & ((ulp_gap(np.where(fin, a, 0), np.where(fin, b, 0)) <= 4)
                      | (np.abs(a - b) <= 1e-6 * np.abs(b)) | (np.abs(a - b) <= atol))
    return (np.isnan(a) & np.isnan(b)) | (a == b) | near


@pytest.mark.parametrize("name", NAMES)
def test_operator_matches_jax(jax_vs_port, name):
    """Each vocabulary operator's six trees against the JAX package with the
    ``jnp`` counterpart: roots and gradients, the same NaN/inf pattern;
    finite values within 4 ulp or 1e-6 relative, gradients also within 1e-6
    of the tree's largest |gradient|. The port computes with the C library's
    math (``patch_host_math``, as its kernels on the host). Lanes where the
    gradient conventions differ (:data:`CONVENTIONS`) hold that difference;
    for :data:`JAX_OFF_TRUTH` an element may part from JAX where the port is
    within the tolerance of the float64 value and JAX is not."""
    got, want, truth, xs, g = jax_vs_port(SET_OF[name])
    s = trees_of(name)
    got, want, truth, xs = [v[s] for v in got], [v[s] for v in want], [v[s] for v in truth], xs[s]
    fin = np.isfinite(got[0]) & np.isfinite(want[0])  # (6, L): gradients of finite roots
    u, v = template_operands(name, xs)
    at = CONVENTIONS[name][0](u, v) if name in CONVENTIONS else np.zeros(fin.shape, bool)
    seen = off_seen = 0
    for w, (p, j, t) in enumerate(zip(got, want, truth)):
        for k in range(6):
            lanes = slice(None) if w == 0 else fin[k]
            with np.errstate(over="ignore"):
                pk, jk, tk = p[k][lanes], j[k][lanes], np.asarray(t[k][lanes], np.float32)
            finite = jk[np.isfinite(jk)]
            atol = 1e-6 * float(np.abs(finite).max()) if w and finite.size else 0.0
            ok = close(pk, jk, atol)
            if w and name in CONVENTIONS:
                conv = at[k][lanes].reshape((-1,) + (1,) * (pk.ndim - 1)) & CONVENTIONS[name][1](pk, jk)
                seen += int((conv & ~ok).sum())
                ok |= conv
            if name in JAX_OFF_TRUTH:
                off = ~ok & close(pk, tk, atol) & ~close(jk, tk, atol)
                off_seen += int(off.sum())
                ok |= off
            assert ok.all(), (["roots", "dconst", "ddata"][w], k, pk[~ok], jk[~ok], tk[~ok])
    # each difference listed is there on these data
    assert (seen > 0) == (name in CONVENTIONS) and (off_seen > 0) == (name in JAX_OFF_TRUTH)
    assert torch.isfinite(torch.from_numpy(got[0])).any()


# ------------------------------------------------------------------ the card

@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU (CUDA kernels have no CPU mode)")
    return torch.device("cuda")


@pytest.mark.cuda
def test_sweep_matches_pytorch_cuda_on_card(cuda):
    """#8/#9 through the vocabulary sets' user build against PyTorch's CUDA
    ops (``tools/op_sweep``): each unary operator's forward on every 4096th
    bit pattern (``chip_smoke.py`` phase 26 sweeps all 2^32), its VJP on
    every 4096th, the binary ones on a 1024 x 1024 grid plus the edges:
    equal bits forward, equal values VJP, NaN as NaN."""
    from multitreegp_tpu_torch.tools import op_sweep

    results = []
    for fset in op_sweep.sweep_sets():
        results += op_sweep.sweep_set(fset, cuda, stride=4096, side=1024)
    bad = {r["name"]: (r["first"], r["vjp"]) for r in results if not r["ok"]}
    assert not bad, bad
    assert len(results) == len(UNARY) + len(BINARY)


@pytest.mark.cuda
def test_vocabulary_tree_kernels_match_plain_on_card(cuda):
    """#1, #3, #5, #4, #6 and #7 on every vocabulary operator (their user
    builds of that set, which ``chip_smoke.py`` does not make): every lane
    bit for bit against the plain version on the card, launch counters."""
    to = lambda t: t.to(cuda)
    fset, trees, x0s, ts, ys = sr_case(pop=256, b=16, t_end=2.0, seed=4, ops=EVERY)
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
    fset, trees, x0s, ts, ys = sr_case(pop=256, b=16, t_end=1.0, seed=4, ops=EVERY)
    trees, x0s, ts, ys = trees.map(to), to(x0s), to(ts), to(ys)
    for fn, plain, budget in ((ca.sr_fitness_adaptive_global_cuda, ca.sr_fitness_adaptive_global_plain, 40),
                              (ca.sr_fitness_adaptive_interval_cuda,
                               ca.sr_fitness_adaptive_interval_plain, 8)):
        got = fn(trees, x0s, ts, ys, fset, 1e-4, 1e-6, budget, "dopri5")
        want = plain(trees, x0s, ts, ys, fset, 1e-4, 1e-6, budget, "dopri5")
        torch.cuda.synchronize()
        assert same_bits(got[0], want[0]) and torch.equal(got[1], want[1]) and torch.equal(got[2], want[2])
    for state_size in (0, 2):
        env, pf, (x0, pts, tgt, _, _, par), pol = policy_case(state_size, cuda, pop=64, b=16,
                                                               ops=EVERY)
        before = cp.policy_rollout_cuda.launches
        got = cp.rollout_policy(pol, x0, pts, tgt, par, env, pf, 2, "rk4", state_size)
        want = cp.policy_rollout_plain(pol, x0, pts, tgt, par, env, pf, 2, "rk4", state_size)
        torch.cuda.synchronize()
        assert cp.policy_rollout_cuda.launches == before + 1
        assert same_bits(got[0], want[0]) and same_bits(got[1], want[1]) and torch.equal(got[2], want[2])
    env, pf, (x0, pts, tgt, _, _, par), pol = policy_case(0, cuda, pop=64, b=16, t_end=1.2,
                                                          ops=EVERY)
    got = cp.policy_rollout_adaptive_cuda(pol, x0, pts, tgt, par, env, pf, max_steps=8)
    want = cp.policy_rollout_adaptive_plain(pol, x0, pts, tgt, par, env, pf, 1e-4, 1e-4, 8)
    torch.cuda.synchronize()
    assert all(same_bits(a, b) for a, b in zip(got[:2], want[:2]))
    assert torch.equal(got[2], want[2]) and torch.equal(got[3], want[3])
