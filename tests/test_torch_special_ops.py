"""PyTorch port: special functions, activations, scalar bases, tensor clamp
bounds and 0-d constants in every tree kernel and traced plant, and function
sets past 63 device op ids.

Each callable of ``registry.special_operators()`` (``2 ** x``, rounded
division by a scalar, rounding to decimals, a 0-d tensor constant,
``lgamma``, ``digamma``, ``polygamma``, the Bessel functions ``i0``/``i0e``/
``i1``/``i1e``, ``erfcx``, ``erfinv``, ``ndtri``, ``log_ndtr``, ``entr``,
``logit``, ``sinc``, the activations, ``frac``, ``deg2rad``/``rad2deg``,
``nan_to_num``; clamps by tensors, ``xlogy``/``xlog1py``, ``logaddexp``/
``logaddexp2``, ``copysign``, ``fmax``/``fmin``, ``ldexp``) traces into
generated code with its VJP (``core/user_ops.py``, the helpers of
``csrc/user_math.cuh``).

Tolerances, and why:

* the user host builds (g++) of #8/#9 on six trees around each operator,
  of #1, #3, #4/#5 and #6/#7 on a set of the special functions, of #8/#9's
  wide instance and #2 on a set of every vocabulary operator (user ids past
  63), and of #6 on a traced plant with tensor clamp bounds and a
  ``softplus`` term, against the plain version: bit for bit per lane (equal
  values, NaN where the other has NaN), forward and VJP, with the C
  library's functions under PyTorch's CPU kernels (``patch_host_math``, and
  :func:`patch_special_math` for ``pow(2.0, x)``, ``lgamma`` and
  ``softplus``, which the CPU computes with SLEEF). Where PyTorch's vectorised CPU kernel computes
  with SLEEF inside one op (:data:`SLEEF_OPS`: the activations, ``logit``,
  ``logaddexp``) or with glibc's vector ``erff`` (``erfinv``), the host
  build (the kernel's scalar formula with the C library) is held within
  :data:`SLEEF_ULP` ulp; where the CPU's vectorised and scalar paths part
  (:data:`CPU_SPLIT`: ``gelu`` at +-inf, NaN in the VJPs of ``hardtanh``,
  ``hardswish`` and ``softshrink``, the sign of ``softshrink``'s 0), those
  lanes are left out. On the card both sides are CUDA: ``tools/op_sweep.py``
  holds the generated code against PyTorch's CUDA ops bit for bit (the
  ``cuda`` cases here, ``chip_smoke.py`` phase 30 over all 2^32 inputs).
* against JAX (the same sets as ``jnp`` callables, ``jax.scipy.special``,
  ``jax.nn`` with ``approximate=False`` for ``gelu``): roots and gradients
  of finite roots with the same NaN/inf pattern; finite values within 4 ulp
  or 1e-6 relative, gradients also within 1e-6 of the tree's largest
  |gradient|. Where the packages' conventions differ, the difference is
  asserted on those lanes (:data:`CONVENTIONS`). Where the packages part by
  more (:data:`OFF_TRUTH`: the float32 series and VJPs of lgamma, erfinv,
  ndtri, log_ndtr, mish, gelu, digamma, trigamma, polygamma, sinc),
  the port is held to the correctly rounded value instead: within the
  tolerance above, or within the operator's stated ulp (up to 512; sinc's
  VJP 2^18, where autograd's float32 formula cancels near 0). ``erfcx``,
  which JAX lacks, is held against ``scipy.special.erfcx`` in float64
  within 4 ulp.

This file imports JAX only inside the tests that compare with it.
"""
import ctypes
import dataclasses
import functools
import shutil
import subprocess
import tempfile
from pathlib import Path

import numpy as np
import pytest
import torch
import torch.nn.functional as F

from multitreegp_tpu_torch import _build
from multitreegp_tpu_torch.core import cuda_adaptive as ca
from multitreegp_tpu_torch.core import cuda_interpreter as ci
from multitreegp_tpu_torch.core import cuda_policy as cp
from multitreegp_tpu_torch.core import cuda_rollout as cr
from multitreegp_tpu_torch.core import user_envs, user_ops
from multitreegp_tpu_torch.core.interpreter import evaluate_trees_plain, evaluate_trees_vjp_plain
from multitreegp_tpu_torch.core.registry import (
    FIXED_MAX_OP, USER_FROM, build_function_set, special_operators, whole_vocabulary,
)
from multitreegp_tpu_torch.core.trees import TreeTensors, rebuild_pointers
from multitreegp_tpu_torch.ops.initialization import make_population_sampler
from multitreegp_tpu_torch.core.cuda_reproduction import reproduce_lanes_plain
from test_torch_kernels import (
    fitness_host, patch_host_math, per_lane_operands, reproduce_case, reproduce_host, same_bits,
)
from test_torch_operators import policy_case, sr_case, tree_rows, ulp_gap
from test_torch_user_env import Pendulum, assert_same, kernel_kw, plain
from test_torch_user_env import policy_case as env_policy_case
from test_torch_user_env import run_host
from test_torch_user_vocab import close
from test_torch_wide_state import fitness_wide

torch.set_num_threads(1)

UNARY_A, UNARY_B, BINARY = special_operators()
ARITH = [("+", 2), ("-", 2), ("*", 2)]
SETS = {"unary_a": ARITH + UNARY_A, "unary_b": ARITH + UNARY_B, "binary": ARITH + BINARY}
SET_OF = {name: key for key, ops in SETS.items() for name, *_ in ops[3:]}
NAMES = tuple(SET_OF)
ARITY = {name: a for ops in SETS.values() for name, _, a in ops[3:]}
FN = {name: f for ops in SETS.values() for name, f, _ in ops[3:]}
# the special functions, whose CPU kernels are the scalar formulas: the set
# of the rollout kernels' host builds
EXACT = ARITH + [(n, FN[n], ARITY[n]) for n in (
    "digamma", "trigamma", "i0e", "i1", "i1e", "erfcx", "ndtri", "log_ndtr", "sinc", "frac",
    "nan_to_num", "tensor_constant", "div_floor_scalar", "round_decimals", "leaky_relu", "hardtanh",
    "hardsigmoid", "xlogy", "copysign", "fmax", "clamp_tensor")]
# every vocabulary operator: user ids 17 to 112
EVERY = ARITH + whole_vocabulary()

INF, NAN = float("inf"), float("nan")
# (x0, x1) at the operators' edges: zeros of both signs, poles of the gamma
# functions, the Bessel and erfcx branch points (8, 50, -6.1, -26.7), the
# hard activations' kinks (+-3, +-1, +-0.5), logit's and erfinv's domain
# ends, infinities, NaN
SPECIAL = [(0.0, 0.0), (-0.0, 1.0), (1.0, 0.0), (-1.0, 2.0), (0.5, -0.5), (-0.5, 0.5), (1.5, 2.5),
           (-2.5, -1.5), (3.0, 3.0), (-3.0, 0.25), (8.0, -8.0), (55.0, -2.0), (-6.5, 3.0),
           (-30.0, 0.75), (0.99999994, -0.99999994), (INF, 1.0), (-INF, 2.0), (1.0, INF), (NAN, 1.0),
           (1.0, NAN), (2.0, 2.0), (-2.0, -0.5), (0.1, 0.9), (0.25, -3.0), (10.0, 0.5), (-1.5, -2.0),
           (6.0, -6.0), (1e-30, 1e-30), (0.75, 4.0), (-0.25, 1e-3)]
L = 64
N_TEMPLATE = 8

# forward expressions: the CUDA form each callable's forward must name
FORWARD_CALL = {
    "pow_base": "powf(mtgp_user::bits(0x40000000u), x)",
    "div_floor_scalar": "mtgp_user::div_floor_scalar(x, mtgp_user::bits(0x3fc00000u), mtgp_user::bits(0x3f2aaaabu))",
    "div_trunc_scalar": "mtgp_user::div_trunc_scalar(x, mtgp_user::bits(0x3fc00000u), mtgp_user::bits(0x3f2aaaabu))",
    "round_decimals": "nearbyintf(x * mtgp_user::bits(0x42c80000u)) / mtgp_user::bits(0x42c80000u)",
    "tensor_constant": "mtgp_user::div_cpu_scalar(x, mtgp_user::bits(0x40400000u), mtgp_user::bits(0x3eaaaaabu))",
    "lgamma": "lgammaf(x)",
    "digamma": "mtgp_user::t_digamma(x)", "trigamma": "mtgp_user::t_trigamma(x)",
    "polygamma2": "mtgp_user::t_polygamma(2, x)", "i0": "mtgp_user::t_i0(x)", "i0e": "mtgp_user::t_i0e(x)",
    "i1": "mtgp_user::t_i1(x)", "i1e": "mtgp_user::t_i1e(x)", "erfcx": "mtgp_user::t_erfcx(x)",
    "erfinv": "mtgp_user::t_erfinv(x)", "ndtri": "mtgp_user::t_ndtri(x)", "log_ndtr": "mtgp_user::t_log_ndtr(x)",
    "entr": "mtgp_user::t_entr(x)", "logit": "mtgp_user::t_logit(x)", "sinc": "mtgp_user::t_sinc(x)",
    "softplus": "mtgp_user::t_softplus(x, mtgp_user::bits(0x3f800000u), mtgp_user::bits(0x41a00000u))",
    "gelu": "mtgp_user::t_gelu(x)", "gelu_tanh": "mtgp_user::t_gelu_tanh(x)", "silu": "mtgp_user::t_silu(x)",
    "mish": "mtgp_user::t_mish(x)",
    "elu": "mtgp_user::t_elu(x, mtgp_user::bits(0x3f800000u), mtgp_user::bits(0x3f800000u), mtgp_user::bits(0x3f800000u))",
    "selu": "mtgp_user::t_elu(x, mtgp_user::bits(0x3fe10966u), mtgp_user::bits(0x3f867d5fu), mtgp_user::bits(0x3f800000u))",
    "celu": "mtgp_user::t_elu(x, mtgp_user::bits(0x3fc00000u), mtgp_user::bits(0x3f800000u), mtgp_user::bits(0x3f2aaaabu))",
    "leaky_relu": "(x > 0.0f ? x : x * mtgp_user::bits(0x3c23d70au))",
    "hardtanh": "(x != x ? x : fminf(fmaxf(x, mtgp_user::bits(0xbf800000u)), mtgp_user::bits(0x3f800000u)))",
    "hardswish": "mtgp_user::t_hardswish(x)", "hardsigmoid": "mtgp_user::t_hardsigmoid(x)",
    "logsigmoid": "mtgp_user::t_log_sigmoid(x)", "softshrink": "mtgp_user::t_softshrink(x, mtgp_user::bits(0x3f000000u))",
    "frac": "(x - truncf(x))", "deg2rad": "x * mtgp_user::bits(0x3c8efa35u)", "rad2deg": "x * mtgp_user::bits(0x42652ee1u)",
    "nan_to_num": "(x != x ? mtgp_user::bits(0x00000000u) : (x == INFINITY ? mtgp_user::bits(0x7f7fffffu)",
    "clamp_tensor": "mtgp_user::clamp_tensor(x, ", "clamp_min_tensor": "fmaxf(x, y)",
    "clamp_max_tensor": "fminf(x, y)", "xlogy": "mtgp_user::t_xlogy(x, y)", "xlog1py": "mtgp_user::t_xlog1py(x, y)",
    "logaddexp": "mtgp_user::t_logaddexp(x, y)", "logaddexp2": "mtgp_user::t_logaddexp2(x, y)",
    "copysign": "copysignf(x, y)", "fmax": "fmaxf(x, y)", "fmin": "fminf(x, y)",
    "ldexp": "x * powf(mtgp_user::bits(0x40000000u), y)",
}


def special_set(key, fns=None):
    ops = SETS[key] if fns is None else ARITH + [(n, fns[n], a) for n, _, a in SETS[key][3:]]
    return build_function_set(ops, [["x0", "x1"]], [1])


def templates(name, c):
    """Six trees around operator ``name`` (as ``test_torch_user_vocab``)."""
    if ARITY[name] == 2:
        return [(name, "x0", "x1"), (name, "x1", c[0]), (name, c[1], "x0"), (name, "x0", "x0"),
                (name, ("*", "x0", c[2]), "x1"), ("*", c[3], (name, "x1", "x0"))]
    return [(name, "x0"), (name, ("*", "x1", c[0])), ("*", c[1], (name, "x0")),
            (name, ("-", "x0", "x1")), (name, c[2]), ("*", (name, "x1"), "x0")]


def set_case(key, fset=None, seed=21):
    """``(fset, trees (6 k, L, N), data (6 k, L, 2), g (6 k, L))``: the six
    templates of each of the set's k operators on ``L`` data vectors, the
    first :data:`SPECIAL`, the rest half uniform on (-1.2, 1.2), half
    normal with sd 4, from ``seed`` with numpy."""
    fset = fset or special_set(key)
    rng = np.random.default_rng(seed)
    c = [float(v) for v in (rng.normal(size=4) * 1.5).astype(np.float32)]
    rows = [tree_rows(e, fset, N_TEMPLATE) for name, *_ in SETS[key][3:] for e in templates(name, c)]
    ops = torch.tensor([r[0] for r in rows], dtype=torch.int32)
    const = torch.tensor([r[1] for r in rows], dtype=torch.float32)
    c1, c2 = rebuild_pointers(ops, fset.slots())
    rest = L - len(SPECIAL)
    x = np.concatenate([np.asarray(SPECIAL, np.float32),
                        rng.uniform(-1.2, 1.2, size=(rest // 2, 2)).astype(np.float32),
                        (rng.normal(size=(rest - rest // 2, 2)) * 4).astype(np.float32)])
    k = len(rows)
    trees = TreeTensors(ops, c1, c2, const).map(lambda a: a[:, None].expand(k, L, N_TEMPLATE).contiguous())
    data = torch.from_numpy(x)[None].expand(k, L, 2).contiguous()
    g = torch.from_numpy(rng.normal(size=(k, L)).astype(np.float32))
    return fset, trees, data, g


def trees_of(name):
    i = [n for n, *_ in SETS[SET_OF[name]][3:]].index(name)
    return slice(6 * i, 6 * i + 6)


# ------------------------------------------------------------ trace and emit

@pytest.mark.parametrize("name", NAMES)
def test_special_callable_compiles(name):
    """Every callable traces, functionalised, to nodes of the emitter's
    table, forward and VJP, with no refusal; its forward is the CUDA form of
    PyTorch's kernel, and the header holds the helpers it calls."""
    fn, arity = FN[name], ARITY[name]
    op = user_ops.compile_op(name, (lambda x, y: fn(x)) if arity == 1 else fn, arity)
    assert FORWARD_CALL[name] in op.forward, op.forward
    assert "dx = " in op.vjp and "dy = " in op.vjp
    text = user_ops.header([op])
    assert all(f"#define MTGP_USER_MATH_{h.upper()}" in text for h in op.helpers)


def test_special_sets_take_user_ids_and_old_headers_stay():
    """The three sweep sets within the interpreter's fixed instances; the
    whole vocabulary past device op id 63 with no refusal; a set of the
    earlier vocabulary carries none of ``csrc/user_math.cuh`` (its header,
    and so its build, is the one it had), and the VJPs of ``silu``,
    ``mish`` and ``logit`` are autograd's backward kernels, as the plain
    versions run them."""
    for key in SETS:
        fset = special_set(key)
        assert fset.refusals == () and fset.num_operators <= ci.FIXED_OPS
        assert fset.max_device_op <= FIXED_MAX_OP
    every = build_function_set(EVERY, [["x0", "x1"]], [1])
    assert every.refusals == () and every.user_count == len(EVERY) - 3
    assert every.max_device_op == USER_FROM + every.user_count - 1 > FIXED_MAX_OP
    old = build_function_set(ARITH + [("sig", torch.sigmoid, 1), ("lg", torch.log1p, 1)], [["x0"]], [1])
    assert "MTGP_USER_MATH" not in old.user_header
    for fn, bwd in ((F.silu, "t_silu_backward"), (F.mish, "t_mish_backward"),
                    (torch.logit, "t_logit_backward")):
        assert bwd in user_ops.compile_op("a", (lambda f: lambda x, y: f(x))(fn), 1).vjp


def test_tensor_constant_is_a_cpu_scalar():
    """A 0-d float32 constant is a CPU scalar to PyTorch's CUDA kernels: a
    division by it multiplies by its float reciprocal there (the CPU's
    divides); powers of it and by it stay refused."""
    op = user_ops.compile_op("c", lambda x, y: x / torch.tensor(4.0) - x / torch.tensor(3.0), 1)
    assert "x * mtgp_user::bits(0x3e800000u)" in op.forward  # 1 / 4 is exact: the same on both devices
    assert "mtgp_user::div_cpu_scalar(x, mtgp_user::bits(0x40400000u), mtgp_user::bits(0x3eaaaaabu))" in op.forward
    # a power of it: the VJP tests the base against 0, a 0-d value the
    # emitter does not fold
    with pytest.raises(user_ops.Refused, match="computes on a tensor constant alone"):
        user_ops.compile_op("b", lambda x, y: torch.tensor(3.0) ** x, 1)
    with pytest.raises(user_ops.Refused, match="a power by a tensor constant"):
        user_ops.compile_op("p", lambda x, y: x ** torch.tensor(2.0), 1)


# ------------------------------------------------- host math of the plain side

_SPECIAL_VMATH_SRC = r"""
#include <math.h>
void vpow_base(float s, const float* x, float* y, long n) { for (long i = 0; i < n; ++i) y[i] = powf(s, x[i]); }
void vlgammaf(const float* x, float* y, long n) { for (long i = 0; i < n; ++i) y[i] = lgammaf(x[i]); }
void vsoftplus(const float* x, float beta, float threshold, float* y, long n) {
  for (long i = 0; i < n; ++i) y[i] = (x[i] * beta) > threshold ? x[i] : log1pf(expf(x[i] * beta)) / beta;
}
"""
_SPECIAL_VMATH = []


def special_vmath() -> ctypes.CDLL:
    """``powf`` of a scalar base and ``lgammaf`` over arrays (the C
    library's, compiled once)."""
    if not _SPECIAL_VMATH:
        out = Path(tempfile.mkdtemp(prefix="mtgp_svmath_"))
        (out / "svmath.c").write_text(_SPECIAL_VMATH_SRC)
        cc = shutil.which("gcc") or shutil.which("cc") or shutil.which("g++")
        subprocess.run([cc, "-x", "c", "-O1", "-fno-builtin", "-shared", "-fPIC", "-o",
                        str(out / "svmath.so"), str(out / "svmath.c"), "-lm"], check=True)
        lib = ctypes.CDLL(str(out / "svmath.so"))
        lib.vpow_base.argtypes = [ctypes.c_float] + [ctypes.c_void_p] * 2 + [ctypes.c_long]
        lib.vlgammaf.argtypes = [ctypes.c_void_p] * 2 + [ctypes.c_long]
        lib.vsoftplus.argtypes = [ctypes.c_void_p, ctypes.c_float, ctypes.c_float, ctypes.c_void_p, ctypes.c_long]
        _SPECIAL_VMATH.append(lib)
    return _SPECIAL_VMATH[0]


def _pow_base_kernel(base, exponent):
    """``pow(scalar, tensor)`` on the CPU: 1 where the base is 1, else the C
    library's ``powf`` (PyTorch's CPU kernel: SLEEF)."""
    if float(base) == 1.0:
        return torch.ones_like(exponent)
    x = np.ascontiguousarray(exponent.detach().numpy(), dtype=np.float32)
    y = np.empty_like(x)
    special_vmath().vpow_base(ctypes.c_float(float(base)), x.ctypes.data, y.ctypes.data, x.size)
    return torch.from_numpy(y).reshape(exponent.shape)


def _softplus_kernel(x, beta=1.0, threshold=20.0):
    """``softplus`` on the CPU by its scalar formula with the C library's
    ``expf`` and ``log1pf`` (PyTorch's vectorised kernel: SLEEF's)."""
    a = np.ascontiguousarray(x.detach().numpy(), dtype=np.float32)
    y = np.empty_like(a)
    special_vmath().vsoftplus(a.ctypes.data, ctypes.c_float(float(beta)), ctypes.c_float(float(threshold)),
                              y.ctypes.data, a.size)
    return torch.from_numpy(y).reshape(x.shape)


def _lgamma_kernel(x):
    a = np.ascontiguousarray(x.detach().numpy(), dtype=np.float32)
    y = np.empty_like(a)
    special_vmath().vlgammaf(a.ctypes.data, y.ctypes.data, a.size)
    return torch.from_numpy(y).reshape(x.shape)


class _SpecialHostMath:
    """``pow.Scalar``, ``lgamma`` and ``softplus``'s CPU kernels by the C
    library while an instance lives (``ldexp`` calls ``pow(2.0, y)``)."""

    def __init__(self):
        import warnings

        self.lib = torch.library.Library("aten", "IMPL")
        with warnings.catch_warnings():
            warnings.simplefilter("ignore")
            self.lib.impl("pow.Scalar", _pow_base_kernel, "CPU")
            self.lib.impl("lgamma", _lgamma_kernel, "CPU")
            self.lib.impl("softplus", _softplus_kernel, "CPU")


_HOLDER = type("_Holder", (), {"math": None})


def patch_special_math(m) -> None:
    """``patch_host_math`` and the C library's ``powf`` of a scalar base,
    ``lgammaf`` and ``softplus``'s scalar formula under PyTorch's CPU
    kernels while ``m`` is active."""
    patch_host_math(m)
    m.setattr(_HOLDER, "math", _SpecialHostMath())


# ops whose CPU kernels compute with SLEEF (or glibc's vector erff) inside
# one op, and the ulp the host build's scalar formula may part from them
SLEEF_OPS = {"softplus", "gelu", "gelu_tanh", "silu", "mish", "elu", "selu", "celu", "logsigmoid",
             "logaddexp", "logaddexp2", "logit", "erfinv"}
SLEEF_ULP = 8


def sleef_close(a, b):
    """``a (6, L, ...)`` against ``b``: NaN at both, equal, within
    :data:`SLEEF_ULP` ulp, or within 1e-6 of the tree's largest finite
    |value| or 1 (a difference of one ulp inside ``1 + erf`` or ``exp(x) - 1``
    is many ulp of a result near 0)."""
    a, b = np.asarray(a, np.float32), np.asarray(b, np.float32)
    fin = np.isfinite(b)
    scale = np.maximum(np.where(fin, np.abs(b), 0).reshape(b.shape[0], -1).max(axis=1), 1.0)
    scale = scale.reshape((-1,) + (1,) * (b.ndim - 1))
    with np.errstate(invalid="ignore"):
        near = np.isfinite(a) & fin & (np.abs(a - b) <= 1e-6 * scale)
    return within_ulp(a, b, SLEEF_ULP) | near
# lanes where PyTorch's CPU vectorised and scalar paths part (operator ->
# the template operands (u, v) where): gelu's vectorised erf gives NaN at
# +-inf; the VJPs of hardtanh, hardswish and softshrink at NaN, and
# softshrink's 0 in (-lambd, lambd), differ in the scalar tail
CPU_SPLIT = {
    "gelu": lambda u, v: np.isinf(u), "gelu_tanh": lambda u, v: np.isinf(u),
    "hardtanh": lambda u, v: np.isnan(u), "hardswish": lambda u, v: np.isnan(u),
    "softshrink": lambda u, v: np.isnan(u) | (np.abs(u) <= 0.5),
}


def template_operands(name, xs, seed=21):
    """The operands ``(u, v)`` (``(6, L)``) of operator ``name`` in each of
    its six templates on the data ``xs (6, L, 2)``."""
    c = (np.random.default_rng(seed).normal(size=4) * 1.5).astype(np.float32)
    x0, x1 = xs[0, :, 0], xs[0, :, 1]
    with np.errstate(all="ignore"):
        if ARITY[name] == 2:
            u = [x0, x1, np.full_like(x0, c[1]), x0, x0 * c[2], x1]
            v = [x1, np.full_like(x0, c[0]), x0, x0, x1, x0]
            return np.stack(u), np.stack(v)
        return np.stack([x0, x1 * c[0], x0, x0 - x1, np.full_like(x0, c[2]), x1]), None


def within_ulp(a, b, ulp):
    """Elementwise: NaN at both, equal, or finite within ``ulp`` ulp."""
    a, b = np.asarray(a, np.float32), np.asarray(b, np.float32)
    fin = np.isfinite(a) & np.isfinite(b)
    gap = ulp_gap(np.where(fin, a, 0), np.where(fin, b, 0))
    return (np.isnan(a) & np.isnan(b)) | (a == b) | (fin & (gap <= ulp))


# ----------------------------------------------- host builds: #8/#9 bit for bit

@pytest.fixture(scope="module")
def host_build(tmp_path_factory):
    if shutil.which("g++") is None and shutil.which("c++") is None:
        pytest.skip("no host C++ compiler")
    out = tmp_path_factory.mktemp("special_host")
    made = {}

    def get(name, variant):
        key = (name, variant.suffix)
        if key not in made:
            made[key] = _build.build_host(name, out, variant)
        return made[key]

    return get


def host_interpreter(lib, trees, data, g, fset):
    status, out = ci.run_forward(lib.interpret_fwd, trees, data, fset)
    assert status == 0
    status, dconst, ddata = ci.run_backward(lib.interpret_bwd, trees, data, g, fset)
    assert status == 0
    return out, dconst, ddata


def plain_interpreter(trees, data, g, fset):
    with pytest.MonkeyPatch.context() as m:
        patch_special_math(m)
        full, x = per_lane_operands(trees, data)
        return (evaluate_trees_plain(full, x, fset),) + evaluate_trees_vjp_plain(full, x, g, fset)


@pytest.fixture(scope="module")
def host_vs_plain(host_build):
    done = {}

    def get(key):
        if key not in done:
            fset, trees, data, g = set_case(key)
            got = host_interpreter(host_build("interpreter", fset.variant), trees, data, g, fset)
            done[key] = got, plain_interpreter(trees, data, g, fset), data
        return done[key]

    return get


@pytest.mark.parametrize("name", NAMES)
def test_interpreter_host_build_bit_exact(host_vs_plain, name):
    """#8/#9's user host build on each operator's six trees, per lane: roots,
    ``dconst`` and ``ddata`` bit for bit with the plain version (within
    :data:`SLEEF_ULP` for :data:`SLEEF_OPS`; :data:`CPU_SPLIT` lanes left
    out)."""
    got, want, data = host_vs_plain(SET_OF[name])
    s = trees_of(name)
    u, v = template_operands(name, data[s].numpy())
    keep = ~CPU_SPLIT[name](u, v) if name in CPU_SPLIT else np.ones(u.shape, bool)
    for a, b, what in zip(got, want, ("roots", "dconst", "ddata")):
        a, b = a[s].numpy(), b[s].numpy()
        lanes = keep.reshape(keep.shape + (1,) * (a.ndim - 2))
        lanes = np.broadcast_to(lanes, a.shape)
        ok = sleef_close(a, b) if name in SLEEF_OPS else within_ulp(a, b, 0)
        assert ok[lanes].all(), (what, a[lanes & ~ok][:4], b[lanes & ~ok][:4])
    assert np.isfinite(want[0][s].numpy()).any()


# ------------------------------------ host builds: #1, #3, #4/#5, #6/#7

def test_fitness_host_build_bit_exact(host_build, monkeypatch):
    """#1 (``sr_fitness.cu``, RK4) on a set of the special functions."""
    fset, trees, x0s, ts, ys = sr_case(ops=EXACT)
    with monkeypatch.context() as m:
        patch_special_math(m)
        mse, alive = cr.sr_fitness_plain(trees, x0s, ts, ys, fset, "rk4", 1)
    err, alive_h = fitness_host(host_build("sr_fitness", fset.variant), trees, x0s, ts, ys, fset, "rk4", 1)
    np.testing.assert_array_equal(alive_h, alive.numpy())
    np.testing.assert_array_equal(err, mse.numpy())
    assert alive.any() and int((trees.ops >= fset.var_start - len(EXACT) + 3).sum()) > 0


def test_rollout_host_build_bit_exact(host_build, monkeypatch):
    """#3 (``sr_rollout.cu``, RK4 x 2) on a set of the special functions."""
    fset, trees, x0s, ts, _ = sr_case(ops=EXACT)
    with monkeypatch.context() as m:
        patch_special_math(m)
        xs, alive = cr.sr_rollout_plain(trees, x0s, ts, fset, "rk4", 2)
    p, d, n = trees.ops.shape
    b, t_steps = x0s.shape[0], ts.shape[0]
    out = np.zeros((t_steps, p, b, d), np.float32)
    alive_h = np.zeros((p, b), np.uint8)
    h, h_final = cr.rollout_step(ts, "rk4", 2)
    fn = host_build("sr_rollout", fset.variant).sr_rollout_host
    fn.argtypes = [ctypes.c_void_p] * 6 + [ctypes.c_int] * 9 + [ctypes.c_float] * 3
    arrays = [np.ascontiguousarray(a.numpy()) for a in (trees.ops, trees.const, fset.device_ops(), x0s)]
    assert fn(*(a.ctypes.data for a in arrays), out.ctypes.data, alive_h.ctypes.data, p, d, n, b,
              t_steps, fset.var_start, fset.has_unary, cr.METHODS["rk4"], 2,
              np.float32(h * 0.5), np.float32(h), h_final) == 0
    np.testing.assert_array_equal(alive_h.astype(bool), alive[-1].numpy())
    np.testing.assert_array_equal(out, xs.numpy())
    assert alive[-1].any()


@pytest.mark.parametrize("kind,budget", [(ca.GLOBAL, 40), (ca.INTERVAL, 8)])
def test_adaptive_host_build_bit_exact(host_build, monkeypatch, kind, budget):
    """#5 (global budget) and #4 (per interval), dopri5, on a set of the
    special functions."""
    fset, trees, x0s, ts, ys = sr_case(pop=12, t_end=1.0, ops=EXACT)
    plain_fn = ca.sr_fitness_adaptive_global_plain if kind == ca.GLOBAL else ca.sr_fitness_adaptive_interval_plain
    with monkeypatch.context() as m:
        patch_special_math(m)
        mse, alive, steps = plain_fn(trees, x0s, ts, ys, fset, 1e-4, 1e-6, budget, "dopri5")
    p, b = trees.ops.shape[0], x0s.shape[0]
    err = np.zeros((p, b), np.float32)
    alive_h = np.zeros((p, b), np.uint8)
    steps_h = np.zeros((p, b), np.int32)
    arrays = [np.ascontiguousarray(a.numpy()) for a in (trees.ops, trees.const, fset.device_ops(),
                                                        x0s, ts, ys)]
    fn = host_build("sr_adaptive", fset.variant).sr_adaptive_host
    fn.argtypes = [ctypes.c_int] + [ctypes.c_void_p] * 9 + [ctypes.c_int] * 9 + [ctypes.c_float] * 3
    assert fn(kind, *(a.ctypes.data for a in arrays), err.ctypes.data, alive_h.ctypes.data,
              steps_h.ctypes.data, p, x0s.shape[1], trees.ops.shape[-1], b, ts.shape[0],
              fset.var_start, fset.has_unary, ca.METHODS["dopri5"], budget, 1e-4, 1e-6, 0.9) == 0
    np.testing.assert_array_equal(alive_h.astype(bool), alive.numpy())
    np.testing.assert_array_equal(steps_h, steps.numpy())
    assert same_bits(torch.from_numpy(err / np.float32(ts.shape[0])), mse)
    assert alive.any()


@pytest.mark.parametrize("kind,state_size", [(cp.FIXED, 0), (cp.FIXED, 2), (cp.ADAPTIVE, 0)])
def test_policy_host_build_bit_exact(host_build, monkeypatch, kind, state_size):
    """#6 (RK4 x 2; static and dynamic) and #7 (dopri5, 8 steps per
    interval) on Acrobot policies of the special functions."""
    env, fset, (x0, ts, tgt, _, _, par), trees = policy_case(
        state_size, ops=EXACT, pop=8, t_end=1.6 if kind == cp.FIXED else 1.2)
    lib = host_build("policy", fset.variant)
    lib.policy_host.argtypes = [ctypes.c_int, ctypes.c_void_p]
    lib.policy_host.restype = ctypes.c_int
    with monkeypatch.context() as m:
        patch_special_math(m)
        if kind == cp.FIXED:
            want = cp.policy_rollout_plain(trees, x0, ts, tgt, par, env, fset, 2, "rk4", state_size)
        else:
            want = cp.policy_rollout_adaptive_plain(trees, x0, ts, tgt, par, env, fset, 1e-4, 1e-4, 8,
                                                    "dopri5", 0.9, 0)
    args = (trees, x0, ts, tgt, par, env, fset, state_size)
    if kind == cp.FIXED:
        status, hxs, hus, count, _ = cp.run_policy(lambda a: lib.policy_host(kind, a), kind, *args, "rk4", 2)
    else:
        status, hxs, hus, count, hsteps = cp.run_policy(
            lambda a: lib.policy_host(kind, a), kind, *args, "dopri5", max_steps=8,
            rtol=1e-4, atol=1e-4, safety=0.9)
        assert torch.equal(hsteps, want[3])
    assert status == 0
    assert same_bits(hxs, want[0]) and same_bits(hus, want[1])
    assert torch.equal(cp._alive_rows(count, ts.shape[0]), want[2])


# ------------------------------------------- a set past 63 device op ids

def every_case(k=12, n=32, depth=5, seed=7):
    """Trees sampled from :data:`EVERY` (user ids to 112) in the
    recompute's layout: ``(fset, trees (k, 5, N), data, g)``."""
    fset = build_function_set(EVERY, [["x0", "x1"]], [1])
    g = torch.Generator().manual_seed(seed)
    pop = make_population_sampler(fset, depth, n)(g, k)[0]
    rng = np.random.default_rng(seed)
    data = torch.from_numpy((rng.normal(size=(k, 5, 2)) * 1.5).astype(np.float32))
    trees = pop.map(lambda a: a[:, 0, None].expand(k, 5, n).contiguous())
    return fset, trees, data, torch.from_numpy(rng.normal(size=(k, 5)).astype(np.float32))


def test_set_past_63_ids_routes_to_the_wide_instances():
    """Every kernel's fixed instances keep their 6-bit op field: a set whose
    largest device op id passes 63 takes the wide instances of #1/#3/#4/#5,
    #6/#7 and #8/#9, and the fixed entry points refuse it."""
    fset = build_function_set(EVERY, [["x0", "x1"]], [1])
    assert not cr.takes_fixed(2, 4, fset.num_variables, fset.max_device_op)
    assert cr.takes_fixed(2, 4, fset.num_variables, FIXED_MAX_OP)
    assert not cp.takes_fixed(Pendulum(), 0, 0, fset.max_device_op)
    assert not ci.takes_fixed(32, 2, fset.num_operators, fset.max_device_op)
    assert ci.op_table_words(fset) == fset.max_device_op + 1 > ci.DEVICE_OPS
    trees = TreeTensors(*(torch.zeros((1, 2, 8), dtype=t) for t in (torch.int32,) * 3 + (torch.float32,)))
    with pytest.raises(NotImplementedError, match="6-bit field"):
        cr.kernel_operands(trees, fset, ("x0s", torch.zeros((4, 2))))


def test_wide_interpreter_host_build_bit_exact(host_build):
    """#8/#9's wide instance (the user build of every vocabulary operator,
    op table of 113 entries) on sampled trees, bit for bit with the plain
    version."""
    fset, trees, data, g = every_case()
    got = host_interpreter(host_build("interpreter", fset.variant), trees, data, g, fset)
    want = plain_interpreter(trees, data, g, fset)
    for a, b in zip(got, want):
        assert sleef_close(a.numpy(), b.numpy()).all()  # the set holds SLEEF_OPS
    assert torch.isfinite(want[0]).any()
    assert int((trees.ops >= fset.string_to_op["pow_base"]).sum()) > 20


def test_wide_fitness_host_build_bit_exact(host_build, monkeypatch):
    """#1's wide instance (``sr_fitness_wide``) on a set whose special
    functions take device op ids past 63 (the earlier vocabulary first)."""
    fset, trees, x0s, ts, ys = sr_case(pop=16, ops=ARITH + whole_vocabulary()[:47] + EXACT[3:])
    assert fset.max_device_op > FIXED_MAX_OP
    with monkeypatch.context() as m:
        patch_special_math(m)
        mse, alive = cr.sr_fitness_plain(trees, x0s, ts, ys, fset, "rk4", 1)
    lib = host_build("sr_fitness", _build.widened(fset.variant))
    err, alive_h, _ = fitness_wide(lib, trees, x0s, ts, ys, fset, "rk4", 1)
    np.testing.assert_array_equal(alive_h, alive.numpy())
    np.testing.assert_array_equal(err, mse.numpy())
    past = [fset.string_to_op[n] for n, *_ in EXACT[3:]]
    assert alive.any() and bool(torch.isin(trees.ops, torch.tensor(past)).any())


def test_reproduce_host_build_takes_a_hundred_operators(tmp_path):
    """#2's host build (tree surgery: arities and probabilities) on a set of
    99 operators, every output equal to the plain version's."""
    cfg, args = reproduce_case(ops=EVERY)
    assert cfg.num_operators == 99
    ref = reproduce_lanes_plain(*args, cfg)
    status, outs = reproduce_host(_build.build_host("reproduce", tmp_path), args, cfg)
    assert status == 0
    np.testing.assert_array_equal(outs[0], ref[0].numpy())
    np.testing.assert_array_equal(outs[2], ref[2].numpy())
    np.testing.assert_allclose(outs[1], ref[1].numpy(), rtol=1e-6, atol=0)
    np.testing.assert_allclose(outs[3], ref[3].numpy(), rtol=1e-6, atol=0)
    assert int((ref[0] >= 2 + 48).sum()) > 0  # operators past the earlier vocabulary were drawn


# ------------------------------------------------- a traced plant with the new ops

class ClippedPendulum(Pendulum):
    """:class:`Pendulum` whose torque clip is a clamp by tensors, twice the
    mass (a parameter), and with a softplus friction term."""

    def drift(self, t, x, u, params):
        g, m, l = params
        bound = (2.0 * m)[..., None]
        torque = torch.clamp(u, -bound, bound)[..., 0]
        friction = 0.05 * F.softplus(x[..., 1])
        theta_acc = 3.0 * g / (2.0 * l) * torch.sin(x[..., 0]) + 3.0 / (m * l * l) * torque - friction
        return torch.stack([x[..., 1], theta_acc], dim=-1)


def test_traced_plant_emits_the_new_ops():
    """The plant's header calls ``clamp_tensor`` and ``t_softplus`` and
    carries their helpers under their include guards."""
    env = ClippedPendulum()
    traced = user_envs.compile_env(env, (torch.ones(2),) * 3)
    assert "mtgp_user::clamp_tensor(" in traced.header and "mtgp_user::t_softplus(" in traced.header
    assert "#define MTGP_USER_MATH_CLAMP_TENSOR" in traced.header
    assert "#define MTGP_USER_MATH_SOFTPLUS" in traced.header


@pytest.mark.parametrize("kind,state_size", [(cp.FIXED, 0), (cp.ADAPTIVE, 0)])
def test_traced_plant_host_build_bit_exact(host_build, monkeypatch, kind, state_size):
    """#6 and #7's host builds with the traced plant: states, controls and
    alive rows bit for bit with the plain version (the C library's math
    under PyTorch's kernels, ``softplus``'s too: :func:`patch_special_math`)."""
    env = ClippedPendulum()
    fset, data, trees = env_policy_case(env, state_size, mode="Different")

    def host(variant):
        lib = host_build("policy", variant)
        lib.policy_host.argtypes = [ctypes.c_int, ctypes.c_void_p]
        lib.policy_host.restype = ctypes.c_int
        return lib

    with monkeypatch.context() as m:
        patch_special_math(m)
        ref = plain(kind, env, fset, data, trees, state_size)
    got = run_host(host, kind, env, fset, data, trees, state_size, **kernel_kw(kind))
    assert_same(got if kind == cp.ADAPTIVE else got[:3], ref)
    assert bool(ref[2][-1].any())


# ------------------------------------------------------------ against JAX

def jax_counterparts():
    """The operators as ``jnp`` callables (name -> fn; ``erfcx`` has none)."""
    import jax
    import jax.numpy as jnp
    import jax.scipy.special as jss

    return {
        "pow_base": lambda x: jnp.power(jnp.float32(2.0), x),
        "div_floor_scalar": lambda x: jnp.floor_divide(x, jnp.float32(1.5)),
        "div_trunc_scalar": lambda x: jnp.trunc(x / jnp.float32(1.5)),
        "round_decimals": lambda x: jnp.round(x, 2), "tensor_constant": lambda x: x / jnp.float32(3.0),
        "lgamma": jss.gammaln, "digamma": jss.digamma, "trigamma": lambda x: jss.polygamma(1, x),
        "polygamma2": lambda x: jss.polygamma(2, x), "i0": jss.i0, "i0e": jss.i0e, "i1": jss.i1,
        "i1e": jss.i1e, "erfinv": jss.erfinv, "ndtri": jss.ndtri, "log_ndtr": jss.log_ndtr,
        "entr": jss.entr, "logit": jss.logit, "sinc": jnp.sinc, "softplus": jax.nn.softplus,
        "gelu": lambda x: jax.nn.gelu(x, approximate=False),
        "gelu_tanh": lambda x: jax.nn.gelu(x, approximate=True), "silu": jax.nn.silu, "mish": jax.nn.mish,
        "elu": jax.nn.elu, "selu": jax.nn.selu, "celu": lambda x: jax.nn.celu(x, 1.5),
        "leaky_relu": lambda x: jax.nn.leaky_relu(x, 0.01), "hardtanh": jax.nn.hard_tanh,
        "hardswish": jax.nn.hard_swish, "hardsigmoid": jax.nn.hard_sigmoid,
        "logsigmoid": jax.nn.log_sigmoid,
        "softshrink": lambda x: jnp.where(x > 0.5, x - 0.5, jnp.where(x < -0.5, x + 0.5, 0.0)),
        "frac": lambda x: x - jnp.trunc(x), "deg2rad": jnp.deg2rad, "rad2deg": jnp.rad2deg,
        "nan_to_num": jnp.nan_to_num,
        "clamp_tensor": lambda x, y: jnp.clip(x, -jnp.abs(y), jnp.abs(y)),
        "clamp_min_tensor": jnp.maximum, "clamp_max_tensor": jnp.minimum, "xlogy": jss.xlogy,
        "xlog1py": jss.xlog1py, "logaddexp": jnp.logaddexp, "logaddexp2": jnp.logaddexp2,
        "copysign": jnp.copysign, "fmax": jnp.fmax, "fmin": jnp.fmin,
        "ldexp": lambda x, y: x * jnp.power(jnp.float32(2.0), y),
    }


def value_and_grads(trees, data, g, fset, dtype=torch.float32):
    """``(roots, dconst, ddata)`` of the port's plain version in ``dtype``."""
    from multitreegp_tpu_torch.core.interpreter import evaluate_trees

    const = trees.const.to(dtype).requires_grad_(True)
    x = data.to(dtype).requires_grad_(True)
    out = evaluate_trees(trees._replace(const=const), x, fset)
    grads = torch.autograd.grad(out, (const, x), g.to(dtype))
    return tuple(v.detach().numpy() for v in (out,) + grads)


@functools.lru_cache(maxsize=None)
def jax_vs_port_case(key):
    """``(port's (roots, dconst, ddata), JAX's, data, g)`` on :func:`set_case`
    of set ``key``: the JAX set of the ``jnp`` counterparts, the port's set
    converted from it (``convert.function_set_from_jax``) where every
    counterpart agrees with the torch callable on the probe values, else
    built from the torch callables."""
    import jax
    import jax.numpy as jnp
    from multitreegp_tpu.core.interpreter import evaluate_trees as jax_evaluate
    from multitreegp_tpu.core.registry import build_function_set as jax_function_set
    from multitreegp_tpu.core.trees import TreeTensors as JaxTrees
    from multitreegp_tpu_torch.convert import function_set_from_jax

    jfns = jax_counterparts()
    base = {"+": jnp.add, "-": jnp.subtract, "*": jnp.multiply}
    ops = [(n, jfns.get(n, lambda x: x), a) for n, _, a in SETS[key][3:]]
    jf = jax_function_set([(n, base[n], 2, 1.0) for n, _ in ARITH] + [(n, f, a, 1.0) for n, f, a in ops],
                          [["x0", "x1"]], [1])
    try:
        fset = function_set_from_jax(jf, {n: FN[n] for n, *_ in ops})
    except ValueError:  # a counterpart parts from the torch callable at a probe (inf, NaN)
        fset = special_set(key)
    assert fset.device_op_ids == special_set(key).device_op_ids
    _, trees, data, g = set_case(key, fset)
    ev = jax.jit(lambda t, d: jax_evaluate(JaxTrees(*t), d, jf, impl="gather"))
    t = [np.asarray(a) for a in trees]
    d, gg = data.numpy(), g.numpy()
    grad = jax.jit(jax.grad(lambda c, d: (ev((*t[:3], c), d) * gg).sum(), argnums=(0, 1)))
    want = (np.asarray(ev(t, d)),) + tuple(np.asarray(x) for x in grad(t[3], d))
    with pytest.MonkeyPatch.context() as m:
        patch_special_math(m)
        got = value_and_grads(trees, data, g, fset)
    # every node in float64, rounded to float32: the correctly rounded value
    # of each operator on the same float32 operands (and cotangents)
    in64 = lambda f: lambda x, y: f(x, y).float().double()
    truth = value_and_grads(trees, data, g, dataclasses.replace(
        fset, operator_fns=tuple(in64(lambda x, y, f=f: f(x.double(), y.double())) for f in fset.operator_fns)),
        torch.float64)
    return got, want, truth, d, gg


@pytest.fixture(scope="module")
def jax_vs_port():
    pytest.importorskip("jax")
    return jax_vs_port_case


# where autograd's and JAX's conventions differ: operator -> (lanes, by the
# operator's operands u, v; the difference on them, port's p against JAX's j)
_differ = lambda p, j: ~close(p, j)
_tie = lambda u, v: u == v
CONVENTIONS = {
    # digamma / polygamma at 0: the C++ standard's -/+inf (PyTorch), NaN (JAX)
    "digamma": (lambda u, v: u == 0, lambda p, j: np.isinf(p) & np.isnan(j)),
    "polygamma2": (lambda u, v: (u <= 0) & (u == np.floor(u)), _differ),
    # trigamma at the poles (negative integers, 0) and +inf: PyTorch's series
    # gives a large finite value and 0, JAX inf and NaN; one float32 ulp off a
    # pole, PyTorch's sin(pi x) in float32 loses the distance to it
    "trigamma": (lambda u, v: ((u <= 0) & (within_ulp(u, np.round(u), 1))) | np.isinf(u), _differ),
    # gelu at +inf: PyTorch's vectorised CPU erf NaN (its CUDA kernel inf), JAX inf
    "gelu": (lambda u, v: np.isposinf(u), lambda p, j: np.isnan(p) & np.isposinf(j)),
    # d i0 at 0: autograd i1(0) = 0, JAX a value
    "i0": (lambda u, v: u == 0, _differ),
    # d sinc near 0: autograd's formula masks x == 0 and gives 0 below
    # float32's reach; JAX divides by x^2 (inf)
    "sinc": (lambda u, v: np.abs(u) < 1e-15, lambda p, j: (p == 0) & ~np.isfinite(j)),
    # the kinks: leaky_relu at 0 (autograd the slope, JAX 1), hardtanh at
    # +-1 (autograd 0, JAX g); softshrink at NaN (PyTorch NaN, the jnp where 0)
    "leaky_relu": (lambda u, v: u == 0, _differ),
    "hardtanh": (lambda u, v: np.abs(u) == 1, lambda p, j: p == 0),
    "softshrink": (lambda u, v: np.isnan(u), lambda p, j: np.isnan(p) & ~np.isnan(j)),
    # ties of clamps and fmax / fmin: autograd passes the cotangent to one
    # operand, JAX's maximum / minimum split it (fmax / fmin: to the other)
    "clamp_tensor": (lambda u, v: (np.abs(u) == np.abs(v)) | (v == 0), _differ),
    "clamp_min_tensor": (_tie, _differ), "clamp_max_tensor": (_tie, _differ),
    "fmax": (_tie, _differ), "fmin": (_tie, _differ),
    # xlogy at x == 0: autograd 0 (masked), JAX log(y) (inf at y == 0)
    "xlogy": (lambda u, v: u == 0, _differ),
    # d copysign at x == 0: autograd 0 (masked), JAX the sign's
    "copysign": (lambda u, v: u == 0, _differ),
}
# operators on whose inputs here the packages part by more than the
# tolerance, with the port's largest gap to the correctly rounded value
# (each node in float64, rounded to float32) on such lanes, in ulp: there
# the port must be within the tolerance of that value (an absolute one of
# 1e-6 of the tree's largest |value|, or 1) or within the ulp given. Largest
# gaps seen: digamma 85 (its float32 series near the poles), log_ndtr 334
# and ndtri 86 (the VJPs, near the tails), sinc 220,258 (autograd's
# float32 VJP cancels near 0), trigamma 19; the others none past the
# tolerance (XLA's
# float32 lgamma, erfinv, mish and the series of polygamma lose a few
# 1e-6 where PyTorch's do not; PyTorch's CPU gelu computes erf and tanh
# with SLEEF polynomials that lose 1e-5 in 1 + erf near -3, its CUDA kernel
# calls erff, held by ``op_sweep`` on the card)
OFF_TRUTH = {"lgamma": 0, "erfinv": 0, "log_ndtr": 512, "ndtri": 128, "mish": 0, "gelu": 0, "gelu_tanh": 0,
             "digamma": 128, "trigamma": 32, "polygamma2": 0, "sinc": 2**18}
# operators JAX lacks: held against another reference
NO_JAX = {"erfcx"}


@pytest.mark.parametrize("name", [n for n in NAMES if n not in NO_JAX])
def test_operator_matches_jax(jax_vs_port, name):
    """Each operator's six trees against the JAX package with the ``jnp``
    counterpart: roots, and the gradients of finite roots, with the same
    NaN/inf pattern; finite values within 4 ulp or 1e-6 relative, gradients
    also within 1e-6 of the tree's largest |gradient|; the lanes of
    :data:`CONVENTIONS` hold the difference named there."""
    got, want, truth, xs, g = jax_vs_port(SET_OF[name])
    s = trees_of(name)
    got, want, truth, xs = [v[s] for v in got], [v[s] for v in want], [v[s] for v in truth], xs[s]
    fin = np.isfinite(got[0]) & np.isfinite(want[0])
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
            if name in CONVENTIONS:
                conv = at[k][lanes].reshape((-1,) + (1,) * (pk.ndim - 1)) & CONVENTIONS[name][1](pk, jk)
                seen += int((conv & ~ok).sum())
                ok |= conv
            if name in OFF_TRUTH:  # the port within the tolerance of the float64 value
                # (absolutely, 1e-6 of the tree's largest finite |value|, or 1) or within the
                # operator's ulp of it
                scale = max(1.0, float(np.abs(finite).max()) if finite.size else 1.0)
                off = ~ok & (close(pk, tk, 1e-6 * scale) | within_ulp(pk, tk, OFF_TRUTH[name]))
                off_seen += int(off.sum())
                ok |= off
            assert ok.all(), (["roots", "dconst", "ddata"][w], k, pk[~ok], jk[~ok], tk[~ok])
    assert (seen > 0) == (name in CONVENTIONS) and (off_seen > 0) == (name in OFF_TRUTH)
    assert np.isfinite(got[0]).any()


def test_erfcx_matches_scipy():
    """``erfcx`` (which JAX lacks) against ``scipy.special.erfcx`` in float64
    rounded to float32: for x >= 0 within 4 ulp; below 0 PyTorch's formula
    2 exp(x^2) - erfcx(-x) rounds x^2 to float32 first, which exp turns into
    a relative error up to x^2 2^-24, so within 4 ulp plus that; the same
    infinities and NaN."""
    scipy_special = pytest.importorskip("scipy.special")
    x = np.concatenate([np.float32([0.0, -0.0, 1.0, -1.0, 8.0, 50.0, 50.5, 5e7, 6e7, -6.1, -6.2, -26.7,
                                    -26.6, 1e-30, -1e-30, np.inf, -np.inf]),
                        (np.random.default_rng(3).normal(size=4000) * 10).astype(np.float32)])
    got = torch.special.erfcx(torch.from_numpy(x)).numpy()
    with np.errstate(over="ignore", invalid="ignore"):
        want64 = scipy_special.erfcx(x.astype(np.float64))
        want = want64.astype(np.float32)
        rel = np.where(x < 0, x.astype(np.float64) ** 2 * 2.0**-24, 0.0) + 4 * 2.0**-23
        near = np.abs(got - want64) <= rel * np.abs(want64)
    assert (within_ulp(got, want, 4) | (np.isfinite(got) & near)).all()
    assert np.array_equal(np.isinf(got), np.isinf(want))


# ------------------------------------------------------------------ the card

@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU (CUDA kernels have no CPU mode)")
    return torch.device("cuda")


@pytest.mark.cuda
def test_sweep_matches_pytorch_cuda_on_card(cuda):
    """#8/#9 through the special sets' user builds against PyTorch's CUDA
    ops (``tools/op_sweep``): each unary operator's forward on every 4096th
    bit pattern (``chip_smoke.py`` phase 30 sweeps all 2^32), its VJP on
    every 4096th, the binary ones on a 1024 x 1024 grid plus the edges:
    equal bits forward, equal values VJP, NaN as NaN."""
    from multitreegp_tpu_torch.tools import op_sweep

    results = []
    for fset in op_sweep.special_sweep_sets():
        results += op_sweep.sweep_set(fset, cuda, stride=4096, side=1024)
    bad = {r["name"]: (r["first"], r["vjp"]) for r in results if not r["ok"]}
    assert not bad, bad
    assert len(results) == len(NAMES)


@pytest.mark.cuda
def test_special_tree_kernels_match_plain_on_card(cuda):
    """#1, #3, #5, #4, #6 and #7 on a set of the special functions, and #1
    and #8/#9 on every vocabulary operator (ids past 63: the wide
    instances): every lane bit for bit against the plain version on the
    card, launch counters."""
    to = lambda t: t.to(cuda)
    for ops in (EXACT, EVERY):
        fset, trees, x0s, ts, ys = sr_case(pop=256, b=16, t_end=2.0, seed=4, ops=ops)
        trees, x0s, ts, ys = trees.map(to), to(x0s), to(ts), to(ys)
        before = cr.sr_fitness_wide_cuda.launches if ops is EVERY else cr.sr_fitness_cuda.launches
        mse, alive = cr.sr_fitness(trees, x0s, ts, ys, fset, "rk4", 1)
        ref, ref_alive = cr.sr_fitness_plain(trees, x0s, ts, ys, fset, "rk4", 1)
        torch.cuda.synchronize()
        after = cr.sr_fitness_wide_cuda.launches if ops is EVERY else cr.sr_fitness_cuda.launches
        assert after > before
        assert torch.equal(alive, ref_alive) and same_bits(mse, ref) and alive.any()
    fset, trees, data, g = every_case()
    trees, data, g = trees.map(to), to(data), to(g)
    before = ci.evaluate_trees_cuda.launches
    out = ci.evaluate_trees_cuda(trees, data, fset)
    dconst, ddata = ci.evaluate_trees_vjp_cuda(trees, data, g, fset)
    full, x = per_lane_operands(trees, data)
    ref = evaluate_trees_plain(full, x, fset)
    ref_c, ref_d = evaluate_trees_vjp_plain(full, x, g, fset)
    torch.cuda.synchronize()
    assert ci.evaluate_trees_cuda.launches > before
    assert same_bits(out, ref) and same_bits(dconst, ref_c) and same_bits(ddata, ref_d)
    fset, trees, x0s, ts, ys = sr_case(pop=256, b=16, t_end=2.0, seed=4, ops=EXACT)
    trees, x0s, ts = trees.map(to), to(x0s), to(ts)
    xs, xs_alive = cr.sr_rollout(trees, x0s, ts, fset, "rk4", 1)
    ref_xs, ref_xs_alive = cr.sr_rollout_plain(trees, x0s, ts, fset, "rk4", 1)
    assert torch.equal(xs_alive, ref_xs_alive) and same_bits(xs, ref_xs)
    fset, trees, x0s, ts, ys = sr_case(pop=256, b=16, t_end=1.0, seed=4, ops=EXACT)
    trees, x0s, ts, ys = trees.map(to), to(x0s), to(ts), to(ys)
    for fn, plain_fn, budget in ((ca.sr_fitness_adaptive_global_cuda, ca.sr_fitness_adaptive_global_plain, 40),
                                 (ca.sr_fitness_adaptive_interval_cuda,
                                  ca.sr_fitness_adaptive_interval_plain, 8)):
        got = fn(trees, x0s, ts, ys, fset, 1e-4, 1e-6, budget, "dopri5")
        want = plain_fn(trees, x0s, ts, ys, fset, 1e-4, 1e-6, budget, "dopri5")
        torch.cuda.synchronize()
        assert same_bits(got[0], want[0]) and torch.equal(got[1], want[1]) and torch.equal(got[2], want[2])
    for state_size in (0, 2):
        env, pf, (x0, pts, tgt, _, _, par), pol = policy_case(state_size, cuda, pop=64, b=16, ops=EXACT)
        got = cp.rollout_policy(pol, x0, pts, tgt, par, env, pf, 2, "rk4", state_size)
        want = cp.policy_rollout_plain(pol, x0, pts, tgt, par, env, pf, 2, "rk4", state_size)
        torch.cuda.synchronize()
        assert same_bits(got[0], want[0]) and same_bits(got[1], want[1]) and torch.equal(got[2], want[2])
    env, pf, (x0, pts, tgt, _, _, par), pol = policy_case(0, cuda, pop=64, b=16, t_end=1.2, ops=EXACT)
    got = cp.policy_rollout_adaptive_cuda(pol, x0, pts, tgt, par, env, pf, max_steps=8)
    want = cp.policy_rollout_adaptive_plain(pol, x0, pts, tgt, par, env, pf, 1e-4, 1e-4, 8)
    torch.cuda.synchronize()
    assert all(same_bits(a, b) for a, b in zip(got[:2], want[:2]))
    assert torch.equal(got[2], want[2]) and torch.equal(got[3], want[3])
