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
  their wrappers, same criteria (#1 also with Euler-Maruyama kick rows, bit
  for bit; the branch probe #10 in every mode, bit for bit); the closed-loop policy kernels (#6 fixed
  step, #7 adaptive) per lane bit for bit, states, controls, alive counts
  and steps (also their instances for N <= 256, on chains of 255, 127 and
  63 rows, and at 1024 and 1025 trajectories), and the policy evaluators' general path (#8, never a
  plain version) on CUDA tensors; the interpreter kernels (forward and VJP)
  through ``evaluate_trees`` and autograd, and in every caller's layout at
  N = 32 to 256 with and without ``sin``/``cos`` (per-lane outputs), and
  their instance past 256 rows at N = 300, 512 and 1024 (16 trajectories a
  tree, one data vector a tree), bit for bit per lane against the plain
  version on the card, and their refusal past 1024 rows; the adaptive kernels (#5 global budget, #4 per
  interval; also their instances for N <= 256, state dim 4 and 1024
  trajectories) and the trajectory kernel (#3) against their plain versions,
  bit for bit per lane (the card's ``powf`` and ``sqrtf`` are PyTorch's), and
  their dispatchers' launch counters and refusals. This file imports no JAX,
  so it also runs where the card is (``pytest --noconftest``).

The host-build checks of the interpreter, adaptive and trajectory kernels are
in ``test_torch_interpreter_kernel.py``, ``test_torch_adaptive.py`` and
``test_torch_rollout_kernel.py``.
"""
import ctypes
import shutil
import subprocess
import tempfile
from pathlib import Path

import numpy as np
import pytest
import torch

from multitreegp_tpu_torch import _build
from multitreegp_tpu_torch.core import tile_surgery as tts
from multitreegp_tpu_torch.core.cuda_reproduction import (
    decay_table, reproduce_lanes, reproduce_lanes_cuda, reproduce_lanes_plain, rows_per_lane,
)
from multitreegp_tpu_torch.core import cuda_adaptive as ca
from multitreegp_tpu_torch.core import cuda_interpreter as ci
from multitreegp_tpu_torch.core import cuda_policy as cp
from multitreegp_tpu_torch.core import cuda_rollout as cro
from multitreegp_tpu_torch.core.cuda_rollout import (
    METHODS, SRFitness, sr_fitness, sr_fitness_cuda, sr_fitness_plain,
)
from multitreegp_tpu_torch.core.interpreter import (
    evaluate_trees, evaluate_trees_plain, evaluate_trees_vjp_plain,
)
from multitreegp_tpu_torch.core.registry import build_function_set
from multitreegp_tpu_torch.core.trees import CONST, EMPTY, OP_START, TreeTensors, rebuild_pointers
from multitreegp_tpu_torch.models.environments import Acrobot, HarmonicOscillator, VanDerPolOscillator
from multitreegp_tpu_torch.models.evaluators import (
    DynamicPolicyEvaluator, SREvaluator, StaticPolicyEvaluator, generate_control_data,
    generate_sr_data,
)
from multitreegp_tpu_torch.models.evaluators.noise import make_sr_kick_rows
from multitreegp_tpu_torch.ops.initialization import make_population_sampler
from multitreegp_tpu_torch.tools import branch_probe as bp

torch.set_num_threads(1)

N = 32
ARITH = [("+", 2, 0.5), ("-", 2, 0.1), ("*", 2, 0.5), ("/", 2, 0.1)]
TRIG = [("sin", 1, 0.3), ("cos", 1, 0.3)]
INTERP_OPS = [("+", 2, 0.5), ("-", 2, 0.1), ("*", 2, 0.5), ("/", 2, 0.4)]
# an operator without a device implementation (a user's callable that the
# emitter refuses, core/user_ops.py: ``//`` has no autograd derivative): the
# kernels refuse a function set with it
NO_DEVICE_OP = ("floordiv", lambda x: x // 2.0, 1, 0.1)

_VMATH_SRC = r"""
#include <math.h>
#define MAP(F) void v##F(const float* x, float* y, long n) { for (long i = 0; i < n; ++i) y[i] = F(x[i]); }
MAP(sinf) MAP(cosf) MAP(expf) MAP(logf) MAP(tanhf) MAP(tanf)
void vpowf(const float* x, float e, float* y, long n) {
  for (long i = 0; i < n; ++i) y[i] = powf(x[i], e);
}
void vpowff(const float* x, const float* e, float* y, long n) {
  for (long i = 0; i < n; ++i) y[i] = powf(x[i], e[i]);
}
void vtanh_grad(const float* x, float* y, long n) {
  for (long i = 0; i < n; ++i) y[i] = fmaf(-x[i], x[i], 1.0f);
}
MAP(erff) MAP(erfcf) MAP(atanf) MAP(asinf) MAP(acosf) MAP(sinhf) MAP(coshf) MAP(asinhf)
MAP(acoshf) MAP(atanhf) MAP(log1pf) MAP(log2f) MAP(log10f) MAP(expm1f) MAP(exp2f)
static float sigmoidf(float x) { return 1.0f / (1.0f + expf(-x)); }
MAP(sigmoidf)
#define MAP2(F) void v##F(const float* x, const float* e, float* y, long n) { \
  for (long i = 0; i < n; ++i) y[i] = F(x[i], e[i]); }
MAP2(atan2f) MAP2(hypotf) MAP2(fmodf)
"""
_VMATH = []
# the C library's functions that patch_host_math puts under PyTorch's CPU
# kernels of the same aten ops (array function: aten op)
_LIBM_UNARY = {f"v{op}f": op for op in ("sin", "cos", "exp", "log", "tanh", "tan", "erf", "erfc", "atan",
                                         "asin", "acos", "sinh", "cosh", "asinh", "acosh", "atanh",
                                         "log1p", "log2", "log10", "expm1", "exp2", "sigmoid")}
_LIBM_BINARY = {"vatan2f": "atan2", "vhypotf": "hypot", "vfmodf": "fmod.Tensor", "vpowff": "pow.Tensor_Tensor"}


def host_vmath() -> ctypes.CDLL:
    """The C library's math functions of :data:`_LIBM_UNARY` and
    :data:`_LIBM_BINARY`, ``powf`` by a scalar and tanh's VJP factor over
    arrays (compiled once, scalar calls: no vector math library)."""
    if not _VMATH:
        out = Path(tempfile.mkdtemp(prefix="mtgp_vmath_"))
        (out / "vmath.c").write_text(_VMATH_SRC)
        cc = shutil.which("gcc") or shutil.which("cc") or shutil.which("g++")
        subprocess.run([cc, "-x", "c", "-O1", "-fno-builtin", "-shared", "-fPIC", "-o",
                        str(out / "vmath.so"), str(out / "vmath.c"), "-lm"], check=True)
        lib = ctypes.CDLL(str(out / "vmath.so"))
        for name in ("vtanh_grad", *_LIBM_UNARY):
            getattr(lib, name).argtypes = [ctypes.c_void_p, ctypes.c_void_p, ctypes.c_long]
        lib.vpowf.argtypes = [ctypes.c_void_p, ctypes.c_float, ctypes.c_void_p, ctypes.c_long]
        for name in _LIBM_BINARY:
            getattr(lib, name).argtypes = [ctypes.c_void_p] * 3 + [ctypes.c_long]
        _VMATH.append(lib)
    return _VMATH[0]


def _f32_array(x):
    return np.ascontiguousarray(x.detach().numpy(), dtype=np.float32)


def _host_map(name, x, *extra):
    a = _f32_array(x)
    out = np.empty_like(a)
    getattr(host_vmath(), name)(a.ctypes.data, *extra, out.ctypes.data, a.size)
    return torch.from_numpy(out).reshape(x.shape)


def host_pow(base, exponent):
    """``torch.pow(tensor, float)`` by the C library's ``powf``."""
    return _host_map("vpowf", base, ctypes.c_float(exponent))


def _libm_kernel(name, arity):
    """A CPU kernel of an aten op that calls the C library's function
    ``name`` on each float32 element (both operands broadcast; another dtype
    is refused)."""

    def kernel(*args):
        if arity == 2:  # a Python number arrives for a wrapped scalar
            x, y = torch.broadcast_tensors(*(a if isinstance(a, torch.Tensor) else torch.tensor(
                a, dtype=torch.float32) for a in args))
            y = _f32_array(y)  # kept alive across the call
            extra = (y.ctypes.data,)
        else:
            (x,), extra = args, ()
        if x.dtype != torch.float32:
            raise TypeError(f"host math {name}: float32 only, got {x.dtype}")
        return _host_map(name, x, *extra)

    return kernel


def _pow_scalar_kernel(x, e):
    """PyTorch's ``pow(tensor, scalar)`` on the CPU, its special cases kept
    (0 fills 1, 1 copies, 0.5 sqrt, -0.5 one over sqrt, -1 the reciprocal, 2
    and 3 products, -2 one over the square), any other exponent by
    ``powf``."""
    if x.dtype != torch.float32:
        raise TypeError(f"host math pow: float32 only, got {x.dtype}")
    a, e = _f32_array(x), float(e)
    with np.errstate(all="ignore"):
        special = {0.0: lambda: np.ones_like(a), 1.0: lambda: a.copy(), 0.5: lambda: np.sqrt(a),
                   -0.5: lambda: np.float32(1) / np.sqrt(a), -1.0: lambda: np.float32(1) / a,
                   2.0: lambda: a * a, 3.0: lambda: a * a * a, -2.0: lambda: np.float32(1) / (a * a)}
        if e in special:
            return torch.from_numpy(np.asarray(special[e](), np.float32)).reshape(x.shape)
    return host_pow(x, e)


def _sqrt_kernel(x):
    """``sqrt`` correctly rounded (numpy's float32 square root, as ``sqrtf``;
    PyTorch's CPU one may round an ulp away)."""
    with np.errstate(invalid="ignore"):
        return torch.from_numpy(np.sqrt(_f32_array(x))).reshape(x.shape)


def _tanh_backward_kernel(g, r):
    """``tanh_backward(g, r)``: ``g * (1 - r * r)`` with ``1 - r * r`` one
    fused multiply-add, as PyTorch's CUDA kernel and the kernels'
    ``tanh_grad`` compute it."""
    return g * _host_map("vtanh_grad", r)


class _AtenHostMath:
    """The aten ops' CPU kernels replaced while an instance lives (a
    ``torch.library`` registration, removed when it is freed): autograd's own
    formulas, which call these ops inside PyTorch, then run with the C
    library's functions too."""

    def __init__(self):
        import warnings

        self.lib = torch.library.Library("aten", "IMPL")
        with warnings.catch_warnings():
            warnings.simplefilter("ignore")  # "overriding a previously registered kernel"
            for name, op in _LIBM_UNARY.items():
                self.lib.impl(op, _libm_kernel(name, 1), "CPU")
            for name, op in _LIBM_BINARY.items():
                self.lib.impl(op, _libm_kernel(name, 2), "CPU")
            self.lib.impl("pow.Tensor_Scalar", _pow_scalar_kernel, "CPU")
            self.lib.impl("sqrt", _sqrt_kernel, "CPU")
            self.lib.impl("tanh_backward", _tanh_backward_kernel, "CPU")


_ATEN_HOST_MATH = type("_Holder", (), {"math": None})


def patch_host_math(m) -> None:
    """Make PyTorch's CPU kernels compute as the host build of a kernel does
    while ``m`` (a ``monkeypatch`` context) is active: the aten ops' CPU
    kernels are replaced (:class:`_AtenHostMath`) by the C library's ``sinf
    cosf expf logf tanhf tanf erff erfcf atanf asinf acosf sinhf coshf asinhf
    acoshf atanhf log1pf log2f log10f expm1f exp2f atan2f hypotf fmodf
    powf``, the sigmoid ``1 / (1 + expf(-x))``, ``pow`` by a scalar with
    PyTorch's special cases around ``powf``, a correctly rounded ``sqrt``
    and tanh's VJP with ``1 - r * r`` one ``fmaf`` (PyTorch's CUDA
    ``tanh_backward`` is contracted; the kernels write it). So autograd's
    formulas, which call these ops inside PyTorch (``erf``'s VJP calls
    ``exp``, ``pow``'s calls ``log``), use them too. PyTorch's vectorised CPU
    versions round an ulp or a few away from them on some inputs; on the
    card PyTorch's and the kernels' are the same CUDA functions. ``abs``,
    ``neg``, ``square``, ``maximum``, ``minimum``, the clamps and the
    roundings are exact on both, and stay."""
    m.setattr(_ATEN_HOST_MATH, "math", _AtenHostMath())


def chain_rows(n: int, rows: int, var_start: int):
    """Opcodes of a tree of ``rows`` rows (odd) padded to ``n``: k + 1
    leaves then k operators ``+``/``-``, ``op_k(leaf_k, op_k-1(...))``, whose
    stack holds k + 1 values, the most a tree of that many rows can."""
    k = (rows - 1) // 2
    leaves = [var_start + i % 2 if i % 3 else CONST for i in range(k + 1)]
    return [EMPTY] * (n - 2 * k - 1) + leaves + [OP_START + i % 2 for i in range(k)]


def with_chains(trees, fset, lengths):
    """``trees (P, m, n)`` with candidate i's trees replaced by the chain of
    ``lengths[i]`` rows (constant leaves 0.5)."""
    n = trees.max_nodes
    ops = trees.ops.clone()
    for i, rows in enumerate(lengths):
        ops[i] = torch.tensor(chain_rows(n, rows, fset.var_start), dtype=torch.int32)
    const = torch.where(ops == CONST, torch.where(trees.ops == CONST, trees.const, 0.5), 0.0)
    c1, c2 = rebuild_pointers(ops, fset.slots(ops.device))
    return TreeTensors(ops, c1, c2, const)


def fitness_case(device="cpu", pop=24, b=4, t_end=1.6, ops=ARITH, n=N, depth=4):
    """VdP data and a population grown to ``depth``; at ``n > 32`` the
    first candidates are chains of ``n - 1``, 127 and 63 rows (the deepest
    stacks; grown trees stay near 10-30 rows)."""
    fset = build_function_set(ops, [["x0", "x1"]], [2])
    g = torch.Generator(device=device).manual_seed(0)
    ts = torch.arange(0.0, t_end, 0.2, device=device)
    x0s, ts, ys, _ = generate_sr_data(VanDerPolOscillator(), g, ts, batch_size=b)
    trees = make_population_sampler(fset, depth, n)(g, pop)[0]
    if n > N:
        trees = with_chains(trees, fset, [n - 1, min(127, n - 1), 63])
    return fset, trees, x0s, ts, ys


def state4_case(device="cpu", pop=6, b=2, n=256, t_steps=4, ops=ARITH, seed=4):
    """State dim 4: ``pop`` candidates of 4 trees of ``n`` rows grown to
    depth 7, the first three chains of ``n - 1``, 127 and 63 rows, on ``b``
    trajectories of numpy data made from ``seed`` (x0 and ground truth
    standard normal) at ``ts = 0, 0.2, ...``: ``(fset, trees, x0s, ts, ys)``."""
    fset = build_function_set(ops, [["x0", "x1", "x2", "x3"]], [4])
    g = torch.Generator(device=device).manual_seed(seed)
    trees = make_population_sampler(fset, 7, n)(g, pop)[0]
    trees = with_chains(trees, fset, [n - 1, min(127, n - 1), min(63, n - 1)])
    rng = np.random.default_rng(seed)
    x0s = torch.from_numpy(rng.normal(size=(b, 4)).astype(np.float32)).to(device)
    ys = torch.from_numpy(rng.normal(size=(b, t_steps, 4)).astype(np.float32)).to(device)
    ts = torch.arange(t_steps, dtype=torch.float32, device=device) * 0.2
    return fset, trees, x0s, ts, ys


def reproduce_case(device="cpu", lanes=192, n=N, depths=(1, 2, 4, 5), max_init_depth=4,
                   ops=ARITH + [("sin", 1, 0.3)]):
    """Parents of ``n`` rows grown to ``depths`` (2 trees per candidate) and
    a quarter crossover lanes, the rest every copy / mutate / fresh pair."""
    fset = build_function_set(ops, [["x0", "x1"], ["x1"]], [1, 1])
    cfg = tts.make_config(fset, n, max_init_depth)
    g = torch.Generator(device=device).manual_seed(1)
    sample = lambda depth, k: make_population_sampler(fset, depth, n)(g, k)[0].map(
        lambda a: a.reshape(-1, n))
    parents = [sample(d, lanes // 8) for d in depths]
    if n > N:  # chains of n - 1 and n / 2 - 1 rows among the parents
        parents[-1] = with_chains(parents[-1], fset, [n - 1, n // 2 - 1] * 4)
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


def lanes_case(device="cpu", k=48, b=3, n=32, depth=5, seed=0, near_zero=True, ops=INTERP_OPS):
    """Trees ``(k, 2, n)`` and states ``(k, b, 2, 2)``, all made from
    ``seed``; with ``near_zero``, every third candidate's constants are near
    or at 0, so ``/`` makes huge, inf and NaN lanes."""
    fset = build_function_set(ops, [["x0", "x1"]], [2])
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


# the interpreter's layouts: trees broadcast against data as its callers
# give them (core/cuda_interpreter.py groups the lanes that share a tree)
INTERP_LAYOUTS = ("recompute", "policy", "two_dims", "unshared", "callable")
# tree sizes of the interpreter cases: N and the grow depth (bench.py's
# max_init_depth=7 at N = 256)
INTERP_SIZES = ((32, 5), (64, 6), (128, 6), (256, 7))


def interp_layout_case(layout, device="cpu", n=32, depth=5, trig=False, seed=0):
    """``(fset, trees, data, g)`` in one of the interpreter's layouts, made
    from ``seed``; ``g`` is the roots' cotangent over the joint batch. Every
    third candidate's constants are near or at 0, so ``/`` makes huge, inf
    and NaN lanes.

    * ``recompute``: trees ``(K, 1, m, N)`` against states ``(K, B, 1, d)``
      (``SRFitness``'s recompute, ``V == d``); a group is one tree's B = 5
      trajectories, which do not divide a warp;
    * ``policy``: one tree ``(K, 1, 1, N)`` against ``(K, B, 1, V)`` with
      ``V = 4`` (observations and a target; ``static_policy.py``);
    * ``two_dims``: trees ``(K, 1, 1, m, N)`` against ``(K, 3, B, 1, d)``,
      broadcast over two dimensions;
    * ``unshared``: one tree per lane, ``(K, B, m, N)`` contiguous;
    * ``callable``: one candidate ``(m, N)`` against ``(37, 1, d)``
      (``to_callable``): a group of 37 lanes spans two blocks.

    At ``n > 32`` the first three candidates are chains of ``n - 1``, 127
    and 63 rows (the longest tapes; grown trees stay near 10-30 rows)."""
    names = ["y0", "y1", "y2", "t0"] if layout == "policy" else ["x0", "x1"]
    m = 1 if layout == "policy" else 2
    fset = build_function_set(INTERP_OPS + (TRIG if trig else []), [names], [m])
    gen = torch.Generator(device=device).manual_seed(seed)
    k, b, v = 24, 5, len(names)
    pop = make_population_sampler(fset, depth, n)(gen, k)[0]
    if n > 32:
        pop = with_chains(pop, fset, [n - 1, min(127, n - 1), min(63, n - 1)])
    rng = np.random.default_rng(seed)
    small = rng.normal(size=pop.const.shape).astype(np.float32) * 1e-3
    small[rng.random(pop.const.shape) < 0.1] = 0.0
    every_third = (torch.arange(k, device=device) % 3 == 0)[:, None, None]
    pop = pop._replace(const=torch.where((pop.ops == CONST) & every_third,
                                         torch.from_numpy(small).to(device), pop.const))
    trees, shape = {
        "recompute": (pop.map(lambda a: a[:, None]), (k, b, 1, v)),
        "policy": (pop.map(lambda a: a[:, None]), (k, b, 1, v)),
        "two_dims": (pop.map(lambda a: a[:, None, None]), (k, 3, b, 1, v)),
        "unshared": (pop.map(lambda a: a[:, None].expand(k, b, m, n).contiguous()), (k, b, m, v)),
        "callable": (pop[0], (37, 1, v)),
    }[layout]
    data = torch.from_numpy(rng.normal(size=shape).astype(np.float32) * 2).to(device)
    batch = torch.broadcast_shapes(trees.ops.shape[:-1], data.shape[:-1])
    g_out = torch.from_numpy(rng.normal(size=batch).astype(np.float32)).to(device)
    return fset, trees, data, g_out


# the instance past 256 rows: N and the layouts of its callers, the
# recompute's (16 trajectories a tree) and one data vector per tree
DEEP_INTERP_SIZES = (300, 512, 1024)
DEEP_INTERP_MEMBERS = (16, 1)


def deep_interp_case(n, members, device="cpu", k=12, trig=False, seed=0):
    """``(fset, trees (k, 1, 2, n), data (k, members, 1, 2), g)``: grown
    trees (depth 7), the first three candidates chains of ``n - 1``, 127 and
    63 rows (at ``n = 1024`` second operands at rows past 511, which need
    every bit of the decoded row's ``c2`` field), every third candidate's
    constants near or at 0 (``/`` makes huge, inf and NaN lanes)."""
    fset = build_function_set(INTERP_OPS + (TRIG if trig else []), [["x0", "x1"]], [2])
    gen = torch.Generator(device=device).manual_seed(seed)
    pop = make_population_sampler(fset, 7, n)(gen, k)[0]
    pop = with_chains(pop, fset, [n - 1, 127, 63])
    rng = np.random.default_rng(seed)
    small = rng.normal(size=pop.const.shape).astype(np.float32) * 1e-3
    small[rng.random(pop.const.shape) < 0.1] = 0.0
    every_third = (torch.arange(k, device=device) % 3 == 0)[:, None, None]
    pop = pop._replace(const=torch.where((pop.ops == CONST) & every_third,
                                         torch.from_numpy(small).to(device), pop.const))
    data = torch.from_numpy(rng.normal(size=(k, members, 1, 2)).astype(np.float32) * 2).to(device)
    g_out = torch.from_numpy(rng.normal(size=(k, members, 2)).astype(np.float32)).to(device)
    return fset, pop.map(lambda a: a[:, None]), data, g_out


# the wide instance (csrc/interpreter.cu: past 1024 rows, 63 variables, 32
# operators): N, data widths, and the layouts of deep_interp_case
WIDE_INTERP_SIZES = (1025, 2048, 4096)
WIDE_INTERP_VARS = (33, 40, 70)


def stack_pointers(ops, slots):
    """``(c1, c2)`` of one tree's opcodes (a list) by a postorder stack, in
    O(N): ``rebuild_pointers`` holds an N x N table per tree."""
    c1, c2, stack = [-1] * len(ops), [-1] * len(ops), []
    for i, op in enumerate(ops):
        arity = int(slots[op]) if 0 <= op < len(slots) else 0
        if op == EMPTY:
            continue
        for _ in range(arity):
            below = stack.pop()
        if arity:
            c1[i] = i - 1
        if arity == 2:
            c2[i] = below
        stack.append(i)
    return c1, c2


def wide_chain_rows(n, rows, var_start, nvar, zigzag):
    """Opcodes of a tree of ``rows`` rows (odd) padded to ``n``: with
    ``zigzag``, ``op_k(op_k-1(...), leaf_k)`` (each operator's second operand
    the operator two rows below it, so second operands reach row n - 3), else
    :func:`chain_rows`' shape (k + 1 leaves, then k operators: the deepest
    stack, second operands down to the first leaf); leaves cycle through
    constants and the ``nvar`` variables, the last first."""
    k = (rows - 1) // 2
    leaf = [var_start + (nvar - i % nvar) % nvar if i % 3 else CONST for i in range(k + 1)]
    opers = [OP_START + i % 2 for i in range(k)]
    body = ([leaf[0]] + [r for i in range(k) for r in (leaf[i + 1], opers[i])] if zigzag
            else leaf + opers)
    return [EMPTY] * (n - 2 * k - 1) + body


def wide_interp_case(n, members, device="cpu", k=6, trig=False, nvar=2, seed=0):
    """``(fset, trees (k, 1, 2, n), data (k, members, 1, nvar), g)`` for the
    wide instance: trees grown to depth 7 over ``nvar`` variables, the first
    three candidates chains of ``n - 1`` rows (the deepest stack; the zigzag,
    whose second operands reach row n - 3) and 127 rows, every third
    candidate's constants near or at 0 (``/`` makes huge, inf and NaN
    lanes)."""
    names = [f"x{i}" for i in range(nvar)]
    fset = build_function_set(INTERP_OPS + (TRIG if trig else []), [names], [2])
    gen = torch.Generator().manual_seed(seed)
    pop = make_population_sampler(fset, 7 if n >= 127 else 4, n)(gen, k)[0]
    ops, c1, c2 = (t.clone() for t in (pop.ops, pop.c1, pop.c2))
    slots = fset.slots().tolist()
    for i, (rows, zigzag) in enumerate(((n - 1, False), (n - 1, True), (min(127, n - 1), False))):
        for j in range(2):
            tree = wide_chain_rows(n, rows, fset.var_start, nvar, zigzag)
            ops[i, j] = torch.tensor(tree, dtype=torch.int32)
            p1, p2 = stack_pointers(tree, slots)
            c1[i, j], c2[i, j] = torch.tensor(p1), torch.tensor(p2)
    rng = np.random.default_rng(seed)
    const = torch.where(ops == CONST, torch.where(pop.ops == CONST, pop.const, 0.5), 0.0)
    small = torch.from_numpy(rng.normal(size=const.shape).astype(np.float32) * 1e-3)
    small[torch.from_numpy(rng.random(const.shape) < 0.1)] = 0.0
    every_third = (torch.arange(k) % 3 == 0)[:, None, None]
    const = torch.where((ops == CONST) & every_third, small, const)
    trees = TreeTensors(ops, c1, c2, const).map(lambda a: a[:, None].to(device))
    data = torch.from_numpy(rng.normal(size=(k, members, 1, nvar)).astype(np.float32) * 2).to(device)
    g_out = torch.from_numpy(rng.normal(size=(k, members, 2)).astype(np.float32)).to(device)
    return fset, trees, data, g_out


def many_operator_set(nvar=2):
    """A set of 33 operators: the 17 of the table and the first 16 unary
    callables of ``registry.vocabulary_operators()`` (user operators,
    device ids 17-32), on ``nvar`` variables, 2 trees."""
    from multitreegp_tpu_torch.core.registry import DEVICE_OPS, vocabulary_operators

    table = [(name, 2 if name in ("+", "-", "*", "/", "pow", "max", "min") else 1, 1.0)
             for name in DEVICE_OPS]
    ops = table + [(name, fn, 1, 1.0) for name, fn, _ in vocabulary_operators()[0][:16]]
    return build_function_set(ops, [[f"x{i}" for i in range(nvar)]], [2])


def many_operator_case(device="cpu", k=24, b=5, n=32, depth=5, seed=0):
    """``(fset, trees (k, 1, 2, n), data (k, b, 1, 2), g)``: the recompute's
    layout with :func:`many_operator_set`'s 33 operators, trees grown to
    ``depth``."""
    fset = many_operator_set()
    gen = torch.Generator().manual_seed(seed)
    pop = make_population_sampler(fset, depth, n)(gen, k)[0]
    rng = np.random.default_rng(seed)
    data = torch.from_numpy(rng.normal(size=(k, b, 1, 2)).astype(np.float32) * 1.5).to(device)
    g_out = torch.from_numpy(rng.normal(size=(k, b, 2)).astype(np.float32)).to(device)
    return fset, pop.map(lambda a: a[:, None].to(device)), data, g_out


def lorenz96_data(b, t_steps, dim=40, forcing=8.0, dt=0.05, seed=0):
    """``(x0s (b, dim), ts (t_steps,), ys (b, t_steps, dim))`` float32:
    Lorenz-96 (Lorenz 1996), ``dx_i/dt = (x_{i+1} - x_{i-2}) x_{i-1} - x_i
    + F``, from ``x0 ~ F + N(0, 1)`` (numpy, ``seed``), integrated in float64
    by RK4 at ``dt`` and saved every 0.2 (the main path's grid)."""
    rng = np.random.default_rng(seed)
    x = forcing + rng.normal(size=(b, dim))

    def drift(v):
        return (np.roll(v, -1, -1) - np.roll(v, 2, -1)) * np.roll(v, 1, -1) - v + forcing

    save = round(0.2 / dt)
    ys = [x]
    for _ in range((t_steps - 1) * save):
        k1 = drift(x)
        k2 = drift(x + dt / 2 * k1)
        k3 = drift(x + dt / 2 * k2)
        k4 = drift(x + dt * k3)
        x = x + dt / 6 * (k1 + 2 * k2 + 2 * k3 + k4)
        ys.append(x)
    ys = np.stack(ys[::save], 1).astype(np.float32)
    ts = (np.arange(t_steps) * 0.2).astype(np.float32)
    return torch.from_numpy(ys[:, 0].copy()), torch.from_numpy(ts), torch.from_numpy(ys)


def per_lane_operands(trees, data):
    """Trees and data expanded to one per lane of their joint batch and
    copied, so the plain VJP's cotangents are per lane, summed over nothing."""
    batch = torch.broadcast_shapes(trees.ops.shape[:-1], data.shape[:-1])
    full = trees.map(lambda a: a.expand(batch + a.shape[-1:]).contiguous())
    return full, data.expand(batch + data.shape[-1:]).contiguous()


def c2_case(device="cpu"):
    """``(fset, trees (2, 1, 2, 8), data (2, 5, 1, 2), g)``: hand-made trees
    whose second operands are rows that a postorder stack would not pop
    (row 1 read twice; a row read as both operands, c2 == i-1; c2 at an
    EMPTY row below the tree's first live row, at the row itself, above it,
    and -1; a live row 0 that no row reads, so a lane that ran this tree
    before leaves a value where the next tree's EMPTY row 0 lies), so the
    interpreter's c2 semantics decide their values. Two of the trees have
    sin rows."""
    fset = build_function_set(INTERP_OPS + TRIG[:1], [["x0", "x1"]], [2])
    x0, x1 = fset.var_start, fset.var_start + 1
    add, sub, mul, div, sin = (fset.string_to_op[o] for o in ("+", "-", "*", "/", "sin"))
    rows = [
        # (ops, c2) of rows 0-7, padding first, root last
        ([CONST, CONST, x0, add, CONST, mul, div, mul], [-1, -1, -1, 1, -1, 1, 3, 6]),
        ([EMPTY, EMPTY, x1, sin, CONST, add, mul, div], [-1, -1, -1, 0, -1, 0, 2, 9]),
        ([EMPTY, CONST, x1, sub, x0, add, sin, mul], [-1, -1, -1, 1, -1, 3, 5, 2]),
        ([EMPTY, x0, x1, mul, CONST, div, add, sub], [-1, -1, -1, 0, -1, 1, 6, 4]),
    ]
    ops = torch.tensor([r[0] for r in rows], dtype=torch.int32).reshape(2, 1, 2, 8)
    c2 = torch.tensor([r[1] for r in rows], dtype=torch.int32).reshape(2, 1, 2, 8)
    const = torch.where(ops == CONST, torch.tensor([1.5, 0.25, -0.75, 2.0] * 8).reshape(2, 1, 2, 8),
                        torch.tensor(0.0))
    trees = TreeTensors(ops, (torch.arange(8, dtype=torch.int32) - 1).expand(2, 1, 2, 8).contiguous(),
                        c2, const).map(lambda a: a.to(device))
    rng = np.random.default_rng(3)
    data = torch.from_numpy(rng.normal(size=(2, 5, 1, 2)).astype(np.float32)).to(device)
    g_out = torch.from_numpy(rng.normal(size=(2, 5, 2)).astype(np.float32)).to(device)
    return fset, trees, data, g_out


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


def fitness_host(lib, trees, x0s, ts, ys, fset, method, substeps, kick_rows=None):
    """The host build of kernel #1: ``(mse, alive)`` as numpy arrays; with
    ``kick_rows (T, B, substeps * d)`` its Euler-Maruyama leg."""
    p, b = trees.ops.shape[0], x0s.shape[0]
    err = np.zeros((p, b), np.float32)
    alive_h = np.zeros((p, b), np.uint8)
    fn = lib.sr_fitness_host
    fn.argtypes = [ctypes.c_void_p] * 9 + [ctypes.c_int] * 9
    arrays = [np.ascontiguousarray(a.numpy()) for a in (trees.ops, trees.const, fset.device_ops(),
                                                        x0s, ts, ys)]
    kicks = None if kick_rows is None else np.ascontiguousarray(kick_rows.numpy())
    status = fn(*(a.ctypes.data for a in arrays), None if kicks is None else kicks.ctypes.data,
                err.ctypes.data, alive_h.ctypes.data, p, x0s.shape[1], trees.ops.shape[-1], b,
                ts.shape[0], fset.var_start, fset.has_unary, METHODS[method], substeps)
    assert status == 0
    return err / np.float32(ts.shape[0]), alive_h.astype(bool)


@pytest.mark.parametrize("method,substeps", [("euler", 2), ("heun", 1), ("rk4", 1), ("rk4", 3)])
def test_fitness_host_build_bit_exact(host_libs, method, substeps):
    fset, trees, x0s, ts, ys = fitness_case()
    mse, alive = sr_fitness_plain(trees, x0s, ts, ys, fset, method, substeps)
    err, alive_h = fitness_host(host_libs["sr_fitness"], trees, x0s, ts, ys, fset, method, substeps)
    np.testing.assert_array_equal(alive_h, alive.numpy())
    np.testing.assert_array_equal(err, mse.numpy())
    assert (~alive.numpy()).any() and alive.numpy().any()


@pytest.mark.parametrize("method,substeps", [("euler", 2), ("rk4", 1)])
def test_fitness_host_build_deep_bit_exact(host_libs, method, substeps):
    """The instance for N <= 256 (local-memory stack of 128 slots) on trees
    of 128 rows grown to depth 7."""
    fset, trees, x0s, ts, ys = fitness_case(n=128, depth=7)
    mse, alive = sr_fitness_plain(trees, x0s, ts, ys, fset, method, substeps)
    err, alive_h = fitness_host(host_libs["sr_fitness"], trees, x0s, ts, ys, fset, method, substeps)
    np.testing.assert_array_equal(alive_h, alive.numpy())
    np.testing.assert_array_equal(err, mse.numpy())


@pytest.mark.parametrize("method", ["heun", "rk4"])
def test_fitness_host_build_trig_bit_exact(host_libs, monkeypatch, method):
    """Kernel #1 with ``sin`` and ``cos`` in the trees (unary rows rewrite the
    top of the stack): bit for bit with the host's ``sinf``/``cosf`` in the
    plain version."""
    fset, trees, x0s, ts, ys = fitness_case(ops=ARITH + TRIG)
    unary = (trees.ops == fset.string_to_op["sin"]) | (trees.ops == fset.string_to_op["cos"])
    assert bool(unary.any())
    with monkeypatch.context() as m:
        patch_host_math(m)
        mse, alive = sr_fitness_plain(trees, x0s, ts, ys, fset, method, 1)
    err, alive_h = fitness_host(host_libs["sr_fitness"], trees, x0s, ts, ys, fset, method, 1)
    np.testing.assert_array_equal(alive_h, alive.numpy())
    np.testing.assert_array_equal(err, mse.numpy())
    assert (~alive.numpy()).any() and alive.numpy().any()


def reproduce_host(lib, args, cfg, rows=None):
    """The host build of kernel #2 on ``reproduce_case``'s ``(N, L)`` tiles
    (passed lane-major, as the CUDA wrapper passes them): ``(status, four
    (N, L) child arrays)``."""
    n, lanes = args[0].shape
    outs = [np.zeros((lanes, n), dt) for dt in (np.int32, np.float32, np.int32, np.float32)]
    lane_major = (0, 1, 2, 3, 8)  # the (N, L) parents and u (R, L)
    ins = [np.ascontiguousarray(a.T.numpy() if i in lane_major else
                                a.numpy().astype(np.uint8) if a.dtype == torch.bool else a.numpy())
           for i, a in enumerate(args)]
    tables = [np.asarray(cfg.slots, np.int32), np.asarray(cfg.operator_probs, np.float32),
              decay_table(cfg).numpy()]
    fn = lib.reproduce_host
    fn.argtypes = [ctypes.c_void_p] * 16 + [ctypes.c_int] * 8 + [ctypes.c_float, ctypes.c_int]
    status = fn(*(a.ctypes.data for a in ins + outs + tables), lanes, n, cfg.num_vars,
                cfg.num_operators, cfg.var_start, cfg.max_init_depth, cfg.cx_retries,
                cfg.mut_retries, cfg.coefficient_sd, args[-1].shape[0] if rows is None else rows)
    return status, [o.T for o in outs]


def test_reproduce_host_build_matches_plain(host_libs):
    cfg, args = reproduce_case()
    ref = reproduce_lanes_plain(*args, cfg)
    status, outs = reproduce_host(host_libs["reproduce"], args, cfg)
    assert status == 0
    np.testing.assert_array_equal(outs[0], ref[0].numpy())
    np.testing.assert_array_equal(outs[2], ref[2].numpy())
    np.testing.assert_allclose(outs[1], ref[1].numpy(), rtol=1e-6, atol=0)
    np.testing.assert_allclose(outs[3], ref[3].numpy(), rtol=1e-6, atol=0)
    # a wrong row count is refused
    assert reproduce_host(host_libs["reproduce"], args, cfg, args[-1].shape[0] - 1)[0] != 0


def test_reproduce_host_build_deep_matches_plain(host_libs):
    """The warp code's instance for N <= 256 (8 rows a thread) on parents of
    128 rows grown up to depth 7, fresh trees at depth 7."""
    cfg, args = reproduce_case(lanes=96, n=128, depths=(1, 3, 5, 7), max_init_depth=7)
    ref = reproduce_lanes_plain(*args, cfg)
    status, outs = reproduce_host(host_libs["reproduce"], args, cfg)
    assert status == 0 and int((ref[0] != 0).sum(0).max()) > 32
    np.testing.assert_array_equal(outs[0], ref[0].numpy())
    np.testing.assert_array_equal(outs[2], ref[2].numpy())
    np.testing.assert_allclose(outs[1], ref[1].numpy(), rtol=1e-6, atol=0)
    np.testing.assert_allclose(outs[3], ref[3].numpy(), rtol=1e-6, atol=0)


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
def test_fitness_kernel_with_kicks_matches_plain_on_card(cuda):
    """Kernel #1's Euler-Maruyama leg: the kick rows built on the card, the
    kernel against its plain version, bit for bit per lane."""
    fset, trees, x0s, ts, ys = fitness_case(cuda, pop=512, b=16, t_end=2.0)
    keys = generate_sr_data(VanDerPolOscillator(0.1), torch.Generator(device=cuda).manual_seed(3),
                            ts, batch_size=16)[3]
    kicks = make_sr_kick_rows(0.2, ts, keys, 4, 2)
    before = sr_fitness_cuda.launches
    mse, alive = sr_fitness(trees, x0s, ts, ys, fset, "euler", 4, kicks)
    ref, ref_alive = sr_fitness_plain(trees, x0s, ts, ys, fset, "euler", 4, kicks)
    torch.cuda.synchronize()
    assert sr_fitness_cuda.launches == before + 1
    assert torch.equal(alive, ref_alive) and same_bits(mse, ref)
    plain_ode, _ = sr_fitness_plain(trees, x0s, ts, ys, fset, "euler", 4)
    assert not torch.equal(mse, plain_ode)


@pytest.mark.cuda
@pytest.mark.parametrize("mode", bp.MODES)
def test_branch_probe_matches_plain_on_card(cuda, mode):
    """Kernel #10 in every mode against its plain version, bit for bit, on
    the probe's 256 tiles (two blocks an SM)."""
    x = bp.probe_input(mode, bp.REPS, cuda)
    before = bp.probe_cuda.launches
    out = bp.probe(x, mode)
    ref = bp.probe_plain(x, mode)
    torch.cuda.synchronize()
    assert bp.probe_cuda.launches == before + 1 and torch.equal(out, ref)


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
@pytest.mark.parametrize("kicks", [False, True])
def test_fitness_kernel_deep_matches_plain_on_card(cuda, kicks):
    """#1's instance for N <= 256 on trees of 256 rows grown to depth 7,
    with and without kick rows: every lane bit for bit."""
    fset, trees, x0s, ts, ys = fitness_case(cuda, pop=256, b=16, t_end=2.0, n=256, depth=7)
    method, sub, rows = "rk4", 1, None
    if kicks:
        keys = generate_sr_data(VanDerPolOscillator(0.1), torch.Generator(device=cuda).manual_seed(3),
                                ts, batch_size=16)[3]
        method, sub, rows = "euler", 4, make_sr_kick_rows(0.2, ts, keys, 4, 2)
    before = sr_fitness_cuda.launches
    mse, alive = sr_fitness(trees, x0s, ts, ys, fset, method, sub, rows)
    ref, ref_alive = sr_fitness_plain(trees, x0s, ts, ys, fset, method, sub, rows)
    torch.cuda.synchronize()
    assert sr_fitness_cuda.launches == before + 1
    assert torch.equal(alive, ref_alive) and same_bits(mse, ref)


@pytest.mark.cuda
def test_reproduce_kernel_deep_matches_plain_on_card(cuda):
    """#2's instance for N <= 256 (8 rows a thread) on parents of 256 rows
    grown up to depth 7: identical opcodes on every lane."""
    cfg, args = reproduce_case(cuda, lanes=512, n=256, depths=(1, 3, 5, 7), max_init_depth=7)
    before = reproduce_lanes_cuda.launches
    out = reproduce_lanes(*args, cfg)
    ref = reproduce_lanes_plain(*args, cfg)
    torch.cuda.synchronize()
    assert reproduce_lanes_cuda.launches == before + 1
    assert torch.equal(out[0], ref[0]) and torch.equal(out[2], ref[2])
    torch.testing.assert_close(out[1], ref[1], rtol=1e-6, atol=0)
    torch.testing.assert_close(out[3], ref[3], rtol=1e-6, atol=0)


@pytest.mark.cuda
@pytest.mark.parametrize("case", ["m_ne_d", "d5", "b1025"])
def test_sr_evaluator_general_path_on_card(cuda, case):
    """Configurations the fused kernels do not take (``m != d``), and d = 5
    and B = 1025 with ``interpreter="gather"`` (the fused gate takes them,
    in #1's wide instance: ``test_torch_wide_state.py``), evaluate through
    the general path on the card, kernel #8 as the drift, not #1; the
    fitness equals the same evaluation on CPU copies to the general path's
    tolerance (rtol 1e-5: the card's and the CPU's division round alike,
    their sums over B do not)."""
    d = 5 if case == "d5" else 2
    m = 1 if case == "m_ne_d" else d
    b = 1025 if case == "b1025" else 16
    names = [f"x{i}" for i in range(d)]
    fset = build_function_set(ARITH, [names], [m])
    g = torch.Generator(device=cuda).manual_seed(4)
    trees = make_population_sampler(fset, 3, 16)(g, 32)[0]
    ts = torch.arange(0.0, 1.0, 0.2, device=cuda)
    x0s = torch.rand((b, d), generator=g, device=cuda)
    ys = torch.rand((b, ts.shape[0], d), generator=g, device=cuda)
    ev = SREvaluator(fset, substeps=1, interpreter="auto" if case == "m_ne_d" else "gather")
    assert not ev._fused(trees, x0s)
    fit0, fwd0 = sr_fitness_cuda.launches, ci.evaluate_trees_cuda.launches
    wide0 = cro.sr_fitness_wide_cuda.launches
    fitness = ev.evaluate_population(trees, (x0s, ts, ys, None))
    torch.cuda.synchronize()
    assert sr_fitness_cuda.launches == fit0 and ci.evaluate_trees_cuda.launches > fwd0
    assert cro.sr_fitness_wide_cuda.launches == wide0
    cpu = ev.evaluate_population(trees.map(lambda a: a.cpu()), (x0s.cpu(), ts.cpu(), ys.cpu(), None))
    torch.testing.assert_close(fitness.cpu(), cpu, rtol=1e-5, atol=0)


@pytest.mark.cuda
def test_policy_evaluator_general_path_on_card(cuda):
    """On 1025 trajectories (a candidate spans gridDim.y blocks) the static
    evaluator takes #6's fixed instance, one launch and no #8; with
    ``interpreter="gather"`` the general path (#8), not #6, and does not
    raise."""
    env, fset, (x0, ts, tgt, pk, ok, par), trees = policy_case(cuda, pop=16, b=1025, t_end=1.0)
    data = (x0, ts, tgt, pk, ok, par)
    for interpreter, kind in (("auto", "fixed"), ("gather", None)):
        ev = StaticPolicyEvaluator(env, fset, substeps=2, interpreter=interpreter)
        assert ev._fused_kind(trees, data) == kind
        before, fwd = cp.policy_rollout_cuda.launches, ci.evaluate_trees_cuda.launches
        fitness = ev.evaluate_population(trees, data)
        torch.cuda.synchronize()
        fused = cp.policy_rollout_cuda.launches - before
        assert (fused, ci.evaluate_trees_cuda.launches > fwd) == ((1, False) if kind else (0, True))
        assert fitness.shape == (16,) and bool(((fitness >= 0) & (fitness <= 1e4)).all())


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
    user_set = build_function_set(INTERP_OPS + [NO_DEVICE_OP], [["x0", "x1"]], [2])
    with pytest.raises(NotImplementedError):  # never the plain version on CUDA tensors
        evaluate_trees(full, data, user_set)
    cpu = full.map(lambda a: a.cpu())  # the plain path on the CPU
    assert same_bits(evaluate_trees(cpu, data.cpu(), user_set),
                     evaluate_trees_plain(cpu, data.cpu(), user_set))


def check_interpreter_on_card(fset, trees, data, g):
    """#8 through its wrapper and #9 through ``run_backward`` (per-lane
    outputs) against the plain version and autograd through it, per lane."""
    fwd0 = ci.evaluate_trees_cuda.launches
    out = ci.evaluate_trees_cuda(trees, data, fset)
    status, dconst, ddata = ci.run_backward(_build.load("interpreter", fset.variant).interpret_bwd,
                                            trees, data, g, fset,
                                            torch.cuda.current_stream().cuda_stream)
    torch.cuda.synchronize()
    assert status == 0 and ci.evaluate_trees_cuda.launches == fwd0 + 1
    full, x = per_lane_operands(trees, data)
    ref = evaluate_trees_plain(full, x, fset)
    ref_c, ref_d = evaluate_trees_vjp_plain(full, x, g, fset)
    assert same_bits(out, ref) and same_bits(dconst, ref_c) and same_bits(ddata, ref_d)
    assert (ref_c != 0).any()


@pytest.mark.cuda
@pytest.mark.parametrize("trig", [False, True], ids=["arith", "trig"])
@pytest.mark.parametrize("n,depth", INTERP_SIZES)
@pytest.mark.parametrize("layout", INTERP_LAYOUTS)
def test_interpreter_layouts_match_plain_on_card(cuda, layout, n, depth, trig):
    """#8 and #9 in each caller's layout (lanes grouped by the tree they
    share) at N = 32 to 256, with and without ``sin``/``cos``: roots and
    per-lane ``dconst``/``ddata`` bit for bit."""
    check_interpreter_on_card(*interp_layout_case(layout, cuda, n, depth, trig))


@pytest.mark.cuda
@pytest.mark.parametrize("members", DEEP_INTERP_MEMBERS)
@pytest.mark.parametrize("n", DEEP_INTERP_SIZES)
def test_interpreter_deep_match_plain_on_card(cuda, n, members):
    """#8 and #9's instance past 256 rows (N = 300, 512, 1024) in the
    recompute's layout (16 trajectories a tree) and with one data vector a
    tree (at 1024 rows a block then runs 16 lanes): roots and per-lane
    ``dconst``/``ddata`` bit for bit."""
    check_interpreter_on_card(*deep_interp_case(n, members, cuda))


@pytest.mark.cuda
def test_interpreter_deep_trig_on_card(cuda):
    check_interpreter_on_card(*deep_interp_case(512, 16, cuda, trig=True))


@pytest.mark.cuda
def test_interpreter_refuses_past_its_limit_on_card(cuda, monkeypatch):
    """Past the rows one block's tape holds in the scratch budget the
    wrapper raises ``NotImplementedError``; at the limit the wide instance
    runs, bit for bit."""
    monkeypatch.setattr(ci, "SCRATCH_BYTES", 1500 * ci.THREADS * 8)
    ci._layouts.clear()
    fset, trees, data, _ = wide_interp_case(1501, 1, cuda, k=3)
    with pytest.raises(NotImplementedError):
        ci.evaluate_trees_cuda(trees, data, fset)
    check_interpreter_on_card(*wide_interp_case(1500, 1, cuda, k=3))
    ci._layouts.clear()


@pytest.mark.cuda
@pytest.mark.parametrize("members", DEEP_INTERP_MEMBERS)
@pytest.mark.parametrize("n", WIDE_INTERP_SIZES)
def test_interpreter_wide_match_plain_on_card(cuda, n, members):
    """#8 and #9's wide instance past 1024 rows (N = 1025, 2048, 4096;
    chains of N - 1 rows, second operands up to row N - 3) in the
    recompute's layout and with one data vector a tree: roots and per-lane
    ``dconst``/``ddata`` bit for bit, one launch each."""
    check_interpreter_on_card(*wide_interp_case(n, members, cuda, k=6 if n < 4096 else 3))


@pytest.mark.cuda
@pytest.mark.parametrize("n,nvar", [(32, 40), (32, 70), (2048, 40)])
def test_interpreter_many_variables_on_card(cuda, n, nvar):
    """40 variables (the fixed instance at N = 32, the wide one at 2048) and
    70 (the wide one): bit for bit per lane."""
    check_interpreter_on_card(*wide_interp_case(n, 16, cuda, k=6, nvar=nvar))


@pytest.mark.cuda
def test_interpreter_many_operators_on_card(cuda):
    """A set of 33 operators (17 of the table, 16 user operators) through
    the wide instance of its user build: bit for bit per lane."""
    check_interpreter_on_card(*many_operator_case(cuda, k=256, b=16))


def wide_sr_case(device, kind):
    """``(fset, trees, data)`` of the SR evaluator past the fixed instances:
    ``"n2048"`` VdP at ``max_nodes=2048`` (grown to depth 10), ``"lorenz96"``
    40 trees of 32 rows grown to depth 2 on Lorenz-96 data
    (:func:`lorenz96_data`; deeper random trees diverge on all of it),
    ``"ops33"`` VdP with :func:`many_operator_set`'s 33 operators."""
    g = torch.Generator(device=device).manual_seed(7)
    if kind == "lorenz96":
        fset = build_function_set(ARITH, [[f"x{i}" for i in range(40)]], [40])
        x0s, ts, ys = lorenz96_data(2, 6, seed=7)
        trees = make_population_sampler(fset, 2, 32)(g, 8)[0]
        return fset, trees, tuple(t.to(device) for t in (x0s, ts, ys)) + (None,)
    fset = many_operator_set() if kind == "ops33" else build_function_set(ARITH, [["x0", "x1"]], [2])
    n, depth = (2048, 10) if kind == "n2048" else (32, 4)
    trees = make_population_sampler(fset, depth, n)(g, 8)[0]
    ts = torch.arange(0.0, 1.2, 0.2, device=device)
    x0s, _, ys, _ = generate_sr_data(VanDerPolOscillator(), g, ts, batch_size=4)
    return fset, trees, (x0s, ts, ys, None)


@pytest.mark.cuda
@pytest.mark.parametrize("kind", ["n2048", "lorenz96", "ops33"])
def test_sr_evaluator_wide_on_card(cuda, kind):
    """``SREvaluator`` past the fixed interpreter instances (2048 rows; 40
    states and trees and 33 operators, with ``interpreter="gather"``) takes
    the general path on the card, #8 as the drift, and equals the same evaluation on CPU copies (the plain versions)
    to the general path's tolerance (rtol 1e-5); its gradient runs #9."""
    fset, trees, data = wide_sr_case(cuda, kind)
    # the 33-operator VdP case and the 40-state one fit the fused gate (#1,
    # the latter in its wide instance): "gather" asks for the general path,
    # as the 2048-row case takes it by default
    ev = SREvaluator(fset, substeps=1, interpreter="auto" if kind == "n2048" else "gather")
    assert not ev._fused(trees, data[0])
    fwd0, bwd0 = ci.evaluate_trees_cuda.launches, ci.evaluate_trees_vjp_cuda.launches
    fitness = ev.evaluate_population(trees, data)
    torch.cuda.synchronize()
    assert ci.evaluate_trees_cuda.launches > fwd0
    cpu = ev.evaluate_population(trees.map(lambda a: a.cpu()),
                                 tuple(t.cpu() if t is not None else t for t in data))
    fin = torch.isfinite(cpu)
    assert torch.equal(torch.isfinite(fitness.cpu()), fin) and bool(fin.any())
    torch.testing.assert_close(fitness.cpu()[fin], cpu[fin], rtol=1e-5, atol=0)
    const = trees.const.clone().requires_grad_(True)
    with torch.enable_grad():
        fit = ev.evaluate_population(trees._replace(const=const), data)
        torch.autograd.grad(torch.where(torch.isfinite(fit), fit, 0.0).sum(), const)
    torch.cuda.synchronize()
    assert ci.evaluate_trees_vjp_cuda.launches > bwd0


@pytest.mark.cuda
def test_interpreter_c2_semantics_on_card(cuda):
    """#8 and #9 read row ``c2`` as the plain version does on hand-made
    trees a postorder stack would evaluate otherwise."""
    check_interpreter_on_card(*c2_case(cuda))


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
    user_set = build_function_set(ARITH + [NO_DEVICE_OP], [["x0", "x1"]], [2])
    with pytest.raises(NotImplementedError):  # an operator the kernels lack
        ca.sr_fitness_adaptive(trees, x0s, ts, ys, user_set)
    cpu = [t.cpu() for t in (x0s, ts, ys)]  # the plain path on the CPU
    got = ca.sr_fitness_adaptive(trees[:2].map(lambda a: a.cpu()), *cpu, user_set)
    ref = ca.sr_fitness_adaptive_interval_plain(trees[:2].map(lambda a: a.cpu()), *cpu, user_set)
    assert same_bits(got[0], ref[0]) and torch.equal(got[1], ref[1])
    with pytest.raises(NotImplementedError):  # N > 256
        wide = trees.map(lambda a: torch.cat([a, a[..., :1].expand(*a.shape[:-1], 240)], -1))
        ca.sr_fitness_adaptive_global(wide, x0s, ts, ys, fset)


@pytest.mark.cuda
@pytest.mark.parametrize("method,trig", [("dopri5", False), ("bosh3", True)])
def test_adaptive_kernels_deep_match_plain_on_card(cuda, method, trig):
    """#5 and #4's instances for N <= 256, one launch each, every lane's
    error sum, alive and attempted steps equal to the plain version on the
    card (budgets 40 for the whole solve, 8 per interval; bosh3 with sin and
    cos): 256 VdP candidates of 256 rows (chains of 255, 127 and 63 rows,
    then trees grown to depth 7) x 16 trajectories at T = 4; state dim 4 at
    N = 256 with 24 candidates x 16 trajectories (a block's decoded trees
    pass 48 KB of shared memory) and 4 candidates x 1024 trajectories (a
    candidate spans 8 blocks)."""
    ops = ARITH + TRIG if trig else ARITH
    cases = (fitness_case(cuda, pop=256, b=16, t_end=0.8, ops=ops, n=256, depth=7),
             state4_case(cuda, pop=24, b=16, ops=ops), state4_case(cuda, pop=4, b=1024, ops=ops))
    for fset, trees, x0s, ts, ys in cases:
        for kernel, plain, budget in (
                (ca.sr_fitness_adaptive_global_cuda, ca.sr_fitness_adaptive_global_plain, 40),
                (ca.sr_fitness_adaptive_interval_cuda, ca.sr_fitness_adaptive_interval_plain, 8)):
            before = kernel.launches
            mse, alive, steps = kernel(trees, x0s, ts, ys, fset, 1e-4, 1e-6, budget, method)
            ref, ref_alive, ref_steps = plain(trees, x0s, ts, ys, fset, 1e-4, 1e-6, budget, method)
            torch.cuda.synchronize()
            assert kernel.launches == before + 1
            assert torch.equal(alive, ref_alive) and torch.equal(steps, ref_steps)
            assert same_bits(mse, ref) and bool((steps > 0).all())


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


@pytest.mark.cuda
@pytest.mark.parametrize("case", ["n256", "n256_trig", "d4_b1024", "p1_b16"])
def test_rollout_kernel_shapes_match_plain_on_card(cuda, case):
    """#3 against its plain version, every state and liveness bit, one
    launch: its N <= 256 instance on 256 candidates of 256 rows (chains of
    255, 127 and 63 rows, then trees grown to depth 7) x 16 trajectories,
    with and without sin/cos; state dim 4 at N = 256 with 4 candidates x 1024
    trajectories (a candidate spans 8 blocks of 128 threads); and the
    inspection shape of ``evaluate_candidate``, one candidate x 16
    trajectories at T = 50."""
    if case.startswith("n256"):
        ops = ARITH + TRIG if case.endswith("trig") else ARITH
        fset, trees, x0s, ts, _ = fitness_case(cuda, pop=256, b=16, t_end=2.0, ops=ops, n=256, depth=7)
    elif case == "d4_b1024":
        fset, trees, x0s, ts, _ = state4_case(cuda, pop=4, b=1024, t_steps=8)
    else:
        fset, trees, x0s, ts, _ = fitness_case(cuda, pop=1, b=16, t_end=10.0)
    before = cro.sr_rollout_cuda.launches
    xs, alive = cro.sr_rollout(trees, x0s, ts, fset, "rk4", 1)
    ref, ref_alive = cro.sr_rollout_plain(trees, x0s, ts, fset, "rk4", 1)
    torch.cuda.synchronize()
    assert cro.sr_rollout_cuda.launches == before + 1
    assert torch.equal(alive, ref_alive) and same_bits(xs, ref) and bool(alive.any())


POLICY_OPS = [("+", 2), ("-", 2), ("*", 2), ("sin", 1), ("cos", 1)]


def policy_case(device="cpu", env=None, state_size=0, pop=24, b=4, t_end=2.2, mode="Constant",
                n=30, ops=POLICY_OPS, depth=4):
    """A control environment's data and a population of policies: static
    (variables ``[y, tgt]``) or dynamic (``[y, a, u, tgt]``, then the
    readout's ``[a, tgt]``)."""
    env = env or Acrobot()
    ys = [f"y{i}" for i in range(env.n_obs)]
    tg = [f"tgt{i}" for i in range(env.n_targets)]
    if state_size:
        a = [f"a{i}" for i in range(state_size)]
        u = [f"u{i}" for i in range(env.n_control)]
        fset = build_function_set(ops, [ys + a + u + tg, a + tg], [state_size, env.n_control])
    else:
        fset = build_function_set(ops, [ys + tg], [env.n_control])
    g = torch.Generator(device=device).manual_seed(0)
    ts = torch.arange(0.0, t_end, 0.2, device=device)
    data = generate_control_data(env, g, ts, batch_size=b, param_mode=mode)
    return env, fset, data, make_population_sampler(fset, depth, n)(g, pop)[0]


@pytest.mark.cuda
@pytest.mark.parametrize("state_size", [0, 2])
def test_policy_kernels_match_plain_on_card(cuda, state_size):
    """#6 (RK4, 2 substeps) and #7 (dopri5, 8 steps per interval) through
    their dispatchers on Acrobot: one launch each, every lane's states,
    controls, alive count and attempted steps equal to the plain version on
    the card; and the dispatchers' refusals."""
    env, fset, (x0, ts, tgt, _, _, par), trees = policy_case(cuda, state_size=state_size, pop=256,
                                                             b=16)
    before = cp.policy_rollout_cuda.launches
    got = cp.rollout_policy(trees, x0, ts, tgt, par, env, fset, 2, "rk4", state_size)
    ref = cp.policy_rollout_plain(trees, x0, ts, tgt, par, env, fset, 2, "rk4", state_size)
    torch.cuda.synchronize()
    assert cp.policy_rollout_cuda.launches == before + 1
    assert all(same_bits(a, b) for a, b in zip(got[:2], ref[:2])) and torch.equal(got[2], ref[2])
    before = cp.policy_rollout_adaptive_cuda.launches
    got = cp.rollout_policy_adaptive(trees, x0, ts, tgt, par, env, fset, max_steps=8,
                                     state_size=state_size, return_steps=True)
    ref = cp.policy_rollout_adaptive_plain(trees, x0, ts, tgt, par, env, fset, max_steps=8,
                                           state_size=state_size)
    torch.cuda.synchronize()
    assert cp.policy_rollout_adaptive_cuda.launches == before + 1
    assert all(same_bits(a, b) for a, b in zip(got[:2], ref[:2]))
    assert torch.equal(got[2], ref[2]) and torch.equal(got[3], ref[3]) and got[2][-1].any()
    user_set = build_function_set(POLICY_OPS + [NO_DEVICE_OP], [fset.variable_names[:4]], [1])
    with pytest.raises(NotImplementedError):  # an operator the kernels lack
        cp.rollout_policy(trees[:, :1], x0, ts, tgt, par, env, user_set, 2, "rk4", 0)
    cpu = lambda t: t.cpu() if isinstance(t, torch.Tensor) else tuple(p.cpu() for p in t)
    got = cp.rollout_policy(trees[:2, :1].map(cpu), *map(cpu, (x0, ts, tgt, par)), env, user_set,
                            2, "rk4", 0)  # the plain path on the CPU
    assert got[0].shape[:3] == (ts.shape[0], 2, x0.shape[0]) and got[2].any()
    with pytest.raises(NotImplementedError):  # N > 256
        wide = trees.map(lambda a: torch.cat([a, a[..., :1].expand(*a.shape[:-1], 240)], -1))
        cp.rollout_policy(wide, x0, ts, tgt, par, env, fset, 2, "rk4", state_size)
    kicks = torch.zeros((ts.shape[0], 16, 2 * 4), device=cuda)
    with pytest.raises(ValueError):  # process noise needs euler
        cp.rollout_policy(trees, x0, ts, tgt, par, env, fset, 2, "rk4", state_size,
                          process_noise_rows=kicks)


@pytest.mark.cuda
@pytest.mark.parametrize("state_size", [0, 2])
def test_policy_kernels_deep_match_plain_on_card(cuda, state_size):
    """#6 and #7's instances for N <= 256 on Acrobot policies of 256 rows
    grown to depth 7, the first three candidates chains of 255, 127 and 63
    rows (the deepest stacks), x 16 trajectories at T = 6: one launch each,
    every lane's states, controls, alive count and attempted steps equal to
    the plain version on the card; #7 with dopri5 and 8 steps per interval
    and with bosh3 and 2 (budgets that run out inside an interval)."""
    env, fset, (x0, ts, tgt, _, _, par), trees = policy_case(
        cuda, state_size=state_size, pop=256, b=16, t_end=1.2, n=256, depth=7)
    trees = with_chains(trees, fset, [255, 127, 63])
    args = (trees, x0, ts, tgt, par, env, fset)
    before = cp.policy_rollout_cuda.launches
    got = cp.rollout_policy(*args, 2, "rk4", state_size)
    ref = cp.policy_rollout_plain(*args, 2, "rk4", state_size)
    torch.cuda.synchronize()
    assert cp.policy_rollout_cuda.launches == before + 1
    assert all(same_bits(a, b) for a, b in zip(got[:2], ref[:2])) and torch.equal(got[2], ref[2])
    for method, max_steps in (("dopri5", 8), ("bosh3", 2)):
        before = cp.policy_rollout_adaptive_cuda.launches
        kw = dict(max_steps=max_steps, method=method, state_size=state_size)
        got = cp.rollout_policy_adaptive(*args, return_steps=True, **kw)
        ref = cp.policy_rollout_adaptive_plain(*args, **kw)
        torch.cuda.synchronize()
        assert cp.policy_rollout_adaptive_cuda.launches == before + 1
        assert all(same_bits(a, b) for a, b in zip(got[:2], ref[:2]))
        assert torch.equal(got[2], ref[2]) and torch.equal(got[3], ref[3])


@pytest.mark.cuda
@pytest.mark.parametrize("kind", ["sde", "adaptive", "dynamic"])
def test_deep_evaluators_match_plain_on_card(cuda, monkeypatch, kind):
    """The deep evaluators' kernel paths at N = 128 (trees grown to depth 7,
    the first three candidates chains of 127, 127 and 63 rows), through
    ``evaluate_population`` on the card: the SDE SR evaluator (#1 with kick
    rows, Euler-Maruyama x 4), the adaptive SR evaluator (#5, dopri5,
    budget 40) and the dynamic policy evaluator (#6, ``state_size=2``, RK4 x
    2); one launch each, and the fitness equal bit for bit to the same
    evaluation through the plain version on the card (#6: the evaluator's
    kernel call replaced by the plain version)."""
    from multitreegp_tpu_torch.models.evaluators import static_policy as sp

    if kind == "dynamic":
        env, fset, data, trees = policy_case(cuda, state_size=2, pop=256, b=16, t_end=1.2, n=128,
                                             depth=7)
        trees = with_chains(trees, fset, [127, 127, 63])
        ev = DynamicPolicyEvaluator(env, fset, state_size=2, substeps=2)
        assert ev._fused_kind(trees, data) == "fixed"
        kernel = cp.policy_rollout_cuda
    else:
        fset, trees, x0s, ts, ys = fitness_case(cuda, pop=256, b=16, t_end=2.0 if kind == "sde" else 0.8,
                                                n=128, depth=7)
        keys = generate_sr_data(VanDerPolOscillator(0.1), torch.Generator(device=cuda).manual_seed(3),
                                ts, batch_size=16)[3]
        data = (x0s, ts, ys, keys)
        if kind == "sde":
            ev = SREvaluator(fset, substeps=4, process_noise=0.2)
            kernel = sr_fitness_cuda
        else:
            ev = SREvaluator(fset, method="adaptive", adaptive_method="dopri5", adaptive_budget=40)
            kernel = ca.sr_fitness_adaptive_global_cuda
        assert ev._fused(trees, x0s)
    before = kernel.launches
    fitness = ev.evaluate_population(trees, data)
    torch.cuda.synchronize()
    assert kernel.launches == before + 1
    if kind == "sde":
        kicks = make_sr_kick_rows(0.2, ts, keys, 4, 2)
        ref = ev._fitness(*sr_fitness_plain(trees, x0s, ts, ys, fset, "euler", 4, kicks))
    elif kind == "adaptive":
        mse, alive, _ = ca.sr_fitness_adaptive_global_plain(trees, x0s, ts, ys, fset, ev.rtol, ev.atol,
                                                            40, "dopri5")
        ref = ev._fitness(mse, alive)
    else:
        monkeypatch.setattr(sp, "rollout_policy", cp.policy_rollout_plain)
        ref = ev.evaluate_population(trees, data)
        assert kernel.launches == before + 1
    torch.cuda.synchronize()
    assert torch.equal(fitness, ref) and bool((fitness < ev.max_fitness).any())


@pytest.mark.cuda
def test_policy_kernels_wide_match_plain_on_card(cuda):
    """#6 (RK4 x 2) and #7 (dopri5, 8 steps per interval) on 4 dynamic
    Acrobot policies x 1024 trajectories (a candidate spans 8 blocks): one
    launch each, every lane's states,
    controls, alive count and attempted steps equal to the plain version."""
    env, fset, (x0, ts, tgt, _, _, par), trees = policy_case(cuda, state_size=2, pop=4, b=1024,
                                                             t_end=1.2)
    args = (trees, x0, ts, tgt, par, env, fset)
    before = cp.policy_rollout_cuda.launches
    got = cp.rollout_policy(*args, 2, "rk4", 2)
    ref = cp.policy_rollout_plain(*args, 2, "rk4", 2)
    torch.cuda.synchronize()
    assert cp.policy_rollout_cuda.launches == before + 1
    assert all(same_bits(a, b) for a, b in zip(got[:2], ref[:2])) and torch.equal(got[2], ref[2])
    before = cp.policy_rollout_adaptive_cuda.launches
    got = cp.rollout_policy_adaptive(*args, max_steps=8, state_size=2, return_steps=True)
    ref = cp.policy_rollout_adaptive_plain(*args, max_steps=8, state_size=2)
    torch.cuda.synchronize()
    assert cp.policy_rollout_adaptive_cuda.launches == before + 1
    assert all(same_bits(a, b) for a, b in zip(got[:2], ref[:2]))
    assert torch.equal(got[2], ref[2]) and torch.equal(got[3], ref[3])


@pytest.mark.cuda
def test_policy_kernel_legs_match_plain_on_card(cuda):
    """#6's other legs on the card: series parameters (Switch) on the
    harmonic oscillator, obs-noise rows and Euler-Maruyama kicks given as
    tensors; and #7 refusing series parameters."""
    env, fset, (x0, ts, tgt, _, _, par), trees = policy_case(
        cuda, HarmonicOscillator(), pop=128, b=16, mode="Switch")
    args = (trees, x0, ts, tgt, par, env, fset)
    g = torch.Generator(device=cuda).manual_seed(3)
    noise = dict(obs_noise_rows=0.1 * torch.randn((ts.shape[0], 16, 2 * env.n_obs), generator=g,
                                                  device=cuda),
                 process_noise_rows=0.05 * torch.randn((ts.shape[0], 16, 2 * 2), generator=g,
                                                       device=cuda))
    for method, sub, rows in (("rk4", 2, {}), ("euler", 2, noise)):  # euler: 1 stage per substep
        got = cp.rollout_policy(*args, sub, method, 0, **rows)
        ref = cp.policy_rollout_plain(*args, sub, method, 0, **rows)
        torch.cuda.synchronize()
        assert all(same_bits(a, b) for a, b in zip(got[:2], ref[:2])) and torch.equal(got[2], ref[2])
    with pytest.raises(ValueError):
        cp.rollout_policy_adaptive(*args)


@pytest.mark.cuda
@pytest.mark.parametrize("kind", ["static", "dynamic", "adaptive", "noisy"])
def test_policy_evaluators_never_run_plain_on_card(cuda, monkeypatch, kind):
    """With CUDA tensors the policy evaluators launch their kernel (#6 or
    #7) and never a plain version; ``evaluate_candidate`` replays through
    kernel #8. ``noisy``: observation noise and ``stochastic=True``, #6 with
    the rows built on the card."""
    def refuse(*args, **kwargs):
        raise AssertionError("a plain version ran on CUDA tensors")

    for name in ("policy_rollout_plain", "policy_rollout_adaptive_plain"):
        monkeypatch.setattr(cp, name, refuse)
    monkeypatch.setattr("multitreegp_tpu_torch.core.interpreter.evaluate_trees_plain", refuse)
    state_size = 2 if kind == "dynamic" else 0
    env = Acrobot(obs_noise=0.05, process_noise=0.05) if kind == "noisy" else None
    env, fset, data, trees = policy_case(cuda, env, state_size=state_size, pop=64, b=16)
    if kind == "noisy":
        ev = StaticPolicyEvaluator(env, fset, substeps=2, stochastic=True)
    elif kind == "dynamic":
        ev = DynamicPolicyEvaluator(env, fset, state_size=2, substeps=2)
    else:
        ev = StaticPolicyEvaluator(env, fset, substeps=8 if kind == "adaptive" else 2,
                                   method="adaptive" if kind == "adaptive" else "rk4",
                                   adaptive_method="dopri5")
    kernel = cp.policy_rollout_adaptive_cuda if kind == "adaptive" else cp.policy_rollout_cuda
    before, fwd = kernel.launches, ci.evaluate_trees_cuda.launches
    fitness = ev.evaluate_population(trees, data)
    out = ev.evaluate_candidate(trees[0], data)
    torch.cuda.synchronize()
    assert kernel.launches == before + 2 and ci.evaluate_trees_cuda.launches > fwd
    assert bool(((fitness >= 0) & (fitness <= 1e4)).all()) and out[0].shape[:2] == (16, 11)
