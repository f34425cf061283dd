"""PyTorch port: the operators past ``+ - * / sin cos`` (``exp log sqrt tanh
tan abs neg square pow max min``) on every path that evaluates a tree.

The kernels compute them only in their extended build (``csrc`` compiled with
``MTGP_EXT_OPS``, ``_build.load(name, True)``), which a function set
with any of them selects (``FunctionSet.extended``).

Tolerances, and why:

* each operator against JAX (``evaluate_trees``, ``impl="gather"`` and
  ``"ladder"``, and ``jax.grad``) on hand-made trees whose operator reads
  leaves, a product of leaves or a difference of variables, with seeded
  inputs that include 0, ties, negatives and overflow: the same NaN / +inf /
  -inf pattern; finite values within 4 ulp or 1e-6 relative (XLA:CPU's
  ``exp``, ``log``, ``tanh``, ``tan`` and ``pow`` are its own approximations,
  PyTorch's CPU ones SLEEF's). Gradients on the lanes whose value is finite
  in both: the same pattern, and within 4 ulp, 1e-6 relative, or 1e-6 of the
  largest |gradient| of the tree (``tanh``'s formulas differ: JAX's ``(g +
  g r)(1 - r)``, autograd's ``g (1 - r r)``, each as exact as ``r``). One
  convention differs and is checked as such: at 0 autograd's ``abs`` sends
  ``g * sgn(0) = 0``, JAX's ``g``.
* the host builds of #8/#9 and of the ``tree_prog.cuh`` kernels (#1, #3, #5,
  #4, #6, #7) against their plain versions: bit for bit per lane, with the C
  library's ``expf``/``logf``/``tanhf``/``tanf``/``powf`` swapped into
  PyTorch (``patch_host_math``); #2 takes a set of 11 operators, opcodes
  identical, constants within rtol 1e-6 as in ``test_torch_kernels``.
* ``SREvaluator.evaluate_population`` (RK4, T = 10, pop 64, N = 32) with
  every operator against JAX's: the same clamped candidates, survivors'
  median relative error <= 1e-6 and Spearman >= 0.997 (rollouts amplify the
  operators' ulps; ROADMAP "How to judge a fault"); ``StaticPolicyEvaluator``
  with ``tanh`` as ``test_torch_policy.py`` holds ``sin``/``cos``.
* the sampler's operator frequencies at 11 operators against JAX's law: total
  variation <= 0.03 on ~25,000 operator rows; the control, the port drawing
  with the probabilities of ``+`` and ``log`` swapped, is not.

Tests that need the card carry the ``cuda`` marker (every lane bit for bit
against the plain version there, where PyTorch and the kernels call the same
CUDA functions; a second operand's subnormal cotangent, which ``exp`` and
``pow`` make common, is kept by both: the plain version's gather backward
writes it, where CUDA's atomic add would flush it to zero). JAX is imported only by the tests that compare with it, so
the card tests also run where there is no JAX (``pytest --noconftest``).
"""
import ctypes
import dataclasses
import shutil

import numpy as np
import pytest
import torch

from multitreegp_tpu_torch import _build
from multitreegp_tpu_torch.core import cuda_adaptive as ca
from multitreegp_tpu_torch.core import cuda_interpreter as ci
from multitreegp_tpu_torch.core import cuda_policy as cp
from multitreegp_tpu_torch.core import cuda_rollout as cr
from multitreegp_tpu_torch.core.cuda_reproduction import reproduce_lanes, reproduce_lanes_plain
from multitreegp_tpu_torch.core.interpreter import (
    evaluate_trees, evaluate_trees_plain, evaluate_trees_vjp_plain,
)
from multitreegp_tpu_torch.core.registry import DEVICE_OPS, EXTENDED_FROM, USER_FROM, build_function_set
from multitreegp_tpu_torch.core.trees import CONST, EMPTY, TreeTensors, rebuild_pointers
from multitreegp_tpu_torch.models import environments as tenvs
from multitreegp_tpu_torch.models.environments import VanDerPolOscillator
from multitreegp_tpu_torch.models.evaluators import generate_control_data, generate_sr_data
from multitreegp_tpu_torch.ops.initialization import make_population_sampler
from test_torch_kernels import (
    fitness_host, patch_host_math, per_lane_operands, reproduce_case, reproduce_host, same_bits,
    with_chains,
)

torch.set_num_threads(1)

UNARY = ("exp", "log", "sqrt", "tanh", "tan", "abs", "neg", "square")
BINARY = ("pow", "max", "min")
EXTENDED = UNARY + BINARY
# every operator the kernels know, in the table's order: (name, arity, probability)
ALL_OPS = ([("+", 2, 0.5), ("-", 2, 0.1), ("*", 2, 0.5), ("/", 2, 0.1), ("sin", 1, 0.1),
            ("cos", 1, 0.1)] + [(name, 1, 0.1) for name in UNARY]
           + [(name, 2, 0.1) for name in BINARY])
# 11 operators: three unary and three binary ones past the six
ELEVEN = [("+", 2, 0.5), ("-", 2, 0.1), ("*", 2, 0.5), ("/", 2, 0.1), ("sin", 1, 0.3),
          ("exp", 1, 0.2), ("log", 1, 0.1), ("tanh", 1, 0.2), ("pow", 2, 0.1), ("max", 2, 0.2),
          ("min", 2, 0.1)]
N_TEMPLATE = 8
L = 48  # data vectors of the templates


def jax_callables():
    import jax.numpy as jnp

    return {"+": jnp.add, "-": jnp.subtract, "*": jnp.multiply, "/": jnp.divide, "sin": jnp.sin,
            "cos": jnp.cos, "exp": jnp.exp, "log": jnp.log, "sqrt": jnp.sqrt, "tanh": jnp.tanh,
            "tan": jnp.tan, "abs": jnp.abs, "neg": jnp.negative, "square": jnp.square,
            "pow": jnp.power, "max": jnp.maximum, "min": jnp.minimum}


def jax_set(ops, variable_list, layer_sizes):
    """The JAX package's function set of ``ops`` (name, arity, probability)."""
    from multitreegp_tpu.core.registry import build_function_set as jax_function_set

    fns = jax_callables()
    return jax_function_set([(name, fns[name], a, p) for name, a, p in ops], variable_list,
                            layer_sizes)


# ------------------------------------------------------------ the table

def test_table_keeps_old_ids_and_selects_the_extended_build():
    assert [DEVICE_OPS[k] for k in ("+", "-", "*", "/", "sin", "cos")] == list(range(6))
    assert [DEVICE_OPS[k] for k in EXTENDED] == list(range(EXTENDED_FROM, EXTENDED_FROM + 11))
    six = build_function_set(ALL_OPS[:6], [["x0"]], [1])
    assert not six.extended and six.has_unary
    for name in EXTENDED:
        fset = build_function_set([("+", 2), (name, 2 if name in BINARY else 1)], [["x0"]], [1])
        assert fset.extended and fset.has_unary == (name in UNARY)
        fset.require_device_ops()
    assert _build.library_path("interpreter", True) != _build.library_path("interpreter")
    assert _build.library_path("interpreter", True).name.startswith("interpreter_ext-")


def protected_log(x):
    return torch.log(torch.abs(x) + 1e-6)


@pytest.mark.parametrize("name,fn,device_id", [
    ("log", None, DEVICE_OPS["log"]), ("log", torch.log, DEVICE_OPS["log"]),
    ("log", lambda x: x.log(), DEVICE_OPS["log"]), ("log", protected_log, USER_FROM),
    ("sqrt", lambda x: torch.sqrt(x.abs()), USER_FROM), ("log", lambda x: x // 2.0, -1)])
def test_torch_callable_under_a_table_name(name, fn, device_id):
    """A torch callable under a table name takes the table's device op only
    where it computes the table's function; a protected one is kept, runs on
    the CPU as given, and is traced into a user operator (``USER_FROM``), or
    refused by the kernels where the emitter refuses it (``//``, which has
    no autograd derivative)."""
    entry = (name, 1) if fn is None else (name, fn, 1)
    fset = build_function_set([("+", 2), entry], [["x0"]], [1])
    assert fset.device_op_ids == (0, device_id) and fset.extended == (device_id != -1)
    assert bool(fset.user_header) == (device_id == USER_FROM)
    ops, const = tree_rows((name, "x0"), fset, 4)
    ops_t = torch.tensor([ops], dtype=torch.int32)
    trees = TreeTensors(ops_t, *rebuild_pointers(ops_t, fset.slots()), torch.tensor([const]))
    x = torch.tensor([[-2.0], [0.0], [3.0]])[:, None]
    got = evaluate_trees(trees.map(lambda a: a[None].expand((3,) + a.shape)), x, fset)[:, 0]
    want = (fn or torch.log)(x[:, 0, 0])
    assert not torch.isnan(want).any() or device_id not in (-1, USER_FROM)
    assert same_bits(got, want)
    if device_id == -1:
        with pytest.raises(NotImplementedError):
            fset.require_device_ops()
    else:
        fset.require_device_ops()


def test_jax_callable_under_a_table_name():
    """A jnp callable under a table name maps to the table's operator where
    it computes it, and raises where it does not (it cannot run on torch
    tensors), in ``build_function_set`` and in ``function_set_from_jax``."""
    jnp = pytest.importorskip("jax.numpy")
    from multitreegp_tpu_torch.convert import function_set_from_jax

    safe_log = lambda x: jnp.log(jnp.abs(x) + 1e-6)
    for name, fn in jax_callables().items():
        arity = 2 if name in BINARY or name in "+-*/" else 1
        assert build_function_set([(name, fn, arity)], [["x0"]], [1]).device_op_ids == (DEVICE_OPS[name],)
    with pytest.raises(ValueError, match="differs from the table"):
        build_function_set([("+", jnp.add, 2), ("log", safe_log, 1)], [["x0"]], [1])
    assert function_set_from_jax(jax_set(ALL_OPS, [["x0", "x1"]], [1])).device_op_ids == tuple(range(17))
    from multitreegp_tpu.core.registry import build_function_set as jax_function_set

    protected = jax_function_set([("+", jnp.add, 2), ("log", safe_log, 1)], [["x0"]], [1])
    with pytest.raises(ValueError, match="give its torch counterpart"):
        function_set_from_jax(protected)


# ------------------------------------------------- hand-made trees per operator

def tree_rows(expr, fset, n):
    """``(ops, const)`` rows of a nested expression in the root-last layout:
    a variable name, a float (a constant), or ``(operator, operand[,
    operand])``; a binary row's first operand is the row below it."""
    ops, const = [], []

    def emit(e):
        if isinstance(e, str):
            ops.append(fset.string_to_op[e])
            const.append(0.0)
        elif isinstance(e, float):
            ops.append(CONST)
            const.append(e)
        else:
            for a in reversed(e[1:]):
                emit(a)
            ops.append(fset.string_to_op[e[0]])
            const.append(0.0)

    emit(expr)
    pad = n - len(ops)
    return [EMPTY] * pad + ops, [0.0] * pad + const


def templates(name, c):
    """Six trees around operator ``name``: its operands are leaves, a product
    of leaves or ``x0 - x1`` (exact in both packages), its value at most
    multiplied once; ``c`` holds six constants."""
    if name in BINARY:
        return [(name, "x0", "x1"), (name, "x1", c[0]), (name, c[1], "x0"), (name, "x0", "x0"),
                (name, ("*", "x0", c[2]), "x1"), ("*", c[3], (name, "x1", "x0"))]
    return [(name, "x0"), (name, ("*", "x1", c[0])), ("*", c[1], (name, "x0")),
            (name, ("-", "x0", "x1")), (name, c[2]), ("*", (name, "x1"), "x0")]


# inputs at the operators' edges: zeros, ties, negatives, overflow of exp
SPECIAL = [(0.0, 0.0), (1.0, 1.0), (-1.0, 2.0), (2.0, 2.0), (-0.5, -0.5), (50.0, -50.0),
           (0.0, -1.0), (1e-3, 3.0), (-3.0, 0.5), (1.5, 0.0), (100.0, 0.25), (-2.0, -3.0)]


def template_constants(seed=14):
    return [float(v) for v in (np.random.default_rng(seed).normal(size=6) * 1.5).astype(np.float32)]


def unary_operands(x, c):
    """The operand of the unary operator in each of ``templates``' trees, on
    data ``x (L, 2)`` (float32, as the trees compute it)."""
    x0, x1 = x[:, 0], x[:, 1]
    return np.stack([x0, x1 * np.float32(c[0]), x0, x0 - x1, np.full_like(x0, c[2]), x1])


def template_case(name, device="cpu", seed=14):
    """Per-lane operands of operator ``name``'s six trees on ``L`` data
    vectors: ``(fset, trees (6, L, N), data (6, L, 2), g (6, L))``, made
    from ``seed`` with numpy."""
    fset = build_function_set(ALL_OPS, [["x0", "x1"]], [1])
    c = template_constants(seed)
    rng = np.random.default_rng(seed + 1)
    rows = [tree_rows(e, fset, N_TEMPLATE) for e in templates(name, c)]
    ops = torch.tensor([r[0] for r in rows], dtype=torch.int32)
    const = torch.tensor([r[1] for r in rows], dtype=torch.float32)
    c1, c2 = rebuild_pointers(ops, fset.slots())
    x = (rng.normal(size=(L, 2)) * 2).astype(np.float32)
    x[:len(SPECIAL)] = SPECIAL
    k = len(rows)
    trees = TreeTensors(ops, c1, c2, const).map(
        lambda a: a[:, None].expand(k, L, N_TEMPLATE).contiguous().to(device))
    data = torch.from_numpy(x)[None].expand(k, L, 2).contiguous().to(device)
    g = torch.from_numpy(rng.normal(size=(k, L)).astype(np.float32)).to(device)
    return fset, trees, data, g


def ulp_gap(a, b):
    """Distance in float32 steps between finite ``a`` and ``b``."""
    order = lambda v: np.where(v < 0, -(v & 0x7FFFFFFF), v)
    ia = order(np.asarray(a, np.float32).view(np.int32).astype(np.int64))
    ib = order(np.asarray(b, np.float32).view(np.int32).astype(np.int64))
    return np.abs(ia - ib)


def assert_same_nonfinite(got, want):
    for test in (np.isnan, np.isposinf, np.isneginf):
        np.testing.assert_array_equal(test(got), test(want))


def assert_close_to_jax(got, want, atol=0.0, rtol=1e-6):
    """The same non-finite pattern; finite entries within 4 ulp, ``rtol``
    (1e-6, or one per entry) relative or ``atol``."""
    got, want = np.asarray(got, np.float32), np.asarray(want, np.float32)
    assert_same_nonfinite(got, want)
    fin = np.isfinite(want)
    a, b = got[fin], want[fin]
    rtol = np.broadcast_to(rtol, want.shape)[fin]
    ok = (ulp_gap(a, b) <= 4) | (np.abs(a - b) <= rtol * np.abs(b)) | (np.abs(a - b) <= atol)
    assert ok.all(), (a[~ok], b[~ok])


@pytest.fixture(scope="module")
def jax_reference():
    pytest.importorskip("jax")
    return make_jax_reference()


def make_jax_reference():
    """``impl -> fn(trees, data, g) -> (roots, (dconst, ddata))`` of the JAX
    package on the templates' shapes, jitted once per ``impl``."""
    import jax
    from multitreegp_tpu.core.interpreter import evaluate_trees as jax_evaluate
    from multitreegp_tpu.core.trees import TreeTensors as JaxTrees

    jf = jax_set(ALL_OPS, [["x0", "x1"]], [1])
    made = {}

    def get(impl):
        if impl not in made:
            ev = lambda t, d: jax_evaluate(JaxTrees(*t), d, jf, impl=impl)
            fwd = jax.jit(ev)
            grad = jax.jit(jax.grad(lambda c, d, t, g: (ev((*t, c), d) * g).sum(), argnums=(0, 1)))

            def run(trees, data, g):
                t = [np.asarray(a) for a in trees]
                d, gg = data.numpy(), g.numpy()
                return np.asarray(fwd(t, d)), tuple(np.asarray(x) for x in grad(t[3], d, t[:3], gg))
            made[impl] = run
        return made[impl]

    return get


def port_value_and_grads(trees, data, g, fset, impl):
    const = trees.const.clone().requires_grad_(True)
    x = data.clone().requires_grad_(True)
    out = evaluate_trees(trees._replace(const=const), x, fset, impl=impl)
    dconst, ddata = torch.autograd.grad(out, (const, x), g)
    return out.detach().numpy(), dconst.numpy(), ddata.numpy()


@pytest.mark.parametrize("impl", ["gather", "ladder"])
@pytest.mark.parametrize("name", EXTENDED)
def test_operator_matches_jax(jax_reference, name, impl):
    fset, trees, data, g = template_case(name)
    want, (want_c, want_d) = jax_reference(impl)(trees, data, g)
    got, got_c, got_d = port_value_and_grads(trees, data, g, fset, impl)
    assert_close_to_jax(got, want)
    assert np.isfinite(want).mean() > 0.3  # log, sqrt and pow are NaN on half the negatives
    fin = np.isfinite(got) & np.isfinite(want)  # (6, L): gradients of finite roots
    x = data.numpy()
    edge = (x[..., 0] == 0) | (x[..., 1] == 0) | (x[..., 0] == x[..., 1])
    # the conventions that differ, on tree 0 (abs(x0), pow(x0, x1)): autograd
    # sends g * sgn(0) = 0 through abs at 0, JAX g; d/dx of pow(0, 0) is 0 in
    # autograd (pow_backward_self), NaN in JAX (0 * 0 ** -1)
    if name == "abs":
        at = x[0, :, 0] == 0
        np.testing.assert_array_equal(want_d[0, at, 0], g.numpy()[0, at])
    if name == "pow":
        at = (x[0, :, 0] == 0) & (x[0, :, 1] == 0)
        assert np.isnan(want_d[0, at, 0]).all()
    if name in ("abs", "pow"):
        assert at.any()
        np.testing.assert_array_equal(got_d[0, at, 0], 0.0)
        fin &= ~edge
    rtol = np.full(fin.shape, 1e-6)
    if name == "tanh":  # 1 - r * r from r of a few ulps: its condition number 2 r^2 / (1 - r^2)
        r = np.tanh(unary_operands(x[0], template_constants()).astype(np.float64))
        rtol += 8 * np.finfo(np.float32).eps * 2 * r * r / np.maximum(1 - r * r, 1e-30)
    for k in range(fin.shape[0]):
        for got_k, want_k, tol in ((got_c[k][fin[k]], want_c[k][fin[k]], rtol[k][fin[k]][:, None]),
                                   (got_d[k][fin[k]], want_d[k][fin[k]], rtol[k][fin[k]][:, None])):
            finite = want_k[np.isfinite(want_k)]
            scale = float(np.abs(finite).max()) if finite.size else 0.0
            assert_close_to_jax(got_k, want_k, atol=1e-6 * scale, rtol=tol)


def test_population_matches_jax(jax_reference):
    """A population sampled (by JAX) with all 17 operators, N = 32, depth 5,
    against JAX's ``evaluate_trees``: roots on 48 data vectors."""
    import jax.random as jr
    from multitreegp_tpu.core.interpreter import evaluate_trees as jax_evaluate
    from multitreegp_tpu.ops.initialization import make_population_sampler as jax_sampler
    from multitreegp_tpu_torch.convert import function_set_from_jax, trees_from_numpy

    jf = jax_set(ALL_OPS, [["x0", "x1"]], [1])
    jpop = jax_sampler(jf, 5, 32)(jr.PRNGKey(3), 64)
    jpop = type(jpop)(*(a[:, None, 0] for a in jpop))  # the first tree, (64, 1, 32)
    trees = trees_from_numpy(*[np.asarray(a) for a in jpop])
    rng = np.random.default_rng(3)
    data = (rng.normal(size=(1, L, 2)) * 2).astype(np.float32)
    want = np.asarray(jax_evaluate(jpop, data, jf, impl="gather"))
    got = evaluate_trees(trees, torch.from_numpy(data), function_set_from_jax(jf)).numpy()
    assert_same_nonfinite(got, want)
    fin = np.isfinite(want)
    # compositions amplify one operator's ulps: per tree, within 1e-5 of its
    # largest finite |root| or 1e-5 relative
    scale = np.where(fin, np.abs(want), 0).max(axis=1, keepdims=True)
    close = np.abs(got - want) <= 1e-5 * np.maximum(np.abs(want), scale)
    assert close[fin].mean() >= 0.999 and fin.mean() > 0.5


# ---------------------------------------------- host builds: #8/#9 bit for bit

@pytest.fixture(scope="module")
def ext_host(tmp_path_factory):
    if shutil.which("g++") is None and shutil.which("c++") is None:
        pytest.skip("no host C++ compiler")
    out = tmp_path_factory.mktemp("ext_host")
    return lambda name: _build.build_host(name, out, True)


@pytest.fixture(scope="module")
def interp_ext(ext_host):
    return ext_host("interpreter")


def population_case(n, depth, k=24, members=5, device="cpu", seed=0, ops=ALL_OPS):
    """``(fset, trees (k, 1, 2, n), data (k, members, 1, 2), g)``: trees grown
    with ``ops``; past 32 rows the first three are chains of ``n - 1``, 127
    and 63 rows."""
    fset = build_function_set(ops, [["x0", "x1"]], [2])
    gen = torch.Generator(device=device).manual_seed(seed)
    pop = make_population_sampler(fset, depth, n)(gen, k)[0]
    if n > 32:
        pop = with_chains(pop, fset, [n - 1, min(127, n - 1), 63])
    rng = np.random.default_rng(seed)
    data = torch.from_numpy(rng.normal(size=(k, members, 1, 2)).astype(np.float32) * 2).to(device)
    g = torch.from_numpy(rng.normal(size=(k, members, 2)).astype(np.float32)).to(device)
    return fset, pop.map(lambda a: a[:, None]), data, g


def host_interpreter(lib, trees, data, g, fset):
    status, out = ci.run_forward(lib.interpret_fwd, trees, data, fset)
    assert status == 0
    status, dconst, ddata = ci.run_backward(lib.interpret_bwd, trees, data, g, fset)
    assert status == 0
    return out, dconst, ddata


def plain_interpreter(trees, data, g, fset, monkeypatch):
    with monkeypatch.context() as m:
        patch_host_math(m)
        full, x = per_lane_operands(trees, data)
        return (evaluate_trees_plain(full, x, fset),) + evaluate_trees_vjp_plain(full, x, g, fset)


@pytest.mark.parametrize("name", EXTENDED)
def test_interpreter_host_build_templates_bit_exact(interp_ext, monkeypatch, name):
    """#8/#9's extended host build on each operator's trees, per lane: roots,
    ``dconst`` and ``ddata`` bit for bit with autograd's formulas."""
    fset, trees, data, g = template_case(name)
    got = host_interpreter(interp_ext, trees, data, g, fset)
    want = plain_interpreter(trees, data, g, fset, monkeypatch)
    assert all(same_bits(a, b) for a, b in zip(got, want))
    assert (want[1] != 0).any()


@pytest.mark.parametrize("n,depth", [(32, 5), (256, 7), (512, 7)])
def test_interpreter_host_build_population_bit_exact(interp_ext, monkeypatch, n, depth):
    """Every instance (N <= 32, <= 256, <= 1024) on sampled trees with all 17
    operators in the recompute's layout (5 trajectories a tree)."""
    fset, trees, data, g = population_case(n, depth, k=12 if n > 32 else 24)
    got = host_interpreter(interp_ext, trees, data, g, fset)
    want = plain_interpreter(trees, data, g, fset, monkeypatch)
    assert all(same_bits(a, b) for a, b in zip(got, want))
    ext_rows = trees.ops >= fset.string_to_op["exp"]
    ext_rows &= trees.ops < fset.var_start
    assert int(ext_rows.sum()) > 20 and torch.isfinite(want[0]).float().mean() > 0.5


def subnormal_case(device="cpu"):
    """``x0 * x1`` (first operand x0) on data whose cotangent of the second
    operand, ``g * x0``, is subnormal: ``(fset, trees (1, 4, N), data, g)``."""
    fset = build_function_set(ALL_OPS, [["x0", "x1"]], [1])
    ops, const = tree_rows(("*", "x0", "x1"), fset, N_TEMPLATE)
    ops = torch.tensor([ops], dtype=torch.int32)
    c1, c2 = rebuild_pointers(ops, fset.slots())
    trees = TreeTensors(ops, c1, c2, torch.tensor([const])).map(
        lambda a: a[:, None].expand(1, 4, N_TEMPLATE).contiguous().to(device))
    data = torch.tensor([[[1e-10, 2.0], [-3e-12, 1.0], [1e-8, -1.0], [1.0, 0.5]]], device=device)
    return fset, trees, data, torch.full((1, 4), 1e-30, device=device)


def test_subnormal_cotangent_of_second_operand(interp_ext):
    """A second operand's subnormal cotangent reaches its row in the plain
    VJP and in the kernel's (IEEE arithmetic, no flush to zero)."""
    fset, trees, data, g = subnormal_case()
    want = g * data[..., 0]  # d(x0 * x1)/dx1
    assert bool(((want != 0) & (want.abs() < torch.finfo(torch.float32).tiny)).any())
    _, ref_d = evaluate_trees_vjp_plain(trees, data, g, fset)
    _, _, got_d = host_interpreter(interp_ext, trees, data, g, fset)
    assert torch.equal(ref_d[..., 1], want) and torch.equal(got_d[..., 1], want)


def test_default_build_refuses_extended_ids(tmp_path):
    """The default build's layout check takes the op ids up to ``cos`` only,
    so an extended set can never run its code."""
    lib = _build.build_host("interpreter", tmp_path)
    fset, trees, data, g = template_case("exp")
    status, _ = ci.run_forward(lib.interpret_fwd, trees, data, fset)
    assert status != 0


# --------------------------------- host builds of the tree_prog.cuh kernels

def sr_case(seed=2, pop=32, b=4, t_end=1.6, ops=ALL_OPS, n=32, depth=4):
    fset = build_function_set(ops, [["x0", "x1"]], [2])
    g = torch.Generator().manual_seed(seed)
    x0s, ts, ys, _ = generate_sr_data(VanDerPolOscillator(), g, torch.arange(0.0, t_end, 0.2),
                                      batch_size=b)
    trees = make_population_sampler(fset, depth, n)(g, pop)[0]
    return fset, trees, x0s, ts, ys


@pytest.mark.parametrize("method,n", [("rk4", 32), ("heun", 32), ("rk4", 128)])
def test_fitness_host_build_bit_exact(ext_host, monkeypatch, method, n):
    """#1 (``sr_fitness.cu``) through ``tree_prog.cuh``'s ``row_step``."""
    fset, trees, x0s, ts, ys = sr_case(n=n, depth=4 if n == 32 else 6)
    with monkeypatch.context() as m:
        patch_host_math(m)
        mse, alive = cr.sr_fitness_plain(trees, x0s, ts, ys, fset, method, 1)
    err, alive_h = fitness_host(ext_host("sr_fitness"), trees, x0s, ts, ys, fset, method, 1)
    np.testing.assert_array_equal(alive_h, alive.numpy())
    np.testing.assert_array_equal(err, mse.numpy())
    assert alive.any() and (~alive).any()


def test_rollout_host_build_bit_exact(ext_host, monkeypatch):
    """#3 (``sr_rollout.cu``), RK4 with 2 substeps."""
    fset, trees, x0s, ts, _ = sr_case()
    with monkeypatch.context() as m:
        patch_host_math(m)
        xs, alive = cr.sr_rollout_plain(trees, x0s, ts, fset, "rk4", 2)
    p, d, n = trees.ops.shape
    b, t_steps = x0s.shape[0], ts.shape[0]
    out = np.zeros((t_steps, p, b, d), np.float32)
    alive_h = np.zeros((p, b), np.uint8)
    h, h_final = cr.rollout_step(ts, "rk4", 2)
    fn = ext_host("sr_rollout").sr_rollout_host
    fn.argtypes = [ctypes.c_void_p] * 6 + [ctypes.c_int] * 9 + [ctypes.c_float] * 3
    arrays = [np.ascontiguousarray(a.numpy()) for a in (trees.ops, trees.const, fset.device_ops(), x0s)]
    assert fn(*(a.ctypes.data for a in arrays), out.ctypes.data, alive_h.ctypes.data, p, d, n, b,
              t_steps, fset.var_start, fset.has_unary, cr.METHODS["rk4"], 2,
              np.float32(h * 0.5), np.float32(h), h_final) == 0
    np.testing.assert_array_equal(alive_h.astype(bool), alive[-1].numpy())
    np.testing.assert_array_equal(out, xs.numpy())
    assert alive[-1].any()


@pytest.mark.parametrize("kind,budget", [(ca.GLOBAL, 40), (ca.INTERVAL, 8)])
def test_adaptive_host_build_bit_exact(ext_host, monkeypatch, kind, budget):
    """#5 (global budget) and #4 (per interval), dopri5."""
    fset, trees, x0s, ts, ys = sr_case(pop=16, t_end=1.0)
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
    fn = ext_host("sr_adaptive").sr_adaptive_host
    fn.argtypes = [ctypes.c_int] + [ctypes.c_void_p] * 9 + [ctypes.c_int] * 9 + [ctypes.c_float] * 3
    assert fn(kind, *(a.ctypes.data for a in arrays), err.ctypes.data, alive_h.ctypes.data,
              steps_h.ctypes.data, p, x0s.shape[1], trees.ops.shape[-1], b, ts.shape[0],
              fset.var_start, fset.has_unary, ca.METHODS["dopri5"], budget, 1e-4, 1e-6, 0.9) == 0
    np.testing.assert_array_equal(alive_h.astype(bool), alive.numpy())
    np.testing.assert_array_equal(steps_h, steps.numpy())
    assert same_bits(torch.from_numpy(err / np.float32(ts.shape[0])), mse)
    assert alive.any()


POLICY_EXT = [("+", 2), ("-", 2), ("*", 2), ("tanh", 1), ("sin", 1), ("cos", 1), ("max", 2),
              ("abs", 1), ("square", 1), ("exp", 1, 0.3), ("pow", 2, 0.3)]


def policy_case(state_size, device="cpu", seed=0, n=30, pop=16, b=4, t_end=2.2, ops=POLICY_EXT):
    """Acrobot, ``pop`` policies grown with ``ops`` (depth 4) on ``b``
    trajectories."""
    env = tenvs.Acrobot()
    ys = [f"y{i}" for i in range(env.n_obs)]
    tg = [f"tgt{i}" for i in range(env.n_targets)]
    if state_size:
        a, u = [f"a{i}" for i in range(state_size)], [f"u{i}" for i in range(env.n_control)]
        fset = build_function_set(ops, [ys + a + u + tg, a + tg], [state_size, env.n_control])
    else:
        fset = build_function_set(ops, [ys + tg], [env.n_control])
    g = torch.Generator(device=device).manual_seed(seed)
    data = generate_control_data(env, g, torch.arange(0.0, t_end, 0.2, device=device), batch_size=b)
    trees = make_population_sampler(fset, 4, n)(g, pop)[0]
    return env, fset, data, trees


@pytest.fixture(scope="module")
def policy_ext(ext_host):
    lib = ext_host("policy")
    lib.policy_host.argtypes = [ctypes.c_int, ctypes.c_void_p]
    lib.policy_host.restype = ctypes.c_int
    return lib


@pytest.mark.parametrize("state_size", [0, 2])
def test_policy_host_build_bit_exact(policy_ext, monkeypatch, state_size):
    """#6 (RK4 x 2) on Acrobot policies with ``tanh``, ``max``, ``pow``, ..."""
    env, fset, (x0, ts, tgt, _, _, par), trees = policy_case(state_size)
    with monkeypatch.context() as m:
        patch_host_math(m)
        xs, us, alive = cp.policy_rollout_plain(trees, x0, ts, tgt, par, env, fset, 2, "rk4",
                                                state_size)
    status, hxs, hus, count, _ = cp.run_policy(
        lambda a: policy_ext.policy_host(cp.FIXED, a), cp.FIXED, trees, x0, ts, tgt, par, env,
        fset, state_size, "rk4", 2)
    assert status == 0
    assert same_bits(hxs, xs) and same_bits(hus, us)
    assert torch.equal(cp._alive_rows(count, ts.shape[0]), alive)


def test_policy_adaptive_host_build_bit_exact(policy_ext, monkeypatch):
    """#7 (dopri5, 8 steps per interval), static."""
    env, fset, (x0, ts, tgt, _, _, par), trees = policy_case(0, t_end=1.2)
    with monkeypatch.context() as m:
        patch_host_math(m)
        xs, us, alive, steps = cp.policy_rollout_adaptive_plain(
            trees, x0, ts, tgt, par, env, fset, 1e-4, 1e-4, 8, "dopri5", 0.9, 0)
    status, hxs, hus, count, hsteps = cp.run_policy(
        lambda a: policy_ext.policy_host(cp.ADAPTIVE, a), cp.ADAPTIVE, trees, x0, ts, tgt, par,
        env, fset, 0, "dopri5", max_steps=8, rtol=1e-4, atol=1e-4, safety=0.9)
    assert status == 0
    assert same_bits(hxs, xs) and same_bits(hus, us) and torch.equal(hsteps, steps)
    assert torch.equal(cp._alive_rows(count, ts.shape[0]), alive)


def test_reproduce_host_build_takes_eleven_operators(tmp_path):
    """#2 (tree surgery: arities and probabilities) with 11 operators."""
    cfg, args = reproduce_case(ops=ELEVEN)
    assert cfg.num_operators == 11
    ref = reproduce_lanes_plain(*args, cfg)
    status, outs = reproduce_host(_build.build_host("reproduce", tmp_path), args, cfg)
    assert status == 0
    np.testing.assert_array_equal(outs[0], ref[0].numpy())
    np.testing.assert_array_equal(outs[2], ref[2].numpy())
    np.testing.assert_allclose(outs[1], ref[1].numpy(), rtol=1e-6, atol=0)
    np.testing.assert_allclose(outs[3], ref[3].numpy(), rtol=1e-6, atol=0)


# ------------------------------------------------- the evaluators against JAX

def test_sr_evaluator_matches_jax():
    jax = pytest.importorskip("jax")
    import jax.numpy as jnp
    import jax.random as jr
    from scipy.stats import spearmanr

    from multitreegp_tpu.models.environments import VanDerPolOscillator as JaxVdP
    from multitreegp_tpu.models.evaluators import SREvaluator as JaxSREvaluator
    from multitreegp_tpu.models.evaluators import generate_sr_data as jax_generate
    from multitreegp_tpu.ops.initialization import make_population_sampler as jax_sampler
    from multitreegp_tpu_torch.convert import function_set_from_jax, sr_data_from_numpy, trees_from_numpy
    from multitreegp_tpu_torch.models.evaluators import SREvaluator

    jf = jax_set(ALL_OPS, [["x0", "x1"]], [2])
    data = jax_generate(JaxVdP(0.0, 0.0), jr.PRNGKey(0), jnp.arange(0.0, 2.0, 0.2), batch_size=4,
                        substeps=8)
    pop = jax_sampler(jf, 4, 32)(jr.PRNGKey(1), 64)
    ref = np.asarray(jax.jit(JaxSREvaluator(jf, interpreter="gather").evaluate_population)(pop, data))
    ev = SREvaluator(function_set_from_jax(jf))
    got = ev.evaluate_population(trees_from_numpy(*[np.asarray(a) for a in pop]),
                                 sr_data_from_numpy(*data[:3])).numpy()
    clamped = ref == 1e5
    np.testing.assert_array_equal(got == 1e5, clamped)
    ok = ~clamped
    assert ok.sum() >= 16
    rel = np.abs(got[ok] - ref[ok]) / np.maximum(np.abs(ref[ok]), 1e-12)
    assert np.median(rel) <= 1e-6
    assert spearmanr(got[ok], ref[ok]).statistic >= 0.997


def test_static_policy_with_tanh_matches_jax():
    jax = pytest.importorskip("jax")
    import jax.numpy as jnp
    from test_torch_policy import assert_fitness_agree, assert_lanes_agree, case, evaluators

    ops = [("+", jnp.add, 2, 0.5), ("-", jnp.subtract, 2, 0.1), ("*", jnp.multiply, 2, 0.5),
           ("tanh", jnp.tanh, 1, 0.4), ("sin", jnp.sin, 1, 0.3), ("cos", jnp.cos, 1, 0.3)]
    jenv, tenv, jf, tf, jdata, tdata, jpop, tpop = case("Acrobot", ops=ops)
    assert tf.extended
    jev, tev = evaluators(jenv, tenv, jf, tf, 0, substeps=2)
    (jxs, jal), jfit = jax.jit(lambda p, d: (jev._rollout_general(p, d),
                                             jev.evaluate_population(p, d)))(jpop, jdata)
    txs, tal = tev._rollout_general(tpop, tdata)
    assert_lanes_agree(txs, tal, jxs, jal)
    assert_fitness_agree(tev.evaluate_population(tpop, tdata), jfit)


# ----------------------------------------------------------- the sampler's law

def operator_rows(trees, var_start):
    ops = np.asarray(trees.ops).reshape(-1)
    return ops[(ops >= 2) & (ops < var_start)]


def tv(a, b) -> float:
    keys = np.union1d(a, b)
    return 0.5 * float(sum(abs((a == k).mean() - (b == k).mean()) for k in keys))


def test_sampler_operator_law_matches_jax():
    """Operator frequencies of 4,096 candidates x 2 trees (depth 4, N = 32)
    sampled with 11 operators by each package; the control swaps the
    probabilities of ``+`` and ``log``."""
    import jax.random as jr
    from multitreegp_tpu.ops.initialization import make_population_sampler as jax_sampler
    from multitreegp_tpu_torch.convert import function_set_from_jax

    jf = jax_set(ELEVEN, [["x0", "x1"]], [2])
    pf = function_set_from_jax(jf)
    want = operator_rows(jax_sampler(jf, 4, 32)(jr.PRNGKey(5), 4096), pf.var_start)
    got = operator_rows(make_population_sampler(pf, 4, 32)(torch.Generator().manual_seed(5), 4096)[0],
                        pf.var_start)
    probs = list(pf.operator_probs)
    i, j = pf.operator_names.index("+"), pf.operator_names.index("log")
    probs[i], probs[j] = probs[j], probs[i]
    swapped = dataclasses.replace(pf, operator_probs=tuple(probs))
    other = operator_rows(make_population_sampler(swapped, 4, 32)(torch.Generator().manual_seed(5),
                                                                 4096)[0], pf.var_start)
    assert len(want) > 20000 and set(np.unique(got)) == set(range(2, pf.var_start))
    assert tv(got, want) <= 0.03
    assert tv(other, want) > 0.03


# ------------------------------------------------------------------ the card

@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU (CUDA kernels have no CPU mode)")
    return torch.device("cuda")


@pytest.mark.cuda
@pytest.mark.parametrize("name", EXTENDED)
def test_interpreter_templates_match_plain_on_card(cuda, name):
    """#8 through ``evaluate_trees`` and #9 through autograd (the extended
    build) on each operator's trees: per lane, bit for bit."""
    fset, trees, data, g = template_case(name, cuda)
    before = ci.evaluate_trees_vjp_cuda.launches
    const = trees.const.clone().requires_grad_(True)
    x = data.clone().requires_grad_(True)
    out = evaluate_trees(trees._replace(const=const), x, fset)
    dconst, ddata = torch.autograd.grad(out, (const, x), g)
    ref = evaluate_trees_plain(trees, data, fset)
    ref_c, ref_d = evaluate_trees_vjp_plain(trees, data, g, fset)
    torch.cuda.synchronize()
    assert ci.evaluate_trees_vjp_cuda.launches == before + 1
    assert same_bits(out, ref) and same_bits(dconst, ref_c) and same_bits(ddata, ref_d)


@pytest.mark.cuda
def test_subnormal_cotangent_matches_plain_on_card(cuda):
    """#9 and the plain VJP on the card keep a second operand's subnormal
    cotangent (the plain version's gather backward writes, it does not add
    atomically: the card's atomic add flushes subnormals)."""
    fset, trees, data, g = subnormal_case(cuda)
    want = g * data[..., 0]
    _, ref_d = evaluate_trees_vjp_plain(trees, data, g, fset)
    _, got_d = ci.evaluate_trees_vjp_cuda(trees, data, g, fset)
    torch.cuda.synchronize()
    assert torch.equal(ref_d[..., 1], want) and torch.equal(got_d[..., 1], want)


@pytest.mark.cuda
@pytest.mark.parametrize("n,depth", [(32, 5), (256, 7), (1024, 7)])
def test_interpreter_population_matches_plain_on_card(cuda, n, depth):
    from test_torch_kernels import check_interpreter_on_card

    check_interpreter_on_card(*population_case(n, depth, k=12 if n > 32 else 24, members=16,
                                               device=cuda))


@pytest.mark.cuda
def test_tree_kernels_match_plain_on_card(cuda):
    """#1, #3, #5 and #4 on 256 candidates with all 17 operators x 16
    trajectories; #6 and #7 on Acrobot policies with ``tanh``, ``max``,
    ``pow``, ...: every lane bit for bit, launch counters."""
    fset, trees, x0s, ts, ys = sr_case(pop=256, b=16, t_end=2.0, seed=4)
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
        env, pf, (x0, pts, tgt, _, _, par), pol = policy_case(state_size, cuda, pop=64, b=16)
        before = cp.policy_rollout_cuda.launches
        got = cp.rollout_policy(pol, x0, pts, tgt, par, env, pf, 2, "rk4", state_size)
        want = cp.policy_rollout_plain(pol, x0, pts, tgt, par, env, pf, 2, "rk4", state_size)
        torch.cuda.synchronize()
        assert cp.policy_rollout_cuda.launches == before + 1
        assert same_bits(got[0], want[0]) and same_bits(got[1], want[1])
        assert torch.equal(got[2], want[2])
    env, pf, (x0, pts, tgt, _, _, par), pol = policy_case(0, cuda, pop=64, b=16, t_end=1.2)
    got = cp.policy_rollout_adaptive_cuda(pol, x0, pts, tgt, par, env, pf, max_steps=8)
    want = cp.policy_rollout_adaptive_plain(pol, x0, pts, tgt, par, env, pf, 1e-4, 1e-4, 8)
    torch.cuda.synchronize()
    assert all(same_bits(a, b) for a, b in zip(got[:2], want[:2]))
    assert torch.equal(got[2], want[2]) and torch.equal(got[3], want[3])


@pytest.mark.cuda
def test_reproduce_kernel_takes_eleven_operators_on_card(cuda):
    cfg, args = reproduce_case(cuda, lanes=1024, ops=ELEVEN)
    out = reproduce_lanes(*args, cfg)
    ref = reproduce_lanes_plain(*args, cfg)
    torch.cuda.synchronize()
    assert torch.equal(out[0], ref[0]) and torch.equal(out[2], ref[2])
    torch.testing.assert_close(out[1], ref[1], rtol=1e-6, atol=0)
    torch.testing.assert_close(out[3], ref[3], rtol=1e-6, atol=0)
