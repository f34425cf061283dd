"""PyTorch port: user operator callables as generated device code.

A torch callable outside the operator table, or under a table name but
computing something else, is traced (``core/user_ops.py``) into a forward and
a VJP written as float32 code, compiled into the user build of each tree
source (``_build.user_variant``, the libraries ``<name>_u<hash12>``). The set
used throughout is gplearn's protected function set (``gplearn/functions.py``):
``+ - *`` and protected division, log, square root and inverse, and the
sigmoid, as torch callables under the names ``/``, ``log``, ``sqrt``, ``inv``
and ``sig``.

Tolerances, and why:

* the user host build of #8/#9 against the plain version: bit for bit per
  lane, forward and VJP (``dconst``, ``ddata``), on data with ``|y|`` at
  0.001 and one float32 step on each side of it, ``y == 0``, negatives, inf
  and NaN. The plain side runs with the C library's ``expf``/``logf`` and a
  correctly rounded ``sqrt`` swapped into PyTorch (``patch_host_math``), as
  the host build calls them; on the card both call CUDA's. The where-guarded
  division's NaN gradient at ``y == 0`` (the unselected branch's ``0 / 0``
  reaches the cotangent, in autograd and ``jax.vjp`` alike) is reference
  behaviour, held on both sides.
* against JAX (the same set as ``jnp`` lambdas): ``evaluate_trees`` and its
  gradient within 4 ulp or 1e-6 relative with the same NaN/inf pattern, as
  ``test_torch_operators.py`` holds; where an ``abs`` reads exactly 0 the
  conventions differ (autograd ``g * sgn(0) = 0``, JAX ``g``), checked as
  such; ``SREvaluator.evaluate_population`` (RK4, T = 10, pop 64, N = 32):
  the same clamped candidates, survivors' median relative error <= 1e-6 and
  Spearman >= 0.997 over the survivors whose fitness one float32 step of the
  initial states moves by at most 1e-4 relative (a trajectory near the pole
  of ``inv`` or of the protected division is chaotic: such a step moves two
  of the 64 candidates by 50% in the port alone).

The host builds of the ``tree_prog.cuh`` kernels (#1, #3, #4/#5, #6/#7) and
#2 with the user set are in ``test_torch_user_kernels.py``. Tests that need
the card carry the ``cuda`` marker (every lane bit for bit against the plain
version, where PyTorch and the kernels call the same CUDA functions). JAX is
imported only by the tests that compare with it (``pytest --noconftest`` runs
the card tests where there is no JAX).
"""
import shutil

import numpy as np
import pytest
import torch

from multitreegp_tpu_torch import _build
from multitreegp_tpu_torch.core import cuda_interpreter as ci
from multitreegp_tpu_torch.core.interpreter import (
    evaluate_trees, evaluate_trees_plain, evaluate_trees_vjp_plain,
)
from multitreegp_tpu_torch.core.registry import USER_FROM, build_function_set, gplearn_operators
from multitreegp_tpu_torch.core.trees import TreeTensors, rebuild_pointers
from test_torch_kernels import patch_host_math, per_lane_operands, same_bits
from test_torch_operators import (
    assert_close_to_jax, assert_same_nonfinite, host_interpreter, population_case, tree_rows,
)

torch.set_num_threads(1)


# gplearn's protected operators as torch callables (name -> (fn, arity)),
# the gen workload's probabilities: + 0.5, - 0.1, * 0.5, / 0.1, the rest 0.1
GPLEARN_OPS = gplearn_operators()
GPLEARN = {name: (fn, a) for name, fn, a, _ in GPLEARN_OPS[3:]}
USER_NAMES = tuple(GPLEARN)
sigmoid = GPLEARN["sig"][0]


def mixed_a(x, y):
    """Comparisons, logical operators, ``rsub``, ``sign``, ``tanh``, ``sin``
    and ``cos`` (the rest of the emitter's table)."""
    keep = (x > y) & (x != 0.0) | ~(y >= -1.0)
    return torch.where(keep, torch.tanh(x) - torch.sin(y), 2.0 - torch.cos(x) * torch.sign(y))


def mixed_b(x, y):
    """``full_like``, ``ones_like``, ``clone``, ``logical_not``, ``tan`` and
    integer powers 2 and 3 (their backward: ``pow`` by 1 and 2)."""
    c = torch.full_like(x, 0.5)
    return torch.where(torch.logical_not(x < c) & (x <= 3.0), torch.tan(x.clone()),
                       torch.ones_like(x) - x ** 2 + x ** 3 * 0.25 - y)


MIXED_OPS = [("+", 2, 0.5), ("-", 2, 0.1), ("*", 2, 0.5), ("mix_a", mixed_a, 2, 0.2),
             ("mix_b", mixed_b, 2, 0.2)]
ARITY = dict({name: a for name, (_, a) in GPLEARN.items()}, mix_a=2, mix_b=2)
N_TEMPLATE = 8
B = np.float32(0.001)
B_BELOW, B_ABOVE = np.nextafter(B, np.float32(0)), np.nextafter(B, np.float32(1))
INF, NAN = float("inf"), float("nan")
# (x0, x1) at the operators' edges: |y| at the 0.001 bound and one step on
# each side of it, y == 0 and -0, x == 0, negatives, inf, NaN, exp's overflow
SPECIAL = [(1.0, B), (1.0, B_BELOW), (1.0, B_ABOVE), (-2.0, -B), (-2.0, -B_BELOW), (3.0, -B_ABOVE),
           (1.5, 0.0), (0.0, 0.0), (-2.5, -0.0), (B, 1.0), (B_BELOW, -1.0), (-B_ABOVE, 0.5),
           (-B, 2.0), (INF, 1.0), (1.0, INF), (-INF, -2.0), (NAN, 1.0), (1.0, NAN),
           (-3.0, -0.5), (100.0, -100.0), (-100.0, 50.0), (0.0, -1.0)]
L = 48


def gplearn_set(variable_list=(("x0", "x1"),), layer_sizes=(1,), ops=GPLEARN_OPS):
    return build_function_set(ops, [list(v) for v in variable_list], list(layer_sizes))


def jax_gplearn_set(variable_list, layer_sizes):
    """The same set as ``jnp`` lambdas in the JAX package's function set."""
    import jax.numpy as jnp
    from multitreegp_tpu.core.registry import build_function_set as jax_function_set

    fns = {"+": (jnp.add, 2), "-": (jnp.subtract, 2), "*": (jnp.multiply, 2),
           "/": (lambda x, y: jnp.where(jnp.abs(y) > 0.001, x / y, 1.0), 2),
           "log": (lambda x: jnp.where(jnp.abs(x) > 0.001, jnp.log(jnp.abs(x)), 0.0), 1),
           "sqrt": (lambda x: jnp.sqrt(jnp.abs(x)), 1),
           "inv": (lambda x: jnp.where(jnp.abs(x) > 0.001, 1.0 / x, 0.0), 1),
           "sig": (lambda x: 1 / (1 + jnp.exp(-x)), 1)}
    probs = {name: p for name, *_, p in GPLEARN_OPS}
    return jax_function_set([(name, fn, a, probs[name]) for name, (fn, a) in fns.items()],
                            variable_list, layer_sizes)


def torch_counterparts():
    return {name: fn for name, (fn, _) in GPLEARN.items()}


# ------------------------------------------------------------ trace and emit

def test_gplearn_set_takes_user_ids_and_the_user_build():
    fset = gplearn_set()
    assert fset.device_op_ids == (0, 1, 2) + tuple(range(USER_FROM, USER_FROM + 5))
    assert fset.refusals == () and fset.extended and fset.has_unary
    fset.require_device_ops()
    variant = fset.variant
    assert variant.suffix == "_u" + fset.user_hash[:12] and "-DMTGP_USER_OPS" in variant.flags
    path = _build.library_path("interpreter", variant)
    assert path.name.startswith(f"interpreter_u{fset.user_hash[:12]}-")
    assert path != _build.library_path("interpreter", True)
    # the default and extended libraries keep their names and hashes
    assert _build.library_path("interpreter", False) == _build.library_path("interpreter", _build.DEFAULT)
    assert _build.library_path("interpreter", True) == _build.library_path("interpreter", _build.EXTENDED)
    # the generated header: one forward and one VJP per user operator and a
    # dispatch of each per arity, constants as bit patterns (0.001 as
    # float32 is 0x3a83126f), no names
    text = fset.user_header
    assert text.count("inline float forward") == 5 + 2 and text.count("inline void vjp") == 5 + 2
    assert "forward_binary(int k, float x, float y) {\n  switch (k) {\n    default: return forward0" in text
    assert "0x3a83126fu" in text and "sig" not in text and "protected" not in text


def test_division_by_a_scalar_emits_the_cuda_rounding():
    """``x / 3.0``: PyTorch's CUDA kernel multiplies by the float32
    reciprocal of 3 (0x3eaaaaab), which the generated code writes for the
    card; its CPU kernel divides, which the host build does (the helper
    ``div_cpu_scalar`` holds both); the two round differently on some
    inputs. By a power of 2 the reciprocal is exact: one multiply."""
    fset = build_function_set([("+", 2), ("third", lambda x: x / 3.0, 1)], [["x0"]], [1])
    assert "mtgp_user::div_cpu_scalar(x, mtgp_user::bits(0x40400000u), mtgp_user::bits(0x3eaaaaabu))" \
        in fset.user_header
    assert "#ifdef __CUDA_ARCH__\n  (void)b;\n  return a * inv_b;\n#else\n  (void)inv_b;\n  return a / b;" \
        in fset.user_header
    x = torch.from_numpy(np.random.default_rng(1).normal(size=4096).astype(np.float32))
    assert bool((x / 3.0 != x * np.float32(1 / np.float32(3.0))).any())
    assert bool((x / 3.0 == torch.from_numpy(x.numpy() / np.float32(3.0))).all())
    half = build_function_set([("+", 2), ("half", lambda x: x / 4.0, 1)], [["x0"]], [1])
    assert "x * mtgp_user::bits(0x3e800000u)" in half.user_header and "div_cpu_scalar" not in half.user_header


def test_header_hash_is_stable_and_follows_the_code():
    a, b = gplearn_set(), gplearn_set()
    assert a.user_header == b.user_header and a.user_hash == b.user_hash
    # the same code under other names shares the build
    renamed = build_function_set([("+", 2), ("-", 2), ("*", 2)] + [
        (f"op{k}", fn, ar) for k, (fn, ar) in enumerate(GPLEARN.values())], [["x0", "x1"]], [1])
    assert renamed.user_hash == a.user_hash
    # a constant changed: other code, another hash and library
    moved = build_function_set(GPLEARN_OPS[:3] + [
        ("/", lambda x, y: torch.where(torch.abs(y) > 0.002, x / y, 1.0), 2)] + GPLEARN_OPS[4:],
        [["x0", "x1"]], [1])
    assert moved.device_op_ids == a.device_op_ids and moved.user_hash != a.user_hash
    assert moved.variant.suffix != a.variant.suffix


def test_same_ids_different_code_take_their_own_layouts_and_libraries(host_interp):
    """Two sets with the same device op ids and different user code: the
    interpreter's layout cache keys on the header's hash, and each set's
    host build computes its own operator."""
    ops = [("+", 2), ("f", lambda x: torch.abs(x) * 2.0, 1)]
    other = [("+", 2), ("f", lambda x: torch.abs(x) * 3.0, 1)]
    f1, f2 = (build_function_set(o, [["x0"]], [1]) for o in (ops, other))
    assert f1.device_op_ids == f2.device_op_ids and f1.user_hash != f2.user_hash
    rows, const = tree_rows(("f", "x0"), f1, 4)
    trees = TreeTensors(torch.tensor([rows], dtype=torch.int32),
                        *rebuild_pointers(torch.tensor([rows], dtype=torch.int32), f1.slots()),
                        torch.tensor([const]))
    data = torch.tensor([[-1.5]])
    outs = []
    for fs in (f1, f2):
        lib = host_interp(fs)
        status, out = ci.run_forward(lib.interpret_fwd, trees, data, fs)
        assert status == 0
        outs.append(float(out[0]))
    assert outs == [3.0, 4.5]
    assert ci._signature(trees, data, f1) != ci._signature(trees, data, f2)


def unreadable(x):
    return x if bool((x > 0).all()) else -x


def centred(x):
    return x - x.mean()


def noisy(x):
    return x + torch.rand_like(x)


@pytest.mark.parametrize("fn,reason", [
    (unreadable, "does not trace"), (centred, "reduces"), (noisy, "draws random numbers"),
    (lambda x: x // 2.0, "does not trace"),
    (lambda x: x * torch.tensor([2.0]), "tensor constant with a lane axis"),
    (lambda x: (x.double() * 2).float(), "aten._to_copy.default computes in torch.float64")])
def test_refused_callable_runs_on_the_cpu_only(fn, reason):
    """A callable the emitter refuses keeps no device op: the kernels raise
    ``NotImplementedError`` naming the reason, the CPU runs it."""
    fset = build_function_set([("+", 2), ("*", 2), ("refused", fn, 1)], [["x0", "x1"]], [1])
    assert fset.device_op_ids == (0, 2, -1) and fset.user_header == ""
    with pytest.raises(NotImplementedError, match="refused") as err:
        fset.require_device_ops()
    assert reason in str(err.value)
    rows, const = tree_rows(("+", ("refused", "x0"), "x1"), fset, 6)
    ops = torch.tensor([rows], dtype=torch.int32)
    trees = TreeTensors(ops, *rebuild_pointers(ops, fset.slots()), torch.tensor([const]))
    data = torch.tensor([[0.5, 2.0], [1.5, -1.0]])
    got = evaluate_trees(trees.map(lambda a: a.expand(2, -1)), data, fset)
    assert torch.isfinite(got).all()
    with pytest.raises(NotImplementedError, match="refused"):  # never the plain version
        ci.run_forward(None, trees.map(lambda a: a.expand(2, -1)), data, fset)


def test_user_ids_stop_at_63():
    """The fixed instances' decoded rows keep the device op id in 6 bits, so
    their ids stop at 63; a set's ids do not: the 48th user operator takes
    id 64, none is refused, and the set runs the wide instances."""
    from multitreegp_tpu_torch.core import cuda_interpreter as ci
    from multitreegp_tpu_torch.core import cuda_rollout as cr
    from multitreegp_tpu_torch.core.registry import FIXED_MAX_OP

    many = [(f"f{k}", (lambda c: lambda x: x * float(c))(k + 2), 1) for k in range(48)]
    fset = build_function_set([("+", 2)] + many, [["x0"]], [1])
    assert fset.device_op_ids[-2] == FIXED_MAX_OP == 63 and fset.device_op_ids[-1] == 64
    fset.require_device_ops()
    assert not cr.takes_fixed(2, 4, 1, fset.max_device_op) and cr.takes_fixed(2, 4, 1, 63)
    assert not ci.takes_fixed(32, 1, 32, fset.max_device_op) and ci.op_table_words(fset) == 65


# ----------------------------------------------- host builds: #8/#9 bit for bit

@pytest.fixture(scope="module")
def host_interp(tmp_path_factory):
    if shutil.which("g++") is None and shutil.which("c++") is None:
        pytest.skip("no host C++ compiler")
    out = tmp_path_factory.mktemp("user_interp")
    made = {}

    def get(fset):
        key = fset.user_hash
        if key not in made:
            made[key] = _build.build_host("interpreter", out, fset.variant)
        return made[key]

    return get


def templates(name, c):
    """Six trees around the operator ``name``: its operands are leaves, a
    product of leaves or ``x0 - x1``, its value at most multiplied once."""
    if ARITY[name] == 2:
        return [(name, "x0", "x1"), (name, "x1", c[0]), (name, c[1], "x0"), (name, "x0", "x0"),
                (name, ("*", "x0", c[2]), "x1"), ("*", c[3], (name, "x1", "x0"))]
    return [(name, "x0"), (name, ("*", "x1", c[0])), ("*", c[1], (name, "x0")),
            (name, ("-", "x0", "x1")), (name, c[2]), ("*", (name, "x1"), "x0")]


def template_case(name, device="cpu", seed=15, fset=None):
    """``(fset, trees (6, L, N), data (6, L, 2), g (6, L))`` of operator
    ``name``'s six trees on ``L`` data vectors, the first ones
    :data:`SPECIAL`, from ``seed`` with numpy."""
    fset = fset or gplearn_set(ops=GPLEARN_OPS if name in GPLEARN else MIXED_OPS)
    rng = np.random.default_rng(seed)
    c = [float(v) for v in (rng.normal(size=6) * 1.5).astype(np.float32)]
    rows = [tree_rows(e, fset, N_TEMPLATE) for e in templates(name, c)]
    ops = torch.tensor([r[0] for r in rows], dtype=torch.int32)
    const = torch.tensor([r[1] for r in rows], dtype=torch.float32)
    c1, c2 = rebuild_pointers(ops, fset.slots())
    x = (rng.normal(size=(L, 2)) * 2).astype(np.float32)
    x[:len(SPECIAL)] = np.asarray(SPECIAL, np.float32)
    k = len(rows)
    trees = TreeTensors(ops, c1, c2, const).map(
        lambda a: a[:, None].expand(k, L, N_TEMPLATE).contiguous().to(device))
    data = torch.from_numpy(x)[None].expand(k, L, 2).contiguous().to(device)
    g = torch.from_numpy(rng.normal(size=(k, L)).astype(np.float32)).to(device)
    return fset, trees, data, g


def plain_interpreter(trees, data, g, fset, monkeypatch):
    with monkeypatch.context() as m:
        patch_host_math(m)
        full, x = per_lane_operands(trees, data)
        return (evaluate_trees_plain(full, x, fset),) + evaluate_trees_vjp_plain(full, x, g, fset)


@pytest.mark.parametrize("name", USER_NAMES + ("mix_a", "mix_b"))
def test_interpreter_host_build_templates_bit_exact(host_interp, monkeypatch, name):
    """#8/#9's user host build on each protected operator's trees (and on
    two callables that hold the rest of the emitter's table), per lane:
    roots, ``dconst`` and ``ddata`` bit for bit with autograd's formulas,
    the NaN gradients at ``y == 0`` included."""
    fset, trees, data, g = template_case(name)
    got = host_interpreter(host_interp(fset), trees, data, g, fset)
    want = plain_interpreter(trees, data, g, fset, monkeypatch)
    assert all(same_bits(a, b) for a, b in zip(got, want))
    assert (want[1] != 0).any() and torch.isfinite(want[0]).float().mean() > 0.5
    if name == "/":  # x0 / x1 at x1 == 0: the value 1, the gradients NaN
        at = data[0, :, 1] == 0
        assert at.any() and (want[0][0, at] == 1).all() and torch.isnan(want[2][0, at]).all()


@pytest.mark.parametrize("n,depth", [(32, 5), (256, 7)])
def test_interpreter_host_build_population_bit_exact(host_interp, monkeypatch, n, depth):
    """The N <= 32 and N <= 256 instances on sampled trees of the gplearn
    set in the recompute's layout (5 trajectories a tree)."""
    fset, trees, data, g = population_case(n, depth, k=12 if n > 32 else 24, ops=GPLEARN_OPS)
    got = host_interpreter(host_interp(fset), trees, data, g, fset)
    want = plain_interpreter(trees, data, g, fset, monkeypatch)
    assert all(same_bits(a, b) for a, b in zip(got, want))
    user_rows = (trees.ops >= fset.string_to_op["/"]) & (trees.ops < fset.var_start)
    assert int(user_rows.sum()) > 20 and torch.isfinite(want[0]).float().mean() > 0.5


def test_extended_build_refuses_user_ids(tmp_path):
    """The extended build's layout check stops at ``min``: a user set can
    never run another build's code."""
    lib = _build.build_host("interpreter", tmp_path, True)
    fset, trees, data, g = template_case("sig")
    status, _ = ci.run_forward(lib.interpret_fwd, trees, data, fset)
    assert status != 0


# ------------------------------------------------------------ against JAX

def jax_value_and_grads(jf, trees, data, g):
    import jax
    from multitreegp_tpu.core.interpreter import evaluate_trees as jax_evaluate
    from multitreegp_tpu.core.trees import TreeTensors as JaxTrees

    ev = lambda t, d: jax_evaluate(JaxTrees(*t), d, jf, impl="gather")
    t = [np.asarray(a) for a in trees]
    d, gg = data.numpy(), g.numpy()
    grad = jax.grad(lambda c, d: (ev((*t[:3], c), d) * gg).sum(), argnums=(0, 1))
    return np.asarray(ev(t, d)), tuple(np.asarray(x) for x in grad(t[3], d))


@pytest.mark.parametrize("name", USER_NAMES)
def test_operator_matches_jax(name):
    """Each protected operator's trees against the JAX package with the same
    set as ``jnp`` lambdas: roots and gradients, the same NaN/inf pattern;
    finite values within 4 ulp or 1e-6 relative (gradients also within 1e-6
    of the tree's largest |gradient|). Where an ``abs`` reads exactly 0, the
    gradient conventions differ and are checked as such."""
    pytest.importorskip("jax")
    from multitreegp_tpu_torch.convert import function_set_from_jax

    jf = jax_gplearn_set([["x0", "x1"]], [1])
    fset = function_set_from_jax(jf, torch_counterparts())
    assert fset.device_op_ids == gplearn_set().device_op_ids
    _, trees, data, g = template_case(name, fset=fset)
    want, (want_c, want_d) = jax_value_and_grads(jf, trees, data, g)
    const = trees.const.clone().requires_grad_(True)
    x = data.clone().requires_grad_(True)
    out = evaluate_trees(trees._replace(const=const), x, fset)
    got_c, got_d = (t.numpy() for t in torch.autograd.grad(out, (const, x), g))
    got = out.detach().numpy()
    assert_close_to_jax(got, want)
    fin = np.isfinite(got) & np.isfinite(want)  # (6, L): gradients of finite roots
    xs = data.numpy()
    if name in ("log", "sqrt", "inv", "/"):
        # abs at 0: autograd g * sgn(0) = 0, JAX g; the lanes with a 0 operand
        # of an abs row (or of /'s guard) are left out, tree 0 checked apart
        col = 1 if name == "/" else 0
        at = xs[0, :, col] == 0
        assert at.any()
        fin &= ~((xs[..., 0] == 0) | (xs[..., 1] == 0) | (xs[..., 0] == xs[..., 1]))
        if name == "sqrt":  # d sqrt|x| at 0: 0 * inf in autograd, JAX's g / 0
            assert np.isnan(got_d[0, at, 0]).all() and np.isinf(want_d[0, at, 0]).all()
    # x0 / x0 (tree 3 of /): its gradient g / x0 - g * ((x0 / x0) / x0) cancels,
    # and JAX forms the second term as (-g * x0) / x0 ** 2: within 4 ulp of
    # the terms' magnitude, 2 |g / x0|
    terms = np.zeros(fin.shape, np.float32)
    if name == "/":
        with np.errstate(divide="ignore", invalid="ignore"):
            terms[3] = 8 * np.finfo(np.float32).eps * 2 * np.abs(g.numpy()[3] / xs[3, :, 0])
    for k in range(fin.shape[0]):
        for got_k, want_k in ((got_c[k][fin[k]], want_c[k][fin[k]]),
                              (got_d[k][fin[k]], want_d[k][fin[k]])):
            finite = want_k[np.isfinite(want_k)]
            scale = float(np.abs(finite).max()) if finite.size else 0.0
            atol = np.broadcast_to(np.maximum(1e-6 * scale, terms[k][fin[k]])[:, None], want_k.shape)
            assert_close_to_jax(got_k, want_k, atol=atol[np.isfinite(want_k)])


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

    jf = jax_gplearn_set([["x0", "x1"]], [2])
    data = jax_generate(JaxVdP(0.0, 0.0), jr.PRNGKey(0), jnp.arange(0.0, 2.0, 0.2), batch_size=4,
                        substeps=8)
    pop = jax_sampler(jf, 4, 32)(jr.PRNGKey(1), 64)
    ref = np.asarray(jax.jit(JaxSREvaluator(jf, interpreter="gather").evaluate_population)(pop, data))
    ev = SREvaluator(function_set_from_jax(jf, torch_counterparts()))
    trees = trees_from_numpy(*[np.asarray(a) for a in pop])
    x0s, ts, ys, _ = sr_data_from_numpy(*data[:3])
    got = ev.evaluate_population(trees, (x0s, ts, ys, None)).numpy()
    clamped = ref == 1e5
    np.testing.assert_array_equal(got == 1e5, clamped)
    ok = ~clamped
    assert ok.sum() >= 16
    rel = np.abs(got[ok] - ref[ok]) / np.maximum(np.abs(ref[ok]), 1e-12)
    assert np.median(rel) <= 1e-6
    # trajectories that pass near a pole of 1 / x or of the protected
    # division (|x| just above 0.001) are chaotic: one float32 step of the
    # initial states moves such a candidate's fitness by up to 50% in the
    # port alone. The ranking is held on the candidates that such a step
    # moves by at most 1e-4 relative, at least 90% of the survivors.
    x0_step = torch.from_numpy(np.nextafter(x0s.numpy(), np.float32(np.inf)))
    moved = ev.evaluate_population(trees, (x0_step, ts, ys, None)).numpy()
    stable = np.abs(moved - got) <= 1e-4 * np.abs(got)
    assert stable[ok].mean() >= 0.9
    keep = ok & stable
    assert spearmanr(got[keep], ref[keep]).statistic >= 0.997


def test_function_set_from_jax_takes_torch_counterparts():
    """``function_set_from_jax`` with ``torch_fns``: the counterparts are held
    against the ``jnp`` callables on the probe values; a missing one and a
    wrong one raise ``ValueError``."""
    pytest.importorskip("jax")
    from multitreegp_tpu_torch.convert import function_set_from_jax

    jf = jax_gplearn_set([["x0", "x1"]], [2])
    fset = function_set_from_jax(jf, torch_counterparts())
    assert fset.operator_names == jf.operator_names and fset.var_start == jf.var_start
    assert fset.device_op_ids[3:] == tuple(range(USER_FROM, USER_FROM + 5))
    missing = {k: v for k, v in torch_counterparts().items() if k != "sig"}
    with pytest.raises(ValueError, match="'sig'.*torch counterpart"):
        function_set_from_jax(jf, missing)
    # unprotected log under the protected log's name: it differs at 0 and below
    wrong = dict(torch_counterparts(), log=lambda x: torch.log(torch.abs(x)))
    with pytest.raises(ValueError, match="'log'.*differs"):
        function_set_from_jax(jf, wrong)
    # off by one float32 step past 1e-6 relative: differs too
    near = dict(torch_counterparts(), sig=lambda x: sigmoid(x) * (1 + 4e-6))
    with pytest.raises(ValueError, match="'sig'.*differs"):
        function_set_from_jax(jf, near)


def test_population_matches_jax():
    """A population sampled by JAX with the gplearn set (N = 32, depth 5)
    against JAX's ``evaluate_trees``: roots on 48 data vectors."""
    pytest.importorskip("jax")
    import jax.random as jr
    from multitreegp_tpu.core.interpreter import evaluate_trees as jax_evaluate
    from multitreegp_tpu.ops.initialization import make_population_sampler as jax_sampler
    from multitreegp_tpu_torch.convert import function_set_from_jax, trees_from_numpy

    jf = jax_gplearn_set([["x0", "x1"]], [1])
    jpop = jax_sampler(jf, 5, 32)(jr.PRNGKey(3), 64)
    jpop = type(jpop)(*(a[:, None, 0] for a in jpop))
    trees = trees_from_numpy(*[np.asarray(a) for a in jpop])
    data = (np.random.default_rng(3).normal(size=(1, L, 2)) * 2).astype(np.float32)
    want = np.asarray(jax_evaluate(jpop, data, jf, impl="gather"))
    got = evaluate_trees(trees, torch.from_numpy(data), function_set_from_jax(jf, torch_counterparts()))
    got = got.numpy()
    assert_same_nonfinite(got, want)
    fin = np.isfinite(want)
    scale = np.where(fin, np.abs(want), 0).max(axis=1, keepdims=True)
    close = np.abs(got - want) <= 1e-5 * np.maximum(np.abs(want), scale)
    assert close[fin].mean() >= 0.999 and fin.mean() > 0.5


# ------------------------------------------------------------------ the card

@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU (CUDA kernels have no CPU mode)")
    return torch.device("cuda")


@pytest.mark.cuda
@pytest.mark.parametrize("name", USER_NAMES + ("mix_a", "mix_b"))
def test_interpreter_templates_match_plain_on_card(cuda, name):
    """#8 through ``evaluate_trees`` and #9 through autograd (the user build)
    on each protected operator's trees: per lane, bit for bit."""
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
    assert fset.variant.suffix in "".join(_build._loaded)


@pytest.mark.cuda
@pytest.mark.parametrize("n,depth", [(32, 5), (256, 7), (1024, 7)])
def test_interpreter_population_matches_plain_on_card(cuda, n, depth):
    from test_torch_kernels import check_interpreter_on_card

    check_interpreter_on_card(*population_case(n, depth, k=12 if n > 32 else 24, members=16,
                                               device=cuda, ops=GPLEARN_OPS))


@pytest.mark.cuda
def test_scalar_division_matches_plain_on_card(cuda):
    """A division by a Python scalar: PyTorch's CUDA kernel multiplies by the
    float32 reciprocal (the CPU one divides), and so does the generated code;
    on the card only, where the plain version takes that rounding."""
    fset = build_function_set([("+", 2), ("*", 2), ("third", lambda x: x / 3.0 + 0.1, 1)],
                              [["x0", "x1"]], [1])
    assert fset.device_op_ids[-1] == USER_FROM
    rng = np.random.default_rng(9)
    rows, const = tree_rows(("third", ("*", "x0", "x1")), fset, N_TEMPLATE)
    ops = torch.tensor([rows], dtype=torch.int32)
    trees = TreeTensors(ops, *rebuild_pointers(ops, fset.slots()), torch.tensor([const]))
    trees = trees.map(lambda a: a.expand(4096, -1).contiguous().to(cuda))
    data = torch.from_numpy(rng.normal(size=(4096, 2)).astype(np.float32) * 3).to(cuda)
    g = torch.from_numpy(rng.normal(size=4096).astype(np.float32)).to(cuda)
    out = ci.evaluate_trees_cuda(trees, data, fset)
    dconst, ddata = ci.evaluate_trees_vjp_cuda(trees, data, g, fset)
    ref = evaluate_trees_plain(trees, data, fset)
    ref_c, ref_d = evaluate_trees_vjp_plain(trees, data, g, fset)
    torch.cuda.synchronize()
    assert same_bits(out, ref) and same_bits(dconst, ref_c) and same_bits(ddata, ref_d)


@pytest.mark.cuda
def test_refused_callable_raises_on_card(cuda):
    fset = build_function_set([("+", 2), ("floordiv", lambda x: x // 2.0, 1)], [["x0"]], [1])
    rows, const = tree_rows(("floordiv", "x0"), fset, 4)
    ops = torch.tensor([rows], dtype=torch.int32)
    trees = TreeTensors(ops, *rebuild_pointers(ops, fset.slots()), torch.tensor([const]))
    with pytest.raises(NotImplementedError, match="floor_divide"):
        evaluate_trees(trees.map(lambda a: a.to(cuda)), torch.zeros((1, 1), device=cuda), fset)
