"""PyTorch port: the interpreter kernels (forward and VJP) and the dispatcher.

* host build (runs here): ``csrc/interpreter.cu`` compiled for the host with
  ``g++`` (``-ffp-contract=off``), driven through the same Python wrapper code
  as on the card (``run_forward`` / ``run_backward``, the layout cache
  included). Per lane it must equal the plain version bit for bit: forward
  roots against ``evaluate_trees_plain``, and backward ``dconst`` /
  ``ddata`` against ``torch.autograd.grad`` of it (same float32 expressions,
  same accumulation order; NaN where the plain version has NaN), in every
  caller's layout (lanes grouped by the tree they share; groups that do not
  divide a warp or span blocks; one tree per lane) at N = 32 to 256, with and
  without ``sin``/``cos``, with blocks of one to four warps, past 256 rows
  (N = 300, 512 and 1024, second operands at rows past 511; 16 lanes a
  tree, and one, where at 1024 rows a block runs 16 lanes), and on
  hand-made trees whose second operand ``c2`` is a row a postorder stack
  would not read. Summed back over broadcast dimensions the order of the
  sums differs, so there each entry must lie within 1e-6 of the sum of the
  magnitudes of its per-lane terms.
* the layout cache: a hit gives a cold call's bits, a changed stride or
  shape gets its own entry, a bad cotangent is refused on a hit, and the
  cache stays bounded.
* ``EvaluateTrees`` on CPU tensors and its VJP against the JAX package's
  ``evaluate_trees_pallas`` run in interpret mode (N = 16 and 128): forward rtol 1e-6
  (atol 1e-6), gradients rtol 1e-5, atol 1e-5 (both interpret the same
  float32 rows; XLA may round the VJP's expressions an ulp apart).
* the dispatcher: CPU tensors go to the plain version; a function set with an
  operator the kernel lacks is refused by the kernel path; the plain versions
  of the other kernels never go through the dispatcher.
The same checks on the card are in ``test_torch_kernels.py`` (marker
``cuda``), which imports no JAX.
"""
import shutil

import jax
import jax.numpy as jnp
import jax.random as jr
import numpy as np
import pytest
import torch
from jax.experimental.pallas import tpu as pltpu

from multitreegp_tpu.core import pallas_interpreter as jax_pi
from multitreegp_tpu.core.registry import build_function_set as jax_function_set
from multitreegp_tpu.ops.initialization import make_population_sampler as jax_sampler
from multitreegp_tpu_torch import _build
from multitreegp_tpu_torch.convert import function_set_from_jax, trees_from_numpy
from multitreegp_tpu_torch.core import cuda_interpreter as ci
from multitreegp_tpu_torch.core import cuda_rollout, interpreter
from multitreegp_tpu_torch.core.cuda_reproduction import reproduce_lanes_plain
from multitreegp_tpu_torch.core.interpreter import (
    EvaluateTrees, evaluate_trees, evaluate_trees_plain, evaluate_trees_vjp_plain,
)
from multitreegp_tpu_torch.core.registry import build_function_set
from multitreegp_tpu_torch.core.trees import CONST, EMPTY
from multitreegp_tpu_torch.core.trees import OP_START
from test_torch_kernels import (
    DEEP_INTERP_MEMBERS, DEEP_INTERP_SIZES, INTERP_LAYOUTS, INTERP_OPS, INTERP_SIZES, NO_DEVICE_OP,
    TRIG, c2_case, deep_interp_case, interp_layout_case, lanes_case, many_operator_case,
    many_operator_set, patch_host_math, per_lane_operands, reproduce_case, same_bits,
    wide_interp_case,
)

torch.set_num_threads(1)

JAX_ARITH = [("+", jnp.add, 2, 0.5), ("-", jnp.subtract, 2, 0.1), ("*", jnp.multiply, 2, 0.5),
             ("/", jnp.divide, 2, 0.4)]


def far_links(trees) -> bool:
    rows = torch.arange(trees.max_nodes)
    return bool(((trees.c2 >= 0) & (rows - trees.c2 > 8)).any())


@pytest.fixture(scope="module")
def host_lib(tmp_path_factory):
    if shutil.which("g++") is None and shutil.which("c++") is None:
        pytest.skip("no host C++ compiler")
    return _build.build_host("interpreter", tmp_path_factory.mktemp("interp_kernel"))


@pytest.mark.parametrize("n,depth", [(32, 5), (64, 6)])
def test_host_build_per_lane_bit_exact(host_lib, n, depth):
    fset, pop, data, g = lanes_case(n=n, depth=depth)
    k, b = data.shape[:2]
    full = pop.map(lambda a: a[:, None].expand(k, b, 2, n))  # one tree per lane
    status, out = ci.run_forward(host_lib.interpret_fwd, full, data, fset)
    assert status == 0
    ref = evaluate_trees_plain(full, data, fset)
    assert same_bits(out, ref)
    assert (~torch.isfinite(ref)).any() and torch.isfinite(ref).float().mean() > 0.5
    assert far_links(pop), "the case should hold second operands far below their rows"

    status, dconst, ddata = ci.run_backward(host_lib.interpret_bwd, full, data, g, fset)
    assert status == 0
    ref_c, ref_d = evaluate_trees_vjp_plain(full, data, g, fset)
    assert dconst.shape == ref_c.shape and ddata.shape == ref_d.shape
    assert same_bits(dconst, ref_c) and same_bits(ddata, ref_d)
    assert (ref_c != 0).any() and (ref_d != 0).any() and (~torch.isfinite(ref_c)).any()


def test_host_build_trig_bit_exact(host_lib, monkeypatch):
    """Unary ``sin``/``cos`` rows: the forward and the VJP (``g * cos(x)``,
    ``g * -sin(x)``, autograd's formulas) bit for bit per lane, with the
    host's ``sinf``/``cosf`` in the plain version and its autograd."""
    fset, pop, data, g = lanes_case(ops=INTERP_OPS + TRIG)
    k, b = data.shape[:2]
    full = pop.map(lambda a: a[:, None].expand(k, b, 2, 32))
    unary = (pop.ops == fset.string_to_op["sin"]) | (pop.ops == fset.string_to_op["cos"])
    assert bool(unary.any())
    with monkeypatch.context() as m:
        patch_host_math(m)
        ref = evaluate_trees_plain(full, data, fset)
        ref_c, ref_d = evaluate_trees_vjp_plain(full, data, g, fset)
    status, out = ci.run_forward(host_lib.interpret_fwd, full, data, fset)
    assert status == 0 and same_bits(out, ref)
    status, dconst, ddata = ci.run_backward(host_lib.interpret_bwd, full, data, g, fset)
    assert status == 0
    assert same_bits(dconst, ref_c) and same_bits(ddata, ref_d)
    assert (ref_c != 0).any() and torch.isfinite(ref).float().mean() > 0.5


def host_per_lane(lib, trees, data, g, fset):
    """The host build's roots and per-lane cotangents in the operands' own
    layout (lanes grouped by the tree they share)."""
    status, out = ci.run_forward(lib.interpret_fwd, trees, data, fset)
    assert status == 0
    status, dconst, ddata = ci.run_backward(lib.interpret_bwd, trees, data, g, fset)
    assert status == 0
    return out, dconst, ddata


def plain_per_lane(trees, data, g, fset):
    """The plain version's roots and per-lane cotangents (autograd through it
    on one tree and one data vector per lane)."""
    full, x = per_lane_operands(trees, data)
    return (evaluate_trees_plain(full, x, fset),) + evaluate_trees_vjp_plain(full, x, g, fset)


@pytest.mark.parametrize("trig", [False, True], ids=["arith", "trig"])
@pytest.mark.parametrize("n,depth", INTERP_SIZES)
@pytest.mark.parametrize("layout", INTERP_LAYOUTS)
def test_host_build_layouts_bit_exact(host_lib, monkeypatch, layout, n, depth, trig):
    """Each caller's layout (lanes grouped by the tree they share, groups
    that do not divide a warp or span blocks, one tree per lane) at N = 32
    to 256, with and without ``sin``/``cos``: roots, ``dconst`` and
    ``ddata`` bit for bit per lane."""
    fset, trees, data, g = interp_layout_case(layout, n=n, depth=depth, trig=trig)
    with monkeypatch.context() as m:
        patch_host_math(m)
        ref, ref_c, ref_d = plain_per_lane(trees, data, g, fset)
    out, dconst, ddata = host_per_lane(host_lib, trees, data, g, fset)
    assert dconst.shape == ref_c.shape and ddata.shape == ref_d.shape
    assert same_bits(out, ref) and same_bits(dconst, ref_c) and same_bits(ddata, ref_d)
    assert (ref_c != 0).any() and (ref_d != 0).any() and torch.isfinite(ref).float().mean() > 0.5


@pytest.mark.parametrize("members", [1, 16, 31, 33])
def test_host_build_block_edges_bit_exact(host_lib, members):
    """The recompute's layout with groups of 1, 16 (two to a block), 31 and 33
    lanes (groups that straddle blocks of 32 lanes, a last block part full):
    the same bits per lane as the plain version."""
    fset, trees, data, g = interp_layout_case("recompute")
    rng = np.random.default_rng(members)
    k, v = data.shape[0], data.shape[-1]
    data = torch.from_numpy(rng.normal(size=(k, members, 1, v)).astype(np.float32) * 2)
    g = torch.from_numpy(rng.normal(size=(k, members, trees.ops.shape[-2])).astype(np.float32))
    ref, ref_c, ref_d = plain_per_lane(trees, data, g, fset)
    out, dconst, ddata = host_per_lane(host_lib, trees, data, g, fset)
    assert same_bits(out, ref) and same_bits(dconst, ref_c) and same_bits(ddata, ref_d)
    assert (ref_c != 0).any() and (ref_d != 0).any()


@pytest.mark.parametrize("members", DEEP_INTERP_MEMBERS)
@pytest.mark.parametrize("n", DEEP_INTERP_SIZES)
def test_host_build_deep_bit_exact(host_lib, n, members):
    """The instance past 256 rows: N = 300, 512 and 1024 (second operands at
    rows past 255, and at 1024 past 511: the decoded row's whole ``c2``
    field), 16 lanes a tree and one (at 1024 rows a block then runs 16
    lanes): roots, ``dconst`` and ``ddata`` bit for bit per lane."""
    fset, trees, data, g = deep_interp_case(n, members)
    assert int(trees.c2.max()) > (511 if n > 512 else 255)
    ref, ref_c, ref_d = plain_per_lane(trees, data, g, fset)
    out, dconst, ddata = host_per_lane(host_lib, trees, data, g, fset)
    assert same_bits(out, ref) and same_bits(dconst, ref_c) and same_bits(ddata, ref_d)
    assert (ref_c != 0).any() and (ref_d != 0).any() and torch.isfinite(ref).float().mean() > 0.5


def test_host_build_deep_trig_bit_exact(host_lib, monkeypatch):
    fset, trees, data, g = deep_interp_case(512, 16, trig=True)
    with monkeypatch.context() as m:
        patch_host_math(m)
        ref, ref_c, ref_d = plain_per_lane(trees, data, g, fset)
    out, dconst, ddata = host_per_lane(host_lib, trees, data, g, fset)
    assert same_bits(out, ref) and same_bits(dconst, ref_c) and same_bits(ddata, ref_d)


@pytest.fixture
def wide_only(monkeypatch):
    """Every layout through the wide instance (the fixed instances take no
    tree), the layout cache emptied around the test."""
    monkeypatch.setattr(ci, "FIXED_ROWS", 0)
    ci._layouts.clear()
    yield
    ci._layouts.clear()


@pytest.mark.parametrize("trig", [False, True], ids=["arith", "trig"])
@pytest.mark.parametrize("n,depth", INTERP_SIZES[::3])
@pytest.mark.parametrize("layout", INTERP_LAYOUTS)
def test_host_build_wide_layouts_bit_exact(host_lib, monkeypatch, wide_only, layout, n, depth, trig):
    """The wide instance in each caller's layout (lanes grouped by the tree
    they share, groups that do not divide a block or span blocks, one tree
    per lane) at N = 32 and 256, with and without ``sin``/``cos``: roots,
    ``dconst`` and ``ddata`` bit for bit per lane."""
    fset, trees, data, g = interp_layout_case(layout, n=n, depth=depth, trig=trig)
    with monkeypatch.context() as m:
        patch_host_math(m)
        ref = plain_per_lane(trees, data, g, fset)
    got = host_per_lane(host_lib, trees, data, g, fset)
    assert ci._operands(trees, data, fset)[-1].wide
    assert all(same_bits(a, b) for a, b in zip(got, ref))


@pytest.mark.parametrize("members", [1, 16, 31, 33])
def test_host_build_wide_block_edges_bit_exact(host_lib, wide_only, members):
    """The wide instance on the recompute's layout with groups of 1, 16, 31
    and 33 lanes (groups that straddle blocks, a last block part full)."""
    fset, trees, data, g = interp_layout_case("recompute")
    rng = np.random.default_rng(members)
    k, v = data.shape[0], data.shape[-1]
    data = torch.from_numpy(rng.normal(size=(k, members, 1, v)).astype(np.float32) * 2)
    g = torch.from_numpy(rng.normal(size=(k, members, trees.ops.shape[-2])).astype(np.float32))
    ref = plain_per_lane(trees, data, g, fset)
    assert all(same_bits(a, b) for a, b in zip(host_per_lane(host_lib, trees, data, g, fset), ref))


def test_host_build_wide_c2_semantics(host_lib, monkeypatch, wide_only):
    """The wide instance reads row ``c2`` as the plain version does on the
    hand-made trees a postorder stack would evaluate otherwise."""
    fset, trees, data, g = c2_case()
    with monkeypatch.context() as m:
        patch_host_math(m)
        ref = plain_per_lane(trees, data, g, fset)
    assert all(same_bits(a, b) for a, b in zip(host_per_lane(host_lib, trees, data, g, fset), ref))


def wide_reference(n, members, k, nvar=2, monkeypatch=None):
    """:func:`test_torch_kernels.wide_interp_case` and the plain version's
    per-lane roots and cotangents on it."""
    case = wide_interp_case(n, members, k=k, nvar=nvar)
    with monkeypatch.context() as m:
        patch_host_math(m)
        return case, plain_per_lane(*case[1:], case[0])


@pytest.mark.parametrize("n,nvar", [(32, 33), (32, 40), (32, 70), (1025, 40)])
def test_host_build_many_variables_bit_exact(host_lib, monkeypatch, n, nvar):
    """Data of 33, 40 and 70 variables: up to 63 the fixed instance (its
    decoded row's 6-bit slot holds them and the zero column), 70 and past
    1024 rows the wide one (a 30-bit slot, the data read where it lies, the
    cotangents accumulated in the output); the chains' leaves cycle through
    variables. Roots, ``dconst`` and ``ddata`` bit for bit per lane."""
    (fset, trees, data, g), ref = wide_reference(n, 16 if n == 32 else 2, 6 if n == 32 else 3,
                                                 nvar=nvar, monkeypatch=monkeypatch)
    assert ci._operands(trees, data, fset)[-1].wide == (n > ci.FIXED_ROWS or nvar > ci.FIXED_VARS)
    got = host_per_lane(host_lib, trees, data, g, fset)
    assert all(same_bits(a, b) for a, b in zip(got, ref))
    assert (ref[2][..., 32:] != 0).any()  # variables past the old limit read


@pytest.fixture(scope="module")
def many_ops_lib(tmp_path_factory):
    if shutil.which("g++") is None and shutil.which("c++") is None:
        pytest.skip("no host C++ compiler")
    return _build.build_host("interpreter", tmp_path_factory.mktemp("many_ops"),
                             many_operator_set().variant)


def test_host_build_many_operators_bit_exact(many_ops_lib, monkeypatch):
    """A set of 33 operators (the table's 17 and 16 user operators, device
    ids 0-32): the wide instance of the set's user build, in the
    recompute's layout; roots, ``dconst`` and ``ddata`` bit for bit per lane
    with the C library's math on both sides."""
    fset, trees, data, g = many_operator_case()
    assert fset.num_operators == 33 and ci._operands(trees, data, fset)[-1].wide
    user = (trees.ops >= OP_START + 17) & (trees.ops < fset.var_start)
    assert int(user.sum()) > 20
    with monkeypatch.context() as m:
        patch_host_math(m)
        ref = plain_per_lane(trees, data, g, fset)
    got = host_per_lane(many_ops_lib, trees, data, g, fset)
    assert all(same_bits(a, b) for a, b in zip(got, ref))
    assert (ref[1] != 0).any() and torch.isfinite(ref[0]).float().mean() > 0.5


def test_host_build_refuses_past_its_limit(host_lib, monkeypatch):
    """The limit memory sets: past the rows whose tape one block of lanes
    holds in the scratch budget (``MAX_NODES`` at ``SCRATCH_BYTES``), the
    wrapper raises ``NotImplementedError``; at it, the wide instance runs.
    The kernel's own check refuses malformed layout words and launch
    ranges."""
    assert ci.MAX_NODES == ci.SCRATCH_BYTES // (ci.THREADS * 8) == 4_194_304
    monkeypatch.setattr(ci, "SCRATCH_BYTES", 1500 * ci.THREADS * 8)
    ci._layouts.clear()
    fset, trees, data, g = wide_interp_case(1501, 1, k=3)
    with pytest.raises(NotImplementedError, match="1500 rows"):
        ci.run_forward(host_lib.interpret_fwd, trees, data, fset)
    ok = wide_interp_case(1500, 1, k=3)
    status, _ = ci.run_forward(host_lib.interpret_fwd, *ok[1:3], ok[0])
    assert status == 0
    layout = ci._make_layout(ok[1], ok[2], ok[0])
    ci._layouts.clear()
    out = torch.empty(layout.batch)
    scratch = torch.empty(layout.lanes * 1500)
    ptrs = [t.data_ptr() for t in (ok[1].ops, ok[1].c2, ok[1].const, ok[2])]
    fwd = ci._bind(host_lib.interpret_fwd, "interpret_fwd")
    call = lambda lane0=0, count=layout.lanes, buf=scratch.data_ptr(): fwd(
        *ptrs, layout.address, out.data_ptr(), buf, lane0, count, None)
    assert call() == 0
    assert call(buf=None) == 1  # the wide instance without its scratch
    assert call(lane0=1, count=1) == 1  # a launch that is not whole blocks
    layout.words[7] = 0  # the fixed instances: at most 1024 rows
    assert call() == 1
    layout.words[2] = 1024
    layout.words[7] = 1
    layout.words[5] = ci.DEVICE_OPS + 1  # more operators than device op ids
    layout.words[4] = OP_START + ci.DEVICE_OPS + 1
    assert call() == 1


def postorder_roots(trees, data, fset):
    """Root values of ``trees`` by a postorder stack machine (a binary row
    pops its first operand, then its second), in float64 per lane."""
    full, x = per_lane_operands(trees, data)
    ops, const = full.ops.reshape(-1, full.max_nodes), full.const.reshape(-1, full.max_nodes)
    x = x.reshape(-1, x.shape[-1]).double()
    out = []
    for lane in range(ops.shape[0]):
        stack = []
        for op, c in zip(ops[lane].tolist(), const[lane].tolist()):
            if op == EMPTY:
                continue
            if op == CONST or op >= fset.var_start:
                stack.append(c if op == CONST else float(x[lane, op - fset.var_start]))
                continue
            fn, arity = fset.operator_fns[op - 2], fset.arities[op - 2]
            a = torch.tensor(stack.pop() if stack else 0.0, dtype=torch.float64)
            b = torch.tensor(stack.pop() if stack and arity == 2 else 0.0, dtype=torch.float64)
            stack.append(float(fn(a, b)))
        out.append(stack[-1] if stack else 0.0)
    return torch.tensor(out).reshape(full.ops.shape[:-1])


def test_host_build_c2_semantics(host_lib, monkeypatch):
    """Hand-made trees whose second operands are rows a postorder stack
    would not pop: the kernel reads row ``c2`` as the plain version does
    (bit for bit per lane, forward and VJP), not the stack's entry."""
    fset, trees, data, g = c2_case()
    with monkeypatch.context() as m:
        patch_host_math(m)
        ref, ref_c, ref_d = plain_per_lane(trees, data, g, fset)
    out, dconst, ddata = host_per_lane(host_lib, trees, data, g, fset)
    assert same_bits(out, ref) and same_bits(dconst, ref_c) and same_bits(ddata, ref_d)
    assert (~torch.isfinite(ref)).any() and torch.isfinite(ref).any()
    stack = postorder_roots(trees, data, fset).float()  # (candidate, lane, tree)
    differs = ~torch.isclose(stack, ref, rtol=1e-3, atol=1e-3, equal_nan=True)
    assert bool(differs.any(dim=1).all()), "every tree must tell c2 from a stack"


def test_layout_cache(host_lib):
    """A cached layout gives the bits of a cold call; a view with other
    strides, a strided last dimension, a c2 laid out unlike ops, or another
    shape gets its own layout; a bad cotangent is refused on a hit; the
    cache stays bounded."""
    fset, trees, data, g = interp_layout_case("recompute")
    ci._layouts.clear()
    cold = host_per_lane(host_lib, trees, data, g, fset)
    assert len(ci._layouts) == 1
    hit = host_per_lane(host_lib, trees, data, g, fset)
    assert len(ci._layouts) == 1
    assert all(same_bits(a, b) for a, b in zip(cold, hit))
    other = data.transpose(0, 1).contiguous().transpose(0, 1)  # same shape, other strides
    assert other.shape == data.shape and other.stride() != data.stride()
    strided = torch.stack([data, -data], -1)[..., 0]  # last dimension strided: copied
    for d in (other, strided):
        assert all(same_bits(a, b) for a, b in zip(cold, host_per_lane(host_lib, trees, d, g, fset)))
    assert len(ci._layouts) == 3
    unshared = interp_layout_case("unshared")[1]
    c2_view = unshared.c2.transpose(0, 1).contiguous().transpose(0, 1)
    full, x = per_lane_operands(trees, data)
    got = host_per_lane(host_lib, full._replace(c2=c2_view), x, g, fset)
    assert all(same_bits(a, b) for a, b in zip(got, host_per_lane(host_lib, full, x, g, fset)))
    part = trees.map(lambda a: a[:7])
    got = host_per_lane(host_lib, part, data[:7, :3], g[:7, :3], fset)
    ref = plain_per_lane(part, data[:7, :3], g[:7, :3], fset)
    assert all(same_bits(a, b) for a, b in zip(got, ref))
    with pytest.raises(ValueError):  # a cotangent of another shape, on a hit
        ci.run_backward(host_lib.interpret_bwd, trees, data, g[:, :1], fset)
    with pytest.raises(ValueError):  # ... of another dtype
        ci.run_backward(host_lib.interpret_bwd, trees, data, g.double(), fset)
    for k in range(1, 25):
        for b in range(1, 4):
            ci.run_forward(host_lib.interpret_fwd, trees.map(lambda a: a[:k]), data[:k, :b], fset)
    assert len(ci._layouts) == ci.MAX_LAYOUTS


def test_host_build_broadcast_sums(host_lib):
    """The recompute's layout: trees ``(K, 1, m, N)`` meet states
    ``(K, B, 1, d)``; dconst sums over B, ddata over the m trees. Constants
    away from 0, so no sum cancels terms far larger than itself."""
    fset, pop, data, g = lanes_case(near_zero=False)
    trees, states = pop.map(lambda a: a[:, None]), data[:, :, :1]
    status, out = ci.run_forward(host_lib.interpret_fwd, trees, states, fset)
    assert status == 0 and same_bits(out, evaluate_trees_plain(trees, states, fset))

    status, per_c, per_d = ci.run_backward(host_lib.interpret_bwd, trees, states, g, fset)
    assert status == 0
    ref_c, ref_d = evaluate_trees_vjp_plain(trees, states, g, fset)
    got_c, got_d = per_c.sum_to_size(ref_c.shape), per_d.sum_to_size(ref_d.shape)
    # dconst: one term per lane, summed over B in another order: within 1e-6
    # of the sum of the terms' magnitudes
    scale = per_c.abs().sum_to_size(ref_c.shape)
    assert torch.equal(torch.isfinite(got_c), torch.isfinite(ref_c))
    fin = torch.isfinite(ref_c)
    assert bool(((got_c - ref_c).abs()[fin] <= 1e-6 * scale[fin]).all())
    # ddata: autograd adds the m trees' terms row by row, the kernel sums each
    # tree's rows first; rows of one lane cancel (terms up to ~1e3 here), so
    # the bound is relative to the largest entry
    fin = torch.isfinite(ref_d)
    assert torch.equal(torch.isfinite(got_d), fin) and fin.float().mean() > 0.9
    atol = 1e-6 * float(ref_d[fin].abs().max())
    torch.testing.assert_close(got_d[fin], ref_d[fin], rtol=1e-5, atol=atol)


def test_host_build_refuses_bad_arguments(host_lib):
    fset, pop, data, g = lanes_case(k=4)
    user_set = build_function_set(INTERP_OPS + [NO_DEVICE_OP], [["x0", "x1"]], [2])
    with pytest.raises(NotImplementedError):  # an operator without a device id
        ci.run_forward(host_lib.interpret_fwd, pop[:, None], data, user_set)
    # the dispatcher takes the plain path on CPU tensors
    assert same_bits(evaluate_trees(pop[:, None], data, user_set),
                     evaluate_trees_plain(pop[:, None], data, user_set))
    with pytest.raises(ValueError):  # wrong cotangent shape
        ci.run_backward(host_lib.interpret_bwd, pop[:, None], data, g[:, :1], fset)
    with pytest.raises(ValueError):  # the CUDA wrappers take CUDA tensors only
        ci.evaluate_trees_cuda(pop[:, None], data, fset)


def check_function_against_jax(n, depth, broadcast):
    """``EvaluateTrees`` (CPU: plain forward, plain VJP) against
    ``evaluate_trees_pallas`` in interpret mode, as the JAX package's own
    interpret tests run it; 6 candidates of ``max_nodes=n``."""
    jf = jax_function_set(JAX_ARITH, [["x0", "x1"]], [2])
    pop = jax_sampler(jf, depth, n)(jr.PRNGKey(5), 6)
    rng = np.random.default_rng(6)
    data = rng.normal(size=(6, 3, 1, 2) if broadcast else (6, 2, 2)).astype(np.float32)
    jpop = jax.tree_util.tree_map(lambda a: a[:, None], pop) if broadcast else pop
    fset = function_set_from_jax(jf)
    tpop = trees_from_numpy(*[np.asarray(a) for a in jpop])

    with pltpu.force_tpu_interpret_mode():
        want = np.asarray(jax_pi.evaluate_trees_pallas(jpop, jnp.asarray(data), jf))
    got = EvaluateTrees.apply(*tpop, torch.from_numpy(data), fset)
    np.testing.assert_allclose(got.numpy(), want, rtol=1e-6, atol=1e-6)

    def loss_kernel(const, d):
        out = jax_pi.evaluate_trees_pallas(jpop._replace(const=const), d, jf)
        return jnp.sum(jnp.where(jnp.isfinite(out), out, 0.0))

    with pltpu.force_tpu_interpret_mode():
        want_c, want_d = jax.grad(loss_kernel, argnums=(0, 1))(jpop.const, jnp.asarray(data))
    const = tpop.const.clone().requires_grad_(True)
    x = torch.from_numpy(data).requires_grad_(True)
    out = EvaluateTrees.apply(tpop.ops, tpop.c1, tpop.c2, const, x, fset)
    got_c, got_d = torch.autograd.grad(torch.where(torch.isfinite(out), out, 0.0).sum(), (const, x))
    assert got_c.shape == tpop.const.shape and got_d.shape == x.shape
    np.testing.assert_allclose(got_c.numpy(), np.asarray(want_c), rtol=1e-5, atol=1e-5)
    np.testing.assert_allclose(got_d.numpy(), np.asarray(want_d), rtol=1e-5, atol=1e-5)
    assert np.abs(np.asarray(want_c)).max() > 0


@pytest.mark.parametrize("broadcast", [False, True])
def test_evaluate_trees_function_matches_jax_kernels(broadcast):
    """N = 16, as the JAX package's interpret tests."""
    check_function_against_jax(16, 3, broadcast)


def test_evaluate_trees_function_matches_jax_kernels_n128():
    """N = 128 (grow depth 6), in the recompute's broadcast layout."""
    check_function_against_jax(128, 6, True)


def test_dispatcher_cpu_and_plain_versions_bypass_it(monkeypatch):
    fset, pop, data, _ = lanes_case(k=8)
    trees, states = pop.map(lambda a: a[:, None]), data[:, :, :1]
    assert same_bits(evaluate_trees(trees, states, fset), evaluate_trees_plain(trees, states, fset))

    def refuse(*args, **kwargs):
        raise AssertionError("a plain version went through the dispatcher")

    monkeypatch.setattr(interpreter, "evaluate_trees", refuse)
    monkeypatch.setattr(cuda_rollout, "evaluate_trees", refuse)
    ts = torch.arange(0.0, 0.6, 0.2)
    ys = torch.zeros((3, ts.shape[0], 2))
    mse, alive = cuda_rollout.sr_fitness_plain(pop, data[0, :, 0], ts, ys, fset)
    assert mse.shape == alive.shape == (8, 3)
    cfg, args = reproduce_case(lanes=16)
    children = reproduce_lanes_plain(*args, cfg)
    assert children[0].shape == args[0].shape
