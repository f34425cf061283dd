"""PyTorch port: the interpreter kernels (forward and VJP) and the dispatcher.

* host build (runs here): ``csrc/interpreter.cu`` compiled for the host with
  ``g++`` (``-ffp-contract=off``), driven through the same Python wrapper code
  as on the card (``run_forward`` / ``run_backward``). Per lane it must equal
  the plain version bit for bit: forward roots against
  ``evaluate_trees_plain``, and backward ``dconst`` / ``ddata`` against
  ``torch.autograd.grad`` of it (same float32 expressions, same accumulation
  order; NaN where the plain version has NaN). Summed back over broadcast
  dimensions the order of the sums differs, so there each entry must lie
  within 1e-6 of the sum of the magnitudes of its per-lane terms.
* ``EvaluateTrees`` on CPU tensors and its VJP against the JAX package's
  ``evaluate_trees_pallas`` run in interpret mode: forward rtol 1e-6
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
from test_torch_kernels import (
    INTERP_OPS, NO_DEVICE_OP, TRIG, lanes_case, patch_host_math, reproduce_case, same_bits,
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
    with pytest.raises(NotImplementedError):  # an operator without a device id
        ci.run_forward(host_lib.interpret_fwd, pop[:, None],
                       data, build_function_set(INTERP_OPS + [NO_DEVICE_OP], [["x0", "x1"]], [2]))
    with pytest.raises(ValueError):  # wrong cotangent shape
        ci.run_backward(host_lib.interpret_bwd, pop[:, None], data, g[:, :1], fset)
    with pytest.raises(ValueError):  # the CUDA wrappers take CUDA tensors only
        ci.evaluate_trees_cuda(pop[:, None], data, fset)


@pytest.mark.parametrize("broadcast", [False, True])
def test_evaluate_trees_function_matches_jax_kernels(broadcast):
    """``EvaluateTrees`` (CPU: plain forward, plain VJP) against
    ``evaluate_trees_pallas`` in interpret mode, as the JAX package's own
    interpret tests run it; N = 16, 6 candidates."""
    jf = jax_function_set(JAX_ARITH, [["x0", "x1"]], [2])
    pop = jax_sampler(jf, 3, 16)(jr.PRNGKey(5), 6)
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
