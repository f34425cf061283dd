"""PyTorch port: the interpreter kernels' wide instance past 1024 rows.

``csrc/interpreter.cu`` runs trees of more than 1024 rows (and data of more
than 63 variables, function sets of more than 32 operators) in its wide
instance: the lane's values and tape in a scratch buffer ``[row][lane]``
that the wrapper allocates, the lanes split into launches within the
scratch budget (``core/cuda_interpreter.py`` ``SCRATCH_BYTES``), the rows
staged a chunk at a time. Its host build (``g++``, ``-ffp-contract=off``),
driven through the same wrapper code as on the card, must equal the plain
version bit for bit per lane (roots, ``dconst``, ``ddata``; NaN where the
plain version has NaN) at N = 1025, 2048 and 4096 on chains of N - 1 rows
(the deepest stack, and the zigzag whose second operands reach row N - 3,
past 1023) among grown trees, 16 lanes a tree and one; with ``sin``/``cos``
rows; and when a small budget splits the lanes into several launches. The
plain version's VJP takes time in the square of the rows it sweeps (~80 s
for a chain of 4095 rows), so the largest cases hold few lanes. The wide
instance in every caller's layout, at 40 and 70 variables and with 33
operators, and the limit memory sets, are in
``test_torch_interpreter_kernel.py``; the same checks on the card in
``test_torch_kernels.py`` (marker ``cuda``).
"""
import shutil

import pytest
import torch

from multitreegp_tpu_torch import _build
from multitreegp_tpu_torch.core import cuda_interpreter as ci
from multitreegp_tpu_torch.core.trees import EMPTY
from test_torch_interpreter_kernel import plain_per_lane
from test_torch_kernels import patch_host_math, same_bits, wide_interp_case

torch.set_num_threads(1)


@pytest.fixture(scope="module")
def host_lib(tmp_path_factory):
    if shutil.which("g++") is None and shutil.which("c++") is None:
        pytest.skip("no host C++ compiler")
    return _build.build_host("interpreter", tmp_path_factory.mktemp("wide_kernel"))


# the wide instance's cases: (N, members a tree, candidates); the plain
# version's VJP sweeps every row below the chains of N - 1 rows (~80 s at
# N = 4096), so the largest cases hold few lanes
WIDE_CASES = ((1025, 16, 6), (2048, 16, 3), (2048, 1, 3), (4096, 1, 3))
_plain_refs = {}


def wide_reference(n, members, k, trig=False, monkeypatch=None):
    """:func:`test_torch_kernels.wide_interp_case` and the plain version's
    per-lane roots and cotangents on it (kept: each is computed once)."""
    case = wide_interp_case(n, members, k=k, trig=trig)
    key = (n, members, k, trig)
    if key not in _plain_refs:
        with monkeypatch.context() as m:
            patch_host_math(m)
            _plain_refs[key] = plain_per_lane(*case[1:], case[0])
    return case, _plain_refs[key]


def wide_launches(lib, trees, data, g, fset):
    """The host build's per-lane outputs and the launches each wrapper made."""
    ops, c2, cst, x, layout = ci._operands(trees, data, fset)
    status, out, fwd = ci._forward(lib.interpret_fwd, ops, c2, cst, x, layout, None)
    assert status == 0 and layout.wide
    status, dconst, ddata, bwd = ci._backward(lib.interpret_bwd, ops, c2, cst, x, layout,
                                             trees.max_nodes, g, None)
    assert status == 0
    return (out, dconst, ddata), (fwd, bwd)


@pytest.mark.parametrize("n,members,k", WIDE_CASES)
def test_host_build_wide_bit_exact(host_lib, monkeypatch, n, members, k):
    """The wide instance past 1024 rows: N = 1025, 2048 and 4096, chains of
    N - 1 rows (N - 2 at odd N: the deepest stack, and the zigzag whose
    second operands reach row N - 3, past 1023) among grown trees, 16 lanes
    a tree and one: roots, ``dconst`` and ``ddata`` bit for bit per lane, in
    one launch."""
    (fset, trees, data, g), ref = wide_reference(n, members, k, monkeypatch=monkeypatch)
    assert int(trees.c2.max()) == n - 3 and int((trees.ops != EMPTY).sum(-1).max()) >= n - 2
    got, launches = wide_launches(host_lib, trees, data, g, fset)
    assert launches == (1, 1)
    assert all(same_bits(a, b) for a, b in zip(got, ref))
    assert (ref[1] != 0).any() and (ref[2] != 0).any()


def test_host_build_wide_launches_split(host_lib, monkeypatch):
    """A scratch budget of a few blocks' tapes splits the lanes into
    launches of whole blocks (the last one short): the same bits as one
    launch, and each launch counted."""
    (fset, trees, data, g), ref = wide_reference(1025, 16, 6, monkeypatch=monkeypatch)
    lanes = g.numel()
    monkeypatch.setattr(ci, "SCRATCH_BYTES", 1025 * 8 * 64)  # 64 lanes a VJP launch, 128 forward
    ci._layouts.clear()
    got, launches = wide_launches(host_lib, trees, data, g, fset)
    ci._layouts.clear()
    assert lanes == 192 and launches == (2, 3)  # forward 128 + 64 lanes, VJP 3 x 64
    assert all(same_bits(a, b) for a, b in zip(got, ref))


def test_host_build_wide_trig_bit_exact(host_lib, monkeypatch):
    """``sin``/``cos`` rows in the wide instance (its instance with the unary
    rows' code), N = 1025."""
    (fset, trees, data, g), ref = wide_reference(1025, 4, 3, trig=True, monkeypatch=monkeypatch)
    got, _ = wide_launches(host_lib, trees, data, g, fset)
    assert all(same_bits(a, b) for a, b in zip(got, ref))
