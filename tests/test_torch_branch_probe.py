"""PyTorch port: the branch probe (TPU kernel #10, ``tools/mosaic_branch_probe.py``)
and its hand-written counterpart ``csrc/branch_probe.cu``.

* The plain version against the TPU probe kernel run in interpret mode on a
  2-tile grid, for each of the four TPU modes: rtol 1e-4 (XLA:CPU contracts
  the body's multiply and add into FMAs, the port does not, and the ulps add
  up over as many as 4,096 dependent steps to 2e-5), which tells the
  iteration counts apart (one iteration moves a value by 6.6% or more); and
  the same threshold.
* The host build of ``branch_probe.cu`` against the plain version, every
  mode including ``lane``: bit-equal.
* The iterations each mode runs: 64, 9, 12, 12, and 9 or 64 per element;
  on tiles past the threshold from the start, 64, 1, 4, 4 and 1.
"""
import ctypes
import importlib.util
import shutil
from pathlib import Path

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from multitreegp_tpu_torch import _build
from multitreegp_tpu_torch.tools import branch_probe as bp

TPU_MODES = ("always", "when", "dynfori", "dynval")


@pytest.fixture(scope="module")
def tpu_probe():
    path = Path(__file__).resolve().parents[1] / "tools" / "mosaic_branch_probe.py"
    spec = importlib.util.spec_from_file_location("mosaic_branch_probe", path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def test_constants_match_tpu_probe(tpu_probe):
    assert (bp.TOTAL, bp.FLIP, bp.CH, bp.REPS) == (tpu_probe.TOTAL, tpu_probe.FLIP, tpu_probe.CH,
                                                    tpu_probe.REPS)
    assert bp.THRESH == tpu_probe.THRESH


@pytest.mark.parametrize("mode", TPU_MODES)
def test_plain_matches_tpu_kernel_interpret(tpu_probe, mode):
    from jax.experimental import pallas as pl
    from jax.experimental.pallas import tpu as pltpu

    reps = 2
    call = pl.pallas_call(
        tpu_probe.make_kernel(mode), grid=(reps,),
        in_specs=[pl.BlockSpec((1, 8, 128), lambda i: (i, 0, 0), memory_space=pltpu.VMEM)],
        out_specs=pl.BlockSpec((1, 8, 128), lambda i: (i, 0, 0), memory_space=pltpu.VMEM),
        out_shape=jax.ShapeDtypeStruct((reps, 8, 128), jnp.float32),
        scratch_shapes=[pltpu.VMEM((8, 128), jnp.float32), pltpu.SMEM((1,), jnp.int32)],
        interpret=True,
    )
    x = bp.probe_input(mode, reps)
    want = np.asarray(jax.jit(call)(x.numpy()))
    got = bp.probe_plain(x, mode)
    np.testing.assert_allclose(got.numpy(), want, rtol=1e-4, atol=0)
    iters = int(bp.element_iterations(x, mode)[0, 0, 0])
    assert float(got[0, 0, 0]) == float(bp._values_after(bp.TOTAL)[iters])


@pytest.fixture(scope="module")
def host_lib(tmp_path_factory):
    if shutil.which("g++") is None and shutil.which("c++") is None:
        pytest.skip("no host C++ compiler")
    return _build.build_host("branch_probe", tmp_path_factory.mktemp("host_probe"))


def probe_host(lib, x: torch.Tensor, mode: str) -> np.ndarray:
    a = np.ascontiguousarray(x.numpy())
    out = np.empty_like(a)
    fn = lib.branch_probe_host
    fn.argtypes = [ctypes.c_int, ctypes.c_void_p, ctypes.c_void_p, ctypes.c_int, ctypes.c_float,
                   ctypes.c_float]
    assert fn(bp.MODES.index(mode), a.ctypes.data, out.ctypes.data, a.shape[0], bp.THRESH,
              bp.LANE_THRESH) == 0
    return out


@pytest.mark.parametrize("mode", bp.MODES)
def test_host_build_matches_plain(host_lib, mode):
    x = bp.probe_input(mode, 3)
    np.testing.assert_array_equal(probe_host(host_lib, x, mode), bp.probe(x, mode).numpy())


@pytest.mark.parametrize("mode", bp.MODES)
def test_host_build_matches_plain_early(host_lib, mode):
    """Tiles past the threshold from the start: the flag drops after the
    first round, so ``when`` and ``lane`` run one iteration and the chunked
    modes one chunk; the host build equals the plain version."""
    x = bp.early_input(3)
    got = probe_host(host_lib, x, mode)
    np.testing.assert_array_equal(got, bp.probe_plain(x, mode).numpy())
    runs = {"always": bp.TOTAL, "when": 1, "lane": 1}.get(mode, bp.CH)
    want = x
    for _ in range(runs):
        want = bp._body(want)
    np.testing.assert_array_equal(got, want.numpy())


def test_iterations_per_mode():
    counts = {m: bp.element_iterations(bp.probe_input(m, 1), m) for m in bp.MODES}
    assert [int(counts[m].max()) for m in TPU_MODES] == [64, 9, 12, 12]
    lane = counts["lane"].reshape(-1)
    assert int(lane[0]) == 64 and int(lane[1]) == 9 and int((lane == 64).sum()) == 1024 // 32
    vals = bp._values_after(bp.TOTAL)
    x = bp.probe_plain(bp.probe_input("lane", 1), "lane").reshape(-1)
    assert float(x[1]) == float(vals[9]) and float(x[0]) < bp.LANE_THRESH
    assert bp.operations(bp.probe_input("always", bp.REPS), "always") == 256 * 1024 * 64 * 64 * 2
    with pytest.raises(ValueError):
        bp.probe_plain(bp.probe_input("always", 1), "sometimes")
