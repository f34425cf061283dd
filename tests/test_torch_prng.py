"""PyTorch port: JAX's threefry random numbers in torch (``core/prng.py``)
against ``jax.random`` (JAX 0.9, ``jax_threefry_partitionable=True``).

What holds, and why:

* ``fold_in``, ``split`` and ``random_bits`` are bit-equal: integer hashes.
  ``uniform`` is bit-equal where XLA:CPU leaves its one float expression
  uncontracted (on ``[0, 1)`` and inside ``normal``), else within 1 ulp.
* ``normal`` is within 3 ulp of JAX's, with about 99% of draws bit-equal:
  the port evaluates XLA's float32 ``erf_inv`` polynomial with its Horner
  steps fused as XLA:CPU fuses them, but on PyTorch's ``log1p``, which rounds
  up to 2 ulp away from XLA's on some inputs; ``erf_inv`` is within 2 ulp,
  and the product with ``sqrt(2)`` can round one more apart.
"""
import jax
import jax.numpy as jnp
import jax.random as jr
import numpy as np
import pytest
import torch

from multitreegp_tpu.core.pallas_policy import stage_times as jax_stage_times
from multitreegp_tpu.models.environments.base import bitcast_time as jax_bitcast
from multitreegp_tpu_torch.core import prng

KEYS = jr.split(jr.PRNGKey(42), 48)
TKEYS = torch.tensor(np.asarray(KEYS).astype(np.int64))
LO = float(np.nextafter(np.float32(-1.0), np.float32(0.0)))


def ulps(a, b) -> np.ndarray:
    a = np.asarray(a, np.float32).view(np.int32).astype(np.int64)
    return np.abs(a - np.asarray(b, np.float32).view(np.int32).astype(np.int64))


def times() -> np.ndarray:
    """0.0, -0.0, negatives, a tiny value and the stage-time grid of the
    control examples (0.2 grid, rk4 x 4 substeps)."""
    grid = np.asarray(jax_stage_times(jnp.arange(0.0, 3.0, 0.2), 4, "rk4")).ravel()
    return np.concatenate([np.float32([0.0, -0.0, -1.5, -1e-30, 3.25e-3, 1e30]), grid])


def test_keys_are_jax_layout():
    key = jr.PRNGKey(7)
    assert np.array_equal(np.asarray(key).astype(np.int64), [0, 7])


def test_fold_in_bit_equal_over_times():
    ts = times()
    bits = jax.lax.bitcast_convert_type(jnp.asarray(ts), jnp.int32)
    want = jax.jit(jax.vmap(lambda b: jax.vmap(lambda k: jr.fold_in(k, b))(KEYS)))(bits)
    data = prng.bitcast_time(torch.from_numpy(ts))
    assert torch.equal(data, torch.from_numpy(np.asarray(jax_bitcast(ts)).astype(np.int64) & prng.MASK))
    got = prng.fold_in(TKEYS, data[:, None])  # (len(ts), B, 2)
    assert np.array_equal(np.asarray(want).astype(np.int64), got.numpy())
    # a Python float and a scalar tensor are the same time
    assert torch.equal(prng.bitcast_time(0.35), prng.bitcast_time(torch.tensor(0.35)))


@pytest.mark.parametrize("num", [2, 5])
def test_split_bit_equal(num):
    want = jax.vmap(lambda k: jr.split(k, num))(KEYS)
    assert np.array_equal(np.asarray(want).astype(np.int64), prng.split(TKEYS, num).numpy())
    # nested: split of split, as generate_sr_data's key tree
    want2 = jr.split(jr.split(jr.PRNGKey(0))[1], 16)
    got2 = prng.split(prng.split(torch.tensor([0, 0]))[1], 16)
    assert np.array_equal(np.asarray(want2).astype(np.int64), got2.numpy())


@pytest.mark.parametrize("n", [1, 7, 64])
def test_random_bits_bit_equal(n):
    want = jax.vmap(lambda k: jr.bits(k, (n,), jnp.uint32))(KEYS)
    assert np.array_equal(np.asarray(want).astype(np.int64), prng.random_bits(TKEYS, n).numpy())


@pytest.mark.parametrize("lo,hi,exact", [(0.0, 1.0, True), (LO, 1.0, True), (-2.5, 4.0, False)])
def test_uniform_bit_equal(lo, hi, exact):
    """Bit-equal on ``[0, 1)`` and on the normal's interval; on ``[-2.5,
    4)`` XLA:CPU contracts ``floats * 6.5 - 2.5`` into a fused multiply-add
    (in ``normal`` it does not), and the port stays within one rounding of
    the product (an ulp of 6.5)."""
    want = np.asarray(jax.jit(jax.vmap(lambda k: jr.uniform(k, (500,), minval=lo, maxval=hi)))(KEYS))
    got = prng.uniform(TKEYS, 500, lo, hi)
    assert got.dtype == torch.float32
    if exact:
        assert np.array_equal(want, got.numpy())
    else:
        assert np.abs(want - got.numpy()).max() <= np.spacing(np.float32(hi - lo))
    assert float(got.min()) >= lo and float(got.max()) < hi


def test_normal_within_3_ulp():
    want = np.asarray(jax.jit(jax.vmap(lambda k: jr.normal(k, (1000,))))(KEYS))
    got = prng.normal(TKEYS, 1000).numpy()
    d = ulps(want, got)
    assert d.max() <= 3, d.max()
    assert (d == 0).mean() >= 0.97, (d == 0).mean()


def test_normal_at_folded_times_within_3_ulp():
    """The observation-noise draw: ``normal(fold_in(key, bitcast(t)), (n,))``
    at every time, vectorised over keys and times."""
    ts = times()
    want = jax.jit(jax.vmap(lambda t: jax.vmap(
        lambda k: jr.normal(jr.fold_in(k, jax_bitcast(t)), (4,)))(KEYS)))(ts)
    got = prng.normal(prng.fold_in(TKEYS, prng.bitcast_time(torch.from_numpy(ts))[:, None]), 4)
    assert got.shape == (len(ts), 48, 4)
    assert ulps(want, got.numpy()).max() <= 3


def test_erf_inv_polynomial():
    """XLA's float32 ``erf_inv`` within 2 ulp on the normal's inputs, with
    both tails and the ends of the interval."""
    u = prng.uniform(TKEYS, 400, LO, 1.0).reshape(-1)
    u = torch.cat([u, torch.tensor([LO, -0.999999, 0.999999, 0.0, 1e-20, -1.0, 1.0])])
    want = np.asarray(jax.jit(jax.lax.erf_inv)(u.numpy()))
    got = prng.erf_inv(u).numpy()
    fin = np.isfinite(want)
    np.testing.assert_array_equal(np.isfinite(got), fin)
    np.testing.assert_array_equal(np.sign(got[~fin]), np.sign(want[~fin]))
    assert ulps(want[fin], got[fin]).max() <= 2
    # not torch.erfinv: another function, which differs by more
    assert not torch.equal(prng.erf_inv(u[:-2]), torch.erfinv(u[:-2]))
