"""JAX's threefry random numbers in PyTorch.

A copy of the semantics of ``jax._src.prng`` and ``jax._src.random`` (JAX
0.9.0, with ``jax_threefry_partitionable=True``, its default) for raw
``threefry2x32`` keys, so that the port draws the very noise the JAX package
draws from the same keys: observation noise and Brownian increments are
``normal(fold_in(key, bitcast_f32(t)), (n,))`` there, a deterministic
function of the key and the solver time.

Keys are int64 tensors of shape ``(..., 2)`` holding uint32 values, the
layout of ``jax.random.key_data`` and of the data tuples' noise keys.
uint32 arithmetic is int64 arithmetic masked with ``0xFFFFFFFF``. Every
function is vectorised over keys (and data) by broadcasting, with no Python
loop over lanes, on the keys' device.

Bits are exact on every device, and so are uniforms where XLA:CPU leaves
``floats * (hi - lo) + lo`` uncontracted (it does so in ``normal`` and on
``[0, 1)``; where it contracts it, they differ by an ulp). ``normal`` is ``sqrt(2) *
erf_inv(u)`` with XLA's float32 ``erf_inv`` polynomial (read from the
compiled HLO of ``jax.lax.erf_inv``; ``torch.erfinv`` is another function),
its Horner steps fused as XLA:CPU fuses them, on top of PyTorch's ``log1p``
and ``sqrt``: XLA's ``log1p`` differs from PyTorch's by up to 2 ulp on some
inputs, so ``erf_inv`` may differ from XLA's by up to 2 ulp and a normal
from JAX's by up to 3 (about 1% do).
"""
from __future__ import annotations

import numpy as np
import torch

MASK = 0xFFFFFFFF
_ROTATIONS = ((13, 15, 26, 6), (17, 29, 16, 24))
_PARITY = 0x1BD11BDA

# XLA's ErfInv32: (coefficient for w < 5, coefficient for w >= 5), highest
# order first, evaluated by Horner's rule in w - 2.5 or sqrt(w) - 3
_ERF_INV = (
    (2.81022636e-08, -0.000200214257), (3.43273939e-07, 0.000100950558),
    (-3.5233877e-06, 0.00134934322), (-4.39150654e-06, -0.00367342844),
    (0.00021858087, 0.00573950773), (-0.00125372503, -0.0076224613),
    (-0.00417768164, 0.00943887047), (0.246640727, 1.00167406),
    (1.50140941, 2.83297682),
)
_SQRT2 = float(np.float32(np.sqrt(2)))
_NORMAL_LO = float(np.nextafter(np.float32(-1.0), np.float32(0.0)))


def _rotl(v: torch.Tensor, r: int) -> torch.Tensor:
    return ((v << r) & MASK) | (v >> (32 - r))


def threefry2x32(k1, k2, x1, x2):
    """The Threefry-2x32 hash (20 rounds) of the counts ``(x1, x2)`` under
    the key ``(k1, k2)``: uint32 values in broadcastable int64 tensors;
    returns the two output words."""
    ks = (k1, k2, k1 ^ k2 ^ _PARITY)
    x0, x1 = (x1 + ks[0]) & MASK, (x2 + ks[1]) & MASK
    for i in range(5):
        for r in _ROTATIONS[i % 2]:
            x0 = (x0 + x1) & MASK
            x1 = x0 ^ _rotl(x1, r)
        x0 = (x0 + ks[(i + 1) % 3]) & MASK
        x1 = (x1 + ks[(i + 2) % 3] + (i + 1)) & MASK
    return x0, x1


def fold_in(keys: torch.Tensor, data) -> torch.Tensor:
    """``jax.random.fold_in`` of keys ``(..., 2)`` and integer data
    broadcasting against ``keys.shape[:-1]`` (taken mod 2**32): the hash of
    the counts ``(0, data)``. Returns keys of the broadcast shape."""
    data = torch.as_tensor(data, dtype=torch.int64, device=keys.device) & MASK
    return torch.stack(threefry2x32(keys[..., 0], keys[..., 1], torch.zeros_like(data), data),
                       dim=-1)


def _iota_hash(keys: torch.Tensor, n: int):
    count = torch.arange(n, dtype=torch.int64, device=keys.device)
    return threefry2x32(keys[..., :1], keys[..., 1:], torch.zeros_like(count), count)


def split(keys: torch.Tensor, num: int = 2) -> torch.Tensor:
    """``jax.random.split``: keys ``(..., 2)`` -> ``(..., num, 2)``; key ``i``
    is the hash of the counts ``(0, i)``, which is ``fold_in(key, i)``."""
    return torch.stack(_iota_hash(keys, num), dim=-1)


def random_bits(keys: torch.Tensor, n: int) -> torch.Tensor:
    """32 random bits per value, ``(..., n)`` from keys ``(..., 2)``: the two
    hash words of the counts ``(0, i)``, xor-ed."""
    bits1, bits2 = _iota_hash(keys, n)
    return bits1 ^ bits2


def uniform(keys: torch.Tensor, n: int, lo: float = 0.0, hi: float = 1.0) -> torch.Tensor:
    """``jax.random.uniform`` float32 draws ``(..., n)`` in ``[lo, hi)``: the
    top 23 bits as the mantissa of a float in ``[1, 2)``, minus 1, scaled by
    ``hi - lo`` (in float32), plus ``lo``, and at least ``lo``."""
    f = np.float32
    mant = ((random_bits(keys, n) >> 9) | 0x3F800000).to(torch.int32)
    floats = mant.view(torch.float32) - 1.0
    lo32, scale = float(f(lo)), float(f(f(hi) - f(lo)))
    return torch.clamp_min(floats * scale + lo32, lo32)


def _fma(a: torch.Tensor, b: torch.Tensor, c: torch.Tensor) -> torch.Tensor:
    """``a * b + c`` rounded once to float32, as a fused multiply-add: the
    product of two floats is exact in double, so only the sum rounds (twice,
    which differs from one rounding on about one input in 2**29)."""
    return (a.double() * b.double() + c.double()).float()


def erf_inv(x: torch.Tensor) -> torch.Tensor:
    """XLA's float32 inverse error function (its ``ErfInv32`` polynomial),
    expression for expression: ``w = -log1p(x * -x)``, Horner's rule in
    ``w - 2.5`` (``w < 5``) or ``sqrt(w) - 3`` with each step a fused
    multiply-add (XLA:CPU contracts them), times ``x``; ``x * inf`` at ``|x|
    == 1``."""
    w = -torch.log1p(x * -x)
    small = w < 5.0
    ww = torch.where(small, w - 2.5, torch.sqrt(w) - 3.0)
    coef = lambda ab: torch.where(small, ab[0], ab[1])
    p = coef(_ERF_INV[0])
    for ab in _ERF_INV[1:]:
        p = _fma(p, ww, coef(ab))
    return torch.where(x.abs() == 1.0, x * float("inf"), p * x)


def normal(keys: torch.Tensor, n: int, scale=1.0) -> torch.Tensor:
    """``jax.random.normal`` float32 draws ``(..., n)`` times ``scale`` (a
    float, or float32 values broadcasting against the draws): ``erf_inv(u) *
    (sqrt(2) * scale)`` with ``u`` uniform in ``[nextafter(-1, 0), 1)``. XLA
    folds a scale of the draws into the ``sqrt(2)`` factor, so a Brownian
    increment ``normal * sqrt(dt)`` rounds so in the JAX package; with
    ``scale = 1`` it is ``jax.random.normal`` itself."""
    factor = _SQRT2 * scale if torch.is_tensor(scale) else float(np.float32(_SQRT2 * scale))
    return erf_inv(uniform(keys, n, _NORMAL_LO, 1.0)) * factor


def bitcast_time(t, device=None) -> torch.Tensor:
    """The float32 bits of a time (a Python float or a tensor of times) as
    uint32 values in int64: the data JAX folds into a key
    (``bitcast_convert_type(float32(t), int32)``)."""
    t = torch.as_tensor(t, dtype=torch.float32, device=device).contiguous()
    return t.view(torch.int32).to(torch.int64) & MASK
