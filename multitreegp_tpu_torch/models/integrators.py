"""Runge-Kutta integration with per-lane divergence containment.

Port of ``multitreegp_tpu/models/integrators.py``:

* :func:`integrate`: euler, heun and rk4 with ``substeps`` steps per save
  interval, ``dt = (ts[t+1] - ts[t]) / substeps`` per interval from the
  float32 grid, as the JAX scan does;
* :func:`integrate_sde`: the same steps plus an Euler-Maruyama kick whose
  Brownian increment is drawn, as JAX draws it, from ``fold_in(key,
  bitcast_f32(t))`` of the trajectory's key (``core/prng.py``);
* :func:`integrate_adaptive`: an embedded pair (Bogacki-Shampine 3(2) or
  Dormand-Prince 5(4)) with per-lane ``(t, dt)`` and an I step controller;
* :func:`linear_interp`: the time-varying parameters' interpolation.

Both keep the per-lane alive freeze: a lane whose state is non-finite or
reaches ``|x| >= DIVERGENCE_BOUND`` stops updating (its state stays frozen)
and is reported dead. Expression order follows the JAX functions exactly,
so float32 results agree with them bit for bit where both avoid FMA
contraction.
"""
from __future__ import annotations

from typing import Callable, Optional, Tuple

import numpy as np
import torch
from torch.utils.weak import WeakIdKeyDictionary

from ..core import prng

DIVERGENCE_BOUND = 1e8

Drift = Callable[[float, torch.Tensor], torch.Tensor]


def finite(x: torch.Tensor) -> torch.Tensor:
    """Lane liveness of a state ``(..., d)``: every component finite and
    below the divergence bound."""
    return (torch.isfinite(x) & (x.abs() < DIVERGENCE_BOUND)).all(dim=-1)


# Step sizes are float32 values held in Python floats, and every scalar
# derived from them (dt/2, dt/6, the substep dt) is rounded in float32 on the
# host. PyTorch's CUDA division by a Python scalar multiplies by its
# reciprocal, which would round differently from the CUDA kernel's and JAX's
# true division.
def _f32(x) -> float:
    return float(np.float32(x))


def _f32_add(a: float, b: float) -> float:
    """``a + b`` in float32: the solver times the drift sees, as JAX's."""
    return _f32(np.float32(a) + np.float32(b))


def substep_time(t0, i, dt):
    """``t0 + i * dt`` rounded once to float32 (a float, or numpy arrays):
    XLA contracts the JAX integrators' substep time into a fused
    multiply-add, and the noise drawn at that time depends on every bit. The
    product of a small integer and a float32 is exact in double, so only the
    sum rounds (twice, which differs from one rounding on about one input in
    2**29)."""
    f64 = lambda v: np.asarray(v, np.float64)
    return (f64(t0) + f64(i) * f64(np.float32(dt))).astype(np.float32)


def euler_step(drift: Drift, t: float, x, dt: float):
    return x + dt * drift(t, x)


def heun_step(drift: Drift, t: float, x, dt: float):
    k1 = drift(t, x)
    k2 = drift(_f32_add(t, dt), x + dt * k1)
    return x + _f32(np.float32(0.5) * np.float32(dt)) * (k1 + k2)


def rk4_step(drift: Drift, t: float, x, dt: float):
    half = _f32(np.float32(0.5) * np.float32(dt))
    k1 = drift(t, x)
    k2 = drift(_f32_add(t, half), x + half * k1)
    k3 = drift(_f32_add(t, half), x + half * k2)
    k4 = drift(_f32_add(t, dt), x + dt * k3)
    return x + _f32(np.float32(dt) / np.float32(6.0)) * (k1 + 2 * k2 + 2 * k3 + k4)


STEPPERS = {"euler": euler_step, "heun": heun_step, "rk4": rk4_step}


# kick(i, t, x, dt) -> the increment added to substep i's update
Kick = Callable[[int, float, torch.Tensor, float], torch.Tensor]


def step_interval(
    stepper, drift: Drift, t0: float, t1: float, x: torch.Tensor, alive: torch.Tensor,
    substeps: int,
    cond_alive: Optional[Callable[[float, torch.Tensor], torch.Tensor]] = None,
    kick: Optional[Kick] = None,
) -> Tuple[torch.Tensor, torch.Tensor]:
    """Advance ``(x, alive)`` over one save interval ``[t0, t1]`` (float32
    values as Python floats): ``dt = (t1 - t0) / substeps`` in float32,
    substep ``i`` at :func:`substep_time`; a ``kick`` is added to each
    substep's update before the liveness test."""
    dt = _f32((np.float32(t1) - np.float32(t0)) / np.float32(substeps))
    for i in range(substeps):
        t = float(substep_time(t0, i, dt))
        x_new = stepper(drift, t, x, dt)
        if kick is not None:
            x_new = x_new + kick(i, t, x, dt)
        ok = finite(x_new)
        if cond_alive is not None:
            ok = ok & cond_alive(_f32_add(t, dt), x_new)
        alive = alive & ok
        x = torch.where(alive[..., None], x_new, x)
    return x, alive


def integrate(
    drift: Drift,
    x0: torch.Tensor,
    ts: torch.Tensor,
    method: str = "rk4",
    substeps: int = 1,
    cond_alive: Optional[Callable[[float, torch.Tensor], torch.Tensor]] = None,
) -> Tuple[torch.Tensor, torch.Tensor]:
    """Integrate ``dx/dt = drift(t, x)`` over the save grid ``ts``.

    Args:
        drift: batched drift; ``x`` has shape ``(..., d)``, returns the same.
        x0: initial state ``(..., d)``.
        ts: float32 save points ``(T,)``; the output includes ``x0``.
        method: "euler" | "heun" | "rk4".
        substeps: RK steps between consecutive save points.
        cond_alive: optional extra liveness predicate ``(t, x) -> bool (...)``;
            ``t`` (like the drift's) is a Python float.

    Returns ``xs (T, ..., d)`` (frozen after death) and ``alive (T, ...)``.
    """
    if method not in STEPPERS:
        raise NotImplementedError(
            f"integration method {method!r}: the fixed-step methods are {sorted(STEPPERS)}; "
            "adaptive stepping is integrate_adaptive"
        )
    return _scan(STEPPERS[method], drift, x0, ts, substeps, cond_alive)


# save grids -> (their version, their times as Python floats)
_grid_times = WeakIdKeyDictionary()


def host_times(ts: torch.Tensor) -> list:
    """``ts.tolist()``, read from the device once per grid tensor (again only
    after it is written): the integrators' Python step times, so that an
    integration over a grid already read makes no host read (a CUDA graph can
    capture it)."""
    hit = _grid_times.get(ts)
    if hit is None or hit[0] != ts._version:
        hit = _grid_times[ts] = (ts._version, ts.tolist())
    return hit[1]


def _scan(stepper, drift: Drift, x0: torch.Tensor, ts: torch.Tensor, substeps: int, cond_alive,
          kick: Optional[Kick] = None) -> Tuple[torch.Tensor, torch.Tensor]:
    times = host_times(ts)
    alive = finite(x0)
    if cond_alive is not None:
        alive = alive & cond_alive(times[0], x0)
    xs, alives = [x0], [alive]
    x = x0
    for t in range(len(times) - 1):
        x, alive = step_interval(stepper, drift, times[t], times[t + 1], x, alive, substeps, cond_alive,
                                 kick)
        xs.append(x)
        alives.append(alive)
    return torch.stack(xs), torch.stack(alives)


def integrate_sde(
    drift: Drift,
    diffusion: Callable[[float, torch.Tensor], torch.Tensor],
    x0: torch.Tensor,
    ts: torch.Tensor,
    noise_keys: torch.Tensor,
    method: str = "euler",
    substeps: int = 1,
    cond_alive: Optional[Callable[[float, torch.Tensor], torch.Tensor]] = None,
) -> Tuple[torch.Tensor, torch.Tensor]:
    """Integrate ``dx = drift dt + diffusion dW`` (Euler-Maruyama, or the
    drift by heun between the kicks): JAX ``integrate_sde``.

    Each substep at time ``t = t0 + i*dt`` (float32) adds ``g @ dW`` to the
    stepper's update, ``g = diffusion(t, x)`` at the substep's starting state
    and ``dW = normal(fold_in(key, bitcast_f32(t)), (d,)) * sqrt(|dt|)`` per
    trajectory key (``sqrt`` correctly rounded in float32); then the lane
    freezes where the state is non-finite, reaches the divergence bound or
    fails ``cond_alive(t + dt, x)``.

    Args:
        drift: batched drift ``(t, x (..., d)) -> (..., d)``.
        diffusion: ``(t, x) -> (..., d)`` (diagonal, elementwise) or ``(...,
            d, d)`` (a matrix applied to ``dW``).
        x0: ``(..., B, d)``; its last batch axis indexes the trajectories,
            one per key.
        ts: save grid ``(T,)``.
        noise_keys: ``(B, 2)`` JAX keys (the data tuple's process-noise keys).
        method / substeps / cond_alive: as in :func:`integrate`.

    Returns ``(xs (T, ..., d), alive (T, ...))``.
    """
    if method not in STEPPERS:
        raise NotImplementedError(f"SDE drift method {method!r}: the steppers are {sorted(STEPPERS)}")
    d = x0.shape[-1]

    def kick(i, t, x, dt):
        g = diffusion(t, x)
        keys = prng.fold_in(noise_keys, prng.bitcast_time(t, noise_keys.device))
        w = prng.normal(keys, d, _f32(np.sqrt(np.abs(np.float32(dt)))))
        if g.dim() == x.dim() + 1:  # a matrix per lane, applied to dW
            return (g * w[..., None, :]).sum(dim=-1)
        return g * w

    return _scan(STEPPERS[method], drift, x0, ts, substeps, cond_alive, kick)


# Embedded pairs for adaptive stepping, as float32 values of the JAX
# package's Python doubles (JAX's weak typing rounds e.g. 19372/6561 once, to
# float32; so do PyTorch's scalar operands and the CUDA kernels' constants).
# No FSAL here, as in the JAX function: lanes step independently.
BS_A = tuple(tuple(_f32(a) for a in row) for row in ((0.5,), (0.0, 0.75), (2 / 9, 1 / 3, 4 / 9)))
BS_B_LOW = tuple(_f32(b) for b in (7 / 24, 0.25, 1 / 3, 0.125))
DP_C = tuple(_f32(c) for c in (0.2, 0.3, 0.8, 8 / 9, 1.0, 1.0))
DP_A = tuple(tuple(_f32(a) for a in row) for row in (
    (0.2,),
    (3 / 40, 9 / 40),
    (44 / 45, -56 / 15, 32 / 9),
    (19372 / 6561, -25360 / 2187, 64448 / 6561, -212 / 729),
    (9017 / 3168, -355 / 33, 46732 / 5247, 49 / 176, -5103 / 18656),
    (35 / 384, 0.0, 500 / 1113, 125 / 192, -2187 / 6784, 11 / 84),
))
DP_B5 = tuple(_f32(b) for b in (35 / 384, 0.0, 500 / 1113, 125 / 192, -2187 / 6784, 11 / 84, 0.0))
DP_B4 = tuple(_f32(b) for b in (5179 / 57600, 0.0, 7571 / 16695, 393 / 640, -92097 / 339200,
                                187 / 2100, 1 / 40))
# the I controller's exponent -1/order of the embedded estimate
ERROR_EXPONENT = {"bosh3": _f32(-1.0 / 3.0), "dopri5": _f32(-0.2)}


def adaptive_step_budget(substeps: int, floor: int = 32) -> int:
    """An evaluator's ``substeps`` as the adaptive path's per-interval step
    budget: ``substeps`` when raised above the fixed-step default of 4,
    else ``floor``."""
    return substeps if substeps > 4 else floor


def tableau_sum(coefs, ks):
    """``sum(a * k for a, k in zip(coefs, ks))`` as Python's ``sum``: from 0,
    left to right, keeping ``0.0 * k`` terms (``0 * inf`` is NaN)."""
    s = torch.zeros_like(ks[0])
    for a, k in zip(coefs, ks):
        s = s + a * k
    return s


def _f32_expr(fn) -> float:
    """A scalar expression evaluated in float32 on the host."""
    with np.errstate(all="ignore"):
        return float(np.float32(fn(np.float32)))


def integrate_adaptive(
    drift: Callable[[torch.Tensor, torch.Tensor], torch.Tensor],
    x0: torch.Tensor,
    ts: torch.Tensor,
    rtol: float = 1e-4,
    atol: float = 1e-6,
    max_steps_per_interval: int = 32,
    cond_alive: Optional[Callable[[torch.Tensor, torch.Tensor], torch.Tensor]] = None,
    safety: float = 0.9,
    method: str = "bosh3",
) -> Tuple[torch.Tensor, torch.Tensor]:
    """Adaptive integration on a fixed save grid (JAX ``integrate_adaptive``).

    Every lane carries its own ``(t, dt)``; ``dt`` carries across save
    points, clamped at each interval's entry to ``[span*1e-3, span]``. Each
    of at most ``max_steps_per_interval`` iterations per interval steps the
    active lanes (alive and ``t < t1 - 1e-12``) with ``bosh3`` or ``dopri5``
    (no FSAL), accepts where the state stays finite and ``err <= 1``, and
    resizes by ``clip(safety * err**e, 0.2, 5)``. A lane dies on NaN at the
    minimum step (``dt_c <= span*1.5e-3``) or when it has not reached the
    save point after the budget. The drift's ``t`` is a per-lane tensor.
    Differentiable: nothing in the controller is detached, as JAX
    differentiates through it.

    Returns ``(xs (T, ..., d), alive (T, ...))`` like :func:`integrate`.
    """
    if method not in ERROR_EXPONENT:
        raise ValueError(f"unknown adaptive method {method!r}")
    expo = ERROR_EXPONENT[method]
    rtol, atol, safety = _f32(rtol), _f32(atol), _f32(safety)

    def rk_step(t, x, dt):
        dte = dt[..., None]
        if method == "bosh3":
            a, b = BS_A, BS_B_LOW
            k1 = drift(t, x)
            k2 = drift(t + 0.5 * dt, x + 0.5 * dte * k1)
            k3 = drift(t + 0.75 * dt, x + 0.75 * dte * k2)
            x_hi = x + dte * (a[2][0] * k1 + a[2][1] * k2 + a[2][2] * k3)
            k4 = drift(t + dt, x_hi)
            x_lo = x + dte * (b[0] * k1 + b[1] * k2 + b[2] * k3 + b[3] * k4)
        else:
            ks = [drift(t, x)]
            for ci, ai in zip(DP_C, DP_A):
                ks.append(drift(t + ci * dt, x + dte * tableau_sum(ai, ks)))
            x_hi = x + dte * tableau_sum(DP_B5, ks)
            x_lo = x + dte * tableau_sum(DP_B4, ks)
        scale = atol + rtol * torch.maximum(x.abs(), x_hi.abs())
        return x_hi, torch.sqrt(torch.square((x_hi - x_lo) / scale).mean(dim=-1))

    times = ts.tolist()
    alive = finite(x0)
    if cond_alive is not None:
        alive = alive & cond_alive(ts[0].expand(alive.shape), x0)
    dt0 = _f32_expr(lambda f: (f(times[1]) - f(times[0])) / f(4.0)) if len(times) > 1 else 1.0
    dt = torch.full(alive.shape, dt0, dtype=x0.dtype, device=x0.device)
    xs, alives = [x0], [alive]
    x = x0
    for i in range(len(times) - 1):
        t0, t1 = times[i], times[i + 1]
        span = _f32_expr(lambda f: f(t1) - f(t0))
        dt_lo = _f32_expr(lambda f: f(span) * f(1e-3))
        dt_dead = _f32_expr(lambda f: f(span) * f(1.5e-3))
        inside = _f32_expr(lambda f: f(t1) - f(1e-12))
        reached = _f32_expr(lambda f: f(t1) - f(1e-9) * max(abs(f(t1)), f(1.0)))
        t = torch.full(alive.shape, t0, dtype=x0.dtype, device=x0.device)
        dt = torch.clamp(dt, dt_lo, span)
        for _ in range(max_steps_per_interval):
            active = alive & (t < inside)
            dt_c = torch.minimum(dt, t1 - t)
            x_new, err = rk_step(t, x, dt_c)
            ok = finite(x_new) & torch.isfinite(err)
            accept = active & ok & (err <= 1.0)
            if cond_alive is not None:
                accept = accept & cond_alive(t + dt_c, x_new)
            x = torch.where(accept[..., None], x_new, x)
            t = torch.where(accept, t + dt_c, t)
            grow = torch.clamp(safety * torch.pow(err, expo), 0.2, 5.0)
            fallback = torch.where(ok, 5.0, 0.2).to(err.dtype)
            factor = torch.where(torch.isfinite(err) & (err > 0.0), grow, fallback)
            dt = torch.where(active, torch.clamp(dt_c * factor, dt_lo, span), dt)
            alive = alive & (ok | ~active | (dt_c > dt_dead))
        alive = alive & (t >= reached)
        xs.append(x)
        alives.append(alive)
    return torch.stack(xs), torch.stack(alives)


def linear_interp(ts: torch.Tensor, values: torch.Tensor, t) -> torch.Tensor:
    """Piecewise-linear interpolation of ``values (T, ...)`` sampled at
    ``ts (T,)``, at ``t`` (a float, or a tensor of per-lane times that
    broadcasts against ``values.shape[1:]``); JAX ``linear_interp``: ``t``
    clipped to ``[ts[0], ts[-1]]``, the interval from ``searchsorted(side=
    "right")``, ``w = (t - t0) / (t1 - t0)`` (0 on an empty interval) and
    ``v0 + w * (v1 - v0)``."""
    t = torch.as_tensor(t, dtype=ts.dtype, device=ts.device)
    t = torch.minimum(torch.maximum(t, ts[0]), ts[-1])
    idx = (torch.searchsorted(ts, t.reshape(-1), right=True).reshape(t.shape) - 1)
    idx = idx.clamp(0, ts.shape[0] - 2)
    t0, t1 = ts[idx], ts[idx + 1]
    w = torch.where(t1 > t0, (t - t0) / (t1 - t0), torch.zeros_like(t))
    shape = torch.broadcast_shapes(values.shape[1:], t.shape)
    rows = values.movedim(0, -1).expand(*shape, values.shape[0])
    i = idx.expand(shape)[..., None]
    v0, v1 = rows.gather(-1, i)[..., 0], rows.gather(-1, i + 1)[..., 0]
    return v0 + w.expand(shape) * (v1 - v0)
