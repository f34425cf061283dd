"""Fixed-grid Runge-Kutta integration with per-lane divergence containment.

Port of the fixed-step half of ``multitreegp_tpu/models/integrators.py``:
euler, heun and rk4 with ``substeps`` steps per save interval, and the
per-lane alive freeze: a lane whose state is non-finite or reaches
``|x| >= DIVERGENCE_BOUND`` stops updating (its state stays frozen) and is
reported dead. Expression order follows the JAX steppers exactly, so float32
results agree with them bit for bit where both avoid FMA contraction. The
step size is taken per interval from the float32 grid, ``dt = (ts[t+1] -
ts[t]) / substeps``, as the JAX scan does.
"""
from __future__ import annotations

from typing import Callable, Optional, Tuple

import numpy as np
import torch

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


def euler_step(drift: Drift, t: float, x, dt: float):
    return x + dt * drift(t, x)


def heun_step(drift: Drift, t: float, x, dt: float):
    k1 = drift(t, x)
    k2 = drift(t + dt, x + dt * k1)
    return x + _f32(np.float32(0.5) * np.float32(dt)) * (k1 + k2)


def rk4_step(drift: Drift, t: float, x, dt: float):
    half = _f32(np.float32(0.5) * np.float32(dt))
    k1 = drift(t, x)
    k2 = drift(t + half, x + half * k1)
    k3 = drift(t + half, x + half * k2)
    k4 = drift(t + dt, x + dt * k3)
    return x + _f32(np.float32(dt) / np.float32(6.0)) * (k1 + 2 * k2 + 2 * k3 + k4)


STEPPERS = {"euler": euler_step, "heun": heun_step, "rk4": rk4_step}


def step_interval(
    stepper, drift: Drift, t0: float, t1: float, x: torch.Tensor, alive: torch.Tensor,
    substeps: int,
    cond_alive: Optional[Callable[[float, torch.Tensor], torch.Tensor]] = None,
) -> Tuple[torch.Tensor, torch.Tensor]:
    """Advance ``(x, alive)`` over one save interval ``[t0, t1]`` (float32
    values as Python floats): ``dt = (t1 - t0) / substeps`` in float32."""
    dt = _f32((np.float32(t1) - np.float32(t0)) / np.float32(substeps))
    for i in range(substeps):
        t = t0 + i * dt
        x_new = stepper(drift, t, x, dt)
        ok = finite(x_new)
        if cond_alive is not None:
            ok = ok & cond_alive(t + dt, x_new)
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
            f"integration method {method!r}: the port has {sorted(STEPPERS)}; "
            "adaptive stepping is ROADMAP Queue 1 #14"
        )
    stepper = STEPPERS[method]
    times = ts.tolist()
    alive = finite(x0)
    if cond_alive is not None:
        alive = alive & cond_alive(times[0], x0)
    xs, alives = [x0], [alive]
    x = x0
    for t in range(len(times) - 1):
        x, alive = step_interval(stepper, drift, times[t], times[t + 1], x, alive, substeps, cond_alive)
        xs.append(x)
        alives.append(alive)
    return torch.stack(xs), torch.stack(alives)
