"""Adaptive SR fitness per lane: the Dopri5/Bosh3 + step-control kernels and
their plain versions.

Counterpart of ``multitreegp_tpu/core/pallas_rollout.py``'s adaptive paths.
Every lane (candidate x trajectory) integrates ``dx = trees(x)`` with an
embedded Runge-Kutta pair (``bosh3`` or ``dopri5``), carries its own ``(t,
dt)`` and the first-same-as-last stage ``k1``, and accumulates the squared
error against the ground truth at the save points. Two step budgets:

* global (:func:`sr_fitness_adaptive_global`, JAX
  ``rollout_sr_fitness_adaptive_global_pallas``): ``budget`` attempted steps
  for the whole solve, as diffrax's ``max_steps``; lanes cross save points
  out of step with each other (a per-lane save index). Kernel
  ``adaptive_global_kernel`` of ``csrc/sr_adaptive.cu``.
* per interval (:func:`sr_fitness_adaptive` and :func:`adaptive_solver_stats`,
  JAX ``rollout_sr_fitness_adaptive_pallas`` and ``adaptive_solver_stats``):
  ``max_steps`` per save interval. Kernel ``adaptive_interval_kernel``.

Each returns ``mse (P, B)``, ``alive (P, B)`` and, where asked,
``lane_steps (P, B)``, the attempted steps per lane. CUDA tensors launch the
kernel (a fixed instance, or past them, ``cuda_rollout.takes_fixed``, the
wide one: ``*_wide_cuda``), or raise for an operator outside
``DEVICE_OPS``, ``N > 256`` or a candidate's program past a block's shared
memory (``cuda_rollout.lanes_refusal``); CPU tensors run the plain version
(the same computation in plain PyTorch, in the kernel's float32 expression
order). Nothing falls back.

:class:`SRFitnessAdaptive` is the counterpart of the two ``custom_vjp``s:
the forward is the dispatcher; the backward recomputes the unfused MSE with
``integrate_adaptive`` (the dispatching interpreter as its drift: kernels
#8/#9 on CUDA) at a per-interval budget and differentiates that.
"""
from __future__ import annotations

import ctypes
from typing import NamedTuple, Tuple

import torch

from .. import _build
from ..models.integrators import (
    BS_A, BS_B_LOW, DP_A, DP_B4, DP_B5, ERROR_EXPONENT, _f32, _f32_expr, finite,
    integrate_adaptive, tableau_sum,
)
from .cuda_rollout import check_lanes, kernel_operands, takes_fixed, wide_operands
from .interpreter import evaluate_trees, evaluate_trees_plain
from .registry import FunctionSet
from .trees import TreeTensors

METHODS = {"bosh3": 0, "dopri5": 1}  # csrc/sr_adaptive.cu AdaptiveMethod
GLOBAL, INTERVAL = 0, 1  # csrc/sr_adaptive.cu Budget
ADAPTIVE_VECTORS = 10  # csrc/sr_adaptive.cu kAdaptiveVectors: the wide lane's vectors
# The plain versions look every this many iterations whether any lane is
# still active, and leave their loop if none is (the rest would be no-ops).
CHECK_EVERY = 8
# the controller's constants as float32 values, as JAX rounds them
CROSS = _f32(1e-12)  # t >= t1 - 1e-12: the lane has reached the save point
DT_MIN = _f32(1e-3)  # dt >= span * 1e-3
DT_DEAD = _f32(1.5e-3)  # NaN at dt_c <= span * 1.5e-3 kills the lane


def _check_method(method: str) -> None:
    if method not in METHODS:
        raise ValueError(f"unknown adaptive method {method!r}: {sorted(METHODS)}")


def _clip(v, lo, hi):
    """``jnp.clip`` with tensor bounds: NaN propagates."""
    return torch.minimum(torch.maximum(v, lo), hi)


def _sq_err(x, y):
    """``sum_q (x_q - y_q)^2`` left to right, as the kernel sums it."""
    dl = x - y
    e = dl[..., 0] * dl[..., 0]
    for q in range(1, x.shape[-1]):
        e = e + dl[..., q] * dl[..., q]
    return e


def _rk_step(drift, method, x, k1, dt, rtol, atol):
    """One embedded step from ``x (P, B, d)`` with the FSAL carry ``k1`` and
    per-lane ``dt (P, B)``: ``(x_hi, err_norm, k_last)``, in the kernel's
    expression order (``err_norm = sqrt(acc * (1/d))`` with ``acc`` summed
    component by component)."""
    dte = dt[..., None]
    if method == "bosh3":
        a, bl = BS_A[2], BS_B_LOW
        k2 = drift(x + (0.5 * dte) * k1)
        k3 = drift(x + (0.75 * dte) * k2)
        x_hi = x + dte * ((a[0] * k1 + a[1] * k2) + a[2] * k3)
        k_last = drift(x_hi)
        x_lo = x + dte * (((bl[0] * k1 + bl[1] * k2) + bl[2] * k3) + bl[3] * k_last)
    else:
        ks = [k1]
        for row in DP_A:
            ks.append(drift(x + dte * tableau_sum(row, ks)))
        x_hi = x + dte * tableau_sum(DP_B5, ks)
        x_lo = x + dte * tableau_sum(DP_B4, ks)
        k_last = ks[6]
    acc = torch.zeros_like(dt)
    for q in range(x.shape[-1]):
        scale = atol + rtol * torch.maximum(x[..., q].abs(), x_hi[..., q].abs())
        r = (x_hi[..., q] - x_lo[..., q]) / scale
        acc = acc + r * r
    return x_hi, torch.sqrt(acc * _f32(1.0 / x.shape[-1])), k_last


def _step_factor(err, ok, safety, expo):
    """The I controller: ``clip(safety * err**e, 0.2, 5)`` where ``err`` is
    finite and positive, else 5 (a finite step) or 0.2."""
    grow = torch.clamp(safety * torch.pow(err, expo), 0.2, 5.0)
    fallback = torch.where(ok, 5.0, 0.2).to(err.dtype)
    return torch.where(torch.isfinite(err) & (err > 0.0), grow, fallback)


class _Lanes:
    """What both plain versions share: the drift, the lanes' initial state,
    the error sum at ``ts[0]`` and the first drift (the FSAL carry)."""

    def __init__(self, trees, x0s, ts, ys, fset, method, rtol, atol, safety):
        _check_method(method)
        p = trees.ops.shape[0]
        b, d = x0s.shape
        batched = trees.map(lambda a: a[:, None])  # (P, 1, d, N) broadcasts over B
        self.drift = lambda x: evaluate_trees_plain(batched, x[:, :, None, :], fset)
        self.method, self.expo = method, ERROR_EXPONENT[method]
        self.rtol, self.atol, self.safety = _f32(rtol), _f32(atol), _f32(safety)
        self.times = ts.tolist()
        self.yt = ys.transpose(0, 1)  # (T, B, d)
        self.x = x0s[None].expand(p, b, d)
        self.alive = finite(self.x)
        self.err = _sq_err(self.x, self.yt[0])
        self.steps = torch.zeros((p, b), dtype=torch.int32, device=x0s.device)
        if len(self.times) > 1:
            self.k1 = self.drift(self.x)
            dt0 = _f32_expr(lambda f: (f(self.times[1]) - f(self.times[0])) / f(4.0))
            self.dt = torch.full((p, b), dt0, dtype=torch.float32, device=x0s.device)

    def attempt(self, active, t, dt_c):
        """One attempted step of size ``dt_c`` on the active lanes: moves
        ``x`` and the FSAL ``k1`` where it is accepted and counts it; returns
        ``(accept, t after the step, the controller's factor, ok)``."""
        x_hi, err, k_last = _rk_step(self.drift, self.method, self.x, self.k1, dt_c,
                                     self.rtol, self.atol)
        ok = finite(x_hi) & torch.isfinite(err)
        accept = active & ok & (err <= 1.0)
        self.x = torch.where(accept[..., None], x_hi, self.x)
        self.k1 = torch.where(accept[..., None], k_last, self.k1)
        self.steps += active.int()
        factor = _step_factor(err, ok, self.safety, self.expo)
        return accept, torch.where(accept, t + dt_c, t), factor, ok


def sr_fitness_adaptive_global_plain(
    trees: TreeTensors, x0s: torch.Tensor, ts: torch.Tensor, ys: torch.Tensor,
    fset: FunctionSet, rtol: float = 1e-4, atol: float = 1e-6, budget: int = 500,
    method: str = "dopri5", safety: float = 0.9,
) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """Plain version of the global-budget kernel (TPU kernel
    ``_make_adaptive_global_kernel``): ``(mse, alive, lane_steps)``, each
    ``(P, B)``. One loop over the budget; a lane's save index advances when
    its ``t`` reaches ``ts[idx+1] - 1e-12``, where ``t`` snaps to that save
    time, the step is clamped to the new interval's span and the squared
    error at the save is added. A lane that has not reached the last save
    when the budget ends is dead.

    trees ``(P, d, N)``; x0s ``(B, d)``; ts ``(T,)``; ys ``(B, T, d)``.
    """
    ln = _Lanes(trees, x0s, ts, ys, fset, method, rtol, atol, safety)
    last = ts.shape[0] - 1
    idx = torch.zeros_like(ln.steps, dtype=torch.long)
    if last > 0:
        t = torch.full_like(ln.dt, ln.times[0])
        lane_b = torch.arange(x0s.shape[0], device=x0s.device)
        for s in range(budget):
            active = ln.alive & (idx < last)
            if s % CHECK_EVERY == 0 and not bool(active.any()):
                break
            idx0 = idx.clamp(max=last - 1)  # the current interval
            t0l, t1l = ts[idx0], ts[idx0 + 1]
            span = t1l - t0l
            dt_c = torch.minimum(ln.dt, t1l - t)
            accept, t_new, factor, ok = ln.attempt(active, t, dt_c)
            crossed = accept & (t_new >= t1l - CROSS)
            t = torch.where(crossed, t1l, t_new)
            dt_n = torch.where(active, _clip(dt_c * factor, span * DT_MIN, span), ln.dt)
            idx_n = idx + crossed.long()
            n_t0 = torch.where(crossed, t1l, t0l)
            n_span = ts[idx_n.clamp(max=last - 1) + 1] - n_t0
            ln.dt = torch.where(crossed & (idx_n < last),
                                _clip(dt_n, n_span * DT_MIN, n_span), dt_n)
            ln.alive = ln.alive & (ok | ~active | (dt_c > span * DT_DEAD))
            e = _sq_err(ln.x, ln.yt[idx_n.clamp(max=last), lane_b])
            ln.err = torch.where(crossed, ln.err + e, ln.err)
            idx = idx_n
    return ln.err / ts.shape[0], ln.alive & (idx >= last), ln.steps


def sr_fitness_adaptive_interval_plain(
    trees: TreeTensors, x0s: torch.Tensor, ts: torch.Tensor, ys: torch.Tensor,
    fset: FunctionSet, rtol: float = 1e-4, atol: float = 1e-6, max_steps: int = 32,
    method: str = "bosh3", safety: float = 0.9,
) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """Plain version of the per-interval kernel (TPU kernel
    ``_make_adaptive_fitness_kernel``): ``(mse, alive, lane_steps)``, each
    ``(P, B)``. At most ``max_steps`` attempts per save interval; ``t``
    restarts at the interval's start and the carried ``dt`` is clamped to its
    span; a lane that has not reached the save point by then is dead. The
    squared error is added at every save point, for dead (frozen) lanes too."""
    ln = _Lanes(trees, x0s, ts, ys, fset, method, rtol, atol, safety)
    times = ln.times
    for i in range(len(times) - 1):
        t0, t1 = times[i], times[i + 1]
        span = _f32_expr(lambda f: f(t1) - f(t0))
        dt_lo = _f32_expr(lambda f: f(span) * f(DT_MIN))
        dt_dead = _f32_expr(lambda f: f(span) * f(DT_DEAD))
        inside = _f32_expr(lambda f: f(t1) - f(CROSS))
        reached = _f32_expr(lambda f: f(t1) - f(1e-9) * max(abs(f(t1)), f(1.0)))
        t = torch.full_like(ln.dt, t0)
        ln.dt = torch.clamp(ln.dt, dt_lo, span)
        for s in range(max_steps):
            active = ln.alive & (t < inside)
            if s % CHECK_EVERY == 0 and not bool(active.any()):
                break
            dt_c = torch.minimum(ln.dt, t1 - t)
            _, t, factor, ok = ln.attempt(active, t, dt_c)
            ln.dt = torch.where(active, torch.clamp(dt_c * factor, dt_lo, span), ln.dt)
            ln.alive = ln.alive & (ok | ~active | (dt_c > dt_dead))
        ln.alive = ln.alive & (t >= reached)
        ln.err = ln.err + _sq_err(ln.x, ln.yt[i + 1])
    return ln.err / ts.shape[0], ln.alive, ln.steps


def _adaptive_cuda(kind, counter, wide, trees, x0s, ts, ys, fset, rtol, atol, budget, method,
                   safety):
    """Launch ``kind``'s kernel of ``csrc/sr_adaptive.cu`` (the wide instance
    with ``wide``), adding one to ``counter.launches`` a launch."""
    _check_method(method)
    if budget < 0:
        raise ValueError(f"step budget {budget} < 0")
    check_lanes(trees, x0s, ts, fset, ys)
    named = (("x0s", x0s), ("ts", ts), ("ys", ys))
    if wide:
        (ops, cst, x0c, tsc, ysc), devop, cpb, launches, scratch = wide_operands(
            trees, fset, ADAPTIVE_VECTORS, *named)
    else:
        (ops, cst, x0c, tsc, ysc), devop, cpb = kernel_operands(trees, fset, *named)
    dev = ops.device
    p, m, n = ops.shape
    b, d = x0s.shape
    t_steps = ts.shape[0]
    err = torch.empty((p, b), dtype=torch.float32, device=dev)
    alive = torch.empty((p, b), dtype=torch.bool, device=dev)
    steps = torch.empty((p, b), dtype=torch.int32, device=dev)

    args = (kind, ops.data_ptr(), cst.data_ptr(), devop.data_ptr(), x0c.data_ptr(), tsc.data_ptr(),
            ysc.data_ptr(), err.data_ptr(), alive.data_ptr(), steps.data_ptr(),
            p, d, n, b, t_steps, fset.var_start, fset.has_unary, METHODS[method], budget,
            _f32(rtol), _f32(atol), _f32(safety))
    types = ([ctypes.c_int] + [ctypes.c_void_p] * 9 + [ctypes.c_int] * 9 + [ctypes.c_float] * 3)
    if wide:
        lib = _build.load("sr_adaptive", _build.widened(fset.variant))
        fn = lib.sr_adaptive_wide_launch
        fn.argtypes = types + [ctypes.c_void_p] + [ctypes.c_int] * 3 + [ctypes.c_void_p]
        fn.restype = ctypes.c_int
        stream = torch.cuda.current_stream(dev).cuda_stream
        for c0, count in launches:
            status = fn(*args, scratch.data_ptr(), c0, count, cpb, stream)
            _build.check(lib, status, "sr_adaptive wide kernel launch")
            counter.launches += 1
    else:
        lib = _build.load("sr_adaptive", fset.variant)
        fn = lib.sr_adaptive_launch
        fn.argtypes = types + [ctypes.c_int, ctypes.c_void_p]
        fn.restype = ctypes.c_int
        stream = torch.cuda.current_stream(dev).cuda_stream
        _build.check(lib, fn(*args, cpb, stream), "sr_adaptive kernel launch")
        counter.launches += 1
    return err / t_steps, alive, steps


def _fixed(x0s, fset) -> bool:
    b, d = x0s.shape
    return takes_fixed(d, b, fset.num_variables, fset.max_device_op)


def sr_fitness_adaptive_global_cuda(
    trees: TreeTensors, x0s: torch.Tensor, ts: torch.Tensor, ys: torch.Tensor,
    fset: FunctionSet, rtol: float = 1e-4, atol: float = 1e-6, budget: int = 500,
    method: str = "dopri5", safety: float = 0.9,
) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """Launch ``adaptive_global_kernel`` (past the fixed instances
    :func:`sr_fitness_adaptive_global_wide_cuda`); ``(mse, alive,
    lane_steps)``."""
    if not _fixed(x0s, fset):
        return sr_fitness_adaptive_global_wide_cuda(trees, x0s, ts, ys, fset, rtol, atol, budget,
                                                    method, safety)
    return _adaptive_cuda(GLOBAL, sr_fitness_adaptive_global_cuda, False, trees, x0s, ts, ys,
                          fset, rtol, atol, budget, method, safety)


sr_fitness_adaptive_global_cuda.launches = 0


def sr_fitness_adaptive_global_wide_cuda(
    trees: TreeTensors, x0s: torch.Tensor, ts: torch.Tensor, ys: torch.Tensor,
    fset: FunctionSet, rtol: float = 1e-4, atol: float = 1e-6, budget: int = 500,
    method: str = "dopri5", safety: float = 0.9,
) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """Launch ``adaptive_global_wide_kernel``, the wide instance (any d and
    B within ``lanes_refusal``); ``(mse, alive, lane_steps)``."""
    return _adaptive_cuda(GLOBAL, sr_fitness_adaptive_global_wide_cuda, True, trees, x0s, ts, ys,
                          fset, rtol, atol, budget, method, safety)


sr_fitness_adaptive_global_wide_cuda.launches = 0


def sr_fitness_adaptive_interval_cuda(
    trees: TreeTensors, x0s: torch.Tensor, ts: torch.Tensor, ys: torch.Tensor,
    fset: FunctionSet, rtol: float = 1e-4, atol: float = 1e-6, max_steps: int = 32,
    method: str = "bosh3", safety: float = 0.9,
) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """Launch ``adaptive_interval_kernel`` (past the fixed instances
    :func:`sr_fitness_adaptive_interval_wide_cuda`); ``(mse, alive,
    lane_steps)``."""
    if not _fixed(x0s, fset):
        return sr_fitness_adaptive_interval_wide_cuda(trees, x0s, ts, ys, fset, rtol, atol,
                                                      max_steps, method, safety)
    return _adaptive_cuda(INTERVAL, sr_fitness_adaptive_interval_cuda, False, trees, x0s, ts, ys,
                          fset, rtol, atol, max_steps, method, safety)


sr_fitness_adaptive_interval_cuda.launches = 0


def sr_fitness_adaptive_interval_wide_cuda(
    trees: TreeTensors, x0s: torch.Tensor, ts: torch.Tensor, ys: torch.Tensor,
    fset: FunctionSet, rtol: float = 1e-4, atol: float = 1e-6, max_steps: int = 32,
    method: str = "bosh3", safety: float = 0.9,
) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """Launch ``adaptive_interval_wide_kernel``, the wide instance;
    ``(mse, alive, lane_steps)``."""
    return _adaptive_cuda(INTERVAL, sr_fitness_adaptive_interval_wide_cuda, True, trees, x0s, ts,
                          ys, fset, rtol, atol, max_steps, method, safety)


sr_fitness_adaptive_interval_wide_cuda.launches = 0


def _dispatch(cuda_fn, plain_fn, trees, *args):
    dev = trees.ops.device
    if dev.type == "cuda":
        return cuda_fn(trees, *args)
    if dev.type == "cpu":
        return plain_fn(trees, *args)
    raise NotImplementedError(f"no adaptive fitness implementation for device {dev}")


def sr_fitness_adaptive_global(
    trees: TreeTensors, x0s: torch.Tensor, ts: torch.Tensor, ys: torch.Tensor,
    fset: FunctionSet, rtol: float = 1e-4, atol: float = 1e-6, budget: int = 500,
    method: str = "dopri5", safety: float = 0.9, return_steps: bool = False,
):
    """Global-budget adaptive fitness, ``(mse (P, B), alive (P, B))`` (and
    ``lane_steps (P, B)`` with ``return_steps``): the kernel for CUDA
    tensors, the plain version for CPU tensors. Not differentiable; see
    :class:`SRFitnessAdaptive`."""
    out = _dispatch(sr_fitness_adaptive_global_cuda, sr_fitness_adaptive_global_plain, trees,
                    x0s, ts, ys, fset, rtol, atol, budget, method, safety)
    return out if return_steps else out[:2]


def sr_fitness_adaptive(
    trees: TreeTensors, x0s: torch.Tensor, ts: torch.Tensor, ys: torch.Tensor,
    fset: FunctionSet, rtol: float = 1e-4, atol: float = 1e-6, max_steps: int = 32,
    method: str = "bosh3", safety: float = 0.9,
) -> Tuple[torch.Tensor, torch.Tensor]:
    """Per-interval-budget adaptive fitness, ``(mse (P, B), alive (P, B))``:
    the kernel for CUDA tensors, the plain version for CPU tensors."""
    return _dispatch(sr_fitness_adaptive_interval_cuda, sr_fitness_adaptive_interval_plain,
                     trees, x0s, ts, ys, fset, rtol, atol, max_steps, method, safety)[:2]


def adaptive_solver_stats(
    trees: TreeTensors, x0s: torch.Tensor, ts: torch.Tensor, ys: torch.Tensor,
    fset: FunctionSet, rtol: float = 1e-4, atol: float = 1e-6, max_steps: int = 32,
    method: str = "bosh3", safety: float = 0.9,
) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """Controller-effort telemetry of the per-interval path: ``(mse, alive,
    lane_steps)``, ``lane_steps`` the attempted (accepted + rejected) steps of
    every lane over the whole grid. The JAX function reports steps per lane
    tile, because a TPU tile steps while any of its lanes is active; a GPU
    thread stops when its own lane is done, so the count is per lane."""
    return _dispatch(sr_fitness_adaptive_interval_cuda, sr_fitness_adaptive_interval_plain,
                     trees, x0s, ts, ys, fset, rtol, atol, max_steps, method, safety)


class AdaptiveConfig(NamedTuple):
    """The adaptive fitness a :class:`SRFitnessAdaptive` computes.

    ``global_budget`` picks the kernel: the whole-solve budget (``steps`` =
    the budget) or the per-interval one (``steps`` = ``max_steps``)."""

    global_budget: bool = True
    steps: int = 500
    method: str = "dopri5"
    rtol: float = 1e-4
    atol: float = 1e-6
    safety: float = 0.9

    def forward(self, trees, x0s, ts, ys, fset):
        args = (trees, x0s, ts, ys, fset, self.rtol, self.atol, self.steps, self.method,
                self.safety)
        if self.global_budget:
            return sr_fitness_adaptive_global(*args)
        return sr_fitness_adaptive(*args)

    def recompute_steps(self, t_steps: int) -> int:
        """The recompute's per-interval budget: ``max(budget // (T-1), 4)``
        for the global budget (the JAX VJP's approximation: exact for lanes
        whose budget never binds), ``max_steps`` for the per-interval one."""
        if self.global_budget:
            return max(self.steps // max(t_steps - 1, 1), 4)
        return self.steps


def adaptive_mse_unfused(
    trees: TreeTensors, x0s: torch.Tensor, ts: torch.Tensor, ys: torch.Tensor,
    fset: FunctionSet, config: AdaptiveConfig,
) -> torch.Tensor:
    """``mse (P, B)`` by ``integrate_adaptive`` over the whole trajectory,
    with the dispatching interpreter as the drift (the VJP's recompute)."""
    p = trees.ops.shape[0]
    b, d = x0s.shape
    batched = trees.map(lambda a: a[:, None])  # (P, 1, d, N)

    def drift(t, x):  # x (P, B, d)
        return evaluate_trees(batched, x[:, :, None, :], fset)

    xs, _ = integrate_adaptive(
        drift, x0s[None].expand(p, b, d), ts, rtol=config.rtol, atol=config.atol,
        max_steps_per_interval=config.recompute_steps(ts.shape[0]), safety=config.safety,
        method=config.method,
    )
    err = xs - ys.transpose(0, 1)[:, None]
    return (err * err).sum(dim=-1).mean(dim=0)


class SRFitnessAdaptive(torch.autograd.Function):
    """Adaptive fitness differentiable in ``const`` and ``x0s``: the forward
    is the dispatcher (kernel #5 or #4 on CUDA), the backward differentiates
    :func:`adaptive_mse_unfused`. No gradient goes to ``ops``, ``c1`` or
    ``c2``, or through ``alive``. Apply as ``SRFitnessAdaptive.apply(ops, c1,
    c2, const, x0s, ts, ys, fset, config)``."""

    @staticmethod
    def forward(ctx, ops, c1, c2, const, x0s, ts, ys, fset, config: AdaptiveConfig):
        ctx.save_for_backward(ops, c1, c2, const, x0s, ts, ys)
        ctx.config = (fset, config)
        mse, alive = config.forward(TreeTensors(ops, c1, c2, const), x0s, ts, ys, fset)
        ctx.mark_non_differentiable(alive)
        return mse, alive

    @staticmethod
    def backward(ctx, g_mse, _g_alive):
        ops, c1, c2, const, x0s, ts, ys = ctx.saved_tensors
        fset, config = ctx.config
        want_x0 = ctx.needs_input_grad[4]
        with torch.enable_grad():
            c = const.detach().requires_grad_(True)
            x0 = x0s.detach().requires_grad_(want_x0)
            mse = adaptive_mse_unfused(TreeTensors(ops, c1, c2, c), x0, ts, ys, fset, config)
            grads = torch.autograd.grad(mse, (c, x0) if want_x0 else (c,), g_mse)
        dx0 = grads[1] if want_x0 else None
        return None, None, None, grads[0], dx0, None, None, None, None
