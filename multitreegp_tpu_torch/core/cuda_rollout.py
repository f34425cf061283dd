"""Fused SR fitness: rollout + squared error per lane, kernel and plain version.

Counterpart of ``multitreegp_tpu/core/pallas_rollout.py``'s fixed-step
fitness path (``rollout_sr_fitness_pallas``). :func:`sr_fitness` returns,
for every candidate and trajectory, ``mse = sum_t sum_d (x_t - y_t)^2 / T``
(the ``x0`` row included) and whether the lane stayed alive, with the
integrator's frozen-lane semantics. The trajectory is never materialised.

* CUDA tensors launch the hand-written kernel ``csrc/sr_fitness.cu``, or
  raise when the call is outside what it implements.
* CPU tensors run :func:`sr_fitness_plain`, the same computation in plain
  PyTorch (the interpreter + integrator steppers), in the same float32
  expression order as the kernel.

:class:`SRFitness` makes it differentiable in the constants and the initial
states, as ``rollout_sr_fitness_pallas``'s ``custom_vjp`` does: the forward is
:func:`sr_fitness`; the backward recomputes the unfused MSE
(:func:`sr_mse_unfused`, the integrator with ``evaluate_trees`` as the
drift: the interpreter kernels on CUDA, the plain interpreter on CPU) and
differentiates that.
"""
from __future__ import annotations

import ctypes
from typing import Tuple

import torch

from .. import _build
from ..models.integrators import STEPPERS, finite, integrate, step_interval
from .interpreter import evaluate_trees, evaluate_trees_plain
from .registry import FunctionSet
from .trees import TreeTensors

METHODS = {"euler": 0, "heun": 1, "rk4": 2}
MAX_NODES = 256  # csrc/sr_fitness.cu kMaxNodes
MAX_STATE_DIM = 4  # template instances of the kernel
THREADS_PER_BLOCK = 128  # target block size: 128 // B candidates per block
SHARED_BYTES = 48 * 1024  # static shared-memory budget of one block


def sr_fitness_plain(
    trees: TreeTensors, x0s: torch.Tensor, ts: torch.Tensor, ys: torch.Tensor,
    fset: FunctionSet, method: str = "rk4", substeps: int = 1,
) -> Tuple[torch.Tensor, torch.Tensor]:
    """Plain PyTorch version of the kernel: ``(mse (P, B), alive (P, B))``.

    trees ``(P, d, N)``; x0s ``(B, d)``; ts ``(T,)``; ys ``(B, T, d)``.
    """
    p = trees.ops.shape[0]
    b, d = x0s.shape
    t_steps = ts.shape[0]
    batched = trees.map(lambda a: a[:, None])  # (P, 1, d, N) broadcasts over B

    def drift(t, x):  # x (P, B, d)
        return evaluate_trees_plain(batched, x[:, :, None, :], fset)

    def sq_err(x, y):  # same summation order as the kernel
        dl = x - y
        e = dl[..., 0] * dl[..., 0]
        for q in range(1, d):
            e = e + dl[..., q] * dl[..., q]
        return e

    x = x0s[None].expand(p, b, d)
    alive = finite(x)
    y = ys.transpose(0, 1)  # (T, B, d)
    err = sq_err(x, y[0])
    stepper = STEPPERS[method]
    times = ts.tolist()
    for t in range(t_steps - 1):
        x, alive = step_interval(stepper, drift, times[t], times[t + 1], x, alive, substeps)
        err = err + sq_err(x, y[t + 1])
    return err / t_steps, alive


def _check_method(method: str) -> None:
    if method not in METHODS:
        raise NotImplementedError(
            f"method {method!r}: the port has {sorted(METHODS)}; adaptive SR is "
            "ROADMAP Queue 1 #14 (TPU kernels #4/#5 of the PERF.md table)"
        )


def _check_supported(trees: TreeTensors, x0s, ts, ys, fset: FunctionSet, method: str, substeps: int):
    p, m, n = trees.ops.shape
    b, d = x0s.shape
    _check_method(method)
    if m != d:
        raise NotImplementedError(f"{m} trees per candidate for state dim {d}: the kernel needs m == d")
    if n > MAX_NODES:
        raise NotImplementedError(f"max_nodes {n} > {MAX_NODES}, the fitness kernel's limit")
    if d > MAX_STATE_DIM:
        raise NotImplementedError(f"state dim {d} > {MAX_STATE_DIM}, the kernel's instances")
    if b > 1024:
        raise NotImplementedError(f"{b} trajectories > 1024 threads of one block")
    if substeps < 1:
        raise ValueError("substeps must be >= 1")
    if ts.shape[0] < 1 or ys.shape != (b, ts.shape[0], d):
        raise ValueError(f"ys {tuple(ys.shape)} does not match (B, T, d) = {(b, ts.shape[0], d)}")
    fset.require_device_ops()


def sr_fitness_cuda(
    trees: TreeTensors, x0s: torch.Tensor, ts: torch.Tensor, ys: torch.Tensor,
    fset: FunctionSet, method: str = "rk4", substeps: int = 1,
) -> Tuple[torch.Tensor, torch.Tensor]:
    """Launch ``csrc/sr_fitness.cu``; ``(mse (P, B), alive (P, B))``."""
    _check_supported(trees, x0s, ts, ys, fset, method, substeps)
    dev = trees.ops.device
    p, m, n = trees.ops.shape
    b, d = x0s.shape
    t_steps = ts.shape[0]
    for name, t, dtype in (("ops", trees.ops, torch.int32), ("const", trees.const, torch.float32),
                           ("x0s", x0s, torch.float32), ("ts", ts, torch.float32),
                           ("ys", ys, torch.float32)):
        if t.device != dev or t.dtype != dtype:
            raise ValueError(f"{name}: expected {dtype} on {dev}, got {t.dtype} on {t.device}")
    if trees.const.shape != trees.ops.shape:
        raise ValueError("ops and const shapes differ")
    ops, cst, x0c, tsc, ysc = (t.contiguous() for t in (trees.ops, trees.const, x0s, ts, ys))
    devop = fset.device_ops(dev)
    err = torch.empty((p, b), dtype=torch.float32, device=dev)
    alive = torch.empty((p, b), dtype=torch.bool, device=dev)
    cpb = max(1, min(THREADS_PER_BLOCK // b, SHARED_BYTES // (m * n * 8)))

    lib = _build.load("sr_fitness")
    fn = lib.sr_fitness_launch
    fn.argtypes = [ctypes.c_void_p] * 8 + [ctypes.c_int] * 9 + [ctypes.c_void_p]
    fn.restype = ctypes.c_int
    stream = torch.cuda.current_stream(dev).cuda_stream
    status = fn(
        ops.data_ptr(), cst.data_ptr(), devop.data_ptr(), x0c.data_ptr(), tsc.data_ptr(),
        ysc.data_ptr(), err.data_ptr(), alive.data_ptr(),
        p, d, n, b, t_steps, fset.var_start, METHODS[method], substeps, cpb, stream,
    )
    _build.check(lib, status, "sr_fitness kernel launch")
    sr_fitness_cuda.launches += 1
    return err / t_steps, alive


sr_fitness_cuda.launches = 0


def sr_fitness(
    trees: TreeTensors, x0s: torch.Tensor, ts: torch.Tensor, ys: torch.Tensor,
    fset: FunctionSet, method: str = "rk4", substeps: int = 1,
) -> Tuple[torch.Tensor, torch.Tensor]:
    """Per-lane ``(mse (P, B), alive (P, B))``: the kernel for CUDA tensors,
    the plain version for CPU tensors."""
    dev = trees.ops.device
    if dev.type == "cuda":
        return sr_fitness_cuda(trees, x0s, ts, ys, fset, method, substeps)
    if dev.type == "cpu":
        _check_method(method)
        return sr_fitness_plain(trees, x0s, ts, ys, fset, method, substeps)
    raise NotImplementedError(f"no fitness implementation for device {dev}")


def sr_mse_unfused(
    trees: TreeTensors, x0s: torch.Tensor, ts: torch.Tensor, ys: torch.Tensor,
    fset: FunctionSet, method: str = "rk4", substeps: int = 1,
) -> torch.Tensor:
    """``mse (P, B)`` by the integrator over the whole trajectory, with the
    dispatching interpreter as the drift (the VJP's recompute;
    ``pallas_rollout.rollout_sr_fitness_pallas``'s ``default_unfused``)."""
    p = trees.ops.shape[0]
    b, d = x0s.shape
    batched = trees.map(lambda a: a[:, None])  # (P, 1, d, N)

    def drift(t, x):  # x (P, B, d)
        return evaluate_trees(batched, x[:, :, None, :], fset)

    xs, _ = integrate(drift, x0s[None].expand(p, b, d), ts, method, substeps)
    err = xs - ys.transpose(0, 1)[:, None]
    return (err * err).sum(dim=-1).mean(dim=0)


class SRFitness(torch.autograd.Function):
    """:func:`sr_fitness` differentiable in ``const`` and ``x0s``; the
    cotangent of ``alive`` is ignored. Apply as
    ``SRFitness.apply(ops, c1, c2, const, x0s, ts, ys, fset, method, substeps)``."""

    @staticmethod
    def forward(ctx, ops, c1, c2, const, x0s, ts, ys, fset, method, substeps):
        ctx.save_for_backward(ops, c1, c2, const, x0s, ts, ys)
        ctx.config = (fset, method, substeps)
        mse, alive = sr_fitness(TreeTensors(ops, c1, c2, const), x0s, ts, ys, fset, method, substeps)
        ctx.mark_non_differentiable(alive)
        return mse, alive

    @staticmethod
    def backward(ctx, g_mse, _g_alive):
        ops, c1, c2, const, x0s, ts, ys = ctx.saved_tensors
        fset, method, substeps = ctx.config
        want_x0 = ctx.needs_input_grad[4]
        with torch.enable_grad():
            c = const.detach().requires_grad_(True)
            x0 = x0s.detach().requires_grad_(want_x0)
            mse = sr_mse_unfused(TreeTensors(ops, c1, c2, c), x0, ts, ys, fset, method, substeps)
            grads = torch.autograd.grad(mse, (c, x0) if want_x0 else (c,), g_mse)
        dx0 = grads[1] if want_x0 else None
        return None, None, None, grads[0], dx0, None, None, None, None, None
