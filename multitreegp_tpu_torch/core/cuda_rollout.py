"""SR rollouts per lane: the fused fitness and the trajectory, kernel and plain.

Counterparts of ``multitreegp_tpu/core/pallas_rollout.py``'s fixed-step
paths:

* :func:`sr_fitness` (``rollout_sr_fitness_pallas``) returns, for every
  candidate and trajectory, ``mse = sum_t sum_d (x_t - y_t)^2 / T`` (the
  ``x0`` row included) and whether the lane stayed alive, with the
  integrator's frozen-lane semantics; the trajectory is never materialised.
  Given kick rows ``(T, B, substeps * d)`` (``make_sr_kick_rows``), substep
  ``s`` of interval ``t`` adds ``kick_rows[t, b, s*d:(s+1)*d]`` to its update:
  the SDE variant, ``integrate_sde``'s Euler-Maruyama rollout.
  Kernel ``csrc/sr_fitness.cu``; plain version :func:`sr_fitness_plain`.
* :func:`sr_rollout` (``rollout_sr_pallas``) returns the trajectory ``xs (T,
  P, B, d)`` and the final liveness broadcast over ``T``, with one step size
  ``(ts[1] - ts[0]) / substeps`` for the whole grid. Kernel
  ``csrc/sr_rollout.cu``; plain version :func:`sr_rollout_plain`.

CUDA tensors launch the hand-written kernel, or raise when the call is
outside what it implements; CPU tensors run the plain version, the same
computation in plain PyTorch in the kernel's float32 expression order. Each
kernel has fixed instances (state dim d <= 4, B <= 1024 trajectories, 63
variables, device op ids up to 63: :func:`takes_fixed`) and a wide-state
instance for the rest
(``csrc/tree_prog_wide.cuh``, the ``_wide`` builds): :func:`sr_fitness_wide_cuda`
and :func:`sr_rollout_wide_cuda`, with a scratch buffer of lane vectors that
the wrapper allocates, split into launches of at most :data:`SCRATCH_BYTES`.
Its one limit, :func:`lanes_refusal`'s, is a candidate's decoded program in
a block's shared memory.

:class:`SRFitness` and :class:`SRRollout` make them differentiable in the
constants and the initial states, as the JAX functions' ``custom_vjp``s do:
the forward is the dispatcher; the backward recomputes through the
integrator with ``evaluate_trees`` as the drift (the interpreter kernels on
CUDA, the plain interpreter on CPU) and differentiates that.
"""
from __future__ import annotations

import ctypes
from typing import NamedTuple, Optional, Tuple

import numpy as np
import torch

from .. import _build
from ..models.integrators import STEPPERS, _f32, finite, integrate, integrate_sde, step_interval
from .interpreter import evaluate_trees, evaluate_trees_plain
from .registry import FIXED_MAX_OP, FunctionSet
from .trees import TreeTensors

METHODS = {"euler": 0, "heun": 1, "rk4": 2}
MAX_NODES = 256  # csrc/sr_fitness.cu kMaxNodes
# The fixed instances take d <= 4 (their template instances), B <= 1024 (#1:
# a candidate's trajectories in one block) and 63 variables (tree_prog.cuh's
# decoded slot); past any of these the wide instance runs.
FIXED_STATE_DIM = 4
FIXED_TRAJECTORIES = 1024
FIXED_VARS = 63
THREADS_PER_BLOCK = 128  # target block size: 128 // B candidates per block
SHARED_BYTES = 48 * 1024  # static shared-memory budget of one block
BLOCK_SHARED_BYTES = 227 * 1024  # the most a block can hold, opted in (H100)
WIDE_LANES = 128  # csrc/tree_prog_wide.cuh kWideLanes: a candidate's trajectories a block
ROW_BYTES = 8  # a decoded row (Row, WideRow)
# the wide instance's scratch per launch: its lane vectors, d floats each per
# lane (FITNESS_VECTORS, ROLLOUT_VECTORS; core/cuda_adaptive.py's
# ADAPTIVE_VECTORS); a population past it launches in parts
SCRATCH_BYTES = 1 << 30
FITNESS_VECTORS = 4  # csrc/sr_fitness.cu kFitnessVectors
ROLLOUT_VECTORS = 4  # csrc/sr_rollout.cu kRolloutVectors


class SDENoise(NamedTuple):
    """The SR evaluator's process noise: the kick rows kernel #1 adds, and
    the keys and scale ``integrate_sde`` draws them from (the recompute)."""

    kick_rows: torch.Tensor  # (T, B, substeps * d)
    keys: torch.Tensor  # (B, 2)
    process_noise: float


def sr_fitness_plain(
    trees: TreeTensors, x0s: torch.Tensor, ts: torch.Tensor, ys: torch.Tensor,
    fset: FunctionSet, method: str = "rk4", substeps: int = 1,
    kick_rows: Optional[torch.Tensor] = None,
) -> Tuple[torch.Tensor, torch.Tensor]:
    """Plain PyTorch version of the kernel: ``(mse (P, B), alive (P, B))``.

    trees ``(P, d, N)``; x0s ``(B, d)``; ts ``(T,)``; ys ``(B, T, d)``;
    kick_rows ``(T, B, substeps * d)`` or None.
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
        kick = None if kick_rows is None else (
            lambda i, _t, _x, _dt, row=kick_rows[t]: row[:, i * d:(i + 1) * d])
        x, alive = step_interval(stepper, drift, times[t], times[t + 1], x, alive, substeps,
                                 kick=kick)
        err = err + sq_err(x, y[t + 1])
    return err / t_steps, alive


def _check_method(method: str) -> None:
    if method not in METHODS:
        raise NotImplementedError(
            f"method {method!r}: the fixed-step kernels have {sorted(METHODS)}; the "
            "adaptive ones are in core/cuda_adaptive.py"
        )


def check_kicks(kick_rows, ts, b: int, d: int, substeps: int) -> None:
    """Raise unless ``kick_rows`` is None or ``(T, B, substeps * d)``."""
    want = (ts.shape[0], b, substeps * d)
    if kick_rows is not None and tuple(kick_rows.shape) != want:
        raise ValueError(f"kick rows {tuple(kick_rows.shape)}: expected (T, B, substeps * d) = {want}")


def program_bytes(d: int, n: int) -> int:
    """Shared memory of one candidate's decoded program: ``d`` trees of ``n``
    rows and each tree's first live row."""
    return d * (n * ROW_BYTES + 4)


def lanes_refusal(m: int, n: int, d: int, b: int) -> Optional[str]:
    """Why the per-lane kernels (#1, #3, #4, #5) do not take candidates of
    ``m`` trees of ``n`` rows on ``b`` trajectories of state dim ``d``, or
    None when they do: the limits :func:`check_lanes` enforces, decided from
    the configuration alone (the SR evaluator's gate; on the CPU too). Any
    ``d`` and ``b`` whose program fits a block's shared memory run, the wide
    instance past the fixed ones (:func:`takes_fixed`). Operators outside
    ``DEVICE_OPS`` are not part of it: they raise on CUDA on every path."""
    if m != d:
        return f"{m} trees per candidate for state dim {d}: the kernel needs m == d"
    if n > MAX_NODES:
        return f"max_nodes {n} > {MAX_NODES}, the fitness kernel's limit"
    if program_bytes(d, n) > BLOCK_SHARED_BYTES:
        return (f"one candidate's {d} trees of {n} rows take {program_bytes(d, n)} B of decoded "
                f"rows > the {BLOCK_SHARED_BYTES} B of shared memory a block holds")
    return None


def takes_fixed(d: int, b: int, nvar: int, max_op: int) -> bool:
    """Whether the fixed instances take state dim ``d``, ``b`` trajectories,
    ``nvar`` variables and device op ids up to ``max_op`` (else the wide
    instance runs: a set past ``registry.FIXED_MAX_OP`` user operators'
    ids too, whose decoded rows hold any id)."""
    return (d <= FIXED_STATE_DIM and b <= FIXED_TRAJECTORIES and nvar <= FIXED_VARS
            and max_op <= FIXED_MAX_OP)


def check_lanes(trees: TreeTensors, x0s, ts, fset: FunctionSet, ys=None) -> None:
    """Raise unless the per-lane kernels take these operands: ``m == d``
    trees, ``N <= 256``, a candidate's program within a block's shared
    memory (:func:`lanes_refusal`) and the device operators."""
    p, m, n = trees.ops.shape
    b, d = x0s.shape
    reason = lanes_refusal(m, n, d, b)
    if reason is not None:
        raise NotImplementedError(reason)
    if ts.shape[0] < 1 or (ys is not None and ys.shape != (b, ts.shape[0], d)):
        raise ValueError(f"ys {tuple(ys.shape)} does not match (B, T, d) = {(b, ts.shape[0], d)}")
    fset.require_device_ops()


def _typed(trees: TreeTensors, fset: FunctionSet, *named):
    """Contiguous operands for a per-lane kernel, checked to lie with the
    trees on one device with the kernel's types, then the device op table."""
    dev = trees.ops.device
    for name, t, dtype in (("ops", trees.ops, torch.int32), ("const", trees.const, torch.float32),
                           *((nm, t, torch.float32) for nm, t in named)):
        if t.device != dev or t.dtype != dtype:
            raise ValueError(f"{name}: expected {dtype} on {dev}, got {t.dtype} on {t.device}")
    if trees.const.shape != trees.ops.shape:
        raise ValueError("ops and const shapes differ")
    tensors = [t.contiguous() for t in (trees.ops, trees.const)] + [t.contiguous() for _, t in named]
    return tensors, fset.device_ops(dev)


def kernel_operands(trees: TreeTensors, fset: FunctionSet, *named):
    """Operands of a fixed instance (:func:`_typed`) and its candidates per
    block: a block is ``cpb`` candidates x B lanes, at most
    ``THREADS_PER_BLOCK`` threads, their trees in ``SHARED_BYTES``. Refuses
    a set of more than ``FIXED_VARS`` variables: the fixed instances' decoded
    row would read variable 63 for any past it."""
    if fset.num_variables > FIXED_VARS:
        raise NotImplementedError(
            f"{fset.num_variables} variables > {FIXED_VARS}, the fixed instances' limit "
            "(csrc/tree_prog.cuh's 6-bit slot); the wide instance takes any")
    if fset.max_device_op > FIXED_MAX_OP:
        raise NotImplementedError(
            f"device op id {fset.max_device_op} > {FIXED_MAX_OP}, the fixed instances' limit "
            "(csrc/tree_prog.cuh's 6-bit field); the wide instance takes any")
    p, m, n = trees.ops.shape
    b = named[0][1].shape[0]  # x0s (B, d) comes first
    cpb = max(1, min(THREADS_PER_BLOCK // b, SHARED_BYTES // (m * n * ROW_BYTES)))
    tensors, devop = _typed(trees, fset, *named)
    return tensors, devop, cpb


def wide_launches(p: int, b: int, d: int, vectors: int):
    """The wide instance's launches over ``p`` candidates: ``(c0, count)``
    each, whose scratch of ``vectors`` lane vectors of ``d`` floats per lane
    fits :data:`SCRATCH_BYTES` (at least one candidate a launch)."""
    step = max(1, SCRATCH_BYTES // (vectors * d * b * 4))
    return [(c0, min(step, p - c0)) for c0 in range(0, p, step)]


def wide_cpb(b: int, d: int, n: int) -> int:
    """Candidates a block of the wide instance holds: at most
    ``THREADS_PER_BLOCK`` threads of at most ``WIDE_LANES`` trajectories a
    candidate, their programs in ``SHARED_BYTES`` (one candidate's up to
    ``BLOCK_SHARED_BYTES``, opted in)."""
    return max(1, min(THREADS_PER_BLOCK // min(b, WIDE_LANES), SHARED_BYTES // program_bytes(d, n)))


def wide_operands(trees: TreeTensors, fset: FunctionSet, vectors: int, *named):
    """Operands of a wide launch (:func:`_typed`), its candidates per block,
    its launches (:func:`wide_launches`) and the scratch of the largest."""
    p, m, n = trees.ops.shape
    b, d = named[0][1].shape  # x0s (B, d) comes first
    tensors, devop = _typed(trees, fset, *named)
    launches = wide_launches(p, b, d, vectors)
    scratch = torch.empty(vectors * d * launches[0][1] * b, dtype=torch.float32,
                          device=trees.ops.device)
    return tensors, devop, wide_cpb(b, d, n), launches, scratch


def sr_fitness_cuda(
    trees: TreeTensors, x0s: torch.Tensor, ts: torch.Tensor, ys: torch.Tensor,
    fset: FunctionSet, method: str = "rk4", substeps: int = 1,
    kick_rows: Optional[torch.Tensor] = None,
) -> Tuple[torch.Tensor, torch.Tensor]:
    """Launch ``csrc/sr_fitness.cu``; ``(mse (P, B), alive (P, B))``: a fixed
    instance, or past them (:func:`takes_fixed`) :func:`sr_fitness_wide_cuda`."""
    _check_method(method)
    if substeps < 1:
        raise ValueError("substeps must be >= 1")
    check_lanes(trees, x0s, ts, fset, ys)
    check_kicks(kick_rows, ts, *x0s.shape, substeps)
    b, d = x0s.shape
    if not takes_fixed(d, b, fset.num_variables, fset.max_device_op):
        return sr_fitness_wide_cuda(trees, x0s, ts, ys, fset, method, substeps, kick_rows)
    named = [("x0s", x0s), ("ts", ts), ("ys", ys)]
    if kick_rows is not None:
        named.append(("kick_rows", kick_rows))
    (ops, cst, x0c, tsc, ysc, *kicks), devop, cpb = kernel_operands(trees, fset, *named)
    dev = ops.device
    p, m, n = ops.shape
    t_steps = ts.shape[0]
    err = torch.empty((p, b), dtype=torch.float32, device=dev)
    alive = torch.empty((p, b), dtype=torch.bool, device=dev)

    lib = _build.load("sr_fitness", fset.variant)
    fn = lib.sr_fitness_launch
    fn.argtypes = [ctypes.c_void_p] * 9 + [ctypes.c_int] * 10 + [ctypes.c_void_p]
    fn.restype = ctypes.c_int
    stream = torch.cuda.current_stream(dev).cuda_stream
    status = fn(
        ops.data_ptr(), cst.data_ptr(), devop.data_ptr(), x0c.data_ptr(), tsc.data_ptr(),
        ysc.data_ptr(), kicks[0].data_ptr() if kicks else None, err.data_ptr(), alive.data_ptr(),
        p, d, n, b, t_steps, fset.var_start, fset.has_unary, METHODS[method], substeps, cpb, stream,
    )
    _build.check(lib, status, "sr_fitness kernel launch")
    sr_fitness_cuda.launches += 1
    return err / t_steps, alive


sr_fitness_cuda.launches = 0


def sr_fitness_wide_cuda(
    trees: TreeTensors, x0s: torch.Tensor, ts: torch.Tensor, ys: torch.Tensor,
    fset: FunctionSet, method: str = "rk4", substeps: int = 1,
    kick_rows: Optional[torch.Tensor] = None,
) -> Tuple[torch.Tensor, torch.Tensor]:
    """Launch the wide instance of ``csrc/sr_fitness.cu`` (the ``_wide``
    build of the set's library; any d and B within :func:`lanes_refusal`);
    ``(mse (P, B), alive (P, B))``. One launch per :func:`wide_launches`
    part, each counted."""
    _check_method(method)
    if substeps < 1:
        raise ValueError("substeps must be >= 1")
    check_lanes(trees, x0s, ts, fset, ys)
    check_kicks(kick_rows, ts, *x0s.shape, substeps)
    named = [("x0s", x0s), ("ts", ts), ("ys", ys)]
    if kick_rows is not None:
        named.append(("kick_rows", kick_rows))
    (ops, cst, x0c, tsc, ysc, *kicks), devop, cpb, launches, scratch = wide_operands(
        trees, fset, FITNESS_VECTORS, *named)
    dev = ops.device
    p, m, n = ops.shape
    b, d = x0s.shape
    t_steps = ts.shape[0]
    err = torch.empty((p, b), dtype=torch.float32, device=dev)
    alive = torch.empty((p, b), dtype=torch.bool, device=dev)

    lib = _build.load("sr_fitness", _build.widened(fset.variant))
    fn = lib.sr_fitness_wide_launch
    fn.argtypes = ([ctypes.c_void_p] * 9 + [ctypes.c_int] * 9 + [ctypes.c_void_p]
                   + [ctypes.c_int] * 3 + [ctypes.c_void_p])
    fn.restype = ctypes.c_int
    stream = torch.cuda.current_stream(dev).cuda_stream
    for c0, count in launches:
        status = fn(
            ops.data_ptr(), cst.data_ptr(), devop.data_ptr(), x0c.data_ptr(), tsc.data_ptr(),
            ysc.data_ptr(), kicks[0].data_ptr() if kicks else None, err.data_ptr(),
            alive.data_ptr(), p, d, n, b, t_steps, fset.var_start, fset.has_unary,
            METHODS[method], substeps, scratch.data_ptr(), c0, count, cpb, stream,
        )
        _build.check(lib, status, "sr_fitness wide kernel launch")
        sr_fitness_wide_cuda.launches += 1
    return err / t_steps, alive


sr_fitness_wide_cuda.launches = 0


def sr_fitness(
    trees: TreeTensors, x0s: torch.Tensor, ts: torch.Tensor, ys: torch.Tensor,
    fset: FunctionSet, method: str = "rk4", substeps: int = 1,
    kick_rows: Optional[torch.Tensor] = None,
) -> Tuple[torch.Tensor, torch.Tensor]:
    """Per-lane ``(mse (P, B), alive (P, B))``: the kernel for CUDA tensors,
    the plain version for CPU tensors."""
    dev = trees.ops.device
    if dev.type == "cuda":
        return sr_fitness_cuda(trees, x0s, ts, ys, fset, method, substeps, kick_rows)
    if dev.type == "cpu":
        _check_method(method)
        check_kicks(kick_rows, ts, *x0s.shape, substeps)
        return sr_fitness_plain(trees, x0s, ts, ys, fset, method, substeps, kick_rows)
    raise NotImplementedError(f"no fitness implementation for device {dev}")


def sr_mse_unfused(
    trees: TreeTensors, x0s: torch.Tensor, ts: torch.Tensor, ys: torch.Tensor,
    fset: FunctionSet, method: str = "rk4", substeps: int = 1,
    noise: Optional[SDENoise] = None,
) -> torch.Tensor:
    """``mse (P, B)`` by the integrator over the whole trajectory, with the
    dispatching interpreter as the drift (the VJP's recompute;
    ``pallas_rollout.rollout_sr_fitness_pallas``'s ``default_unfused``, or
    with ``noise`` the SR evaluator's ``unfused_mse``: ``integrate_sde``
    with the diagonal diffusion ``process_noise``)."""
    p = trees.ops.shape[0]
    b, d = x0s.shape
    batched = trees.map(lambda a: a[:, None])  # (P, 1, d, N)

    def drift(t, x):  # x (P, B, d)
        return evaluate_trees(batched, x[:, :, None, :], fset)

    x0 = x0s[None].expand(p, b, d)
    if noise is None:
        xs, _ = integrate(drift, x0, ts, method, substeps)
    else:
        pn = _f32(noise.process_noise)
        xs, _ = integrate_sde(drift, lambda t, x: torch.full_like(x, pn), x0, ts, noise.keys,
                              method, substeps)
    err = xs - ys.transpose(0, 1)[:, None]
    return (err * err).sum(dim=-1).mean(dim=0)


class SRFitness(torch.autograd.Function):
    """:func:`sr_fitness` differentiable in ``const`` and ``x0s``; the
    cotangent of ``alive`` is ignored. Apply as ``SRFitness.apply(ops, c1,
    c2, const, x0s, ts, ys, fset, method, substeps, noise)``, ``noise`` an
    :class:`SDENoise` (the kicks forward, ``integrate_sde`` in the
    recompute) or None."""

    @staticmethod
    def forward(ctx, ops, c1, c2, const, x0s, ts, ys, fset, method, substeps, noise=None):
        ctx.save_for_backward(ops, c1, c2, const, x0s, ts, ys)
        ctx.config = (fset, method, substeps, noise)
        kicks = None if noise is None else noise.kick_rows
        mse, alive = sr_fitness(TreeTensors(ops, c1, c2, const), x0s, ts, ys, fset, method,
                                substeps, kicks)
        ctx.mark_non_differentiable(alive)
        return mse, alive

    @staticmethod
    def backward(ctx, g_mse, _g_alive):
        ops, c1, c2, const, x0s, ts, ys = ctx.saved_tensors
        fset, method, substeps, noise = ctx.config
        want_x0 = ctx.needs_input_grad[4]
        with torch.enable_grad():
            c = const.detach().requires_grad_(True)
            x0 = x0s.detach().requires_grad_(want_x0)
            mse = sr_mse_unfused(TreeTensors(ops, c1, c2, c), x0, ts, ys, fset, method, substeps,
                                 noise)
            grads = torch.autograd.grad(mse, (c, x0) if want_x0 else (c,), g_mse)
        dx0 = grads[1] if want_x0 else None
        return None, None, None, grads[0], dx0, None, None, None, None, None, None


# --------------------------------------------------- trajectory (kernel #3)

# method -> ([(stage coefficient, accumulation weight)...], final scale): the
# TPU rollout kernel's table (pallas_rollout._RK_TABLES)
RK_TABLES = {
    "euler": ([(0.0, 1.0)], 1.0),
    "heun": ([(0.0, 1.0), (1.0, 1.0)], 0.5),
    "rk4": ([(0.0, 1.0), (0.5, 2.0), (0.5, 2.0), (1.0, 1.0)], 1 / 6),
}


def rollout_step(ts: torch.Tensor, method: str, substeps: int):
    """``(h, h*final_scale)`` of the trajectory rollout: ``h = (ts[1] -
    ts[0]) / substeps`` in double from the float32 grid (one step size for
    the whole grid), each stage scalar ``h*c`` and the final one formed in
    double and rounded once to float32 where used."""
    _check_method(method)
    if substeps < 1:
        raise ValueError("substeps must be >= 1")
    times = ts.tolist()
    dt = float(np.float32(times[1]) - np.float32(times[0])) if len(times) > 1 else 0.0
    h = dt / substeps
    return h, _f32(h * RK_TABLES[method][1])


def sr_rollout_plain(
    trees: TreeTensors, x0s: torch.Tensor, ts: torch.Tensor, fset: FunctionSet,
    method: str = "rk4", substeps: int = 1,
) -> Tuple[torch.Tensor, torch.Tensor]:
    """Plain PyTorch version of the trajectory kernel: ``(xs (T, P, B, d),
    alive (T, P, B))``, ``alive`` the final liveness broadcast over T."""
    stages, _ = RK_TABLES[method]
    h, h_final = rollout_step(ts, method, substeps)
    p = trees.ops.shape[0]
    b, d = x0s.shape
    batched = trees.map(lambda a: a[:, None])

    def drift(x):
        return evaluate_trees_plain(batched, x[:, :, None, :], fset)

    x = x0s[None].expand(p, b, d)
    alive = finite(x)
    xs = [x]
    for _ in range(ts.shape[0] - 1):
        for _ in range(substeps):
            acc, k = torch.zeros_like(x), None
            for c, w in stages:
                k = drift(x if k is None else x + _f32(h * c) * k)
                acc = acc + w * k
            x_new = x + h_final * acc
            alive = alive & finite(x_new)
            x = torch.where(alive[..., None], x_new, x)
        xs.append(x)
    return torch.stack(xs), alive[None].expand(ts.shape[0], p, b)


def sr_rollout_cuda(
    trees: TreeTensors, x0s: torch.Tensor, ts: torch.Tensor, fset: FunctionSet,
    method: str = "rk4", substeps: int = 1,
) -> Tuple[torch.Tensor, torch.Tensor]:
    """Launch ``csrc/sr_rollout.cu``; ``(xs (T, P, B, d), alive (T, P, B))``:
    a fixed instance, or past them :func:`sr_rollout_wide_cuda`."""
    h, h_final = rollout_step(ts, method, substeps)
    check_lanes(trees, x0s, ts, fset)
    b, d = x0s.shape
    if not takes_fixed(d, b, fset.num_variables, fset.max_device_op):
        return sr_rollout_wide_cuda(trees, x0s, ts, fset, method, substeps)
    (ops, cst, x0c), devop, cpb = kernel_operands(trees, fset, ("x0s", x0s))
    dev = ops.device
    p, m, n = ops.shape
    t_steps = ts.shape[0]
    xs = torch.empty((t_steps, p, b, d), dtype=torch.float32, device=dev)
    alive = torch.empty((p, b), dtype=torch.bool, device=dev)

    lib = _build.load("sr_rollout", fset.variant)
    fn = lib.sr_rollout_launch
    if fn.argtypes is None:  # once per loaded library
        fn.argtypes = ([ctypes.c_void_p] * 6 + [ctypes.c_int] * 9 + [ctypes.c_float] * 3
                       + [ctypes.c_int, ctypes.c_void_p])
        fn.restype = ctypes.c_int
    status = fn(
        ops.data_ptr(), cst.data_ptr(), devop.data_ptr(), x0c.data_ptr(), xs.data_ptr(),
        alive.data_ptr(), p, d, n, b, t_steps, fset.var_start, fset.has_unary, METHODS[method],
        substeps,
        _f32(h * 0.5), _f32(h), h_final, cpb, torch.cuda.current_stream(dev).cuda_stream,
    )
    _build.check(lib, status, "sr_rollout kernel launch")
    sr_rollout_cuda.launches += 1
    return xs, alive[None].expand(t_steps, p, b)


sr_rollout_cuda.launches = 0


def sr_rollout_wide_cuda(
    trees: TreeTensors, x0s: torch.Tensor, ts: torch.Tensor, fset: FunctionSet,
    method: str = "rk4", substeps: int = 1,
) -> Tuple[torch.Tensor, torch.Tensor]:
    """Launch the wide instance of ``csrc/sr_rollout.cu``; ``(xs (T, P, B,
    d), alive (T, P, B))``. One launch per :func:`wide_launches` part, each
    counted."""
    h, h_final = rollout_step(ts, method, substeps)
    check_lanes(trees, x0s, ts, fset)
    (ops, cst, x0c), devop, cpb, launches, scratch = wide_operands(
        trees, fset, ROLLOUT_VECTORS, ("x0s", x0s))
    dev = ops.device
    p, m, n = ops.shape
    b, d = x0s.shape
    t_steps = ts.shape[0]
    xs = torch.empty((t_steps, p, b, d), dtype=torch.float32, device=dev)
    alive = torch.empty((p, b), dtype=torch.bool, device=dev)

    lib = _build.load("sr_rollout", _build.widened(fset.variant))
    fn = lib.sr_rollout_wide_launch
    fn.argtypes = ([ctypes.c_void_p] * 6 + [ctypes.c_int] * 9 + [ctypes.c_float] * 3
                   + [ctypes.c_void_p] + [ctypes.c_int] * 3 + [ctypes.c_void_p])
    fn.restype = ctypes.c_int
    stream = torch.cuda.current_stream(dev).cuda_stream
    for c0, count in launches:
        status = fn(
            ops.data_ptr(), cst.data_ptr(), devop.data_ptr(), x0c.data_ptr(), xs.data_ptr(),
            alive.data_ptr(), p, d, n, b, t_steps, fset.var_start, fset.has_unary,
            METHODS[method], substeps, _f32(h * 0.5), _f32(h), h_final, scratch.data_ptr(), c0,
            count, cpb, stream,
        )
        _build.check(lib, status, "sr_rollout wide kernel launch")
        sr_rollout_wide_cuda.launches += 1
    return xs, alive[None].expand(t_steps, p, b)


sr_rollout_wide_cuda.launches = 0


def sr_rollout(
    trees: TreeTensors, x0s: torch.Tensor, ts: torch.Tensor, fset: FunctionSet,
    method: str = "rk4", substeps: int = 1,
) -> Tuple[torch.Tensor, torch.Tensor]:
    """Trajectories ``(xs (T, P, B, d), alive (T, P, B))``: the kernel for
    CUDA tensors, the plain version for CPU tensors."""
    dev = trees.ops.device
    if dev.type == "cuda":
        return sr_rollout_cuda(trees, x0s, ts, fset, method, substeps)
    if dev.type == "cpu":
        return sr_rollout_plain(trees, x0s, ts, fset, method, substeps)
    raise NotImplementedError(f"no rollout implementation for device {dev}")


class SRRollout(torch.autograd.Function):
    """:func:`sr_rollout` differentiable in ``const`` and ``x0s`` through the
    unfused recompute (``integrate`` with ``evaluate_trees`` as the drift,
    JAX ``rollout_sr_pallas``'s ``custom_vjp``); the cotangent of ``alive``
    is ignored. Apply as ``SRRollout.apply(ops, c1, c2, const, x0s, ts,
    fset, method, substeps)``."""

    @staticmethod
    def forward(ctx, ops, c1, c2, const, x0s, ts, fset, method, substeps):
        ctx.save_for_backward(ops, c1, c2, const, x0s, ts)
        ctx.config = (fset, method, substeps)
        xs, alive = sr_rollout(TreeTensors(ops, c1, c2, const), x0s, ts, fset, method, substeps)
        ctx.mark_non_differentiable(alive)
        return xs, alive

    @staticmethod
    def backward(ctx, g_xs, _g_alive):
        ops, c1, c2, const, x0s, ts = ctx.saved_tensors
        fset, method, substeps = ctx.config
        want_x0 = ctx.needs_input_grad[4]
        with torch.enable_grad():
            c = const.detach().requires_grad_(True)
            x0 = x0s.detach().requires_grad_(want_x0)
            trees = TreeTensors(ops, c1, c2, c).map(lambda a: a[:, None])
            p, (b, d) = ops.shape[0], x0.shape
            xs, _ = integrate(lambda t, x: evaluate_trees(trees, x[:, :, None, :], fset),
                              x0[None].expand(p, b, d), ts, method, substeps)
            grads = torch.autograd.grad(xs, (c, x0) if want_x0 else (c,), g_xs)
        dx0 = grads[1] if want_x0 else None
        return None, None, None, grads[0], dx0, None, None, None, None
