"""Closed-loop symbolic-policy rollouts per lane: kernels #6 and #7 and their
plain versions.

Counterpart of ``multitreegp_tpu/core/pallas_policy.py``. Every lane
(candidate x trajectory) integrates a control environment's plant driven by
the candidate's trees, and the rollout returns the augmented state ``[x, a]``
and the controls at every save point and the per-save liveness:

* :func:`rollout_policy` (``rollout_policy_pallas``): euler / heun / rk4 with
  ``substeps`` steps of one size ``(ts[1] - ts[0]) / substeps``; constant,
  per-trajectory ``(B,)`` or ``(B, T)`` series parameters; optional
  observation-noise rows and Euler-Maruyama kicks given as tensors. Kernel
  ``policy_kernel`` of ``csrc/policy.cu``; plain version
  :func:`policy_rollout_plain`.
* :func:`rollout_policy_adaptive` (``rollout_policy_adaptive_pallas``):
  Dopri5 / Bosh3 with the per-lane I controller and a step budget per save
  interval, ``cond_alive`` rejecting steps; per-trajectory parameters, no
  noise. Kernel ``policy_adaptive_kernel``; plain version
  :func:`policy_rollout_adaptive_plain`.

A static policy (``state_size = 0``) computes ``u = trees([y, tgt])``; a
dynamic one augments the state with ``a`` and has ``state_size`` state trees
then ``n_control`` readout trees: ``u = readout([0s(n_obs), a, 0s(n_control),
tgt])`` inside the loop, ``da = state_trees([y, a, u, tgt])``. The controls
at the save points see real observations (``u`` zero-fed).

The plant is the environment's device drift: a hand-written struct of
``csrc/control_envs.cuh`` for the seven built-in classes (by exact type,
:data:`ENV_IDS`), and for any other environment that sets
``tile_safe_drift = True`` the struct ``core/user_envs.py`` generates from
its torch methods, compiled as the one plant of a user-environment build
(``_build.env_variant``; :func:`device_plant`, :func:`policy_variant`).

CUDA tensors launch the kernel, or raise where it does not apply (an
operator outside ``DEVICE_OPS``, ``N > 256``, a candidate's decoded program
past a block's shared memory (:func:`policy_lanes_refusal`), an environment
with no device plant (not tile-safe, or a refused trace: the reason),
process noise with a method other than euler,
series parameters in the adaptive kernel); CPU tensors run the plain
version, which computes what the kernel computes in plain PyTorch, in its
float32 expression order. Nothing falls back. Each kernel has fixed
instances (``state_size <= 2``, at most two targets, device op ids up to
63: :func:`takes_fixed`) for any number of trajectories, and a wide-state
instance for any hidden state, number of targets and operator set (``csrc/tree_prog_wide.cuh``, the ``_wide``
builds): :func:`policy_rollout_wide_cuda` and
:func:`policy_rollout_adaptive_wide_cuda`, with a scratch buffer of lane
vectors that the wrapper allocates, split into launches of at most
``cuda_rollout.SCRATCH_BYTES``.

:class:`PolicyRollout` is the counterpart of the policy evaluators'
``custom_vjp``: the forward is a dispatcher, the backward differentiates the
evaluator's general path (``integrate`` or ``integrate_adaptive`` with
``evaluate_trees``: kernels #8 and #9 on CUDA) and its control replay.
"""
from __future__ import annotations

import ctypes
from typing import Optional, Tuple

import numpy as np
import torch

from .. import _build
from ..models.environments.control_envs import (
    Acrobot, Acrobot2, CartPole, ChangingHarmonicOscillator, HarmonicOscillator,
    HarmonicOscillator2, StirredTankReactor,
)
from ..models.integrators import ERROR_EXPONENT, _f32, _f32_expr, finite, substep_time
from .cuda_adaptive import CHECK_EVERY, CROSS, DT_DEAD, DT_MIN, _rk_step, _step_factor
from .cuda_adaptive import METHODS as ADAPTIVE_METHODS
from .cuda_rollout import (
    BLOCK_SHARED_BYTES, METHODS, RK_TABLES, SHARED_BYTES, THREADS_PER_BLOCK, program_bytes,
    rollout_step, wide_cpb, wide_launches,
)
from .interpreter import evaluate_trees_plain
from .registry import FIXED_MAX_OP, FunctionSet
from .trees import TreeTensors
from .user_envs import USER_ENV_ID, TracedEnv, refusal, traced

# csrc/control_envs.cuh EnvId: the exact class picks the device drift
ENV_IDS = {HarmonicOscillator: 0, ChangingHarmonicOscillator: 1, HarmonicOscillator2: 2,
           CartPole: 3, Acrobot: 4, Acrobot2: 5, StirredTankReactor: 6}
FIXED, ADAPTIVE = 0, 1  # csrc/policy.cu Kind
MAX_NODES = 256  # kMaxNodes
# The fixed instances take state_size <= 2 (kMaxStateSize, their template
# instances), at most two targets (kMaxTargets, their data slots) and a data
# vector within tree_prog.cuh's 6-bit slot; a candidate's trajectories span
# gridDim.y blocks of at most 128, so any number. Past these the wide
# instance runs.
FIXED_STATE_SIZE = 2
FIXED_TARGETS = 2
FIXED_SLOTS = 63
# the wide instance's lane vectors of latent + state_size floats per lane, by
# kind (csrc/policy.cu kFixedWideVectors, kAdaptiveWideVectors); the data
# vector's floats follow them
WIDE_VECTORS = {FIXED: 5, ADAPTIVE: 10}


def _leaves(params) -> Tuple[torch.Tensor, ...]:
    return tuple(params) if isinstance(params, (tuple, list)) else (params,)


def _series(params) -> bool:
    return any(p.dim() >= 2 for p in _leaves(params))


def param_table(params, b: int) -> torch.Tensor:
    """``(B, n_params)``: each leaf broadcast to one value per trajectory."""
    return torch.stack([p.to(torch.float32).reshape(-1).expand(b) for p in _leaves(params)], dim=-1)


def param_rows(params, b: int, t_steps: int) -> torch.Tensor:
    """``(T, B, n_params)`` rows of the streamed parameters: a series ``(B,
    T)`` transposed, a constant broadcast over T."""
    rows = [p.to(torch.float32).transpose(0, 1) if p.dim() == 2
            else p.to(torch.float32).reshape(-1).expand(b).expand(t_steps, b)
            for p in _leaves(params)]
    return torch.stack(rows, dim=-1)


def _streamed(params, t_steps: int, obs_noise_rows, process_noise_rows) -> bool:
    """Whether the parameters are interpolated between save rows: series
    parameters or any noise rows (then every parameter is, as in the TPU
    kernel), on a grid of at least two points."""
    rows = obs_noise_rows is not None or process_noise_rows is not None
    return t_steps > 1 and (_series(params) or rows)


def stage_frac(s: int, c: float, substeps: int) -> Tuple[float, float]:
    """``(frac, 1 - frac)`` of stage offset ``c`` in substep ``s``, in
    float32: ``(s + c) * (1 / substeps)``."""
    f = np.float32
    frac = f(f(s) + f(c)) * f(1.0 / substeps)
    return float(frac), float(f(1.0) - frac)


def stage_times(ts: torch.Tensor, substeps: int, method: str) -> torch.Tensor:
    """``(T-1, substeps, n_stages)`` solver times of every drift evaluation of
    the fixed-step rollout (JAX ``pallas_policy.stage_times``): ``dt = (t1 -
    t0) / substeps`` per interval, ``t0 + i*dt`` (``substep_time``), then ``t
    + c*dt`` for the stage offsets ``c``, in float32 on the host, the
    expressions the integrator's steps use, so draws at these times are the
    draws the general path makes."""
    f32 = np.float32
    t = ts.detach().cpu().numpy().astype(f32)
    t0, dtv = t[:-1], (t[1:] - t[:-1]) / f32(substeps)
    tb = substep_time(t0[:, None], np.arange(substeps)[None, :], dtv[:, None])
    offs = np.asarray([c for c, _w in RK_TABLES[method][0]], f32)
    return torch.from_numpy(tb[:, :, None] + offs * dtv[:, None, None]).to(ts.device)


class _Loop:
    """What both plain versions share: the trees split into state and
    readout trees, the closed-loop drift, the save-point controls and the
    liveness test, batched over ``(P, B)``."""

    def __init__(self, trees, x0, targets, env, fset, state_size):
        self.env, self.fset, self.ss = env, fset, state_size
        self.latent = x0.shape[1]
        batched = trees.map(lambda a: a[:, None])  # (P, 1, m, N)
        self.state_eq = batched.map(lambda a: a[..., :state_size, :])
        self.readout = batched.map(lambda a: a[..., state_size:, :])
        self.nc = trees.ops.shape[1] - state_size
        self.p, self.b = trees.ops.shape[0], x0.shape[0]
        self.tgt = targets.to(torch.float32).expand(self.p, self.b, targets.shape[-1])
        x0a = torch.cat([x0, x0.new_zeros((self.b, state_size))], dim=-1)
        self.x0 = x0a[None].expand(self.p, self.b, self.latent + state_size)

    def _eval(self, trees, *parts):
        return evaluate_trees_plain(trees, torch.cat(parts, dim=-1)[..., None, :], self.fset)

    def _observe(self, x, noise):
        xl = x[..., : self.latent]
        return self.env.obs(xl) if noise is None else self.env.obs_noisy(xl, noise)

    def drift(self, x, params, noise=None):
        y = self._observe(x, noise)
        xl = x[..., : self.latent]
        if not self.ss:
            return self.env.drift(0.0, xl, self._eval(self.readout, y, self.tgt), params)
        a = x[..., self.latent:]
        zeros_u = x.new_zeros(x.shape[:-1] + (self.nc,))
        u = self._eval(self.readout, torch.zeros_like(y), a, zeros_u, self.tgt)
        dx = self.env.drift(0.0, xl, u, params)
        return torch.cat([dx, self._eval(self.state_eq, y, a, u, self.tgt)], dim=-1)

    def controls(self, x, noise=None):
        y = self._observe(x, noise)
        if not self.ss:
            return self._eval(self.readout, y, self.tgt)
        zeros_u = x.new_zeros(x.shape[:-1] + (self.nc,))
        return self._eval(self.readout, y, x[..., self.latent:], zeros_u, self.tgt)

    def ok(self, x):
        return finite(x) & self.env.cond_alive(0.0, x[..., : self.latent])


def policy_rollout_plain(
    trees: TreeTensors, x0: torch.Tensor, ts: torch.Tensor, targets: torch.Tensor, params,
    env, fset: FunctionSet, substeps: int = 1, method: str = "rk4", state_size: int = 0,
    obs_noise_rows: Optional[torch.Tensor] = None,
    process_noise_rows: Optional[torch.Tensor] = None,
) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """Plain PyTorch version of kernel #6: ``(xs (T, P, B, latent +
    state_size), us (T, P, B, n_control), alive (T, P, B))``.

    trees ``(P, state_size + n_control, N)``; x0 ``(B, latent)``; targets
    ``(B, n_targets)``; params a tuple of ``(B,)`` or ``(B, T)`` tensors;
    ``obs_noise_rows (T, B, substeps * stages * n_obs)`` (row t: every stage
    draw of interval t, (substep, stage, obs)-major; the save-time draw of
    save t in slot (0, 0)); ``process_noise_rows (T, B, substeps * latent)``
    (euler only)."""
    t_steps = ts.shape[0]
    kicks = process_noise_rows is not None and t_steps > 1
    if kicks and method != "euler":
        raise ValueError("process noise requires Euler stepping (integrate_sde)")
    stages, _ = RK_TABLES[method]
    h, h_final = rollout_step(ts, method, substeps)
    lp = _Loop(trees, x0, targets, env, fset, state_size)
    latent, b = lp.latent, lp.b
    streamed = _streamed(params, t_steps, obs_noise_rows, process_noise_rows)
    rows = param_rows(params, b, t_steps) if streamed else None
    const = None if streamed else tuple(param_table(params, b).unbind(-1))
    n_obs = env.n_obs

    def noise(t, s, st):
        if obs_noise_rows is None or t_steps < 2:
            return None
        off = (s * len(stages) + st) * n_obs
        return obs_noise_rows[t, :, off:off + n_obs]

    x = lp.x0
    alive = lp.ok(x)
    xs, us, alives = [x], [lp.controls(x, noise(0, 0, 0))], [alive]
    for t in range(t_steps - 1):
        for s in range(substeps):
            acc, k = torch.zeros_like(x), None
            for st, (c, w) in enumerate(stages):
                par = const
                if streamed:
                    frac, keep = stage_frac(s, c, substeps)
                    par = tuple((rows[t] * keep + rows[t + 1] * frac).unbind(-1))
                x_st = x if k is None else x + _f32(h * c) * k
                k = lp.drift(x_st, par, noise(t, s, st))
                acc = acc + w * k
            x_new = x + h_final * acc
            if kicks:
                kick = process_noise_rows[t, :, s * latent:(s + 1) * latent]
                x_new = torch.cat([x_new[..., :latent] + kick, x_new[..., latent:]], dim=-1)
            alive = alive & lp.ok(x_new)
            x = torch.where(alive[..., None], x_new, x)
        xs.append(x)
        us.append(lp.controls(x, noise(t + 1, 0, 0)))
        alives.append(alive)
    return torch.stack(xs), torch.stack(us), torch.stack(alives)


def policy_rollout_adaptive_plain(
    trees: TreeTensors, x0: torch.Tensor, ts: torch.Tensor, targets: torch.Tensor, params,
    env, fset: FunctionSet, rtol: float = 1e-4, atol: float = 1e-4, max_steps: int = 16,
    method: str = "dopri5", safety: float = 0.9, state_size: int = 0,
) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor, torch.Tensor]:
    """Plain PyTorch version of kernel #7: ``(xs, us, alive, lane_steps
    (P, B))``. Kernel #4's per-interval controller on the closed loop, with
    ``cond_alive`` rejecting a step (not killing the lane), liveness starting
    as finite & ``cond_alive``, and the error norm over the augmented state;
    ``lane_steps`` counts every lane's attempted steps."""
    if method not in ADAPTIVE_METHODS:
        raise ValueError(f"unknown adaptive method {method!r}: {sorted(ADAPTIVE_METHODS)}")
    if _series(params):
        raise ValueError("the adaptive policy rollout takes constant parameters only")
    lp = _Loop(trees, x0, targets, env, fset, state_size)
    const = tuple(param_table(params, lp.b).unbind(-1))
    drift = lambda x: lp.drift(x, const)
    rtol, atol, safety, expo = _f32(rtol), _f32(atol), _f32(safety), ERROR_EXPONENT[method]
    times = ts.tolist()
    x = lp.x0
    alive = lp.ok(x)
    xs, us, alives = [x], [lp.controls(x)], [alive]
    steps = torch.zeros(alive.shape, dtype=torch.int32, device=x.device)
    if len(times) > 1:
        k1 = drift(x)
        dt0 = _f32_expr(lambda f: (f(times[1]) - f(times[0])) / f(4.0))
        dt = torch.full(alive.shape, dt0, dtype=torch.float32, device=x.device)
    for i in range(len(times) - 1):
        t0, t1 = times[i], times[i + 1]
        span = _f32_expr(lambda f: f(t1) - f(t0))
        dt_lo = _f32_expr(lambda f: f(span) * f(DT_MIN))
        dt_dead = _f32_expr(lambda f: f(span) * f(DT_DEAD))
        inside = _f32_expr(lambda f: f(t1) - f(CROSS))
        reached = _f32_expr(lambda f: f(t1) - f(1e-9) * max(abs(f(t1)), f(1.0)))
        t = torch.full_like(dt, t0)
        dt = torch.clamp(dt, dt_lo, span)
        for s in range(max_steps):
            active = alive & (t < inside)
            if s % CHECK_EVERY == 0 and not bool(active.any()):
                break
            dt_c = torch.minimum(dt, t1 - t)
            x_hi, err, k_last = _rk_step(drift, method, x, k1, dt_c, rtol, atol)
            ok = finite(x_hi) & torch.isfinite(err)
            accept = active & ok & (err <= 1.0) & env.cond_alive(0.0, x_hi[..., : lp.latent])
            x = torch.where(accept[..., None], x_hi, x)
            k1 = torch.where(accept[..., None], k_last, k1)
            t = torch.where(accept, t + dt_c, t)
            steps += active.int()
            factor = _step_factor(err, ok, safety, expo)
            dt = torch.where(active, torch.clamp(dt_c * factor, dt_lo, span), dt)
            alive = alive & (ok | ~active | (dt_c > dt_dead))
        alive = alive & (t >= reached)
        xs.append(x)
        us.append(lp.controls(x))
        alives.append(alive)
    return torch.stack(xs), torch.stack(us), torch.stack(alives), steps


# ---------------------------------------------------------------- kernels

_ARG_POINTERS = ("ops", "cst", "devop", "x0", "tgt", "par", "obs_rows", "kick_rows", "ts", "xs",
                 "us", "alive", "steps")
_ARG_INTS = ("env", "state_size", "P", "m", "n", "B", "T", "var_start", "n_obs", "n_targets",
             "method", "substeps", "streamed", "k_obs", "max_steps")
_ARG_FLOATS = ("h_half", "h_full", "h_final", "inv_sub", "rtol", "atol", "safety")


class _Args(ctypes.Structure):
    """csrc/policy.cu ``PolicyArgs``, field for field."""

    _fields_ = ([(f, ctypes.c_void_p) for f in _ARG_POINTERS] + [(f, ctypes.c_int) for f in _ARG_INTS]
                + [(f, ctypes.c_float) for f in _ARG_FLOATS])


def plant_refusal(env, params) -> Optional[str]:
    """Why the kernels have no plant for ``env``, or None: a built-in class
    has its hand-written one, any other environment a plant traced from its
    methods unless it is not tile-safe or its trace is refused
    (``user_envs.refusal``; ``params``: their structure is traced)."""
    return None if type(env) in ENV_IDS else refusal(env, params)


def device_plant(env, params) -> Tuple[int, Optional[TracedEnv]]:
    """The plant the kernels run for ``env``: ``(its id in
    csrc/control_envs.cuh, None)`` for a built-in class, ``(USER_ENV_ID,
    its generated plant)`` for any other; raises ``NotImplementedError``
    with :func:`plant_refusal`'s reason where there is none."""
    reason = plant_refusal(env, params)
    if reason is not None:
        raise NotImplementedError(f"no device plant: {reason}")
    if type(env) in ENV_IDS:
        return ENV_IDS[type(env)], None
    return USER_ENV_ID, traced(env, params)


def policy_variant(env, params, fset: FunctionSet):
    """The build of ``csrc/policy.cu`` that runs ``env``'s plant with
    ``fset``'s operators (a fixed instance's; ``_build.widened`` of it for
    the wide one): the set's own build for a built-in plant, its
    user-environment form for a generated one."""
    _, plant = device_plant(env, params)
    return fset.variant if plant is None else _build.env_variant(fset.variant, plant.header)


def obs_width(env) -> int:
    """The observation's floats in the kernels' data vector: the latent
    size for a built-in plant (its first ``n_obs`` are read), ``n_obs`` for a
    generated one."""
    return env.latent_size if type(env) in ENV_IDS else env.n_obs


def data_width(env, state_size: int, n_targets: int) -> int:
    """Length of the kernels' data vector ``[y (obs_width), a (state_size),
    u (n_control), targets (n_targets)]``."""
    return obs_width(env) + state_size + env.n_control + n_targets


def data_slots(env, fset: FunctionSet, state_size: int) -> torch.Tensor:
    """int32 slot of every variable in the kernels' data vector ``[y
    (obs_width), a (state_size), u (n_control), targets (n_targets)]``: the
    policy's variables are ``[y (n_obs), tgt]`` (static) or ``[y, a, u,
    tgt]`` (dynamic); a variable past that width gets the slot past the
    vector, which reads 0."""
    ow, nc, n_obs, nt = obs_width(env), env.n_control, env.n_obs, env.n_targets
    width = n_obs + (state_size + nc if state_size else 0) + nt
    slots = []
    for v in range(fset.num_variables):
        if v < n_obs:
            slots.append(v)
        elif v < n_obs + state_size:
            slots.append(ow + v - n_obs)
        elif state_size and v < n_obs + state_size + nc:
            slots.append(ow + v - n_obs)
        elif v < width:
            slots.append(ow + state_size + nc + v - (width - nt))
        else:
            slots.append(data_width(env, state_size, nt))
    return torch.tensor(slots, dtype=torch.int32)


def takes_fixed(env, state_size: int, n_targets: int, max_op: int) -> bool:
    """Whether the fixed instances take ``state_size`` hidden states,
    ``n_targets`` targets and device op ids up to ``max_op`` (else the wide
    instance runs): their template instances, their target slots, and every
    data slot (the zero slot past the vector included) and op id within
    ``tree_prog.cuh``'s 6-bit field."""
    return (state_size <= FIXED_STATE_SIZE and n_targets <= FIXED_TARGETS
            and data_width(env, state_size, n_targets) <= FIXED_SLOTS and max_op <= FIXED_MAX_OP)


def policy_lanes_refusal(m: int, n: int) -> Optional[str]:
    """Why the policy kernels (#6, #7) do not take candidates of ``m`` trees
    of ``n`` rows, or None when they do, from the configuration alone (the
    evaluators' gate; on the CPU too): ``N <= 256``, and one candidate's
    decoded program within a block's shared memory. Any hidden state, number
    of targets and number of trajectories run, the wide instance past the
    fixed ones (:func:`takes_fixed`)."""
    if n > MAX_NODES:
        return f"max_nodes {n} > {MAX_NODES}, the policy kernels' limit"
    if program_bytes(m, n) > BLOCK_SHARED_BYTES:
        return (f"one candidate's {m} trees of {n} rows take {program_bytes(m, n)} B of decoded "
                f"rows > the {BLOCK_SHARED_BYTES} B of shared memory a block holds")
    return None


def check_policy(trees: TreeTensors, x0, targets, params, env, fset: FunctionSet,
                 state_size: int) -> int:
    """Raise unless the policy kernels take these operands; returns the
    plant's id (:func:`device_plant`)."""
    p, m, n = trees.ops.shape
    env_id, _ = device_plant(env, params)
    if state_size < 0 or m != state_size + env.n_control:
        raise ValueError(f"{m} trees for state_size {state_size} + {env.n_control} controls")
    reason = policy_lanes_refusal(m, n)
    if reason is not None:
        raise NotImplementedError(reason)
    if x0.dim() != 2 or x0.shape[-1] != env.latent_size:
        raise ValueError(f"x0 {tuple(x0.shape)}: expected (B, {env.latent_size})")
    fset.require_device_ops()
    return env_id


def run_policy(launch, kind: int, trees: TreeTensors, x0, ts, targets, params, env,
               fset: FunctionSet, state_size: int = 0, method: str = "rk4", substeps: int = 1,
               obs_noise_rows=None, process_noise_rows=None, max_steps: int = 0,
               rtol: float = 0.0, atol: float = 0.0, safety: float = 0.0, wide: bool = False):
    """Build the operands of ``csrc/policy.cu`` and call ``launch(args)``
    (a fixed instance: the CUDA launcher, or the host build on CPU tensors),
    or with ``wide`` ``launch(args, scratch, c0, count)`` once per part of
    :func:`cuda_rollout.wide_launches` (the wide instance; ``scratch`` its
    lane vectors, allocated here): returns ``(status, xs, us, alive count
    (P, B), steps (P, B))``, ``status`` the first non-zero one. The fixed
    instances refuse what :func:`takes_fixed` does not admit. ``launch``
    is the build of :func:`policy_variant`'s: the plant's id goes in the
    operands."""
    env_id = check_policy(trees, x0, targets, params, env, fset, state_size)
    if not wide and not takes_fixed(env, state_size, targets.shape[-1], fset.max_device_op):
        raise NotImplementedError(
            f"state_size {state_size}, {targets.shape[-1]} targets and device op id "
            f"{fset.max_device_op}: the fixed instances take state_size <= {FIXED_STATE_SIZE}, <= "
            f"{FIXED_TARGETS} targets and ids <= {FIXED_MAX_OP}; the wide one takes any")
    dev = trees.ops.device
    p, m, n = trees.ops.shape
    b, t_steps = x0.shape[0], ts.shape[0]
    kicks = process_noise_rows is not None and t_steps > 1
    obs = obs_noise_rows is not None and t_steps > 1
    if kind == FIXED and kicks and method != "euler":
        raise ValueError("process noise requires Euler stepping (integrate_sde)")
    if kind == ADAPTIVE and (_series(params) or obs_noise_rows is not None
                             or process_noise_rows is not None):
        raise ValueError("the adaptive policy kernel takes constant parameters and no noise rows")
    streamed = kind == FIXED and _streamed(params, t_steps, obs_noise_rows, process_noise_rows)
    slots = data_slots(env, fset, state_size).to(dev)
    var = trees.ops - fset.var_start
    ops = torch.where(var >= 0, fset.var_start + slots[var.clamp(0, slots.shape[0] - 1).long()],
                      trees.ops).to(torch.int32).contiguous()
    f32c = lambda t: t.to(device=dev, dtype=torch.float32).contiguous()
    t = dict(ops=ops, cst=f32c(trees.const), devop=fset.device_ops(dev), x0=f32c(x0),
             tgt=f32c(targets) if targets.shape[-1] else torch.zeros(1, device=dev),
             par=f32c(param_rows(params, b, t_steps) if streamed else param_table(params, b)),
             ts=f32c(ts))
    if obs:
        t["obs_rows"] = f32c(obs_noise_rows)
    if kicks:
        t["kick_rows"] = f32c(process_noise_rows)
    d_aug, nc = x0.shape[1] + state_size, m - state_size
    t["xs"] = torch.empty((t_steps, p, b, d_aug), dtype=torch.float32, device=dev)
    t["us"] = torch.empty((t_steps, p, b, nc), dtype=torch.float32, device=dev)
    t["alive"] = torch.empty((p, b), dtype=torch.int32, device=dev)
    t["steps"] = torch.zeros((p, b), dtype=torch.int32, device=dev)
    args = _Args(**{k: v.data_ptr() for k, v in t.items()})
    if kind == FIXED:
        h, h_final = rollout_step(ts, method, substeps)
        stages = len(RK_TABLES[method][0])
        args.method, args.substeps = METHODS[method], substeps
        args.h_half, args.h_full, args.h_final = _f32(h * 0.5), _f32(h), h_final
        args.inv_sub = _f32(1.0 / substeps)
        args.k_obs = obs_noise_rows.shape[-1] if obs else 0
        if obs and args.k_obs != substeps * stages * env.n_obs:
            raise ValueError(f"obs noise rows of width {args.k_obs}: expected substeps x stages x n_obs")
    else:
        args.method, args.max_steps = ADAPTIVE_METHODS[method], max_steps
        args.rtol, args.atol, args.safety = _f32(rtol), _f32(atol), _f32(safety)
    args.env, args.state_size, args.P, args.m, args.n, args.B, args.T = (
        env_id, state_size, p, m, n, b, t_steps)
    args.var_start, args.n_obs, args.n_targets = fset.var_start, env.n_obs, targets.shape[-1]
    args.streamed = int(streamed)
    status = 0
    if p * b and not wide:
        status = launch(ctypes.byref(args))
    elif p * b:
        per_lane = WIDE_VECTORS[kind] * d_aug + data_width(env, state_size, targets.shape[-1])
        parts = wide_launches(p, b, per_lane, 1)
        scratch = torch.empty(per_lane * parts[0][1] * b, dtype=torch.float32, device=dev)
        for c0, count in parts:
            status = launch(ctypes.byref(args), scratch.data_ptr(), c0, count)
            if status:
                break
    return status, t["xs"], t["us"], t["alive"], t["steps"]


def _alive_rows(count: torch.Tensor, t_steps: int) -> torch.Tensor:
    """Per-save liveness ``(T, P, B)`` from the count of alive save rows."""
    return torch.arange(t_steps, device=count.device)[:, None, None] < count[None]


def _cuda_launch(kind: int, trees: TreeTensors, b: int, env, params, fset: FunctionSet, wrapper,
                 wide: bool):
    """The launcher :func:`run_policy` calls on CUDA tensors: each launch of
    the library of :func:`policy_variant` (its ``_wide`` form for the wide
    instance) checked, then counted in ``wrapper.launches``."""
    dev = trees.ops.device
    if dev.type != "cuda":
        raise ValueError(f"the policy kernels take CUDA tensors, got {dev}")
    m, n = trees.ops.shape[1:]
    stream = torch.cuda.current_stream(dev).cuda_stream
    variant = policy_variant(env, params, fset)
    if wide:
        lib = _build.load("policy", _build.widened(variant))
        fn = lib.policy_wide_launch
        fn.argtypes = [ctypes.c_int, ctypes.c_void_p, ctypes.c_void_p] + [ctypes.c_int] * 3 + [ctypes.c_void_p]
        cpb = wide_cpb(b, m, n)
    else:
        lib = _build.load("policy", variant)
        fn = lib.policy_launch
        fn.argtypes = [ctypes.c_int, ctypes.c_void_p, ctypes.c_int, ctypes.c_void_p]
        # a candidate's shared memory: m decoded programs of n 8-byte rows and
        # their first live rows (csrc/tree_prog.cuh program_smem)
        cpb = max(1, min(THREADS_PER_BLOCK // b, SHARED_BYTES // (m * (n * 8 + 4))))
    fn.restype = ctypes.c_int
    what = f"{'adaptive ' if kind == ADAPTIVE else ''}policy{' wide' if wide else ''} kernel launch"

    def launch(args, *part):  # part: the wide instance's scratch, c0, count
        _build.check(lib, fn(kind, args, *part, cpb, stream), what)
        wrapper.launches += 1
        return 0
    return launch


def _fixed_launch(wrapper, wide: bool, trees, x0, ts, targets, params, env, fset, substeps, method,
                  state_size, obs_noise_rows, process_noise_rows):
    """Kernel #6 in the instance ``wide`` names, counted in ``wrapper``."""
    if method not in METHODS:
        raise NotImplementedError(f"method {method!r}: the fixed-step kernel has {sorted(METHODS)}")
    if substeps < 1:
        raise ValueError("substeps must be >= 1")
    launch = _cuda_launch(FIXED, trees, x0.shape[0], env, params, fset, wrapper, wide)
    _, xs, us, count, _ = run_policy(
        launch, FIXED, trees, x0, ts, targets, params, env, fset, state_size, method, substeps,
        obs_noise_rows, process_noise_rows, wide=wide)
    return xs, us, _alive_rows(count, ts.shape[0])


def _adaptive_launch(wrapper, wide: bool, trees, x0, ts, targets, params, env, fset, rtol, atol,
                     max_steps, method, safety, state_size):
    """Kernel #7 in the instance ``wide`` names, counted in ``wrapper``."""
    if method not in ADAPTIVE_METHODS:
        raise ValueError(f"unknown adaptive method {method!r}: {sorted(ADAPTIVE_METHODS)}")
    if max_steps < 0:
        raise ValueError(f"step budget {max_steps} < 0")
    launch = _cuda_launch(ADAPTIVE, trees, x0.shape[0], env, params, fset, wrapper, wide)
    _, xs, us, count, steps = run_policy(
        launch, ADAPTIVE, trees, x0, ts, targets, params, env, fset, state_size, method,
        max_steps=max_steps, rtol=rtol, atol=atol, safety=safety, wide=wide)
    return xs, us, _alive_rows(count, ts.shape[0]), steps


def policy_rollout_cuda(
    trees: TreeTensors, x0: torch.Tensor, ts: torch.Tensor, targets: torch.Tensor, params,
    env, fset: FunctionSet, substeps: int = 1, method: str = "rk4", state_size: int = 0,
    obs_noise_rows: Optional[torch.Tensor] = None,
    process_noise_rows: Optional[torch.Tensor] = None,
) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """Launch ``policy_kernel``; ``(xs, us, alive)`` as the plain version: a
    fixed instance, or past them (:func:`takes_fixed`)
    :func:`policy_rollout_wide_cuda`."""
    args = (trees, x0, ts, targets, params, env, fset, substeps, method, state_size,
            obs_noise_rows, process_noise_rows)
    if not takes_fixed(env, state_size, targets.shape[-1], fset.max_device_op):
        return policy_rollout_wide_cuda(*args)
    return _fixed_launch(policy_rollout_cuda, False, *args)


policy_rollout_cuda.launches = 0


def policy_rollout_wide_cuda(
    trees: TreeTensors, x0: torch.Tensor, ts: torch.Tensor, targets: torch.Tensor, params,
    env, fset: FunctionSet, substeps: int = 1, method: str = "rk4", state_size: int = 0,
    obs_noise_rows: Optional[torch.Tensor] = None,
    process_noise_rows: Optional[torch.Tensor] = None,
) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """Launch the wide instance of ``csrc/policy.cu``'s fixed-step kernel
    (the ``_wide`` build of the set's library; any hidden state, targets and
    trajectories within :func:`policy_lanes_refusal`); ``(xs, us, alive)``.
    One launch per :func:`cuda_rollout.wide_launches` part, each counted."""
    return _fixed_launch(policy_rollout_wide_cuda, True, trees, x0, ts, targets, params, env, fset,
                         substeps, method, state_size, obs_noise_rows, process_noise_rows)


policy_rollout_wide_cuda.launches = 0


def policy_rollout_adaptive_cuda(
    trees: TreeTensors, x0: torch.Tensor, ts: torch.Tensor, targets: torch.Tensor, params,
    env, fset: FunctionSet, rtol: float = 1e-4, atol: float = 1e-4, max_steps: int = 16,
    method: str = "dopri5", safety: float = 0.9, state_size: int = 0,
) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor, torch.Tensor]:
    """Launch ``policy_adaptive_kernel``; ``(xs, us, alive, lane_steps)``: a
    fixed instance, or past them :func:`policy_rollout_adaptive_wide_cuda`."""
    args = (trees, x0, ts, targets, params, env, fset, rtol, atol, max_steps, method, safety,
            state_size)
    if not takes_fixed(env, state_size, targets.shape[-1], fset.max_device_op):
        return policy_rollout_adaptive_wide_cuda(*args)
    return _adaptive_launch(policy_rollout_adaptive_cuda, False, *args)


policy_rollout_adaptive_cuda.launches = 0


def policy_rollout_adaptive_wide_cuda(
    trees: TreeTensors, x0: torch.Tensor, ts: torch.Tensor, targets: torch.Tensor, params,
    env, fset: FunctionSet, rtol: float = 1e-4, atol: float = 1e-4, max_steps: int = 16,
    method: str = "dopri5", safety: float = 0.9, state_size: int = 0,
) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor, torch.Tensor]:
    """Launch the wide instance of ``policy_adaptive_kernel``; ``(xs, us,
    alive, lane_steps)``, each part's launch counted."""
    return _adaptive_launch(policy_rollout_adaptive_wide_cuda, True, trees, x0, ts, targets, params,
                            env, fset, rtol, atol, max_steps, method, safety, state_size)


policy_rollout_adaptive_wide_cuda.launches = 0


def rollout_policy(
    trees: TreeTensors, x0: torch.Tensor, ts: torch.Tensor, targets: torch.Tensor, params,
    env, fset: FunctionSet, substeps: int = 1, method: str = "rk4", state_size: int = 0,
    obs_noise_rows: Optional[torch.Tensor] = None,
    process_noise_rows: Optional[torch.Tensor] = None,
) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """The fixed-step closed loop, ``(xs (T, P, B, d_aug), us (T, P, B,
    n_control), alive (T, P, B))``: kernel #6 for CUDA tensors, the plain
    version for CPU tensors."""
    dev = trees.ops.device
    args = (trees, x0, ts, targets, params, env, fset, substeps, method, state_size,
            obs_noise_rows, process_noise_rows)
    if dev.type == "cuda":
        return policy_rollout_cuda(*args)
    if dev.type == "cpu":
        if method not in METHODS:
            raise NotImplementedError(f"method {method!r}: the fixed-step rollout has {sorted(METHODS)}")
        return policy_rollout_plain(*args)
    raise NotImplementedError(f"no policy rollout for device {dev}")


def rollout_policy_adaptive(
    trees: TreeTensors, x0: torch.Tensor, ts: torch.Tensor, targets: torch.Tensor, params,
    env, fset: FunctionSet, rtol: float = 1e-4, atol: float = 1e-4, max_steps: int = 16,
    method: str = "dopri5", safety: float = 0.9, state_size: int = 0,
    return_steps: bool = False,
):
    """The adaptive closed loop, ``(xs, us, alive)`` (and ``lane_steps (P,
    B)`` with ``return_steps``: per lane, where the JAX function reports per
    tile): kernel #7 for CUDA tensors, the plain version for CPU tensors."""
    dev = trees.ops.device
    args = (trees, x0, ts, targets, params, env, fset, rtol, atol, max_steps, method, safety,
            state_size)
    if dev.type == "cuda":
        out = policy_rollout_adaptive_cuda(*args)
    elif dev.type == "cpu":
        out = policy_rollout_adaptive_plain(*args)
    else:
        raise NotImplementedError(f"no adaptive policy rollout for device {dev}")
    return out if return_steps else out[:3]


class PolicyRollout(torch.autograd.Function):
    """A fused policy rollout differentiable in ``const``: ``fused(trees) ->
    (xs, us, alive)`` is the forward (a dispatcher: kernel #6 or #7 on
    CUDA); the backward differentiates ``recompute(trees) -> (xs, us)``, the
    evaluator's general path and control replay (``evaluate_trees`` as the
    drift: kernels #8 and #9 on CUDA). No gradient goes to ``ops``, ``c1``,
    ``c2`` or through ``alive``. Apply as ``PolicyRollout.apply(ops, c1, c2,
    const, fused, recompute)``."""

    @staticmethod
    def forward(ctx, ops, c1, c2, const, fused, recompute):
        ctx.save_for_backward(ops, c1, c2, const)
        ctx.recompute = recompute
        xs, us, alive = fused(TreeTensors(ops, c1, c2, const))
        ctx.mark_non_differentiable(alive)
        return xs, us, alive

    @staticmethod
    def backward(ctx, g_xs, g_us, _g_alive):
        ops, c1, c2, const = ctx.saved_tensors
        with torch.enable_grad():
            c = const.detach().requires_grad_(True)
            xs, us = ctx.recompute(TreeTensors(ops, c1, c2, c))
            (dconst,) = torch.autograd.grad((xs, us), (c,), (g_xs, g_us), allow_unused=True)
        if dconst is None:
            dconst = torch.zeros_like(const)
        return None, None, None, dconst, None, None
