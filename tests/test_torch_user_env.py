"""PyTorch port: user control environments in the policy kernels #6/#7.

JAX's policy kernels trace any environment whose class sets
``tile_safe_drift = True``; the port traces such an environment's torch
methods into a generated plant (``core/user_envs.py``) that
``csrc/policy.cu`` compiles as the one plant of its user-environment build
(``_build.env_variant``). Two user environments:

* ``Pendulum``: Gym's ``Pendulum-v1`` (``gym/envs/classic_control/
  pendulum.py``) as an ODE: state ``(theta, theta_dot)``, drift ``(theta_dot,
  3 g / (2 l) sin(theta) + 3 / (m l^2) clip(u, -2, 2))``, parameters ``(g,
  m, l)``, observation ``[cos theta, sin theta, theta_dot]`` (three floats
  from two states), cost ``angle_normalize(theta)^2 + 0.1 theta_dot^2 +
  0.001 u^2`` summed over the save grid (Gym's discrete speed clip is not an
  ODE term and is left out);
* ``Quadrotor2D``: safe-control-gym's planar quadrotor, state ``(x, x_dot,
  z, z_dot, theta, theta_dot)``, two thrusts, ``x'' = sin(theta) (T1 + T2) /
  m``, ``z'' = cos(theta) (T1 + T2) / m - g``, ``theta'' = (T2 - T1) L /
  Iyy`` (m = 0.027, Iyy = 1.4e-5, L = 0.0397, g = 9.8), two targets ``(x*,
  z*)``, ``cond_alive`` ``z > 0``;

and ``TracedAcrobot``, a subclass of ``Acrobot`` that changes nothing, so it
takes the traced build beside the built-in's hand-written struct.

On the CPU:

* trace and emit: the header's struct, the same text (and hash) on a second
  trace, the cache per instance, and ``chip_smoke.py``'s Pendulum traces to
  the same header;
* refusals: a constant matrix (``x @ A``), Python ``if`` on a value, a
  reduction; each environment takes the general path with the reason kept
  in ``env_refusal``, and the wrappers raise;
* the surface: ``tile_safe_drift`` equals the JAX package's on the base and
  each built-in class; ``_fused_kind`` routes a built-in, a tile-safe user
  environment, a non-tile-safe one and a refused one;
* the host build (``g++``) of ``policy.cu`` with each generated plant
  against the plain versions, bit for bit on every lane (states, controls,
  alive count, attempted steps), the C library's math patched into PyTorch
  (``test_torch_kernels.patch_host_math``): #6 static and dynamic
  (``state_size=2``), #7, the wide instance at ``state_size=4``, the Switch
  series and observation-noise rows;
* the traced Acrobot's host build equal to the hand-written Acrobot's;
* the evaluators against JAX's (``StaticPolicyEvaluator`` /
  ``DynamicPolicyEvaluator`` with ``interpreter="gather"``, its general path
  on the CPU) on the same data and population, carried across by
  ``convert.py``. ROADMAP.md's tolerances: at short horizon (T = 6) every
  fitness within 1e-6 relative of JAX's; at T = 26 identical clamping at
  ``max_fitness`` and a survivor Spearman >= 0.997 (XLA:CPU contracts the
  RK updates into FMAs and has its own ``sin``/``cos``, so long rollouts
  part by ulps that the plants amplify).

On the card (marker ``cuda``): each user-environment instance against its
plain version on every lane with the launch counters, the evaluators
through one launch of a ``policy_e<hash12>`` build, and the traced Acrobot
beside the built-in one. JAX is imported only inside the tests that use it,
so the card's run (``pytest --noconftest -m cuda``, no JAX there) imports
this file.
"""
import ctypes
import math
import shutil

import numpy as np
import pytest
import torch

from multitreegp_tpu_torch import _build
from multitreegp_tpu_torch.core import cuda_policy as cp
from multitreegp_tpu_torch.core import user_envs
from multitreegp_tpu_torch.core.registry import build_function_set
from multitreegp_tpu_torch.models import environments as tenvs
from multitreegp_tpu_torch.models.environments.base import ControlEnvironmentBase, time_varying
from multitreegp_tpu_torch.models.environments.control_envs import _decay_series, _switch_series
from multitreegp_tpu_torch.models.evaluators import (
    DynamicPolicyEvaluator, StaticPolicyEvaluator, generate_control_data,
)
from multitreegp_tpu_torch.ops.initialization import make_population_sampler
from test_torch_kernels import patch_host_math, same_bits

torch.set_num_threads(1)

PI = math.pi
OPS = [("+", 2), ("-", 2), ("*", 2), ("sin", 1), ("cos", 1)]
PENDULUM_RANGES = ((8.0, 12.0), (0.8, 1.2), (0.8, 1.2))  # g, m, l away from Constant


def _uniform(shape, g, lo, hi):
    return lo + (hi - lo) * torch.rand(shape, generator=g, device=g.device)


class Pendulum(ControlEnvironmentBase):
    """Gym's ``Pendulum-v1`` as a controlled ODE (see the module docstring)."""

    tile_safe_drift = True

    def __init__(self, process_noise: float = 0.0, obs_noise: float = 0.0):
        super().__init__(process_noise, obs_noise, n_var=2, n_control=1, n_dim=1, n_obs=3)
        self.max_torque = 2.0

    def sample_init_states(self, batch_size, generator):
        x0 = torch.stack([_uniform((batch_size,), generator, -PI, PI),
                          _uniform((batch_size,), generator, -1.0, 1.0)], dim=-1)
        return x0, torch.zeros((batch_size, 0), device=generator.device)

    def sample_params(self, batch_size, mode, ts, generator):
        if mode == "Constant":
            ones = torch.ones(batch_size, device=ts.device)
            return 10.0 * ones, ones, ones
        series = dict(Different=lambda lo, hi: _uniform((batch_size,), generator, lo, hi),
                      Switch=lambda lo, hi: _switch_series(generator, batch_size, ts, lo, hi),
                      Decay=lambda lo, hi: _decay_series(generator, batch_size, ts, lo, hi))[mode]
        return tuple(series(lo, hi) for lo, hi in PENDULUM_RANGES)

    def params_at(self, params, ts, t):
        return tuple(time_varying(p, ts, t) for p in params)

    def drift(self, t, x, u, params):
        g, m, l = params
        torque = torch.clamp(u[..., 0], -self.max_torque, self.max_torque)
        theta_acc = 3.0 * g / (2.0 * l) * torch.sin(x[..., 0]) + 3.0 / (m * l * l) * torque
        return torch.stack([x[..., 1], theta_acc], dim=-1)

    def obs(self, x):
        return torch.stack([torch.cos(x[..., 0]), torch.sin(x[..., 0]), x[..., 1]], dim=-1)

    def fitness(self, xs, us, targets, ts, params):
        theta = torch.remainder(xs[..., 0] + PI, 2 * PI) - PI  # Gym's angle_normalize
        u = torch.clamp(us[..., 0], -self.max_torque, self.max_torque)
        return (theta * theta + 0.1 * (xs[..., 1] * xs[..., 1]) + 0.001 * (u * u)).sum(dim=-1)


class Quadrotor2D(ControlEnvironmentBase):
    """safe-control-gym's planar quadrotor (see the module docstring);
    parameter: the mass."""

    tile_safe_drift = True
    n_targets = 2

    def __init__(self, process_noise: float = 0.0, obs_noise: float = 0.0):
        super().__init__(process_noise, obs_noise, n_var=6, n_control=2, n_dim=1, n_obs=6)
        self.g, self.iyy, self.arm, self.max_thrust = 9.8, 1.4e-5, 0.0397, 0.2

    def sample_init_states(self, batch_size, generator):
        zero = torch.zeros(batch_size, device=generator.device)
        x0 = torch.stack([_uniform((batch_size,), generator, -0.5, 0.5), zero,
                          _uniform((batch_size,), generator, 0.5, 1.5), zero,
                          _uniform((batch_size,), generator, -0.1, 0.1), zero], dim=-1)
        targets = torch.stack([_uniform((batch_size,), generator, -1.0, 1.0),
                               _uniform((batch_size,), generator, 0.5, 1.5)], dim=-1)
        return x0, targets

    def sample_params(self, batch_size, mode, ts, generator):
        if mode == "Constant":
            return (torch.full((batch_size,), 0.027, device=ts.device),)
        return (_uniform((batch_size,), generator, 0.02, 0.035),)

    def drift(self, t, x, u, params):
        (mass,) = params
        thrust = torch.clamp(u, 0.0, self.max_thrust)
        t1, t2 = thrust.unbind(-1)
        theta = x[..., 4]
        lift = (t1 + t2) / mass
        return torch.stack([x[..., 1], torch.sin(theta) * lift, x[..., 3],
                            torch.cos(theta) * lift - self.g, x[..., 5],
                            (t2 - t1) * (self.arm / self.iyy)], dim=-1)

    def cond_alive(self, t, x):
        return x[..., 2] > 0.0

    def fitness(self, xs, us, targets, ts, params):
        dx = xs[..., 0] - targets[..., 0][..., None]
        dz = xs[..., 2] - targets[..., 1][..., None]
        return (dx * dx + dz * dz + 0.01 * (xs[..., 4] * xs[..., 4])).sum(dim=-1)


class VectorPendulum(Pendulum):
    """The Pendulum's drift written on vectors of the state axis: slices,
    ``v[..., None]`` (a width-1 vector broadcast along the axis),
    ``squeeze``, ``cat``."""

    def drift(self, t, x, u, params):
        g, m, l = params
        torque = torch.clamp(u, -self.max_torque, self.max_torque).squeeze(-1)
        coef = (3.0 * g / (2.0 * l))[..., None]
        acc = coef * torch.sin(x[..., :1]) + (3.0 / (m * l * l) * torque)[..., None]
        return torch.cat([x[..., 1:], acc], dim=-1)


class TracedAcrobot(tenvs.Acrobot):
    """The built-in Acrobot under another class: the traced build."""


class MatrixPendulum(Pendulum):
    """Refused: a matmul with a constant matrix."""

    def drift(self, t, x, u, params):
        return x @ torch.tensor([[0.0, -1.0], [1.0, 0.0]]) + u


class BranchingPendulum(Pendulum):
    """Refused: Python control flow on a value."""

    def drift(self, t, x, u, params):
        return super().drift(t, x, u, params) if bool((x[..., 0] > 0).all()) else -x


class SummingPendulum(Pendulum):
    """Refused: a reduction over the state axis."""

    def drift(self, t, x, u, params):
        return super().drift(t, x, u, params) * x.sum(dim=-1, keepdim=True)


class UntracedPendulum(Pendulum):
    """Not tile-safe: always the general path."""

    tile_safe_drift = False


REFUSED = [(MatrixPendulum, "tensor constant"), (BranchingPendulum, "does not trace"),
           (SummingPendulum, "reduces")]


def policy_case(env, state_size=0, pop=6, b=4, t_steps=6, n=30, depth=4, mode="Constant", dt=0.05,
                seed=0):
    """``(fset, data, trees)``: ``pop`` policies of ``n`` rows grown to
    ``depth`` on ``b`` trajectories of ``generate_control_data`` at ``ts = 0,
    dt, ...`` (the port's generator, seeded)."""
    ys = [f"y{i}" for i in range(env.n_obs)]
    tg = [f"tgt{i}" for i in range(env.n_targets)]
    if state_size:
        a, u = [f"a{i}" for i in range(state_size)], [f"u{i}" for i in range(env.n_control)]
        fset = build_function_set(OPS, [ys + a + u + tg, a + tg], [state_size, env.n_control])
    else:
        fset = build_function_set(OPS, [ys + tg], [env.n_control])
    g = torch.Generator().manual_seed(seed)
    ts = torch.arange(t_steps, dtype=torch.float32) * dt
    data = generate_control_data(env, g, ts, batch_size=b, param_mode=mode)
    trees = make_population_sampler(fset, depth, n)(g, pop)[0]
    return fset, data, trees


# ------------------------------------------------------- trace and emit

@pytest.mark.parametrize("cls,sizes", [(Pendulum, (2, 1, 3, 3)), (Quadrotor2D, (6, 2, 1, 6)),
                                       (TracedAcrobot, (4, 1, 4, 4)), (VectorPendulum, (2, 1, 3, 3))])
def test_trace_emits_one_struct(cls, sizes):
    env = cls()
    _fset, data, _trees = policy_case(env, b=2)
    plant = user_envs.traced(env, data[5])
    assert isinstance(plant, user_envs.TracedEnv), plant
    assert (plant.latent, plant.controls, plant.params, plant.obs) == sizes
    latent, nc, n_par, n_obs = sizes
    h = plant.header
    assert "struct UserEnv" in h and "kTraced = true" in h
    assert f"kLatent = {latent}, kControls = {nc}, kParams = {n_par}, kObs = {n_obs};" in h
    assert all(f"dx[{q}] = " in h for q in range(latent))
    assert all(f"y[{q}] = " in h for q in range(n_obs))
    assert user_envs.traced(env, data[5]) is plant  # cached per instance
    again = user_envs.compile_env(cls(), data[5])
    assert again.header == h  # deterministic text, so one build per plant
    variant = _build.env_variant(_build.DEFAULT, h)
    assert variant.suffix == "_e" + _build.header_hash(h)[:12]
    assert _build.variant_name("policy", _build.widened(_build.env_variant(_build.EXTENDED, h))) == (
        f"policy_ext_e{_build.header_hash(h)[:12]}_wide")


def test_pendulum_constants_and_observation_in_the_header():
    """Numbers read from ``self`` become float32 constants; the observation
    is three floats of two states; the default ``cond_alive`` is true."""
    env = Pendulum()
    h = user_envs.traced(env, (torch.ones(2),) * 3).header
    two = "mtgp_user::bits(0x40000000u)"  # max_torque 2.0
    assert f"fmaxf(u[0], mtgp_user::bits(0xc0000000u)), {two})" in h
    assert "cosf(x[0])" in h and "sinf(x[0])" in h and "return true;" in h
    assert "noise[2]" in h and "noise[3]" not in h


def test_chip_smoke_pendulum_traces_alike():
    """``chip_smoke.py`` builds its own Pendulum (it imports no test): the
    same plant, hence the same build."""
    import chip_smoke

    ours = user_envs.traced(Pendulum(), (torch.ones(2),) * 3)
    theirs = user_envs.traced(chip_smoke.pendulum_env(), (torch.ones(2),) * 3)
    assert theirs.header == ours.header


@pytest.mark.parametrize("cls,reason", REFUSED)
def test_refused_env_takes_the_general_path(cls, reason):
    env = cls()
    fset, data, trees = policy_case(env, pop=2, b=2, t_steps=3)
    why = user_envs.refusal(env, data[5])
    assert why is not None and reason in why and cls.__name__ in why
    ev = StaticPolicyEvaluator(env, fset, substeps=1)
    assert ev._fused_kind(trees, data) is None
    assert ev.env_refusal == why
    with pytest.raises(NotImplementedError, match="no device plant"):
        cp.device_plant(env, data[5])
    with pytest.raises(NotImplementedError, match=reason):
        cp.run_policy(None, cp.FIXED, trees, *data[:3], data[5], env, fset)
    fitness = ev.evaluate_population(trees, data)  # the general path
    assert fitness.shape == (2,) and bool(torch.isfinite(fitness).all())


# ------------------------------------------------------------ the surface

def test_tile_safe_drift_matches_jax():
    from multitreegp_tpu.models import environments as jenvs
    from multitreegp_tpu.models.environments.base import ControlEnvironmentBase as JaxBase

    assert ControlEnvironmentBase.tile_safe_drift is False and JaxBase.tile_safe_drift is False
    for name in ("HarmonicOscillator", "ChangingHarmonicOscillator", "HarmonicOscillator2", "CartPole",
                 "Acrobot", "Acrobot2", "StirredTankReactor"):
        assert getattr(tenvs, name).tile_safe_drift is getattr(jenvs, name).tile_safe_drift is True, name


def test_fused_kind_routes_by_plant():
    """A built-in type keeps its struct; a tile-safe user environment takes
    #6/#7 through its trace; a non-tile-safe one and a refused one take the
    general path with the reason kept; the same on the CPU as on the card."""
    cases = [(tenvs.Acrobot(), "fixed", None), (TracedAcrobot(), "fixed", None),
             (Pendulum(), "fixed", None), (UntracedPendulum(), None, "tile_safe_drift = False"),
             (SummingPendulum(), None, "reduces")]
    for env, kind, reason in cases:
        fset, data, trees = policy_case(env, pop=2, b=2, t_steps=3)
        ev = StaticPolicyEvaluator(env, fset, substeps=1)
        assert ev._fused_kind(trees, data) == kind, type(env).__name__
        assert (ev.env_refusal is None) == (reason is None)
        if reason:
            assert reason in ev.env_refusal
        ad = DynamicPolicyEvaluator(env, policy_case(env, 2, pop=2, b=2, t_steps=3)[0], state_size=2,
                                    method="adaptive", substeps=2)
        assert ad._fused_kind(trees, data) == (kind and "adaptive")
    acrobot_params = policy_case(tenvs.Acrobot(), pop=2, b=2, t_steps=3)[1][5]
    env_id, plant = cp.device_plant(tenvs.Acrobot(), acrobot_params)
    assert env_id == cp.ENV_IDS[tenvs.Acrobot] and plant is None
    env_id, plant = cp.device_plant(TracedAcrobot(), acrobot_params)
    assert env_id == user_envs.USER_ENV_ID and plant.name == "TracedAcrobot"


def test_data_vector_holds_the_observation():
    """A generated plant's data vector is ``[y (n_obs), a, u, tgt]``; a
    built-in plant's keeps ``latent`` slots for ``y``."""
    pend, quad = Pendulum(), Quadrotor2D()
    assert cp.data_width(pend, 2, 0) == 3 + 2 + 1 and cp.obs_width(pend) == 3
    fset = policy_case(pend, 2, pop=2, b=2, t_steps=3)[0]
    assert cp.data_slots(pend, fset, 2).tolist() == [0, 1, 2, 3, 4, 5]
    fset = policy_case(quad, 0, pop=2, b=2, t_steps=3)[0]
    assert cp.data_slots(quad, fset, 0).tolist() == [0, 1, 2, 3, 4, 5, 8, 9]
    assert cp.takes_fixed(pend, 2, 0, fset.max_device_op) and not cp.takes_fixed(pend, 3, 0, fset.max_device_op)


# ---------------------------------------------- the host build vs plain

@pytest.fixture(scope="module")
def host(tmp_path_factory):
    """``host(variant)``: the host build of ``csrc/policy.cu`` in
    ``variant``, built once."""
    if shutil.which("g++") is None and shutil.which("c++") is None:
        pytest.skip("no host C++ compiler")
    out = tmp_path_factory.mktemp("user_env_host")
    made = {}

    def get(variant):
        if variant.suffix not in made:
            lib = made[variant.suffix] = _build.build_host("policy", out, variant)
            if variant.suffix.endswith("_wide"):
                lib.policy_wide_host.argtypes = [ctypes.c_int, ctypes.c_void_p, ctypes.c_void_p,
                                                 ctypes.c_int, ctypes.c_int]
                lib.policy_wide_host.restype = ctypes.c_int
            else:
                lib.policy_host.argtypes = [ctypes.c_int, ctypes.c_void_p]
                lib.policy_host.restype = ctypes.c_int
        return made[variant.suffix]

    return get


def run_host(host, kind, env, fset, data, trees, state_size, rows=None, **kw):
    """The host build of :func:`cp.policy_variant` (its ``_wide`` form past
    the fixed instances) through ``run_policy``: ``(xs, us, alive (T, P,
    B), steps)``."""
    x0, ts, tgt, _, _, par = data
    wide = not cp.takes_fixed(env, state_size, tgt.shape[-1], fset.max_device_op)
    variant = cp.policy_variant(env, par, fset)
    lib = host(_build.widened(variant) if wide else variant)
    if wide:
        launch = lambda args, scratch, c0, count: lib.policy_wide_host(kind, args, scratch, c0, count)
    else:
        launch = lambda args: lib.policy_host(kind, args)
    status, xs, us, count, steps = cp.run_policy(launch, kind, trees, x0, ts, tgt, par, env, fset,
                                                 state_size, wide=wide, **(rows or {}), **kw)
    assert status == 0
    return xs, us, cp._alive_rows(count, ts.shape[0]), steps


def plain(kind, env, fset, data, trees, state_size, rows=None, method=None, budget=8):
    x0, ts, tgt, _, _, par = data
    if kind == cp.FIXED:
        return cp.policy_rollout_plain(trees, x0, ts, tgt, par, env, fset, 2, method or "rk4",
                                       state_size, **(rows or {}))
    return cp.policy_rollout_adaptive_plain(trees, x0, ts, tgt, par, env, fset, 1e-4, 1e-4, budget,
                                            method or "dopri5", 0.9, state_size)


def kernel_kw(kind, method=None, budget=8):
    if kind == cp.FIXED:
        return dict(method=method or "rk4", substeps=2)
    return dict(method=method or "dopri5", max_steps=budget, rtol=1e-4, atol=1e-4, safety=0.9)


def assert_same(got, ref):
    """Every lane identical: states, controls, alive (and attempted steps)."""
    assert same_bits(got[0], ref[0]) and same_bits(got[1], ref[1])
    assert torch.equal(got[2], ref[2])
    if len(ref) > 3:
        assert torch.equal(got[3], ref[3])


def obs_rows(env, t_steps, b, substeps, stages, seed=3):
    g = torch.Generator().manual_seed(seed)
    return 0.05 * torch.randn((t_steps, b, substeps * stages * env.n_obs), generator=g)


HOST_CASES = [  # (env class, kind, state_size, mode, noise rows)
    (Pendulum, cp.FIXED, 0, "Constant", False), (Pendulum, cp.FIXED, 2, "Different", False),
    (Pendulum, cp.FIXED, 0, "Switch", False), (Pendulum, cp.FIXED, 0, "Constant", True),
    (Pendulum, cp.FIXED, 4, "Different", False), (Pendulum, cp.ADAPTIVE, 0, "Different", False),
    (Pendulum, cp.ADAPTIVE, 2, "Constant", False), (Pendulum, cp.ADAPTIVE, 4, "Different", False),
    (Quadrotor2D, cp.FIXED, 0, "Different", False), (Quadrotor2D, cp.FIXED, 2, "Constant", True),
    (VectorPendulum, cp.FIXED, 0, "Different", True),
    (Quadrotor2D, cp.ADAPTIVE, 0, "Different", False),
]


@pytest.mark.parametrize("cls,kind,state_size,mode,noisy", HOST_CASES)
def test_user_env_host_build_bit_exact(host, monkeypatch, cls, kind, state_size, mode, noisy):
    env = cls()
    fset, data, trees = policy_case(env, state_size, mode=mode)
    rows = dict(obs_noise_rows=obs_rows(env, 6, 4, 2, 4)) if noisy else None
    with monkeypatch.context() as m:
        patch_host_math(m)
        ref = plain(kind, env, fset, data, trees, state_size, rows)
    got = run_host(host, kind, env, fset, data, trees, state_size, rows, **kernel_kw(kind))
    assert_same(got if kind == cp.ADAPTIVE else got[:3], ref)
    assert bool(ref[2][-1].any())
    if kind == cp.ADAPTIVE:
        assert bool((ref[3] > 0).all())


@pytest.mark.parametrize("kind,state_size,method", [(cp.FIXED, 0, "rk4"), (cp.FIXED, 2, "euler"),
                                                    (cp.ADAPTIVE, 0, "dopri5"), (cp.ADAPTIVE, 1, "bosh3")])
def test_traced_acrobot_equals_the_hand_written_struct(host, kind, state_size, method):
    """The traced Acrobot's build and the built-in ``AcrobotEnv`` compute
    the same bits on the same inputs (T = 11, 0.2 apart, as phase 13)."""
    builtin, traced = tenvs.Acrobot(), TracedAcrobot()
    fset, data, trees = policy_case(builtin, state_size, pop=8, t_steps=11, dt=0.2)
    kw = kernel_kw(kind, method)
    want = run_host(host, kind, builtin, fset, data, trees, state_size, **kw)
    got = run_host(host, kind, traced, fset, data, trees, state_size, **kw)
    assert_same(got, want)
    assert bool(want[2][-1].any())


# ----------------------------------------------- the evaluators against JAX

def jax_envs():
    """The JAX package's counterparts of :class:`Pendulum` and
    :class:`Quadrotor2D`: ``ControlEnvironmentBase`` subclasses with
    ``tile_safe_drift = True``, per lane, in the same expression order."""
    import jax.numpy as jnp
    import jax.random as jr

    from multitreegp_tpu.models.environments.base import ControlEnvironmentBase as JaxBase
    from multitreegp_tpu.models.environments.base import obs_noise_at
    from multitreegp_tpu.models.environments.base import time_varying as jax_time_varying

    class JaxPendulum(JaxBase):
        tile_safe_drift = True

        def __init__(self, process_noise=0.0, obs_noise=0.0):
            super().__init__(process_noise, obs_noise, n_var=2, n_control=1, n_dim=1, n_obs=3)
            self.max_torque = 2.0

        def sample_init_states(self, batch_size, key):
            k1, k2 = jr.split(key)
            x0 = jnp.stack([jr.uniform(k1, (batch_size,), minval=-PI, maxval=PI),
                            jr.uniform(k2, (batch_size,), minval=-1.0, maxval=1.0)], axis=-1)
            return x0, jnp.zeros((batch_size, 0))

        def sample_params(self, batch_size, mode, ts, key):
            if mode == "Constant":
                ones = jnp.ones(batch_size)
                return 10.0 * ones, ones, ones
            keys = jr.split(key, 3)
            return tuple(jr.uniform(k, (batch_size,), minval=lo, maxval=hi)
                         for k, (lo, hi) in zip(keys, PENDULUM_RANGES))

        def params_at(self, params, ts, t):
            return tuple(jax_time_varying(p, ts, t) for p in params)

        def drift(self, t, x, u, params):
            g, m, l = params
            torque = jnp.clip(u[0], -self.max_torque, self.max_torque)
            return jnp.stack([x[1], 3.0 * g / (2.0 * l) * jnp.sin(x[0]) + 3.0 / (m * l * l) * torque])

        def f_obs(self, key, t, x, params):
            y = jnp.stack([jnp.cos(x[0]), jnp.sin(x[0]), x[1]])
            return y + obs_noise_at(key, t, self.n_obs) @ (self.obs_noise * jnp.eye(self.n_obs))

        def obs_tiles(self, x):
            return jnp.stack([jnp.cos(x[0]), jnp.sin(x[0]), x[1]])

        def fitness(self, xs, us, target, ts, params):
            theta = (xs[:, 0] + PI) % (2 * PI) - PI
            u = jnp.clip(us[:, 0], -self.max_torque, self.max_torque)
            return jnp.sum(theta * theta + 0.1 * (xs[:, 1] * xs[:, 1]) + 0.001 * (u * u))

    class JaxQuadrotor2D(JaxBase):
        tile_safe_drift = True
        n_targets = 2

        def __init__(self, process_noise=0.0, obs_noise=0.0):
            super().__init__(process_noise, obs_noise, n_var=6, n_control=2, n_dim=1, n_obs=6)
            self.g, self.iyy, self.arm, self.max_thrust = 9.8, 1.4e-5, 0.0397, 0.2

        def sample_init_states(self, batch_size, key):
            k = jr.split(key, 5)
            zero = jnp.zeros(batch_size)
            x0 = jnp.stack([jr.uniform(k[0], (batch_size,), minval=-0.5, maxval=0.5), zero,
                            jr.uniform(k[1], (batch_size,), minval=0.5, maxval=1.5), zero,
                            jr.uniform(k[2], (batch_size,), minval=-0.1, maxval=0.1), zero], axis=-1)
            targets = jnp.stack([jr.uniform(k[3], (batch_size,), minval=-1.0, maxval=1.0),
                                 jr.uniform(k[4], (batch_size,), minval=0.5, maxval=1.5)], axis=-1)
            return x0, targets

        def sample_params(self, batch_size, mode, ts, key):
            if mode == "Constant":
                return (jnp.full((batch_size,), 0.027),)
            return (jr.uniform(key, (batch_size,), minval=0.02, maxval=0.035),)

        def drift(self, t, x, u, params):
            (mass,) = params
            thrust = jnp.clip(u, 0.0, self.max_thrust)
            lift = (thrust[0] + thrust[1]) / mass
            return jnp.stack([x[1], jnp.sin(x[4]) * lift, x[3], jnp.cos(x[4]) * lift - self.g, x[5],
                              (thrust[1] - thrust[0]) * (self.arm / self.iyy)])

        def cond_alive(self, t, x):
            return x[2] > 0.0

        def fitness(self, xs, us, target, ts, params):
            dx, dz = xs[:, 0] - target[0], xs[:, 2] - target[1]
            return jnp.sum(dx * dx + dz * dz + 0.01 * (xs[:, 4] * xs[:, 4]))

    return dict(Pendulum=(JaxPendulum, Pendulum), Quadrotor2D=(JaxQuadrotor2D, Quadrotor2D))


def jax_case(name, state_size, t_steps, mode="Different", pop=24, b=4, dt=0.05, seed=0):
    """JAX's environment, function set, data and population, and the port's
    of the same, carried across by ``convert.py``."""
    import jax.numpy as jnp
    import jax.random as jr

    from multitreegp_tpu.core.registry import build_function_set as jax_function_set
    from multitreegp_tpu.models.evaluators import generate_control_data as jax_generate
    from multitreegp_tpu.ops.initialization import make_population_sampler as jax_sampler
    from multitreegp_tpu_torch.convert import (
        control_data_from_numpy, function_set_from_jax, trees_from_numpy,
    )

    jcls, tcls = jax_envs()[name]
    jenv, tenv = jcls(), tcls()
    ops = [("+", jnp.add, 2, 0.5), ("-", jnp.subtract, 2, 0.1), ("*", jnp.multiply, 2, 0.5),
           ("sin", jnp.sin, 1, 0.3), ("cos", jnp.cos, 1, 0.3)]
    ys = [f"y{i}" for i in range(jenv.n_obs)]
    tg = [f"tgt{i}" for i in range(jenv.n_targets)]
    if state_size:
        a, u = [f"a{i}" for i in range(state_size)], [f"u{i}" for i in range(jenv.n_control)]
        jf = jax_function_set(ops, [ys + a + u + tg, a + tg], [state_size, jenv.n_control])
    else:
        jf = jax_function_set(ops, [ys + tg], [jenv.n_control])
    ts = jnp.arange(t_steps, dtype=jnp.float32) * dt
    jdata = jax_generate(jenv, jr.PRNGKey(seed), ts, batch_size=b, param_mode=mode)
    jpop = jax_sampler(jf, 3, 16)(jr.PRNGKey(seed + 1), pop)
    tdata = control_data_from_numpy(*[np.asarray(x) if not isinstance(x, tuple) else
                                      tuple(np.asarray(p) for p in x) for x in jdata])
    tpop = trees_from_numpy(*[np.asarray(x) for x in jpop])
    return jenv, tenv, jf, function_set_from_jax(jf), jdata, tdata, jpop, tpop


def spearman(a, b) -> float:
    ra, rb = np.argsort(np.argsort(a)), np.argsort(np.argsort(b))
    return float(np.corrcoef(ra, rb)[0, 1])


@pytest.mark.parametrize("name,state_size,t_steps", [("Pendulum", 2, 6), ("Quadrotor2D", 0, 6),
                                                     ("Pendulum", 0, 26), ("Quadrotor2D", 2, 26)])
def test_evaluators_match_jax(name, state_size, t_steps):
    """The port's fused path (the gate admits the traced plant; on the CPU
    the plain version, which the host build equals bit for bit) against
    JAX's evaluator on its general path."""
    import jax

    from multitreegp_tpu.models.evaluators import DynamicPolicyEvaluator as JaxDynamic
    from multitreegp_tpu.models.evaluators import StaticPolicyEvaluator as JaxStatic

    jenv, tenv, jf, tf, jdata, tdata, jpop, tpop = jax_case(name, state_size, t_steps)
    kw = dict(substeps=1, method="rk4")
    if state_size:
        jev = JaxDynamic(jenv, jf, state_size=state_size, interpreter="gather", **kw)
        tev = DynamicPolicyEvaluator(tenv, tf, state_size=state_size, **kw)
    else:
        jev, tev = JaxStatic(jenv, jf, interpreter="gather", **kw), StaticPolicyEvaluator(tenv, tf, **kw)
    assert tev._fused_kind(tpop, tdata) == "fixed"
    want = np.asarray(jax.jit(jev.evaluate_population)(jpop, jdata))
    got = tev.evaluate_population(tpop, tdata).numpy()
    top = tev.max_fitness
    assert np.isfinite(got).all()
    assert ((got >= top) == (want >= top)).all()
    surv = (got < top) & (want < top)
    assert surv.sum() >= 8
    if t_steps <= 6:  # short horizon: 1e-6 relative
        rel = np.abs(got[surv] - want[surv]) / np.maximum(np.abs(want[surv]), 1e-12)
        assert rel.max() <= 1e-6, rel.max()
    else:  # a long rollout: the ranking
        assert spearman(got[surv], want[surv]) >= 0.997


# ---------------------------------------------------------------- on the card

@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    return torch.device("cuda")


def on(device, data, trees):
    return (tuple(d.to(device) if torch.is_tensor(d) else tuple(p.to(device) for p in d) for d in data),
            trees.map(lambda a: a.to(device)))


COUNTERS = (cp.policy_rollout_cuda, cp.policy_rollout_adaptive_cuda, cp.policy_rollout_wide_cuda,
            cp.policy_rollout_adaptive_wide_cuda)


@pytest.mark.cuda
@pytest.mark.parametrize("state_size,noisy,counts", [(0, False, [1, 1, 0, 0]), (2, False, [1, 1, 0, 0]),
                                                     (0, True, [1, 0, 0, 0]), (4, False, [0, 0, 1, 1])])
def test_user_env_kernels_match_plain_on_card(cuda, state_size, noisy, counts):
    env = Pendulum()
    fset, data, trees = policy_case(env, state_size, pop=64, b=16, mode="Different")
    data, trees = on(cuda, data, trees)
    x0, ts, tgt, _, _, par = data
    rows = dict(obs_noise_rows=obs_rows(env, 6, 16, 2, 4).to(cuda)) if noisy else {}
    before = [c.launches for c in COUNTERS]
    got = cp.rollout_policy(trees, x0, ts, tgt, par, env, fset, 2, "rk4", state_size, **rows)
    torch.cuda.synchronize()
    assert_same(got, plain(cp.FIXED, env, fset, data, trees, state_size, rows))
    if not noisy:
        got = cp.rollout_policy_adaptive(trees, x0, ts, tgt, par, env, fset, 1e-4, 1e-4, 8, "dopri5", 0.9,
                                         state_size, return_steps=True)
        torch.cuda.synchronize()
        assert_same(got, plain(cp.ADAPTIVE, env, fset, data, trees, state_size))
    assert [c.launches - n for c, n in zip(COUNTERS, before)] == counts
    assert _build.variant_name("policy", cp.policy_variant(env, par, fset)).startswith("policy_e")


@pytest.mark.cuda
def test_evaluator_takes_the_user_env_build_on_card(cuda):
    from multitreegp_tpu_torch.core import cuda_interpreter as ci

    env = Pendulum()
    fset, data, trees = policy_case(env, pop=64, b=16, t_steps=11)
    data, trees = on(cuda, data, trees)
    ev = StaticPolicyEvaluator(env, fset, substeps=1)
    before, fwd = cp.policy_rollout_cuda.launches, ci.evaluate_trees_cuda.launches
    fitness = ev.evaluate_population(trees, data)
    torch.cuda.synchronize()
    assert cp.policy_rollout_cuda.launches == before + 1 and ci.evaluate_trees_cuda.launches == fwd
    assert bool(((fitness >= 0) & (fitness <= ev.max_fitness)).all())


@pytest.mark.cuda
def test_traced_acrobot_equals_builtin_on_card(cuda):
    builtin, traced = tenvs.Acrobot(), TracedAcrobot()
    fset, data, trees = policy_case(builtin, 0, pop=256, b=16, t_steps=11, dt=0.2)
    data, trees = on(cuda, data, trees)
    x0, ts, tgt, _, _, par = data
    for env_a, env_b in ((builtin, traced),):
        assert_same(cp.rollout_policy(trees, x0, ts, tgt, par, env_b, fset, 4, "rk4", 0),
                    cp.rollout_policy(trees, x0, ts, tgt, par, env_a, fset, 4, "rk4", 0))
        assert_same(cp.rollout_policy_adaptive(trees, x0, ts, tgt, par, env_b, fset, return_steps=True),
                    cp.rollout_policy_adaptive(trees, x0, ts, tgt, par, env_a, fset, return_steps=True))
