"""PyTorch port: the seven control environments against the JAX package's,
and their device drifts (``csrc/control_envs.cuh``) against the torch ones.

Tolerances, and why:

* batched ``drift``, ``obs``, ``cond_alive`` and ``fitness`` against JAX's
  (vmapped over lanes) on the same numpy states, controls, targets and
  parameters: rtol 1e-6 (atol 1e-6 times the output's scale). XLA:CPU may
  contract a product and a sum into an FMA and has its own ``sin``/``cos``/
  ``exp``, and the costs sum over T in another order; the liveness masks are
  identical.
* ``linear_interp``: rtol 1e-6 against JAX's (an FMA in ``v0 + w*(v1-v0)``).
* the parameter modes: shapes, value ranges and the switch index range
  (the law, not the stream: the two packages' generators differ).
* the host build of ``control_envs.cuh`` against the torch drifts and
  observations: bit for bit, with ``torch.sin``/``cos``/``exp`` computed by
  the C library as the host build does.
"""
import ctypes
import math
import shutil
import subprocess

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from multitreegp_tpu.models import environments as jenvs
from multitreegp_tpu.models.integrators import linear_interp as jax_linear_interp
from multitreegp_tpu_torch import _build
from multitreegp_tpu_torch.core.cuda_policy import ENV_IDS
from multitreegp_tpu_torch.models import environments as tenvs
from multitreegp_tpu_torch.models.integrators import linear_interp
from test_torch_kernels import patch_host_math

torch.set_num_threads(1)

NAMES = ["HarmonicOscillator", "ChangingHarmonicOscillator", "HarmonicOscillator2", "CartPole",
         "Acrobot", "Acrobot2", "StirredTankReactor"]
LANES = 64


def lane_inputs(name, seed=0):
    """``(x (L, latent), u (L, n_control), params tuple of (L,), targets (L,
    n_targets))`` as numpy float32, per-lane parameters near the reference's
    Constant values."""
    env = getattr(tenvs, name)()
    rng = np.random.default_rng(seed)
    latent = env.latent_size
    if name == "StirredTankReactor":
        x = rng.uniform([275, 350, -0.2], [300, 375, 1.2], size=(LANES, 3))
        u = rng.uniform(-20, 320, size=(LANES, 1))
        base = np.array([100, 239, -5e4, 5e4, 100, 300, 300, 20.0])
        params = tuple(base[i] * rng.uniform(0.8, 1.2, size=LANES) for i in range(8))
    else:
        x = rng.normal(size=(LANES, latent)) * 3.0
        x[::7] *= 20.0  # some past Acrobot's velocity bounds
        u = rng.normal(size=(LANES, env.n_control)) * 1.5
        n_par = {"HarmonicOscillator": 2, "ChangingHarmonicOscillator": 2, "Acrobot": 4,
                 "Acrobot2": 4}.get(name, 1)
        params = tuple(rng.uniform(0.5, 1.5, size=LANES) for _ in range(n_par))
    targets = rng.uniform(-3, 3, size=(LANES, env.n_targets))
    f32 = lambda a: np.asarray(a, np.float32)
    return f32(x), f32(u), tuple(f32(p) for p in params), f32(targets)


def jax_params(name, params):
    return params if len(params) > 1 else params[0]


@pytest.mark.parametrize("name", NAMES)
def test_drift_obs_cond_match_jax(name):
    x, u, params, _ = lane_inputs(name)
    jenv, tenv = getattr(jenvs, name)(), getattr(tenvs, name)()
    jp = jax_params(name, tuple(jnp.asarray(p) for p in params))
    want = np.asarray(jax.jit(jax.vmap(jenv.drift, in_axes=(None, 0, 0, 0)))(
        0.0, jnp.asarray(x), jnp.asarray(u), jp))
    got = tenv.drift(0.0, torch.from_numpy(x), torch.from_numpy(u),
                     tuple(torch.from_numpy(p) for p in params)).numpy()
    fin = np.isfinite(want)
    np.testing.assert_array_equal(np.isfinite(got), fin)
    scale = np.abs(want[fin]).max()
    np.testing.assert_allclose(got[fin], want[fin], rtol=1e-6, atol=1e-6 * scale)
    jy = np.asarray(jax.jit(jax.vmap(jenv.obs_tiles, in_axes=1, out_axes=1))(jnp.asarray(x.T)).T)
    np.testing.assert_allclose(tenv.obs(torch.from_numpy(x)).numpy(), jy, rtol=1e-6, atol=1e-6)
    noise = np.random.default_rng(1).normal(size=(LANES, tenv.n_obs)).astype(np.float32)
    jyn = np.asarray(jax.jit(jenv.obs_tiles_noisy)(jnp.asarray(x.T), jnp.asarray(noise.T)).T)
    np.testing.assert_allclose(tenv.obs_noisy(torch.from_numpy(x), torch.from_numpy(noise)).numpy(),
                               jyn, rtol=1e-6, atol=1e-6)
    jc = np.asarray(jax.vmap(lambda xi: jenv.cond_alive(0.0, xi))(jnp.asarray(x)))
    tc = tenv.cond_alive(0.0, torch.from_numpy(x)).numpy()
    np.testing.assert_array_equal(tc, np.broadcast_to(jc, tc.shape))
    if name.startswith("Acrobot"):
        assert (~tc).any() and tc.any()


def trajectories(name, t_steps=12, b=6, p=3, seed=2):
    """Saved states ``(P, B, T, latent)`` (some inf-filled, as dead saves
    are), controls, targets and a time grid."""
    env = getattr(tenvs, name)()
    rng = np.random.default_rng(seed)
    xs = rng.normal(size=(p, b, t_steps, env.latent_size)).astype(np.float32)
    if name.startswith("Acrobot"):  # swing some lanes up past the success line
        xs[:, ::2, 4:, 0] = np.pi
    if name == "StirredTankReactor":
        xs = xs * 20 + 400
    us = rng.normal(size=(p, b, t_steps, env.n_control)).astype(np.float32)
    xs[0, 1, 7:] = np.inf
    us[0, 1, 7:] = np.inf
    targets = rng.uniform(-3, 3, size=(b, env.n_targets)).astype(np.float32)
    ts = np.arange(t_steps, dtype=np.float32) * np.float32(0.2)
    return xs, us, targets, ts


@pytest.mark.parametrize("name,series", [(n, False) for n in NAMES] + [
    ("HarmonicOscillator", True), ("ChangingHarmonicOscillator", True)])  # costs that read series
def test_fitness_matches_jax(name, series):
    xs, us, targets, ts = trajectories(name)
    b, t_steps = xs.shape[1], xs.shape[2]
    _, _, params, _ = lane_inputs(name)
    params = tuple(p[:b] for p in params)
    if series:
        params = tuple(np.linspace(p, 2 * p, t_steps, axis=-1).astype(np.float32) for p in params)
    jenv, tenv = getattr(jenvs, name)(), getattr(tenvs, name)()
    jp = jax_params(name, tuple(jnp.asarray(p) for p in params))
    per_lane = jax.vmap(jax.vmap(jenv.fitness, in_axes=(0, 0, 0, None, 0)),
                        in_axes=(0, 0, None, None, None))
    want = np.asarray(jax.jit(per_lane)(jnp.asarray(xs), jnp.asarray(us), jnp.asarray(targets),
                                        jnp.asarray(ts), jp))
    got = tenv.fitness(torch.from_numpy(xs), torch.from_numpy(us), torch.from_numpy(targets),
                       torch.from_numpy(ts), tuple(torch.from_numpy(p) for p in params)).numpy()
    assert got.shape == want.shape == xs.shape[:2]
    fin = np.isfinite(want)
    np.testing.assert_array_equal(np.isfinite(got), fin)
    np.testing.assert_allclose(got[fin], want[fin], rtol=1e-6)
    assert fin.any()


def test_acrobot_fitness_takes_the_first_success():
    """The cost counts the first save past the success line (argmax of the
    bool cast to an integer: the first maximal index), the horizon if none,
    and the control cost before it."""
    env = tenvs.Acrobot()
    ts = torch.arange(6, dtype=torch.float32) * 0.2
    xs = torch.zeros((2, 6, 4))
    xs[0, 2:, 0] = math.pi  # successful from save 2 on
    us = torch.ones((2, 6, 1))
    cost = env.fitness(xs, us, torch.zeros((2, 0)), ts, None)
    torch.testing.assert_close(cost, torch.tensor([2 + 3 * 0.01, 6 + 0.01]))


def test_linear_interp_matches_jax():
    rng = np.random.default_rng(0)
    ts = np.arange(0.0, 2.0, 0.2, dtype=np.float32)
    values = rng.normal(size=(ts.shape[0], 3)).astype(np.float32)
    jl = jax.jit(jax_linear_interp)
    for t in (-1.0, 0.0, 0.3, 0.4, 1.0000001, 1.8, 2.5):
        want = np.asarray(jl(jnp.asarray(ts), jnp.asarray(values), jnp.float32(t)))
        got = linear_interp(torch.from_numpy(ts), torch.from_numpy(values), t).numpy()
        np.testing.assert_allclose(got, want, rtol=1e-6, atol=1e-7)
    lanes = rng.uniform(-0.5, 2.5, size=(4, 3)).astype(np.float32)  # per-lane times
    got = linear_interp(torch.from_numpy(ts), torch.from_numpy(values), torch.from_numpy(lanes))
    want = np.stack([np.asarray(jax.vmap(lambda t, v: jl(jnp.asarray(ts), v, t), in_axes=(0, 1))(
        jnp.asarray(lanes[i]), jnp.asarray(values))) for i in range(4)])
    np.testing.assert_allclose(got.numpy(), want, rtol=1e-6, atol=1e-7)


@pytest.mark.parametrize("name,mode", [("HarmonicOscillator", "Constant"),
                                       ("HarmonicOscillator", "Different"),
                                       ("HarmonicOscillator", "Switch"),
                                       ("HarmonicOscillator", "Decay"),
                                       ("ChangingHarmonicOscillator", "Decay"),
                                       ("Acrobot2", "Switch"), ("Acrobot2", "Decay"),
                                       ("StirredTankReactor", "Different")])
def test_param_modes_law(name, mode):
    env = getattr(tenvs, name)()
    g = torch.Generator().manual_seed(0)
    ts = torch.arange(0.0, 10.0, 0.2)
    b, t_steps = 256, ts.shape[0]
    params = env.sample_params(b, mode, ts, g)
    assert isinstance(params, tuple)
    for p in params:
        assert p.dtype == torch.float32
        assert p.shape == ((b, t_steps) if mode in ("Switch", "Decay") else (b,))
    if name == "StirredTankReactor":
        lo = torch.tensor([75, 200, -55000, 25000, 75, 300, 250, 10.0])
        hi = torch.tensor([150, 350, -45000, 75000, 125, 350, 300, 30.0])
        stacked = torch.stack(params, -1)
        assert bool(((stacked >= lo) & (stacked <= hi)).all())
    elif mode == "Switch":
        lo, hi = (0.75, 1.25) if name == "Acrobot2" else (0.5, 1.5)
        p = params[0]
        assert bool(((p >= lo) & (p <= hi)).all())
        jumps = (p[:, 1:] != p[:, :-1]).sum(dim=1)
        assert bool((jumps <= 1).all())
        first = torch.where(jumps > 0, (p[:, 1:] != p[:, :-1]).int().argmax(dim=1) + 1, -1)
        hit = first[first >= 0]
        assert bool(((hit >= t_steps // 4) & (hit < 3 * t_steps // 4)).all()) and hit.numel() > 200
    elif mode == "Decay":
        p = params[0]
        ratio = p[:, 1:] / p[:, :-1]  # decay ** 0.2 per save
        assert bool((ratio.std(dim=1) < 1e-4).all())
        if name == "ChangingHarmonicOscillator":  # growing omega, decaying zeta
            assert bool((ratio > 1).all()) and bool((params[1][:, 1:] < params[1][:, :-1]).all())
    x0, targets = env.sample_init_states(b, g)
    assert x0.shape == (b, env.latent_size) and targets.shape == (b, env.n_targets)


@pytest.fixture(scope="module")
def envs_host(tmp_path_factory):
    """``control_envs.cuh`` in a host lane loop: drift, cond_alive and the
    wrapped observation of every lane of one environment."""
    if shutil.which("g++") is None:
        pytest.skip("no host C++ compiler")
    out = tmp_path_factory.mktemp("envs_host")
    src = out / "envs_host.cpp"
    src.write_text('''#include "control_envs.cuh"
template <class E>
int run(int lanes, const float* x, const float* u, const float* p, float* dx, unsigned char* ok,
        float* y) {
  for (int i = 0; i < lanes; ++i) {
    const float* xi = x + i * E::kLatent;
    E::drift(xi, u + i * E::kControls, p + i * E::kParams, dx + i * E::kLatent);
    ok[i] = E::alive(xi);
    for (int q = 0; q < E::kLatent; ++q) y[i * E::kLatent + q] = xi[q];
    E::wrap_obs(y + i * E::kLatent);
  }
  return 0;
}
extern "C" int envs_host(int env, int lanes, const float* x, const float* u, const float* p,
                         float* dx, unsigned char* ok, float* y) {
  switch (env) {
    case kHarmonicOscillator:
    case kChangingHarmonicOscillator: return run<HarmonicOscillatorEnv>(lanes, x, u, p, dx, ok, y);
    case kHarmonicOscillator2: return run<HarmonicOscillator2Env>(lanes, x, u, p, dx, ok, y);
    case kCartPole: return run<CartPoleEnv>(lanes, x, u, p, dx, ok, y);
    case kAcrobot: return run<AcrobotEnv<false>>(lanes, x, u, p, dx, ok, y);
    case kAcrobot2: return run<AcrobotEnv<true>>(lanes, x, u, p, dx, ok, y);
    case kStirredTankReactor: return run<StirredTankReactorEnv>(lanes, x, u, p, dx, ok, y);
    default: return 1;
  }
}
''')
    lib = out / "envs_host.so"
    subprocess.run(["g++", "-std=c++17", "-O2", "-ffp-contract=off", "-shared", "-fPIC",
                    "-I", str(_build.CSRC_DIR), "-o", str(lib), str(src)], check=True)
    return ctypes.CDLL(str(lib))


@pytest.mark.parametrize("name", NAMES)
def test_device_drift_host_build_bit_exact(envs_host, monkeypatch, name):
    x, u, params, _ = lane_inputs(name, seed=3)
    env = getattr(tenvs, name)()
    p = np.ascontiguousarray(np.stack(params, -1))
    dx = np.zeros_like(x)
    ok = np.zeros(LANES, np.uint8)
    y = np.zeros_like(x)
    fn = envs_host.envs_host
    fn.argtypes = [ctypes.c_int, ctypes.c_int] + [ctypes.c_void_p] * 6
    assert fn(ENV_IDS[type(env)], LANES, *(a.ctypes.data for a in (x, u, p, dx, ok, y))) == 0
    with monkeypatch.context() as m:
        patch_host_math(m)
        want = env.drift(0.0, torch.from_numpy(x), torch.from_numpy(u),
                         tuple(torch.from_numpy(q) for q in params))
        alive = env.cond_alive(0.0, torch.from_numpy(x))
    np.testing.assert_array_equal(dx, want.numpy())  # NaN where NaN
    np.testing.assert_array_equal(ok.astype(bool), alive.numpy())
    n_obs = env.n_obs
    np.testing.assert_array_equal(y[:, :n_obs], env.obs(torch.from_numpy(x)).numpy())
