"""PyTorch port: the noise streams (``models/evaluators/noise.py``), the
noisy observation and ``integrate_sde`` against the JAX package, on the same
numpy keys and states.

What holds, and why:

* ``stage_times`` is bit-equal on the examples' 0.2 grid at 1, 2 and 4
  substeps. XLA:CPU contracts the substep time ``t0 + i*dt`` into a fused
  multiply-add, and the port rounds it once too (``substep_time``); at heun
  x 4 XLA leaves it unfused in its ``stage_times`` program, an ulp apart on
  some times (the port keeps the integrator's fused time there too).
* The rows hold the same draws at the same times: every entry within 4 ulp
  and at least 97% bit-equal. A normal is within 3 ulp of JAX's (PyTorch's
  ``log1p`` against XLA's, ``test_torch_prng.py``), and the scale rounds
  once more.
* ``integrate_sde``: exact or within 1e-6 of the state's scale at short
  horizons (the drift's ``x + dt*k`` is an FMA in XLA:CPU, not in the
  port), and at long ones by the statistical criteria of ROADMAP Queue 3:
  the same lanes alive and the final states' Spearman rank correlation >=
  0.997.
"""
import jax
import jax.numpy as jnp
import jax.random as jr
import numpy as np
import pytest
import torch

from multitreegp_tpu.core.pallas_policy import stage_times as jax_stage_times
from multitreegp_tpu.models import environments as jenvs
from multitreegp_tpu.models.evaluators import generate_control_data as jax_generate
from multitreegp_tpu.models.evaluators import noise as jnoise
from multitreegp_tpu.models.integrators import integrate_sde as jax_integrate_sde
from multitreegp_tpu_torch.convert import control_data_from_numpy
from multitreegp_tpu_torch.core.cuda_policy import stage_times
from multitreegp_tpu_torch.models import environments as tenvs
from multitreegp_tpu_torch.models.evaluators import noise
from multitreegp_tpu_torch.models.integrators import integrate_sde

torch.set_num_threads(1)

TS = jnp.arange(0.0, 2.2, 0.2)  # T = 11
TTS = torch.from_numpy(np.array(TS))


def ulps(a, b) -> np.ndarray:
    a = np.asarray(a, np.float32).view(np.int32).astype(np.int64)
    return np.abs(a - np.asarray(b, np.float32).view(np.int32).astype(np.int64))


def assert_same_draws(got, want, share=0.97):
    got, want = np.asarray(got), np.asarray(want)
    assert got.shape == want.shape
    d = ulps(want, got)
    assert d.max() <= 4, d.max()
    assert (d == 0).mean() >= share, (d == 0).mean()


def to_numpy(tree):
    return tuple(to_numpy(a) for a in tree) if isinstance(tree, tuple) else np.asarray(tree)


def env_pair(name, **kw):
    return getattr(jenvs, name)(**kw), getattr(tenvs, name)(**kw)


def data_pair(jenv, mode="Constant", b=4, seed=0):
    jdata = jax_generate(jenv, jr.PRNGKey(seed), TS, batch_size=b, param_mode=mode)
    return jdata, control_data_from_numpy(*to_numpy(jdata))


@pytest.mark.parametrize("method,substeps", [("euler", 1), ("euler", 2), ("euler", 4),
                                             ("heun", 1), ("heun", 2), ("rk4", 1), ("rk4", 2),
                                             ("rk4", 4)])
def test_stage_times_bit_equal(method, substeps):
    want = np.asarray(jax.jit(jax_stage_times, static_argnums=(1, 2))(TS, substeps, method))
    got = stage_times(TTS, substeps, method)
    assert got.dtype == torch.float32
    np.testing.assert_array_equal(got.numpy(), want)


NOISY = [("HarmonicOscillator", "Constant"), ("Acrobot", "Constant"),
         ("StirredTankReactor", "Constant"), ("HarmonicOscillator", "Switch"),
         ("HarmonicOscillator", "Decay")]


@pytest.mark.parametrize("name,mode", NOISY)
@pytest.mark.parametrize("method,substeps", [("rk4", 2), ("euler", 4)])
def test_obs_noise_rows_match_jax(name, mode, method, substeps):
    """Every stage draw of every interval, ``(T, B, substeps * stages *
    n_obs)``, with row ``T-1`` holding only the draw at ``ts[-1]``; the
    StirredTankReactor's ``W`` scales its observations by 15, 15 and 0.1."""
    jenv, tenv = env_pair(name, obs_noise=0.05)
    jdata, tdata = data_pair(jenv, mode)
    want = jax.jit(lambda ts, p, k: jnoise.make_obs_noise_rows(jenv, ts, p, k, substeps, method))(
        TS, jdata[5], jdata[4])
    got = noise.make_obs_noise_rows(tenv, tdata[1], tdata[5], tdata[4], substeps, method)
    assert_same_draws(got, want)
    n_obs = tenv.n_obs
    assert bool((got[-1, :, n_obs:] == 0).all()) and bool((got[-1, :, :n_obs] != 0).all())


@pytest.mark.parametrize("name,d_extra", [("HarmonicOscillator", 0), ("Acrobot", 0),
                                          ("StirredTankReactor", 2), ("HarmonicOscillator", 1)])
def test_process_noise_rows_match_jax(name, d_extra):
    """Euler-Maruyama kicks ``(T, B, substeps * latent)``, drawn over the
    whole integrated state (a dynamic policy's ``latent + state_size``)."""
    jenv, tenv = env_pair(name, process_noise=0.1)
    jdata, tdata = data_pair(jenv)
    d_aug = tenv.latent_size + d_extra
    want = jax.jit(lambda ts, p, k: jnoise.make_process_noise_rows(jenv, ts, p, k, 4, d_aug))(
        TS, jdata[5], jdata[3])
    got = noise.make_process_noise_rows(tenv, tdata[1], tdata[5], tdata[3], 4, d_aug)
    assert_same_draws(got, want)
    assert bool((got[-1] == 0).all())


@pytest.mark.parametrize("d,substeps", [(2, 4), (3, 1)])
def test_sr_kick_rows_match_jax(d, substeps):
    keys = jr.split(jr.PRNGKey(3), 6)
    want = jax.jit(lambda ts, k: jnoise.make_sr_kick_rows(0.05, ts, k, substeps, d))(TS, keys)
    got = noise.make_sr_kick_rows(0.05, TTS, torch.tensor(np.asarray(keys).astype(np.int64)),
                                  substeps, d)
    assert_same_draws(got, want)


@pytest.mark.parametrize("name", ["HarmonicOscillator", "Acrobot", "StirredTankReactor"])
def test_noisy_observation_matches_jax(name):
    """``f_obs`` with noise at a scalar time and at per-lane times ``(P, B)``;
    Acrobot wraps its angles after the noise (states near +-pi cross the
    wrap)."""
    jenv, tenv = env_pair(name, obs_noise=0.3)
    jdata, tdata = data_pair(jenv, b=5)
    rng = np.random.default_rng(0)
    x = rng.normal(size=(3, 5, tenv.latent_size)).astype(np.float32)
    if name == "Acrobot":
        x[..., :2] = np.pi + rng.normal(size=(3, 5, 2)).astype(np.float32) * 0.05
    t_lane = rng.uniform(0.0, 2.0, size=(3, 5)).astype(np.float32)
    keys, params = jdata[4], jdata[5]
    per_b = jax.vmap(jenv.f_obs, in_axes=(0, None, 0, 0))
    want_s = jax.jit(jax.vmap(per_b, in_axes=(None, None, 0, None)))(keys, jnp.float32(0.6), x, params)
    want_l = jax.jit(jax.vmap(jax.vmap(jenv.f_obs, in_axes=(0, 0, 0, 0)), in_axes=(None, 0, 0, None)))(
        keys, t_lane, x, params)
    got_s = tenv.f_obs(tdata[4], 0.6, torch.from_numpy(x), tdata[5])
    got_l = tenv.f_obs(tdata[4], torch.from_numpy(t_lane), torch.from_numpy(x), tdata[5])
    for got, want in ((got_s, want_s), (got_l, want_l)):
        np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=1e-6, atol=1e-6)
    if name == "Acrobot":
        assert float(got_s[..., :2].abs().max()) <= np.pi
    # without noise no draw is made: the plain observation
    clean = env_pair(name)[1]
    assert torch.equal(clean.f_obs(None, 0.6, torch.from_numpy(x), tdata[5]),
                       clean.obs(torch.from_numpy(x)))


def _sde_pair(matrix: bool):
    """A damped rotation with a state-dependent diffusion, diagonal or a
    full matrix per lane."""
    a = np.float32([[-0.1, 1.0], [-1.0, -0.1]])

    def jdrift(t, x):
        return x @ a.T + 0.05 * jnp.sin(t)

    def tdrift(t, x):
        return x @ torch.from_numpy(a).T + 0.05 * torch.sin(torch.as_tensor(t, dtype=torch.float32))

    if matrix:
        m = np.float32([[0.2, 0.05], [0.0, 0.1]])
        jdiff = lambda t, x: jnp.broadcast_to(m, x.shape + (2,)) * (1.0 + 0.1 * x[..., None])
        tdiff = lambda t, x: torch.from_numpy(m).expand(x.shape + (2,)) * (1.0 + 0.1 * x[..., None])
    else:
        jdiff = lambda t, x: 0.2 * (1.0 + 0.1 * x * x)
        tdiff = lambda t, x: 0.2 * (1.0 + 0.1 * x * x)
    return (jdrift, jdiff), (tdrift, tdiff)


@pytest.mark.parametrize("matrix", [False, True])
@pytest.mark.parametrize("method", ["euler", "heun"])
def test_integrate_sde_matches_jax(matrix, method):
    (jdrift, jdiff), (tdrift, tdiff) = _sde_pair(matrix)
    rng = np.random.default_rng(1)
    x0 = rng.normal(size=(3, 8, 2)).astype(np.float32)  # (P, B, d)
    keys = jr.split(jr.PRNGKey(5), 8)
    tkeys = torch.tensor(np.asarray(keys).astype(np.int64))
    cond = lambda t, x: (x * x).sum(-1) < 9.0
    for ts, exact in ((jnp.arange(0.0, 0.6, 0.2), True), (jnp.arange(0.0, 20.0, 0.2), False)):
        jxs, jal = jax.jit(lambda x, t, k: jax_integrate_sde(jdrift, jdiff, x, t, k, method, 4,
                                                             cond_alive=cond))(x0, ts, keys)
        txs, tal = integrate_sde(tdrift, tdiff, torch.from_numpy(x0), torch.from_numpy(np.asarray(ts)),
                                 tkeys, method, 4, cond_alive=cond)
        jxs, jal = np.asarray(jxs), np.asarray(jal)
        assert txs.shape == jxs.shape and tal.shape == jal.shape
        if exact:
            np.testing.assert_array_equal(tal.numpy(), jal)
            scale = np.abs(jxs).max()
            assert np.abs(txs.numpy() - jxs).max() <= 1e-6 * scale
        else:  # 100 intervals: some lanes cross the bound, the rest agree in rank
            a = tal.numpy()[-1]
            assert (a == jal[-1]).mean() >= 0.95 and 0 < a.sum() < a.size
            both = a & jal[-1]
            got, want = txs.numpy()[-1][both].ravel(), jxs[-1][both].ravel()
            rank = lambda v: np.argsort(np.argsort(v))
            assert np.corrcoef(rank(got), rank(want))[0, 1] >= 0.997


def test_integrate_sde_draws_depend_on_key_and_time_only():
    """Two calls with the same keys give the same path; a lane's path does
    not depend on the other lanes (its key alone draws its increments)."""
    (_, _), (tdrift, tdiff) = _sde_pair(False)
    keys = torch.tensor(np.asarray(jr.split(jr.PRNGKey(2), 4)).astype(np.int64))
    x0 = torch.ones(4, 2)
    a, _ = integrate_sde(tdrift, tdiff, x0, TTS, keys, "euler", 2)
    b, _ = integrate_sde(tdrift, tdiff, x0, TTS, keys, "euler", 2)
    c, _ = integrate_sde(tdrift, tdiff, x0[1:2], TTS, keys[1:2], "euler", 2)
    assert torch.equal(a, b) and torch.equal(a[:, 1:2], c)
    assert not torch.equal(a[:, 0], a[:, 1])
