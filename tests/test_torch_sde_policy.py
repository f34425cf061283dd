"""PyTorch port: the policy evaluators with observation noise and
``stochastic=True``, against the JAX package on the same numpy keys, states
and candidates.

Fixed step takes kernel #6 (its plain version here) with the rows built in
torch, Euler when stochastic; the adaptive method with noise takes the
general path. Held against JAX's general path with the tolerances of
``test_torch_policy.py`` (XLA:CPU's FMAs; the draws are within a few ulp,
``test_torch_noise.py``). The adaptive method with observation noise is held
by law instead: its draws fall at per-lane solver times, which differ from
JAX's by ulps once the controller's ``pow`` rounds apart (ROADMAP Queue 3),
and a time an ulp away draws other noise. There the same lanes stay alive,
each state stays within 5% of its lane's scale (the noise is 5% of it), and
the fitness within 5% with a Spearman rank correlation >= 0.997. That law
cannot tell right noise from wrong: once a lane's times part, its draws are
as unrelated to JAX's as other keys' would be. So the first step, where the
times still agree bit for bit, is held tightly: there the states agree to
1e-6 of the lane's scale, and the noise-free rollout and one with other
observation keys are off by more than 1e-4 on the lanes the noise moves.
"""
import jax
import numpy as np
import pytest
import torch

import multitreegp_tpu.models.evaluators.dynamic_policy as jax_dynamic
import multitreegp_tpu.models.evaluators.static_policy as jax_static
import multitreegp_tpu_torch.models.evaluators.static_policy as torch_static
from multitreegp_tpu_torch.core import cuda_policy as cp
from test_torch_policy import assert_fitness_agree, assert_lanes_agree, case, evaluators

torch.set_num_threads(1)

POLICY_CASES = [
    # name, env kwargs, evaluator kwargs, state_size
    ("HarmonicOscillator", dict(obs_noise=0.05), dict(), 0),
    ("Acrobot", dict(obs_noise=0.05), dict(), 0),
    ("HarmonicOscillator", dict(process_noise=0.05), dict(stochastic=True), 0),
    ("CartPole", dict(obs_noise=0.02, process_noise=0.02), dict(stochastic=True), 0),
    ("HarmonicOscillator", dict(obs_noise=0.05, process_noise=0.05), dict(stochastic=True), 2),
    ("HarmonicOscillator", dict(obs_noise=0.05), dict(method="adaptive"), 0),
    ("HarmonicOscillator", dict(process_noise=0.05), dict(stochastic=True, method="adaptive"), 0),
    ("HarmonicOscillator", dict(process_noise=0.05), dict(stochastic=True, method="adaptive"), 1),
]


@pytest.mark.parametrize("name,env_kw,ev_kw,state_size", POLICY_CASES)
def test_noisy_policy_matches_jax(monkeypatch, name, env_kw, ev_kw, state_size):
    """The general paths and the fitness, with JAX's dispatch: fixed step
    takes #6 (its plain version here) with the rows built in torch, euler
    when stochastic; the adaptive method with noise the general path."""
    jenv, tenv, jf, tf, jdata, tdata, jpop, tpop = case(name, state_size=state_size, pop=10,
                                                        t_end=1.6, **env_kw)
    jev, tev = evaluators(jenv, tenv, jf, tf, state_size, substeps=2, **ev_kw)
    (jxs, jal), jfit = jax.jit(lambda p, d: (jev._rollout_general(p, d),
                                             jev.evaluate_population(p, d)))(jpop, jdata)
    txs, tal = tev._rollout_general(tpop, tdata)
    by_law = ev_kw.get("method") == "adaptive" and "obs_noise" in env_kw
    assert_lanes_agree(txs, tal, jxs, jal, tol=5e-2 if by_law else 1e-4)
    calls = []
    for fn in ("policy_rollout_plain", "policy_rollout_adaptive_plain"):
        orig = getattr(cp, fn)
        monkeypatch.setattr(cp, fn, lambda *a, _n=fn, _f=orig: calls.append((_n, a[-2:])) or _f(*a))
    fit = tev.evaluate_population(tpop, tdata)
    assert_fitness_agree(fit, jfit, tol=5e-2 if by_law else 1e-4)
    if by_law:
        rank = lambda v: np.argsort(np.argsort(np.asarray(v)))
        assert np.corrcoef(rank(fit), rank(jfit))[0, 1] >= 0.997
    if ev_kw.get("method") == "adaptive":
        assert calls == []
    else:
        ((fn, (obs_rows, kick_rows)),) = calls
        assert fn == "policy_rollout_plain"
        assert (obs_rows is not None) == ("obs_noise" in env_kw)
        assert (kick_rows is not None) == ("process_noise" in env_kw)



@pytest.mark.parametrize("name,method,state_size", [
    ("HarmonicOscillator", "dopri5", 0), ("HarmonicOscillator", "bosh3", 0),
    ("Acrobot", "dopri5", 0), ("HarmonicOscillator", "dopri5", 2)])
def test_noisy_adaptive_first_step_matches_jax(monkeypatch, name, method, state_size):
    """The adaptive general path with observation noise, exactly up to its
    first step: with a budget of one step per interval every lane takes one
    step from t = 0 at dt = span / 4 and stops, so both packages draw at the
    same stage times. The states after it agree to 1e-6 of the lane's scale;
    the noise-free rollout and one with other observation keys are each off
    by more than 1e-4 on most of the lanes the noise moves."""
    for mod in (jax_static, jax_dynamic, torch_static):  # the port's dynamic evaluator inherits
        monkeypatch.setattr(mod, "adaptive_step_budget", lambda substeps: 1)
    jenv, tenv, jf, tf, jdata, tdata, jpop, tpop = case(name, state_size=state_size, pop=24,
                                                        t_end=0.6, obs_noise=0.05)
    kw = dict(substeps=2, method="adaptive", adaptive_method=method)
    jev, tev = evaluators(jenv, tenv, jf, tf, state_size, **kw)
    quiet = evaluators(None, type(tenv)(), None, tf, state_size, **kw)[1]
    jx = np.asarray(jax.jit(jev._rollout_general)(jpop, jdata)[0])[1]
    scale = np.maximum(np.abs(jx).max(-1), 1e-6)
    rel = lambda ev, data: np.abs(np.asarray(ev._rollout_general(tpop, data)[0])[1] - jx).max(-1) / scale
    assert rel(tev, tdata).max() <= 1e-6
    moved = rel(quiet, tdata) > 1e-4
    assert moved.mean() >= 0.2, moved.mean()
    other = tdata[:4] + (tdata[4] ^ 1,) + tdata[5:]
    assert (rel(tev, other)[moved] > 1e-4).mean() >= 0.5


def test_noise_draws_are_deterministic_in_the_keys():
    """Same data, same fitness; other observation keys, another fitness."""
    _, tenv, _, tf, _, tdata, _, tpop = case("HarmonicOscillator", pop=8, obs_noise=0.2,
                                              process_noise=0.1)
    ev = evaluators(None, tenv, None, tf, 0, substeps=2, stochastic=True)[1]
    a, b = ev.evaluate_population(tpop, tdata), ev.evaluate_population(tpop, tdata)
    assert torch.equal(a, b)
    other = tdata[:4] + (tdata[4] ^ 1,) + tdata[5:]
    assert not torch.equal(ev.evaluate_population(tpop, other), a)
