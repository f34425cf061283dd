"""The noise streams of the fused rollouts, built up front.

Port of ``multitreegp_tpu/models/evaluators/noise.py``. Observation noise
and Brownian increments are deterministic functions of (key, solver time),
``normal(fold_in(key, bitcast_f32(t)), (n,))`` (``core/prng.py``), so every
draw a fixed-step rollout will make is known before it starts: each function
draws them at the stage times of ``core.cuda_policy.stage_times`` (the
integrator's own float32 time expressions) in one vectorised pass over all
times and trajectories, and the fused kernels (#1, #6) read them as rows.
The general path (``integrate_sde``, ``f_obs``) draws the same numbers at the
same times.
"""
from __future__ import annotations

import numpy as np
import torch

from ...core import prng
from ...core.cuda_policy import stage_times
from ..integrators import _f32


def _substep_grid(ts: torch.Tensor, substeps: int, device):
    """The Euler substep times ``(T-1, substeps)`` and the ``sqrt(|dt|)``
    scale of each interval's increments ``(T-1, 1)``, in float32."""
    taus = stage_times(ts, substeps, "euler")[..., 0].to(device)
    t = ts.detach().cpu().numpy().astype(np.float32)
    dt = (t[1:] - t[:-1]) / np.float32(substeps)
    scale = torch.from_numpy(np.sqrt(np.abs(dt)).astype(np.float32)).to(device)
    return taus, scale[:, None]


def _increments(keys: torch.Tensor, taus: torch.Tensor, scale: torch.Tensor, d: int):
    """``normal(fold_in(key, bitcast(tau)), (d,)) * sqrt(|dt|)`` for every
    time ``taus (T-1, S)`` and key ``(B, 2)``: ``(T-1, S, B, d)``."""
    return prng.normal(prng.fold_in(keys, prng.bitcast_time(taus[..., None])), d,
                       scale[:, :, None, None])


def _rows(draws: torch.Tensor) -> torch.Tensor:
    """``(T-1, S, ..., B, n)`` draws to rows ``(T, B, S * ... * n)``,
    (substep, stage, value)-major, with a zero row ``T-1``."""
    lead = draws.shape[0]
    nz = draws.movedim(-2, 1).reshape(lead, draws.shape[-2], -1)
    return torch.cat([nz, torch.zeros_like(nz[:1])], dim=0)


def make_obs_noise_rows(env, ts: torch.Tensor, params, obs_keys: torch.Tensor, substeps: int,
                        method: str) -> torch.Tensor:
    """``(T, B, substeps * n_stages * n_obs)`` scaled observation-noise
    draws: row ``t`` holds every stage draw of save interval ``[ts[t],
    ts[t+1])``, each ``obs_noise_at(key_b, tau) @ W(params_b at tau)``, the
    additive term of ``f_obs``; row ``T-1`` holds only the draw at
    ``ts[-1]``, in slot (0, 0), which the save-point controls read."""
    dev = obs_keys.device
    taus = stage_times(ts, substeps, method).to(dev)  # (T-1, S, K)
    t = taus[..., None]  # broadcasts against B
    nz = env.obs_noise_term(obs_keys, t, env.params_at(params, ts, t))  # (T-1, S, K, B, n_obs)
    rows = _rows(nz)
    t_end = ts[-1:].to(dev)
    last = env.obs_noise_term(obs_keys, t_end, env.params_at(params, ts, t_end))  # (B, n_obs)
    rows[-1, :, : env.n_obs] = last
    return rows


def make_process_noise_rows(env, ts: torch.Tensor, params, process_keys: torch.Tensor,
                            substeps: int, d_aug: int) -> torch.Tensor:
    """``(T, B, substeps * latent)`` Euler-Maruyama kicks ``G(t) @
    dW[:latent]`` of the plant's latent state, ``G`` the environment's
    (state-independent) diffusion. The increment is drawn over the whole
    integrated state ``d_aug`` (latent plus a dynamic policy's hidden state),
    as ``integrate_sde`` draws it, and only its latent part is kicked."""
    latent = env.latent_size
    dev = process_keys.device
    taus, scale = _substep_grid(ts, substeps, dev)
    w = _increments(process_keys, taus, scale, d_aug)[..., :latent]  # (T-1, S, B, latent)
    x0 = torch.zeros(latent, device=dev)
    u0 = torch.zeros(env.n_control, device=dev)
    g = env.diffusion(taus, x0, u0, env.params_at(params, ts, taus[..., None])).to(dev)
    return _rows((g * w[..., None, :]).sum(dim=-1))


def make_sr_kick_rows(process_noise: float, ts: torch.Tensor, process_keys: torch.Tensor,
                      substeps: int, d: int) -> torch.Tensor:
    """``(T, B, substeps * d)`` Euler-Maruyama kicks of the SR evaluator's
    diagonal diffusion: ``process_noise * normal(fold_in(key, bitcast(t)),
    (d,)) * sqrt(|dt|)`` at every substep time, the increments of
    ``integrate_sde``, for kernel #1."""
    taus, scale = _substep_grid(ts, substeps, process_keys.device)
    return _rows(_f32(process_noise) * _increments(process_keys, taus, scale, d))

