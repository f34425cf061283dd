"""Control environments (PyTorch ports of
``multitreegp_tpu/models/environments/control_envs.py``).

The seven ODE plants of the symbolic-policy workloads, batched over leading
dimensions, with explicit parameter tuples and the four parameter modes
Constant / Different / Switch / Decay (Switch and Decay give ``(B, T)``
series that ``params_at`` interpolates at solver time). Every drift copies
the JAX expression for expression, in float32: ``x**2`` is ``x * x``, Python
constants round once to float32, ``clip`` propagates NaN, and a division by a
Python number divides by a tensor of it (PyTorch's CUDA division by a scalar
multiplies by its reciprocal, and ``number / tensor`` is ``reciprocal(tensor)
* number``), so the device drifts of ``csrc/control_envs.cuh`` equal these
bit for bit.
"""
from __future__ import annotations

import math
from typing import Tuple

import torch

from .base import ControlEnvironmentBase, time_varying

PI = math.pi


def _div(a: torch.Tensor, s: float) -> torch.Tensor:
    """``a / s`` by true division on every device."""
    return a / torch.full_like(a, s)


def _rdiv(s: float, a: torch.Tensor) -> torch.Tensor:
    """``s / a`` by true division."""
    return torch.full_like(a, s) / a


def _wrap(a: torch.Tensor) -> torch.Tensor:
    """``(a + pi) % (2 pi) - pi``: floored remainder, as ``jnp.remainder``."""
    return torch.remainder(a + PI, 2 * PI) - PI


def _uniform(shape, generator, lo, hi) -> torch.Tensor:
    return lo + (hi - lo) * torch.rand(shape, generator=generator, device=generator.device)


def _switch_series(generator, batch: int, ts: torch.Tensor, lo: float, hi: float) -> torch.Tensor:
    """``(B, T)`` series that jumps once at a switch index drawn from
    ``[T // 4, 3T // 4)`` (JAX ``_switch_series``)."""
    t_steps = ts.shape[0]
    switch = torch.randint(t_steps // 4, 3 * t_steps // 4, (batch,), generator=generator,
                           device=generator.device)
    before = _uniform((batch,), generator, lo, hi)
    after = _uniform((batch,), generator, lo, hi)
    idx = torch.arange(t_steps, device=ts.device)[None, :]
    return torch.where(idx < switch[:, None], before[:, None], after[:, None])


def _decay_series(generator, batch: int, ts: torch.Tensor, lo: float, hi: float,
                  d_min: float = 0.98, d_max: float = 1.02) -> torch.Tensor:
    init = _uniform((batch,), generator, lo, hi)
    decay = _uniform((batch,), generator, d_min, d_max)
    return init[:, None] * decay[:, None] ** ts[None, :]


def _squeeze_control(u: torch.Tensor) -> torch.Tensor:
    return u[..., 0]


class HarmonicOscillator(ControlEnvironmentBase):
    """Damped harmonic oscillator with an LQR-style quadratic cost."""

    tile_safe_drift = True
    n_targets = 1

    def __init__(self, process_noise: float = 0.0, obs_noise: float = 0.0, n_obs: int = 2):
        super().__init__(process_noise, obs_noise, n_var=2, n_control=1, n_dim=1, n_obs=n_obs)
        self.p0 = (3.0, 1.0)
        self.q = self.r = 0.5

    def sample_init_states(self, batch_size, generator):
        dev = generator.device
        z = torch.randn((batch_size, 2), generator=generator, device=dev)
        x0 = z * torch.tensor(self.p0, device=dev)
        targets = _uniform((batch_size, self.n_targets), generator, -3.0, 3.0)
        return x0, targets

    def sample_params(self, batch_size, mode, ts, generator):
        if mode == "Constant":
            return (torch.ones(batch_size, device=ts.device),
                    torch.zeros(batch_size, device=ts.device))
        if mode == "Different":
            return (_uniform((batch_size,), generator, 0.0, 2.0),
                    _uniform((batch_size,), generator, 0.0, 1.5))
        if mode == "Switch":
            return (_switch_series(generator, batch_size, ts, 0.5, 1.5),
                    _switch_series(generator, batch_size, ts, 0.0, 1.0))
        if mode == "Decay":
            return (_decay_series(generator, batch_size, ts, 0.5, 1.5),
                    _decay_series(generator, batch_size, ts, 0.0, 1.0))
        raise ValueError(f"unknown param mode {mode!r}")

    def params_at(self, params, ts, t):
        return tuple(time_varying(p, ts, t) for p in params)

    def drift(self, t, x, u, params):
        omega, zeta = params
        return torch.stack([x[..., 1], -omega * x[..., 0] - zeta * x[..., 1] + u[..., 0]], dim=-1)

    def fitness(self, xs, us, targets, ts, params):
        omega = params[0]
        omega0 = omega if omega.dim() < 2 else omega[:, 0]  # the cost uses the initial physics
        tgt = targets[..., 0]
        u_d = omega0 * tgt
        pos_err = xs[..., 0] - tgt[..., None]
        du = us[..., 0] - u_d[..., None]
        return (self.q * (pos_err * pos_err) + self.r * (du * du)).sum(dim=-1)


class ChangingHarmonicOscillator(HarmonicOscillator):
    """Time-varying A(t) variant: the parameters are series in the Switch and
    Decay modes, interpolated at solver time."""

    def sample_init_states(self, batch_size, generator):
        dev = generator.device
        z = torch.randn((batch_size, 2), generator=generator, device=dev)
        x0 = z * torch.tensor((2.0, 1.0), device=dev)
        return x0, torch.full((batch_size, self.n_targets), -2.0, device=dev)

    def sample_params(self, batch_size, mode, ts, generator):
        if mode == "Decay":  # growing omega, decaying zeta
            return (_decay_series(generator, batch_size, ts, 0.6, 0.6, 1.05, 1.05),
                    _decay_series(generator, batch_size, ts, 0.3, 0.5, 0.97, 0.98))
        return super().sample_params(batch_size, mode, ts, generator)

    def fitness(self, xs, us, targets, ts, params):
        omega = params[0]
        omega_t = (omega[:, None] if omega.dim() < 2 else omega) * torch.ones_like(ts)
        tgt = targets[..., 0]
        u_d = omega_t * tgt[..., None]
        pos_err = xs[..., 0] - tgt[..., None]
        du = us[..., 0] - u_d
        return (self.q * (pos_err * pos_err) + self.r * (du * du)).sum(dim=-1)


class HarmonicOscillator2(ControlEnvironmentBase):
    """Two coupled oscillators, two controls: block-diagonal A with weak
    coupling, written index-wise."""

    tile_safe_drift = True

    def __init__(self, process_noise: float = 0.0, obs_noise: float = 0.0, n_obs=None):
        super().__init__(process_noise, obs_noise, n_var=2, n_control=2, n_dim=2, n_obs=n_obs or 4)
        self.n_targets = 2
        self.p0 = (3.0, 1.0, 3.0, 1.0)
        self.q = self.r = 0.5
        a = torch.zeros((4, 4))
        a[0, 1], a[1, 0], a[2, 3], a[3, 2], a[3, 0], a[1, 2] = 1.0, -1.0, 1.0, -1.0, -0.5, -0.5
        self.a_mat = a
        self.b_mat = torch.zeros((4, 2))
        self.b_mat[1, 0] = self.b_mat[3, 1] = 1.0

    def sample_init_states(self, batch_size, generator):
        dev = generator.device
        z = torch.randn((batch_size, 4), generator=generator, device=dev)
        x0 = z * torch.tensor(self.p0, device=dev)
        return x0, _uniform((batch_size, self.n_targets), generator, -3.0, 3.0)

    def sample_params(self, batch_size, mode, ts, generator):
        return (torch.zeros(batch_size, device=ts.device),)

    def drift(self, t, x, u, params):
        x0, x1, x2, x3 = x.unbind(-1)
        return torch.stack([x1, -x0 - 0.5 * x2 + u[..., 0], x3, -x2 - 0.5 * x0 + u[..., 1]], dim=-1)

    def fitness(self, xs, us, targets, ts, params):
        dev = xs.device
        zeros = torch.zeros_like(targets[..., 0])
        x_d = torch.stack([targets[..., 0], zeros, targets[..., 1], zeros], dim=-1)  # (B, 4)
        u_d = -(x_d @ self.a_mat.to(dev).T @ torch.linalg.pinv(self.b_mat).to(dev).T)  # (B, 2)
        q = torch.tensor([self.q, 0.0, self.q, 0.0], device=dev)
        err = xs - x_d[..., None, :]
        cost_x = (err * q * err).sum(dim=-1)
        du = us - u_d[..., None, :]
        cost_u = self.r * (du * du).sum(dim=-1)
        return (cost_x + cost_u).sum(dim=-1)


class CartPole(ControlEnvironmentBase):
    """Classic cart-pole; the cost counts invalid (diverged) trajectory
    points."""

    tile_safe_drift = True

    def __init__(self, process_noise: float = 0.0, obs_noise: float = 0.0, n_obs: int = 4):
        super().__init__(process_noise, obs_noise, n_var=4, n_control=1, n_dim=1, n_obs=n_obs)
        self.init_bound = 0.05
        self.g = 9.81
        self.pole_mass = 0.1
        self.pole_length = 0.5
        self.cart_mass = 1.0

    def sample_init_states(self, batch_size, generator):
        x0 = _uniform((batch_size, 4), generator, -self.init_bound, self.init_bound)
        return x0, torch.zeros((batch_size, 0), device=generator.device)

    def sample_params(self, batch_size, mode, ts, generator):
        return (torch.zeros(batch_size, device=ts.device),)

    def drift(self, t, x, u, params):
        control = torch.clamp(_squeeze_control(u), -1.0, 1.0)
        theta, x_dot, theta_dot = x[..., 1], x[..., 2], x[..., 3]
        cos_t, sin_t = torch.cos(theta), torch.sin(theta)
        total_mass = self.cart_mass + self.pole_mass
        ml = self.pole_mass * self.pole_length
        td2 = theta_dot * theta_dot
        theta_acc = (
            self.g * sin_t - _div(cos_t * (control + ml * td2 * sin_t), total_mass)
        ) / (self.pole_length * (4.0 / 3.0 - _div(self.pole_mass * (cos_t * cos_t), total_mass)))
        x_acc = _div(control + ml * (td2 * sin_t - theta_acc * cos_t), total_mass)
        return torch.stack([x_dot, theta_dot, x_acc, theta_acc], dim=-1)

    def fitness(self, xs, us, targets, ts, params):
        invalid = torch.isinf(xs).any(dim=-1) | torch.isnan(us[..., 0])
        return invalid.float().sum(dim=-1)


class Acrobot(ControlEnvironmentBase):
    """Underactuated two-link swing-up with one torque: the StaticPolicy and
    DynamicPolicy notebooks' benchmark. Cost = index of the first success
    (tips above 1.5) + the full horizon if never successful + the control
    cost before success; observations wrap both angles into [-pi, pi); a
    velocity bound kills runaway trajectories."""

    tile_safe_drift = True

    def __init__(self, process_noise: float = 0.0, obs_noise: float = 0.0, n_obs: int = 4):
        super().__init__(process_noise, obs_noise, n_var=4, n_control=1, n_dim=1, n_obs=n_obs)
        self.init_bound = 0.1
        self.r_cost = 0.01
        self.g = 9.81
        self.moi = 1.0

    def sample_init_states(self, batch_size, generator):
        x0 = _uniform((batch_size, 4), generator, -self.init_bound, self.init_bound)
        return x0, torch.zeros((batch_size, 0), device=generator.device)

    def sample_params(self, batch_size, mode, ts, generator):
        ones = torch.ones(batch_size, device=ts.device)
        return ones, ones, ones, ones  # l1, l2, m1, m2 (Constant mode)

    def obs(self, x):
        return torch.cat([_wrap(x[..., :2]), x[..., 2:]], dim=-1)[..., : self.n_obs]

    def obs_noisy(self, x, noise):
        y = x[..., : self.n_obs] + noise  # the angles wrap after the noise
        return torch.cat([_wrap(y[..., :2]), y[..., 2:]], dim=-1)

    def _accelerations(self, x, torque1, torque2, params):
        l1, l2, m1, m2 = params
        lc1, lc2 = 0.5 * l1, 0.5 * l2
        th1, th2, dth1, dth2 = x.unbind(-1)
        cos_th2, sin_th2 = torch.cos(th2), torch.sin(th2)
        d1 = m1 * (lc1 * lc1) + m2 * (l1 * l1 + lc2 * lc2 + 2 * l1 * lc2 * cos_th2) + 2 * self.moi
        d2 = m2 * (lc2 * lc2 + l1 * lc2 * cos_th2) + self.moi
        phi2 = m2 * lc2 * self.g * torch.cos(th1 + th2 - PI / 2)
        phi1 = (
            -m2 * l1 * lc2 * (dth2 * dth2) * sin_th2
            - 2 * m2 * l1 * lc2 * dth1 * dth2 * torch.sin(th1)
            + (m1 * lc1 + m2 * l1) * self.g * torch.cos(th1 - PI / 2)
            + phi2
        )
        th2_acc = (
            torque2 + d2 / d1 * phi1 - m2 * l1 * lc2 * (dth1 * dth1) * sin_th2 - phi2
        ) / (m2 * (lc2 * lc2) + self.moi - d2 * d2 / d1)
        th1_acc = -(torque1 + d2 * th2_acc + phi1) / d1
        return torch.stack([dth1, dth2, th1_acc, th2_acc], dim=-1)

    def drift(self, t, x, u, params):
        # one torque, on the second joint
        control = torch.clamp(_squeeze_control(u), -1.0, 1.0)
        return self._accelerations(x, 0.0, control, params)

    def fitness(self, xs, us, targets, ts, params):
        a0 = xs[..., 0]
        reached = -torch.cos(a0) - torch.cos(a0 + xs[..., 1]) > 1.5
        first = torch.argmax(reached.int(), dim=-1)  # the first success, 0 if none
        control_cost = self.r_cost * (us * us).sum(dim=-1)
        step_idx = ts / (ts[1] - ts[0])
        costs = torch.where(step_idx > first[..., None], torch.zeros_like(control_cost), control_cost)
        horizon = torch.where(first == 0, ts.shape[0], 0)
        return (first + horizon).float() + costs.sum(dim=-1)

    def cond_alive(self, t, x):
        return (x[..., 2].abs() <= 8 * PI) & (x[..., 3].abs() <= 18 * PI)


class Acrobot2(Acrobot):
    """Two-torque acrobot with randomisable physics."""

    def __init__(self, process_noise: float = 0.0, obs_noise: float = 0.0, n_obs=None):
        super().__init__(process_noise, obs_noise, n_obs=n_obs or 4)
        self.n_control = 2

    def sample_params(self, batch_size, mode, ts, generator):
        if mode == "Constant":
            ones = torch.ones(batch_size, device=ts.device)
            return ones, ones, ones, ones
        if mode == "Different":
            return tuple(_uniform((batch_size,), generator, 0.75, 1.25) for _ in range(4))
        if mode == "Switch":
            return tuple(_switch_series(generator, batch_size, ts, 0.75, 1.25) for _ in range(4))
        if mode == "Decay":
            return tuple(_decay_series(generator, batch_size, ts, 0.75, 1.25) for _ in range(4))
        raise ValueError(f"unknown param mode {mode!r}")

    def params_at(self, params, ts, t):
        return tuple(time_varying(p, ts, t) for p in params)

    def drift(self, t, x, u, params):
        # control 0 acts on joint 2, control 1 on joint 1 with its sign flipped
        control = torch.clamp(u, -1.0, 1.0)
        return self._accelerations(x, -control[..., 1], control[..., 0], params)


class StirredTankReactor(ControlEnvironmentBase):
    """Exothermic CSTR with Arrhenius kinetics and coolant control. State
    ``(Tc, T, c)``."""

    tile_safe_drift = True

    def __init__(self, process_noise: float = 0.0, obs_noise: float = 0.0, n_obs: int = 3,
                 n_targets: int = 1):
        super().__init__(process_noise, obs_noise, n_var=3, n_control=1, n_dim=1, n_obs=n_obs)
        self.n_targets = n_targets
        self.init_lower = (275.0, 350.0, 0.5)
        self.init_upper = (300.0, 375.0, 1.0)
        self.ea_over_r = 72750.0 / 8.314
        self.k0 = 7.2e10
        self.cf = 1.0
        self.q_t = 0.01
        self.r_u = 0.0001

    def sample_init_states(self, batch_size, generator):
        dev = generator.device
        lo, hi = torch.tensor(self.init_lower, device=dev), torch.tensor(self.init_upper, device=dev)
        x0 = lo + (hi - lo) * torch.rand((batch_size, 3), generator=generator, device=dev)
        return x0, _uniform((batch_size, self.n_targets), generator, 400.0, 500.0)

    def sample_params(self, batch_size, mode, ts, generator):
        ones = torch.ones(batch_size, device=ts.device)
        if mode == "Constant":
            return (100 * ones, 239 * ones, -5.0e4 * ones, 5.0e4 * ones,
                    100 * ones, 300 * ones, 300 * ones, 20.0 * ones)
        if mode == "Different":
            ranges = [(75, 150), (200, 350), (-55000, -45000), (25000, 75000),
                      (75, 125), (300, 350), (250, 300), (10, 30)]
            return tuple(_uniform((batch_size,), generator, float(lo), float(hi)) for lo, hi in ranges)
        raise ValueError(f"unknown param mode {mode!r}")

    def _obs_matrices(self, params):
        c = torch.eye(3)[: self.n_obs]
        w = self.obs_noise * torch.eye(self.n_obs) * torch.tensor([15.0, 15.0, 0.1])[: self.n_obs]
        return c, w

    def drift(self, t, x, u, params):
        vol, cp, dhr, ua, q, tf, tcf, volc = params
        tc, temp, c = x[..., 0], x[..., 1], torch.clamp(x[..., 2], 0.0, 1.0)
        control = torch.clamp(_squeeze_control(u), 0.0, 300.0)
        k_rate = self.k0 * torch.exp(_rdiv(-self.ea_over_r, temp))
        dc = (q / vol) * (self.cf - c) - k_rate * c
        dtemp = (q / vol) * (tf - temp) + (-dhr / cp) * k_rate * c + (ua / vol / cp) * (tc - temp)
        dtc = (control / volc) * (tcf - tc) + (ua / volc / cp) * (temp - tc)
        return torch.stack([dtc, dtemp, dc], dim=-1)

    def fitness(self, xs, us, targets, ts, params):
        temp_err = xs[..., 1] - targets[..., 0][..., None]
        u0 = us[..., 0]
        return (self.q_t * (temp_err * temp_err) + self.r_u * (u0 * u0)).sum(dim=-1)


CONTROL_ENVIRONMENTS = (HarmonicOscillator, ChangingHarmonicOscillator, HarmonicOscillator2,
                        CartPole, Acrobot, Acrobot2, StirredTankReactor)
