// Device drifts of the seven control environments
// (models/environments/control_envs.py), for the closed-loop policy kernels
// (policy.cu). One struct per plant: its latent size, controls and
// parameters as compile-time constants, the batched torch drift of one lane
// in the same float32 expression order, its `cond_alive`, and the angle
// wrapping of its observation (the observation is the first n_obs latent
// components, plus the noise row where one is given, then wrapped). Each
// sets kObs = kLatent (the observation's slots in the trees' data vector)
// and kTraced = false. A user environment's plant has the same members
// but its own observation (kTraced = true, kObs = n_obs, `observe(x,
// noise_or_null, y)` in place of `wrap_obs`); core/user_envs.py generates
// it, as mtgp_env::UserEnv, into a header that the user-environment build
// includes (-DMTGP_USER_ENV, environment id kUserEnv).
//
// Numerics, as in the torch versions: Python constants are float32 values of
// the JAX package's doubles (f32(9.81), f32(pi / 2), f32(72750.0 / 8.314));
// x**2 is x * x; a division divides (never a reciprocal times); the floored
// remainder is fmodf plus the divisor where the signs differ, as
// torch.remainder and jnp.remainder compute it; a clip is torch.clamp's,
// NaN in, NaN out; sinf/cosf/expf are the C library's on the host and CUDA's
// on the card, the functions PyTorch's CUDA torch.sin/cos/exp call.
//
// Plain C++ under MTGP_HD, so the host build tests it.
#pragma once

#include "tree_eval.cuh"

namespace {

// environment ids: core/cuda_policy.py ENV_IDS
enum EnvId {
  kHarmonicOscillator = 0,
  kChangingHarmonicOscillator = 1,
  kHarmonicOscillator2 = 2,
  kCartPole = 3,
  kAcrobot = 4,
  kAcrobot2 = 5,
  kStirredTankReactor = 6,
  kUserEnv = 7,  // core/user_envs.py USER_ENV_ID: the user-environment build's one plant
};

constexpr double kPi = 3.141592653589793;  // jnp.pi

// torch.clamp(v, lo, hi): NaN in, NaN out
MTGP_HD inline float clamp_f(float v, float lo, float hi) {
  return isnan(v) ? v : fminf(fmaxf(v, lo), hi);
}

// (a + pi) % (2 pi) - pi with the floored remainder
MTGP_HD inline float wrap_angle(float a) {
  const float b = f32(2 * kPi);
  float m = fmodf(a + f32(kPi), b);
  if (m != 0.0f && ((b < 0.0f) != (m < 0.0f))) m = m + b;
  return m - f32(kPi);
}

// Both harmonic oscillators (the changing one differs only in its
// parameters, which the kernel interpolates): params (omega, zeta).
struct HarmonicOscillatorEnv {
  static constexpr int kLatent = 2, kControls = 1, kParams = 2;
  static constexpr int kObs = kLatent;
  static constexpr bool kTraced = false;
  MTGP_HD static void drift(const float* x, const float* u, const float* p, float* dx) {
    const float omega = p[0], zeta = p[1];
    dx[0] = x[1];
    dx[1] = (-omega * x[0] - zeta * x[1]) + u[0];
  }
  MTGP_HD static bool alive(const float*) { return true; }
  MTGP_HD static void wrap_obs(float*) {}
};

// Two coupled oscillators, two controls; params (unused,).
struct HarmonicOscillator2Env {
  static constexpr int kLatent = 4, kControls = 2, kParams = 1;
  static constexpr int kObs = kLatent;
  static constexpr bool kTraced = false;
  MTGP_HD static void drift(const float* x, const float* u, const float*, float* dx) {
    dx[0] = x[1];
    dx[1] = (-x[0] - 0.5f * x[2]) + u[0];
    dx[2] = x[3];
    dx[3] = (-x[2] - 0.5f * x[0]) + u[1];
  }
  MTGP_HD static bool alive(const float*) { return true; }
  MTGP_HD static void wrap_obs(float*) {}
};

// Cart-pole; params (unused,).
struct CartPoleEnv {
  static constexpr int kLatent = 4, kControls = 1, kParams = 1;
  static constexpr int kObs = kLatent;
  static constexpr bool kTraced = false;
  MTGP_HD static void drift(const float* x, const float* u, const float*, float* dx) {
    const float control = clamp_f(u[0], -1.0f, 1.0f);
    const float theta = x[1], x_dot = x[2], theta_dot = x[3];
    const float cos_t = cosf(theta), sin_t = sinf(theta);
    const float total_mass = f32(1.0 + 0.1);  // cart + pole
    const float ml = f32(0.1 * 0.5);          // pole mass * pole length
    const float td2 = theta_dot * theta_dot;
    const float theta_acc =
        (f32(9.81) * sin_t - (cos_t * (control + ml * td2 * sin_t)) / total_mass) /
        (f32(0.5) * (f32(4.0 / 3.0) - (f32(0.1) * (cos_t * cos_t)) / total_mass));
    const float x_acc = (control + ml * (td2 * sin_t - theta_acc * cos_t)) / total_mass;
    dx[0] = x_dot;
    dx[1] = theta_dot;
    dx[2] = x_acc;
    dx[3] = theta_acc;
  }
  MTGP_HD static bool alive(const float*) { return true; }
  MTGP_HD static void wrap_obs(float*) {}
};

// Acrobot (one torque, on the second joint) and Acrobot2 (control 0 on the
// second joint, control 1 on the first with its sign flipped); params
// (l1, l2, m1, m2).
template <bool kTwoTorques>
struct AcrobotEnv {
  static constexpr int kLatent = 4, kControls = kTwoTorques ? 2 : 1, kParams = 4;
  static constexpr int kObs = kLatent;
  static constexpr bool kTraced = false;
  MTGP_HD static void drift(const float* x, const float* u, const float* p, float* dx) {
    const float l1 = p[0], l2 = p[1], m1 = p[2], m2 = p[3];
    const float torque2 = clamp_f(u[0], -1.0f, 1.0f);
    const float torque1 = kTwoTorques ? -clamp_f(u[1], -1.0f, 1.0f) : 0.0f;
    const float lc1 = 0.5f * l1, lc2 = 0.5f * l2;
    const float th1 = x[0], th2 = x[1], dth1 = x[2], dth2 = x[3];
    const float cos_th2 = cosf(th2), sin_th2 = sinf(th2);
    const float g = f32(9.81);
    const float d1 = (m1 * (lc1 * lc1) + m2 * ((l1 * l1 + lc2 * lc2) + 2.0f * l1 * lc2 * cos_th2)) +
                     2.0f;
    const float d2 = m2 * (lc2 * lc2 + l1 * lc2 * cos_th2) + 1.0f;
    const float phi2 = m2 * lc2 * g * cosf((th1 + th2) - f32(kPi / 2));
    // the reference's sin(th1) in the second term, kept
    const float phi1 = ((-m2 * l1 * lc2 * (dth2 * dth2) * sin_th2 -
                         2.0f * m2 * l1 * lc2 * dth1 * dth2 * sinf(th1)) +
                        (m1 * lc1 + m2 * l1) * g * cosf(th1 - f32(kPi / 2))) +
                       phi2;
    const float th2_acc =
        (((torque2 + d2 / d1 * phi1) - m2 * l1 * lc2 * (dth1 * dth1) * sin_th2) - phi2) /
        ((m2 * (lc2 * lc2) + 1.0f) - d2 * d2 / d1);
    const float th1_acc = -((torque1 + d2 * th2_acc) + phi1) / d1;
    dx[0] = dth1;
    dx[1] = dth2;
    dx[2] = th1_acc;
    dx[3] = th2_acc;
  }
  MTGP_HD static bool alive(const float* x) {
    return fabsf(x[2]) <= f32(8 * kPi) && fabsf(x[3]) <= f32(18 * kPi);
  }
  MTGP_HD static void wrap_obs(float* y) {
    y[0] = wrap_angle(y[0]);
    y[1] = wrap_angle(y[1]);
  }
};

// Exothermic stirred-tank reactor, state (Tc, T, c); params (vol, cp, dhr,
// ua, q, tf, tcf, volc).
struct StirredTankReactorEnv {
  static constexpr int kLatent = 3, kControls = 1, kParams = 8;
  static constexpr int kObs = kLatent;
  static constexpr bool kTraced = false;
  MTGP_HD static void drift(const float* x, const float* u, const float* p, float* dx) {
    const float vol = p[0], cp = p[1], dhr = p[2], ua = p[3], q = p[4], tf = p[5], tcf = p[6],
                volc = p[7];
    const float tc = x[0], temp = x[1], c = clamp_f(x[2], 0.0f, 1.0f);
    const float control = clamp_f(u[0], 0.0f, 300.0f);
    const float k_rate = f32(7.2e10) * expf(f32(-(72750.0 / 8.314)) / temp);
    dx[2] = (q / vol) * (1.0f - c) - k_rate * c;
    dx[1] = ((q / vol) * (tf - temp) + (-dhr / cp) * k_rate * c) + (ua / vol / cp) * (tc - temp);
    dx[0] = (control / volc) * (tcf - tc) + (ua / volc / cp) * (temp - tc);
  }
  MTGP_HD static bool alive(const float*) { return true; }
  MTGP_HD static void wrap_obs(float*) {}
};

}  // namespace
