// Closed-loop symbolic-policy rollouts: fixed step and adaptive.
//
// Replaces two TPU kernels of multitreegp_tpu/core/pallas_policy.py:
//   * `_make_policy_kernel` (reached through `rollout_policy_pallas` ->
//     `pl.pallas_call`): the fixed-step closed loop, `policy_kernel`;
//   * `_make_adaptive_policy_kernel` (`rollout_policy_adaptive_pallas` ->
//     `pl.pallas_call`): the Dopri5/Bosh3 + I-controller closed loop with a
//     step budget per save interval, `policy_adaptive_kernel`.
// Per lane (candidate x trajectory) both integrate an environment's plant
// (control_envs.cuh) driven by the candidate's trees:
//   static  u = trees([y, tgt]);                      dx = env.drift(x, u)
//   dynamic u = readout([0s(n_obs), a, 0s(n_ctrl), tgt]); dx = env.drift(x, u);
//           da = state_trees([y, a, u, tgt])
// with y the observation of the latent state, and write the augmented state
// [x, a] and the controls at every save point (the controls with real
// observations, zero-fed u), and the count of alive save rows (liveness is
// monotone, so save t is alive iff t < count).
//
// Fixed step: euler/heun/rk4, `substeps` steps of one size h = (ts[1] -
// ts[0]) / substeps over the whole grid; a lane dies when its state turns
// non-finite, reaches |x| >= 1e8 or fails the plant's `cond_alive`, and is
// frozen from then on. Parameters are per trajectory, or (B, T) rows
// interpolated at the stage's fraction of the interval (`streamed`: then
// every parameter is, as in the TPU kernel); optional observation-noise rows
// are added to the observation at every stage and save, and optional
// Euler-Maruyama kicks to the latent state after every substep.
// Adaptive: adaptive_step.cuh's embedded step and controller, as the SR
// per-interval kernel (sr_adaptive.cu), except that `cond_alive` rejects a
// step instead of killing the lane, liveness starts as finite & cond_alive,
// and the error norm runs over the augmented state; per-trajectory params, no
// noise. It also returns the attempted steps per lane.
//
// What bounds it on this card: the latency of each tree row's dependent
// chain, then instruction issue, and (adaptive) warp divergence. Per step a
// lane evaluates its trees at every stage (the readout, the plant, the
// state trees) and reads nothing but its trees (staged once per block in
// shared memory), its row of parameters or noise, and the grid; it writes
// (T, d_aug + n_control) floats. Bytes are negligible.
//
// Design: one thread per lane, candidate-major. A block decodes its
// candidates' trees once, when it stages them into shared memory, into the
// programs of tree_prog.cuh (the tree machine of #1): 8-byte rows with the
// device op id or data slot folded in, the first live row of each tree, a
// static stack slot per row; the top of each tree's stack in a register, the
// rest in local memory (N / 2 slots a tree, for the larger of the two tree
// groups below), branch-free rows. A static policy's n_control trees run as
// independent chains in one row loop; a dynamic one runs its readout, then
// its state_size state trees as independent chains in one loop; the
// save-point controls run the readout program. The closed-loop drift is
// inlined into the fixed-step kernel, whose stage loop is a runtime loop
// (one call site); the adaptive kernel calls it out of line at each of the
// embedded step's stages (inlined at those nine call sites, its card build
// computed wrong lanes while its host build did not; PERF.md section 6).
// The adaptive kernel's lane runs one flat loop: each
// iteration attempts one step or, once the lane's interval is finished
// (budget spent, dead, or t >= t1 - 1e-12), closes the interval (the reach
// test, the save row, the next interval's t0 and the clip of dt), so a warp
// runs as many iterations as its slowest lane's steps and saves, not the
// sum over intervals of each interval's slowest lane. A block holds at most
// 128 trajectories of a candidate (a candidate with more spans several
// blocks), so a block never exceeds 128 threads whatever the instance's
// registers. State, stages, t, dt and the FSAL k1 live in registers;
// templates on the plant, the policy's
// state size (0 = static, d_aug = latent + state size) and the stack bound
// (N <= 32 or 256). The tree's data vector has fixed slots [y (latent; a
// user plant's kObs), a (state size), u (controls), targets (2)]; the wrapper
// rewrites each variable opcode to its slot, so a leaf is a chain of
// selects over registers whatever n_obs and n_targets are. The TPU kernels'
// (8, 128) tiles, size sort, row-trip tables, double-buffered row staging,
// `go_scr` early exit and VMEM gate are not carried over: a thread reads its
// own rows and stops stepping once its lane is done.
//
// Numerics: the TPU kernels' float32 expressions in their order (the plain
// versions in core/cuda_policy.py): stage inputs x + (h*c)*k and the update
// x + (h*final_scale)*acc with acc = 0 + w1*k1 + ..., the scalars h*c and
// h*final_scale rounded once from double by the wrapper; the interpolation
// lo*(1-frac) + hi*frac with frac = (s + c) * (1/substeps); each tree row
// applies the operator of tree_eval.cuh to the operands of its stack machine.
// Built with -fmad=false and IEEE division and square root.
//
// The wide-state instance (built with -DMTGP_WIDE_STATE, the `_wide`
// libraries, and only there) takes any hidden state size, any number of
// targets and any number of trajectories, for what the fixed instances
// (state_size <= 2, <= 2 targets) do not take: the augmented state [x, a],
// the stage inputs, the stages and their sums (#7: the seven stages, x_hi
// and the FSAL k1) are lane vectors of latent + state_size floats in a
// scratch buffer the wrapper allocates, and so is the trees' data vector
// [y, a, u, tgt] of latent + state_size + n_control + n_targets floats, a
// leaf reading its slot there through the wide row's 29-bit field; the
// state trees run four at a time, the readout trees as one group
// (tree_prog_wide.cuh); the plant's latent block and the controls stay in
// registers. The same expressions in the same order, so where a fixed
// instance runs a wide lane is bit-equal to it, and at any size to the
// plain versions. #7's drift stays out of line, as in its fixed instance.
//
// The user-environment build (built with -DMTGP_USER_ENV and -include of a
// header that core/user_envs.py generates from a torch environment's
// drift, cond_alive, obs and obs_noisy, the `_e<hash>` libraries) has one
// plant, mtgp_env::UserEnv, in every instance, fixed and wide, in place of
// the seven hand-written ones: the role of JAX's kernels tracing any
// `tile_safe_drift` environment into their body. Its observation is its own
// `observe` (kObs floats, which may exceed the latent size), so the data
// vector is [y (kObs), a, u, tgt]; a built-in plant's kObs is its kLatent, and
// its instances compile as they did.
//
// The per-lane code is plain C++ under MTGP_HD, so the same file also
// compiles for the host (without __CUDACC__) into a lane loop that decodes
// every candidate as a block does and that tests run against the plain
// versions on machines without a card.
#include "adaptive_step.cuh"
#include "control_envs.cuh"
#include "tree_prog.cuh"
#ifdef MTGP_WIDE_STATE
#include "tree_prog_wide.cuh"
#endif

namespace {

constexpr int kMaxTargets = 2;
constexpr int kMaxStateSize = 2;

// A lane's vector passed by value: the adaptive kernel's out-of-line drift
// call takes and returns its vectors in registers.
template <int N>
struct Vec {
  float v[N];
};

#ifdef __CUDACC__
#define MTGP_NOINLINE __noinline__
#else
#define MTGP_NOINLINE
#endif

enum Method { kEuler = 0, kHeun = 1, kRk4 = 2 };

// Everything a launch reads and writes; filled by the wrapper
// (core/cuda_policy.py _Args, field for field).
struct PolicyArgs {
  const int* ops;          // (P, m, n) with variable opcodes rewritten to slots
  const float* cst;        // (P, m, n)
  const int* devop;        // (num operators,) device op ids
  const float* x0;         // (B, latent)
  const float* tgt;        // (B, n_targets)
  const float* par;        // (B, n_params), or (T, B, n_params) rows when streamed
  const float* obs_rows;   // (T, B, k_obs) or null
  const float* kick_rows;  // (T, B, substeps * latent) or null
  const float* ts;         // (T,) (adaptive)
  float* xs;               // (T, P, B, d_aug)
  float* us;               // (T, P, B, n_control)
  int* alive;              // (P, B) count of alive save rows
  int* steps;              // (P, B) attempted steps (adaptive)
  int env, state_size, P, m, n, B, T, var_start, n_obs, n_targets;
  int method, substeps, streamed, k_obs, max_steps;
  float h_half, h_full, h_final, inv_sub;  // fixed step: h*0.5, h, h*final_scale, 1/substeps
  float rtol, atol, safety;                // adaptive
};

// The policy of one lane: its decoded trees (the SS state trees, then the NC
// readout trees), the first live row of each group, its targets, its stack
// slots (those of the larger group; the groups run one after the other).
template <class Env, int SS, int N>
struct LanePolicy {
  static constexpr int L = Env::kLatent, NC = Env::kControls, NP = Env::kParams, D = L + SS;
  static constexpr int O = Env::kObs;                     // the observation's floats
  static constexpr int M = SS + NC;                       // trees per candidate
  static constexpr int G = NC > SS ? NC : SS;             // trees in the larger group
  static constexpr int KD = O + SS + NC + kMaxTargets;    // data slots [y, a, u, tgt]
  static_assert(Env::kTraced || O == L, "a built-in plant observes its latent state");
  const Row* prog;  // tree k's rows at prog + k * n
  int n;
  int first_state, first_readout;
  int n_obs;
  float tgt[kMaxTargets];
  float* stk;  // G trees' slots, tree k's at k * stack_slots<N>()

  // out[k] = tree (tree0 + k) on data, the K trees as K chains of one loop
  template <int K>
  MTGP_HD void run(int tree0, int first, const float (&data)[KD], float (&out)[K]) const {
    run_trees<K, KD, true>(prog + tree0 * n, first, n, data, out, stk, stack_slots<N>());
  }

  // y = the observation of the latent state x (+ the noise row, if any)
  MTGP_HD void observe(const float* x, const float* noise, float (&y)[O]) const {
    if constexpr (Env::kTraced) {
      Env::observe(x, noise, y);
    } else {
#pragma unroll
      for (int q = 0; q < L; ++q) y[q] = (noise != nullptr && q < n_obs) ? x[q] + noise[q] : x[q];
      Env::wrap_obs(y);
    }
  }

  // data = [y or 0, a, u or 0, tgt]
  MTGP_HD void fill(float (&data)[KD], const float* y, const float* x, const float* u) const {
#pragma unroll
    for (int q = 0; q < O; ++q) data[q] = y ? y[q] : 0.0f;
#pragma unroll
    for (int j = 0; j < SS; ++j) data[O + j] = x[L + j];
#pragma unroll
    for (int j = 0; j < NC; ++j) data[O + SS + j] = u ? u[j] : 0.0f;
#pragma unroll
    for (int j = 0; j < kMaxTargets; ++j) data[O + SS + NC + j] = tgt[j];
  }

  // dx = the closed loop's drift at the augmented state x
  MTGP_HD void drift(const float (&x)[D], const float* p, const float* noise, float (&dx)[D]) const {
    float y[O], data[KD], u[NC];
    observe(x, noise, y);
    // the readout; a dynamic one sees the hidden state and the targets only
    fill(data, SS > 0 ? nullptr : y, x, nullptr);
    run<NC>(SS, first_readout, data, u);
    Env::drift(x, u, p, dx);
    if constexpr (SS > 0) {
      float da[SS];
      fill(data, y, x, u);
      run<SS>(0, first_state, data, da);
#pragma unroll
      for (int j = 0; j < SS; ++j) dx[L + j] = da[j];
    }
  }

  // drift() as one out-of-line call, arguments and result by value
  MTGP_NOINLINE MTGP_HD Vec<D> drift_v(const Vec<D> x, const Vec<NP> p) const {
    Vec<D> dx;
    drift(x.v, p.v, nullptr, dx.v);
    return dx;
  }

  MTGP_HD void drift_call(const float (&x)[D], const float (&p)[NP], float (&dx)[D]) const {
    Vec<D> xv;
    Vec<NP> pv;
#pragma unroll
    for (int q = 0; q < D; ++q) xv.v[q] = x[q];
#pragma unroll
    for (int j = 0; j < NP; ++j) pv.v[j] = p[j];
    const Vec<D> kv = drift_v(xv, pv);
#pragma unroll
    for (int q = 0; q < D; ++q) dx[q] = kv.v[q];
  }

  // the controls at a save point: real observations, u zero-fed
  MTGP_HD void controls(const float (&x)[D], const float* noise, float (&u)[NC]) const {
    float y[O], data[KD];
    observe(x, noise, y);
    fill(data, y, x, nullptr);
    run<NC>(SS, first_readout, data, u);
  }

  // finite, below the divergence bound, and the plant's cond_alive
  MTGP_HD static bool ok(const float (&x)[D]) {
    bool good = true;
#pragma unroll
    for (int q = 0; q < D; ++q) good = good && isfinite(x[q]) && fabsf(x[q]) < kBound;
    return good && Env::alive(x);
  }
};

// The policy of trajectory b of a candidate whose decoded trees are `prog`
// and their first live rows `starts`.
template <class Env, int SS, int N>
MTGP_HD LanePolicy<Env, SS, N> lane_policy(const PolicyArgs& a, const Row* prog,
                                           const int* starts, int b, float* stk) {
  using Pol = LanePolicy<Env, SS, N>;
  Pol pol{prog, a.n, a.n, a.n, a.n_obs, {}, stk};
#pragma unroll
  for (int k = 0; k < Pol::M; ++k) {
    int& first = k < SS ? pol.first_state : pol.first_readout;
    first = starts[k] < first ? starts[k] : first;
  }
#pragma unroll
  for (int j = 0; j < kMaxTargets; ++j)
    pol.tgt[j] = j < a.n_targets ? a.tgt[b * a.n_targets + j] : 0.0f;
  return pol;
}

// Writes save row t of this lane: the augmented state and the controls.
template <class Env, int SS, int N>
MTGP_HD void save_row(const PolicyArgs& a, const LanePolicy<Env, SS, N>& pol, size_t lane, int t,
                      const float (&x)[Env::kLatent + SS], const float* noise) {
  constexpr int D = Env::kLatent + SS, NC = Env::kControls;
  const size_t row = static_cast<size_t>(t) * a.P * a.B + lane;
  float u[NC];
  pol.controls(x, noise, u);
#pragma unroll
  for (int q = 0; q < D; ++q) a.xs[row * D + q] = x[q];
#pragma unroll
  for (int j = 0; j < NC; ++j) a.us[row * NC + j] = u[j];
}

template <class Env, int SS>
MTGP_HD void init_state(const PolicyArgs& a, int b, float (&x)[Env::kLatent + SS]) {
  constexpr int L = Env::kLatent;
#pragma unroll
  for (int q = 0; q < L; ++q) x[q] = a.x0[b * L + q];
#pragma unroll
  for (int j = 0; j < SS; ++j) x[L + j] = 0.0f;
}

// The fixed-step closed loop of one lane.
template <class Env, int SS, int N>
MTGP_HD void policy_lane(const PolicyArgs& a, const Row* prog, const int* starts, int b,
                         size_t lane) {
  constexpr int L = Env::kLatent, NP = Env::kParams, D = L + SS;
  using Pol = LanePolicy<Env, SS, N>;
  float stk[Pol::G * stack_slots<N>()];
  const Pol pol = lane_policy<Env, SS, N>(a, prog, starts, b, stk);
  const bool rk4 = a.method == kRk4;
  const int n_stages = rk4 ? 4 : (a.method == kHeun ? 2 : 1);
  const int k_obs = a.k_obs;
  const size_t traj = static_cast<size_t>(b);

  float x[D];
  init_state<Env, SS>(a, b, x);
  bool alive = Pol::ok(x);
  const float* save_noise = a.obs_rows ? a.obs_rows + traj * k_obs : nullptr;
  save_row<Env, SS, N>(a, pol, lane, 0, x, save_noise);
  int count = alive ? 1 : 0;
  float p[NP];  // per trajectory, or interpolated at every stage when streamed
#pragma unroll
  for (int k = 0; k < NP; ++k) p[k] = a.streamed ? 0.0f : a.par[traj * NP + k];
  for (int t = 0; t + 1 < a.T; ++t) {
    // rows t and t+1 of the streamed parameters
    const float* lo = a.streamed ? a.par + (static_cast<size_t>(t) * a.B + traj) * NP : a.par;
    const float* hi = a.streamed ? lo + static_cast<size_t>(a.B) * NP : a.par;
    const float* noise_t = a.obs_rows ? a.obs_rows + (static_cast<size_t>(t) * a.B + traj) * k_obs
                                      : nullptr;
    for (int s = 0; s < a.substeps && alive; ++s) {
      float acc[D], k[D], xst[D], xn[D];
#pragma unroll
      for (int q = 0; q < D; ++q) acc[q] = 0.0f;
      // a runtime loop: the drift below is its one inlined call site
#pragma unroll 1
      for (int st = 0; st < n_stages; ++st) {
        // the stage's offset c, weight w and scalar h*c (pallas_rollout
        // _RK_TABLES: rk4 (0, 1) (0.5, 2) (0.5, 2) (1, 1); heun (0, 1) (1, 1))
        const float c = st == 0 ? 0.0f : (rk4 && st < 3 ? 0.5f : 1.0f);
        const float w = rk4 && (st == 1 || st == 2) ? 2.0f : 1.0f;
        const float hc = rk4 && st < 3 ? a.h_half : a.h_full;
        if (a.streamed) {
          const float frac = (static_cast<float>(s) + c) * a.inv_sub;
          const float keep = 1.0f - frac;
#pragma unroll
          for (int j = 0; j < NP; ++j) p[j] = lo[j] * keep + hi[j] * frac;
        }
        if (st == 0) {
#pragma unroll
          for (int q = 0; q < D; ++q) xst[q] = x[q];
        } else {
#pragma unroll
          for (int q = 0; q < D; ++q) xst[q] = x[q] + hc * k[q];
        }
        const float* noise = noise_t ? noise_t + (s * n_stages + st) * a.n_obs : nullptr;
        pol.drift(xst, p, noise, k);
#pragma unroll
        for (int q = 0; q < D; ++q) acc[q] = acc[q] + w * k[q];
      }
#pragma unroll
      for (int q = 0; q < D; ++q) xn[q] = x[q] + a.h_final * acc[q];
      if (a.kick_rows) {  // Euler-Maruyama: the latent block only
        const float* kick =
            a.kick_rows + (static_cast<size_t>(t) * a.B + traj) * a.substeps * L + s * L;
#pragma unroll
        for (int q = 0; q < L; ++q) xn[q] = xn[q] + kick[q];
      }
      alive = Pol::ok(xn);
      if (alive) {
#pragma unroll
        for (int q = 0; q < D; ++q) x[q] = xn[q];
      }
    }
    const float* noise_save =
        a.obs_rows ? a.obs_rows + (static_cast<size_t>(t + 1) * a.B + traj) * k_obs : nullptr;
    save_row<Env, SS, N>(a, pol, lane, t + 1, x, noise_save);
    count += alive ? 1 : 0;
  }
  a.alive[lane] = count;
}

// rk_step's drift: the closed loop at constant params, no noise
template <class Env, int SS, int N>
struct PolicyDrift {
  const LanePolicy<Env, SS, N>& pol;
  const float (&p)[Env::kParams];
  MTGP_HD void operator()(const float (&x)[Env::kLatent + SS],
                          float (&k)[Env::kLatent + SS]) const {
    pol.drift_call(x, p, k);
  }
};

// The adaptive closed loop of one lane (per-interval budget), as one flat
// loop: an iteration attempts a step of the open interval ti while the lane
// has budget, lives and has not crossed t1; otherwise it closes the interval
// and opens the next. The same steps, in the same order, as a loop over
// intervals with a step loop inside each.
template <class Env, int SS, int N>
MTGP_HD void policy_adaptive_lane(const PolicyArgs& a, const Row* prog, const int* starts, int b,
                                  size_t lane) {
  constexpr int NP = Env::kParams, D = Env::kLatent + SS;
  using Pol = LanePolicy<Env, SS, N>;
  float stk[Pol::G * stack_slots<N>()];
  const Pol pol = lane_policy<Env, SS, N>(a, prog, starts, b, stk);
  float p[NP];
#pragma unroll
  for (int k = 0; k < NP; ++k) p[k] = a.par[static_cast<size_t>(b) * NP + k];
  const PolicyDrift<Env, SS, N> f{pol, p};

  float x[D], k1[D];
  init_state<Env, SS>(a, b, x);
  bool alive = Pol::ok(x);
  save_row<Env, SS, N>(a, pol, lane, 0, x, nullptr);
  int count = alive ? 1 : 0;
  int steps = 0;
  if (a.T > 1) {
    const float expo = error_exponent(a.method);
    f(x, k1);  // the one up-front evaluation FSAL amortises
    float dt = (a.ts[1] - a.ts[0]) / 4.0f;
    // the open interval [t0, t1) = [ts[ti], ts[ti + 1]), t in it, s its steps so far
    int ti = 0, s = 0;
    float t1 = a.ts[1];
    float span = t1 - a.ts[0];
    float t = a.ts[0];
    dt = clip(dt, span * kDtMin, span);
    while (true) {
      if (s < a.max_steps && alive && t < t1 - kCross) {
        const float dt_c = nan_min(dt, t1 - t);
        float x_hi[D], k_last[D];
        const float err = rk_step<D>(f, a.method, x, k1, dt_c, a.rtol, a.atol, x_hi, k_last);
        bool finite_hi = true;
#pragma unroll
        for (int q = 0; q < D; ++q)
          finite_hi = finite_hi && isfinite(x_hi[q]) && fabsf(x_hi[q]) < kBound;
        const bool ok = finite_hi && isfinite(err);
        // cond_alive rejects the step (integrate_adaptive's accept)
        if (ok && err <= 1.0f && Env::alive(x_hi)) {
#pragma unroll
          for (int q = 0; q < D; ++q) {
            x[q] = x_hi[q];
            k1[q] = k_last[q];
          }
          t = t + dt_c;
        }
        dt = clip(dt_c * step_factor(err, ok, a.safety, expo), span * kDtMin, span);
        alive = alive && (ok || dt_c > span * kDtDead);
        ++s;
        ++steps;
      } else {
        alive = alive && t >= t1 - kReach * nan_max(fabsf(t1), 1.0f);
        save_row<Env, SS, N>(a, pol, lane, ti + 1, x, nullptr);
        count += alive ? 1 : 0;
        if (++ti + 1 >= a.T) break;
        const float t0 = a.ts[ti];
        t1 = a.ts[ti + 1];
        span = t1 - t0;
        t = t0;
        dt = clip(dt, span * kDtMin, span);
        s = 0;
      }
    }
  }
  a.alive[lane] = count;
  a.steps[lane] = steps;
}

enum Kind { kFixed = 0, kAdaptive = 1 };

#ifdef __CUDACC__
// The most trajectories of one candidate a block holds (the wrapper's
// THREADS_PER_BLOCK, core/cuda_rollout.py): a candidate with more spans
// several blocks (gridDim.y), so a block never exceeds 128 threads whatever
// the instance's registers.
constexpr int kBlockLanes = 128;

// A block holds `cpb` candidates x `bpb` of their trajectories (blockIdx.y
// picks which). The block's candidates' decoded trees in shared memory;
// this thread's candidate's programs and first live rows, its trajectory
// and lane, or false past the block's last candidate or trajectory.
template <class Env, int SS, int N>
__device__ inline bool stage_lane(const PolicyArgs& a, int cpb, int bpb, const Row** prog,
                                  const int** starts, int* b, size_t* lane) {
  constexpr int M = SS + Env::kControls;
  extern __shared__ unsigned char smem[];
  Row* s_prog = reinterpret_cast<Row*>(smem);  // cpb * M trees of n rows
  int* s_start = reinterpret_cast<int*>(s_prog + static_cast<size_t>(cpb) * M * a.n);
  const int ncand = stage_programs<N>(a.ops, a.cst, a.devop, a.var_start, a.P, M, a.n, cpb,
                                      s_prog, s_start);
  const int lc = threadIdx.x / bpb;
  *b = blockIdx.y * bpb + threadIdx.x - lc * bpb;
  if (lc >= ncand || *b >= a.B) return false;
  *lane = static_cast<size_t>(blockIdx.x * cpb + lc) * a.B + *b;
  *prog = s_prog + static_cast<size_t>(lc) * M * a.n;
  *starts = s_start + lc * M;
  return true;
}

template <class Env, int SS, int N>
__global__ void policy_kernel(PolicyArgs a, int cpb, int bpb) {
  const Row* prog;
  const int* starts;
  int b;
  size_t lane;
  if (stage_lane<Env, SS, N>(a, cpb, bpb, &prog, &starts, &b, &lane))
    policy_lane<Env, SS, N>(a, prog, starts, b, lane);
}

template <class Env, int SS, int N>
__global__ void policy_adaptive_kernel(PolicyArgs a, int cpb, int bpb) {
  const Row* prog;
  const int* starts;
  int b;
  size_t lane;
  if (stage_lane<Env, SS, N>(a, cpb, bpb, &prog, &starts, &b, &lane))
    policy_adaptive_lane<Env, SS, N>(a, prog, starts, b, lane);
}

template <class Env, int SS, int N>
int launch(int kind, const PolicyArgs& a, int cpb, cudaStream_t stream) {
  const int bpb = a.B < kBlockLanes ? a.B : kBlockLanes;
  if (cpb * bpb > 1024) return static_cast<int>(cudaErrorInvalidValue);
  const dim3 grid((a.P + cpb - 1) / cpb, (a.B + bpb - 1) / bpb);
  const size_t smem = program_smem(cpb, a.m, a.n);  // the wrapper's cpb keeps it within 48 KB
  if (smem > 48 * 1024) return static_cast<int>(cudaErrorInvalidValue);
  if (kind == kFixed)
    policy_kernel<Env, SS, N><<<grid, cpb * bpb, smem, stream>>>(a, cpb, bpb);
  else
    policy_adaptive_kernel<Env, SS, N><<<grid, cpb * bpb, smem, stream>>>(a, cpb, bpb);
  return static_cast<int>(cudaGetLastError());
}
#else
template <class Env, int SS, int N>
int launch(int kind, const PolicyArgs& a) {
  constexpr int M = SS + Env::kControls;
  Row prog[M * N];
  int starts[M];
  for (int p = 0; p < a.P; ++p) {
    const size_t tree = static_cast<size_t>(p) * M * a.n;
    for (int i = 0; i < M * a.n; ++i) prog[i] = Row{a.ops[tree + i], a.cst[tree + i]};
    for (int k = 0; k < M; ++k) starts[k] = decode_tree<N>(prog + k * a.n, a.n, a.devop, a.var_start);
    for (int b = 0; b < a.B; ++b) {
      const size_t lane = static_cast<size_t>(p) * a.B + b;
      if (kind == kFixed)
        policy_lane<Env, SS, N>(a, prog, starts, b, lane);
      else
        policy_adaptive_lane<Env, SS, N>(a, prog, starts, b, lane);
    }
  }
  return 0;
}
#endif

// `wide`: the wide instance's limits (any state size and targets) instead
// of the fixed instances'.
template <class Env>
bool bad_args(int kind, const PolicyArgs& a, bool wide) {
  const bool fixed = kind == kFixed;
  return a.P <= 0 || a.n <= 0 || a.n > kMaxNodes || a.B <= 0 || a.T <= 0 ||
         a.state_size < 0 || a.m != a.state_size + Env::kControls || a.n_targets < 0 ||
         (!wide && (a.state_size > kMaxStateSize || a.n_targets > kMaxTargets)) ||
         a.n_obs < 0 || a.n_obs > Env::kObs || (Env::kTraced && a.n_obs != Env::kObs) ||
         (fixed && (a.method < kEuler || a.method > kRk4 || a.substeps <= 0 ||
                    (a.kick_rows && a.method != kEuler))) ||
         (!fixed && (a.method != kBosh3 && a.method != kDopri5)) ||
         (!fixed && (a.max_steps < 0 || a.streamed || a.obs_rows || a.kick_rows));
}

#ifdef MTGP_WIDE_STATE
// A wide lane's vectors of d_aug = latent + state_size floats: the
// fixed-step kernel's state, next state, stage input, stage and stage sum;
// the adaptive kernel's WideVectors (the state, x_hi, the stage input, the
// seven stages). The data vector [y, a, u, tgt] follows them. The wrapper's
// scratch per lane (core/cuda_policy.py WIDE_VECTORS).
constexpr int kFixedWideVectors = 5;
constexpr int kAdaptiveWideVectors = 10;

// The policy of one wide lane: its decoded trees (the state_size state
// trees, then the NC readout trees), its data vector `data` [y, a, u, tgt]
// of `width` floats, whose target slots the lane fills once.
template <class Env, bool U>
struct WidePolicy {
  static constexpr int L = Env::kLatent, NC = Env::kControls, NP = Env::kParams;
  static constexpr int O = Env::kObs;  // the observation's floats
  WideTrees<U> trees;
  int ss, width, n_obs;
  LaneVec data;

  MTGP_HD int dim() const { return L + ss; }

  // y = the observation of the latent state x (+ the noise row, if any)
  MTGP_HD void observe(const LaneVec& x, const float* noise, float (&y)[O]) const {
    if constexpr (Env::kTraced) {
      float xl[L];
#pragma unroll
      for (int q = 0; q < L; ++q) xl[q] = x[q];
      Env::observe(xl, noise, y);
    } else {
#pragma unroll
      for (int q = 0; q < L; ++q) y[q] = (noise != nullptr && q < n_obs) ? x[q] + noise[q] : x[q];
      Env::wrap_obs(y);
    }
  }

  // data = [y or 0, a, u or 0, tgt]
  MTGP_HD void fill(const float* y, const LaneVec& x, const float* u) const {
#pragma unroll
    for (int q = 0; q < O; ++q) data[q] = y ? y[q] : 0.0f;
    for (int j = 0; j < ss; ++j) data[O + j] = x[L + j];
#pragma unroll
    for (int j = 0; j < NC; ++j) data[O + ss + j] = u ? u[j] : 0.0f;
  }

  // the controls of the readout trees on the data vector
  MTGP_HD void readout(float (&u)[NC]) const { trees.template group<NC>(ss, data, width, u); }

  // dx = the closed loop's drift at the augmented state x
  MTGP_HD void drift(const LaneVec& x, const float* p, const float* noise, const LaneVec& dx) const {
    float y[O], u[NC], xl[L], dxl[L];
    observe(x, noise, y);
    // the readout; a dynamic one sees the hidden state and the targets only
    fill(ss > 0 ? nullptr : y, x, nullptr);
    readout(u);
#pragma unroll
    for (int q = 0; q < L; ++q) xl[q] = x[q];
    Env::drift(xl, u, p, dxl);
#pragma unroll
    for (int q = 0; q < L; ++q) dx[q] = dxl[q];
    if (ss > 0) {
      fill(y, x, u);
      trees.run(0, ss, data, width, LaneVec{&dx[L], dx.s});
    }
  }

  // drift() as one out-of-line call (the adaptive kernel's: inlined at its
  // stages, the fixed instance's card build computed wrong lanes, F7)
  MTGP_NOINLINE MTGP_HD void drift_call(const LaneVec x, const Vec<NP> p, const LaneVec dx) const {
    drift(x, p.v, nullptr, dx);
  }

  // the controls at a save point: real observations, u zero-fed
  MTGP_HD void controls(const LaneVec& x, const float* noise, float (&u)[NC]) const {
    float y[O];
    observe(x, noise, y);
    fill(y, x, nullptr);
    readout(u);
  }

  // the plant's cond_alive on the latent block of x
  MTGP_HD static bool plant_alive(const LaneVec& x) {
    float xl[L];
#pragma unroll
    for (int q = 0; q < L; ++q) xl[q] = x[q];
    return Env::alive(xl);
  }

  // each component finite and below the divergence bound
  MTGP_HD bool bounded(const LaneVec& x) const {
    bool good = true;
    for (int q = 0; q < dim(); ++q) good = good && isfinite(x[q]) && fabsf(x[q]) < kBound;
    return good;
  }

  // finite, below the divergence bound, and the plant's cond_alive
  MTGP_HD bool ok(const LaneVec& x) const { return bounded(x) && plant_alive(x); }
};

// Writes save row t of a wide lane: the augmented state and the controls.
template <class Env, bool U>
MTGP_HD void save_row_wide(const PolicyArgs& a, const WidePolicy<Env, U>& pol, size_t lane, int t,
                           const LaneVec& x, const float* noise) {
  constexpr int NC = Env::kControls;
  const int d = pol.dim();
  const size_t row = static_cast<size_t>(t) * a.P * a.B + lane;
  float u[NC];
  pol.controls(x, noise, u);
  for (int q = 0; q < d; ++q) a.xs[row * d + q] = x[q];
#pragma unroll
  for (int j = 0; j < NC; ++j) a.us[row * NC + j] = u[j];
}

template <class Env, bool U>
MTGP_HD void init_state_wide(const PolicyArgs& a, const WidePolicy<Env, U>& pol, int b,
                             const LaneVec& x) {
  constexpr int L = Env::kLatent;
#pragma unroll
  for (int q = 0; q < L; ++q) x[q] = a.x0[b * L + q];
  for (int j = 0; j < pol.ss; ++j) x[L + j] = 0.0f;
}

// policy_lane on the wide instance: the same loop, its vectors x (the
// state), xn (the next state; swapped with x when it is accepted), xst (the
// stage input), k (the stage) and acc (the stage sum).
template <class Env, bool U>
MTGP_HD void policy_lane_wide(const PolicyArgs& a, const WidePolicy<Env, U>& pol, int b,
                              size_t lane, LaneVec x, LaneVec xn, const LaneVec& xst,
                              const LaneVec& k, const LaneVec& acc) {
  constexpr int L = Env::kLatent, NP = Env::kParams;
  const int d = pol.dim();
  const bool rk4 = a.method == kRk4;
  const int n_stages = rk4 ? 4 : (a.method == kHeun ? 2 : 1);
  const int k_obs = a.k_obs;
  const size_t traj = static_cast<size_t>(b);

  init_state_wide<Env, U>(a, pol, b, x);
  bool alive = pol.ok(x);
  const float* save_noise = a.obs_rows ? a.obs_rows + traj * k_obs : nullptr;
  save_row_wide<Env, U>(a, pol, lane, 0, x, save_noise);
  int count = alive ? 1 : 0;
  float p[NP];  // per trajectory, or interpolated at every stage when streamed
#pragma unroll
  for (int j = 0; j < NP; ++j) p[j] = a.streamed ? 0.0f : a.par[traj * NP + j];
  for (int t = 0; t + 1 < a.T; ++t) {
    const float* lo = a.streamed ? a.par + (static_cast<size_t>(t) * a.B + traj) * NP : a.par;
    const float* hi = a.streamed ? lo + static_cast<size_t>(a.B) * NP : a.par;
    const float* noise_t = a.obs_rows ? a.obs_rows + (static_cast<size_t>(t) * a.B + traj) * k_obs
                                      : nullptr;
    for (int s = 0; s < a.substeps && alive; ++s) {
      for (int q = 0; q < d; ++q) acc[q] = 0.0f;
      for (int st = 0; st < n_stages; ++st) {
        const float c = st == 0 ? 0.0f : (rk4 && st < 3 ? 0.5f : 1.0f);
        const float w = rk4 && (st == 1 || st == 2) ? 2.0f : 1.0f;
        const float hc = rk4 && st < 3 ? a.h_half : a.h_full;
        if (a.streamed) {
          const float frac = (static_cast<float>(s) + c) * a.inv_sub;
          const float keep = 1.0f - frac;
#pragma unroll
          for (int j = 0; j < NP; ++j) p[j] = lo[j] * keep + hi[j] * frac;
        }
        if (st > 0) {
          for (int q = 0; q < d; ++q) xst[q] = x[q] + hc * k[q];
        }
        const float* noise = noise_t ? noise_t + (s * n_stages + st) * a.n_obs : nullptr;
        pol.drift(st == 0 ? x : xst, p, noise, k);
        for (int q = 0; q < d; ++q) acc[q] = acc[q] + w * k[q];
      }
      for (int q = 0; q < d; ++q) xn[q] = x[q] + a.h_final * acc[q];
      if (a.kick_rows) {  // Euler-Maruyama: the latent block only
        const float* kick =
            a.kick_rows + (static_cast<size_t>(t) * a.B + traj) * a.substeps * L + s * L;
#pragma unroll
        for (int q = 0; q < L; ++q) xn[q] = xn[q] + kick[q];
      }
      alive = pol.ok(xn);
      if (alive) {  // the next state becomes the state
        const LaneVec old = x;
        x = xn;
        xn = old;
      }
    }
    const float* noise_save =
        a.obs_rows ? a.obs_rows + (static_cast<size_t>(t + 1) * a.B + traj) * k_obs : nullptr;
    save_row_wide<Env, U>(a, pol, lane, t + 1, x, noise_save);
    count += alive ? 1 : 0;
  }
  a.alive[lane] = count;
}

// rk_step_n's drift: the closed loop at constant params, no noise, out of line
template <class Env, bool U>
struct WidePolicyDrift {
  const WidePolicy<Env, U>& pol;
  const Vec<Env::kParams>& p;
  MTGP_HD void operator()(const LaneVec& x, const LaneVec& k) const { pol.drift_call(x, p, k); }
};

// policy_adaptive_lane on the wide instance: the same flat loop, its
// vectors in v (an accepted step swaps x with x_hi and k1 with the last
// stage) and the step of adaptive_step.cuh's rk_step_n.
template <class Env, bool U>
MTGP_HD void policy_adaptive_lane_wide(const PolicyArgs& a, const WidePolicy<Env, U>& pol, int b,
                                       size_t lane, WideVectors v) {
  constexpr int NP = Env::kParams;
  const int d = pol.dim();
  Vec<NP> p;
#pragma unroll
  for (int j = 0; j < NP; ++j) p.v[j] = a.par[static_cast<size_t>(b) * NP + j];
  const WidePolicyDrift<Env, U> f{pol, p};

  init_state_wide<Env, U>(a, pol, b, v.x);
  bool alive = pol.ok(v.x);
  save_row_wide<Env, U>(a, pol, lane, 0, v.x, nullptr);
  int count = alive ? 1 : 0;
  int steps = 0;
  if (a.T > 1) {
    const float expo = error_exponent(a.method);
    f(v.x, v.ks[0]);  // the one up-front evaluation FSAL amortises
    float dt = (a.ts[1] - a.ts[0]) / 4.0f;
    int ti = 0, s = 0;
    float t1 = a.ts[1];
    float span = t1 - a.ts[0];
    float t = a.ts[0];
    dt = clip(dt, span * kDtMin, span);
    while (true) {
      if (s < a.max_steps && alive && t < t1 - kCross) {
        const float dt_c = nan_min(dt, t1 - t);
        const float err =
            rk_step_n(f, a.method, d, v.x, v.ks, dt_c, a.rtol, a.atol, v.x_hi, v.xs);
        const bool ok = pol.bounded(v.x_hi) && isfinite(err);
        // cond_alive rejects the step (integrate_adaptive's accept)
        if (ok && err <= 1.0f && pol.plant_alive(v.x_hi)) {
          v.accept();
          t = t + dt_c;
        }
        dt = clip(dt_c * step_factor(err, ok, a.safety, expo), span * kDtMin, span);
        alive = alive && (ok || dt_c > span * kDtDead);
        ++s;
        ++steps;
      } else {
        alive = alive && t >= t1 - kReach * nan_max(fabsf(t1), 1.0f);
        save_row_wide<Env, U>(a, pol, lane, ti + 1, v.x, nullptr);
        count += alive ? 1 : 0;
        if (++ti + 1 >= a.T) break;
        const float t0 = a.ts[ti];
        t1 = a.ts[ti + 1];
        span = t1 - t0;
        t = t0;
        dt = clip(dt, span * kDtMin, span);
        s = 0;
      }
    }
  }
  a.alive[lane] = count;
  a.steps[lane] = steps;
}

// Trajectory b of candidate c on the wide instance: its policy (the data
// vector after the kernel's vectors, its targets filled), its vectors at the
// launch's lane li, its output lane c * B + b.
template <class Env, bool U>
MTGP_HD void run_lane_wide(int kind, const WideSpan& s, const PolicyArgs& a,
                           const WideTrees<U>& f, int c, int b, size_t li) {
  constexpr int L = Env::kLatent, NC = Env::kControls, O = Env::kObs;
  const int d = L + a.state_size;
  const int vectors = kind == kFixed ? kFixedWideVectors : kAdaptiveWideVectors;
  const WidePolicy<Env, U> pol{f, a.state_size, O + a.state_size + NC + a.n_targets, a.n_obs,
                               scratch_vec(s, static_cast<size_t>(vectors) * d, li)};
  for (int j = 0; j < a.n_targets; ++j)
    pol.data[O + a.state_size + NC + j] = a.tgt[static_cast<size_t>(b) * a.n_targets + j];
  const size_t lane = static_cast<size_t>(c) * a.B + b;
  const auto vec = [&](int v) { return scratch_vec(s, static_cast<size_t>(v) * d, li); };
  if (kind == kFixed) {
    policy_lane_wide<Env, U>(a, pol, b, lane, vec(0), vec(1), vec(2), vec(3), vec(4));
  } else {
    WideVectors v{vec(0), vec(1), vec(2), {}};
    for (int j = 0; j < 7; ++j) v.ks[j] = vec(3 + j);
    policy_adaptive_lane_wide<Env, U>(a, pol, b, lane, v);
  }
}

// The wide instance takes the unary rows' code always, as the fixed ones do.
#ifdef __CUDACC__
template <class Env, int N>
__global__ void policy_wide_kernel(WideSpan s, PolicyArgs a, int cpb, int bpb) {
  wide_block<true, N>(s, cpb, bpb, [&](const WideTrees<true>& f, int c, int b, size_t li) {
    run_lane_wide<Env, true>(kFixed, s, a, f, c, b, li);
  });
}

template <class Env, int N>
__global__ void policy_adaptive_wide_kernel(WideSpan s, PolicyArgs a, int cpb, int bpb) {
  wide_block<true, N>(s, cpb, bpb, [&](const WideTrees<true>& f, int c, int b, size_t li) {
    run_lane_wide<Env, true>(kAdaptive, s, a, f, c, b, li);
  });
}

template <class Env, int N>
int launch_policy_wide(int kind, const PolicyArgs& a, const WideSpan& s, int cpb,
                       cudaStream_t stream) {
  return static_cast<int>(kind == kFixed
                              ? launch_wide(&policy_wide_kernel<Env, N>, s, a, cpb, stream)
                              : launch_wide(&policy_adaptive_wide_kernel<Env, N>, s, a, cpb, stream));
}
#else
template <class Env, int N>
int launch_policy_wide(int kind, const PolicyArgs& a, const WideSpan& s) {
  wide_host<true, N>(s, [&](const WideTrees<true>& f, int c, int b, size_t li) {
    run_lane_wide<Env, true>(kind, s, a, f, c, b, li);
  });
  return 0;
}
#endif
#endif  // MTGP_WIDE_STATE

}  // namespace

#ifdef MTGP_USER_ENV
// The user-environment build: its one plant, the generated struct.
#define MTGP_ENV_SWITCH(CALL)                                                   \
  switch (a->env) {                                                             \
    case kUserEnv: CALL(mtgp_env::UserEnv);                                     \
    default: return kInvalid;                                                   \
  }
#else
// One case per plant; CALL(ENV) is its launch.
#define MTGP_ENV_SWITCH(CALL)                                                   \
  switch (a->env) {                                                             \
    case kHarmonicOscillator:                                                   \
    case kChangingHarmonicOscillator: CALL(HarmonicOscillatorEnv);              \
    case kHarmonicOscillator2: CALL(HarmonicOscillator2Env);                    \
    case kCartPole: CALL(CartPoleEnv);                                          \
    case kAcrobot: CALL(AcrobotEnv<false>);                                     \
    case kAcrobot2: CALL(AcrobotEnv<true>);                                     \
    case kStirredTankReactor: CALL(StirredTankReactorEnv);                      \
    default: return kInvalid;                                                   \
  }
#endif

extern "C" {

// kind 0 = the fixed-step kernel, 1 = the adaptive one; `args` points to a
// PolicyArgs.
#ifdef __CUDACC__
const char* mtgp_error_string(int status) {
  return cudaGetErrorString(static_cast<cudaError_t>(status));
}
#else
// host build of the same per-lane code (tests without a card); 1 reports
// bad arguments
const char* mtgp_error_string(int status) {
  return status ? "invalid arguments" : "no error";
}
#endif

#ifdef MTGP_WIDE_STATE
// The wide instance on candidates c0 .. c0 + count - 1, its scratch
// (kFixedWideVectors or kAdaptiveWideVectors) x d_aug + the data vector's
// floats per lane, [vector][component][lane] (tree_prog_wide.cuh WideSpan,
// whose d is the m trees a candidate).
#define MTGP_WIDE_SPAN                                                                  \
  const PolicyArgs* a = static_cast<const PolicyArgs*>(args);                           \
  const WideSpan span{a->ops, a->cst, a->devop, a->var_start, a->m, a->n, a->B, c0, count, \
                      scratch};                                                         \
  const bool bad = (kind != kFixed && kind != kAdaptive) || bad_span(span) || c0 + count > a->P
#define MTGP_WIDE_ENV(ENV)                                                  \
  do {                                                                      \
    if (bad_args<ENV>(kind, *a, true)) return kInvalid;                     \
    return a->n <= 32 ? MTGP_WIDE_LAUNCH(ENV, 32) : MTGP_WIDE_LAUNCH(ENV, kMaxNodes); \
  } while (0)

#ifdef __CUDACC__
// Launches on `stream` with `cpb` candidates per block; returns
// cudaGetLastError() of the launch.
int policy_wide_launch(int kind, const void* args, float* scratch, int c0, int count, int cpb,
                       void* stream) {
  constexpr int kInvalid = static_cast<int>(cudaErrorInvalidValue);
  MTGP_WIDE_SPAN;
  if (bad) return kInvalid;
  cudaStream_t st = static_cast<cudaStream_t>(stream);
#define MTGP_WIDE_LAUNCH(ENV, N) launch_policy_wide<ENV, N>(kind, *a, span, cpb, st)
  MTGP_ENV_SWITCH(MTGP_WIDE_ENV)
  return kInvalid;
#undef MTGP_WIDE_LAUNCH
}
#else
int policy_wide_host(int kind, const void* args, float* scratch, int c0, int count) {
  constexpr int kInvalid = 1;
  MTGP_WIDE_SPAN;
  if (bad) return kInvalid;
#define MTGP_WIDE_LAUNCH(ENV, N) launch_policy_wide<ENV, N>(kind, *a, span)
  MTGP_ENV_SWITCH(MTGP_WIDE_ENV)
  return kInvalid;
#undef MTGP_WIDE_LAUNCH
}
#endif
#else  // the fixed instances
#ifdef __CUDACC__
#define MTGP_LAUNCH(ENV, SS, N) launch<ENV, SS, N>(kind, *a, cpb, s)
#else
#define MTGP_LAUNCH(ENV, SS, N) launch<ENV, SS, N>(kind, *a)
#endif

// One instance per plant, state size and tree bound (N <= 32 or 256).
#define MTGP_STACKS(ENV, SS) (a->n <= 32 ? MTGP_LAUNCH(ENV, SS, 32) : MTGP_LAUNCH(ENV, SS, kMaxNodes))
#define MTGP_ENV(ENV)                                               \
  do {                                                              \
    if (bad_args<ENV>(kind, *a, false)) return kInvalid;            \
    switch (a->state_size) {                                        \
      case 0: return MTGP_STACKS(ENV, 0);                           \
      case 1: return MTGP_STACKS(ENV, 1);                           \
      default: return MTGP_STACKS(ENV, 2);                          \
    }                                                               \
  } while (0)

#ifdef __CUDACC__
// Launches on `stream`; returns cudaGetLastError() of the launch.
int policy_launch(int kind, const void* args, int cpb, void* stream) {
  constexpr int kInvalid = static_cast<int>(cudaErrorInvalidValue);
  const PolicyArgs* a = static_cast<const PolicyArgs*>(args);
  if ((kind != kFixed && kind != kAdaptive) || cpb <= 0) return kInvalid;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  MTGP_ENV_SWITCH(MTGP_ENV)
  return kInvalid;
}
#else
int policy_host(int kind, const void* args) {
  constexpr int kInvalid = 1;
  const PolicyArgs* a = static_cast<const PolicyArgs*>(args);
  if (kind != kFixed && kind != kAdaptive) return kInvalid;
  MTGP_ENV_SWITCH(MTGP_ENV)
  return kInvalid;
}
#endif
#endif  // MTGP_WIDE_STATE

}  // extern "C"
