#!/usr/bin/env python3
"""GPU smoke run of the PyTorch/CUDA port (``multitreegp_tpu_torch``).

Run from the repository root on a machine with one NVIDIA Hopper GPU::

    python3 chip_smoke.py [--out results.json]

It builds the hand-written kernels from ``multitreegp_tpu_torch/csrc`` with
``nvcc`` (one process per source, in parallel; the libraries of later phases
at the lowest CPU priority behind the first phases) and drives the port's paths at
the full width of the flagship workload (symbolic regression of Van der Pol;
8 islands x 512 candidates, 2 trees of ``max_nodes=32``, operators + - * /,
16 trajectories, 50 save points, RK4 with one substep) and of the control
workload (phases 12-14). Phases, one line or a few each:

1. device: ``nvidia-smi`` name and power limit, torch/CUDA versions, build time
   (at the end, when the builds behind the phases finished);
2. fitness kernel vs its plain PyTorch version (T = 5 and T = 50; at T = 50
   every lane identical);
3. reproduction kernel vs its plain version on the main path's 3696 lanes
   (every lane's opcodes identical);
4. the main path: ``initialize_population`` then 5 x (``evaluate_population``
   + ``evolve``), with the kernels' launch counters read around it; then
   ``fit()`` for 20 generations, its generation step run eagerly at each
   variant's first generation, captured as a CUDA graph at its second and
   replayed after (migration at generations 9 and 19), beside the same
   host loop from the same seed, four times: every output and the
   generator's state bit-equal, the host loop's and a ``fit()`` of replays'
   ms per generation, the kernels on the device in such a ``fit()``
   (torch.profiler) equal to the host loop's launches, each graph's capture
   seconds, nodes, replay ms and device busy time, and a warm step of each
   variant under ``torch.cuda.set_sync_debug_mode("error")``;
5. kernel and plain-version times (CUDA events, median of several runs; the
   kernels' own device time per launch by torch.profiler);
6. interpreter forward and VJP kernels vs their plain versions, per lane, at
   the constant-optimisation recompute's 50 x 16 x 2 lanes and at the whole
   population's 4096 x 16 x 2 lanes, through ``evaluate_trees`` and autograd
   on one tree per lane, and in the recompute's layout (trees ``(K, 1, 2,
   N)`` against states ``(K, 16, 1, 2)``: lanes grouped by the tree they
   share) on the VJP's per-lane outputs; every lane identical;
7. the constant-optimisation path: the host loop for 20 generations with
   ``coefficient_optimisation=True`` (top-k 50, 10 Adam steps), so rounds run
   at generations 14 and 19; all four launch counters read around it, the
   refined top-k fitness against the unrefined, ms per generation and per
   round (split into the fused forward, the recompute and its backward);
   then the graphed ``fit()`` beside it as in phase 4 (four variants: the
   round at 14 and 19, migration at 9 and 19), and the graphed round's ms;
8. interpreter kernel and plain-version times at both shapes (CUDA events;
   the kernels' device time per launch by torch.profiler), the dispatcher
   ``evaluate_trees`` forward and forward + backward through autograd (what
   a drift call of the recompute pays), and the wrappers' host time per
   call split into ``_operands`` (the layout cache), the ``ctypes`` call and
   the rest;
9. the adaptive kernels (#5 global budget, #4 per interval; Dormand-Prince
   5(4)) and the trajectory kernel (#3) against their plain versions at the
   full width of 4096 x 16 lanes, every lane identical: #5 with the budget
   500 at T = 50 and 40 at T = 10, #4 with 32 steps per interval at T = 10, #3
   RK4 at T = 50 (with its device time per launch by torch.profiler); the
   attempted steps per lane and per warp (the maximum of 32 consecutive
   lanes) and how many warps reach the budget;
10. the adaptive path: 5 generations of the 8 x 512 host loop with
   ``SREvaluator(method="adaptive", adaptive_method="dopri5")``, the
   attempted-step telemetry of both budgets (``adaptive_solver_stats`` and
   the global kernel's), one ``optimise`` call (top-k 50, 2 Adam steps: the
   recompute takes ~4 s an epoch) through the adaptive gradient, and
   ``evaluate_candidate`` of the best under the RK4 evaluator; all seven
   launch counters read around it; then #3 at that inspection shape (one
   candidate x 16 trajectories) against its plain version, and its time;
11. adaptive and trajectory kernel and plain-version times (CUDA events;
   #5's and #4's device time per launch by torch.profiler), the global
   kernel's node-evals/s, and what sets #5's time: #5 on 1/8 of the
   candidates (fewer warps per SM) and on the candidates sorted by their
   slowest lane's steps (fewer warp-steps);
12. the closed-loop policy kernels (#6 fixed step, #7 adaptive) against
   their plain versions per lane on the control path's full width (Acrobot,
   8 x 512 policies x 16 trajectories, operators + - * sin cos; #6 RK4 with
   4 substeps at T = 8, #7 Dormand-Prince with 8 steps per interval at
   T = 6: the horizon is cut because the plain versions launch thousands
   of kernels per interval), static and dynamic (``state_size=2``); every
   other plant, series parameters and noise rows at 512 x 16, T = 6; every
   lane identical (states, controls, alive count, attempted steps); and
   the sin/cos repair: #1, #5, #8/#9 with + - * / sin cos and #2 with the
   policy function sets;
13. the control paths at full width (T = 250): 5 generations of the host
   loop each with the static (#6), dynamic (#6) and adaptive static (#7)
   evaluators, ``evaluate_candidate`` of the best static policy (replay
   through #8) and one ``optimise`` of its loop's top 8 (2 Adam steps, the
   horizon cut to T = 60: the recompute is host-bound, ~40 s at T = 250)
   through ``PolicyRollout`` (#8/#9 in the backward);
14. #6 and #7 times at T = 250 (CUDA events, and the device time per
   launch by torch.profiler), with bounds counted from the run, the alive
   share and (#7) the attempted steps per lane;
15. the noise streams and the SDE: the rows built on the card against the
   same rows built on the CPU (the generator's bits equal, the normals' ulp
   gap reported); #1 with Euler-Maruyama kick rows against its plain version
   on the 65,536 lanes of phase 2 at T = 50 (4 substeps); the 5-generation
   8 x 512 host loop of the SDE SR workload (VdP with process noise 0.05);
   the static and dynamic Acrobot loops (T = 250, 5 generations) with
   observation noise and ``stochastic=True`` (#6 given the rows); one noisy
   adaptive evaluation through the general path (per-lane draws, no #7),
   the horizon cut to T = 6 (the general path launches #8 per stage); #6
   against its plain version on the port's rows (RK4 observation rows, Euler
   observation + kick rows) on all 65,536 lanes at T = 8 (phase 12's cut),
   every lane identical; #1's and #6's times with and without noise, and
   the rows' build time;
16. the branch probe (#10, ``python -m multitreegp_tpu_torch.tools.branch_probe``):
   every mode against its plain version, then the tool's timing run, each
   mode's time and device time beside its bound (at the non-FMA rate: the
   body is a multiply and an add);
17. the instances of #1-#9 for trees of up to 256 rows against their
   plain versions: #1 on 256 candidates of 256 rows (chains of 255, 127
   and 63 rows among them) x 16 trajectories at T = 4, RK4 and
   Euler-Maruyama with kick rows; #3 on the same lanes (RK4); #8/#9 on the
   same trees against 16 states each in the recompute's layout; #5 (budget
   8) and #4 (4 per interval), dopri5, on the same lanes at T = 3; #2 on
   one island's 462 lanes of those parents; #6 (dynamic, RK4 x 2: the
   readout and the two state trees) and #7 (static, dopri5, 8 steps per
   interval) on 256 Acrobot policies of 256 rows, chained the same way, x
   16 trajectories at T = 2 (the plain
   versions sweep all 256 rows at every stage; the card tests hold the
   other two pairs);
18. the reproduction path without the fused kernel (``fused_reproduction=
   False``: crossover, the seven mutations and fresh samples as per-tree
   PyTorch operators) on phase 4's workload, 5 generations, beside the fused
   path on the same initial population: ms per generation and evolve ms,
   every child valid (``validate_host``), the best never increasing, #2
   never launched;
19. past the fixed interpreter instances' 1024 rows: phase 4's workload at
   ``max_nodes=2048``, ``max_init_depth=10``, default routing (the non-fused
   evolve; the SR evaluator's general path with #8's wide instance as the
   drift), 3 generations and one constant-optimisation round (top-k 50, 10
   Adam steps, #9 in the backward), #8/#9 launches read around each step;
   #8/#9 against their plain versions, every lane identical, with 16
   trajectories a tree and with one data vector a tree: at 512 and 1024 rows
   (the fixed instance) on chains of N - 1, 127 and 63 rows; at 2048
   rows (the wide instance) the roots on chains of N - 1 rows (one of
   them the zigzag whose second operands reach row N - 3), roots and
   cotangents on chains of 1023 rows in trees of N rows; at 2048 rows on the
   evaluation's and the round's shapes; their events, device time per
   launch and bounds on each case;
20. ``gen_deep`` (``bench.py``: ``max_nodes=128``, ``max_init_depth=7``) on
   the fused path: 5 generations, ms per generation, #1's and #2's device
   time per launch;
21. ``SREvaluator.prepare_chained`` on phase 4's last population and on
   phase 15's SDE workload: ``step(const0)`` bit-equal to
   ``evaluate_population`` per candidate; 10 chained steps against 10
   ``evaluate_population`` calls (CUDA events, device busy time), the ms
   the hoist saves per evaluation and the SDE kick rows' build alone;
22. ``fit(shard=True)`` at full width (``gen_opt``: 8 x 512, top-k 50, 10
   Adam steps, 15 generations) over one NCCL rank per card (the card count
   capped to a divisor of the 8 islands; ``torch.multiprocessing.spawn``,
   a ``FileStore``): at W = 1 bit-equal to ``fit()``; at every W the
   histories, valid trees, fitness in [0, 1e5] and a round that makes
   nothing worse; per rank the ms per generation split into evaluation,
   migration ring, evolve and global best, the round's ms and #1/#2/#8/#9
   launches;
23. the three notebook examples (``python -m multitreegp_tpu_torch.examples.
   <name>``) through ``build`` and their loop at the notebooks' full sizes
   and generation counts: symbolic regression (VdP, 10 x 100, 100
   generations, RK4 x 4: #1, #2) for seeds 0-2, with ``--fused`` (``fit()``)
   and ``--adaptive`` (dopri5, rtol = atol = 1e-6, budget 500: #5) for seed
   0; the static Acrobot policy (5 x 100, 50 generations, T = 250: #6, #2)
   for seeds 0-2 and ``--adaptive`` (dopri5, 8 steps per interval: #7) for
   seed 0; the dynamic policy (``state_size=2``: #6) for seeds 0-2; per run
   the best-fitness history (finite, within bounds, never increasing, ending
   below generation 0's), valid last populations, readout trees reading only
   ``a0``/``a1``, each kernel's launches (the evaluation's once a
   generation, #2 once an evolve), ms per generation split into evaluate and
   evolve by ``PhaseTimer``; then #1, #2 and #5-#7 against their plain
   versions at ``max_nodes=30`` on the seed-0 populations (horizons cut, #5's
   budget 40), every lane identical;
24. the operators past ``+ - * / sin cos`` (the kernels' extended build,
   compiled beside the default one): phase 4's ``gen`` workload with ``+ - *
   / exp log sqrt tanh pow max min abs neg square``, 5 generations of the
   host loop (#1, #2), one constant-optimisation round of the top 50 (10 Adam
   steps; #8/#9) and ``evaluate_candidate`` of the best (#3); on its last
   population #1 and #3 (T = 10) and #5 / #4 (phase 17's cut: T = 3, budget
   8 / 4 per interval) against their plain versions, every lane identical;
   the static Acrobot loop with ``+ - * tanh sin cos`` at 4096 x 16, T = 250,
   RK4 x 4, 5 generations (#6, #2), then #6 static and dynamic (T = 6) and #7
   static (T = 4) against their plain versions; #8/#9 in the round's layout
   (its top 50 x 16 x 2 lanes) and on chains of 255, 127
   and 63 rows at N = 256 (phase 17's 256 x 16 lanes) and of 1023, 127 and 63
   rows at N = 1024 (16 a tree), every operator in the chains, every lane
   bit-equal; #2 on one generation's lanes with the 14 operators; each
   kernel's device time beside the six-operator one on the same shape, in
   turns (#1, #3, #5, #4 on phase 2's population; #6, #7 on phase 12's); the
   same six-operator trees through the default and the extended library (#1,
   #5, #6 static, #9), what one build for both would cost them; and the
   extended build's ``nvcc`` seconds;
25. user operators (torch callables traced into generated device code,
   ``core/user_ops.py``; the kernels' user build, compiled beside the others):
   phase 4's ``gen`` workload with gplearn's protected set (``+ - *`` and
   the protected ``/``, ``log``, ``sqrt``, ``inv`` and ``sig``,
   ``registry.gplearn_operators``), 5 generations of the host loop (#1, #2),
   one constant-optimisation round of the top 50 (10 Adam steps; #8/#9) and
   ``evaluate_candidate`` of the best (#3); on its last population #1 and #3
   (T = 10), #5 / #4 (phase 17's cut) and #8/#9 in the round's layout
   against their plain versions, every lane identical, and #2 on one
   generation's lanes; the static Acrobot loop with ``+ - * sin cos`` and the
   protected ``/`` at 4096 x 16, T = 250, RK4 x 4, 5 generations (#6, #2),
   then #6 static and dynamic (T = 6) and #7 static (T = 4) against their
   plain versions; #1, #5 and #9 on phase 2's trees through the extended
   library (the table's ``/``; also its instance with the unary rows' code)
   and the user library (the protected ``/``) in turns, what the generated
   code costs; the user builds' ``nvcc`` seconds.
26. the emitter's vocabulary (``registry.vocabulary_operators``: the sigmoid,
   ``erf``, clamps, ``maximum``/``minimum``, powers by any scalar and by a
   tensor, ``relu``, the inverse and hyperbolic functions, ``log1p``/``expm1``,
   rounding, ``fmod``/``remainder``, rounded divisions, comparisons cast to
   float32, in-place forms), traced by this machine's torch: #8/#9 through
   the two sweep sets' user build against PyTorch's own CUDA ops
   (``tools/op_sweep``), each unary operator on all 2^32 float32 inputs
   (``SWEEP_STRIDE``; equal bits, NaN as NaN) and its VJP on every 256th
   with two cotangents, the binary ones on a 4096 x 4096 grid stratified by
   exponent plus the edges; phase 4's ``gen`` workload with the PySR-style
   set (``registry.pysr_operators``), 5 generations (#1, #2), a round of
   the top 50 (#8/#9), ``evaluate_candidate`` (#3), every launch counted;
   #1, #3 (T = 10) and #8/#9 (the round's layout) against their plain
   versions on its last population, every lane identical; #1 on phase 2's
   trees through ``_ext`` and the vocabulary's library in turns; the
   vocabulary builds' ``nvcc`` seconds. #4-#7's vocabulary builds are not
   made here (``pytest -m cuda tests/test_torch_user_vocab.py`` makes and
   checks them).
27. past four states, 1024 trajectories, 32 variables and 32 operators:
   Lorenz-96 (Lorenz 1996; 40 states, F = 8; its data made here by a
   float64 RK4 from a seeded normal around F) as symbolic regression with 40
   trees a candidate of ``max_nodes=32``, ``+ - * /``, 8 x 512 candidates x
   16 trajectories, T = 50 saves 0.05 apart, RK4 x 1: the SR evaluator's
   fused path through #1's wide instance (one launch an evaluation, no #8)
   and the fused reproduction (#2), 3 generations and one round of the top
   50 (#1 wide forward, #8/#9 in the recompute); one evaluation of the last
   population through the general path (#8 on 2,621,440 lanes a drift call)
   beside the fused one: clamp agreement and survivor Spearman; #1, #3, #5
   and #4 wide against their plain versions on every lane at T = 6; the
   same population under ``method="adaptive"`` (dopri5, budget 500: #5
   wide), ``adaptive_solver_stats`` (#4 wide) and ``evaluate_candidate``
   (#3 wide), each wide kernel's events, device time and bound; VdP with
   phase 2's population on 2,048 trajectories (#1 wide at d = 2, against
   plain at T = 6, timed at T = 50) and, on the main path's 16, the wide
   instance against the fixed one (bit-equal, device time in turns); then phase 4's
   workload with 33 operators (the table's 17 and 16 of
   ``registry.vocabulary_operators()``) through the general path, one
   evaluation and one round of the top 50 (#8/#9 in the wide instance of
   the set's user build); #8/#9 against their plain versions at each
   workload's shapes, every lane identical, with events, device time and
   bounds.
28. the policy kernels past two hidden states, two targets and 1024
   trajectories: the dynamic Acrobot with ``state_size=8`` (9 trees a
   candidate, the largest hidden state JAX's VMEM gate fuses at
   ``max_nodes`` 30 and 32) at phase 13's shape (8 x 512 policies, 16
   trajectories, T = 250, RK4 x 4, ``max_nodes=30``, ``+ - * sin cos``): 3
   generations of the host loop through #6's wide instance (one launch an
   evaluation, no #8) and #2, then one evaluation of the last population
   through the general path (#8) beside the fused one (clamp agreement,
   survivor Spearman), on the policy grid and on a grid of equal float32
   intervals (0.25 apart, T = 200), and one through ``method="adaptive"`` (dopri5, 8
   steps per interval: #7's wide instance); #6 and #7 wide against their
   plain versions on every lane at T = 4, each one's events, device time
   and bound at T = 250; ``StirredTankReactor(n_targets=3)`` (static, 512 x
   16, T = 6) through #6 and #7 wide against plain; the static Acrobot on
   2,048 trajectories (1,024 policies, T = 250, xs 8.4 GB) through #6's
   fixed instance (a candidate spans 16 blocks), against plain at T = 4;
   and the wide and fixed instances side by side on phase 13's static and
   dynamic shapes: every lane bit-equal, then device time in turns.
29. user control environments through #6/#7 (``policy.cu``'s
   user-environment builds, ``policy_e<hash12>``, whose one plant
   ``core/user_envs.py`` traces from the environment's torch methods): Gym's
   ``Pendulum-v1`` (:func:`pendulum_env`, defined here) at the ``policy``
   workload's shape (8 x 512 policies, 16 trajectories, ``max_nodes`` 30,
   ``+ - * sin cos``, T = 201 save points 0.05 apart, RK4 x 1): 3
   generations (#6 once an evaluation, no #8; #2), the last population
   through the general path beside the fused one, a dynamic population
   (``state_size`` 2), ``method="adaptive"`` (#7) and observation noise (#6
   with the obs-noise rows); every user-environment instance against its
   plain version on every lane at T = 6 (#6 static, dynamic, noisy; #7;
   #6/#7 wide at ``state_size`` 4), #6 and #7 timed at T = 201;
   ``TracedAcrobot`` (``Acrobot`` under another class, so traced) beside the
   built-in struct at phase 13's shape cut to T = 26 (#6 and #7), bit-equal,
   then device time in turns; the new builds' ``nvcc`` seconds.
30. the special functions, activations, scalar bases, tensor clamp bounds
   and 0-d constants (``registry.special_operators``: ``2 ** x``, rounded
   division and a 0-d tensor constant by a scalar, rounding to decimals,
   ``lgamma``, ``digamma``, ``polygamma``, ``i0``/``i0e``/``i1``/``i1e``,
   ``erfcx``, ``erfinv``, ``ndtri``, ``log_ndtr``, ``entr``, ``logit``,
   ``sinc``, the activations, ``frac``, ``deg2rad``, ``nan_to_num``; clamps
   by tensors, ``xlogy``, ``logaddexp``, ``copysign``, ``fmax``/``fmin``,
   ``ldexp``), traced by this machine's torch: #8/#9 through the wide
   instance of the user build of every vocabulary operator (device op ids
   to 112) against PyTorch's own CUDA ops as in phase 26 (the polygamma
   series' negative non-integers below -256 swept apart, every 4096th, with
   both forwards' times); #1 (T = 10)
   and #8/#9 (the round's layout) on 4096 candidates sampled from ``+ - * /``
   and ten special functions, and #8/#9 on 1024 from every vocabulary operator
   (user device op ids to 112: its wide instance), against their plain
   versions, every lane identical; #1 on phase 2's trees through
   ``_ext`` and the special library in turns; the new builds' ``nvcc``
   seconds.

Any failed check raises, so the script exits non-zero and prints no result.
The last lines are a JSON line of per-kernel numbers, the card's name and
power limit, and ``{"ok": true, "device": {...}}``; ``--sharded-only`` prints
the last two.
"""
from __future__ import annotations

import argparse
import json
import math
import os
import re
import statistics
import subprocess
import sys
import threading
import time
from concurrent.futures import ThreadPoolExecutor

FULL = dict(islands=8, pop=512, max_nodes=32, depth=4, batch=16, horizon=10.0, dt=0.2,
            generations=5, timing_runs=5, plain_runs=1,
            fit_generations=20, top_k=50, gradient_steps=10, elite=0.1, interp_runs=20,
            adaptive_budget=500, adaptive_check_budget=40, adaptive_interval_steps=32, adaptive_short_t=10,
            adaptive_opt_steps=2,
            policy_horizon=50.0, policy_nodes=30, policy_substeps=4, policy_adaptive_substeps=8,
            policy_fixed_t=8, policy_adaptive_t=6, legs_pop=512, legs_t=6, trig_adaptive_t=4,
            policy_opt_top_k=8, policy_opt_steps=2, policy_opt_t=60,
            noise=0.05, noisy_adaptive_t=6, ab_runs=10, probe_reps=256,
            deep_nodes=256, deep_depth=7, deep_pop=256, deep_t=4, deep_rep_pop=512, deep_policy_t=2,
            deep_adaptive_t=3, deep_adaptive_budget=8, deep_interval_steps=4,
            wide_nodes=2048, wide_depth=10, wide_generations=3, wide_check_nodes=(512, 1024, 2048),
            lorenz_states=40, lorenz_forcing=8.0, lorenz_depth=2, lorenz_dt=0.05, ext_chain_nodes=1024,
            wide_batch=2048, wide_check_t=6, wide_check_budget=8, wide_check_interval_steps=4,
            deep_gen_nodes=128, wide_policy_states=8, wide_policy_generations=3, wide_policy_check_t=4,
            wide_policy_pop=1024, wide_policy_runs=3, wide_policy_exact_dt=0.25,
            deep_gen_depth=7, chain_k=10, shard_generations=15,
            user_env_t=201, user_env_dt=0.05, user_env_generations=3, user_env_check_t=6, user_env_wide_states=4,
            user_env_acrobot_t=26, user_env_runs=3,
            example_sizes=None, example_t=None, example_check_t=6, example_check_adaptive_t=4, example_check_budget=40)
KERNELS = ("sr_fitness", "reproduce", "interpreter", "sr_adaptive", "sr_rollout",
           "policy", "branch_probe")  # csrc/<name>.cu
# the sources with an extended build (the tree kernels: #1, #3-#9), phase 24's
EXTENDED_KERNELS = ("sr_fitness", "interpreter", "sr_adaptive", "sr_rollout", "policy")
SHARDED_KERNELS = ("sr_fitness", "reproduce", "interpreter")  # phase 22's path
# the sources with a wide-state build (#1, #3, #4/#5; phase 27's path; #6/#7,
# phase 28's)
WIDE_KERNELS = ("sr_fitness", "sr_rollout", "sr_adaptive", "policy")
# the wide instances' rows of the kernels line: (name, source, TPU kernel)
WIDE_ROWS = (("sr_fitness_wide", "sr_fitness.cu", "multitreegp_tpu/core/pallas_rollout.py:279"),
             ("sr_rollout_wide", "sr_rollout.cu", "multitreegp_tpu/core/pallas_rollout.py:163"),
             ("sr_adaptive_global_wide", "sr_adaptive.cu", "multitreegp_tpu/core/pallas_rollout.py:1828"),
             ("sr_adaptive_interval_wide", "sr_adaptive.cu", "multitreegp_tpu/core/pallas_rollout.py:1277"))
# NVIDIA H100 SXM data sheet: HBM3 bytes/s, float32 FLOP/s outside the tensor
# cores (both at the full 700 W power limit). The FLOP/s count an FMA as two
# operations; a multiply or an add alone (the kernels are built with
# -fmad=false) is one operation per lane and cycle, half that rate. Every
# bound but the branch probe's counts at the FMA rate, so it is up to 2x low.
PEAK_BYTES_PER_S = 3.35e12
PEAK_F32_PER_S = 67e12
PEAK_F32_NOFMA_PER_S = PEAK_F32_PER_S / 2
OPERATORS = [("+", 2, 0.5), ("-", 2, 0.1), ("*", 2, 0.5), ("/", 2, 0.1)]


def check(ok: bool, msg: str) -> None:
    if not ok:
        raise RuntimeError(f"check failed: {msg}")


_T0 = time.perf_counter()


def say(*parts) -> None:
    print(*parts, flush=True)


def phase_line(*parts) -> None:
    """A phase's line, prefixed with the seconds since the script started."""
    say(f"[{time.perf_counter() - _T0:6.1f} s]", *parts)


def cuda_time_ms(fn, runs: int, torch) -> float:
    """Median milliseconds of ``fn()`` over ``runs`` runs, by CUDA events
    (one warm-up call first)."""
    fn()
    times = []
    for _ in range(runs):
        start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
        start.record()
        fn()
        end.record()
        torch.cuda.synchronize()
        times.append(start.elapsed_time(end))
    return statistics.median(times)


def profile_device(fn, torch) -> dict:
    """Device-side view of ``fn()`` by ``torch.profiler``: wall ms, device
    busy ms (the union of kernel intervals), kernel launches, and ms and
    count per kernel name. Busy 0 and no kernels mean the profiler saw no
    device activity. Only device activity is recorded: tracing every host
    op of a constant-optimisation round (~10^5 of them) slows the host and
    takes tens of seconds to process."""
    from torch.profiler import ProfilerActivity, profile

    sync(torch.device("cuda"))
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        fn()
        torch.cuda.synchronize()
        wall = (time.perf_counter() - t0) * 1e3
    spans = sorted((e.time_range.start, e.time_range.end, e.name) for e in prof.events()
                   if e.device_type == torch.autograd.DeviceType.CUDA)
    busy, end, per = 0.0, float("-inf"), {}
    for t0_, t1, name in spans:
        busy += max(0.0, t1 - max(t0_, end))
        end = max(end, t1)
        n, ms = per.get(name, (0, 0.0))
        per[name] = (n + 1, ms + (t1 - t0_) / 1e3)
    return dict(wall_ms=wall, busy_ms=busy / 1e3, kernels=len(spans), per_kernel=per)


# every traced run in which a kernel's launches were missing: which kernel,
# which attempt, how many calls, and how many device events the trace held
TRACE_DROPS: list = []


def kernel_device_ms(cases, runs: int, torch) -> dict:
    """``{key: mean device ms of one launch}`` of each ``(key, fn, kernel
    name)`` over the launches traced in ``runs`` calls, by torch.profiler:
    CUDA events around a wrapper call also hold its host work when the
    kernel is short."""
    out = {}
    for key, fn, kernel in cases:
        # the tracer may drop events, at times a whole short run's (at times
        # three in a row): retry, with twice the calls each time, and record
        # each run that came back without the kernel
        for attempt in range(5):
            prof = profile_device(lambda: [fn() for _ in range(runs << attempt)], torch)
            hits = [v for k, v in prof["per_kernel"].items() if f"::{kernel}<" in k]
            count = sum(c for c, _ in hits)
            if count:
                break
            drop = dict(key=key, kernel=kernel, attempt=attempt, calls=runs << attempt,
                        device_events=prof["kernels"], names=sorted(prof["per_kernel"])[:4])
            TRACE_DROPS.append(drop)
            phase_line(f"trace without {kernel} ({key}): attempt {attempt}, {drop['calls']} calls, "
                       f"{drop['device_events']} device events traced {drop['names']}")
        check(count > 0, f"no launch of {kernel} traced in 5 tries of {runs}-{runs << 4} calls")
        out[key] = sum(ms for _, ms in hits) / count
    return out


def bound(nbytes: float, ops: float, ops_per_s: float = PEAK_F32_PER_S):
    """``(ms, "bytes" | "operations")``: the least time the card could take
    to move ``nbytes`` and do ``ops`` float32 operations at ``ops_per_s``,
    and which sets it."""
    t_bytes = nbytes / PEAK_BYTES_PER_S * 1e3
    t_ops = ops / ops_per_s * 1e3
    return (t_bytes, "bytes") if t_bytes >= t_ops else (t_ops, "operations")


def nbytes(*tensors) -> int:
    return sum(t.numel() * t.element_size() for t in tensors)


# float32 operations of one operator row per device op id: the forward's one,
# and the VJP's cotangent expressions plus the adds that accumulate them
# (csrc/interpreter.cu backward_rows, unary_vjp, binary_vjp; a C library
# function such as expf counts as one)
VJP_OPS = {0: 2, 1: 3, 2: 4, 3: 6, 4: 3, 5: 4, 6: 2, 7: 2, 8: 3, 9: 4, 10: 4, 11: 4, 12: 2,
           13: 3, 14: 9, 15: 5, 16: 5}


def operator_rows(trees, fset):
    """Per device op id, the count of operator rows in ``trees``."""
    import torch

    ids = torch.tensor([-1, -1] + list(fset.device_op_ids), device=trees.ops.device)
    is_op = (trees.ops >= 2) & (trees.ops < fset.var_start)
    dev = ids[trees.ops.clamp(0, len(ids) - 1).long()]
    counts = {k: int(((dev == k) & is_op).sum()) for k in VJP_OPS}
    return {k: v for k, v in counts.items() if v}


def interp_bounds(trees, states, cot, fset):
    """``(forward, VJP)`` bounds of #8/#9 for ``trees`` broadcast against
    ``states``, every tree on as many lanes, with per-lane cotangents
    ``cot``: each input read once, of the trees only their live rows and the
    padding row before them (ops, c2 and const, 4 B each), each output
    written once as the wrappers return it (a root per lane; dconst like
    const, ddata like states); one operation per operator row and lane
    forward, the VJP's expressions backward."""
    from multitreegp_tpu_torch.core.trees import tree_sizes

    n = trees.max_nodes
    per_tree = cot.numel() // trees.ops[..., 0].numel()
    tree_bytes = int((tree_sizes(trees) + 1).clamp(max=n).sum()) * 12
    rows = operator_rows(trees, fset)
    fwd = bound(tree_bytes + nbytes(states) + cot.numel() * 4, sum(rows.values()) * per_tree)
    bwd = bound(tree_bytes + nbytes(states, cot) + nbytes(trees.const, states),
                sum((1 + VJP_OPS[k]) * v for k, v in rows.items()) * per_tree)
    return fwd, bwd


def main_data(device, s):
    """``(generator, data)``: the main path's VdP data tuple ``(x0s, ts, ys,
    None)`` from seed 0, and the generator that made it."""
    import torch

    from multitreegp_tpu_torch.models.environments import VanDerPolOscillator
    from multitreegp_tpu_torch.models.evaluators import generate_sr_data

    g = torch.Generator(device=device).manual_seed(0)
    ts_full = torch.arange(0.0, s["horizon"], s["dt"], device=device)
    x0s, _, ys_full, _ = generate_sr_data(VanDerPolOscillator(), g, ts_full, batch_size=s["batch"])
    return g, (x0s, ts_full, ys_full, None)


def run(device, sizes=FULL) -> dict:
    """Phases 2-30 on ``device``; returns the numbers the script prints."""
    import torch

    from multitreegp_tpu_torch import GeneticProgramming
    from multitreegp_tpu_torch.core import cuda_reproduction as cr
    from multitreegp_tpu_torch.core import cuda_rollout as cf
    from multitreegp_tpu_torch.core import tile_surgery as ts
    from multitreegp_tpu_torch.core.registry import build_function_set
    from multitreegp_tpu_torch.core.trees import TreeTensors, rebuild_pointers, validate_host
    from multitreegp_tpu_torch.models.evaluators import SREvaluator
    from multitreegp_tpu_torch.ops.initialization import make_population_sampler
    from multitreegp_tpu_torch.utils.metrics import node_evals_per_evaluation

    s = sizes
    n, islands, pop, b = s["max_nodes"], s["islands"], s["pop"], s["batch"]
    total_pop = islands * pop
    fset = build_function_set(OPERATORS, [["x0", "x1"]], [2])
    g, (x0s, ts_full, ys_full, _) = main_data(device, s)
    trees = make_population_sampler(fset, s["depth"], n)(g, total_pop)[0]
    out: dict = {}

    # -- phase 2: fitness kernel vs plain --------------------------------------
    def fitness_pair(t_steps):
        ts_, ys_ = ts_full[:t_steps], ys_full[:, :t_steps].contiguous()
        got = cf.sr_fitness(trees, x0s, ts_, ys_, fset, "rk4", 1)
        ref = cf.sr_fitness_plain(trees, x0s, ts_, ys_, fset, "rk4", 1)
        return got, ref

    (mse, alive), (ref, ref_alive) = fitness_pair(5)
    both = alive & ref_alive
    rel5 = float(((mse - ref).abs() / ref.abs().clamp(min=1e-30))[both].max())
    check(torch.equal(alive, ref_alive), "T=5 alive masks differ")
    check(rel5 <= 1e-6, f"T=5 relative MSE difference {rel5}")
    (mse, alive), (ref, ref_alive) = fitness_pair(ts_full.shape[0])
    agree = float((alive == ref_alive).float().mean())
    both = alive & ref_alive
    rel = ((mse - ref).abs() / ref.abs().clamp(min=1e-30))[both]
    fin = torch.isfinite(mse) & torch.isfinite(ref) & both
    a_err = float((mse - ref).abs()[fin].max())
    identical = float(lanes_identical(mse, alive, ref, ref_alive).float().mean())
    bit_equal = identical == 1.0
    check(bit_equal, f"T=50: {identical:.6f} of lanes identical to the plain version")
    phase_line(f"phase 2 fitness kernel vs plain: T=5 max rel {rel5:.3e}; T={ts_full.shape[0]} alive "
        f"agreement {agree:.6f}, max rel {float(rel.max()):.3e}, max abs {a_err:.3e}, "
        f"identical on {identical:.6f} of lanes; lanes {total_pop * b}, alive {int(alive.sum())}")
    out["fitness"] = dict(rel_t5=rel5, alive_agreement=agree, max_rel=float(rel.max()),
                          max_abs_err=a_err, bit_equal=bit_equal)

    # -- phase 3: reproduction kernel vs plain ---------------------------------
    rep = reproduction_case(device, s, trees, fset, g)
    args, got, lanes = rep.pop("args"), rep.pop("children"), rep["lanes"]
    ops_same, c_err, c_rel = rep["ops_identical"], rep["max_abs_err"], rep["max_rel"]
    phase_line(f"phase 3 reproduction kernel vs plain: {lanes} lanes, ops identical on {ops_same:.6f}, "
        f"const max abs {c_err:.3e} max rel {c_rel:.3e}; all {2 * lanes} children valid; "
        f"uniform rows per lane {args[-1].shape[0]}")
    cfg, u_rows = rep.pop("cfg"), rep.pop("u_rows")
    out["reproduce"] = rep
    slots = fset.slots(device)

    # -- phase 4: the main path -------------------------------------------------
    data = (x0s, ts_full, ys_full, None)
    gp = GeneticProgramming(
        num_generations=s["generations"], population_size=pop,
        fitness_function=SREvaluator(substeps=1), operator_list=OPERATORS,
        variable_list=[["x0", "x1"]], layer_sizes=[2], num_populations=islands,
        max_nodes=n, max_init_depth=s["depth"], device=device,
    )
    gen_g = torch.Generator(device=device).manual_seed(1)
    node_evals = node_evals_per_evaluation(total_pop, 2, n, b, ts_full.shape[0], 1, "rk4")
    cf.sr_fitness_cuda.launches = 0
    cr.reproduce_lanes_cuda.launches = 0
    pops = gp.initialize_population(gen_g)
    best, gens = [], []
    for gen in range(s["generations"]):
        sync(device)
        t0 = time.perf_counter()
        fitness, pops = gp.evaluate_population(pops, data)
        sync(device)
        t1 = time.perf_counter()
        pops = gp.evolve(pops, fitness, gen_g)
        sync(device)
        t2 = time.perf_counter()
        check(bool(torch.isfinite(fitness).all()), "non-finite fitness")
        check(bool(((fitness >= 0) & (fitness <= 1e5)).all()), "fitness outside [0, 1e5]")
        best.append(float(fitness.min()))
        gens.append(dict(eval_ms=(t1 - t0) * 1e3, evolve_ms=(t2 - t1) * 1e3,
                         node_evals_per_s=node_evals / (t1 - t0), best=best[-1]))
    launches = {"sr_fitness": cf.sr_fitness_cuda.launches, "reproduce": cr.reproduce_lanes_cuda.launches}
    check(all(b1 <= b0 for b0, b1 in zip(best, best[1:])), f"best fitness increased: {best}")
    validate_host(pops.map(lambda a: a.reshape(-1, n)), slots)
    if device.type == "cuda":
        check(launches["sr_fitness"] >= s["generations"], f"fitness kernel launches {launches}")
        check(launches["reproduce"] >= s["generations"], f"reproduction kernel launches {launches}")
    best_str = gp.to_string(gp.get_statistics(s["generations"] - 1)[1])
    for i, rec in enumerate(gens):
        phase_line(f"phase 4 main path gen {i}: eval {rec['eval_ms']:.3f} ms, evolve {rec['evolve_ms']:.3f} ms, "
            f"{rec['node_evals_per_s']:.4e} node-evals/s, best fitness {rec['best']:.6g}")
    phase_line(f"phase 4 main path: {islands}x{pop} candidates, launches {launches}, best {best_str}")
    out["main_path"] = dict(generations=gens, launches=launches, best=best_str)

    def make_gen():
        return GeneticProgramming(
            num_generations=s["fit_generations"], population_size=pop,
            fitness_function=SREvaluator(substeps=1), operator_list=OPERATORS,
            variable_list=[["x0", "x1"]], layer_sizes=[2], num_populations=islands,
            max_nodes=n, max_init_depth=s["depth"], elite_percentage=s["elite"], device=device)

    loop = loop_generations(make_gen(), data, device, s["fit_generations"], 1, fit_counters())
    out["main_path"]["graphed"] = graphed_fit(device, s, make_gen, data, 1, loop, "phase 4")

    # -- phase 5: kernel vs plain times ----------------------------------------
    ys_c = ys_full.contiguous()
    fit_k = lambda: cf.sr_fitness_cuda(trees, x0s, ts_full, ys_c, fset, "rk4", 1)
    fit_p = lambda: cf.sr_fitness_plain(trees, x0s, ts_full, ys_c, fset, "rk4", 1)
    rep_k = lambda: cr.reproduce_lanes_cuda(*args, cfg)
    rep_p = lambda: cr.reproduce_lanes_plain(*args, cfg)
    if device.type == "cuda":
        # plain, kernel, kernel, plain
        times = {}
        for name, fn, runs in (("fit_plain", fit_p, s["plain_runs"]), ("fit_kernel", fit_k, s["timing_runs"]),
                               ("rep_kernel", rep_k, s["timing_runs"]), ("rep_plain", rep_p, s["plain_runs"]),
                               ("rep_u_transpose", lambda: u_rows.T.contiguous(), s["timing_runs"])):
            times[name] = cuda_time_ms(fn, runs, torch)
        times.update(kernel_device_ms((("fit_device", fit_k, "sr_fitness_kernel"),
                                       ("rep_device", rep_k, "reproduce_kernel")), s["timing_runs"], torch))
        phase_line(f"phase 5 times (median ms): fitness kernel {times['fit_kernel']:.3f} (device "
            f"{times['fit_device']:.4f}) vs plain "
            f"{times['fit_plain']:.3f}; reproduction kernel {times['rep_kernel']:.3f} (device "
            f"{times['rep_device']:.4f}) vs plain "
            f"{times['rep_plain']:.3f} (its uniforms' lane-major copy in evolve "
            f"{times['rep_u_transpose']:.4f}); fitness kernel rate {node_evals / times['fit_kernel'] * 1e3:.4e} node-evals/s")
        out["times_ms"] = times
    out.update(interpreter_phase(device, s, trees, fset, g))
    out.update(const_opt_phase(device, s, data))
    if device.type == "cuda":
        out.update(interpreter_times(device, s, trees, fset, g))
    out.update(adaptive_kernels_phase(device, s, trees, fset, x0s, ts_full, ys_full))
    out.update(adaptive_path_phase(device, s, data))
    if device.type == "cuda":
        out.update(adaptive_times(device, s, trees, fset, x0s, ts_full, ys_full))
    ps = policy_setup(device, s)
    out.update(policy_kernels_phase(device, s, ps, trees, fset, x0s, ts_full, ys_full))
    out.update(policy_path_phase(device, s, ps))
    out.update(policy_times(device, s, ps))
    out.update(sde_phase(device, s, ps, trees, fset, ts_full))
    out.update(probe_phase(device, s))
    out.update(deep_phase(device, s, ps))
    out.update(nonfused_phase(device, s, data))
    out.update(wide_phase(device, s, data))
    out.update(gen_deep_phase(device, s, data))
    out.update(chained_phase(device, s, pops.map(lambda a: a.reshape((-1,) + a.shape[2:])), fset, data))
    out.update(sharded_phase(device, s, data))
    out.update(examples_phase(device, s))
    out.update(extended_phase(device, s, data, trees, fset, ps))
    out.update(user_phase(device, s, data, trees, fset, ps))
    out.update(vocabulary_phase(device, s, data, trees, fset))
    out.update(many_phase(device, s, data, trees, fset))
    out.update(wide_policy_phase(device, s, ps))
    out.update(user_env_phase(device, s, ps))
    out.update(special_phase(device, s, data, trees, fset))

    # -- the kernels line --------------------------------------------------------
    times = out.get("times_ms", {})
    # rk4 per step and lane: 4 tree evaluations (one operation per operator
    # row), stage inputs 6d, the update 7d, the error 3d; a lane that dies
    # stops stepping, and is counted for one step
    rows_p = ((trees.ops >= 2) & (trees.ops < fset.var_start)).sum(dim=(1, 2))
    steps = torch.where(alive, ts_full.shape[0] - 1, 1)  # (P, B); one substep
    fit_ops = float((steps * (4 * rows_p[:, None] + 16 * 2)).sum())
    fit_bytes = nbytes(trees.ops, trees.const, x0s, ts_full, ys_full) + total_pop * b * 5
    rep_bytes = nbytes(*args) + nbytes(*got)
    interp = out["interpreter"]
    k_lanes = interp["recompute"]["lanes"]
    fwd_bound, bwd_bound = interp["recompute"]["bounds"]
    fwd_bound_pop, bwd_bound_pop = interp["population"]["bounds"]
    fit_bound, rep_bound = bound(fit_bytes, fit_ops), bound(rep_bytes, 0)
    it = out.get("interp_times_ms", {}).get("recompute", {})
    it_pop = out.get("interp_times_ms", {}).get("population", {})
    launches7 = out["const_opt"]["launches"]
    launches10 = out["adaptive_path"]["launches"]

    def row(name, source, replaces, launches, err, ms, plain_ms, bnd, **extra):
        return dict(name=name, route="cuda", source=f"multitreegp_tpu_torch/csrc/{source}",
                    replaces=replaces, launches=launches, max_abs_err=err, ms=ms,
                    plain_ms=plain_ms, bound_ms=bnd[0], bound_by=bnd[1], library_ms=None,
                    **extra)

    sde = out["sde"]
    wide, gd = out["wide"], out["gen_deep"]
    wide_times = wide.get("times", {})

    def case_row(res, key):
        """A phase's #8/#9 launches on its path (loop and round), its
        bit-equal checks, and on each timed case the events, device time,
        plain version and bound."""
        launches = sum(g["eval_launches"][key] for g in res["generations"]) + res["round"]["launches"][key]
        kind = key.split("_")[1]
        shapes = {name: dict(instance=t["instance"], lanes=t["lanes"], rows_max=t["rows_max"],
                             ms=t[f"{kind}_kernel"], device_ms=t[f"{kind}_device"], plain_ms=t.get(f"{kind}_plain"),
                             plain_fwd_vjp_per_lane_ms=t["plain_fwd_vjp_per_lane"],
                             bound_ms=t[f"{kind}_bound"][0], bound_by=t[f"{kind}_bound"][1])
                  for name, t in res.get("times", {}).items() if f"{kind}_kernel" in t}
        return dict(launches=launches, checks=res["checks"], **shapes)

    def wide_row(key):
        """The wide instance on its paths: phase 19 (2048 rows), phase 27
        (Lorenz-96's 40 variables on the fixed instance, 33 operators on the
        wide one)."""
        return dict(n=s["wide_nodes"], **case_row(wide, key), lorenz96=case_row(out["lorenz96"], key),
                    ops33=case_row(out["ops33"], key))

    gen_deep = dict(n=s["deep_gen_nodes"], ms_per_generation=gd["ms_per_generation"])
    shard = out["sharded"]["ranks"]
    shard_launches = lambda key: [r["launches"][key] for r in shard]
    out["kernels"] = [
        row("sr_fitness", "sr_fitness.cu", "multitreegp_tpu/core/pallas_rollout.py:279",
            launches["sr_fitness"], a_err, times.get("fit_kernel"), times.get("fit_plain"),
            fit_bound, device_ms=times.get("fit_device"), launches_const_opt=launches7["sr_fitness"], kicks=sde["fitness_kicks"],
            deep=out["deep"]["fitness"],
            gen_deep=dict(gen_deep, launches=gd["launches"]["sr_fitness"], device_ms=gd.get("fit_device_ms")),
            launches_sharded=shard_launches("sr_fitness"), launches_chained=out["chained"]["launches"]),
        row("reproduce", "reproduce.cu", "multitreegp_tpu/core/pallas_reproduction.py:53",
            launches["reproduce"], c_err, times.get("rep_kernel"), times.get("rep_plain"),
            rep_bound, device_ms=times.get("rep_device"), launches_const_opt=launches7["reproduce"],
            launches_adaptive=launches10["reproduce"], deep=out["deep"]["reproduce"],
            gen_deep=dict(gen_deep, launches=gd["launches"]["reproduce"], device_ms=gd.get("rep_device_ms")),
            launches_sharded=shard_launches("reproduce")),
        row("interpret_fwd", "interpreter.cu", "multitreegp_tpu/core/pallas_interpreter.py:142",
            launches7["interpret_fwd"], interp["max_abs_err_fwd"], it.get("fwd_kernel"),
            it.get("fwd_plain"), fwd_bound, lanes=k_lanes, device_ms=it.get("fwd_device"),
            dispatch_ms=it.get("dispatch_fwd"), host_us=it.get("host_us"),
            launches_adaptive=launches10["interpret_fwd"],
            population=dict(lanes=interp["population"]["lanes"], ms=it_pop.get("fwd_kernel"),
                            device_ms=it_pop.get("fwd_device"), plain_ms=it_pop.get("fwd_plain"),
                            bound_ms=fwd_bound_pop[0], bound_by=fwd_bound_pop[1]),
            deep=out["deep"]["interpreter"], wide=wide_row("interpret_fwd"),
            launches_sharded=shard_launches("interpret_fwd")),
        row("interpret_bwd", "interpreter.cu", "multitreegp_tpu/core/pallas_interpreter.py:178",
            launches7["interpret_bwd"], interp["max_abs_err_bwd"], it.get("bwd_kernel"),
            it.get("bwd_plain"), bwd_bound, lanes=k_lanes, device_ms=it.get("bwd_device"),
            dispatch_fwd_bwd_ms=it.get("dispatch_fwd_bwd"),
            launches_adaptive=launches10["interpret_bwd"],
            population=dict(lanes=interp["population"]["lanes"], ms=it_pop.get("bwd_kernel"),
                            device_ms=it_pop.get("bwd_device"), plain_ms=it_pop.get("bwd_plain"),
                            bound_ms=bwd_bound_pop[0], bound_by=bwd_bound_pop[1]),
            deep=out["deep"]["interpreter"], wide=wide_row("interpret_bwd"),
            launches_sharded=shard_launches("interpret_bwd")),
    ]
    for k in out["kernels"]:  # the kernels on the device in a graphed fit() of replays only
        k["launches_graphed_fit"] = {
            phase: res["graphed"].get("graph_launches", {}).get(k["name"])
            for phase, res in (("gen", out["main_path"]), ("gen_opt", out["const_opt"]))}
    ak, at = out["adaptive_kernels"], out.get("adaptive_times_ms", {})
    g_long, i_short = ak[f"global_t{ts_full.shape[0]}"], ak[f"interval_t{s['adaptive_short_t']}"]
    ro = ak["rollout"]
    out["kernels"] += [
        row("sr_adaptive_global", "sr_adaptive.cu", "multitreegp_tpu/core/pallas_rollout.py:1828",
            launches10["sr_adaptive_global"], g_long["max_abs_err"], at.get("global_long"),
            g_long["plain_ms"], bound(g_long["bytes"], g_long["ops"]), t_steps=ts_full.shape[0],
            device_ms=at.get("global_long_device"), node_evals_per_s=at.get("global_node_evals_per_s"),
            what_sets_time=at.get("what_sets_5"), deep=out["deep"]["adaptive"]["global"]),
        row("sr_adaptive_interval", "sr_adaptive.cu", "multitreegp_tpu/core/pallas_rollout.py:1277",
            launches10["sr_adaptive_interval"], i_short["max_abs_err"], at.get("interval_short"),
            i_short["plain_ms"], bound(i_short["bytes"], i_short["ops"]), t_steps=s["adaptive_short_t"],
            device_ms=at.get("interval_short_device"), deep=out["deep"]["adaptive"]["interval"]),
        row("sr_rollout", "sr_rollout.cu", "multitreegp_tpu/core/pallas_rollout.py:163",
            launches10["sr_rollout"], ro["max_abs_err"], at.get("rollout"), ro["plain_ms"],
            bound(ro["bytes"], ro["ops"]), t_steps=ts_full.shape[0], device_ms=ro["device_ms"],
            inspection=out["adaptive_path"]["inspection"], deep=out["deep"]["rollout"]),
    ]
    pk, pp, pt = out["policy_kernels"], out["policy_path"], out["policy_times_ms"]

    def policy_row(name, kind, replaces, launches):
        static, dynamic = pt[f"{kind}_static"], pt[f"{kind}_dynamic"]
        return row(name, "policy.cu", replaces, launches, pk[f"{kind}_static"]["max_abs_err"],
                   static["ms"], pk[f"{kind}_static"]["plain_ms"], (static["bound_ms"], static["bound_by"]),
                   device_ms=static["device_ms"], t_steps=ps["data"][1].shape[0],
                   plain_t_steps=pk[f"{kind}_static"]["t_steps"],
                   dynamic=dict(ms=dynamic["ms"], device_ms=dynamic["device_ms"],
                                plain_ms=pk[f"{kind}_dynamic"]["plain_ms"],
                                bound_ms=dynamic["bound_ms"], bound_by=dynamic["bound_by"]),
                   deep=out["deep"][f"policy_{kind}"])

    out["kernels"] += [
        policy_row("policy", "fixed", "multitreegp_tpu/core/pallas_policy.py:120",
                   pp["static"]["launches"]["policy"] + pp["dynamic"]["launches"]["policy"]),
        policy_row("policy_adaptive", "adaptive", "multitreegp_tpu/core/pallas_policy.py:691",
                   pp["adaptive"]["launches"]["policy_adaptive"]),
    ]
    out["kernels"][-2]["noisy"] = sde["policy_noise"]
    ex = out["examples"]
    for k in out["kernels"]:  # phase 23's launches per example run, and the N = 30 checks
        runs = {f"{r['label']}_{r['seed']}": r["launches"][k["name"]] for r in ex["runs"]
                if r["launches"].get(k["name"])}
        if runs:
            k["examples"] = dict(launches=sum(runs.values()), runs=runs,
                                 checks=ex["checks"].get(k["name"], {}))
    ext = out["extended"]
    chains = tuple(c for c in ext["checks"] if c.startswith("interpreter_"))
    # per kernel row: its source, phase 24's timed cases and checks
    ext_of = dict(sr_fitness=("sr_fitness", ("sr_fitness",), ("sr_fitness",)),
                  sr_rollout=("sr_rollout", ("sr_rollout",), ("sr_rollout",)),
                  sr_adaptive_global=("sr_adaptive", ("sr_adaptive_global",), ("sr_adaptive_global",)),
                  sr_adaptive_interval=("sr_adaptive", ("sr_adaptive_interval",), ("sr_adaptive_interval",)),
                  interpret_fwd=("interpreter", (), chains), interpret_bwd=("interpreter", (), chains),
                  policy=("policy", ("policy_static", "policy_dynamic"), ("policy_static", "policy_dynamic")),
                  policy_adaptive=("policy", ("policy_adaptive",), ("policy_adaptive_static",)),
                  reproduce=("reproduce", (), ("reproduce",)))
    fork_of = dict(sr_fitness="sr_fitness", sr_adaptive_global="sr_adaptive_global", policy="policy_static",
                   interpret_bwd="interpret_bwd")
    for k in out["kernels"]:  # phase 24: the extended build on its path
        source, timed, checked = ext_of[k["name"]]
        launches = sum(d.get(k["name"], 0) for d in (ext["loop_launches"], ext["policy"]["launches"],
                                                      ext["launches"]))
        k["extended"] = dict(
            launches=launches,
            nvcc_s=ext.get("nvcc_s", {}).get(f"{source}_ext"),
            checks={c: ext["checks"][c] for c in checked},
            device_ms={f"{t}_{tag}": ext.get("device_ms", {}).get(f"{t}_{tag}")
                       for t in timed for tag in ("six", "ext")})
        if k["name"] in fork_of:  # the same six-operator trees through both builds
            k["extended"]["fork_device_ms"] = {
                tag: ext.get("device_ms", {}).get(f"fork_{fork_of[k['name']]}_{tag}")
                for tag in ("default", "ext_build")}
    user = out["user"]
    # per kernel row: its source, phase 25's checks and timed cases
    user_of = dict(sr_fitness=("sr_fitness", ("sr_fitness",), ("sr_fitness",)),
                   sr_rollout=("sr_rollout", ("sr_rollout",), ()),
                   sr_adaptive_global=("sr_adaptive", ("sr_adaptive_global",), ("sr_adaptive_global",)),
                   sr_adaptive_interval=("sr_adaptive", ("sr_adaptive_interval",), ()),
                   interpret_fwd=("interpreter", ("interpreter_round",), ()),
                   interpret_bwd=("interpreter", ("interpreter_round",), ("interpret_bwd",)),
                   policy=("policy", ("policy_static", "policy_dynamic"), ()),
                   policy_adaptive=("policy", ("policy_adaptive_static",), ()),
                   reproduce=("reproduce", ("reproduce",), ()))
    for k in out["kernels"]:  # phase 25: the user build on its path
        if k["name"] not in user_of:
            continue
        source, checked, timed = user_of[k["name"]]
        launches = sum(d.get(k["name"], 0) for d in (user["loop_launches"], user["policy"]["launches"],
                                                      user["launches"]))
        k["user"] = dict(
            launches=launches,
            nvcc_s={lib: sec for lib, sec in user.get("nvcc_s", {}).items() if lib.startswith(f"{source}_u")},
            checks={c: user["checks"][c] for c in checked},
            device_ms={f"{t}_{tag}": user.get("device_ms", {}).get(f"{t}_{tag}")
                       for t in timed for tag in ("ext", "ext_unary", "user")})
    voc = out["vocabulary"]
    vocab_of = dict(sr_fitness=("sr_fitness", ("sr_fitness",)), sr_rollout=("sr_rollout", ("sr_rollout",)),
                    interpret_fwd=("interpreter", ("interpreter_round",)),
                    interpret_bwd=("interpreter", ("interpreter_round",)))
    for k in out["kernels"]:  # phase 26: the vocabulary's user build on its path
        if k["name"] not in vocab_of:
            continue
        source, checked = vocab_of[k["name"]]
        k["vocabulary"] = dict(
            launches=voc["launches"].get(k["name"], 0),
            nvcc_s={lib: sec for lib, sec in voc.get("nvcc_s", {}).items() if lib.startswith(f"{source}_u")},
            checks={c: voc["checks"][c] for c in checked},
            device_ms={t: v for t, v in voc.get("device_ms", {}).items() if k["name"] == "sr_fitness"})
        if source == "interpreter":
            k["vocabulary"]["sweep"] = {
                name: dict(lanes=r["lanes"], mismatches=r["mismatches"], vjp_lanes=r["vjp_lanes"],
                           vjp_mismatches={t: v["mismatches"] for t, v in r["vjp"].items()})
                for name, r in voc["sweep"].items()}
    wk = out["lorenz96"]["wide_state"]
    for name, source, replaces in WIDE_ROWS:  # phase 27: the wide-state instances on their paths
        k = wk["kernels"][name]
        out["kernels"].append(row(name, source, replaces, k.pop("launches"), k.pop("max_abs_err"),
                                  k.pop("ms"), k.pop("plain_ms"), k.pop("bound"), **k))
    out["kernels"][-4]["trajectories"] = out["trajectories"]
    wp = out["wide_policy"]
    for name, replaces in (("policy_wide", "multitreegp_tpu/core/pallas_policy.py:120"),
                           ("policy_adaptive_wide", "multitreegp_tpu/core/pallas_policy.py:691")):
        k = dict(wp["kernels"][name])  # phase 28: the wide-state instances on their paths
        out["kernels"].append(row(name, "policy.cu", replaces, k.pop("launches"), k.pop("max_abs_err"),
                                  k.pop("ms"), k.pop("plain_ms"), k.pop("bound"), **k))
    next(k for k in out["kernels"] if k["name"] == "policy")["trajectories"] = wp["trajectories"]
    ue = out["user_env"]
    for name, replaces in (("policy_user_env", "multitreegp_tpu/core/pallas_policy.py:120"),
                           ("policy_adaptive_user_env", "multitreegp_tpu/core/pallas_policy.py:691")):
        k = dict(ue["kernels"][name])  # phase 29: the user-environment builds on their paths
        out["kernels"].append(row(name, "policy.cu", replaces, k.pop("launches"), k.pop("max_abs_err"),
                                  k.pop("ms"), k.pop("plain_ms"), k.pop("bound"), **k))
    pb = out["probe"]
    always = pb["modes"]["always"]
    out["kernels"].append(
        row("branch_probe", "branch_probe.cu", "tools/mosaic_branch_probe.py:58", pb["launches"],
            pb["max_abs_err"], always["ms"], always["plain_ms"],
            (always["bound_ms"], always["bound_by"]), modes=pb["modes"]))
    return out


def same_bits(a, b) -> bool:
    """Equal values, NaN where the other has NaN."""
    import torch

    nan = torch.isnan(a)
    return torch.equal(nan, torch.isnan(b)) and torch.equal(a[~nan], b[~nan])


def lanes_identical(mse, alive, ref, ref_alive):
    """Per lane: the same error sum (NaN where the other is NaN) and the same
    liveness."""
    import torch

    return ((mse == ref) | (torch.isnan(mse) & torch.isnan(ref))) & (alive == ref_alive)


def rollout_identical(xs, alive, ref, ref_alive):
    """``(share of lanes identical, max abs error on finite states)`` of #3's
    trajectories ``xs (T, P, B, d)`` and liveness ``(T, P, B)`` against its
    plain version's: a lane is identical when every state (NaN where the
    other has NaN) and its liveness are."""
    import torch

    same_x = (xs == ref) | (torch.isnan(xs) & torch.isnan(ref))
    lane_same = same_x.all(dim=-1).all(dim=0) & (alive == ref_alive).all(dim=0)
    fin = torch.isfinite(xs) & torch.isfinite(ref)
    max_abs = float((xs - ref).abs()[fin].max()) if bool(fin.any()) else 0.0
    return float(lane_same.float().mean()), max_abs


def rollout_ops(trees, fset, alive, t_steps: int, d: int) -> float:
    """Float32 operations of #3's RK4 rollout with one substep: per step and
    lane 4 tree evaluations (one operation per operator row), the stage
    inputs 6d, the stage sums 8d, the update 2d and the liveness test 2d; a
    lane that dies stops stepping, and is counted for one step."""
    import torch

    rows = ((trees.ops >= 2) & (trees.ops < fset.var_start)).sum(dim=(1, 2))[:, None]
    steps = torch.where(alive, t_steps - 1, 1)
    return float((steps * (4 * rows + 18 * d)).sum())


def reproduction_case(device, s, trees, fset, g) -> dict:
    """Kernel #2 against its plain version on the lanes of one generation of
    ``trees`` (``(P, m, N)``): a quarter crossover, the rest every copy /
    mutate / fresh pair; every lane's child opcodes identical, every child a
    valid tree."""
    import torch

    from multitreegp_tpu_torch.core import cuda_reproduction as cr
    from multitreegp_tpu_torch.core import tile_surgery as ts
    from multitreegp_tpu_torch.core.trees import TreeTensors, rebuild_pointers, validate_host

    n = trees.max_nodes
    cfg = ts.make_config(fset, n, s["depth"])
    elite = (int(0.1 * s["pop"]) // 2) * 2
    pairs = s["islands"] * ((s["pop"] - elite) // 2)
    lanes = pairs * fset.num_trees
    flat = trees.map(lambda a: a.reshape(-1, n))
    pick = torch.randint(0, flat.ops.shape[0], (2, lanes), generator=g, device=device)
    # (N, L) views of lane-major parents and uniforms, as reproduce_pairs gives them
    p1o, p1c = flat.ops[pick[0]].T, flat.const[pick[0]].T
    p2o, p2c = flat.ops[pick[1]].T, flat.const[pick[1]].T
    lane = torch.arange(lanes, device=device)
    cx = lane % 4 == 0  # a quarter crossover, the rest every copy/mutate/fresh pair
    act1 = torch.where(cx, 0, (lane // 4) % 3).to(torch.int32)
    act2 = torch.where(cx, 0, (lane // 12) % 3).to(torch.int32)
    vmask = fset.variable_mask.to(device)[lane % fset.num_trees].T.contiguous()
    u_rows = torch.rand((cr.rows_per_lane(cfg), lanes), generator=g, device=device)
    args = (p1o, p1c, p2o, p2c, cx, act1, act2, vmask, u_rows.T.contiguous().T)
    got = cr.reproduce_lanes(*args, cfg)
    ref = cr.reproduce_lanes_plain(*args, cfg)
    same = (got[0] == ref[0]).all(0) & (got[2] == ref[2]).all(0)  # lanes with identical children
    ops_same = float(same.float().mean())
    c_err = max(float((got[i] - ref[i]).abs()[:, same].max()) for i in (1, 3))
    c_rel = max(float(((got[i] - ref[i]).abs() / ref[i].abs().clamp(min=1e-30))[:, same].max())
                for i in (1, 3))
    bit_equal = all(torch.equal(a, b) for a, b in zip(got, ref))
    check(ops_same == 1.0, f"child ops identical on {ops_same} of lanes")
    check(c_rel <= 1e-6, f"child const relative difference {c_rel}")
    slots = fset.slots(device)
    for ops_t, const_t in (got[:2], got[2:]):
        ops = ops_t.T.contiguous()
        c1, c2 = rebuild_pointers(ops, slots)
        validate_host(TreeTensors(ops, c1, c2, const_t.T), slots)
    return dict(lanes=lanes, ops_identical=ops_same, max_abs_err=c_err, max_rel=c_rel,
                bit_equal=bit_equal, args=args, children=got, cfg=cfg, u_rows=u_rows)


def interpreter_cases(device, s, trees, fset, g):
    """The interpreter's two shapes, in the layout the recompute gives it:
    trees ``(K, 1, m, N)`` against states ``(K, B, 1, d)``, with the roots'
    cotangent ``(K, B, m)``. K is the top-k (recompute) or the population."""
    import torch

    b = s["batch"]
    cases = {}
    for name, k in (("recompute", s["top_k"]), ("population", s["islands"] * s["pop"])):
        k = min(k, trees.ops.shape[0])
        cands = trees[:k]
        states = torch.randn((k, b, 1, 2), generator=g, device=device) * 2
        cot = torch.randn((k, b, cands.ops.shape[1]), generator=g, device=device)
        cases[name] = (cands, states, cot)
    return cases


def interpreter_phase(device, s, trees, fset, g) -> dict:
    """Phase 6: kernels #8 (forward) and #9 (VJP) through ``evaluate_trees``
    and autograd, against the plain interpreter and autograd through it, per
    lane: trees and states expanded to one per lane, so no sum intervenes."""
    import torch

    from multitreegp_tpu_torch.core.interpreter import (
        evaluate_trees, evaluate_trees_plain, evaluate_trees_vjp_plain,
    )

    def compare(got, ref, what):
        fin = torch.isfinite(ref)
        check(torch.equal(torch.isfinite(got), fin), f"{what}: finite masks differ")
        diff = (got - ref).abs()[fin]
        rel = float((diff / ref.abs()[fin].clamp(min=1e-30)).max()) if fin.any() else 0.0
        check(rel <= 1e-6, f"{what}: max relative difference {rel}")
        nan = torch.isnan(ref)
        same = torch.equal(torch.isnan(got), nan) and torch.equal(got[~nan], ref[~nan])
        return float(diff.max()) if fin.any() else 0.0, rel, same, float(fin.float().mean())

    res, err_f, err_b = {}, 0.0, 0.0
    for name, (cands, states, cot) in interpreter_cases(device, s, trees, fset, g).items():
        k, b, m = cot.shape
        n = cands.max_nodes
        full = cands.map(lambda a: a[:, None].expand((k, b) + a.shape[1:]).contiguous())
        x = states.expand(k, b, m, 2).contiguous()
        const = full.const.clone().requires_grad_(True)
        xg = x.clone().requires_grad_(True)
        out = evaluate_trees(full._replace(const=const), xg, fset)
        dconst, ddata = torch.autograd.grad(out, (const, xg), cot)
        ref = evaluate_trees_plain(full, x, fset)
        ref_c, ref_d = evaluate_trees_vjp_plain(full, x, cot, fset)
        # the recompute's own layout, lanes grouped by the tree they share:
        # the per-lane outputs of the VJP, before the wrapper sums them
        out_g, dconst_g, ddata_g = grouped_per_lane(cands.map(lambda a: a[:, None]), states, cot, fset)
        sync(device)
        f = compare(out.detach(), ref, f"{name} forward")
        c = compare(dconst, ref_c, f"{name} dconst")
        d = compare(ddata, ref_d, f"{name} ddata")
        fg = compare(out_g, ref, f"{name} forward, grouped")
        cg = compare(dconst_g, ref_c, f"{name} dconst, grouped")
        dg = compare(ddata_g, ref_d, f"{name} ddata, grouped")
        err_f, err_b = max(err_f, f[0], fg[0]), max(err_b, c[0], d[0], cg[0], dg[0])
        check(all(v[2] for v in (f, c, d, fg, cg, dg)), f"{name}: a lane differs from the plain version")
        res[name] = dict(
            lanes=k * b * m, rows=operator_rows(cands, fset), bit_equal=dict(fwd=f[2], dconst=c[2], ddata=d[2]),
            bit_equal_grouped=dict(fwd=fg[2], dconst=cg[2], ddata=dg[2]),
            max_rel=dict(fwd=f[1], dconst=c[1], ddata=d[1]), finite=dict(fwd=f[3], dconst=c[3]),
            bounds=interp_bounds(cands, states, cot, fset))
        phase_line(f"phase 6 interpreter kernels vs plain, {name}: {k}x{b}x{m} = {k * b * m} lanes, "
            f"N {n}; forward max rel {f[1]:.3e} bit-equal {f[2]} (finite {f[3]:.4f}); dconst "
            f"max rel {c[1]:.3e} bit-equal {c[2]}; ddata max rel {d[1]:.3e} bit-equal {d[2]}; "
            f"grouped layout (trees (K, 1, m, N)) bit-equal forward {fg[2]}, dconst {cg[2]}, "
            f"ddata {dg[2]}")
    res.update(max_abs_err_fwd=err_f, max_abs_err_bwd=err_b)
    return {"interpreter": res}


def grouped_per_lane(trees, states, cot, fset):
    """#8's roots and #9's per-lane ``dconst``/``ddata`` (before the
    wrapper's sums) for trees broadcast against states, as the recompute
    lays them out (consecutive lanes share a tree); on CPU tensors the plain
    versions on one tree and one state per lane."""
    import torch

    from multitreegp_tpu_torch.core import cuda_interpreter as ci
    from multitreegp_tpu_torch.core.interpreter import evaluate_trees_plain, evaluate_trees_vjp_plain

    if states.device.type != "cuda":
        batch = torch.broadcast_shapes(trees.ops.shape[:-1], states.shape[:-1])
        full = trees.map(lambda a: a.expand(batch + a.shape[-1:]))
        x = states.expand(batch + states.shape[-1:])
        return (evaluate_trees_plain(full, x, fset),) + evaluate_trees_vjp_plain(full, x, cot, fset)
    out = ci.evaluate_trees_cuda(trees, states, fset)
    lib = ci._build.load("interpreter", fset.variant)
    status, dconst, ddata = ci.run_backward(lib.interpret_bwd, trees, states, cot, fset,
                                            torch.cuda.current_stream().cuda_stream)
    check(status == 0, f"interpreter backward kernel launch: status {status}")
    return out, dconst, ddata


def fit_counters() -> dict:
    """The launch counters of the kernels ``fit()``'s step reaches."""
    from multitreegp_tpu_torch.core import cuda_interpreter as ci
    from multitreegp_tpu_torch.core import cuda_reproduction as cr
    from multitreegp_tpu_torch.core import cuda_rollout as cf

    return dict(sr_fitness=cf.sr_fitness_cuda, reproduce=cr.reproduce_lanes_cuda,
                interpret_fwd=ci.evaluate_trees_cuda, interpret_bwd=ci.evaluate_trees_vjp_cuda)


def fit_tensors(out) -> list:
    best, sols, pops, fitness = out
    return [best, *sols, *pops, fitness]


# the device names of the kernels fit()'s step reaches, as torch.profiler shows them
FIT_KERNEL_NAMES = dict(sr_fitness=("sr_fitness_kernel", "sr_fitness_wide_kernel"),
                        reproduce=("reproduce_kernel",),
                        interpret_fwd=("interpret_fwd_kernel", "interpret_fwd_wide"),
                        interpret_bwd=("interpret_bwd_kernel", "interpret_bwd_wide"))


def fit_plan(gp, gens: int):
    """The generations a fresh graphed ``fit()`` of ``gens`` generations runs
    eagerly (each schedule variant's first) and captures (each variant's
    second; ``multitreegp_tpu_torch/fit_step.py``'s ``GraphedRun``)."""
    from multitreegp_tpu_torch.fit_step import schedule

    by_variant = {}
    for gen in range(gens):
        by_variant.setdefault(schedule(gp, gen), []).append(gen)
    return ([v[0] for v in by_variant.values()],
            [v[1] for v in by_variant.values() if len(v) > 1])


def device_kernel_counts(fn, torch) -> dict:
    """Launches of each kernel of :data:`FIT_KERNEL_NAMES` that ran on the
    device in ``fn()``, by torch.profiler (graph replays included)."""
    prof = profile_device(fn, torch)
    return {k: sum(n for name, (n, _) in prof["per_kernel"].items() if any(t in name for t in names))
            for k, names in FIT_KERNEL_NAMES.items()}


def cuda_graph_nodes(graph) -> int:
    """Nodes of a CUDA graph captured with ``keep_graph=True`` (libcuda's
    ``cuGraphGetNodes``)."""
    import ctypes

    get_nodes = ctypes.CDLL("libcuda.so.1").cuGraphGetNodes
    get_nodes.argtypes = [ctypes.c_void_p, ctypes.c_void_p, ctypes.POINTER(ctypes.c_size_t)]
    get_nodes.restype = ctypes.c_int
    count = ctypes.c_size_t(0)
    status = get_nodes(graph.raw_cuda_graph(), None, ctypes.byref(count))
    check(status == 0, f"cuGraphGetNodes: CUresult {status}")
    return count.value


def graphed_fit(device, s, make, data, seed, loop, label) -> dict:
    """The graphed ``fit()`` (``multitreegp_tpu_torch/fit_step.py``: one CUDA
    graph per schedule variant, migration x round, run eagerly at the
    variant's first generation, captured at its second and replayed from
    then on) of ``make()`` from ``seed`` beside ``loop``
    (:func:`loop_generations` from the same seed): the best-fitness history,
    best solutions, final populations, final fitness and the generator's
    final state bit-equal. The launch counters, zeroed before the first
    run, hold the eager generations' and the captures' launches: the host
    loop's at those generations. On the card, the same object then runs
    ``fit()`` three more times on its cached graphs, each equal again: the
    second captures the variants that came up once; the third, timed,
    replays only, and no wrapper runs in it; the fourth runs under
    torch.profiler, whose count of each kernel on the device must equal the
    host loop's launches. Per variant: capture seconds and nodes (the
    captures timed and kept by this function), replay ms (CUDA events,
    median of ``s["timing_runs"]``), one profiled replay's device busy time,
    and one warm step under ``torch.cuda.set_sync_debug_mode("error")`` (a
    host synchronisation raises); the graphs' pool's bytes."""
    import torch

    from multitreegp_tpu_torch import fit_step

    counters = fit_counters()
    gp = make()
    gens = gp.num_generations
    captures = {}
    capture = fit_step.GraphedRun._capture

    def timed_capture(run, generation):
        t0 = time.perf_counter()
        graph = capture(run, generation)
        captures[fit_step.schedule(run.gp, generation)] = dict(
            generation=generation, capture_s=time.perf_counter() - t0, nodes=cuda_graph_nodes(graph))
        return graph

    for fn in counters.values():
        fn.launches = 0
    g = torch.Generator(device=device).manual_seed(seed)
    fit_step.GraphedRun._capture, fit_step.GraphedRun.keep_graph = timed_capture, True
    try:
        sync(device)
        t0 = time.perf_counter()
        got = gp.fit(g, data)
        sync(device)
        first_s = time.perf_counter() - t0
        launches = {k: fn.launches for k, fn in counters.items()}
        want = fit_tensors(loop["outputs"])
        equal = all(torch.equal(a, b) for a, b in zip(fit_tensors(got), want))
        check(equal, f"{label}: graphed fit() differs from the host loop")
        check(torch.equal(g.get_state(), loop["state"]), f"{label}: the generator ends elsewhere")
        host_ms = statistics.mean(r["eval_ms"] + r["evolve_ms"] for r in loop["generations"])
        res = dict(generations=gens, equal=equal, first_fit_s=first_s, host_loop_ms=host_ms,
                   launches=launches, refusal=gp.fit_refusal)
        if device.type != "cuda":
            check(gp.fit_refusal.startswith("cpu"), f"{label}: fit_refusal {gp.fit_refusal!r}")
            return res
        check(gp.fit_refusal is None, f"{label}: fit() not graphed: {gp.fit_refusal}")
        eager, captured = fit_plan(gp, gens)
        at = [{k: r["eval_launches"][k] + r["evolve_launches"][k] for k in counters}
              for r in loop["generations"]]
        planned = {k: sum(at[gen][k] for gen in eager + captured) for k in counters}
        check(launches == planned, f"{label}: counted launches {launches} != the host loop's at the "
                                   f"eager generations {eager} and the captures {captured}: {planned}")
        (run,) = gp._graph_runs.values()
        variants = {fit_step.schedule(gp, gen) for gen in eager}
        sync(device)
        t0 = time.perf_counter()
        again = gp.fit(torch.Generator(device=device).manual_seed(seed), data)
        sync(device)
        second_s = time.perf_counter() - t0
        check(all(torch.equal(a, b) for a, b in zip(fit_tensors(again), want)),
              f"{label}: the second fit() differs from the host loop")
        check(set(run.graphs) == set(captures) == variants,
              f"{label}: graphs {sorted(run.graphs)}, captures {sorted(captures)}, variants {sorted(variants)}")
    finally:
        fit_step.GraphedRun._capture, fit_step.GraphedRun.keep_graph = capture, False
    for fn in counters.values():
        fn.launches = 0
    sync(device)
    t0 = time.perf_counter()
    again = gp.fit(torch.Generator(device=device).manual_seed(seed), data)
    sync(device)
    graphed_ms = (time.perf_counter() - t0) * 1e3 / gens
    check(all(torch.equal(a, b) for a, b in zip(fit_tensors(again), want)),
          f"{label}: the replays' fit() differs from the host loop")
    idle = {k: fn.launches for k, fn in counters.items()}
    check(not any(idle.values()), f"{label}: a wrapper ran in a fit() of replays: {idle}")
    fit_seed = lambda: gp.fit(torch.Generator(device=device).manual_seed(seed), data)
    for attempt in range(3):  # the tracer may drop events: it cannot add any
        on_device = device_kernel_counts(fit_seed, torch)
        if on_device == loop["launches"]:
            break
        TRACE_DROPS.append(dict(key=f"{label} graphed fit()", attempt=attempt, traced=on_device))
    check(on_device == loop["launches"], f"{label}: kernels on the device in a fit() of replays "
                                         f"{on_device} != the host loop's launches {loop['launches']}")
    check(on_device["reproduce"] == gens and on_device["sr_fitness"] >= gens,
          f"{label}: {on_device} over {gens} generations")
    pool = tuple(run.pool)
    pool_bytes = sum(seg["total_size"] for seg in torch.cuda.memory_snapshot()
                     if tuple(seg.get("segment_pool_id", ())) == pool)
    out = {}
    for variant, graph in run.graphs.items():
        stats = dict(captures[variant])

        def replay(graph=graph, gen=stats["generation"]):  # the history has room at `gen`
            run.state.generation.fill_(gen)
            graph.replay()

        stats["replay_ms"] = cuda_time_ms(replay, s["timing_runs"], torch)
        prof = profile_device(replay, torch)  # one replay: the device's busy share
        heavy = sorted(prof["per_kernel"].items(), key=lambda kv: -kv[1][1])[:4]
        stats.update(replay_wall_ms=prof["wall_ms"], replay_busy_ms=prof["busy_ms"],
                     replay_kernels=prof["kernels"],
                     replay_heaviest=[(k[:48], n, ms) for k, (n, ms) in heavy])
        state = run.state.clone()
        state.generation.fill_(stats["generation"])
        rng = torch.Generator(device=device)
        rng.set_state(run.generator.get_state())
        sync(device)
        torch.cuda.set_sync_debug_mode("error")
        try:  # a warm step: every cache filled
            fit_step.generation_step(gp, data, state, rng, stats["generation"])
        finally:
            torch.cuda.set_sync_debug_mode("default")
        stats["sync_free"] = True
        out["migrate={},round={}".format(*variant)] = stats
    res.update(graphed_ms_per_generation=graphed_ms, second_fit_s=second_s, pool_bytes=pool_bytes,
               eager_generations=eager,
               captured_generations=captured, graph_launches=on_device, variants=out)
    phase_line(f"{label} graphed fit(): {gens} generations equal to the host loop bit for bit "
               f"(history, solutions, populations, fitness, generator), four times; host loop "
               f"{host_ms:.3f} ms/generation (mean of its {gens}), graphed {graphed_ms:.3f} ms/generation "
               f"(mean of a fit() of replays only), first fit() {first_s:.2f} s (eager at {eager}, "
               f"captures at {captured}), second {second_s:.2f} s (the other captures); pool "
               f"{pool_bytes} B; counted launches {launches} (eager "
               f"generations + captures), kernels on the device in a fit() of replays {on_device} "
               f"(torch.profiler)")
    for name, v in out.items():
        phase_line(f"{label} graph {name}: captured at gen {v['generation']} in {v['capture_s']:.3f} s, "
                   f"{v['nodes']} nodes, replay {v['replay_ms']:.3f} ms "
                   f"(profiled: wall {v['replay_wall_ms']:.3f} ms, device busy {v['replay_busy_ms']:.3f} ms, "
                   f"{v['replay_kernels']} kernels; heaviest: "
                   + "; ".join(f"{k} {n} x, {ms:.3f} ms" for k, n, ms in v["replay_heaviest"])
                   + "); a warm step under sync debug mode \"error\" made no synchronisation")
    return res


def const_opt_phase(device, s, data) -> dict:
    """Phase 7: ``fit()`` with constant optimisation at full width, with the
    four kernels' launch counters read around it. Timers that synchronise
    the device run only inside the constant-optimisation rounds."""
    import torch

    from multitreegp_tpu_torch import GeneticProgramming
    from multitreegp_tpu_torch.core import cuda_interpreter as ci
    from multitreegp_tpu_torch.core import cuda_reproduction as cr
    from multitreegp_tpu_torch.core import cuda_rollout as cf
    from multitreegp_tpu_torch.core.trees import validate_host
    from multitreegp_tpu_torch.models.evaluators import SREvaluator

    gens, n, b = s["fit_generations"], s["max_nodes"], s["batch"]
    t_steps = data[1].shape[0]

    def make():
        return GeneticProgramming(
            num_generations=gens, population_size=s["pop"], fitness_function=SREvaluator(substeps=1),
            operator_list=OPERATORS, variable_list=[["x0", "x1"]], layer_sizes=[2],
            num_populations=s["islands"], max_nodes=n, max_init_depth=s["depth"],
            coefficient_optimisation=True, gradient_steps=s["gradient_steps"],
            coefficient_opt_top_k=s["top_k"], elite_percentage=s["elite"], device=device,
        )

    gp = make()
    scheduled = [gen for gen in range(gens) if gp._optimise_due(gen)]

    spans = dict(forward=0.0, recompute=0.0, backward=0.0)
    in_round = [False]

    def timed(fn, key):
        def wrapper(*args):
            if not in_round[0]:
                return fn(*args)
            sync(device)
            t0 = time.perf_counter()
            result = fn(*args)
            sync(device)
            spans[key] += time.perf_counter() - t0
            return result
        return wrapper

    rounds, fitnesses, marks = [], [], []
    optimise_core, evaluate, evolve = gp._optimise_core, gp.evaluate_population, gp.evolve

    def optimise_core_timed(populations, fitness, data_):
        flat = fitness.reshape(-1)
        top = torch.argsort(flat, stable=True)[: gp.coefficient_opt_top_k]
        before = dict(spans)
        sync(device)
        t0 = time.perf_counter()
        in_round[0] = True
        pops, fit = optimise_core(populations, fitness, data_)
        in_round[0] = False
        sync(device)
        split = {k: (spans[k] - before[k]) * 1e3 for k in spans}
        split["backward"] -= split["recompute"]  # the backward's span holds the recompute
        rounds.append(dict(generation=gp.current_generation, ms=(time.perf_counter() - t0) * 1e3,
                           unrefined=flat[top].clone(), refined=fit.reshape(-1)[top].clone(),
                           split_ms=split))
        return pops, fit

    def evaluate_recorded(populations, data_):
        fitness, pops = evaluate(populations, data_)
        fitnesses.append(fitness)
        return fitness, pops

    def evolve_marked(*args):
        result = evolve(*args)
        sync(device)
        marks.append(time.perf_counter())
        return result

    gp._optimise_core, gp.evaluate_population, gp.evolve = (
        optimise_core_timed, evaluate_recorded, evolve_marked)
    patched = [(cf, "sr_fitness", cf.sr_fitness), (cf, "sr_mse_unfused", cf.sr_mse_unfused)]
    cf.sr_fitness = timed(cf.sr_fitness, "forward")
    cf.sr_mse_unfused = timed(cf.sr_mse_unfused, "recompute")
    backward = cf.SRFitness.backward
    cf.SRFitness.backward = staticmethod(timed(backward, "backward"))
    counters = dict(sr_fitness=cf.sr_fitness_cuda, reproduce=cr.reproduce_lanes_cuda,
                    interpret_fwd=ci.evaluate_trees_cuda, interpret_bwd=ci.evaluate_trees_vjp_cuda)
    try:
        sync(device)
        t0 = time.perf_counter()
        loop = loop_generations(gp, data, device, gens, 2, counters)
        launches = loop["launches"]
    finally:
        for mod, name, fn in patched:
            setattr(mod, name, fn)
        cf.SRFitness.backward = staticmethod(backward)

    best, _, final_pops, _ = loop["outputs"]
    drift_calls = (t_steps - 1) * 4  # rk4, one substep
    check([r["generation"] for r in rounds] == scheduled, f"rounds at {rounds} != {scheduled}")
    for r in rounds:
        worse = r["refined"] > r["unrefined"] * (1 + 1e-6)
        check(not bool(worse.any()), f"refinement made {int(worse.sum())} candidates worse")
    for fitness in fitnesses:
        check(bool(torch.isfinite(fitness).all()), "non-finite fitness")
        check(bool(((fitness >= 0) & (fitness <= 1e5)).all()), "fitness outside [0, 1e5]")
    best_l = best.tolist()
    check(all(b1 <= b0 for b0, b1 in zip(best_l, best_l[1:])), f"best fitness increased: {best_l}")
    validate_host(final_pops.map(lambda a: a.reshape(-1, n)), gp.fset.slots(device))
    if device.type == "cuda":
        need = len(scheduled) * s["gradient_steps"] * drift_calls
        check(launches["interpret_fwd"] >= need and launches["interpret_bwd"] >= need,
              f"interpreter kernel launches {launches} < {need}")
        check(launches["sr_fitness"] >= gens and launches["reproduce"] >= gens,
              f"fitness / reproduction kernel launches {launches} < {gens}")
    profile = None
    if device.type == "cuda":  # one more round, profiled: where its time goes
        flat = final_pops.map(lambda a: a.reshape((-1,) + a.shape[2:]))
        top = torch.argsort(fitnesses[-1].reshape(-1), stable=True)[: gp.coefficient_opt_top_k]
        profile = profile_device(lambda: gp.optimise(flat[top], data), torch)
        heavy = sorted(profile["per_kernel"].items(), key=lambda kv: -kv[1][1])[:4]
        phase_line(f"phase 7 profiled round: wall {profile['wall_ms']:.1f} ms, device busy "
            f"{profile['busy_ms']:.2f} ms ({profile['busy_ms'] / profile['wall_ms']:.2%}), "
            f"{profile['kernels']} kernel launches; heaviest: " + "; ".join(
                f"{k[:40]} {n} x, {ms:.2f} ms" for k, (n, ms) in heavy))
        profile["per_kernel"] = {k: list(v) for k, v in heavy}
    gen_ms = [(t1 - t0_) * 1e3 for t0_, t1 in zip([t0] + marks, marks)]
    plain_gens = [ms for i, ms in enumerate(gen_ms) if i and i not in scheduled]
    summary = [dict(generation=r["generation"], ms=r["ms"], split_ms=r["split_ms"],
                    unrefined_sum=float(r["unrefined"].sum()), refined_sum=float(r["refined"].sum()),
                    improved=int((r["refined"] < r["unrefined"]).sum()),
                    best_unrefined=float(r["unrefined"].min()), best_refined=float(r["refined"].min()))
               for r in rounds]
    phase_line(f"phase 7 const-opt fit: {s['islands']}x{s['pop']} candidates, {gens} generations, top-k "
        f"{gp.coefficient_opt_top_k}, {s['gradient_steps']} Adam steps, rounds at {scheduled}; "
        f"launches {launches} (interpreter needs >= {len(scheduled) * s['gradient_steps'] * drift_calls})")
    for r in summary:
        sp = r["split_ms"]
        phase_line(f"phase 7 round at gen {r['generation']}: {r['ms']:.1f} ms (fused forward "
            f"{sp['forward']:.1f}, recompute {sp['recompute']:.1f}, backward {sp['backward']:.1f}); "
            f"top-k fitness sum {r['unrefined_sum']:.6g} -> {r['refined_sum']:.6g}, "
            f"{r['improved']} improved, best {r['best_unrefined']:.6g} -> {r['best_refined']:.6g}")
    phase_line(f"phase 7 ms per generation: without a round median {statistics.median(plain_gens):.3f} "
        f"(first {gen_ms[0]:.1f}); with a round "
        f"{', '.join(f'{gen_ms[g_]:.1f}' for g_ in scheduled)}; best fitness "
        f"{best_l[0]:.6g} -> {best_l[-1]:.6g}")
    graphed = graphed_fit(device, s, make, data, 2, loop, "phase 7")
    if device.type == "cuda":
        round_ms = {k: v["replay_ms"] for k, v in graphed["variants"].items() if k.endswith("round=True")}
        phase_line(f"phase 7 graphed round: replay {', '.join(f'{k} {v:.1f} ms' for k, v in round_ms.items())} "
                   f"against the host loop's {', '.join(f"{r['ms']:.1f}" for r in summary)} ms a round")
    return {"const_opt": dict(launches=launches, rounds=summary, generation_ms=gen_ms,
                              best=best_l, drift_calls=drift_calls, round_profile=profile,
                              graphed=graphed)}


def interpreter_times(device, s, trees, fset, g) -> dict:
    """Phase 8: CUDA-event times of kernels #8 and #9 and their plain
    versions at both shapes, in turns (plain, kernel, kernel, plain)."""
    import torch

    from multitreegp_tpu_torch.core import cuda_interpreter as ci
    from multitreegp_tpu_torch.core.interpreter import (
        evaluate_trees, evaluate_trees_plain, evaluate_trees_vjp_plain,
    )

    res = {}
    for name, (cands, states, cot) in interpreter_cases(device, s, trees, fset, g).items():
        trees_b = cands.map(lambda a: a[:, None])
        fns = dict(
            fwd_plain=(lambda: evaluate_trees_plain(trees_b, states, fset), s["plain_runs"]),
            fwd_kernel=(lambda: ci.evaluate_trees_cuda(trees_b, states, fset), s["interp_runs"]),
            bwd_kernel=(lambda: ci.evaluate_trees_vjp_cuda(trees_b, states, cot, fset), s["interp_runs"]),
            bwd_plain=(lambda: evaluate_trees_vjp_plain(trees_b, states, cot, fset), s["plain_runs"]),
        )
        const = cands.const[:, None].clone().requires_grad_(True)
        xg = states.clone().requires_grad_(True)
        trees_g = trees_b._replace(const=const)
        # what a drift call of the recompute pays: the dispatcher forward,
        # and forward and backward through autograd
        fns["dispatch_fwd"] = (lambda: evaluate_trees(trees_b, states, fset), s["interp_runs"])
        fns["dispatch_fwd_bwd"] = (
            lambda: torch.autograd.grad(evaluate_trees(trees_g, xg, fset), (const, xg), cot),
            s["interp_runs"])
        res[name] = {k: cuda_time_ms(fn, runs, torch) for k, (fn, runs) in fns.items()}
        t = res[name]
        # the kernels' own device time, without the wrapper's host work
        for key, kernel in (("fwd", "interpret_fwd_kernel"), ("bwd", "interpret_bwd_kernel")):
            fn, runs = fns[f"{key}_kernel"]
            prof = profile_device(lambda: [fn() for _ in range(runs)], torch)
            hits = [v for k_, v in prof["per_kernel"].items() if kernel in k_]
            t[f"{key}_device"] = sum(ms for _, ms in hits) / max(1, sum(c for c, _ in hits)) if hits else None
        t["host_us"] = host_split(trees_b, states, cot, fset, torch)
        dev = lambda v: "not measured" if v is None else f"{v:.4f}"
        h = t["host_us"]
        phase_line(f"phase 8 interpreter times (median ms), {name} {cot.numel()} lanes: forward kernel "
            f"{t['fwd_kernel']:.4f} (device {dev(t['fwd_device'])}) vs plain {t['fwd_plain']:.3f}; "
            f"VJP kernel {t['bwd_kernel']:.4f} (device {dev(t['bwd_device'])}) vs plain "
            f"{t['bwd_plain']:.3f}; dispatcher evaluate_trees {t['dispatch_fwd']:.4f}, forward + "
            f"backward through autograd {t['dispatch_fwd_bwd']:.4f}; host us per call: forward "
            f"wrapper {h['fwd_wrapper']:.2f} (_operands {h['operands']:.2f}, ctypes call "
            f"{h['fwd_ctypes']:.2f}, rest {h['fwd_rest']:.2f}), VJP wrapper {h['bwd_wrapper']:.2f} "
            f"(ctypes call {h['bwd_ctypes']:.2f}, rest {h['bwd_rest']:.2f}); within the rest: "
            f"stream lookup {h['stream']:.2f}, torch.empty {h['empty']:.2f}, the VJP's two sums "
            f"{h['sums']:.2f}; EvaluateTrees.apply (forward) {h['dispatch_fwd']:.2f}")
    return {"interp_times_ms": res}


def host_split(trees, states, cot, fset, torch, calls=200) -> dict:
    """Host microseconds per call of the interpreter wrappers (the card's
    host clock; each loop ends in a synchronise, so the queue never backs
    up): the whole forward and VJP wrappers, ``_operands`` on a cache hit,
    and the bare ``ctypes`` calls with their pointers made beforehand; "rest"
    is the wrapper less the two (output allocation, stream lookup, checks,
    the VJP's cotangent copy and sums), and three of its parts alone; and the
    dispatcher's autograd ``Function`` around the forward wrapper."""
    from multitreegp_tpu_torch.core import cuda_interpreter as ci
    from multitreegp_tpu_torch.core.interpreter import EvaluateTrees

    lib = ci._build.load("interpreter")
    fwd, bwd = ci._bind(lib.interpret_fwd, "interpret_fwd"), ci._bind(lib.interpret_bwd, "interpret_bwd")
    stream = torch.cuda.current_stream().cuda_stream
    ops, c2, cst, x, layout = ci._operands(trees, states, fset)
    out = torch.empty(layout.batch, device=states.device)
    dconst = torch.empty((trees.max_nodes, layout.lanes), device=states.device)
    ddata = torch.empty((x.shape[-1], layout.lanes), device=states.device)
    ptrs = (ops.data_ptr(), c2.data_ptr(), cst.data_ptr(), x.data_ptr(), layout.address)
    g = cot.contiguous()

    def per_call_us(fn):
        fn()
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        for _ in range(calls):
            fn()
        t1 = time.perf_counter()
        torch.cuda.synchronize()
        return (t1 - t0) / calls * 1e6

    batch, shape_c, shape_d = layout.batch, trees.const.shape, states.shape

    def sums():  # the VJP's per-lane views summed back to the primal shapes
        for t, shape in ((dconst, shape_c), (ddata, shape_d)):
            t.view((t.shape[0],) + tuple(batch)).movedim(0, -1).sum_to_size(shape)

    h = dict(
        fwd_wrapper=per_call_us(lambda: ci.evaluate_trees_cuda(trees, states, fset)),
        bwd_wrapper=per_call_us(lambda: ci.evaluate_trees_vjp_cuda(trees, states, cot, fset)),
        dispatch_fwd=per_call_us(lambda: EvaluateTrees.apply(*trees, states, fset)),
        operands=per_call_us(lambda: ci._operands(trees, states, fset)),
        fwd_ctypes=per_call_us(lambda: fwd(*ptrs, out.data_ptr(), None, 0, layout.lanes, stream)),
        bwd_ctypes=per_call_us(lambda: bwd(*ptrs, g.data_ptr(), dconst.data_ptr(),
                                           ddata.data_ptr(), None, 0, layout.lanes, stream)),
        stream=per_call_us(lambda: torch.cuda.current_stream(states.device).cuda_stream),
        empty=per_call_us(lambda: torch.empty(batch, dtype=torch.float32, device=states.device)),
        sums=per_call_us(sums))
    h["fwd_rest"] = h["fwd_wrapper"] - h["operands"] - h["fwd_ctypes"]
    h["bwd_rest"] = h["bwd_wrapper"] - h["operands"] - h["bwd_ctypes"]
    return h


# float32 operations per attempted Dormand-Prince step and lane besides its six
# tree evaluations, per state component (csrc/sr_adaptive.cu rk_step): the
# stage inputs 2 * (1 + ... + 6) + 2 * 6, x_hi and x_lo 2 * (7 + 1) each, the
# error norm's 9; and per lane the controller's ~20
DOPRI5_OPS_PER_DIM, CONTROL_OPS = 2 * 21 + 12 + 32 + 9, 20


def adaptive_ops(trees, fset, steps, d: int, t_steps: int) -> float:
    """float32 operations of an adaptive dopri5 run from its attempted steps
    per lane ``steps (P, B)``: six tree evaluations (one operation per
    operator row) and the step's arithmetic per attempt, the up-front
    evaluation, and the squared error at each save."""
    rows = ((trees.ops >= 2) & (trees.ops < fset.var_start)).sum(dim=(1, 2))[:, None]  # (P, 1)
    per_step = 6 * rows + DOPRI5_OPS_PER_DIM * d + CONTROL_OPS
    return float((steps * per_step + rows + 3 * d * t_steps).sum())


def compare_adaptive(got, ref):
    """Per lane: error sum, alive and attempted steps identical; returns
    ``(share identical, alive agreement, steps agreement, max rel and max
    abs on lanes alive in both)``."""
    import torch

    (mse, alive, steps), (mse_r, alive_r, steps_r) = got, ref
    same_mse = (mse == mse_r) | (torch.isnan(mse) & torch.isnan(mse_r))
    same = same_mse & (alive == alive_r) & (steps == steps_r)
    both = alive & alive_r
    diff = (mse - mse_r).abs()[both]
    rel = diff / mse_r.abs()[both].clamp(min=1e-30)
    return (float(same.float().mean()), float((alive == alive_r).float().mean()),
            float((steps == steps_r).float().mean()), float(rel.max()) if rel.numel() else 0.0,
            float(diff.max()) if diff.numel() else 0.0)


def warp_maxima(steps):
    """The attempted steps of each warp's slowest lane: ``steps (P, B)`` in
    launch order (candidate-major) cut into warps of 32 consecutive lanes."""
    flat = steps.reshape(-1)
    return flat[: flat.numel() // 32 * 32].reshape(-1, 32).amax(dim=1)


def warp_steps(steps, budget: int) -> dict:
    """Per-warp maxima of ``steps (P, B)``: min, median, max, their sum,
    and how many warps reach ``budget``."""
    w = warp_maxima(steps)
    return dict(warps=w.numel(), warp_steps_min=int(w.min()), warp_steps_median=float(w.float().median()),
                warp_steps_max=int(w.max()), warp_steps_total=int(w.sum()),
                warps_at_budget=int((w >= budget).sum()))


def timed_plain(fn, device):
    """``(result, ms)`` of one call, by CUDA events on the card (wall clock
    on the CPU)."""
    import torch

    if device.type != "cuda":
        t0 = time.perf_counter()
        return fn(), (time.perf_counter() - t0) * 1e3
    start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
    start.record()
    out = fn()
    end.record()
    torch.cuda.synchronize()
    return out, start.elapsed_time(end)


def adaptive_kernels_phase(device, s, trees, fset, x0s, ts_full, ys_full) -> dict:
    """Phase 9: kernels #5, #4 and #3 against their plain versions on the
    population of phase 2, every candidate on every trajectory. Each plain
    version runs once (it is timed by CUDA events here; phase 11 reports it
    beside the kernels')."""
    import torch

    from multitreegp_tpu_torch.core import cuda_adaptive as ca
    from multitreegp_tpu_torch.core import cuda_rollout as cf

    t_short, t_long = s["adaptive_short_t"], ts_full.shape[0]
    budget, per_interval = s["adaptive_budget"], s["adaptive_interval_steps"]
    grid = lambda t: (ts_full[:t], ys_full[:, :t].contiguous())
    cases = [
        ("global", t_short, ca.sr_fitness_adaptive_global_cuda, ca.sr_fitness_adaptive_global_plain,
         s["adaptive_check_budget"]),
        ("global", t_long, ca.sr_fitness_adaptive_global_cuda, ca.sr_fitness_adaptive_global_plain, budget),
        ("interval", t_short, ca.sr_fitness_adaptive_interval_cuda, ca.sr_fitness_adaptive_interval_plain,
         per_interval),
    ]
    on_card = device.type == "cuda"
    res = {}
    for kind, t_steps, kernel, plain, steps_arg in cases:
        ts_, ys_ = grid(t_steps)
        args = (trees, x0s, ts_, ys_, fset, 1e-4, 1e-6, steps_arg, "dopri5", 0.9)
        got = kernel(*args) if on_card else plain(*args)
        ref, plain_ms = timed_plain(lambda: plain(*args), device)
        same, alive_ok, steps_ok, max_rel, max_abs = compare_adaptive(got, ref)
        check(same == 1.0, f"{kind} T={t_steps}: only {same:.6f} of lanes identical")
        st = got[2].float()
        key = f"{kind}_t{t_steps}"
        res[key] = dict(identical=same, alive_agreement=alive_ok, steps_agreement=steps_ok,
                        max_rel=max_rel, max_abs_err=max_abs, plain_ms=plain_ms,
                        alive=float(got[1].float().mean()), steps_total=int(got[2].sum()),
                        steps_min=int(st.min()), steps_median=float(st.median()),
                        steps_max=int(st.max()), lanes=got[1].numel())
        r = res[key]
        # a warp is 32 consecutive lanes in launch order (B trajectories x
        # its candidates) and runs its slowest lane's steps
        budget_steps = steps_arg if kind == "global" else steps_arg * (t_steps - 1)
        r.update(warp_steps(got[2], budget_steps))
        r["ops"] = adaptive_ops(trees, fset, got[2], x0s.shape[1], t_steps)
        r["bytes"] = nbytes(trees.ops, trees.const, x0s, ts_, ys_) + got[1].numel() * 9
        phase_line(f"phase 9 {'#5 global' if kind == 'global' else '#4 per-interval'} adaptive kernel "
                   f"vs plain, dopri5, T={t_steps}, {r['lanes']} lanes: identical {same:.6f}, alive "
                   f"agreement {alive_ok:.6f}, steps agreement {steps_ok:.6f}, max rel (alive in both) "
                   f"{max_rel:.3e}, max abs {max_abs:.3e}; alive {r['alive']:.4f}; attempted steps "
                   f"total {r['steps_total']}, per lane min {r['steps_min']} median "
                   f"{r['steps_median']:.0f} max {r['steps_max']}; per-warp max over {r['warps']} warps: "
                   f"min {r['warp_steps_min']} median {r['warp_steps_median']:.0f} max "
                   f"{r['warp_steps_max']}, sum {r['warp_steps_total']}, {r['warps_at_budget']} warps "
                   f"reach the budget of {budget_steps}; plain {plain_ms:.1f} ms")
    # #3: the trajectory, RK4 with one substep over the whole grid
    rollout = lambda: (cf.sr_rollout_cuda if on_card else cf.sr_rollout_plain)(
        trees, x0s, ts_full, fset, "rk4", 1)
    xs, alive = rollout()
    (ref, ref_alive), plain_ms = timed_plain(
        lambda: cf.sr_rollout_plain(trees, x0s, ts_full, fset, "rk4", 1), device)
    share, max_abs = rollout_identical(xs, alive, ref, ref_alive)
    check(share == 1.0, f"trajectory kernel: {share:.6f} of lanes bit-equal")
    res["rollout"] = dict(identical=share, max_abs_err=max_abs, plain_ms=plain_ms,
                          alive=float(alive[-1].float().mean()), lanes=alive[-1].numel(),
                          ops=rollout_ops(trees, fset, alive[-1], t_long, x0s.shape[1]),
                          bytes=nbytes(trees.ops, trees.const, x0s, ts_full, xs) + alive[-1].numel(),
                          device_ms=None)
    if on_card:
        res["rollout"]["device_ms"] = kernel_device_ms(
            (("rollout", rollout, "sr_rollout_kernel"),), s["timing_runs"], torch)["rollout"]
    phase_line(f"phase 9 #3 trajectory kernel vs plain, rk4, T={t_long}, {alive[-1].numel()} lanes: "
               f"bit-equal {share:.6f}, max abs {max_abs:.3e}; alive {res['rollout']['alive']:.4f}; "
               + (f"device {res['rollout']['device_ms']:.4f} ms; " if on_card else "")
               + f"plain {plain_ms:.1f} ms")
    return {"adaptive_kernels": res}


def adaptive_path_phase(device, s, data) -> dict:
    """Phase 10: the adaptive path through the user's entry points, with all
    seven launch counters zeroed before it and read after."""
    import torch

    from multitreegp_tpu_torch import GeneticProgramming
    from multitreegp_tpu_torch.core import cuda_adaptive as ca
    from multitreegp_tpu_torch.core import cuda_interpreter as ci
    from multitreegp_tpu_torch.core import cuda_reproduction as cr
    from multitreegp_tpu_torch.core import cuda_rollout as cf
    from multitreegp_tpu_torch.core.trees import validate_host
    from multitreegp_tpu_torch.models.evaluators import SREvaluator

    n, b, islands, pop = s["max_nodes"], s["batch"], s["islands"], s["pop"]
    x0s, ts, ys, _ = data
    ev = SREvaluator(method="adaptive", adaptive_method="dopri5", adaptive_budget=s["adaptive_budget"])
    gp = GeneticProgramming(
        num_generations=s["generations"], population_size=pop, fitness_function=ev,
        operator_list=OPERATORS, variable_list=[["x0", "x1"]], layer_sizes=[2],
        num_populations=islands, max_nodes=n, max_init_depth=s["depth"],
        gradient_steps=s["adaptive_opt_steps"], coefficient_opt_top_k=s["top_k"], device=device,
    )
    counters = dict(sr_adaptive_global=ca.sr_fitness_adaptive_global_cuda,
                    sr_adaptive_interval=ca.sr_fitness_adaptive_interval_cuda,
                    reproduce=cr.reproduce_lanes_cuda, interpret_fwd=ci.evaluate_trees_cuda,
                    interpret_bwd=ci.evaluate_trees_vjp_cuda, sr_rollout=cf.sr_rollout_cuda,
                    sr_fitness=cf.sr_fitness_cuda)
    for fn in counters.values():
        fn.launches = 0
    gen_g = torch.Generator(device=device).manual_seed(3)
    pops = gp.initialize_population(gen_g)
    best, gens = [], []
    for gen in range(s["generations"]):
        sync(device)
        t0 = time.perf_counter()
        fitness, pops_eval = gp.evaluate_population(pops, data)
        sync(device)
        t1 = time.perf_counter()
        pops = gp.evolve(pops_eval, fitness, gen_g)
        sync(device)
        t2 = time.perf_counter()
        check(bool(torch.isfinite(fitness).all()), "non-finite adaptive fitness")
        check(bool(((fitness >= 0) & (fitness <= 1e5)).all()), "adaptive fitness outside [0, 1e5]")
        best.append(float(fitness.min()))
        gens.append(dict(eval_ms=(t1 - t0) * 1e3, evolve_ms=(t2 - t1) * 1e3, best=best[-1]))
    check(all(b1 <= b0 for b0, b1 in zip(best, best[1:])), f"best adaptive fitness increased: {best}")
    validate_host(pops.map(lambda a: a.reshape(-1, n)), gp.fset.slots(device))
    loop_launches = {k: fn.launches for k, fn in counters.items()}

    # attempted-step telemetry of the last evaluated population, both budgets
    flat = pops_eval.map(lambda a: a.reshape((-1,) + a.shape[2:]))
    _, alive_g, steps_g = ca.sr_fitness_adaptive_global(
        flat, x0s, ts, ys, gp.fset, budget=s["adaptive_budget"], method="dopri5", return_steps=True)
    _, alive_i, steps_i = ca.adaptive_solver_stats(
        flat, x0s, ts, ys, gp.fset, max_steps=s["adaptive_interval_steps"], method="dopri5")
    telemetry = {}
    for key, st, al in (("global", steps_g, alive_g), ("interval", steps_i, alive_i)):
        f = st.float()
        telemetry[key] = dict(total=int(st.sum()), min=int(st.min()), median=float(f.median()),
                              max=int(st.max()), mean=float(f.mean()), alive=float(al.float().mean()),
                              at_budget=float((st >= (s["adaptive_budget"] if key == "global" else
                                                     s["adaptive_interval_steps"] * (ts.shape[0] - 1))
                                               ).float().mean()))

    # one constant-optimisation call through the adaptive gradient
    top = torch.argsort(fitness.reshape(-1), stable=True)[: gp.coefficient_opt_top_k]
    cands = flat[top]
    spans = dict(forward=0.0, recompute=0.0, backward=0.0)

    def timed(fn, key):
        def wrapper(*args, **kwargs):
            sync(device)
            t0 = time.perf_counter()
            result = fn(*args, **kwargs)
            sync(device)
            spans[key] += time.perf_counter() - t0
            return result
        return wrapper

    patched = [(ca, "sr_fitness_adaptive_global"), (ca, "adaptive_mse_unfused")]
    saved = [getattr(m, a) for m, a in patched] + [ca.SRFitnessAdaptive.backward]
    ca.sr_fitness_adaptive_global = timed(ca.sr_fitness_adaptive_global, "forward")
    ca.adaptive_mse_unfused = timed(ca.adaptive_mse_unfused, "recompute")
    ca.SRFitnessAdaptive.backward = staticmethod(timed(ca.SRFitnessAdaptive.backward, "backward"))
    try:
        before = ev.evaluate_population(cands, data)
        for k in spans:
            spans[k] = 0.0
        sync(device)
        t0 = time.perf_counter()
        refined, _ = gp.optimise(cands, data)
        sync(device)
        opt_ms = (time.perf_counter() - t0) * 1e3
    finally:
        for (m, a), fn in zip(patched, saved):
            setattr(m, a, fn)
        ca.SRFitnessAdaptive.backward = staticmethod(saved[-1])
    split = {k: v * 1e3 for k, v in spans.items()}
    split["backward"] -= split["recompute"]  # the backward's span holds the recompute
    worse = refined > before * (1 + 1e-6)
    check(not bool(worse.any()), f"refinement made {int(worse.sum())} candidates worse")

    # the best candidate's trajectories through the RK4 evaluator (kernel #3)
    best_cand = flat[int(torch.argmin(fitness.reshape(-1)))]
    rk4 = SREvaluator(fset=gp.fset, substeps=1)
    cand_fit, pred = rk4.evaluate_candidate(best_cand, data)
    call_fit = float(rk4(best_cand, data))
    check(pred.shape == (b, ts.shape[0], 2) and bool(torch.isfinite(cand_fit).all()),
          "evaluate_candidate of the best candidate")
    check(0.0 <= call_fit <= 1e5, f"evaluator call {call_fit}")
    launches = {k: fn.launches for k, fn in counters.items()}
    if device.type == "cuda":
        check(loop_launches["sr_adaptive_global"] >= s["generations"], f"#5 launches {loop_launches}")
        check(loop_launches["reproduce"] >= s["generations"], f"#2 launches {loop_launches}")
        check(launches["sr_adaptive_interval"] >= 1, f"#4 launches {launches}")
        check(launches["interpret_fwd"] >= 1 and launches["interpret_bwd"] >= 1,
              f"#8/#9 launches {launches}")
        check(launches["sr_rollout"] >= 1, f"#3 launches {launches}")
    # #3 at the inspection shape evaluate_candidate gives it (P = 1, B
    # trajectories), timed after the counters were read
    one = best_cand.map(lambda a: a[None])
    inspect_fn = lambda: (cf.sr_rollout_cuda if device.type == "cuda" else cf.sr_rollout_plain)(
        one, x0s, ts, gp.fset, "rk4", 1)
    xs1, alive1 = inspect_fn()
    (ref1, ref_alive1), plain1_ms = timed_plain(
        lambda: cf.sr_rollout_plain(one, x0s, ts, gp.fset, "rk4", 1), device)
    same1, _ = rollout_identical(xs1, alive1, ref1, ref_alive1)
    check(same1 == 1.0, f"#3 at P = 1: {same1:.6f} of lanes bit-equal")
    inspection = dict(lanes=alive1[-1].numel(), identical=same1, plain_ms=plain1_ms, ms=None,
                      device_ms=None)
    inspection["bound_ms"], inspection["bound_by"] = bound(
        nbytes(one.ops, one.const, x0s, ts, xs1) + alive1[-1].numel(),
        rollout_ops(one, gp.fset, alive1[-1], ts.shape[0], x0s.shape[1]))
    if device.type == "cuda":
        inspection["ms"] = cuda_time_ms(inspect_fn, s["timing_runs"], torch)
        inspection["device_ms"] = kernel_device_ms(
            (("inspect", inspect_fn, "sr_rollout_kernel"),), s["timing_runs"], torch)["inspect"]
    for i, rec in enumerate(gens):
        phase_line(f"phase 10 adaptive path gen {i}: eval {rec['eval_ms']:.3f} ms, evolve "
                   f"{rec['evolve_ms']:.3f} ms, best fitness {rec['best']:.6g}")
    for key, tl in telemetry.items():
        phase_line(f"phase 10 attempted steps per lane, {key} budget: total {tl['total']}, min "
                   f"{tl['min']}, median {tl['median']:.0f}, max {tl['max']}, mean {tl['mean']:.2f}; "
                   f"alive {tl['alive']:.4f}, at the budget {tl['at_budget']:.4f}")
    phase_line(f"phase 10 optimise: top-k {cands.ops.shape[0]}, {gp.gradient_steps} Adam steps, "
               f"{opt_ms:.1f} ms (forward {split['forward']:.1f}, recompute {split['recompute']:.1f}, "
               f"backward {split['backward']:.1f}); fitness sum {float(before.sum()):.6g} -> "
               f"{float(refined.sum()):.6g}, {int((refined < before).sum())} improved")
    phase_line(f"phase 10 best under rk4: per-trajectory fitness {[round(float(v), 6) for v in cand_fit]}, "
               f"call {call_fit:.6g}; launches in the loop {loop_launches}, in the whole phase {launches}")
    phase_line(f"phase 10 #3 at the inspection shape (1 candidate x {inspection['lanes']} trajectories, "
               f"T={ts.shape[0]}): bit-equal {same1:.6f}; "
               + (f"{inspection['ms']:.4f} ms (device {inspection['device_ms']:.4f}); "
                  if inspection["ms"] is not None else "")
               + f"bound {inspection['bound_ms']:.6f} ms by {inspection['bound_by']}; plain {plain1_ms:.1f} ms")
    return {"adaptive_path": dict(generations=gens, best=best, loop_launches=loop_launches,
                                  launches=launches, telemetry=telemetry, optimise_ms=opt_ms,
                                  optimise_split_ms=split, unrefined_sum=float(before.sum()),
                                  refined_sum=float(refined.sum()),
                                  improved=int((refined < before).sum()), candidate_fitness=call_fit,
                                  inspection=inspection)}


def adaptive_times(device, s, trees, fset, x0s, ts_full, ys_full) -> dict:
    """Phase 11: CUDA-event times of kernels #5, #4 and #3 at the phase 9
    shapes (the plain versions' single runs were timed in phase 9), the
    device time per launch of #5 and #4, and what sets #5's time (T = 50):
    #5 on the first 1/8 of the candidates (a few warps per SM instead of
    ~15), and on the candidates sorted by their slowest lane's steps (the
    same lanes, fewer warp-steps: an upper bound of what binning lanes by
    effort can save). If the slowest warp's latency sets the time, the full
    run takes about the 1/8 run's time and sorting saves little; if the
    card's issue rate does, both scale with the warp-steps per SM."""
    from multitreegp_tpu_torch.core import cuda_adaptive as ca
    from multitreegp_tpu_torch.core import cuda_rollout as cf
    from multitreegp_tpu_torch.utils.metrics import adaptive_node_evals

    import torch

    t_short = s["adaptive_short_t"]
    short = (ts_full[:t_short], ys_full[:, :t_short].contiguous())
    glob = lambda tr: (lambda: ca.sr_fitness_adaptive_global_cuda(tr, x0s, ts_full, ys_full, fset,
                                                                  budget=s["adaptive_budget"]))
    fns = dict(
        global_long=glob(trees),
        global_short=lambda: ca.sr_fitness_adaptive_global_cuda(trees, x0s, *short, fset,
                                                                budget=s["adaptive_budget"]),
        interval_short=lambda: ca.sr_fitness_adaptive_interval_cuda(
            trees, x0s, *short, fset, max_steps=s["adaptive_interval_steps"], method="dopri5"),
        rollout=lambda: cf.sr_rollout_cuda(trees, x0s, ts_full, fset, "rk4", 1),
    )
    times = {k: cuda_time_ms(fn, s["timing_runs"], torch) for k, fn in fns.items()}
    steps = fns["global_long"]()[2]
    rate = adaptive_node_evals(steps, "dopri5", 2, s["max_nodes"]) / times["global_long"] * 1e3
    p = trees.ops.shape[0]
    part = trees[: p // 8]
    order = torch.argsort(steps.amax(dim=1), stable=True)
    by_effort = trees[order]
    check(torch.equal(glob(by_effort)()[2], steps[order]), "#5 on sorted candidates: other steps")
    times.update(kernel_device_ms((("global_long_device", fns["global_long"], "adaptive_global_kernel"),
                                   ("interval_short_device", fns["interval_short"], "adaptive_interval_kernel"),
                                   ("global_part_device", glob(part), "adaptive_global_kernel"),
                                   ("global_sorted_device", glob(by_effort), "adaptive_global_kernel")),
                                  s["timing_runs"], torch))
    full, part_w, sorted_w = warp_maxima(steps), warp_maxima(steps[: p // 8]), warp_maxima(steps[order])
    what = dict(warps=full.numel(), warp_steps=int(full.sum()), warp_steps_max=int(full.max()),
                part_warps=part_w.numel(), part_warp_steps=int(part_w.sum()),
                part_warp_steps_max=int(part_w.max()), part_ms=times["global_part_device"],
                sorted_warp_steps=int(sorted_w.sum()), sorted_warps_at_budget=int((sorted_w >= s["adaptive_budget"]).sum()),
                sorted_ms=times["global_sorted_device"], full_ms=times["global_long_device"])
    phase_line(f"phase 11 times (median ms): #5 global T={ts_full.shape[0]} {times['global_long']:.3f} "
               f"(device {times['global_long_device']:.4f}), T={t_short} {times['global_short']:.3f}; #4 "
               f"per-interval T={t_short} {times['interval_short']:.3f} (device "
               f"{times['interval_short_device']:.4f}); #3 trajectory T={ts_full.shape[0]} "
               f"{times['rollout']:.3f}; #5 rate {rate:.4e} node-evals/s")
    phase_line(f"phase 11 what sets #5's time (device ms): all {p} candidates {what['full_ms']:.4f} "
               f"({what['warps']} warps, {what['warp_steps']} warp-steps, slowest {what['warp_steps_max']}); "
               f"the first {p // 8} {what['part_ms']:.4f} ({what['part_warps']} warps, "
               f"{what['part_warp_steps']} warp-steps, slowest {what['part_warp_steps_max']}); sorted by "
               f"their slowest lane {what['sorted_ms']:.4f} ({what['sorted_warp_steps']} warp-steps, "
               f"{what['sorted_warps_at_budget']} warps at the budget)")
    return {"adaptive_times_ms": dict(times, global_node_evals_per_s=rate, what_sets_5=what)}


# ----------------------------------------------------------- control path

POLICY_OPERATORS = [("+", 2), ("-", 2), ("*", 2), ("sin", 1), ("cos", 1)]
TRIG_OPERATORS = OPERATORS + [("sin", 1, 0.3), ("cos", 1, 0.3)]
# float32 operations of one Acrobot drift, counted by hand from the drift's
# expression (sin, cos and a remainder each counted as one) with its wrapped
# observation: a lower bound of the plant's work
ACROBOT_DRIFT_OPS = 80
# per attempted Dormand-Prince step and lane besides the drifts, per state
# component, and per fixed RK4 substep (stage inputs, sums, update, liveness)
RK4_OPS_PER_DIM = 18


def policy_setup(device, s) -> dict:
    """The control path's configuration at full width: Acrobot, 16
    trajectories on ``arange(0, 50, 0.2)``, 8 x 512 candidates of one tree
    (static) or 2 + 1 trees (dynamic, ``state_size=2``), ``max_nodes=30``,
    operators + - * sin cos (the JAX package's ``policy`` workload)."""
    import torch

    from multitreegp_tpu_torch.core.registry import build_function_set
    from multitreegp_tpu_torch.models.environments import Acrobot
    from multitreegp_tpu_torch.models.evaluators import generate_control_data
    from multitreegp_tpu_torch.ops.initialization import make_population_sampler

    env = Acrobot(0.0, 0.0)
    ys = [f"y{i}" for i in range(env.n_obs)]
    fsets = dict(static=build_function_set(POLICY_OPERATORS, [ys], [env.n_control]),
                 dynamic=build_function_set(POLICY_OPERATORS, [ys + ["a0", "a1", "u0"], ["a0", "a1"]],
                                            [2, env.n_control]))
    g = torch.Generator(device=device).manual_seed(10)
    ts = torch.arange(0.0, s["policy_horizon"], s["dt"], device=device)
    data = generate_control_data(env, g, ts, batch_size=s["batch"])
    total = s["islands"] * s["pop"]
    trees = {k: make_population_sampler(f, s["depth"], s["policy_nodes"])(g, total)[0]
             for k, f in fsets.items()}
    return dict(env=env, fsets=fsets, data=data, trees=trees, g=g, state_size=dict(static=0, dynamic=2))


def compare_policy(got, ref) -> dict:
    """Per lane: states, controls, alive count (and attempted steps) of a
    policy kernel against its plain version. Raises unless every lane is
    identical (NaN where the other has NaN)."""
    import torch

    same = lambda a, b: ((a == b) | (torch.isnan(a) & torch.isnan(b))).all(-1).all(0)
    lane = same(got[0], ref[0]) & same(got[1], ref[1]) & (got[2].sum(0) == ref[2].sum(0))
    if len(got) > 3:
        lane &= got[3] == ref[3]
    diff = (got[0] - ref[0]).abs()
    fin = torch.isfinite(got[0]) & torch.isfinite(ref[0])
    r = dict(identical=float(lane.float().mean()),
             max_abs_err=float(diff[fin].max()) if bool(fin.any()) else 0.0,
             alive=float(got[2][-1].float().mean()), lanes=lane.numel())
    check(r["identical"] == 1.0, f"only {r['identical']:.6f} of lanes identical")
    return r


def policy_pair(device, kind, trees, data, env, fset, state_size, t_steps, substeps=4,
                method="rk4", rows=None):
    """Kernel #6 or #7 and its plain version on the first ``t_steps`` save
    points; returns the comparison and the plain version's ms."""
    from multitreegp_tpu_torch.core import cuda_policy as cp

    x0, ts, tgt, _, _, par = data
    ts = ts[:t_steps]
    par = tuple(p[:, :t_steps] if p.dim() == 2 else p for p in par)
    on_card = device.type == "cuda"
    if kind == "fixed":
        args = (trees, x0, ts, tgt, par, env, fset, substeps, method, state_size)
        kernel, plain = (cp.policy_rollout_cuda if on_card else cp.policy_rollout_plain), cp.policy_rollout_plain
        kw = rows or {}
    else:
        args = (trees, x0, ts, tgt, par, env, fset, 1e-4, 1e-4, 8, "dopri5", 0.9, state_size)
        kernel = cp.policy_rollout_adaptive_cuda if on_card else cp.policy_rollout_adaptive_plain
        plain, kw = cp.policy_rollout_adaptive_plain, {}
    got = kernel(*args, **kw)
    ref, plain_ms = timed_plain(lambda: plain(*args, **kw), device)
    res = compare_policy(got, ref)
    if kind == "adaptive":
        st = got[3].float()
        res.update(steps_min=int(st.min()), steps_median=float(st.median()), steps_max=int(st.max()))
    res.update(plain_ms=plain_ms, t_steps=t_steps)
    return res


def policy_kernels_phase(device, s, ps, trees_sr, fset_sr, x0s, ts_sr, ys_sr) -> dict:
    """Phase 12: kernels #6 and #7 against their plain versions on the card,
    at the path's full width with the horizon cut (the plain versions launch
    thousands of kernels per interval); the other plants, series parameters
    and noise rows at 512 x 16; and the sin/cos repair of #1, #5, #8/#9 and
    #2 with the policy function sets."""
    import torch

    from multitreegp_tpu_torch.core import cuda_adaptive as ca
    from multitreegp_tpu_torch.core import cuda_rollout as cf
    from multitreegp_tpu_torch.core.interpreter import (
        evaluate_trees, evaluate_trees_plain, evaluate_trees_vjp_plain,
    )
    from multitreegp_tpu_torch.core.registry import build_function_set
    from multitreegp_tpu_torch.models import environments as envs
    from multitreegp_tpu_torch.models.evaluators import generate_control_data
    from multitreegp_tpu_torch.ops.initialization import make_population_sampler

    res = {}
    env, data = ps["env"], ps["data"]
    for name in ("static", "dynamic"):
        for kind, t_steps in (("fixed", s["policy_fixed_t"]), ("adaptive", s["policy_adaptive_t"])):
            r = policy_pair(device, kind, ps["trees"][name], data, env, ps["fsets"][name],
                            ps["state_size"][name], t_steps, s["policy_substeps"])
            res[f"{kind}_{name}"] = r
            phase_line(f"phase 12 {'#6' if kind == 'fixed' else '#7'} {name} vs plain, Acrobot, "
                       f"{r['lanes']} lanes, T={t_steps}: identical {r['identical']:.6f} (states, "
                       f"controls, alive count{', steps' if kind == 'adaptive' else ''}), max abs "
                       f"{r['max_abs_err']:.3e}; alive {r['alive']:.4f}; plain {r['plain_ms']:.1f} ms"
                       + (f"; steps per lane min {r['steps_min']} median {r['steps_median']:.0f} "
                          f"max {r['steps_max']}" if kind == "adaptive" else ""))

    # the other plants and legs, 512 x 16 candidates x trajectories
    g = torch.Generator(device=device).manual_seed(11)
    legs = [("HarmonicOscillator", "Constant", None), ("HarmonicOscillator", "Switch", None),
            ("HarmonicOscillator", "Decay", None), ("ChangingHarmonicOscillator", "Switch", None),
            ("ChangingHarmonicOscillator", "Decay", None), ("HarmonicOscillator2", "Constant", None),
            ("CartPole", "Constant", None), ("Acrobot2", "Different", None),
            ("StirredTankReactor", "Different", None), ("HarmonicOscillator", "Constant", "obs"),
            ("Acrobot", "Constant", "obs+kicks")]
    t_steps, sub = s["legs_t"], 2
    ts = torch.arange(t_steps, dtype=torch.float32, device=device) * s["dt"]
    leg_res = []
    for name, mode, noise in legs:
        e = getattr(envs, name)()
        ys = [f"y{i}" for i in range(e.n_obs)] + [f"tgt{i}" for i in range(e.n_targets)]
        fset = build_function_set(POLICY_OPERATORS, [ys], [e.n_control])
        d = generate_control_data(e, g, ts, batch_size=s["batch"], param_mode=mode)
        tr = make_population_sampler(fset, s["depth"], s["policy_nodes"])(g, s["legs_pop"])[0]
        method, rows = "rk4", None
        if noise:
            method = "euler" if "kicks" in noise else "rk4"
            stages = 1 if method == "euler" else 4
            rows = dict(obs_noise_rows=0.05 * torch.randn(
                (t_steps, s["batch"], sub * stages * e.n_obs), generator=g, device=device))
            if "kicks" in noise:
                rows["process_noise_rows"] = 0.02 * torch.randn(
                    (t_steps, s["batch"], sub * e.latent_size), generator=g, device=device)
        kinds = ["fixed"] + (["adaptive"] if mode in ("Constant", "Different") and not noise else [])
        for kind in kinds:
            r = policy_pair(device, kind, tr, d, e, fset, 0, t_steps, sub, method, rows)
            r.update(env=name, mode=mode, noise=noise, kind=kind)
            leg_res.append(r)
            phase_line(f"phase 12 {'#6' if kind == 'fixed' else '#7'} leg {name} {mode}"
                       f"{' ' + noise if noise else ''} ({method if kind == 'fixed' else 'dopri5'}), "
                       f"{r['lanes']} lanes, T={t_steps}: identical {r['identical']:.6f}; alive "
                       f"{r['alive']:.4f}")
    res["legs"] = leg_res

    # the sin/cos repair: #1, #5 and #8/#9 with + - * / sin cos, #2 with the
    # policy function sets (1 and 3 trees per candidate)
    trig = build_function_set(TRIG_OPERATORS, [["x0", "x1"]], [2])
    tt = make_population_sampler(trig, s["depth"], s["max_nodes"])(g, trees_sr.ops.shape[0])[0]
    unary = int(((tt.ops == trig.string_to_op["sin"]) | (tt.ops == trig.string_to_op["cos"])).sum())
    on_card = device.type == "cuda"
    fit_args = (tt, x0s, ts_sr, ys_sr, trig, "rk4", 1)
    mse, alive = (cf.sr_fitness_cuda if on_card else cf.sr_fitness_plain)(*fit_args)
    ref, ref_alive = cf.sr_fitness_plain(*fit_args)
    both = alive & ref_alive
    rel1 = float(((mse - ref).abs() / ref.abs().clamp(min=1e-30))[both].max())
    agree1 = float((alive == ref_alive).float().mean())
    eq1 = float(((mse == ref) & (alive == ref_alive)).float().mean())
    check(agree1 >= 0.999 and eq1 >= 0.999, f"#1 sin/cos: alive agreement {agree1}, identical {eq1}")
    t5 = s["trig_adaptive_t"]
    a_args = (tt, x0s, ts_sr[:t5], ys_sr[:, :t5].contiguous(), trig, 1e-4, 1e-6,
              s["deep_adaptive_budget"], "dopri5", 0.9)
    got5 = (ca.sr_fitness_adaptive_global_cuda if on_card else ca.sr_fitness_adaptive_global_plain)(*a_args)
    same5, _, _, rel5, _ = compare_adaptive(got5, ca.sr_fitness_adaptive_global_plain(*a_args))
    check(same5 == 1.0, f"#5 sin/cos: {same5} of lanes identical")
    k, b = min(s["top_k"], tt.ops.shape[0]), s["batch"]
    full = tt[:k].map(lambda a: a[:, None].expand((k, b) + a.shape[1:]).contiguous())
    states = torch.randn((k, b, 2, 2), generator=g, device=device) * 2
    cot = torch.randn((k, b, 2), generator=g, device=device)
    const = full.const.clone().requires_grad_(True)
    xg = states.clone().requires_grad_(True)
    out8 = evaluate_trees(full._replace(const=const), xg, trig)
    dconst, ddata = torch.autograd.grad(out8, (const, xg), cot)
    sb = lambda a, r: bool(torch.equal(torch.isnan(a), torch.isnan(r)) and torch.equal(a[~torch.isnan(r)], r[~torch.isnan(r)]))
    ref_c, ref_d = evaluate_trees_vjp_plain(full, states, cot, trig)
    eq8 = sb(out8.detach(), evaluate_trees_plain(full, states, trig))
    eq9 = sb(dconst, ref_c) and sb(ddata, ref_d)
    check(eq8 and eq9, f"#8/#9 sin/cos: forward bit-equal {eq8}, VJP bit-equal {eq9}")
    reps = {}
    for name in ("static", "dynamic"):
        rep = reproduction_case(device, s, ps["trees"][name], ps["fsets"][name], g)
        reps[name] = dict(lanes=rep["lanes"], ops_identical=rep["ops_identical"],
                          max_rel=rep["max_rel"], bit_equal=rep["bit_equal"])
    res["trig"] = dict(unary_rows=unary, fitness=dict(alive_agreement=agree1, identical=eq1, max_rel=rel1),
                       adaptive_global=dict(identical=same5, max_rel=rel5),
                       interpreter=dict(fwd_bit_equal=eq8, vjp_bit_equal=eq9, lanes=k * b * 2),
                       reproduce=reps)
    phase_line(f"phase 12 sin/cos repair ({unary} sin/cos rows in {tt.ops.shape[0]} candidates): "
               f"#1 rk4 T={ts_sr.shape[0]} identical {eq1:.6f} (alive agreement {agree1:.6f}, max rel "
               f"{rel1:.3e}); #5 dopri5 T={t5} identical {same5:.6f}; #8 forward bit-equal {eq8}, "
               f"#9 VJP bit-equal {eq9} ({k * b * 2} lanes); #2 with the policy sets: "
               + "; ".join(f"{k_} {v['lanes']} lanes ops identical {v['ops_identical']:.6f} "
                           f"bit-equal {v['bit_equal']}" for k_, v in reps.items()))
    return {"policy_kernels": res}


def policy_fixed_ops(trees, fset, state_size, d_aug, count, t_steps, substeps, env_ops) -> float:
    """float32 operations of a #6 run from its alive counts ``(P, B)``: per
    substep four drifts (one operation per operator row of every tree, the
    plant's ``env_ops``) and the RK4 arithmetic; a lane steps until the
    interval it dies in; and the controls at every save point."""
    rows = ((trees.ops >= 2) & (trees.ops < fset.var_start))
    drift_rows = rows.sum(dim=(1, 2))[:, None]  # (P, 1)
    readout_rows = rows[:, state_size:].sum(dim=(1, 2))[:, None]
    steps = substeps * count.clamp(max=t_steps - 1)
    per_step = 4 * (drift_rows + env_ops) + RK4_OPS_PER_DIM * d_aug
    return float((steps * per_step + t_steps * readout_rows).sum())


def policy_adaptive_ops(trees, fset, state_size, d_aug, steps, t_steps, env_ops) -> float:
    """float32 operations of a #7 run from its attempted steps per lane: six
    drifts and the step's arithmetic per attempt, the up-front drift, and
    the controls at every save point."""
    rows = ((trees.ops >= 2) & (trees.ops < fset.var_start))
    drift_rows = rows.sum(dim=(1, 2))[:, None]
    readout_rows = rows[:, state_size:].sum(dim=(1, 2))[:, None]
    per_step = 6 * (drift_rows + env_ops) + DOPRI5_OPS_PER_DIM * d_aug + CONTROL_OPS
    return float((steps * per_step + drift_rows + env_ops + t_steps * readout_rows).sum())


def policy_bound(kind, out, trees, fset, state_size, data, substeps, env_ops=ACROBOT_DRIFT_OPS):
    """``(bound, operations, bytes)`` of a #6 (``kind`` "fixed") or #7 run
    on data ``data`` that returned ``out``: its inputs read and its outputs
    written once, its operations counted from its alive counts (#6) or
    attempted steps (#7), ``env_ops`` a drift of the plant (Acrobot's by
    default)."""
    x0, ts, tgt, _, _, par = data
    t_steps = ts.shape[0]
    count = out[2].sum(0)
    nb = (nbytes(trees.ops, trees.const, x0, tgt, ts, *par) + nbytes(out[0], out[1])
          + count.numel() * 4 * (2 if kind == "adaptive" else 1))
    d_aug = out[0].shape[-1]
    if kind == "fixed":
        ops = policy_fixed_ops(trees, fset, state_size, d_aug, count, t_steps, substeps, env_ops)
    else:
        ops = policy_adaptive_ops(trees, fset, state_size, d_aug, out[3], t_steps, env_ops)
    return bound(nb, ops), ops, nb


def policy_path_phase(device, s, ps) -> dict:
    """Phase 13: the control paths at full width through the user's entry
    points: 5 generations of the host loop (``evaluate_population`` +
    ``evolve``) with the static (#6), dynamic (#6) and adaptive static (#7)
    evaluators, the launch counters zeroed before each loop and read after;
    then ``evaluate_candidate`` of the best static policy (its replay through
    #8) and one ``optimise`` of the static loop's top candidates through
    ``PolicyRollout`` (#8/#9 in the backward)."""
    import torch

    from multitreegp_tpu_torch import GeneticProgramming
    from multitreegp_tpu_torch.core import cuda_interpreter as ci
    from multitreegp_tpu_torch.core import cuda_policy as cp
    from multitreegp_tpu_torch.core import cuda_reproduction as cr
    from multitreegp_tpu_torch.core.trees import validate_host
    from multitreegp_tpu_torch.models.evaluators import DynamicPolicyEvaluator, StaticPolicyEvaluator
    from multitreegp_tpu_torch.utils.metrics import node_evals_per_evaluation, policy_adaptive_node_evals

    env, data = ps["env"], ps["data"]
    ys = [f"y{i}" for i in range(env.n_obs)]
    t_steps, n, b = data[1].shape[0], s["policy_nodes"], s["batch"]
    total = s["islands"] * s["pop"]
    configs = dict(
        static=(StaticPolicyEvaluator(env, substeps=s["policy_substeps"]), [ys], [1], cp.policy_rollout_cuda),
        dynamic=(DynamicPolicyEvaluator(env, state_size=2, substeps=s["policy_substeps"]),
                 [ys + ["a0", "a1", "u0"], ["a0", "a1"]], [2, 1], cp.policy_rollout_cuda),
        adaptive=(StaticPolicyEvaluator(env, method="adaptive", adaptive_method="dopri5", rtol=1e-4,
                                        atol=1e-4, substeps=s["policy_adaptive_substeps"]),
                  [ys], [1], cp.policy_rollout_adaptive_cuda),
    )
    counters = dict(policy=cp.policy_rollout_cuda, policy_adaptive=cp.policy_rollout_adaptive_cuda,
                    reproduce=cr.reproduce_lanes_cuda, interpret_fwd=ci.evaluate_trees_cuda,
                    interpret_bwd=ci.evaluate_trees_vjp_cuda)
    res = {}
    for name, (ev, layers, sizes, kernel) in configs.items():
        gp = GeneticProgramming(
            num_generations=s["generations"], population_size=s["pop"], fitness_function=ev,
            operator_list=POLICY_OPERATORS, variable_list=layers, layer_sizes=sizes,
            num_populations=s["islands"], max_nodes=n, max_init_depth=s["depth"],
            gradient_steps=s["policy_opt_steps"], coefficient_opt_top_k=s["policy_opt_top_k"],
            device=device)
        for fn in counters.values():
            fn.launches = 0
        gen_g = torch.Generator(device=device).manual_seed(12)
        pops = gp.initialize_population(gen_g)
        best, gens = [], []
        for _ in range(s["generations"]):
            sync(device)
            t0 = time.perf_counter()
            fitness, pops_eval = gp.evaluate_population(pops, data)
            sync(device)
            t1 = time.perf_counter()
            pops = gp.evolve(pops_eval, fitness, gen_g)
            sync(device)
            t2 = time.perf_counter()
            check(bool(torch.isfinite(fitness).all()), f"{name}: non-finite policy fitness")
            check(bool(((fitness >= 0) & (fitness <= 1e4)).all()), f"{name}: fitness outside [0, 1e4]")
            best.append(float(fitness.min()))
            gens.append(dict(eval_ms=(t1 - t0) * 1e3, evolve_ms=(t2 - t1) * 1e3, best=best[-1]))
        check(all(b1 <= b0 for b0, b1 in zip(best, best[1:])), f"{name}: best fitness increased {best}")
        validate_host(pops.map(lambda a: a.reshape(-1, n)), gp.fset.slots(device))
        launches = {k: fn.launches for k, fn in counters.items()}
        kernel_key = "policy_adaptive" if name == "adaptive" else "policy"
        if device.type == "cuda":
            check(launches[kernel_key] >= s["generations"], f"{name}: policy kernel launches {launches}")
            check(launches["reproduce"] >= s["generations"], f"{name}: #2 launches {launches}")
        flat = pops_eval.map(lambda a: a.reshape((-1,) + a.shape[2:]))
        r = dict(generations=gens, best=best, launches=launches, best_string=gp.to_string(
            flat[int(torch.argmin(fitness.reshape(-1)))]))
        if name == "adaptive":
            x0, ts, tgt, _, _, par = data
            steps = cp.rollout_policy_adaptive(flat, x0, ts, tgt, par, env, gp.fset,
                                               rtol=1e-4, atol=1e-4, max_steps=s["policy_adaptive_substeps"],
                                               method="dopri5", return_steps=True)[3]
            st = steps.float()
            evals = policy_adaptive_node_evals(steps, "dopri5", gp.fset.num_trees, n, t_steps)
            r.update(steps_min=int(st.min()), steps_median=float(st.median()), steps_max=int(st.max()),
                     steps_mean=float(st.mean()))
        else:
            evals = node_evals_per_evaluation(total, gp.fset.num_trees, n, b, t_steps,
                                              s["policy_substeps"], "rk4", replay_trees=gp.fset.num_trees)
        r["node_evals"] = evals
        for i, rec in enumerate(gens):
            rec["node_evals_per_s"] = evals / (rec["eval_ms"] / 1e3)
            phase_line(f"phase 13 {name} policy gen {i}: eval {rec['eval_ms']:.3f} ms, evolve "
                       f"{rec['evolve_ms']:.3f} ms, {rec['node_evals_per_s']:.4e} node-evals/s, best "
                       f"fitness {rec['best']:.6g}")
        phase_line(f"phase 13 {name} policy: {s['islands']}x{s['pop']} candidates x {b} trajectories, "
                   f"T={t_steps}; launches {launches}; best {r['best_string']}"
                   + (f"; attempted steps per lane min {r['steps_min']} median {r['steps_median']:.0f} "
                      f"max {r['steps_max']}" if name == "adaptive" else ""))
        res[name] = r
        if name == "static":
            static_gp, static_flat, static_fit = gp, flat, fitness.reshape(-1)

    # evaluate_candidate of the best static policy, and one optimise call
    for fn in counters.values():
        fn.launches = 0
    ev = static_gp.evaluator
    best_cand = static_flat[int(torch.argmin(static_fit))]
    xs_c, ys_c, us_c, cost = ev.evaluate_candidate(best_cand, data)
    check(xs_c.shape == (b, t_steps, 4) and us_c.shape == (b, t_steps, 1), "evaluate_candidate shapes")
    check(bool(((cost >= 0) & (cost <= 1e4)).all()), f"evaluate_candidate cost {cost}")
    top = torch.argsort(static_fit, stable=True)[: s["policy_opt_top_k"]]
    cands = static_flat[top]
    opt_data = (data[0], data[1][: s["policy_opt_t"]]) + data[2:]
    before = ev.evaluate_population(cands, opt_data)
    sync(device)
    t0 = time.perf_counter()
    refined, _ = static_gp.optimise(cands, opt_data)
    sync(device)
    opt_ms = (time.perf_counter() - t0) * 1e3
    launches = {k: fn.launches for k, fn in counters.items()}
    worse = refined > before * (1 + 1e-6)
    check(not bool(worse.any()), f"refinement made {int(worse.sum())} policies worse")
    if device.type == "cuda":
        check(launches["interpret_fwd"] >= 1 and launches["interpret_bwd"] >= 1,
              f"#8/#9 launches in the candidate replay and optimise {launches}")
    res["optimise"] = dict(top_k=int(top.numel()), steps=s["policy_opt_steps"], t_steps=s["policy_opt_t"],
                           ms=opt_ms, unrefined_sum=float(before.sum()), refined_sum=float(refined.sum()),
                           improved=int((refined < before).sum()), launches=launches,
                           candidate_cost=[float(c) for c in cost])
    phase_line(f"phase 13 best static policy evaluate_candidate: per-trajectory cost "
               f"{[round(float(c), 4) for c in cost]}; optimise top-{int(top.numel())} "
               f"({s['policy_opt_steps']} Adam steps, T={s['policy_opt_t']}): {opt_ms:.1f} ms, fitness sum "
               f"{float(before.sum()):.6g} -> {float(refined.sum()):.6g}, {res['optimise']['improved']} "
               f"improved; launches {launches}")
    return {"policy_path": res}


def policy_times(device, s, ps) -> dict:
    """Phase 14: CUDA-event times of #6 (static, dynamic) and #7 (static,
    dynamic) at the path's full shapes (T = 250) and each kernel's device
    time per launch by torch.profiler, with each run's bound counted from
    its own outputs (on CPU tensors: the bounds of the plain versions' runs,
    no times)."""
    import torch

    from multitreegp_tpu_torch.core import cuda_policy as cp

    env, (x0, ts, tgt, _, _, par) = ps["env"], ps["data"]
    t_steps = ts.shape[0]
    res = {}
    for name in ("static", "dynamic"):
        trees, fset, ss = ps["trees"][name], ps["fsets"][name], ps["state_size"][name]
        fns = dict(
            fixed=lambda: cp.rollout_policy(trees, x0, ts, tgt, par, env, fset, s["policy_substeps"],
                                            "rk4", ss),
            adaptive=lambda: cp.rollout_policy_adaptive(
                trees, x0, ts, tgt, par, env, fset, 1e-4, 1e-4, s["policy_adaptive_substeps"], "dopri5",
                0.9, ss, return_steps=True))
        for kind, fn in fns.items():
            ms = device_ms = None
            if device.type == "cuda":
                ms = cuda_time_ms(fn, s["timing_runs"], torch)
                kernel = "policy_kernel" if kind == "fixed" else "policy_adaptive_kernel"
                device_ms = kernel_device_ms([(kind, fn, kernel)], s["timing_runs"], torch)[kind]
            out = fn()
            count = out[2].sum(0)
            bnd, ops, nb = policy_bound(kind, out, trees, fset, ss, ps["data"], s["policy_substeps"])
            r = res[f"{kind}_{name}"] = dict(ms=ms, device_ms=device_ms, bound_ms=bnd[0], bound_by=bnd[1],
                                             ops=ops, bytes=nb, alive=float(out[2][-1].float().mean()))
            if kind == "adaptive":
                st = out[3].float()
                r.update(steps_min=int(st.min()), steps_median=float(st.median()), steps_max=int(st.max()))
            if ms is not None:
                phase_line(f"phase 14 {'#6' if kind == 'fixed' else '#7'} {name} T={t_steps}, "
                           f"{count.numel()} lanes: {ms:.3f} ms (median of {s['timing_runs']}; device "
                           f"{device_ms:.4f} ms a launch), alive {r['alive']:.4f}"
                           + (f", attempted steps per lane min {r['steps_min']} median "
                              f"{r['steps_median']:.0f} max {r['steps_max']}" if kind == "adaptive" else "")
                           + f"; bound {bnd[0]:.4f} ms by {bnd[1]} ({ops:.4e} operations, "
                           f"{nb / 1e6:.1f} MB)")
    return {"policy_times_ms": res}


# ------------------------------------------------------------ noise and SDE


def ulp_gap(a, b) -> int:
    """The largest distance in units in the last place between two float32
    tensors of one shape (their bits mapped to ordered integers)."""
    import torch

    key = lambda v: (lambda i: torch.where(i < 0, -(i & 0x7FFFFFFF), i))(
        v.contiguous().view(torch.int32).long())
    return int((key(a) - key(b.to(a.device))).abs().max()) if a.numel() else 0


def host_loop(gp, data, s, device, counters, name) -> dict:
    """Phase 15's ``s["generations"]`` generations of the host loop
    (:func:`loop_generations`, the counters zeroed before and read after)."""
    r = loop_generations(gp, data, device, s["generations"], 21, counters)
    for i, rec in enumerate(r["generations"]):
        phase_line(f"phase 15 {name} gen {i}: eval {rec['eval_ms']:.3f} ms, evolve {rec['evolve_ms']:.3f} "
                   f"ms, best fitness {rec['best']:.6g}")
    phase_line(f"phase 15 {name}: {s['islands']}x{s['pop']} candidates; launches {r['launches']}")
    return dict(generations=r["generations"], best=r["best"], launches=r["launches"])


def sde_phase(device, s, ps, trees, fset, ts_sr) -> dict:
    """Phase 15: the noise streams, kernel #1's Euler-Maruyama leg and the
    noisy and stochastic paths (see the module docstring)."""
    import torch

    from multitreegp_tpu_torch import GeneticProgramming
    from multitreegp_tpu_torch.core import cuda_interpreter as ci
    from multitreegp_tpu_torch.core import cuda_policy as cp
    from multitreegp_tpu_torch.core import cuda_reproduction as cr
    from multitreegp_tpu_torch.core import cuda_rollout as cf
    from multitreegp_tpu_torch.core import prng
    from multitreegp_tpu_torch.core.cuda_policy import stage_times
    from multitreegp_tpu_torch.models.environments import Acrobot, VanDerPolOscillator
    from multitreegp_tpu_torch.models.evaluators import (
        DynamicPolicyEvaluator, SREvaluator, StaticPolicyEvaluator, generate_sr_data,
    )
    from multitreegp_tpu_torch.models.evaluators.noise import (
        make_obs_noise_rows, make_process_noise_rows, make_sr_kick_rows,
    )

    on_card = device.type == "cuda"
    pn, sub, b = s["noise"], s["policy_substeps"], s["batch"]
    res = {}
    g = torch.Generator(device=device).manual_seed(20)
    x0s, ts, ys, keys = generate_sr_data(VanDerPolOscillator(pn), g, ts_sr, batch_size=b, substeps=8)
    noisy = Acrobot(obs_noise=pn, process_noise=pn)
    pdata = ps["data"]
    cpu = lambda t: t.cpu() if torch.is_tensor(t) else tuple(cpu(v) for v in t)

    # the rows on the card against the same rows on the CPU
    def build(d, k, t):
        return dict(obs=make_obs_noise_rows(noisy, d[1], d[5], d[4], sub, "rk4"),
                    kicks=make_process_noise_rows(noisy, d[1], d[5], d[3], sub, noisy.latent_size),
                    sr_kicks=make_sr_kick_rows(pn, t, k, sub, 2))

    rows, build_ms = timed_plain(lambda: build(pdata, keys, ts), device)
    rows_cpu = build(cpu(pdata), keys.cpu(), ts.cpu())
    taus = stage_times(pdata[1], sub, "rk4")
    bits = lambda k, t: prng.random_bits(prng.fold_in(k, prng.bitcast_time(t[..., None])), 4)
    bits_equal = bool(torch.equal(bits(pdata[4], taus).cpu(), bits(pdata[4].cpu(), taus.cpu())))
    gaps = {k: ulp_gap(v, rows_cpu[k]) for k, v in rows.items()}
    check(bits_equal, "the generator's bits differ between the card and the CPU")
    check(max(gaps.values()) <= 8, f"rows on the card and the CPU {gaps} ulp apart")
    res["rows"] = dict(bits_equal=bits_equal, ulp_gap=gaps, build_ms=build_ms,
                       shapes={k: list(v.shape) for k, v in rows.items()})
    phase_line(f"phase 15 noise rows, card vs CPU: generator bits equal {bits_equal}; largest ulp gap "
               f"{gaps}; shapes {res['rows']['shapes']}; built on the card in {build_ms:.1f} ms (obs "
               f"rows T={pdata[1].shape[0]} rk4 x {sub}, kick rows, SR kick rows T={ts.shape[0]})")

    # #1 with kick rows against its plain version, every lane of phase 2
    kicks = rows["sr_kicks"]
    args = (trees, x0s, ts, ys, fset, "euler", sub, kicks)
    mse, alive = (cf.sr_fitness_cuda if on_card else cf.sr_fitness_plain)(*args)
    (ref, ref_alive), plain_ms = timed_plain(lambda: cf.sr_fitness_plain(*args), device)
    identical = float(lanes_identical(mse, alive, ref, ref_alive).float().mean())
    fin = torch.isfinite(mse) & torch.isfinite(ref)
    k_err = float((mse - ref).abs()[fin].max())
    check(identical == 1.0, f"#1 with kicks: {identical:.6f} of lanes identical")
    no_kicks = lambda: cf.sr_fitness(trees, x0s, ts, ys, fset, "euler", sub)
    with_kicks = lambda: cf.sr_fitness(trees, x0s, ts, ys, fset, "euler", sub, kicks)
    times = {}
    if on_card:  # in turns: without, with, with, without
        for key, fn in (("euler_no_kicks", no_kicks), ("euler_kicks", with_kicks),
                        ("euler_kicks_2", with_kicks), ("euler_no_kicks_2", no_kicks)):
            times[key] = cuda_time_ms(fn, s["ab_runs"], torch)
    rows_p = ((trees.ops >= 2) & (trees.ops < fset.var_start)).sum(dim=(1, 2))[:, None]
    steps = torch.where(alive, ts.shape[0] - 1, 1) * sub
    d = x0s.shape[1]
    # per euler substep: the drift's operator rows, the update 2d, the kick
    # d, the liveness 2d; the squared error 3d per save point
    k_ops = float((steps * (rows_p + 5 * d)).sum()) + 3 * d * ts.shape[0] * alive.numel()
    k_bytes = nbytes(trees.ops, trees.const, x0s, ts, ys, kicks) + alive.numel() * 5
    kb = bound(k_bytes, k_ops)
    res["fitness_kicks"] = dict(identical=identical, max_abs_err=k_err, plain_ms=plain_ms,
                                lanes=alive.numel(), alive=float(alive.float().mean()), substeps=sub,
                                t_steps=ts.shape[0], bound_ms=kb[0], bound_by=kb[1], **times)
    phase_line(f"phase 15 #1 with kick rows vs plain, euler x {sub}, T={ts.shape[0]}, {alive.numel()} "
               f"lanes: identical {identical:.6f}, max abs {k_err:.3e}; alive "
               f"{res['fitness_kicks']['alive']:.4f}; plain {plain_ms:.1f} ms; kernel (median ms, in "
               f"turns) " + ", ".join(f"{k} {v:.4f}" for k, v in times.items())
               + f"; bound {kb[0]:.5f} ms by {kb[1]}")

    # the SDE SR host loop at full width
    sr_counters = dict(sr_fitness=cf.sr_fitness_cuda, reproduce=cr.reproduce_lanes_cuda,
                       interpret_fwd=ci.evaluate_trees_cuda)
    gp = GeneticProgramming(
        num_generations=s["generations"], population_size=s["pop"],
        fitness_function=SREvaluator(substeps=sub, process_noise=pn), operator_list=OPERATORS,
        variable_list=[["x0", "x1"]], layer_sizes=[2], num_populations=s["islands"],
        max_nodes=s["max_nodes"], max_init_depth=s["depth"], device=device)
    res["sr_loop"] = host_loop(gp, (x0s, ts, ys, keys), s, device, sr_counters, "SDE SR loop")
    if on_card:
        lc = res["sr_loop"]["launches"]
        check(lc["sr_fitness"] >= s["generations"] and lc["reproduce"] >= s["generations"],
              f"SDE SR loop launches {lc}")
        res["fitness_kicks"]["launches"] = lc["sr_fitness"]

    # the noisy and stochastic control loops at full width, T = 250
    ys_obs = [f"y{i}" for i in range(noisy.n_obs)]
    pcounters = dict(policy=cp.policy_rollout_cuda, policy_adaptive=cp.policy_rollout_adaptive_cuda,
                     reproduce=cr.reproduce_lanes_cuda)
    loops = dict(
        static=(StaticPolicyEvaluator(noisy, substeps=sub, stochastic=True), [ys_obs], [1]),
        dynamic=(DynamicPolicyEvaluator(noisy, state_size=2, substeps=sub, stochastic=True),
                 [ys_obs + ["a0", "a1", "u0"], ["a0", "a1"]], [2, 1]))
    for name, (ev, layers, sizes) in loops.items():
        gp = GeneticProgramming(
            num_generations=s["generations"], population_size=s["pop"], fitness_function=ev,
            operator_list=POLICY_OPERATORS, variable_list=layers, layer_sizes=sizes,
            num_populations=s["islands"], max_nodes=s["policy_nodes"], max_init_depth=s["depth"],
            device=device)
        r = host_loop(gp, pdata, s, device, pcounters, f"noisy {name} policy loop")
        if on_card:
            check(r["launches"]["policy"] >= s["generations"] and r["launches"]["policy_adaptive"] == 0,
                  f"noisy {name} loop launches {r['launches']}")
        res[f"{name}_loop"] = r

    # one noisy adaptive evaluation: the general path, at a cut horizon
    t_cut = s["noisy_adaptive_t"]
    cut = (pdata[0], pdata[1][:t_cut]) + pdata[2:]
    ev = StaticPolicyEvaluator(Acrobot(obs_noise=pn), ps["fsets"]["static"], method="adaptive",
                               adaptive_method="dopri5", substeps=s["policy_adaptive_substeps"])
    for fn in (*pcounters.values(), ci.evaluate_trees_cuda):
        fn.launches = 0
    fit, ad_ms = timed_plain(lambda: ev.evaluate_population(ps["trees"]["static"], cut), device)
    ad_launches = dict(policy_adaptive=cp.policy_rollout_adaptive_cuda.launches,
                       interpret_fwd=ci.evaluate_trees_cuda.launches)
    check(bool(torch.isfinite(fit).all()) and bool(((fit >= 0) & (fit <= 1e4)).all()),
          "noisy adaptive fitness")
    if on_card:
        check(ad_launches["policy_adaptive"] == 0 and ad_launches["interpret_fwd"] > 0,
              f"noisy adaptive launches {ad_launches}")
    res["noisy_adaptive"] = dict(t_steps=t_cut, ms=ad_ms, launches=ad_launches, best=float(fit.min()),
                                 lanes=fit.numel() * b)
    phase_line(f"phase 15 noisy adaptive static evaluation (general path, dopri5, T={t_cut}): "
               f"{ad_ms:.1f} ms, launches {ad_launches}, best fitness {float(fit.min()):.6g}")

    # #6 with and without the rows at T = 250 (static), and the rows' build
    x0, pts, tgt, pk, ok, par = pdata
    trees_p, fset_p = ps["trees"]["static"], ps["fsets"]["static"]
    obs_rows = rows["obs"]
    kick_rows = make_process_noise_rows(noisy, pts, par, pk, sub, noisy.latent_size)
    obs_euler = make_obs_noise_rows(noisy, pts, par, ok, sub, "euler")
    # #6 against its plain version on these rows, every lane, at phase 12's
    # cut horizon: the RK4 observation rows and the Euler observation + kick
    # rows of the stochastic loops
    t6, vs_plain = s["policy_fixed_t"], {}
    for key, method, rws in (("rk4_obs_rows", "rk4", dict(obs_noise_rows=obs_rows)),
                             ("euler_obs_kick_rows", "euler",
                              dict(obs_noise_rows=obs_euler, process_noise_rows=kick_rows))):
        r = policy_pair(device, "fixed", trees_p, pdata, noisy, fset_p, 0, t6, sub, method,
                        {k: v[:t6] for k, v in rws.items()})
        vs_plain[key] = r
        phase_line(f"phase 15 #6 with the port's {key.replace('_', ' ')} vs plain, static Acrobot, "
                   f"{r['lanes']} lanes, T={t6}: identical {r['identical']:.6f} (states, controls, "
                   f"alive count), max abs {r['max_abs_err']:.3e}; alive {r['alive']:.4f}; plain "
                   f"{r['plain_ms']:.1f} ms")
    pol = lambda method, o=None, k=None: lambda: cp.rollout_policy(
        trees_p, x0, pts, tgt, par, noisy, fset_p, sub, method, 0, o, k)
    ptimes = {}
    if on_card:
        for key, fn in (("rk4", pol("rk4")), ("rk4_obs_rows", pol("rk4", obs_rows)),
                        ("euler", pol("euler")), ("euler_obs_kick_rows", pol("euler", obs_euler, kick_rows))):
            ptimes[key] = cuda_time_ms(fn, s["timing_runs"], torch)
        _, ptimes["build_obs_rows_ms"] = timed_plain(
            lambda: make_obs_noise_rows(noisy, pts, par, ok, sub, "rk4"), device)
    out6 = pol("rk4", obs_rows)()
    count = out6[2].sum(0)
    ops6 = policy_fixed_ops(trees_p, fset_p, 0, 4, count, pts.shape[0], sub, ACROBOT_DRIFT_OPS)
    b6 = bound(nbytes(trees_p.ops, trees_p.const, x0, tgt, pts, *par, obs_rows, out6[0], out6[1])
               + count.numel() * 4, ops6)
    res["policy_noise"] = dict(launches=res["static_loop"]["launches"]["policy"]
                               + res["dynamic_loop"]["launches"]["policy"],
                               bound_ms_obs_rows=b6[0], bound_by_obs_rows=b6[1], vs_plain=vs_plain,
                               max_abs_err=max(r["max_abs_err"] for r in vs_plain.values()), **ptimes)
    phase_line(f"phase 15 #6 static Acrobot T={pts.shape[0]}, {count.numel()} lanes (median ms): "
               + ", ".join(f"{k} {v:.3f}" for k, v in ptimes.items())
               + f"; bound with obs rows {b6[0]:.4f} ms by {b6[1]}")
    return {"sde": res}


def probe_phase(device, s) -> dict:
    """Phase 16: the branch probe (#10) in every mode against its plain
    version, then the tool's own timing run with the launch counter zeroed
    before it and read after; each mode's bound from the iterations its
    elements run."""
    import torch

    from multitreegp_tpu_torch.tools import branch_probe as bp

    on_card = device.type == "cuda"
    modes, err = {}, 0.0
    for mode in bp.MODES:
        x = bp.probe_input(mode, s["probe_reps"], device)
        got = bp.probe_cuda(x, mode) if on_card else bp.probe_plain(x, mode)
        ref, plain_ms = timed_plain(lambda: bp.probe_plain(x, mode), device)
        check(bool(torch.equal(got, ref)), f"probe {mode}: kernel and plain version differ")
        err = max(err, float((got - ref).abs().max()))
        # the body's multiply and add under -fmad=false: the non-FMA rate
        bnd = bound(2 * nbytes(x), bp.operations(x, mode), PEAK_F32_NOFMA_PER_S)
        modes[mode] = dict(plain_ms=plain_ms, bound_ms=bnd[0], bound_by=bnd[1], ops=bp.operations(x, mode),
                           iterations_mean=float(bp.element_iterations(x, mode).float().mean()))
    bp.probe_cuda.launches = 0
    timed = bp.measure() if on_card else {}
    launches = bp.probe_cuda.launches
    if on_card:
        check(launches >= len(bp.MODES), f"probe launches {launches}")
        inputs = {mode: bp.probe_input(mode, s["probe_reps"], device) for mode in bp.MODES}
        device_ms = kernel_device_ms([(mode, lambda m=mode: bp.probe_cuda(inputs[m], m), "probe_kernel")
                                      for mode in bp.MODES], s["timing_runs"], torch)
        for mode, r in timed.items():
            r.update(device_ms=device_ms[mode], device_ratio=device_ms[mode] / device_ms["always"])
    # what a launch costs besides its iterations: every mode on tiles past the
    # threshold from the start (one round's work, then the flag is down)
    early = bp.early_input(s["probe_reps"], device)
    early_ms = {}
    for mode in bp.MODES:
        got = bp.probe_cuda(early, mode) if on_card else bp.probe_plain(early, mode)
        check(bool(torch.equal(got, bp.probe_plain(early, mode))), f"probe {mode} early: kernel and plain differ")
    if on_card:
        early_ms = kernel_device_ms([(mode, lambda m=mode: bp.probe_cuda(early, m), "probe_kernel")
                                     for mode in ("when", "dynfori", "dynval")], s["timing_runs"], torch)
    for mode, r in modes.items():
        r.update(timed.get(mode, dict(ms=None)))
        phase_line(f"phase 16 probe {mode}: identical to plain; "
                   + (f"{r['ms']:.4f} ms ({r['ratio']:.3f}x of always, ideal {r['ideal_ratio']:.3f}x), "
                      f"device {r['device_ms']:.4f} ms ({r['device_ratio']:.3f}x); "
                      if r["ms"] is not None else "")
                   + f"bound {r['bound_ms']:.5f} ms by {r['bound_by']} ({r['ops']:.4e} operations at "
                   f"{PEAK_F32_NOFMA_PER_S:.3e}/s, "
                   f"{r['iterations_mean']:.2f} iterations per element); plain {r['plain_ms']:.1f} ms")
    phase_line(f"phase 16 probe: {s['probe_reps']} tiles of 8x128, TOTAL {bp.TOTAL}, FLIP {bp.FLIP}, CH {bp.CH}; "
               f"launches in the timing run {launches}; on tiles past the threshold (identical to plain), "
               f"device ms: " + (", ".join(f"{m} {v:.4f}" for m, v in early_ms.items()) or "not measured")
               + " (when: one iteration; dynfori, dynval: one chunk, then the rounds' reductions)")
    return {"probe": dict(modes=modes, launches=launches, max_abs_err=err, early_device_ms=early_ms)}


def stack_pointers(ops, slots):
    """``(c1, c2)`` of one tree's opcodes (a list) by a postorder stack, in
    O(N) (``rebuild_pointers`` holds an N x N table per tree)."""
    c1, c2, stack = [-1] * len(ops), [-1] * len(ops), []
    for i, op in enumerate(ops):
        if op == 0:  # EMPTY
            continue
        arity = slots[op] if op < len(slots) else 0
        for _ in range(arity):
            below = stack.pop()
        if arity:
            c1[i] = i - 1
        if arity == 2:
            c2[i] = below
        stack.append(i)
    return c1, c2


def chain_trees(trees, fset, lengths, zigzag=()):
    """``trees (P, m, n)`` with candidate i's trees replaced by a chain of
    ``lengths[i]`` rows: k + 1 leaves then k operators ``+``/``-``, whose
    stack holds k + 1 values, the most a tree of that many rows can; a
    candidate in ``zigzag`` gets ``op_k(op_k-1(...), leaf_k)`` instead, each
    operator's second operand the operator two rows below it (second
    operands up to row n - 3)."""
    import torch

    from multitreegp_tpu_torch.core.trees import CONST, EMPTY, OP_START, TreeTensors

    n = trees.max_nodes
    ops, c1, c2 = (t.clone() for t in (trees.ops, trees.c1, trees.c2))
    slots = fset.slots().tolist()
    for i, rows in enumerate(lengths):
        k = (rows - 1) // 2
        leaves = [fset.var_start + j % 2 if j % 3 else CONST for j in range(k + 1)]
        opers = [OP_START + j % 2 for j in range(k)]
        body = ([leaves[0]] + [r for j in range(k) for r in (leaves[j + 1], opers[j])]
                if i in zigzag else leaves + opers)
        tree = [EMPTY] * (n - 2 * k - 1) + body
        p1, p2 = stack_pointers(tree, slots)
        ops[i] = torch.tensor(tree, dtype=torch.int32)
        c1[i], c2[i] = torch.tensor(p1, dtype=torch.int32), torch.tensor(p2, dtype=torch.int32)
    const = torch.where(ops == CONST, torch.where(trees.ops == CONST, trees.const, 0.5), 0.0)
    return TreeTensors(ops, c1, c2, const)


def deep_phase(device, s, ps) -> dict:
    """Phase 17: the instances of #1-#9 for trees of up to 256
    rows against their plain versions. #1: 256 candidates of 2 trees of 256
    rows grown to depth 7, the first three chains of 255, 127 and 63 rows
    (the deepest stacks), x 16 VdP trajectories at T = 4, RK4 and Euler x 4
    with kick rows; #3 on the same lanes, RK4; #5 (budget 8) and #4 (4 steps per interval), dopri5, on
    the same lanes at T = 3; #2: one island's 462 lanes of those parents, fresh trees
    at depth 7; #6 on 256 dynamic Acrobot policies (RK4 x 2) and #7 on 256
    static ones (dopri5, 8 steps per interval), of 256 rows grown and
    chained the same way, x 16 trajectories at T = 2. Every lane identical
    (#2: its opcodes)."""
    import torch

    from multitreegp_tpu_torch.core import cuda_adaptive as ca
    from multitreegp_tpu_torch.core import cuda_rollout as cf
    from multitreegp_tpu_torch.core.interpreter import evaluate_trees_plain, evaluate_trees_vjp_plain
    from multitreegp_tpu_torch.core.registry import build_function_set
    from multitreegp_tpu_torch.models.environments import VanDerPolOscillator
    from multitreegp_tpu_torch.models.evaluators import generate_sr_data
    from multitreegp_tpu_torch.models.evaluators.noise import make_sr_kick_rows
    from multitreegp_tpu_torch.ops.initialization import make_population_sampler

    on_card = device.type == "cuda"
    n, sub = s["deep_nodes"], s["policy_substeps"]
    fset = build_function_set(OPERATORS, [["x0", "x1"]], [2])
    g = torch.Generator(device=device).manual_seed(30)
    ts = torch.arange(0, s["deep_t"], device=device) * s["dt"]
    x0s, ts, ys, keys = generate_sr_data(VanDerPolOscillator(), g, ts, batch_size=s["batch"])
    grown = make_population_sampler(fset, s["deep_depth"], n)(g, s["deep_pop"])[0]
    trees = chain_trees(grown, fset, [n - 1, min(127, n - 1), min(63, n - 1)])
    kicks = make_sr_kick_rows(s["noise"], ts, keys, sub, 2)
    res = {}
    for key, method, substeps, rows in (("rk4", "rk4", 1, None), ("euler_kicks", "euler", sub, kicks)):
        args = (trees, x0s, ts, ys, fset, method, substeps, rows)
        mse, alive = (cf.sr_fitness_cuda if on_card else cf.sr_fitness_plain)(*args)
        (ref, ref_alive), plain_ms = timed_plain(lambda: cf.sr_fitness_plain(*args), device)
        identical = float(lanes_identical(mse, alive, ref, ref_alive).float().mean())
        check(identical == 1.0, f"deep #1 {key}: {identical:.6f} of lanes identical")
        fin = torch.isfinite(mse) & torch.isfinite(ref)
        res[key] = dict(identical=identical, lanes=alive.numel(), alive=float(alive.float().mean()),
                        max_abs_err=float((mse - ref).abs()[fin].max()), plain_ms=plain_ms)
    sizes = (trees.ops != 0).sum(-1)
    # #3 on the same lanes, RK4 with one substep
    xs, alive_r = (cf.sr_rollout_cuda if on_card else cf.sr_rollout_plain)(trees, x0s, ts, fset, "rk4", 1)
    (ref, ref_alive), plain_ms = timed_plain(lambda: cf.sr_rollout_plain(trees, x0s, ts, fset, "rk4", 1),
                                             device)
    share, max_abs = rollout_identical(xs, alive_r, ref, ref_alive)
    check(share == 1.0, f"deep #3: {share:.6f} of lanes identical")
    rollout = dict(identical=share, lanes=alive_r[-1].numel(), alive=float(alive_r[-1].float().mean()),
                   max_abs_err=max_abs, plain_ms=plain_ms)
    # #5 and #4 on the same candidates, the horizon cut (the plain versions
    # sweep all 256 rows at every stage)
    t_a = s["deep_adaptive_t"]
    adaptive = {}
    for key, kernel, plain, budget in (
            ("global", ca.sr_fitness_adaptive_global_cuda, ca.sr_fitness_adaptive_global_plain,
             s["deep_adaptive_budget"]),
            ("interval", ca.sr_fitness_adaptive_interval_cuda, ca.sr_fitness_adaptive_interval_plain,
             s["deep_interval_steps"])):
        args = (trees, x0s, ts[:t_a], ys[:, :t_a].contiguous(), fset, 1e-4, 1e-6, budget, "dopri5", 0.9)
        got = (kernel if on_card else plain)(*args)
        ref, plain_ms = timed_plain(lambda: plain(*args), device)
        same, _, _, _, max_abs = compare_adaptive(got, ref)
        check(same == 1.0, f"deep #{5 if key == 'global' else 4}: {same:.6f} of lanes identical")
        st = got[2].float()
        adaptive[key] = dict(identical=same, lanes=st.numel(), alive=float(got[1].float().mean()),
                             max_abs_err=max_abs, plain_ms=plain_ms, budget=budget, steps_min=int(st.min()),
                             steps_median=float(st.median()), steps_max=int(st.max()))
    phase_line(f"phase 17 #5/#4 N={n} vs plain, dopri5, {st.numel()} lanes, T={t_a}: "
               + "; ".join(f"{'#5' if k == 'global' else '#4'} budget {v['budget']} identical "
                           f"{v['identical']:.6f}, alive {v['alive']:.4f}, steps per lane min {v['steps_min']} "
                           f"median {v['steps_median']:.0f} max {v['steps_max']}, plain {v['plain_ms']:.1f} ms"
                           for k, v in adaptive.items()))
    phase_line(f"phase 17 #1 N={n} vs plain, {alive.numel()} lanes, T={ts.shape[0]}, tree rows mean "
               f"{float(sizes.float().mean()):.1f} max {int(sizes.max())}: "
               + "; ".join(f"{k} identical {v['identical']:.6f}, alive {v['alive']:.4f}, plain "
                           f"{v['plain_ms']:.1f} ms" for k, v in res.items()))
    phase_line(f"phase 17 #3 N={n} vs plain, rk4, {rollout['lanes']} lanes, T={ts.shape[0]}: identical "
               f"{rollout['identical']:.6f}, alive {rollout['alive']:.4f}, plain {rollout['plain_ms']:.1f} ms")
    # #8 and #9 on the same candidates against 16 states each, in the
    # recompute's layout, every lane (the VJP's per-lane outputs)
    k, b, m = trees.ops.shape[0], s["batch"], trees.ops.shape[1]
    states = torch.randn((k, b, 1, 2), generator=g, device=device) * 2
    cot = torch.randn((k, b, m), generator=g, device=device)
    trees_b = trees.map(lambda a: a[:, None])
    got = grouped_per_lane(trees_b, states, cot, fset)
    full = trees.map(lambda a: a[:, None].expand(k, b, m, n).contiguous())
    x = states.expand(k, b, m, 2).contiguous()
    ref, plain_ms = timed_plain(
        lambda: (evaluate_trees_plain(full, x, fset),) + evaluate_trees_vjp_plain(full, x, cot, fset),
        device)
    same = [bool(same_bits(a, r)) for a, r in zip(got, ref)]
    check(all(same), f"deep #8/#9: bit-equal forward, dconst, ddata {same}")
    fin = torch.isfinite(ref[0])
    interp = dict(lanes=k * b * m, bit_equal=dict(zip(("fwd", "dconst", "ddata"), same)),
                  finite=float(fin.float().mean()), plain_ms=plain_ms,
                  max_abs_err=max(float(torch.where(torch.isfinite(r), (a - r).abs(), 0.0).max())
                                  for a, r in zip(got, ref)))
    phase_line(f"phase 17 #8/#9 N={n} vs plain, {k}x{b}x{m} = {k * b * m} lanes (trees (K, 1, m, N)): "
               f"bit-equal forward, dconst, ddata {same}, finite {interp['finite']:.4f}, plain "
               f"{plain_ms:.1f} ms")
    rep = reproduction_case(device, dict(s, islands=1, pop=s["deep_rep_pop"], depth=s["deep_depth"]),
                            trees, fset, g)
    got = rep.pop("children")
    for key in ("args", "cfg", "u_rows"):
        rep.pop(key)
    kept = (got[0] != 0).sum(0)
    phase_line(f"phase 17 #2 N={n} vs plain: {rep['lanes']} lanes, ops identical on "
               f"{rep['ops_identical']:.6f}, const max rel {rep['max_rel']:.3e}, bit-equal "
               f"{rep['bit_equal']}; child rows mean {float(kept.float().mean()):.1f} max {int(kept.max())}")
    # #6 on dynamic and #7 on static Acrobot policies of 256 rows
    deep_policy = {}
    for name, kind in (("dynamic", "fixed"), ("static", "adaptive")):
        pf = ps["fsets"][name]
        grown = make_population_sampler(pf, s["deep_depth"], n)(g, s["deep_pop"])[0]
        ptrees = chain_trees(grown, pf, [n - 1, min(127, n - 1), min(63, n - 1)])
        r = policy_pair(device, kind, ptrees, ps["data"], ps["env"], pf, ps["state_size"][name],
                        s["deep_policy_t"], substeps=2)
        r["policies"] = name
        deep_policy[f"policy_{kind}"] = r
        phase_line(f"phase 17 {'#6' if kind == 'fixed' else '#7'} N={n} {name} vs plain, Acrobot, "
                   f"{r['lanes']} lanes, T={s['deep_policy_t']}: identical {r['identical']:.6f}; alive "
                   f"{r['alive']:.4f}; plain {r['plain_ms']:.1f} ms"
                   + (f"; steps per lane min {r['steps_min']} median {r['steps_median']:.0f} max "
                      f"{r['steps_max']}" if kind == "adaptive" else ""))
    return {"deep": dict(fitness=res, rollout=rollout, adaptive=adaptive, reproduce=rep,
                         interpreter=interp, **deep_policy)}


def loop_generations(gp, data, device, gens, seed, counters, validate=None) -> dict:
    """``gens`` generations of ``evaluate_population`` + ``evolve`` from a
    fresh population, timed on the host clock around synchronisations, with
    every counter of ``counters`` read around each step; ``validate(pops)``
    checks each generation's children. Checks the fitness and that the best
    never grows. Returns also ``fit()``'s four outputs and the generator's
    final state."""
    import torch

    for fn in counters.values():
        fn.launches = 0
    gen_g = torch.Generator(device=device).manual_seed(seed)
    pops = gp.initialize_population(gen_g)
    best, recs = [], []
    for _ in range(gens):
        before = {k: fn.launches for k, fn in counters.items()}
        sync(device)
        t0 = time.perf_counter()
        fitness, pops = gp.evaluate_population(pops, data)
        sync(device)
        t1 = time.perf_counter()
        mid = {k: fn.launches for k, fn in counters.items()}
        pops = gp.evolve(pops, fitness, gen_g)
        sync(device)
        t2 = time.perf_counter()
        top = gp.evaluator.max_fitness
        check(bool(torch.isfinite(fitness).all()), "non-finite fitness")
        check(bool(((fitness >= 0) & (fitness <= top)).all()), f"fitness outside [0, {top}]")
        if validate is not None:
            validate(pops)
        best.append(float(fitness.min()))
        recs.append(dict(eval_ms=(t1 - t0) * 1e3, evolve_ms=(t2 - t1) * 1e3, best=best[-1],
                         eval_launches={k: mid[k] - before[k] for k in counters},
                         evolve_launches={k: fn.launches - mid[k] for k, fn in counters.items()}))
    check(all(b1 <= b0 for b0, b1 in zip(best, best[1:])), f"best fitness increased: {best}")
    return dict(generations=recs, best=best, pops=pops, fitness=fitness,
                launches={k: fn.launches for k, fn in counters.items()},
                outputs=(gp.best_fitnesses, gp.best_solutions, pops, fitness), state=gen_g.get_state())


def nonfused_phase(device, s, data) -> dict:
    """Phase 18: the reproduction path without the fused kernel
    (``fused_reproduction=False``: the per-tree operators of
    ``ops/reproduction.make_evolve_island``) on phase 4's workload, beside
    the fused path on the same initial population in the same run; every
    generation's children pass ``validate_host``."""
    import torch

    from multitreegp_tpu_torch import GeneticProgramming
    from multitreegp_tpu_torch.core import cuda_reproduction as cr
    from multitreegp_tpu_torch.core import cuda_rollout as cf
    from multitreegp_tpu_torch.core.trees import validate_host
    from multitreegp_tpu_torch.models.evaluators import SREvaluator

    n = s["max_nodes"]
    counters = dict(sr_fitness=cf.sr_fitness_cuda, reproduce=cr.reproduce_lanes_cuda)
    res = {}
    for name, fused in (("non_fused", False), ("fused", True)):
        gp = GeneticProgramming(
            num_generations=s["generations"], population_size=s["pop"],
            fitness_function=SREvaluator(substeps=1), operator_list=OPERATORS,
            variable_list=[["x0", "x1"]], layer_sizes=[2], num_populations=s["islands"],
            max_nodes=n, max_init_depth=s["depth"], fused_reproduction=fused,
            elite_percentage=s["elite"], device=device)
        check(gp.fused_reproduction == fused, f"{name}: routed to the other path")
        slots = gp.fset.slots(device)
        validate = (lambda p: validate_host(p.map(lambda a: a.reshape(-1, n)), slots)) if not fused else None
        r = loop_generations(gp, data, device, s["generations"], 18, counters, validate)
        gp_g = torch.Generator(device=device).manual_seed(180)
        if device.type == "cuda":
            check(r["launches"]["sr_fitness"] >= s["generations"], f"{name}: #1 launches {r['launches']}")
            check((r["launches"]["reproduce"] == 0) != fused, f"{name}: #2 launches {r['launches']}")
        gens = r["generations"]
        profile = None
        if device.type == "cuda":  # one more evolve of the last children, profiled: what the device does
            fitness = gp._evaluate(r["pops"], data)  # the children's own fitness
            prof = profile_device(lambda: gp.evolve(r["pops"], fitness, gp_g), torch)
            profile = dict(wall_ms=prof["wall_ms"], busy_ms=prof["busy_ms"], kernels=prof["kernels"])
        res[name] = dict(generations=[{k: v for k, v in g.items() if "launches" not in k} for g in gens],
                         evolve_profile=profile,
                         launches=r["launches"], best=r["best"],
                         ms_per_generation=statistics.median(g["eval_ms"] + g["evolve_ms"] for g in gens[1:]),
                         evolve_ms=statistics.median(g["evolve_ms"] for g in gens[1:]))
    for name, r in res.items():
        for i, g in enumerate(r["generations"]):
            phase_line(f"phase 18 {name} gen {i}: eval {g['eval_ms']:.3f} ms, evolve {g['evolve_ms']:.3f} ms, "
                       f"best fitness {g['best']:.6g}")
    nf, fu = res["non_fused"], res["fused"]
    for name, r in res.items():
        if r["evolve_profile"]:
            pr = r["evolve_profile"]
            phase_line(f"phase 18 {name} evolve profiled: wall {pr['wall_ms']:.1f} ms, device busy "
                       f"{pr['busy_ms']:.2f} ms ({pr['busy_ms'] / pr['wall_ms']:.2%}), {pr['kernels']} kernel "
                       f"launches")
    phase_line(f"phase 18 {s['islands']}x{s['pop']} candidates, N={n}: ms per generation (median of gens "
               f"1-{s['generations'] - 1}) non-fused {nf['ms_per_generation']:.3f} (evolve {nf['evolve_ms']:.3f}) "
               f"vs fused {fu['ms_per_generation']:.3f} (evolve {fu['evolve_ms']:.3f}); launches non-fused "
               f"{nf['launches']}, fused {fu['launches']}; every non-fused child valid; best non-increasing")
    return {"non_fused": res}


def wide_interpreter_case(device, trees, fset, g, members, lengths=None, zigzag=()):
    """:func:`shape_case` of the first candidates chained (``lengths``, by
    default N - 1, 127 and 63 rows: the longest tapes; ``zigzag`` as in
    :func:`chain_trees`); ``members = 1`` is one data vector a tree."""
    n = trees.max_nodes
    return shape_case(device, chain_trees(trees, fset, lengths or [n - 1, 127, 63], zigzag), members, g)


def shape_case(device, cands, members, g, x0s=None):
    """``(trees (K, 1, m, N), states (K, members, 1, V), cotangent)`` of
    ``cands`` against ``members`` random states each (V = 2), or against the
    rows of ``x0s (members, V)`` (every candidate the same), the cotangent
    from ``g`` (a fixed seed without one)."""
    import torch

    k, m = cands.ops.shape[:2]
    if g is None:
        g = torch.Generator(device=device).manual_seed(0)
    if x0s is None:
        states = torch.randn((k, members, 1, 2), generator=g, device=device) * 2
    else:
        states = x0s[None, :members, None].expand(k, members, 1, x0s.shape[-1])
    cot = torch.randn((k, members, m), generator=g, device=device)
    return cands.map(lambda a: a[:, None]), states, cot


def lanes_check(trees_b, states, cot, fset, label, vjp=True) -> dict:
    """#8's roots and #9's per-lane cotangents for ``trees_b`` broadcast
    against ``states`` (consecutive lanes share a tree) against the plain
    versions on one tree and one state per lane: every lane bit-equal (with
    ``vjp`` false the roots alone)."""
    import torch

    from multitreegp_tpu_torch.core import cuda_interpreter as ci
    from multitreegp_tpu_torch.core.interpreter import evaluate_trees_plain, evaluate_trees_vjp_plain

    batch = cot.shape
    full = trees_b.map(lambda a: a.expand(batch + a.shape[-1:]).contiguous())
    x = states.expand(batch + states.shape[-1:]).contiguous()
    if vjp:
        got = grouped_per_lane(trees_b, states, cot, fset)
        ref, plain_ms = timed_plain(
            lambda: (evaluate_trees_plain(full, x, fset),) + evaluate_trees_vjp_plain(full, x, cot, fset),
            states.device)
    else:
        got = (ci.evaluate_trees_cuda(trees_b, states, fset) if states.device.type == "cuda"
               else evaluate_trees_plain(full, x, fset),)
        ref, plain_ms = timed_plain(lambda: (evaluate_trees_plain(full, x, fset),), states.device)
    same = [bool(same_bits(a, r)) for a, r in zip(got, ref)]
    check(all(same), f"{label}: bit-equal forward, dconst, ddata {same}")
    return dict(lanes=cot.numel(), members=cot.shape[1], bit_equal=dict(zip(("fwd", "dconst", "ddata"), same)),
                finite=float(torch.isfinite(ref[0]).float().mean()), plain_ms=plain_ms,
                c2_max=int(trees_b.c2.max()), rows_max=int((trees_b.ops != 0).sum(-1).max()),
                max_abs_err=max(float(torch.where(torch.isfinite(r), (a - r).abs(), 0.0).max())
                                for a, r in zip(got, ref)))


def wide_phase(device, s, data) -> dict:
    """Phase 19: past the fixed instances' 1024 rows. Phase 4's workload at
    ``max_nodes=2048``, ``max_init_depth=10`` with default routing, which
    takes the non-fused evolve and the evaluators' general path (the
    integrator with #8's wide instance as the drift): 3 generations, then one
    constant-optimisation round of the top 50 (10 Adam steps; #9 in the
    backward); #8/#9 launches read around each step. Then #8/#9 against
    their plain versions, every lane bit-equal, in the recompute's layout (16
    trajectories a tree) and with one data vector a tree: at 512 and 1024
    rows (the fixed instance) on chains of N - 1, 127 and 63 rows; at 2048
    rows (the wide one) the roots on chains of N - 1 rows (one the
    zigzag whose second operands reach row N - 3), and roots and cotangents
    on chains of 1023 rows (one the zigzag) in trees of N rows (the plain
    VJP's time grows with the square of its rows; ``pytest -m cuda``'s
    ``test_interpreter_wide_match_plain_on_card`` holds the chains of N - 1
    rows); and at 2048 rows on the evaluation's shape (the population x 16)
    and the round's (its top 50 x 16); on each case their times and
    bounds."""
    import torch

    from multitreegp_tpu_torch import GeneticProgramming
    from multitreegp_tpu_torch.core import cuda_interpreter as ci
    from multitreegp_tpu_torch.core import cuda_reproduction as cr
    from multitreegp_tpu_torch.core import cuda_rollout as cf
    from multitreegp_tpu_torch.ops.initialization import make_population_sampler
    from multitreegp_tpu_torch.models.evaluators import SREvaluator

    n, b, gens = s["wide_nodes"], s["batch"], s["wide_generations"]
    t_steps = data[1].shape[0]
    gp = GeneticProgramming(
        num_generations=gens, population_size=s["pop"],
        fitness_function=SREvaluator(substeps=1), operator_list=OPERATORS,
        variable_list=[["x0", "x1"]], layer_sizes=[2], num_populations=s["islands"], max_nodes=n,
        max_init_depth=s["wide_depth"], gradient_steps=s["gradient_steps"],
        coefficient_opt_top_k=s["top_k"], elite_percentage=s["elite"], device=device)
    check(not gp.fused_reproduction, "N > 256 must take the non-fused path")
    counters = dict(sr_fitness=cf.sr_fitness_cuda, reproduce=cr.reproduce_lanes_cuda,
                    interpret_fwd=ci.evaluate_trees_cuda, interpret_bwd=ci.evaluate_trees_vjp_cuda)
    r = loop_generations(gp, data, device, gens, 19, counters)
    pops = r["pops"]
    res = round_phase(gp, pops, data, device, counters, t_steps, f"phase 19 N={n}")
    sizes = (pops.ops != 0).sum(-1)
    if device.type == "cuda":
        for i, gen in enumerate(r["generations"]):
            ev = gen["eval_launches"]
            check(ev["interpret_fwd"] >= (t_steps - 1) * 4 and ev["sr_fitness"] == 0 and ev["reproduce"] == 0,
                  f"gen {i} evaluate launches {ev}")
            check(not any(gen["evolve_launches"].values()), f"gen {i} evolve launches {gen['evolve_launches']}")
    for i, gen in enumerate(r["generations"]):
        phase_line(f"phase 19 N={n} gen {i}: eval {gen['eval_ms']:.3f} ms, evolve {gen['evolve_ms']:.3f} ms, "
                   f"best fitness {gen['best']:.6g}; launches in evaluate {gen['eval_launches']}, in evolve "
                   f"{gen['evolve_launches']}")
    phase_line(f"phase 19 N={n} tree rows mean {float(sizes.float().mean()):.1f} max {int(sizes.max())}")

    # #8/#9 against the plain versions past 256 rows, every lane
    fset, flat, top = gp.fset, res.pop("flat"), res.pop("top")
    g = torch.Generator(device=device).manual_seed(190)
    cases = {}
    for nodes in s["wide_check_nodes"]:
        depth = s["wide_depth"] if nodes >= 2 ** s["wide_depth"] else s["deep_depth"]
        cands = (flat[top] if nodes == n else
                 make_population_sampler(fset, depth, nodes)(g, top.numel())[0])
        for members, layout in ((b, "recompute"), (1, "one_member")):
            if nodes <= ci.FIXED_ROWS:
                cases[f"n{nodes}_{layout}"] = (wide_interpreter_case(device, cands, fset, g, members), True)
                continue
            cases[f"n{nodes}_{layout}_roots"] = (wide_interpreter_case(
                device, cands, fset, g, members, [nodes - 1, nodes - 1, 127], zigzag=(1,)), False)
            cases[f"n{nodes}_{layout}"] = (wide_interpreter_case(
                device, cands, fset, g, members, [min(511, nodes - 1)] * 2 + [63], zigzag=(1,)), True)
    cases[f"n{n}_population"] = (shape_case(device, flat, b, g), True)
    cases[f"n{n}_round"] = (shape_case(device, flat[top], b, g), True)
    checks = {}
    for key, (case, vjp) in cases.items():
        checks[key] = c = lanes_check(*case, fset, f"#8/#9 {key}", vjp=vjp)
        phase_line(f"phase 19 #8/#9 {key} vs plain ({c['lanes']} lanes, {c['members']} a tree, trees of up "
                   f"to {c['rows_max']} rows, second operands up to row {c['c2_max']}): bit-equal "
                   f"{c['bit_equal']}, finite {c['finite']:.4f}, plain {c['plain_ms']:.1f} ms")
    res.update(generations=r["generations"], launches=r["launches"], rows_mean=float(sizes.float().mean()),
               rows_max=int(sizes.max()), checks=checks)
    if device.type == "cuda":
        res["times"] = interpreter_case_times(s, cases, checks, fset, "phase 19")
    return {"wide": res}


def round_phase(gp, pops, data, device, counters, t_steps, label) -> dict:
    """One constant-optimisation round of ``gp`` on the top-k of ``pops``
    (evaluated again), with ``counters`` read around it; at least
    ``gradient_steps`` x the drift calls of #8 and #9 on the card, nothing
    made worse. Returns the round's record, with the flat population and
    the top-k's indices under ``flat`` and ``top``."""
    import torch

    fitness = gp._evaluate(pops, data)
    flat = pops.map(lambda a: a.reshape((-1,) + a.shape[2:]))
    top = torch.argsort(fitness.reshape(-1), stable=True)[: gp.coefficient_opt_top_k]
    before = {k: fn.launches for k, fn in counters.items()}
    sync(device)
    t0 = time.perf_counter()
    refined, _ = gp.optimise(flat[top], data)
    sync(device)
    round_ms = (time.perf_counter() - t0) * 1e3
    launches = {k: fn.launches - before[k] for k, fn in counters.items()}
    unrefined = fitness.reshape(-1)[top]
    check(not bool((refined > unrefined * (1 + 1e-6)).any()), f"{label}: refinement made a candidate worse")
    if device.type == "cuda":
        need = gp.gradient_steps * (t_steps - 1) * 4  # rk4, one substep
        check(launches["interpret_fwd"] >= need and launches["interpret_bwd"] >= need,
              f"{label} round launches {launches} < {need}")
    phase_line(f"{label} round: top-k {top.numel()}, {gp.gradient_steps} Adam steps, {round_ms:.1f} ms, "
               f"launches {launches}; top-k fitness sum {float(unrefined.sum()):.6g} -> {float(refined.sum()):.6g}")
    return dict(round=dict(ms=round_ms, launches=launches, unrefined_sum=float(unrefined.sum()),
                           refined_sum=float(refined.sum())), flat=flat, top=top)


def interpreter_case_times(s, cases, checks, fset, label) -> dict:
    """#8/#9 on each of ``cases`` (``{name: ((trees, states, cot), vjp)}``):
    events and device time per launch, and the bounds (:func:`interp_bounds`);
    the plain versions' events at the evaluation's and the round's shapes,
    elsewhere the per-lane plain run of the check; #9 only where ``vjp``."""
    import torch

    from multitreegp_tpu_torch.core import cuda_interpreter as ci
    from multitreegp_tpu_torch.core.interpreter import evaluate_trees_plain, evaluate_trees_vjp_plain

    out = {}
    for name, ((trees_b, states, cot), vjp) in cases.items():
        fwd = lambda: ci.evaluate_trees_cuda(trees_b, states, fset)
        bwd = lambda: ci.evaluate_trees_vjp_cuda(trees_b, states, cot, fset)
        t = dict(lanes=cot.numel(), rows_max=checks[name]["rows_max"],
                 fwd_kernel=cuda_time_ms(fwd, s["interp_runs"], torch),
                 plain_fwd_vjp_per_lane=checks[name]["plain_ms"])
        kind = "wide" if ci._operands(trees_b, states, fset)[-1].wide else "kernel"
        t["instance"] = kind
        timed = [("fwd_device", fwd, f"interpret_fwd_{kind}")]
        if vjp:
            t["bwd_kernel"] = cuda_time_ms(bwd, s["interp_runs"], torch)
            timed.append(("bwd_device", bwd, f"interpret_bwd_{kind}"))
        if name.endswith(("_population", "_round")):
            t["fwd_plain"] = cuda_time_ms(lambda: evaluate_trees_plain(trees_b, states, fset), 1, torch)
            t["bwd_plain"] = cuda_time_ms(lambda: evaluate_trees_vjp_plain(trees_b, states, cot, fset), 1, torch)
        t.update(kernel_device_ms(timed, s["interp_runs"], torch))
        t["fwd_bound"], t["bwd_bound"] = interp_bounds(trees_b, states, cot, fset)
        out[name] = t
        plain = (f"plain {t['fwd_plain']:.2f} / {t['bwd_plain']:.2f}" if "fwd_plain" in t else
                 f"plain {'forward + VJP' if vjp else 'forward'} per lane {t['plain_fwd_vjp_per_lane']:.1f}")
        vjp_part = (f"VJP kernel {t['bwd_kernel']:.4f} (device {t['bwd_device']:.4f}, bound "
                    f"{t['bwd_bound'][0]:.7f} by {t['bwd_bound'][1]})" if vjp else "forward only")
        phase_line(f"{label} #8/#9 {name} times ({kind} instance), {t['lanes']} lanes, trees up to {t['rows_max']} rows (median "
                   f"ms): forward kernel {t['fwd_kernel']:.4f} (device {t['fwd_device']:.4f}, bound "
                   f"{t['fwd_bound'][0]:.7f} by {t['fwd_bound'][1]}); {vjp_part}; {plain}")
    return out


def gen_deep_phase(device, s, data) -> dict:
    """Phase 20: the JAX package's ``gen_deep`` workload (``bench.py``'s
    ``main_generations(max_nodes=128, max_init_depth=7)``) on the fused path:
    5 generations of the host loop, ms per generation, and #1's and #2's
    device time per launch over one more generation by torch.profiler."""
    import torch

    from multitreegp_tpu_torch import GeneticProgramming
    from multitreegp_tpu_torch.core import cuda_reproduction as cr
    from multitreegp_tpu_torch.core import cuda_rollout as cf
    from multitreegp_tpu_torch.core.trees import validate_host
    from multitreegp_tpu_torch.models.evaluators import SREvaluator

    n = s["deep_gen_nodes"]
    gp = GeneticProgramming(
        num_generations=s["generations"] + 1, population_size=s["pop"],
        fitness_function=SREvaluator(substeps=1), operator_list=OPERATORS,
        variable_list=[["x0", "x1"]], layer_sizes=[2], num_populations=s["islands"], max_nodes=n,
        max_init_depth=s["deep_gen_depth"], elite_percentage=s["elite"], device=device)
    check(gp.fused_reproduction, "N <= 256 must take the fused path")
    counters = dict(sr_fitness=cf.sr_fitness_cuda, reproduce=cr.reproduce_lanes_cuda)
    r = loop_generations(gp, data, device, s["generations"], 20, counters)
    validate_host(r["pops"].map(lambda a: a.reshape(-1, n)), gp.fset.slots(device))
    if device.type == "cuda":
        check(r["launches"]["sr_fitness"] >= s["generations"] and r["launches"]["reproduce"] >= s["generations"],
              f"gen_deep launches {r['launches']}")
    gens = r["generations"]
    sizes = (r["pops"].ops != 0).sum(-1)
    res = dict(generations=[{k: v for k, v in gen.items() if "launches" not in k} for gen in gens],
               launches=r["launches"], best=r["best"], rows_mean=float(sizes.float().mean()),
               rows_max=int(sizes.max()),
               ms_per_generation=statistics.median(gen["eval_ms"] + gen["evolve_ms"] for gen in gens[1:]))
    for i, gen in enumerate(gens):
        phase_line(f"phase 20 gen_deep gen {i}: eval {gen['eval_ms']:.3f} ms, evolve {gen['evolve_ms']:.3f} ms, "
                   f"best fitness {gen['best']:.6g}")
    if device.type == "cuda":  # #1 and #2 on the last population, by torch.profiler
        pops, gen_g = r["pops"], torch.Generator(device=device).manual_seed(200)
        fitness = gp._evaluate(pops, data)  # the last children's own fitness
        flat = pops.map(lambda a: a.reshape((-1,) + a.shape[2:]))
        x0s, ts, ys, _ = data
        ys_c = ys.contiguous()
        res.update(kernel_device_ms(
            (("fit_device_ms", lambda: cf.sr_fitness_cuda(flat, x0s, ts, ys_c, gp.fset, "rk4", 1),
              "sr_fitness_kernel"),
             ("rep_device_ms", lambda: gp._evolve_populations(pops, fitness, gen_g, 0), "reproduce_kernel")),
            s["timing_runs"], torch))
    dev = lambda v: "not measured" if v is None else f"{v:.4f} ms"
    phase_line(f"phase 20 gen_deep: {s['islands']}x{s['pop']} candidates, N={n}, depth {s['deep_gen_depth']}: ms "
               f"per generation (median of gens 1-{s['generations'] - 1}) {res['ms_per_generation']:.3f}; #1 device "
               f"{dev(res.get('fit_device_ms'))}, #2 device {dev(res.get('rep_device_ms'))} a launch; tree "
               f"rows mean {res['rows_mean']:.1f} max {res['rows_max']}; launches {r['launches']}")
    return {"gen_deep": res}


def chained_phase(device, s, pops, fset, data) -> dict:
    """Phase 21: ``SREvaluator.prepare_chained`` on phase 4's last population
    (8 x 512 candidates, RK4 x 1, T = 50) and on the SDE workload of phase 15
    (process noise 0.05, Euler x 4): ``step(const0)`` bit-equal to
    ``evaluate_population`` per candidate; then ``chain_k`` chained steps
    (each step's constants nudged by ``1e-30 * min(fitness)``, the chain of
    ``bench.py``) against as many ``evaluate_population`` calls, by CUDA
    events and the device's busy time, and the kick rows' build alone."""
    import torch

    from multitreegp_tpu_torch.core import cuda_rollout as cf
    from multitreegp_tpu_torch.models.environments import VanDerPolOscillator
    from multitreegp_tpu_torch.models.evaluators import SREvaluator, generate_sr_data
    from multitreegp_tpu_torch.models.evaluators.noise import make_sr_kick_rows

    on_card = device.type == "cuda"
    x0s, ts, ys, _ = data
    g = torch.Generator(device=device).manual_seed(20)  # phase 15's SDE data
    sde_data = generate_sr_data(VanDerPolOscillator(s["noise"]), g, ts, batch_size=s["batch"], substeps=8)
    cases = dict(ode=(SREvaluator(fset, substeps=1), data),
                 sde=(SREvaluator(fset, substeps=s["policy_substeps"], process_noise=s["noise"]), sde_data))
    res, k = dict(launches=0), s["chain_k"]
    for name, (ev, d) in cases.items():
        before = cf.sr_fitness_cuda.launches
        prepared = ev.prepare_chained(pops, d)
        check(prepared is not None, f"prepare_chained refused the {name} workload")
        step, const0 = prepared
        got, want = step(const0), ev.evaluate_population(pops, d)
        same = float((got == want).float().mean())
        check(torch.equal(got, want), f"{name}: step(const0) equals evaluate_population on {same:.6f}")
        res["launches"] += cf.sr_fitness_cuda.launches - before
        rec = dict(candidates=got.numel(), identical=same)

        def chained():
            c = const0
            for _ in range(k):
                c = c + 1e-30 * step(c).min()
            return c

        def unchained():
            c = const0
            for _ in range(k):
                c = c + 1e-30 * ev.evaluate_population(pops._replace(const=c), d).min()
            return c

        if on_card:
            # unchained, chained, chained, unchained
            t = [cuda_time_ms(fn, s["timing_runs"], torch) for fn in (unchained, chained, chained, unchained)]
            rec.update(unchained_ms=[t[0], t[3]], chained_ms=[t[1], t[2]],
                       unchained_busy_ms=profile_device(unchained, torch)["busy_ms"],
                       chained_busy_ms=profile_device(chained, torch)["busy_ms"])
            rec["saved_per_eval_ms"] = (statistics.mean(rec["unchained_ms"])
                                        - statistics.mean(rec["chained_ms"])) / k
            if name == "sde":
                rec["kick_rows_ms"] = cuda_time_ms(
                    lambda: make_sr_kick_rows(s["noise"], ts, d[3], s["policy_substeps"], 2),
                    s["timing_runs"], torch)
            phase_line(f"phase 21 prepare_chained {name}: step(const0) identical to evaluate_population on "
                       f"{same:.6f} of {got.numel()} candidates; {k} chained steps {rec['chained_ms'][0]:.3f}, "
                       f"{rec['chained_ms'][1]:.3f} ms (device busy {rec['chained_busy_ms']:.3f}) vs {k} "
                       f"evaluate_population {rec['unchained_ms'][0]:.3f}, {rec['unchained_ms'][1]:.3f} ms "
                       f"(busy {rec['unchained_busy_ms']:.3f}); saved {rec['saved_per_eval_ms']:.4f} ms an "
                       f"evaluation" + (f"; the kick rows alone {rec['kick_rows_ms']:.3f} ms"
                                        if name == "sde" else ""))
        else:
            chained(), unchained()
            phase_line(f"phase 21 prepare_chained {name}: identical on {same:.6f} of {got.numel()} candidates")
        res[name] = rec
    return {"chained": res}


def sharded_rank(rank, world, store, out_dir, s, data_cpu, backend):
    """One rank of phase 22: ``fit(shard=True)`` on ``gen_opt``'s
    configuration for ``shard_generations`` generations over a mesh of
    ``world`` ranks (NCCL, one card each; gloo on the CPU), twice on one
    seed, with the per-generation spans and launch counts of each run; at
    W = 1 also ``fit()`` on the same seed. Saves its record to
    ``out_dir``."""
    import os
    from pathlib import Path

    import torch
    import torch.distributed as dist

    from multitreegp_tpu_torch import GeneticProgramming
    from multitreegp_tpu_torch.core import cuda_interpreter as ci
    from multitreegp_tpu_torch.core import cuda_reproduction as cr
    from multitreegp_tpu_torch.core import cuda_rollout as cf
    from multitreegp_tpu_torch.core.trees import validate_host
    from multitreegp_tpu_torch.models.evaluators import SREvaluator
    from multitreegp_tpu_torch.parallel import collective
    from multitreegp_tpu_torch.parallel.mesh import make_mesh

    if backend == "nccl":
        os.environ["LOCAL_RANK"] = str(rank)
        torch.cuda.set_device(rank)
    dist.init_process_group(backend, store=dist.FileStore(store, world), rank=rank, world_size=world)
    try:
        mesh = make_mesh()
        device = mesh.device
        data = tuple(None if t is None else t.to(device) for t in data_cpu)
        gens = s["shard_generations"]

        def make(**kwargs):
            return GeneticProgramming(
                num_generations=gens, population_size=s["pop"], fitness_function=SREvaluator(substeps=1),
                operator_list=OPERATORS, variable_list=[["x0", "x1"]], layer_sizes=[2],
                num_populations=s["islands"], max_nodes=s["max_nodes"], max_init_depth=s["depth"],
                coefficient_optimisation=True, gradient_steps=s["gradient_steps"],
                coefficient_opt_top_k=s["top_k"], elite_percentage=s["elite"], **kwargs)

        counters = dict(sr_fitness=cf.sr_fitness_cuda, reproduce=cr.reproduce_lanes_cuda,
                        interpret_fwd=ci.evaluate_trees_cuda, interpret_bwd=ci.evaluate_trees_vjp_cuda)

        def run_once():
            """One timed ``fit(shard=True)``: its outputs and record."""
            spans = {k: [0.0] * gens for k in ("eval", "ring", "evolve", "best", "round")}
            marks, rounds = [], []
            gp = make(mesh=mesh)

            def timed(fn, key, mark=False):
                def wrapper(*args):
                    sync(device)
                    t0 = time.perf_counter()
                    if mark:
                        marks.append(t0)
                    result = fn(*args)
                    sync(device)
                    spans[key][gp.current_generation] += (time.perf_counter() - t0) * 1e3
                    return result
                return wrapper

            make_round = collective.make_constant_opt_collective

            def make_round_checked(*args):
                step = make_round(*args)

                def checked(pops, fitness):
                    out = step(pops, fitness)
                    worse = out[1] > fitness * (1 + 1e-6)
                    rounds.append(dict(generation=gp.current_generation, worse=int(worse.sum()),
                                       improved=int((out[1] < fitness).sum())))
                    return out
                return timed(checked, "round")

            patched = [(collective, "_ring_shift_islands", timed(collective._ring_shift_islands, "ring")),
                       (collective, "global_best", timed(collective.global_best, "best")),
                       (collective, "make_constant_opt_collective", make_round_checked)]
            saved = [(mod, name, getattr(mod, name)) for mod, name, _ in patched]
            gp._evaluate = timed(gp._evaluate, "eval", mark=True)
            gp._evolve_island = timed(gp._evolve_island, "evolve")
            try:
                for mod, name, fn in patched:
                    setattr(mod, name, fn)
                for fn in counters.values():
                    fn.launches = 0
                sync(device)
                t0 = time.perf_counter()
                out = gp.fit(torch.Generator(device=device).manual_seed(2), data, shard=True)
                sync(device)
                wall = (time.perf_counter() - t0) * 1e3
                launches = {k: fn.launches for k, fn in counters.items()}
            finally:
                for mod, name, fn in saved:
                    setattr(mod, name, fn)
            return gp, out, dict(wall_ms=wall, launches=launches, spans=spans, rounds=rounds,
                                 gen_ms=[(b - a) * 1e3 for a, b in zip(marks, marks[1:])])

        # the first run pays the process's first launches of every kernel;
        # the second, on the same seed, is the steady state and must repeat it
        _, cold_out, cold = run_once()
        gp, (best, sols, pops, fitness), warm = run_once()
        flat = lambda o: [o[0], *o[1], *o[2], o[3]]
        rec = dict(rank=rank, world=world, device=str(device), **warm, best=best.cpu(),
                   cold=dict(wall_ms=cold["wall_ms"], gen_ms=cold["gen_ms"], spans=cold["spans"]),
                   repeated=all(torch.equal(a, b) for a, b in zip(flat(cold_out), flat((best, sols, pops, fitness)))),
                   fitness_min=float(fitness.min()), fitness_max=float(fitness.max()),
                   finite=bool(torch.isfinite(fitness).all()))
        validate_host(pops.map(lambda a: a.reshape(-1, a.shape[-1])), gp.fset.slots(device))
        rec["valid"] = True
        if world == 1:  # the same seed through fit()
            want = make(device=device).fit(torch.Generator(device=device).manual_seed(2), data)
            rec["equal_fit"] = all(torch.equal(a, b) for a, b in zip(flat((best, sols, pops, fitness)), flat(want)))
        torch.save(rec, Path(out_dir) / f"rank{rank}.pt")
    finally:
        dist.destroy_process_group()


def sharded_phase(device, s, data) -> dict:
    """Phase 22: ``fit(shard=True)`` at full width on ``gen_opt``'s
    configuration (8 x 512, top-k 50, 10 Adam steps) for 15 generations (the
    round at generation 14), over W ranks spawned with
    ``torch.multiprocessing`` (NCCL, a ``FileStore``): W the machine's card
    count capped to a divisor of the islands (gloo, W = 1 on the CPU). At
    W = 1 the run equals ``fit()`` bit for bit; at every W the histories
    never grow, every final tree is valid, the fitness is finite in [0, 1e5]
    and the round makes no candidate worse. Each rank runs the fit twice on
    one seed (the first pays the process's first launch of every kernel)
    and the second must repeat it bit for bit. Per rank, of the second run:
    ms per generation and its spans (evaluation, migration ring, evolve,
    global best), the round, and #1/#2/#8/#9 launches; of the first, ms per
    generation, the ring and the round."""
    import tempfile
    from pathlib import Path

    import torch
    import torch.multiprocessing as mp

    on_card = device.type == "cuda"
    cards = torch.cuda.device_count() if on_card else 1
    world = max(w for w in range(1, min(cards, s["islands"]) + 1) if s["islands"] % w == 0)
    backend = "nccl" if on_card else "gloo"
    data_cpu = tuple(None if t is None else t.cpu() for t in data)
    with tempfile.TemporaryDirectory() as tmp:
        mp.spawn(sharded_rank, args=(world, str(Path(tmp) / "store"), tmp, s, data_cpu, backend),
                 nprocs=world, join=True)
        ranks = [torch.load(Path(tmp) / f"rank{r}.pt") for r in range(world)]
    gens = s["shard_generations"]
    for r in ranks:
        best = r["best"].tolist()
        check(all(b1 <= b0 for b0, b1 in zip(best, best[1:])), f"rank {r['rank']}: best fitness increased {best}")
        check(r["finite"] and 0 <= r["fitness_min"] and r["fitness_max"] <= 1e5,
              f"rank {r['rank']}: fitness outside [0, 1e5]")
        check(r["valid"], "invalid trees")
        check(len(r["rounds"]) == 1 and r["rounds"][0]["worse"] == 0,
              f"rank {r['rank']}: the round {r['rounds']}")
        check(torch.equal(r["best"], ranks[0]["best"]), "the ranks' histories differ")
        check(r["repeated"], f"rank {r['rank']}: a second run on the same seed differs")
        if on_card:
            launches = r["launches"]
            check(launches["sr_fitness"] >= gens and launches["reproduce"] >= gens
                  and launches["interpret_fwd"] > 0 and launches["interpret_bwd"] > 0,
                  f"rank {r['rank']}: launches {launches}")
    if world == 1:
        check(ranks[0]["equal_fit"], "fit(shard=True) at W = 1 differs from fit()")
    res = dict(world=world, cards=cards, backend=backend, generations=gens, ranks=[])
    for r in ranks:
        # generation g runs from its evaluation's start to the next one's
        plain = [g for g in range(1, len(r["gen_ms"])) if g != r["rounds"][0]["generation"]]
        med = {k: statistics.median(v[g] for g in plain) for k, v in r["spans"].items()
               if k not in ("round", "ring")}
        ring = r["spans"]["ring"]
        med["ring"] = max(ring)  # the ring runs in the migration generations only
        rec = dict(rank=r["rank"], device=r["device"], launches=r["launches"], wall_ms=r["wall_ms"],
                   gen_ms=statistics.median(r["gen_ms"][g] for g in plain), span_ms=med,
                   ring_generations=[g for g, v in enumerate(ring) if v > 0],
                   round_ms=r["spans"]["round"][r["rounds"][0]["generation"]],
                   round=r["rounds"][0], best=r["best"].tolist(),
                   cold=dict(gen_ms=statistics.median(r["cold"]["gen_ms"][g] for g in plain),
                             ring_ms=max(r["cold"]["spans"]["ring"]),
                             round_ms=max(r["cold"]["spans"]["round"])))
        res["ranks"].append(rec)
        phase_line(f"phase 22 sharded fit rank {r['rank']}/{world} ({backend}, {r['device']}): {s['islands']}x"
                   f"{s['pop']} candidates, {gens} generations; ms per generation (median without the round) "
                   f"{rec['gen_ms']:.3f}: eval {med['eval']:.3f}, evolve "
                   f"{med['evolve']:.3f}, global best {med['best']:.4f}; migration ring {med['ring']:.4f} (gens "
                   f"{rec['ring_generations']}); round at gen {rec['round']['generation']} "
                   f"{rec['round_ms']:.1f} ms ({rec['round']['improved']} improved, 0 worse); launches "
                   f"{r['launches']}; best {rec['best'][0]:.6g} -> {rec['best'][-1]:.6g}; the process's first "
                   f"run: {rec['cold']['gen_ms']:.3f} ms a generation, ring {rec['cold']['ring_ms']:.4f}, round "
                   f"{rec['cold']['round_ms']:.1f} ms; the second repeats it bit for bit")
    if world == 1:
        phase_line("phase 22: fit(shard=True) at W = 1 equals fit() bit for bit (histories, populations, "
                   "fitness)" + (f"; {cards} card(s) on this machine" if on_card else "")
                   + ("; the W > 1 NCCL ring was not exercised on this machine" if on_card and cards == 1
                      else ""))
    return {"sharded": res}


# phase 23: (label, example module, seed, build options, run options); the
# examples' defaults are the notebooks' full sizes and generation counts
EXAMPLE_RUNS = (
    [("sr", "symbolic_regression", seed, {}, {}) for seed in (0, 1, 2)]
    + [("sr_fused", "symbolic_regression", 0, {}, dict(fused=True)),
       ("sr_adaptive", "symbolic_regression", 0, dict(adaptive=True), {})]
    + [("static", "static_policy", seed, {}, {}) for seed in (0, 1, 2)]
    + [("static_adaptive", "static_policy", 0, dict(adaptive=True), {})]
    + [("dynamic", "dynamic_policy", seed, {}, {}) for seed in (0, 1, 2)])
# the kernel each run's evaluation launches once a generation (#2 runs once an evolve)
EXAMPLE_EVAL_KERNEL = dict(sr="sr_fitness", sr_fused="sr_fitness", sr_adaptive="sr_adaptive_global",
                           static="policy", static_adaptive="policy_adaptive", dynamic="policy")


def example_counters():
    """The launch counters of the kernels the examples reach (#8 to show it
    idle: no example's evaluation takes the general path)."""
    from multitreegp_tpu_torch.core import cuda_adaptive as ca
    from multitreegp_tpu_torch.core import cuda_interpreter as ci
    from multitreegp_tpu_torch.core import cuda_policy as cp
    from multitreegp_tpu_torch.core import cuda_reproduction as cr
    from multitreegp_tpu_torch.core import cuda_rollout as cf

    return dict(sr_fitness=cf.sr_fitness_cuda, reproduce=cr.reproduce_lanes_cuda,
                sr_adaptive_global=ca.sr_fitness_adaptive_global_cuda,
                policy=cp.policy_rollout_cuda, policy_adaptive=cp.policy_rollout_adaptive_cuda,
                interpret_fwd=ci.evaluate_trees_cuda)


def cut_grid(data, k: int) -> tuple:
    """An example's data on the first ``k`` points of its save grid: ``ts``,
    and the targets ``ys`` of SR data ``(x0s, ts, ys, keys)``."""
    if len(data) == 4:
        return data[0], data[1][:k], data[2][:, :k].contiguous(), data[3]
    return (data[0], data[1][:k]) + tuple(data[2:])


def examples_phase(device, s) -> dict:
    """Phase 23: the three notebook examples (``multitreegp_tpu_torch/
    examples``) through their own entry points, ``build`` and the loop
    ``main`` runs (``examples.run``), at the notebooks' full sizes and
    generation counts (a rehearsal off the card cuts them with
    ``s["example_sizes"]``, and the save grid to its first ``s["example_t"]``
    points): SR for seeds 0-2, ``--fused`` and ``--adaptive`` for seed
    0; static for seeds 0-2 and ``--adaptive`` for seed 0; dynamic for seeds
    0-2. Each run: a finite best-fitness history in ``[0, max_fitness +
    size_parsimony * m * N]`` that never increases and ends below generation
    0's; the last population valid (``validate_host``), the dynamic readout
    trees reading only ``a0``/``a1``; its evaluation kernel (#1, #5, #6 or
    #7) launched once a generation and #2 once an evolve, by the counters
    zeroed before the run; ms per generation split into evaluate and evolve
    by ``utils.profiling.PhaseTimer``. Then #1, #2 and #5-#7 against their
    plain versions at ``max_nodes=30`` on the seed-0 runs' last
    populations, every lane identical (the horizon cut, and #5's budget cut
    to 40: the plain versions launch thousands of small kernels a save
    interval, and #5's steps until its slowest lane ends, 51 s at the
    example's budget of 500)."""
    import importlib

    import torch

    from multitreegp_tpu_torch.core import cuda_adaptive as ca
    from multitreegp_tpu_torch.core import cuda_rollout as cf
    from multitreegp_tpu_torch.core.trees import validate_host
    from multitreegp_tpu_torch.examples import run as run_example
    from multitreegp_tpu_torch.utils.profiling import PhaseTimer

    on_card = device.type == "cuda"
    sizes = s["example_sizes"] or {}
    counters = example_counters()
    runs, last = [], {}
    for label, module, seed, build_kw, run_kw in EXAMPLE_RUNS:
        mod = importlib.import_module(f"multitreegp_tpu_torch.examples.{module}")
        strategy, data, g = mod.build(seed, device, **build_kw, **sizes)
        if s["example_t"]:
            data = cut_grid(data, s["example_t"])
        for fn in counters.values():
            fn.launches = 0
        timer = PhaseTimer()
        sync(device)
        t0 = time.perf_counter()
        history, pops = run_example(strategy, data, g, timer=timer, **run_kw)
        sync(device)
        wall = time.perf_counter() - t0
        launches = {k: fn.launches for k, fn in counters.items()}
        gens, hist = strategy.num_generations, history.tolist()
        top = (strategy.evaluator.max_fitness
               + strategy.size_parsimony * strategy.num_trees * strategy.max_nodes)
        name = f"{label} seed {seed}"
        check(all(map(math.isfinite, hist)) and all(0 <= h <= top for h in hist),
              f"{name}: best fitness outside [0, {top}]: {hist}")
        check(all(b1 <= b0 for b0, b1 in zip(hist, hist[1:])), f"{name}: best fitness increased: {hist}")
        check(hist[-1] < hist[0] or bool(sizes), f"{name}: no improvement over {gens} generations: {hist}")
        n = strategy.max_nodes
        validate_host(pops.map(lambda a: a.reshape(-1, n)), strategy.fset.slots(device))
        if module == "dynamic_policy":
            fset = strategy.fset
            readout = pops.ops[:, :, fset.layer_sizes[0]:]
            allowed = torch.tensor([fset.string_to_op["a0"], fset.string_to_op["a1"]], device=device,
                                   dtype=readout.dtype)
            leaves = readout[readout >= fset.var_start]
            check(bool(torch.isin(leaves, allowed).all()), f"{name}: a readout tree reads past a0/a1")
        if on_card:
            want = {k: 0 for k in counters}
            want[EXAMPLE_EVAL_KERNEL[label]] = gens
            want["reproduce"] = gens
            if run_kw.get("fused"):  # graphed fit(): the wrappers run at the eager steps and captures
                check(strategy.fit_refusal is None, f"{name}: fit() not graphed: {strategy.fit_refusal}")
                eager, captured = fit_plan(strategy, gens)
                want = {k: v and len(eager) + len(captured) for k, v in want.items()}
            check(launches == want, f"{name}: launches {launches}, expected {want}")
        summ = timer.summary()
        if "fit" in summ:
            ms = dict(generation=summ["fit"]["total_s"] / gens * 1e3)
        else:
            ms = dict(evaluate=summ["evaluate"]["mean_s"] * 1e3, evolve=summ["evolve"]["mean_s"] * 1e3)
            ms["generation"] = ms["evaluate"] + ms["evolve"]
        rec = dict(label=label, seed=seed, generations=gens, candidates=pops.ops.shape[0] * pops.ops.shape[1],
                   ms_per_generation=ms, wall_s=wall, best_first=hist[0], best_last=hist[-1],
                   launches=launches, best=strategy.to_string(strategy.get_statistics(gens - 1)[1]))
        runs.append(rec)
        if seed == 0:
            last[label] = (strategy, data, pops)
        split = (f"evaluate {ms['evaluate']:.3f} + evolve {ms['evolve']:.3f}" if "evaluate" in ms
                 else "fit()")
        phase_line(f"phase 23 {name}: {rec['candidates']} candidates x {gens} generations, "
                   f"{ms['generation']:.3f} ms a generation ({split}), {wall:.1f} s; best {hist[0]:.6g} -> "
                   f"{hist[-1]:.6g}: {rec['best']}; launches {launches}")

    # the kernels at N = 30 against their plain versions, on the seed-0
    # populations (off the card the plain versions against themselves)
    checks = {}
    g = torch.Generator(device=device).manual_seed(23)
    fit_kernel = cf.sr_fitness_cuda if on_card else cf.sr_fitness_plain
    adaptive_kernel = ca.sr_fitness_adaptive_global_cuda if on_card else ca.sr_fitness_adaptive_global_plain
    strategy, data, pops = last["sr"]
    fset, flat = strategy.fset, pops.map(lambda a: a.reshape((-1,) + a.shape[2:]))
    x0s, ts, ys, _ = data
    t_cut = s["example_check_t"]
    ts_c, ys_c = ts[:t_cut], ys[:, :t_cut].contiguous()
    mse, alive = fit_kernel(flat, x0s, ts_c, ys_c, fset, "rk4", 4)
    (ref, ref_alive), plain_ms = timed_plain(
        lambda: cf.sr_fitness_plain(flat, x0s, ts_c, ys_c, fset, "rk4", 4), device)
    same = float(lanes_identical(mse, alive, ref, ref_alive).float().mean())
    check(same == 1.0, f"#1 at N = 30: {same} of lanes identical")
    fin = torch.isfinite(mse) & torch.isfinite(ref)
    checks["sr_fitness"] = dict(sr=dict(identical=same, max_abs_err=float((mse - ref).abs()[fin].max()),
                                        plain_ms=plain_ms, t_steps=t_cut, lanes=mse.numel()))
    rep = reproduction_case(device, dict(depth=strategy.max_init_depth, pop=strategy.population_size,
                                         islands=strategy.num_populations), flat, fset, g)
    checks["reproduce"] = dict(sr={k: rep[k] for k in ("lanes", "ops_identical", "max_abs_err", "bit_equal")})
    strategy, data, pops = last["sr_adaptive"]
    flat = pops.map(lambda a: a.reshape((-1,) + a.shape[2:]))
    ev = strategy.evaluator
    t_cut = s["example_check_adaptive_t"]
    budget = s["example_check_budget"]  # the plain version steps until its slowest lane ends
    args = (flat, data[0], data[1][:t_cut], data[2][:, :t_cut].contiguous(), strategy.fset, ev.rtol,
            ev.atol, budget, ev.adaptive_method)
    got = adaptive_kernel(*args)
    ref, plain_ms = timed_plain(lambda: ca.sr_fitness_adaptive_global_plain(*args), device)
    same, _, _, _, max_abs = compare_adaptive(got, ref)
    check(same == 1.0, f"#5 at N = 30: {same} of lanes identical")
    checks["sr_adaptive_global"] = dict(sr_adaptive=dict(identical=same, max_abs_err=max_abs, plain_ms=plain_ms,
                                                         t_steps=t_cut, budget=budget, lanes=got[0].numel()))
    for label, kind, t_cut in (("static", "fixed", s["example_check_t"]),
                               ("dynamic", "fixed", s["example_check_t"]),
                               ("static_adaptive", "adaptive", s["example_check_adaptive_t"])):
        strategy, data, pops = last[label]
        ev = strategy.evaluator
        flat = pops.map(lambda a: a.reshape((-1,) + a.shape[2:]))
        checks.setdefault(EXAMPLE_EVAL_KERNEL[label], {})[label] = policy_pair(
            device, kind, flat, data, ev.env, strategy.fset, ev.state_size, t_cut, substeps=ev.substeps)
    for kernel, by_run in checks.items():
        for label, c in by_run.items():
            phase_line(f"phase 23 {kernel} vs plain at N = 30 on the {label} seed-0 run's last population: "
                       + ", ".join(f"{k} {v:.6g}" if isinstance(v, float) else f"{k} {v}"
                                   for k, v in c.items()))
    return {"examples": dict(runs=runs, checks=checks)}


# phase 24: the gen workload's and the control workload's operator sets with
# the operators past + - * / sin cos (the kernels' extended build)
EXT_UNARY = ("exp", "log", "sqrt", "tanh", "abs", "neg", "square")
EXT_OPERATORS = (OPERATORS + [(name, 1, 0.1) for name in EXT_UNARY]
                 + [(name, 2, 0.1) for name in ("pow", "max", "min")])
EXT_POLICY_OPERATORS = [("+", 2), ("-", 2), ("*", 2), ("tanh", 1), ("sin", 1), ("cos", 1)]
# a chain's group of unary rows, each finite on what the one before gives
# (tanh's (-1, 1) keeps exp, then log, finite; abs before sqrt), ending in
# [1, e) so that the pow after it has a positive base
EXT_CHAIN_GROUP = ("tanh", "exp", "log", "neg", "abs", "sqrt", "square", "exp")
EXT_CHAIN_BINARY = ("+", "max", "-", "min", "*")


def ext_chain_trees(trees, fset, lengths):
    """``trees (P, m, n)`` with candidate i's trees replaced by a chain of
    ``lengths[i]`` rows (odd) that holds every operator of phase 24: k + 1
    leaves, then k binary rows (``+ max - min *``, ``pow`` after each group)
    whose stack holds k + 1 values, the most a tree of that many rows can
    with its unary rows; after every (k / G)-th binary row a group of the
    eight unary rows of :data:`EXT_CHAIN_GROUP`, G = (rows - 1) // 40
    groups."""
    import torch

    from multitreegp_tpu_torch.core.trees import CONST, EMPTY, TreeTensors, rebuild_pointers

    n = trees.max_nodes
    op = fset.string_to_op
    ops = trees.ops.clone()
    for i, rows in enumerate(lengths):
        groups = max(1, (rows - 1) // 40)
        k = (rows - 1 - len(EXT_CHAIN_GROUP) * groups) // 2
        leaves = [fset.var_start + j % 2 if j % 3 else CONST for j in range(k + 1)]
        body, after_group, left = [], False, groups
        for j in range(k):
            body.append(op["pow"] if after_group else op[EXT_CHAIN_BINARY[j % len(EXT_CHAIN_BINARY)]])
            after_group = left > 0 and j % (k // groups) == 0
            if after_group:
                body += [op[u] for u in EXT_CHAIN_GROUP]
                left -= 1
        chain = leaves + body
        ops[i] = torch.tensor([EMPTY] * (n - len(chain)) + chain, dtype=torch.int32)
    const = torch.where(ops == CONST, torch.where(trees.ops == CONST, trees.const, 0.5), 0.0)
    c1, c2 = rebuild_pointers(ops, fset.slots(ops.device))
    return TreeTensors(ops, c1, c2, const)


def with_unused_max(trees, fset, extra=(("max", 2, 0.1),)):
    """``(trees, fset)`` with a binary ``max`` (or the operators ``extra``)
    appended to ``fset``'s operators, which no tree uses (variable opcodes
    shift past them): the same computation, through the kernels' extended
    build (with an unused unary operator in ``extra``, its instance with the
    unary rows' code)."""
    import torch

    from multitreegp_tpu_torch.core.registry import build_function_set

    mask, names, variable_list, row = fset.variable_mask, fset.variable_names, [], 0
    for size in fset.layer_sizes:
        variable_list.append([names[v] for v in torch.nonzero(mask[row] > 0).flatten().tolist()])
        row += size
    wide = build_function_set(
        list(zip(fset.operator_names, fset.arities, fset.operator_probs)) + list(extra),
        variable_list, fset.layer_sizes)
    unary = fset.has_unary or any(a == 1 for _, a, _ in extra)
    check(wide.variable_names == names and wide.extended and wide.has_unary == unary
          and torch.equal(wide.variable_mask, mask), f"a set with unused {extra} appended")
    shift = len(extra)
    return trees._replace(ops=torch.where(trees.ops >= fset.var_start, trees.ops + shift, trees.ops)), wide


def in_turns(cases, runs, torch) -> dict:
    """Device ms of one launch per ``(key, fn, kernel)``, each case timed
    twice in the order a, b, b, a for consecutive pairs (six-operator and
    extended on one shape): ``{key: [first, second]}``."""
    out = {}
    for pair in zip(cases[::2], cases[1::2]):
        for key, fn, kernel in pair + pair[::-1]:
            out.setdefault(key, []).append(kernel_device_ms(((key, fn, kernel),), runs, torch)[key])
    return out


def extended_phase(device, s, data, trees6, fset6, ps) -> dict:
    """Phase 24: the operators past ``+ - * / sin cos`` through every tree
    kernel (their extended build): the ``gen`` workload's host loop, round and
    inspection, the kernels against their plain versions on its population,
    the static Acrobot loop with ``tanh``, #6/#7 against their plain
    versions, #8/#9 on chains at 256 and 1024 rows, and each kernel's device
    time beside the six-operator one (``trees6``, ``fset6``: phase 2's
    population; ``ps``: phase 12's)."""
    import torch

    from multitreegp_tpu_torch import GeneticProgramming, _build
    from multitreegp_tpu_torch.core import cuda_adaptive as ca
    from multitreegp_tpu_torch.core import cuda_interpreter as ci
    from multitreegp_tpu_torch.core import cuda_policy as cp
    from multitreegp_tpu_torch.core import cuda_reproduction as cr
    from multitreegp_tpu_torch.core import cuda_rollout as cf
    from multitreegp_tpu_torch.core.registry import build_function_set
    from multitreegp_tpu_torch.core.trees import validate_host
    from multitreegp_tpu_torch.models.evaluators import SREvaluator, StaticPolicyEvaluator
    from multitreegp_tpu_torch.ops.initialization import make_population_sampler

    t_start = time.perf_counter()
    on_card = device.type == "cuda"
    x0s, ts_full, ys_full, _ = data
    n, b, t_steps = s["max_nodes"], s["batch"], ts_full.shape[0]
    gp = GeneticProgramming(
        num_generations=s["generations"], population_size=s["pop"],
        fitness_function=SREvaluator(substeps=1), operator_list=EXT_OPERATORS,
        variable_list=[["x0", "x1"]], layer_sizes=[2], num_populations=s["islands"], max_nodes=n,
        max_init_depth=s["depth"], gradient_steps=s["gradient_steps"],
        coefficient_opt_top_k=s["top_k"], elite_percentage=s["elite"], device=device)
    fset = gp.fset
    check(fset.extended, "phase 24's function set must take the extended build")
    counters = dict(sr_fitness=cf.sr_fitness_cuda, reproduce=cr.reproduce_lanes_cuda,
                    interpret_fwd=ci.evaluate_trees_cuda, interpret_bwd=ci.evaluate_trees_vjp_cuda,
                    sr_rollout=cf.sr_rollout_cuda)
    validate = lambda pops: validate_host(pops.map(lambda a: a.reshape(-1, n)), fset.slots(device))
    r = loop_generations(gp, data, device, s["generations"], 24, counters, validate)
    if on_card:
        for i, gen in enumerate(r["generations"]):
            check(gen["eval_launches"]["sr_fitness"] >= 1 and gen["evolve_launches"]["reproduce"] >= 1,
                  f"gen {i} launches {gen['eval_launches']} {gen['evolve_launches']}")
    gen_ms = [g_["eval_ms"] + g_["evolve_ms"] for g_ in r["generations"]]
    # the round: the top 50 of the last generation, 10 Adam steps (#8/#9)
    pops = r["pops"]
    fitness = gp._evaluate(pops, data)
    flat = pops.map(lambda a: a.reshape((-1,) + a.shape[2:]))
    top = torch.argsort(fitness.reshape(-1), stable=True)[: gp.coefficient_opt_top_k]
    before = {k: fn.launches for k, fn in counters.items()}
    sync(device)
    t0 = time.perf_counter()
    refined, _ = gp.optimise(flat[top], data)
    sync(device)
    round_ms = (time.perf_counter() - t0) * 1e3
    unrefined = fitness.reshape(-1)[top]
    check(not bool((refined > unrefined * (1 + 1e-6)).any()), "refinement made a candidate worse")
    # the best candidate's trajectories (#3)
    best = flat[int(torch.argmin(fitness.reshape(-1)))]
    cand_fit, pred = SREvaluator(fset=fset, substeps=1).evaluate_candidate(best, data)
    check(pred.shape == (b, t_steps, 2) and bool(torch.isfinite(cand_fit).all()),
          "evaluate_candidate of the best candidate")
    launches = {k: fn.launches - before[k] for k, fn in counters.items()}
    if on_card:
        need = s["gradient_steps"] * (t_steps - 1) * 4  # rk4, one substep: drift calls
        check(launches["interpret_fwd"] >= need and launches["interpret_bwd"] >= need,
              f"round launches {launches} < {need}")
        check(launches["sr_rollout"] >= 1, f"#3 launches {launches}")
    phase_line(f"phase 24 gen with {len(EXT_OPERATORS)} operators ({' '.join(fset.operator_names)}): "
               f"{s['islands']}x{s['pop']} candidates, ms per generation {[round(v, 3) for v in gen_ms]} "
               f"(median {statistics.median(gen_ms):.3f}), best {[round(v, 6) for v in r['best']]}, loop "
               f"launches {r['launches']}; round of top {top.numel()}: {round_ms:.1f} ms, fitness sum "
               f"{float(unrefined.sum()):.6g} -> {float(refined.sum()):.6g}; then round + "
               f"evaluate_candidate launches {launches}")
    res = dict(generations=r["generations"], ms_per_generation=gen_ms, loop_launches=r["launches"],
               round=dict(ms=round_ms, unrefined_sum=float(unrefined.sum()),
                          refined_sum=float(refined.sum())), launches=launches, checks={})
    checks = res["checks"]

    # the kernels against their plain versions on the last population: #1 and
    # #3 at phase 11's T = 10 (the plain versions dispatch all 14 operators
    # at every row), #5 / #4 at phase 17's cut
    t_fix = s["adaptive_short_t"]
    ts_, ys_ = ts_full[:t_fix], ys_full[:, :t_fix].contiguous()
    mse, alive = (cf.sr_fitness_cuda if on_card else cf.sr_fitness_plain)(
        flat, x0s, ts_, ys_, fset, "rk4", 1)
    (ref, ref_alive), plain_ms = timed_plain(
        lambda: cf.sr_fitness_plain(flat, x0s, ts_, ys_, fset, "rk4", 1), device)
    same = float(lanes_identical(mse, alive, ref, ref_alive).float().mean())
    check(same == 1.0, f"#1 extended: {same:.6f} of lanes identical")
    fin = torch.isfinite(mse) & torch.isfinite(ref)
    checks["sr_fitness"] = dict(identical=same, alive=float(alive.float().mean()), plain_ms=plain_ms,
                                lanes=alive.numel(), t_steps=t_fix,
                                max_abs_err=float((mse - ref).abs()[fin].max()))
    xs, xalive = (cf.sr_rollout_cuda if on_card else cf.sr_rollout_plain)(flat, x0s, ts_, fset, "rk4", 1)
    (rxs, rxalive), plain_ms = timed_plain(lambda: cf.sr_rollout_plain(flat, x0s, ts_, fset, "rk4", 1),
                                           device)
    same, max_abs = rollout_identical(xs, xalive, rxs, rxalive)
    check(same == 1.0, f"#3 extended: {same:.6f} of lanes identical")
    checks["sr_rollout"] = dict(identical=same, max_abs_err=max_abs, plain_ms=plain_ms,
                                lanes=xalive[-1].numel(), t_steps=t_fix)
    t_cut = s["deep_adaptive_t"]
    cut = (ts_full[:t_cut], ys_full[:, :t_cut].contiguous())
    for key, kernel, plain, steps_arg in (
            ("sr_adaptive_global", ca.sr_fitness_adaptive_global_cuda, ca.sr_fitness_adaptive_global_plain,
             s["deep_adaptive_budget"]),
            ("sr_adaptive_interval", ca.sr_fitness_adaptive_interval_cuda,
             ca.sr_fitness_adaptive_interval_plain, s["deep_interval_steps"])):
        args = (flat, x0s, *cut, fset, 1e-4, 1e-6, steps_arg, "dopri5", 0.9)
        got = kernel(*args) if on_card else plain(*args)
        want, plain_ms = timed_plain(lambda: plain(*args), device)
        same, _, _, _, max_abs = compare_adaptive(got, want)
        check(same == 1.0, f"{key} extended: {same:.6f} of lanes identical")
        checks[key] = dict(identical=same, max_abs_err=max_abs, plain_ms=plain_ms, t_steps=t_cut,
                           steps_arg=steps_arg, lanes=got[1].numel())
    for key in ("sr_fitness", "sr_rollout", "sr_adaptive_global", "sr_adaptive_interval"):
        c = checks[key]
        phase_line(f"phase 24 #{dict(sr_fitness=1, sr_rollout=3, sr_adaptive_global=5, sr_adaptive_interval=4)[key]} "
                   f"{key} extended vs plain on the last population ({c['lanes']} lanes, T={c['t_steps']}): "
                   f"identical {c['identical']:.6f}, max abs {c['max_abs_err']:.3e}, plain {c['plain_ms']:.1f} ms")

    # #8/#9 in the round's layout (its top 50 against the batch's states, the
    # N <= 32 instance the round launches) and #2 on one generation's lanes of
    # the 14-operator population
    gc = torch.Generator(device=device).manual_seed(242)
    c = checks["interpreter_round"] = lanes_check(*shape_case(device, flat[top], b, gc), fset,
                                                  "#8/#9 extended, the round's layout")
    phase_line(f"phase 24 #8/#9 extended N={n} vs plain in the round's layout ({c['lanes']} lanes): "
               f"bit-equal {c['bit_equal']}, finite {c['finite']:.4f}, plain {c['plain_ms']:.1f} ms")
    rep = reproduction_case(device, s, pops, fset, gc)
    c = checks["reproduce"] = {k: rep[k] for k in ("lanes", "ops_identical", "max_abs_err", "max_rel",
                                                    "bit_equal")}
    phase_line(f"phase 24 #2 reproduce vs plain with {fset.num_operators} operators ({c['lanes']} lanes): "
               f"ops identical {c['ops_identical']:.6f}, const max rel {c['max_rel']:.3e}, bit-equal "
               f"{c['bit_equal']}; every child valid")

    # the control workload with tanh: 5 generations of the static loop (#6, #2)
    env, pdata = ps["env"], ps["data"]
    ys = [f"y{i}" for i in range(env.n_obs)]
    pgp = GeneticProgramming(
        num_generations=s["generations"], population_size=s["pop"],
        fitness_function=StaticPolicyEvaluator(env, substeps=s["policy_substeps"]),
        operator_list=EXT_POLICY_OPERATORS, variable_list=[ys], layer_sizes=[1],
        num_populations=s["islands"], max_nodes=s["policy_nodes"], max_init_depth=s["depth"],
        device=device)
    pfset = pgp.fset
    check(pfset.extended, "the policy set with tanh must take the extended build")
    pcounters = dict(policy=cp.policy_rollout_cuda, reproduce=cr.reproduce_lanes_cuda)
    pr = loop_generations(pgp, pdata, device, s["generations"], 240, pcounters)
    if on_card:
        check(all(g_["eval_launches"]["policy"] >= 1 and g_["evolve_launches"]["reproduce"] >= 1
                  for g_ in pr["generations"]), f"policy loop launches {pr['launches']}")
    pgen_ms = [g_["eval_ms"] + g_["evolve_ms"] for g_ in pr["generations"]]
    phase_line(f"phase 24 static Acrobot with {' '.join(pfset.operator_names)}: ms per generation "
               f"{[round(v, 3) for v in pgen_ms]} (median {statistics.median(pgen_ms):.3f}), best "
               f"{[round(v, 4) for v in pr['best']]}, launches {pr['launches']}")
    res["policy"] = dict(generations=pr["generations"], ms_per_generation=pgen_ms, launches=pr["launches"])
    pflat = pr["pops"].map(lambda a: a.reshape((-1,) + a.shape[2:]))
    dyn_fset = build_function_set(EXT_POLICY_OPERATORS, [ys + ["a0", "a1", "u0"], ["a0", "a1"]],
                                  [2, env.n_control])
    g = torch.Generator(device=device).manual_seed(241)
    dyn_trees = make_population_sampler(dyn_fset, s["depth"], s["policy_nodes"])(
        g, s["islands"] * s["pop"])[0]
    for key, kind, trees_, fset_, state_size, t_cut in (
            ("policy_static", "fixed", pflat, pfset, 0, s["legs_t"]),
            ("policy_dynamic", "fixed", dyn_trees, dyn_fset, 2, s["legs_t"]),
            ("policy_adaptive_static", "adaptive", pflat, pfset, 0, s["trig_adaptive_t"])):
        c = checks[key] = policy_pair(device, kind, trees_, pdata, env, fset_, state_size, t_cut,
                                      substeps=s["policy_substeps"])
        phase_line(f"phase 24 {key} extended vs plain, T={t_cut}, {c['lanes']} lanes: identical "
                   f"{c['identical']:.6f}, max abs {c['max_abs_err']:.3e}, alive {c['alive']:.4f}, plain "
                   f"{c['plain_ms']:.1f} ms")

    # #8/#9 on chains holding every operator: 256 rows (phase 17's 256 x 16
    # lanes) and 1024 rows (16 a tree)
    for nodes, count in ((s["deep_nodes"], s["deep_pop"]), (s["ext_chain_nodes"], 12)):
        cands = make_population_sampler(fset, s["deep_depth"], nodes)(g, count)[0]
        cands = ext_chain_trees(cands, fset, [nodes - 1, min(127, nodes - 1), min(63, nodes - 1)])
        key = f"interpreter_n{nodes}"
        c = checks[key] = lanes_check(*shape_case(device, cands, b, g), fset, f"#8/#9 extended {key}")
        phase_line(f"phase 24 #8/#9 extended N={nodes} vs plain ({c['lanes']} lanes, trees of up to "
                   f"{c['rows_max']} rows): bit-equal {c['bit_equal']}, finite {c['finite']:.4f}, plain "
                   f"{c['plain_ms']:.1f} ms")

    if on_card:
        check(all(_build.variant_name(k, True) in _build._loaded for k in EXTENDED_KERNELS),
              f"extended builds loaded: {sorted(_build._loaded)}")
        # device ms per launch beside the six-operator sets on one shape, in turns
        ys_c = ys_full.contiguous()
        short = (ts_full[: s["adaptive_short_t"]], ys_full[:, : s["adaptive_short_t"]].contiguous())
        sr_cases = []
        for tag, tr, fs in (("six", trees6, fset6), ("ext", flat, fset)):
            sr_cases.append([
                (f"sr_fitness_{tag}", (lambda tr=tr, fs=fs: cf.sr_fitness_cuda(tr, x0s, ts_full, ys_c, fs, "rk4", 1)),
                 "sr_fitness_kernel"),
                (f"sr_rollout_{tag}", (lambda tr=tr, fs=fs: cf.sr_rollout_cuda(tr, x0s, ts_full, fs, "rk4", 1)),
                 "sr_rollout_kernel"),
                (f"sr_adaptive_global_{tag}", (lambda tr=tr, fs=fs: ca.sr_fitness_adaptive_global_cuda(
                    tr, x0s, ts_full, ys_c, fs, 1e-4, 1e-6, s["adaptive_budget"], "dopri5")),
                 "adaptive_global_kernel"),
                (f"sr_adaptive_interval_{tag}", (lambda tr=tr, fs=fs: ca.sr_fitness_adaptive_interval_cuda(
                    tr, x0s, *short, fs, 1e-4, 1e-6, s["adaptive_interval_steps"], "dopri5")),
                 "adaptive_interval_kernel")])
        x0, pts, tgt, _, _, par = pdata
        pol_cases = []
        for tag, st, dy, fs_s, fs_d in (("six", ps["trees"]["static"], ps["trees"]["dynamic"],
                                         ps["fsets"]["static"], ps["fsets"]["dynamic"]),
                                        ("ext", pflat, dyn_trees, pfset, dyn_fset)):
            pol_cases.append([
                (f"policy_static_{tag}", (lambda st=st, fs=fs_s: cp.policy_rollout_cuda(
                    st, x0, pts, tgt, par, env, fs, s["policy_substeps"], "rk4", 0)), "policy_kernel"),
                (f"policy_dynamic_{tag}", (lambda dy=dy, fs=fs_d: cp.policy_rollout_cuda(
                    dy, x0, pts, tgt, par, env, fs, s["policy_substeps"], "rk4", 2)), "policy_kernel"),
                (f"policy_adaptive_{tag}", (lambda st=st, fs=fs_s: cp.policy_rollout_adaptive_cuda(
                    st, x0, pts, tgt, par, env, fs, 1e-4, 1e-4, s["policy_adaptive_substeps"])),
                 "policy_adaptive_kernel")])
        cases = [c for six, ext in (sr_cases, pol_cases) for pair in zip(six, ext) for c in pair]
        # what the extended build costs a six-operator set: the same trees
        # through the default library and, with an unused max appended to
        # the set, through the extended one (#1, #5, #6, #9)
        tr_x, fs_x = with_unused_max(trees6, fset6)
        st_x, fs_sx = with_unused_max(ps["trees"]["static"], ps["fsets"]["static"])
        bwd = shape_case(device, trees6, b, gc)
        bwd_x = (with_unused_max(bwd[0], fset6)[0],) + bwd[1:]
        fork = []
        for tag, tr, fs, st, fs_s, ops in (("default", trees6, fset6, ps["trees"]["static"],
                                            ps["fsets"]["static"], bwd),
                                           ("ext_build", tr_x, fs_x, st_x, fs_sx, bwd_x)):
            fork.append([
                (f"fork_sr_fitness_{tag}", (lambda tr=tr, fs=fs: cf.sr_fitness_cuda(
                    tr, x0s, ts_full, ys_c, fs, "rk4", 1)), "sr_fitness_kernel"),
                (f"fork_sr_adaptive_global_{tag}", (lambda tr=tr, fs=fs: ca.sr_fitness_adaptive_global_cuda(
                    tr, x0s, ts_full, ys_c, fs, 1e-4, 1e-6, s["adaptive_budget"], "dopri5")),
                 "adaptive_global_kernel"),
                (f"fork_policy_static_{tag}", (lambda st=st, fs=fs_s: cp.policy_rollout_cuda(
                    st, x0, pts, tgt, par, env, fs, s["policy_substeps"], "rk4", 0)), "policy_kernel"),
                (f"fork_interpret_bwd_{tag}", (lambda ops=ops, fs=fs: ci.evaluate_trees_vjp_cuda(
                    *ops, fs)), "interpret_bwd_kernel")])
        cases = [c for pair in zip(*fork) for c in pair] + cases
        times = in_turns(cases, 3, torch)
        res["device_ms"] = times
        for key in ("sr_fitness", "sr_adaptive_global", "policy_static", "interpret_bwd"):
            d, x = times[f"fork_{key}_default"], times[f"fork_{key}_ext_build"]
            phase_line(f"phase 24 {key} six-operator trees, device ms a launch (default build, extended "
                       f"build, extended build, default build): {d[0]:.4f}, {x[0]:.4f}, {x[1]:.4f}, {d[1]:.4f}")
        for key in ("sr_fitness", "sr_rollout", "sr_adaptive_global", "sr_adaptive_interval",
                    "policy_static", "policy_dynamic", "policy_adaptive"):
            six, ext = times[f"{key}_six"], times[f"{key}_ext"]
            phase_line(f"phase 24 {key} device ms a launch (six-operator, extended, extended, six-operator "
                       f"on one shape): {six[0]:.4f}, {ext[0]:.4f}, {ext[1]:.4f}, {six[1]:.4f}")
        res["nvcc_s"] = {k: v for k, v in _build.build_seconds.items() if k.endswith("_ext")}
        phase_line(f"phase 24 extended build nvcc seconds (beside the default build): {res['nvcc_s']}")
    res["seconds"] = time.perf_counter() - t_start
    phase_line(f"phase 24 took {res['seconds']:.1f} s")
    return {"extended": res}


# phase 25: gplearn's protected operators as torch callables (user operators:
# generated device code in the kernels' user build). The gen workload's set is
# core.registry.gplearn_operators(); the control workload's is phase 13's
# with the protected division (its header holds that operator alone)
def user_policy_operators():
    from multitreegp_tpu_torch.core.registry import protected_division

    return POLICY_OPERATORS + [("/", protected_division, 2)]


def user_sets():
    """``(gen set, control set)`` of phase 25 (built before the kernels, so
    that their user libraries are compiled in the parallel prelude)."""
    from multitreegp_tpu_torch.core.registry import build_function_set, gplearn_operators

    gen = build_function_set(gplearn_operators(), [["x0", "x1"]], [2])
    control = build_function_set(user_policy_operators(), [["y0"]], [1])
    return gen, control


# the sources each phase-25 set runs: the gen loop, round and checks (#1, #3,
# #4/#5, #8/#9), the control loop and checks (#6/#7)
USER_GEN_KERNELS = ("sr_fitness", "interpreter", "sr_adaptive", "sr_rollout")
USER_CONTROL_KERNELS = ("policy",)


def with_protected_division(trees, fset):
    """``(trees, fset)`` of phase 2's ``+ - * /`` trees in the gplearn set,
    whose first four operators are ``+ - *`` and the protected ``/`` (variable
    opcodes shift past its four other operators, which no tree uses): the same
    trees, with ``/`` the user operator, through the user library."""
    import torch

    from multitreegp_tpu_torch.core.registry import build_function_set, gplearn_operators

    user = build_function_set(gplearn_operators(), [list(fset.variable_names)], list(fset.layer_sizes))
    check(user.operator_names[:4] == fset.operator_names and user.variable_names == fset.variable_names,
          "the gplearn set's first operators are + - * /")
    shift = user.var_start - fset.var_start
    return trees._replace(ops=torch.where(trees.ops >= fset.var_start, trees.ops + shift, trees.ops)), user


def user_phase(device, s, data, trees6, fset6, ps) -> dict:
    """Phase 25: gplearn's protected operators (torch callables traced into
    generated device code, the kernels' user build) through every tree
    kernel: the ``gen`` workload's host loop, round and inspection, the
    kernels against their plain versions on its population, the static
    Acrobot loop with the protected ``/``, #6/#7 against their plain
    versions, and #1, #5 and #9 on phase 2's trees through the extended
    library (the table's ``/``) and the user library (the protected ``/``)
    in turns (``trees6``, ``fset6``: phase 2's population; ``ps``: phase
    12's)."""
    import torch

    from multitreegp_tpu_torch import GeneticProgramming, _build
    from multitreegp_tpu_torch.core import cuda_adaptive as ca
    from multitreegp_tpu_torch.core import cuda_interpreter as ci
    from multitreegp_tpu_torch.core import cuda_policy as cp
    from multitreegp_tpu_torch.core import cuda_reproduction as cr
    from multitreegp_tpu_torch.core import cuda_rollout as cf
    from multitreegp_tpu_torch.core.registry import USER_FROM, build_function_set, gplearn_operators
    from multitreegp_tpu_torch.core.trees import validate_host
    from multitreegp_tpu_torch.models.evaluators import SREvaluator, StaticPolicyEvaluator

    t_start = time.perf_counter()
    on_card = device.type == "cuda"
    x0s, ts_full, ys_full, _ = data
    n, b, t_steps = s["max_nodes"], s["batch"], ts_full.shape[0]
    gp = GeneticProgramming(
        num_generations=s["generations"], population_size=s["pop"],
        fitness_function=SREvaluator(substeps=1), operator_list=gplearn_operators(),
        variable_list=[["x0", "x1"]], layer_sizes=[2], num_populations=s["islands"], max_nodes=n,
        max_init_depth=s["depth"], gradient_steps=s["gradient_steps"],
        coefficient_opt_top_k=s["top_k"], elite_percentage=s["elite"], device=device)
    fset = gp.fset
    check(fset.device_op_ids[3:] == tuple(range(USER_FROM, USER_FROM + 5)) and fset.user_hash != "",
          f"phase 25's protected operators must be user operators: {fset.device_op_ids}")
    counters = dict(sr_fitness=cf.sr_fitness_cuda, reproduce=cr.reproduce_lanes_cuda,
                    interpret_fwd=ci.evaluate_trees_cuda, interpret_bwd=ci.evaluate_trees_vjp_cuda,
                    sr_rollout=cf.sr_rollout_cuda)
    validate = lambda pops: validate_host(pops.map(lambda a: a.reshape(-1, n)), fset.slots(device))
    r = loop_generations(gp, data, device, s["generations"], 25, counters, validate)
    if on_card:
        for i, gen in enumerate(r["generations"]):
            check(gen["eval_launches"]["sr_fitness"] >= 1 and gen["evolve_launches"]["reproduce"] >= 1,
                  f"gen {i} launches {gen['eval_launches']} {gen['evolve_launches']}")
    gen_ms = [g_["eval_ms"] + g_["evolve_ms"] for g_ in r["generations"]]
    # the round: the top 50 of the last generation, 10 Adam steps (#8/#9)
    pops = r["pops"]
    fitness = gp._evaluate(pops, data)
    flat = pops.map(lambda a: a.reshape((-1,) + a.shape[2:]))
    user_rows = int(((flat.ops >= 2 + 3) & (flat.ops < fset.var_start)).sum())
    top = torch.argsort(fitness.reshape(-1), stable=True)[: gp.coefficient_opt_top_k]
    before = {k: fn.launches for k, fn in counters.items()}
    sync(device)
    t0 = time.perf_counter()
    refined, _ = gp.optimise(flat[top], data)
    sync(device)
    round_ms = (time.perf_counter() - t0) * 1e3
    unrefined = fitness.reshape(-1)[top]
    check(not bool((refined > unrefined * (1 + 1e-6)).any()), "refinement made a candidate worse")
    # the best candidate's trajectories (#3)
    best = flat[int(torch.argmin(fitness.reshape(-1)))]
    cand_fit, pred = SREvaluator(fset=fset, substeps=1).evaluate_candidate(best, data)
    check(pred.shape == (b, t_steps, 2) and bool(torch.isfinite(cand_fit).all()),
          "evaluate_candidate of the best candidate")
    launches = {k: fn.launches - before[k] for k, fn in counters.items()}
    if on_card:
        need = s["gradient_steps"] * (t_steps - 1) * 4  # rk4, one substep: drift calls
        check(launches["interpret_fwd"] >= need and launches["interpret_bwd"] >= need,
              f"round launches {launches} < {need}")
        check(launches["sr_rollout"] >= 1, f"#3 launches {launches}")
    phase_line(f"phase 25 gen with gplearn's protected set ({' '.join(fset.operator_names)}, device ids "
               f"{list(fset.device_op_ids)}, library suffix {fset.variant.suffix}): {s['islands']}x"
               f"{s['pop']} candidates, {user_rows} user rows in the last population, ms per generation "
               f"{[round(v, 3) for v in gen_ms]} (median {statistics.median(gen_ms):.3f}), best "
               f"{[round(v, 6) for v in r['best']]}, loop launches {r['launches']}; round of top "
               f"{top.numel()}: {round_ms:.1f} ms, fitness sum {float(unrefined.sum()):.6g} -> "
               f"{float(refined.sum()):.6g}; then round + evaluate_candidate launches {launches}")
    res = dict(generations=r["generations"], ms_per_generation=gen_ms, loop_launches=r["launches"],
               round=dict(ms=round_ms, unrefined_sum=float(unrefined.sum()),
                          refined_sum=float(refined.sum())), launches=launches, user_rows=user_rows,
               checks={})
    checks = res["checks"]

    # the kernels against their plain versions on the last population: #1 and
    # #3 at T = 10, #5 / #4 at phase 17's cut
    t_fix = s["adaptive_short_t"]
    ts_, ys_ = ts_full[:t_fix], ys_full[:, :t_fix].contiguous()
    mse, alive = (cf.sr_fitness_cuda if on_card else cf.sr_fitness_plain)(
        flat, x0s, ts_, ys_, fset, "rk4", 1)
    (ref, ref_alive), plain_ms = timed_plain(
        lambda: cf.sr_fitness_plain(flat, x0s, ts_, ys_, fset, "rk4", 1), device)
    same = float(lanes_identical(mse, alive, ref, ref_alive).float().mean())
    check(same == 1.0, f"#1 user operators: {same:.6f} of lanes identical")
    fin = torch.isfinite(mse) & torch.isfinite(ref)
    checks["sr_fitness"] = dict(identical=same, alive=float(alive.float().mean()), plain_ms=plain_ms,
                                lanes=alive.numel(), t_steps=t_fix,
                                max_abs_err=float((mse - ref).abs()[fin].max()))
    xs, xalive = (cf.sr_rollout_cuda if on_card else cf.sr_rollout_plain)(flat, x0s, ts_, fset, "rk4", 1)
    (rxs, rxalive), plain_ms = timed_plain(lambda: cf.sr_rollout_plain(flat, x0s, ts_, fset, "rk4", 1),
                                           device)
    same, max_abs = rollout_identical(xs, xalive, rxs, rxalive)
    check(same == 1.0, f"#3 user operators: {same:.6f} of lanes identical")
    checks["sr_rollout"] = dict(identical=same, max_abs_err=max_abs, plain_ms=plain_ms,
                                lanes=xalive[-1].numel(), t_steps=t_fix)
    t_cut = s["deep_adaptive_t"]
    cut = (ts_full[:t_cut], ys_full[:, :t_cut].contiguous())
    for key, kernel, plain, steps_arg in (
            ("sr_adaptive_global", ca.sr_fitness_adaptive_global_cuda, ca.sr_fitness_adaptive_global_plain,
             s["deep_adaptive_budget"]),
            ("sr_adaptive_interval", ca.sr_fitness_adaptive_interval_cuda,
             ca.sr_fitness_adaptive_interval_plain, s["deep_interval_steps"])):
        args = (flat, x0s, *cut, fset, 1e-4, 1e-6, steps_arg, "dopri5", 0.9)
        got = kernel(*args) if on_card else plain(*args)
        want, plain_ms = timed_plain(lambda: plain(*args), device)
        same, _, _, _, max_abs = compare_adaptive(got, want)
        check(same == 1.0, f"{key} user operators: {same:.6f} of lanes identical")
        checks[key] = dict(identical=same, max_abs_err=max_abs, plain_ms=plain_ms, t_steps=t_cut,
                           steps_arg=steps_arg, lanes=got[1].numel())
    for key in ("sr_fitness", "sr_rollout", "sr_adaptive_global", "sr_adaptive_interval"):
        c = checks[key]
        phase_line(f"phase 25 #{dict(sr_fitness=1, sr_rollout=3, sr_adaptive_global=5, sr_adaptive_interval=4)[key]} "
                   f"{key} user operators vs plain on the last population ({c['lanes']} lanes, "
                   f"T={c['t_steps']}): identical {c['identical']:.6f}, max abs {c['max_abs_err']:.3e}, plain "
                   f"{c['plain_ms']:.1f} ms")

    # #8/#9 in the round's layout (its top 50 against the batch's states) and
    # #2 on one generation's lanes of the user-operator population
    gc = torch.Generator(device=device).manual_seed(252)
    c = checks["interpreter_round"] = lanes_check(*shape_case(device, flat[top], b, gc), fset,
                                                  "#8/#9 user operators, the round's layout")
    phase_line(f"phase 25 #8/#9 user operators N={n} vs plain in the round's layout ({c['lanes']} lanes): "
               f"bit-equal {c['bit_equal']}, finite {c['finite']:.4f}, plain {c['plain_ms']:.1f} ms")
    rep = reproduction_case(device, s, pops, fset, gc)
    c = checks["reproduce"] = {k: rep[k] for k in ("lanes", "ops_identical", "max_abs_err", "max_rel",
                                                    "bit_equal")}
    phase_line(f"phase 25 #2 reproduce vs plain with the user set ({c['lanes']} lanes): ops identical "
               f"{c['ops_identical']:.6f}, const max rel {c['max_rel']:.3e}, bit-equal {c['bit_equal']}; "
               f"every child valid")

    # the control workload with the protected division: 5 generations of the
    # static loop (#6, #2)
    env, pdata = ps["env"], ps["data"]
    ys = [f"y{i}" for i in range(env.n_obs)]
    pgp = GeneticProgramming(
        num_generations=s["generations"], population_size=s["pop"],
        fitness_function=StaticPolicyEvaluator(env, substeps=s["policy_substeps"]),
        operator_list=user_policy_operators(), variable_list=[ys], layer_sizes=[1],
        num_populations=s["islands"], max_nodes=s["policy_nodes"], max_init_depth=s["depth"],
        device=device)
    pfset = pgp.fset
    check(pfset.device_op_ids[-1] == USER_FROM, "the control set's / must be a user operator")
    pcounters = dict(policy=cp.policy_rollout_cuda, reproduce=cr.reproduce_lanes_cuda)
    pr = loop_generations(pgp, pdata, device, s["generations"], 250, pcounters)
    if on_card:
        check(all(g_["eval_launches"]["policy"] >= 1 and g_["evolve_launches"]["reproduce"] >= 1
                  for g_ in pr["generations"]), f"policy loop launches {pr['launches']}")
    pgen_ms = [g_["eval_ms"] + g_["evolve_ms"] for g_ in pr["generations"]]
    phase_line(f"phase 25 static Acrobot with {' '.join(pfset.operator_names)} (/ protected): ms per "
               f"generation {[round(v, 3) for v in pgen_ms]} (median {statistics.median(pgen_ms):.3f}), "
               f"best {[round(v, 4) for v in pr['best']]}, launches {pr['launches']}")
    res["policy"] = dict(generations=pr["generations"], ms_per_generation=pgen_ms, launches=pr["launches"])
    pflat = pr["pops"].map(lambda a: a.reshape((-1,) + a.shape[2:]))
    dyn_fset = build_function_set(user_policy_operators(), [ys + ["a0", "a1", "u0"], ["a0", "a1"]],
                                  [2, env.n_control])
    g = torch.Generator(device=device).manual_seed(251)
    from multitreegp_tpu_torch.ops.initialization import make_population_sampler

    dyn_trees = make_population_sampler(dyn_fset, s["depth"], s["policy_nodes"])(
        g, s["islands"] * s["pop"])[0]
    for key, kind, trees_, fset_, state_size, t_cut in (
            ("policy_static", "fixed", pflat, pfset, 0, s["legs_t"]),
            ("policy_dynamic", "fixed", dyn_trees, dyn_fset, 2, s["legs_t"]),
            ("policy_adaptive_static", "adaptive", pflat, pfset, 0, s["trig_adaptive_t"])):
        c = checks[key] = policy_pair(device, kind, trees_, pdata, env, fset_, state_size, t_cut,
                                      substeps=s["policy_substeps"])
        phase_line(f"phase 25 {key} user operators vs plain, T={t_cut}, {c['lanes']} lanes: identical "
                   f"{c['identical']:.6f}, max abs {c['max_abs_err']:.3e}, alive {c['alive']:.4f}, plain "
                   f"{c['plain_ms']:.1f} ms")

    if on_card:
        loaded = [_build.variant_name(k, fset.variant) for k in USER_GEN_KERNELS]
        loaded += [_build.variant_name(k, pfset.variant) for k in USER_CONTROL_KERNELS]
        check(all(k in _build._loaded for k in loaded), f"user builds loaded: {sorted(_build._loaded)}")
        # what the generated code costs: phase 2's trees through the extended
        # library (an unused max appended: / is the table's; with an unused
        # exp too, the instance with the unary rows' code, which the gplearn
        # set's unary operators select) and through the user library (/ the
        # protected division), in turns (#1, #5, #9)
        ys_c = ys_full.contiguous()
        tr_x, fs_x = with_unused_max(trees6, fset6)
        tr_xu, fs_xu = with_unused_max(trees6, fset6, (("max", 2, 0.1), ("exp", 1, 0.1)))
        tr_u, fs_u = with_protected_division(trees6, fset6)
        check(fs_u.has_unary and fs_xu.has_unary and not fs_x.has_unary, "the cost cases' instances")
        bwd = shape_case(device, trees6, b, gc)
        cost = []
        for tag, tr, fs in (("ext", tr_x, fs_x), ("ext_unary", tr_xu, fs_xu), ("user", tr_u, fs_u)):
            ops_b = (tr.map(lambda a: a[:, None]),) + bwd[1:]
            cost.append([
                (f"sr_fitness_{tag}", (lambda tr=tr, fs=fs: cf.sr_fitness_cuda(
                    tr, x0s, ts_full, ys_c, fs, "rk4", 1)), "sr_fitness_kernel"),
                (f"sr_adaptive_global_{tag}", (lambda tr=tr, fs=fs: ca.sr_fitness_adaptive_global_cuda(
                    tr, x0s, ts_full, ys_c, fs, 1e-4, 1e-6, s["adaptive_budget"], "dopri5")),
                 "adaptive_global_kernel"),
                (f"interpret_bwd_{tag}", (lambda ops_b=ops_b, fs=fs: ci.evaluate_trees_vjp_cuda(
                    *ops_b, fs)), "interpret_bwd_kernel")])
        # pairs (ext, user) and (ext_unary, user): each timed a, b, b, a
        times = in_turns([c for ext, xu, user in zip(*cost) for c in (ext, user, xu, user)], 3, torch)
        res["device_ms"] = times
        for key in ("sr_fitness", "sr_adaptive_global", "interpret_bwd"):
            x, xu, u = times[f"{key}_ext"], times[f"{key}_ext_unary"], times[f"{key}_user"]
            phase_line(f"phase 25 {key} phase 2's trees, device ms a launch (extended library with the "
                       f"table's /, user library with the protected /, user, extended): {x[0]:.4f}, "
                       f"{u[0]:.4f}, {u[1]:.4f}, {x[1]:.4f}; (extended library's unary instance, user, "
                       f"user, extended unary): {xu[0]:.4f}, {u[2]:.4f}, {u[3]:.4f}, {xu[1]:.4f}")
        res["nvcc_s"] = {k: v for k, v in _build.build_seconds.items() if "_u" in k}
        phase_line(f"phase 25 user build nvcc seconds (beside the default and extended builds): "
                   f"{res['nvcc_s']}")
    res["seconds"] = time.perf_counter() - t_start
    phase_line(f"phase 25 took {res['seconds']:.1f} s")
    return {"user": res}


VOCAB_GEN_KERNELS = ("sr_fitness", "interpreter", "sr_rollout")  # phase 26's path: #1, #3, #8/#9
SWEEP_STRIDE = 1  # phase 26's forward sweep: every bit pattern
SWEEP_SIDE = 4096  # phase 26's binary grid: 4096 x 4096 plus the edges


def vocabulary_sets():
    """``(gen set, unary sweep set, binary sweep set)`` of phase 26: the
    PySR-style set (``registry.pysr_operators``) over phase 4's variables and
    the two sets of ``registry.vocabulary_operators`` (built before the
    kernels, so that their user libraries are compiled in the parallel
    prelude; traced by this machine's torch, which must refuse none)."""
    from multitreegp_tpu_torch.core.registry import build_function_set, pysr_operators
    from multitreegp_tpu_torch.tools.op_sweep import sweep_sets

    gen = build_function_set(pysr_operators(), [["x0", "x1"]], [2])
    check(gen.refusals == (), f"PySR-style operators refused: {gen.refusals}")
    return (gen,) + sweep_sets()


def with_vocabulary_set(trees, fset):
    """``(trees, fset)`` of phase 2's ``+ - * /`` trees in the PySR-style set,
    whose first four operators are ``+ - * /`` (variable opcodes shift past
    its seven user operators, which no tree uses): the same trees through
    its user library, which holds the vocabulary's code."""
    import torch

    from multitreegp_tpu_torch.core.registry import build_function_set, pysr_operators

    vocab = build_function_set(pysr_operators(), [list(fset.variable_names)], list(fset.layer_sizes))
    check(vocab.operator_names[:4] == fset.operator_names and vocab.variable_names == fset.variable_names,
          "the PySR-style set's first operators are + - * /")
    shift = vocab.var_start - fset.var_start
    return trees._replace(ops=torch.where(trees.ops >= fset.var_start, trees.ops + shift, trees.ops)), vocab


def vocabulary_phase(device, s, data, trees6, fset6) -> dict:
    """Phase 26: the emitter's vocabulary (``registry.vocabulary_operators``,
    traced by this torch) on the card. #8/#9 through the two sweep sets' user
    build against PyTorch's own CUDA ops (``tools/op_sweep``): each unary
    operator on every ``SWEEP_STRIDE``-th of the 2^32 float32 bit patterns
    (equal bits, NaN as NaN), its VJP on every 256th with the cotangent 1
    and a normal one (equal values); the binary ones on a ``SWEEP_SIDE``
    square grid stratified by exponent plus the edges. Then the main path
    with the PySR-style set: phase 4's ``gen`` workload, 5 generations (#1,
    #2), a round of the top 50 (#8/#9) and ``evaluate_candidate`` (#3),
    every launch counted between zeroed counters; on the last population #1,
    #3 and #8/#9 against their plain versions, every lane identical; #1's
    device time on phase 2's trees through the vocabulary's library and
    through ``_ext``, in turns (``trees6``, ``fset6``: phase 2's population)."""
    import torch

    from multitreegp_tpu_torch import GeneticProgramming, _build
    from multitreegp_tpu_torch.core import cuda_interpreter as ci
    from multitreegp_tpu_torch.core import cuda_reproduction as cr
    from multitreegp_tpu_torch.core import cuda_rollout as cf
    from multitreegp_tpu_torch.core.registry import pysr_operators
    from multitreegp_tpu_torch.core.trees import validate_host
    from multitreegp_tpu_torch.models.evaluators import SREvaluator
    from multitreegp_tpu_torch.tools import op_sweep

    t_start = time.perf_counter()
    on_card = device.type == "cuda"
    x0s, ts_full, ys_full, _ = data
    n, b, t_steps = s["max_nodes"], s["batch"], ts_full.shape[0]
    _, unary_set, binary_set = vocabulary_sets()
    res = dict(torch=torch.__version__, sweep={}, checks={})

    # the sweep (checks: these launches are not the main path's)
    if on_card:
        for fset in (unary_set, binary_set):
            for r in op_sweep.sweep_set(fset, device, SWEEP_STRIDE, SWEEP_SIDE):
                res["sweep"][r["name"]] = r
                vjp = " ".join(f"{k} {v['mismatches']} (zero sign {v['zero_sign']})" for k, v in r["vjp"].items())
                phase_line(f"phase 26 sweep {r['name']}: {r['lanes']} lanes, mismatches {r['mismatches']} "
                           f"{r['first']}; VJP on {r['vjp_lanes']}: {vjp}; {r['s']:.2f} s")
        bad = {k: (r["first"], r["vjp"]) for k, r in res["sweep"].items() if not r["ok"]}
        check(not bad, f"phase 26 sweep mismatches: {bad}")
        check(len(res["sweep"]) == unary_set.num_operators + binary_set.num_operators,
              f"phase 26 swept {len(res['sweep'])} operators")
    res["sweep_s"] = time.perf_counter() - t_start

    # the main path with the PySR-style set
    gp = GeneticProgramming(
        num_generations=s["generations"], population_size=s["pop"],
        fitness_function=SREvaluator(substeps=1), operator_list=pysr_operators(),
        variable_list=[["x0", "x1"]], layer_sizes=[2], num_populations=s["islands"], max_nodes=n,
        max_init_depth=s["depth"], gradient_steps=s["gradient_steps"],
        coefficient_opt_top_k=s["top_k"], elite_percentage=s["elite"], device=device)
    fset = gp.fset
    check(fset.refusals == () and fset.user_hash != "", f"phase 26's set: {fset.refusals}")
    counters = dict(sr_fitness=cf.sr_fitness_cuda, reproduce=cr.reproduce_lanes_cuda,
                    interpret_fwd=ci.evaluate_trees_cuda, interpret_bwd=ci.evaluate_trees_vjp_cuda,
                    sr_rollout=cf.sr_rollout_cuda)
    validate = lambda pops: validate_host(pops.map(lambda a: a.reshape(-1, n)), fset.slots(device))
    r = loop_generations(gp, data, device, s["generations"], 26, counters, validate)
    pops = r["pops"]
    fitness = gp._evaluate(pops, data)
    flat = pops.map(lambda a: a.reshape((-1,) + a.shape[2:]))
    user_rows = int(((flat.ops >= 2 + 4) & (flat.ops < fset.var_start)).sum())
    top = torch.argsort(fitness.reshape(-1), stable=True)[: gp.coefficient_opt_top_k]
    sync(device)
    t0 = time.perf_counter()
    refined, _ = gp.optimise(flat[top], data)
    sync(device)
    round_ms = (time.perf_counter() - t0) * 1e3
    unrefined = fitness.reshape(-1)[top]
    check(not bool((refined > unrefined * (1 + 1e-6)).any()), "refinement made a candidate worse")
    best = flat[int(torch.argmin(fitness.reshape(-1)))]
    cand_fit, pred = SREvaluator(fset=fset, substeps=1).evaluate_candidate(best, data)
    check(pred.shape == (b, t_steps, 2) and bool(torch.isfinite(cand_fit).all()),
          "evaluate_candidate of the best candidate")
    launches = {k: fn.launches for k, fn in counters.items()}  # zeroed by loop_generations
    if on_card:
        check(all(v >= 1 for v in launches.values()), f"phase 26 path launches {launches}")
        need = s["gradient_steps"] * (t_steps - 1) * 4  # rk4, one substep: drift calls
        check(launches["interpret_fwd"] >= need and launches["interpret_bwd"] >= need,
              f"phase 26 round launches {launches} < {need}")
    gen_ms = [g_["eval_ms"] + g_["evolve_ms"] for g_ in r["generations"]]
    phase_line(f"phase 26 gen with the PySR-style set ({' '.join(fset.operator_names)}, device ids "
               f"{list(fset.device_op_ids)}, library suffix {fset.variant.suffix}): {s['islands']}x"
               f"{s['pop']} candidates, {user_rows} user rows in the last population, ms per generation "
               f"{[round(v, 3) for v in gen_ms]} (median {statistics.median(gen_ms):.3f}), best "
               f"{[round(v, 6) for v in r['best']]}; round of top {top.numel()}: {round_ms:.1f} ms, "
               f"fitness sum {float(unrefined.sum()):.6g} -> {float(refined.sum()):.6g}; launches on the "
               f"path (loop, round, evaluate_candidate) {launches}")
    res.update(generations=r["generations"], ms_per_generation=gen_ms, launches=launches,
               user_rows=user_rows, round=dict(ms=round_ms, unrefined_sum=float(unrefined.sum()),
                                               refined_sum=float(refined.sum())))

    # #1 and #3 against their plain versions on the last population at T = 10,
    # #8/#9 in the round's layout
    checks = res["checks"]
    t_fix = s["adaptive_short_t"]
    ts_, ys_ = ts_full[:t_fix], ys_full[:, :t_fix].contiguous()
    mse, alive = (cf.sr_fitness_cuda if on_card else cf.sr_fitness_plain)(flat, x0s, ts_, ys_, fset, "rk4", 1)
    (ref, ref_alive), plain_ms = timed_plain(
        lambda: cf.sr_fitness_plain(flat, x0s, ts_, ys_, fset, "rk4", 1), device)
    same = float(lanes_identical(mse, alive, ref, ref_alive).float().mean())
    check(same == 1.0, f"#1 vocabulary: {same:.6f} of lanes identical")
    fin = torch.isfinite(mse) & torch.isfinite(ref)
    checks["sr_fitness"] = dict(identical=same, alive=float(alive.float().mean()), plain_ms=plain_ms,
                                lanes=alive.numel(), t_steps=t_fix,
                                max_abs_err=float((mse - ref).abs()[fin].max()))
    xs, xalive = (cf.sr_rollout_cuda if on_card else cf.sr_rollout_plain)(flat, x0s, ts_, fset, "rk4", 1)
    (rxs, rxalive), plain_ms = timed_plain(lambda: cf.sr_rollout_plain(flat, x0s, ts_, fset, "rk4", 1),
                                           device)
    same, max_abs = rollout_identical(xs, xalive, rxs, rxalive)
    check(same == 1.0, f"#3 vocabulary: {same:.6f} of lanes identical")
    checks["sr_rollout"] = dict(identical=same, max_abs_err=max_abs, plain_ms=plain_ms,
                                lanes=xalive[-1].numel(), t_steps=t_fix)
    gc = torch.Generator(device=device).manual_seed(262)
    checks["interpreter_round"] = lanes_check(*shape_case(device, flat[top], b, gc), fset,
                                              "#8/#9 vocabulary, the round's layout")
    for key in ("sr_fitness", "sr_rollout", "interpreter_round"):
        c = checks[key]
        phase_line(f"phase 26 {key} vocabulary vs plain on the last population ({c['lanes']} lanes"
                   f"{', T=' + str(c['t_steps']) if 't_steps' in c else ''}): identical "
                   f"{c.get('identical', c.get('bit_equal'))}, max abs {c['max_abs_err']:.3e}, plain "
                   f"{c['plain_ms']:.1f} ms")

    if on_card:
        check(all(_build.variant_name(k, fset.variant) in _build._loaded for k in VOCAB_GEN_KERNELS),
              f"vocabulary builds loaded: {sorted(_build._loaded)}")
        # #1 on phase 2's trees through _ext (an unused max appended; with an
        # unused exp too, its unary instance) and through the vocabulary's
        # library, in turns
        ys_c = ys_full.contiguous()
        tr_x, fs_x = with_unused_max(trees6, fset6)
        tr_xu, fs_xu = with_unused_max(trees6, fset6, (("max", 2, 0.1), ("exp", 1, 0.1)))
        tr_v, fs_v = with_vocabulary_set(trees6, fset6)
        fit = lambda tr, fs: (lambda: cf.sr_fitness_cuda(tr, x0s, ts_full, ys_c, fs, "rk4", 1))
        cases = [("sr_fitness_ext", fit(tr_x, fs_x), "sr_fitness_kernel"),
                 ("sr_fitness_vocab", fit(tr_v, fs_v), "sr_fitness_kernel"),
                 ("sr_fitness_ext_unary", fit(tr_xu, fs_xu), "sr_fitness_kernel"),
                 ("sr_fitness_vocab", fit(tr_v, fs_v), "sr_fitness_kernel")]
        times = res["device_ms"] = in_turns(cases, 3, torch)
        x, xu, v = times["sr_fitness_ext"], times["sr_fitness_ext_unary"], times["sr_fitness_vocab"]
        phase_line(f"phase 26 #1 phase 2's trees, device ms a launch (_ext, vocabulary library, vocabulary, "
                   f"_ext): {x[0]:.4f}, {v[0]:.4f}, {v[1]:.4f}, {x[1]:.4f}; (_ext unary, vocabulary, "
                   f"vocabulary, _ext unary): {xu[0]:.4f}, {v[2]:.4f}, {v[3]:.4f}, {xu[1]:.4f}")
        libs = [_build.variant_name(k, v_.variant) for k, v_ in
                [(k, fset) for k in VOCAB_GEN_KERNELS] + [("interpreter", unary_set), ("interpreter", binary_set)]]
        res["nvcc_s"] = {k: _build.build_seconds.get(k) for k in libs}
        phase_line(f"phase 26 vocabulary builds' nvcc seconds (beside the other builds): {res['nvcc_s']}")
    res["seconds"] = time.perf_counter() - t_start
    phase_line(f"phase 26 took {res['seconds']:.1f} s (the sweep {res['sweep_s']:.1f} s)")
    return {"vocabulary": res}


# phase 27: a system of 40 states, and a set of 33 operators
def lorenz96_data(device, s, seed=27):
    """``(x0s, ts, ys, None)``: Lorenz-96 (Lorenz 1996), ``dx_i/dt = (x_{i+1}
    - x_{i-2}) x_{i-1} - x_i + F`` with ``s["lorenz_states"]`` states and F =
    ``s["lorenz_forcing"]``, ``s["batch"]`` trajectories from ``x0 ~ F +
    N(0, 1)`` (numpy, ``seed``), integrated in float64 by RK4 at a tenth of
    the save step and saved as many times as the main path's grid has points,
    ``s["lorenz_dt"]`` apart (0.05, the usual step of this system: at the
    main path's 0.2, RK4 x 1 diverges on Lorenz-96 itself); float32 on
    ``device``. Test data, made here, not an environment of the package."""
    import numpy as np
    import torch

    rng = np.random.default_rng(seed)
    f = s["lorenz_forcing"]
    x = f + rng.normal(size=(s["batch"], s["lorenz_states"]))

    def drift(v):
        return (np.roll(v, -1, -1) - np.roll(v, 2, -1)) * np.roll(v, 1, -1) - v + f

    ts = np.arange(round(s["horizon"] / s["dt"])) * s["lorenz_dt"]
    sub, h = 10, s["lorenz_dt"] / 10
    ys = [x]
    for _ in range((ts.shape[0] - 1) * sub):
        k1 = drift(x)
        k2 = drift(x + h / 2 * k1)
        k3 = drift(x + h / 2 * k2)
        x = x + h / 6 * (k1 + 2 * k2 + 2 * k3 + drift(x + h * k3))
        ys.append(x)
    ys = np.stack(ys[::sub], 1).astype(np.float32)
    as_t = lambda a: torch.from_numpy(np.ascontiguousarray(a)).to(device)
    return as_t(ys[:, 0]), as_t(ts.astype(np.float32)), as_t(ys), None


def many_operators():
    """Phase 27's 33 operators: the 17 of the table (``+ - * /`` at the main
    path's probabilities, the rest 0.1) and the first 16 unary callables of
    ``registry.vocabulary_operators()`` (user operators, ids 17-32), at 0.1."""
    from multitreegp_tpu_torch.core.registry import DEVICE_OPS, vocabulary_operators

    binary = ("+", "-", "*", "/", "pow", "max", "min")
    table = OPERATORS + [(name, 2 if name in binary else 1, 0.1) for name in DEVICE_OPS
                         if name not in ("+", "-", "*", "/")]
    return table + [(name, fn, 1, 0.1) for name, fn, _ in vocabulary_operators()[0][:16]]


def many_operator_set():
    """The function set of :func:`many_operators` (traced before the kernels
    are built, so that its user library is compiled in the parallel
    prelude)."""
    from multitreegp_tpu_torch.core.registry import build_function_set

    return build_function_set(many_operators(), [["x0", "x1"]], [2])


def many_phase(device, s, data, trees2, fset2) -> dict:
    """Phase 27: the SR kernels past four states and 1024 trajectories, and
    the interpreter past 32 variables and past 32 operators. Lorenz-96 with
    40 states (:func:`lorenz96_data`): 40 trees a candidate of
    ``max_nodes=32``, ``+ - * /``, grown to depth 2 (deeper random trees
    diverge on nearly every lane), 8 x 512 candidates x 16 trajectories,
    T = 50 saves 0.05 apart, RK4 x 1: the SR evaluator's fused path through
    #1's wide instance (one launch an evaluation, no #8), the fused
    reproduction (#2), 3 generations, then one round of the top 50 (10 Adam
    steps; the recompute's #8/#9 on 32,000 lanes a call); #8/#9 against
    their plain versions at the evaluation's and the round's shapes; the
    wide-state kernels on the last population (:func:`wide_state_phase`);
    VdP at 2,048 trajectories (:func:`trajectories_phase`). Then phase 4's
    VdP workload with the 33 operators of :func:`many_operators` through the
    general path (``interpreter="gather"``: the round runs #8/#9 alone, in
    the wide instance of the set's user build): one evaluation of 8 x 512
    candidates and one round of the top 50. #8/#9 against their plain
    versions, every lane bit-equal, at each workload's evaluation and round
    shapes, with events, device time and bounds."""
    import torch

    from multitreegp_tpu_torch import GeneticProgramming, _build
    from multitreegp_tpu_torch.core import cuda_adaptive as ca
    from multitreegp_tpu_torch.core import cuda_interpreter as ci
    from multitreegp_tpu_torch.core import cuda_reproduction as cr
    from multitreegp_tpu_torch.core import cuda_rollout as cf
    from multitreegp_tpu_torch.models.evaluators import SREvaluator

    t0 = time.perf_counter()
    b, n = s["batch"], s["max_nodes"]
    counters = dict(sr_fitness=cf.sr_fitness_cuda, reproduce=cr.reproduce_lanes_cuda,
                    interpret_fwd=ci.evaluate_trees_cuda, interpret_bwd=ci.evaluate_trees_vjp_cuda,
                    sr_fitness_wide=cf.sr_fitness_wide_cuda, sr_rollout_wide=cf.sr_rollout_wide_cuda,
                    sr_adaptive_global_wide=ca.sr_fitness_adaptive_global_wide_cuda,
                    sr_adaptive_interval_wide=ca.sr_fitness_adaptive_interval_wide_cuda)
    names = [f"x{i}" for i in range(s["lorenz_states"])]
    lorenz = lorenz96_data(device, s)
    t_steps = lorenz[1].shape[0]
    gp = GeneticProgramming(
        num_generations=s["wide_generations"], population_size=s["pop"],
        fitness_function=SREvaluator(substeps=1), operator_list=OPERATORS, variable_list=[names],
        layer_sizes=[len(names)], num_populations=s["islands"], max_nodes=n,
        max_init_depth=s["lorenz_depth"], gradient_steps=s["gradient_steps"],
        coefficient_opt_top_k=s["top_k"], elite_percentage=s["elite"], device=device)
    check(gp.fused_reproduction, "Lorenz-96 at max_nodes=32 takes the fused reproduction")
    r = loop_generations(gp, lorenz, device, s["wide_generations"], 27, counters)
    res = round_phase(gp, r["pops"], lorenz, device, counters, t_steps, "phase 27 Lorenz-96")
    if device.type == "cuda":
        for i, gen in enumerate(r["generations"]):
            ev, evo = gen["eval_launches"], gen["evolve_launches"]
            check(ev["sr_fitness_wide"] == 1 and ev["interpret_fwd"] == 0 and ev["sr_fitness"] == 0
                  and evo["reproduce"] >= 1, f"Lorenz-96 gen {i} launches {ev} {evo}")
    for i, gen in enumerate(r["generations"]):
        phase_line(f"phase 27 Lorenz-96 ({len(names)} states, {s['islands']}x{s['pop']} candidates of "
                   f"{len(names)} trees) gen {i}: eval {gen['eval_ms']:.3f} ms, evolve {gen['evolve_ms']:.3f} ms, "
                   f"best fitness {gen['best']:.6g}; launches in evaluate {gen['eval_launches']}, in evolve "
                   f"{gen['evolve_launches']}")
    flat, top = res.pop("flat"), res.pop("top")
    x0s = lorenz[0]
    cases = {"population": (shape_case(device, flat, b, None, x0s), True),
             "round": (shape_case(device, flat[top], b, None, x0s), True)}
    checks = {}
    for key, (case, vjp) in cases.items():
        checks[key] = c = lanes_check(*case, gp.fset, f"Lorenz-96 #8/#9 {key}", vjp=vjp)
        phase_line(f"phase 27 Lorenz-96 #8/#9 {key} vs plain ({c['lanes']} lanes, {c['members']} a tree, "
                   f"{len(names)} variables): bit-equal {c['bit_equal']}, finite {c['finite']:.4f}, plain "
                   f"{c['plain_ms']:.1f} ms")
    res.update(generations=r["generations"], launches=r["launches"], checks=checks, states=len(names))
    if device.type == "cuda":
        res["times"] = interpreter_case_times(s, cases, checks, gp.fset, "phase 27 Lorenz-96")
    res["wide_state"] = wide_state_phase(device, s, gp, flat, lorenz, counters)
    res["wide_state"]["kernels"]["sr_fitness_wide"]["launches"] = (
        r["launches"]["sr_fitness_wide"] + res["round"]["launches"]["sr_fitness_wide"])
    out = {"lorenz96": res, "trajectories": trajectories_phase(device, s, trees2, fset2, data, counters)}

    # the 33-operator round on the VdP workload, through the general path
    gp = GeneticProgramming(
        num_generations=1, population_size=s["pop"],
        fitness_function=SREvaluator(substeps=1, interpreter="gather"), operator_list=many_operators(),
        variable_list=[["x0", "x1"]], layer_sizes=[2], num_populations=s["islands"], max_nodes=n,
        max_init_depth=s["depth"], gradient_steps=s["gradient_steps"],
        coefficient_opt_top_k=s["top_k"], elite_percentage=s["elite"], device=device)
    fset = gp.fset
    check(fset.num_operators == 33 and not fset.refusals, f"the 33-operator set: {fset.refusals}")
    t_steps = data[1].shape[0]
    pops = gp.initialize_population(torch.Generator(device=device).manual_seed(270))
    before = {k: fn.launches for k, fn in counters.items()}
    sync(device)
    t1 = time.perf_counter()
    fitness = gp._evaluate(pops, data)
    sync(device)
    eval_ms = (time.perf_counter() - t1) * 1e3
    ev = {k: fn.launches - before[k] for k, fn in counters.items()}
    check(bool(torch.isfinite(fitness).all()), "33 operators: non-finite fitness")
    if device.type == "cuda":
        check(ev["interpret_fwd"] >= (t_steps - 1) * 4 and ev["sr_fitness"] == 0, f"33 operators: launches {ev}")
        check(_build.variant_name("interpreter", fset.variant) in _build._loaded, "33 operators: user build")
    res = round_phase(gp, pops, data, device, counters, t_steps, "phase 27 33 operators")
    flat, top = res.pop("flat"), res.pop("top")
    user_rows = int(((flat.ops >= 2 + 17) & (flat.ops < fset.var_start)).sum())
    phase_line(f"phase 27 33 operators ({' '.join(fset.operator_names)}; device ids {list(fset.device_op_ids)}): "
               f"{s['islands']}x{s['pop']} candidates, {user_rows} user rows, evaluation {eval_ms:.1f} ms, "
               f"launches {ev}, best {float(fitness.min()):.6g}")
    g = torch.Generator(device=device).manual_seed(271)
    cases = {"round": (shape_case(device, flat[top], b, g), True)}
    checks = {"round": lanes_check(*cases["round"][0], fset, "33 operators #8/#9 round")}
    c = checks["round"]
    phase_line(f"phase 27 33 operators #8/#9 round vs plain ({c['lanes']} lanes): bit-equal {c['bit_equal']}, "
               f"finite {c['finite']:.4f}, plain {c['plain_ms']:.1f} ms")
    res.update(generations=[dict(eval_ms=eval_ms, eval_launches=ev)], checks=checks, user_rows=user_rows,
               device_op_ids=list(fset.device_op_ids))
    if device.type == "cuda":
        res["times"] = interpreter_case_times(s, cases, checks, fset, "phase 27 33 operators")
    out["ops33"] = res
    out["lorenz96"]["seconds"] = out["ops33"]["seconds"] = time.perf_counter() - t0
    phase_line(f"phase 27 took {time.perf_counter() - t0:.1f} s")
    return out


def spearman(a, b) -> float:
    """Spearman's rank correlation of two 1-d tensors (ties ranked in
    order)."""
    import torch

    ra, rb = (torch.argsort(torch.argsort(x, stable=True)).double() for x in (a, b))
    ra, rb = ra - ra.mean(), rb - rb.mean()
    return float((ra * rb).sum() / (ra.norm() * rb.norm()).clamp(min=1e-30))


def zeroed(counters) -> dict:
    """Every counter set to 0 (before the path it reads)."""
    for fn in counters.values():
        fn.launches = 0
    return counters


def counted_run(fn, counters, device):
    """``(fn(), host ms, {name: launches})``: every counter zeroed before the
    call and read after it."""
    zeroed(counters)
    sync(device)
    t0 = time.perf_counter()
    value = fn()
    sync(device)
    return value, (time.perf_counter() - t0) * 1e3, {k: c.launches for k, c in counters.items()}


def wide_state_phase(device, s, gp, flat, lorenz, counters) -> dict:
    """Phase 27's wide-state kernels on Lorenz-96's last population (40
    states, 4096 candidates x 16 trajectories): one evaluation through the
    fused path (#1 wide) beside one through the general path
    (``interpreter="gather"``: the integrator and #8), judged as ROADMAP.md's
    rule for long chaotic rollouts (clamp agreement, survivor Spearman >=
    0.997); #1 (RK4), #3 (RK4), #5 and #4 (dopri5) wide against their plain
    versions on every lane at the cut horizon ``wide_check_t`` (#5's budget
    ``wide_check_budget``, #4's ``wide_check_interval_steps``); the same
    population under ``method="adaptive"`` (dopri5, budget
    ``adaptive_budget``: #5 wide), ``adaptive_solver_stats`` (T =
    ``adaptive_short_t``, ``adaptive_interval_steps`` per interval: #4 wide)
    and ``evaluate_candidate`` of the best (#3 wide), every launch counted
    between zeroed counters; each wide kernel's events, device time per
    launch and bound at its path's shape."""
    import torch

    from multitreegp_tpu_torch.core import cuda_adaptive as ca
    from multitreegp_tpu_torch.core import cuda_rollout as cf
    from multitreegp_tpu_torch.models.evaluators import SREvaluator

    on_card = device.type == "cuda"
    fset, ev = gp.fset, gp.evaluator
    x0s, ts, ys, _ = lorenz
    p, d, t_steps = flat.ops.shape[0], x0s.shape[1], ts.shape[0]
    top = ev.max_fitness

    counted = lambda fn: counted_run(fn, counters, device)

    # the fused path against the general one on the same population
    fused, fused_ms, l_fused = counted(lambda: ev.evaluate_population(flat, lorenz))
    general_ev = SREvaluator(fset, top, substeps=ev.substeps, interpreter="gather")
    general, general_ms, l_general = counted(lambda: general_ev.evaluate_population(flat, lorenz))
    if on_card:
        check(l_fused["sr_fitness_wide"] == 1 and l_fused["interpret_fwd"] == 0, f"fused {l_fused}")
        check(l_general["sr_fitness_wide"] == 0 and l_general["interpret_fwd"] >= (t_steps - 1) * 4,
              f"general {l_general}")
    clamp = float(((fused >= top) == (general >= top)).float().mean())
    surv = (fused < top) & (general < top)
    rho = spearman(fused[surv], general[surv]) if int(surv.sum()) > 1 else 1.0
    rel = ((fused - general).abs() / general.abs().clamp(min=1e-30))[surv]
    out = dict(fused_vs_general=dict(
        candidates=p, clamp_agreement=clamp, survivors=int(surv.sum()), spearman=rho,
        max_rel=float(rel.max()) if rel.numel() else 0.0, fused_ms=fused_ms, general_ms=general_ms,
        launches_fused=l_fused, launches_general=l_general))
    check(clamp >= 0.999 and rho >= 0.997, f"Lorenz-96 fused vs general: {out['fused_vs_general']}")
    phase_line(f"phase 27 Lorenz-96 fused (#1 wide) vs general path (#8) on {p} candidates: clamp agreement "
               f"{clamp:.6f}, {int(surv.sum())} survivors, Spearman {rho:.6f}, max rel {out['fused_vs_general']['max_rel']:.3e}; "
               f"evaluation {fused_ms:.1f} ms fused, {general_ms:.1f} ms general")

    # the wide kernels against their plain versions at the cut horizon
    t_cut = s["wide_check_t"]
    tc, yc = ts[:t_cut], ys[:, :t_cut].contiguous()
    budget, per_interval = s["wide_check_budget"], s["wide_check_interval_steps"]
    a5 = (flat, x0s, tc, yc, fset, 1e-4, 1e-6, budget, "dopri5", 0.9)
    a4 = (flat, x0s, tc, yc, fset, 1e-4, 1e-6, per_interval, "dopri5", 0.9)
    pairs = dict(
        sr_fitness_wide=(lambda: cf.sr_fitness_wide_cuda(flat, x0s, tc, yc, fset, "rk4", 1),
                         lambda: cf.sr_fitness_plain(flat, x0s, tc, yc, fset, "rk4", 1)),
        sr_rollout_wide=(lambda: cf.sr_rollout_wide_cuda(flat, x0s, tc, fset, "rk4", 1),
                         lambda: cf.sr_rollout_plain(flat, x0s, tc, fset, "rk4", 1)),
        sr_adaptive_global_wide=(lambda: ca.sr_fitness_adaptive_global_wide_cuda(*a5),
                                 lambda: ca.sr_fitness_adaptive_global_plain(*a5)),
        sr_adaptive_interval_wide=(lambda: ca.sr_fitness_adaptive_interval_wide_cuda(*a4),
                                   lambda: ca.sr_fitness_adaptive_interval_plain(*a4)))
    kernels = {}
    for name, (kernel, plain) in pairs.items():
        got = kernel() if on_card else plain()
        ref, plain_ms = timed_plain(plain, device)
        if name == "sr_fitness_wide":
            same = float(lanes_identical(*got, *ref).float().mean())
            fin = torch.isfinite(got[0]) & torch.isfinite(ref[0])
            max_abs = float((got[0] - ref[0]).abs()[fin].max()) if bool(fin.any()) else 0.0
        elif name == "sr_rollout_wide":
            same, max_abs = rollout_identical(*got, *ref)
        else:
            same, _, _, _, max_abs = compare_adaptive(got, ref)
        check(same == 1.0, f"{name} vs plain at T={t_cut}: {same:.6f} of lanes identical")
        kernels[name] = dict(check=dict(identical=same, t_steps=t_cut, lanes=p * x0s.shape[0]),
                             max_abs_err=max_abs, plain_ms=plain_ms, plain_t_steps=t_cut)
        phase_line(f"phase 27 {name} vs plain, d={d}, T={t_cut}, {p * x0s.shape[0]} lanes: identical {same:.6f}, "
                   f"max abs {max_abs:.3e}, plain {plain_ms:.1f} ms")

    # the paths that launch #5, #4 and #3 wide
    ev_ad = SREvaluator(fset, top, substeps=ev.substeps, method="adaptive", adaptive_method="dopri5",
                        adaptive_budget=s["adaptive_budget"])
    fit_ad, ad_ms, l_ad = counted(lambda: ev_ad.evaluate_population(flat, lorenz))
    t_short = s["adaptive_short_t"]
    ts_s, ys_s = ts[:t_short], ys[:, :t_short].contiguous()
    stats, stats_ms, l_stats = counted(lambda: ca.adaptive_solver_stats(
        flat, x0s, ts_s, ys_s, fset, max_steps=s["adaptive_interval_steps"], method="dopri5"))
    best = int(torch.argmin(fused))
    cand = flat[best:best + 1]
    (cand_fit, _), cand_ms, l_cand = counted(lambda: ev.evaluate_candidate(flat[best], lorenz))
    check(bool(torch.isfinite(fit_ad).all()) and bool(((fit_ad >= 0) & (fit_ad <= top)).all()),
          "adaptive Lorenz-96 fitness outside [0, max]")
    if on_card:
        check(l_ad["sr_adaptive_global_wide"] == 1 and l_ad["interpret_fwd"] == 0, f"adaptive {l_ad}")
        check(l_stats["sr_adaptive_interval_wide"] == 1, f"solver stats {l_stats}")
        check(l_cand["sr_rollout_wide"] == 1 and l_cand["interpret_fwd"] == 0, f"evaluate_candidate {l_cand}")
    kernels["sr_fitness_wide"]["launches"] = None  # the loop's and round's, set by the caller
    kernels["sr_adaptive_global_wide"]["launches"] = l_ad["sr_adaptive_global_wide"]
    kernels["sr_adaptive_interval_wide"]["launches"] = l_stats["sr_adaptive_interval_wide"]
    kernels["sr_rollout_wide"]["launches"] = l_cand["sr_rollout_wide"]
    phase_line(f"phase 27 Lorenz-96 adaptive (dopri5, budget {s['adaptive_budget']}): evaluation {ad_ms:.1f} ms, "
               f"best {float(fit_ad.min()):.6g}, launches {l_ad}; solver stats T={t_short}: {stats_ms:.1f} ms, "
               f"attempted steps per lane max {int(stats[2].max())}; evaluate_candidate of the best "
               f"({float(fused[best]):.6g}): {cand_ms:.1f} ms, launches {l_cand}")

    # each wide kernel at its path's shape: events, device time, bound
    rows = ((flat.ops >= 2) & (flat.ops < fset.var_start)).sum(dim=(1, 2))
    fit_args = (flat, x0s, ts, ys, fset, "rk4", 1)
    mse, alive = (cf.sr_fitness_wide_cuda if on_card else cf.sr_fitness_plain)(*fit_args)
    steps1 = torch.where(alive, t_steps - 1, 1)
    shapes = dict(
        sr_fitness_wide=(lambda: cf.sr_fitness_wide_cuda(*fit_args), "sr_fitness_wide_kernel", t_steps,
                         bound(nbytes(flat.ops, flat.const, x0s, ts, ys) + alive.numel() * 5,
                               float((steps1 * (4 * rows[:, None] + 16 * d)).sum()))),
        sr_rollout_wide=(lambda: cf.sr_rollout_wide_cuda(cand, x0s, ts, fset, "rk4", 1),
                         "sr_rollout_wide_kernel", t_steps, None),
        sr_adaptive_global_wide=(lambda: ca.sr_fitness_adaptive_global_wide_cuda(
            flat, x0s, ts, ys, fset, budget=s["adaptive_budget"]), "adaptive_global_wide_kernel", t_steps, None),
        sr_adaptive_interval_wide=(lambda: ca.sr_fitness_adaptive_interval_wide_cuda(
            flat, x0s, ts_s, ys_s, fset, max_steps=s["adaptive_interval_steps"], method="dopri5"),
            "adaptive_interval_wide_kernel", t_short, None))
    for name, (fn, kernel, t, bnd) in shapes.items():
        k = kernels[name]
        k.update(t_steps=t, ms=None, device_ms=None)
        if name == "sr_rollout_wide":
            xs, r_alive = (fn() if on_card else cf.sr_rollout_plain(cand, x0s, ts, fset, "rk4", 1))
            bnd = bound(nbytes(cand.ops, cand.const, x0s, ts, xs) + r_alive[-1].numel(),
                        rollout_ops(cand, fset, r_alive[-1], t, d))
            k["shape"] = "inspection: one candidate x 16"
        elif name.startswith("sr_adaptive"):
            got = fn() if on_card else (ca.sr_fitness_adaptive_global_plain(flat, x0s, ts, ys, fset, budget=s["adaptive_budget"])
                                        if "global" in name else stats)
            tt = ts if "global" in name else ts_s
            bnd = bound(nbytes(flat.ops, flat.const, x0s, tt, ys[:, :t]) + got[1].numel() * 9,
                        adaptive_ops(flat, fset, got[2], d, t))
            k.update(steps_max=int(got[2].max()), steps_total=int(got[2].sum()),
                     alive=float(got[1].float().mean()))
        k["bound"] = bnd
        if on_card:  # #5's budget-long launches (~0.6 s each) timed over fewer runs
            runs = 2 if name == "sr_adaptive_global_wide" else s["timing_runs"]
            k["ms"] = cuda_time_ms(fn, runs, torch)
            k["device_ms"] = kernel_device_ms(((name, fn, kernel),), runs, torch)[name]
        phase_line(f"phase 27 {name} at T={t}: " + (f"{k['ms']:.4f} ms events, device {k['device_ms']:.4f} ms, "
                                                   if on_card else "") + f"bound {bnd[0]:.6f} ms ({bnd[1]})")
    return dict(out, kernels=kernels, adaptive=dict(ms=ad_ms, launches=l_ad, best=float(fit_ad.min())),
                solver_stats=dict(ms=stats_ms, launches=l_stats, steps_max=int(stats[2].max())),
                candidate=dict(ms=cand_ms, launches=l_cand, fitness=float(cand_fit.mean())))


def trajectories_phase(device, s, trees, fset, data, counters) -> dict:
    """Phase 27, past 1024 trajectories: phase 2's population (the main
    path's 8 x 512 VdP candidates of 2 trees) on ``wide_batch`` (2,048) VdP
    trajectories over the main path's grid, one ``evaluate_population``
    (#1's wide instance at d = 2, one launch), #1 wide against its plain
    version on every lane at ``wide_check_t``, its events and device time
    at T = 50 beside its bound; and on the main path's 16 trajectories the
    wide instance against the fixed one (its instance of the main path) at
    d = 2: every lane bit-equal, device time in turns (fixed, wide, wide,
    fixed), the cost of the wide form where the fixed one runs."""
    import torch

    from multitreegp_tpu_torch.core import cuda_rollout as cf
    from multitreegp_tpu_torch.models.environments import VanDerPolOscillator
    from multitreegp_tpu_torch.models.evaluators import SREvaluator, generate_sr_data

    on_card = device.type == "cuda"
    ts = data[1]
    g = torch.Generator(device=device).manual_seed(272)
    x0s, _, ys, _ = generate_sr_data(VanDerPolOscillator(), g, ts, batch_size=s["wide_batch"])
    ev = SREvaluator(fset, substeps=1)
    zeroed(counters)
    sync(device)
    t0 = time.perf_counter()
    fitness = ev.evaluate_population(trees, (x0s, ts, ys, None))
    sync(device)
    eval_ms = (time.perf_counter() - t0) * 1e3
    launches = {k: c.launches for k, c in counters.items()}
    check(bool(torch.isfinite(fitness).all()), "B=2048: non-finite fitness")
    if on_card:
        check(launches["sr_fitness_wide"] == 1 and launches["sr_fitness"] == 0, f"B=2048 launches {launches}")
    t_cut = s["wide_check_t"]
    cut = (trees, x0s, ts[:t_cut], ys[:, :t_cut].contiguous(), fset, "rk4", 1)
    got = cf.sr_fitness_wide_cuda(*cut) if on_card else cf.sr_fitness_plain(*cut)
    ref, plain_ms = timed_plain(lambda: cf.sr_fitness_plain(*cut), device)
    same = float(lanes_identical(*got, *ref).float().mean())
    check(same == 1.0, f"#1 wide at B={x0s.shape[0]}: {same:.6f} of lanes identical")
    full = (trees, x0s, ts, ys, fset, "rk4", 1)
    mse, alive = cf.sr_fitness_wide_cuda(*full) if on_card else cf.sr_fitness_plain(*full)
    rows = ((trees.ops >= 2) & (trees.ops < fset.var_start)).sum(dim=(1, 2))
    steps = torch.where(alive, ts.shape[0] - 1, 1)
    bnd = bound(nbytes(trees.ops, trees.const, x0s, ts, ys) + alive.numel() * 5,
                float((steps * (4 * rows[:, None] + 16 * 2)).sum()))
    out = dict(trajectories=x0s.shape[0], lanes=alive.numel(), eval_ms=eval_ms, launches=launches,
               identical=same, plain_ms=plain_ms, plain_t_steps=t_cut, bound_ms=bnd[0], bound_by=bnd[1],
               ms=None, device_ms=None, fixed_vs_wide=None)
    if on_card:
        fn = lambda: cf.sr_fitness_wide_cuda(*full)
        out["ms"] = cuda_time_ms(fn, s["timing_runs"], torch)
        out["device_ms"] = kernel_device_ms((("b2048", fn, "sr_fitness_wide_kernel"),), s["timing_runs"], torch)["b2048"]
        main = (trees, data[0], ts, data[2], fset, "rk4", 1)
        fixed, wide = cf.sr_fitness_cuda(*main), cf.sr_fitness_wide_cuda(*main)
        check(same_bits(fixed[0], wide[0]) and torch.equal(fixed[1], wide[1]), "wide != fixed at d = 2")
        turns = in_turns((("fixed", lambda: cf.sr_fitness_cuda(*main), "sr_fitness_kernel"),
                          ("wide", lambda: cf.sr_fitness_wide_cuda(*main), "sr_fitness_wide_kernel")),
                         s["ab_runs"], torch)
        out["fixed_vs_wide"] = dict(bit_equal=True, lanes=fixed[1].numel(), device_ms=turns)
    phase_line(f"phase 27 VdP at {x0s.shape[0]} trajectories ({alive.numel()} lanes): evaluation {eval_ms:.1f} ms, "
               f"launches {launches}; #1 wide vs plain at T={t_cut}: identical {same:.6f}, plain {plain_ms:.1f} ms; "
               + (f"#1 wide T={ts.shape[0]} {out['ms']:.4f} ms events, device {out['device_ms']:.4f} ms; "
                  f"fixed vs wide at d=2 (device ms, in turns) {out['fixed_vs_wide']['device_ms']}; " if on_card else "")
               + f"bound {bnd[0]:.6f} ms ({bnd[1]})")
    return out


def wide_policy_phase(device, s, ps) -> dict:
    """Phase 28: the policy kernels past two hidden states, two targets and
    1024 trajectories. The dynamic Acrobot with ``wide_policy_states`` (8)
    hidden states at phase 13's shape (``ps``, :func:`policy_setup`): 3
    generations of the host loop (#6 wide, #2), the last population through
    the general path (``interpreter="gather"``: #8) beside the fused one, on
    the policy grid (clamp agreement >= 0.999; #6 steps the whole grid with
    ``ts[1] - ts[0]``, the integrator each interval with its own float32
    span, so long chaotic rollouts part) and on a grid of equal float32
    intervals ``wide_policy_exact_dt`` apart over the same horizon, judged
    as ROADMAP.md's rule for long chaotic rollouts (clamp agreement 1.0,
    survivor Spearman >= 0.997), and through ``method="adaptive"`` (dopri5,
    ``policy_adaptive_substeps`` steps per interval: #7 wide); #6 and #7
    wide against their plain versions on every lane at ``wide_policy_check_t``
    save points; each one's events, device time and bound at T = 250 (#7
    timed once). ``StirredTankReactor(n_targets=3)`` through #6 and #7 wide
    at phase 12's leg shape. The static Acrobot on ``wide_batch`` (2,048)
    trajectories with ``wide_policy_pop`` (1,024) policies at T = 250
    through #6's fixed instance, against plain at the cut horizon. The wide
    and fixed instances on phase 13's static and dynamic shapes: bit-equal,
    then device time in turns (fixed, wide, wide, fixed)."""
    import torch

    from multitreegp_tpu_torch import GeneticProgramming
    from multitreegp_tpu_torch.core import cuda_interpreter as ci
    from multitreegp_tpu_torch.core import cuda_policy as cp
    from multitreegp_tpu_torch.core import cuda_reproduction as cr
    from multitreegp_tpu_torch.core.registry import build_function_set
    from multitreegp_tpu_torch.models.environments import StirredTankReactor
    from multitreegp_tpu_torch.models.evaluators import (
        DynamicPolicyEvaluator, StaticPolicyEvaluator, generate_control_data,
    )
    from multitreegp_tpu_torch.ops.initialization import make_population_sampler

    t0 = time.perf_counter()
    on_card = device.type == "cuda"
    env, data = ps["env"], ps["data"]
    x0, ts, tgt, _, _, par = data
    t_steps, b, n, ss = ts.shape[0], s["batch"], s["policy_nodes"], s["wide_policy_states"]
    sub, budget, t_cut = s["policy_substeps"], s["policy_adaptive_substeps"], s["wide_policy_check_t"]
    counters = dict(policy=cp.policy_rollout_cuda, policy_adaptive=cp.policy_rollout_adaptive_cuda,
                    policy_wide=cp.policy_rollout_wide_cuda,
                    policy_adaptive_wide=cp.policy_rollout_adaptive_wide_cuda,
                    reproduce=cr.reproduce_lanes_cuda, interpret_fwd=ci.evaluate_trees_cuda)
    counted = lambda fn: counted_run(fn, counters, device)
    hidden = [f"a{i}" for i in range(ss)]
    ev = DynamicPolicyEvaluator(env, state_size=ss, substeps=sub)
    gp = GeneticProgramming(
        num_generations=s["wide_policy_generations"], population_size=s["pop"], fitness_function=ev,
        operator_list=POLICY_OPERATORS,
        variable_list=[[f"y{i}" for i in range(env.n_obs)] + hidden + ["u0"], hidden],
        layer_sizes=[ss, env.n_control], num_populations=s["islands"], max_nodes=n,
        max_init_depth=s["depth"], device=device)
    fset = gp.fset
    r = loop_generations(gp, data, device, s["wide_policy_generations"], 28, counters)
    for i, gen in enumerate(r["generations"]):
        e, evo = gen["eval_launches"], gen["evolve_launches"]
        if on_card:
            check(e["policy_wide"] == 1 and e["policy"] == 0 and e["interpret_fwd"] == 0
                  and evo["reproduce"] >= 1, f"phase 28 gen {i} launches {e} {evo}")
        phase_line(f"phase 28 dynamic Acrobot ({ss} hidden states, {s['islands']}x{s['pop']} policies of "
                   f"{ss + 1} trees x {b} trajectories, T={t_steps}) gen {i}: eval {gen['eval_ms']:.3f} ms, "
                   f"evolve {gen['evolve_ms']:.3f} ms, best fitness {gen['best']:.6g}; launches in evaluate {e}")
    flat = r["pops"].map(lambda a: a.reshape((-1,) + a.shape[2:]))
    p = flat.ops.shape[0]

    # the fused path against the general one on the last population: on the
    # policy grid, where #6 takes one step size for the whole grid (ts[1] -
    # ts[0]) and the integrator one per interval (arange's float32 intervals
    # differ by ulps), and on a grid of equal float32 intervals over the same
    # horizon, where both take the same steps
    general_ev = DynamicPolicyEvaluator(env, fset, state_size=ss, substeps=sub, interpreter="gather")
    top = ev.max_fitness
    exact_ts = torch.arange(0.0, s["policy_horizon"], s["wide_policy_exact_dt"], device=device)
    fvg = {}
    for grid, d in (("policy_grid", data), ("exact_grid", (x0, exact_ts) + data[2:])):
        fused, fused_ms, l_fused = counted(lambda: ev.evaluate_population(flat, d))
        general, general_ms, l_general = counted(lambda: general_ev.evaluate_population(flat, d))
        if on_card:
            check(l_fused["policy_wide"] == 1 and l_fused["interpret_fwd"] == 0, f"fused {l_fused}")
            check(l_general["policy_wide"] == 0
                  and l_general["interpret_fwd"] >= (d[1].shape[0] - 1) * sub * 4, f"general {l_general}")
        clamp = float(((fused >= top) == (general >= top)).float().mean())
        surv = (fused < top) & (general < top)
        rho = spearman(fused[surv], general[surv]) if int(surv.sum()) > 1 else 1.0
        rel = ((fused - general).abs() / general.abs().clamp(min=1e-30))[surv]
        fvg[grid] = r_ = dict(
            candidates=p, t_steps=d[1].shape[0], clamp_agreement=clamp, survivors=int(surv.sum()), spearman=rho,
            max_rel=float(rel.max()) if rel.numel() else 0.0,
            rel_over_1e3=float((rel > 1e-3).float().mean()) if rel.numel() else 0.0,
            fused_ms=fused_ms, general_ms=general_ms, launches_fused=l_fused, launches_general=l_general)
        phase_line(f"phase 28 fused (#6 wide) vs general path (#8), {grid} (T={r_['t_steps']}), {p} policies: "
                   f"clamp agreement {clamp:.6f}, {r_['survivors']} survivors, Spearman {rho:.8f}, max rel "
                   f"{r_['max_rel']:.3e} ({r_['rel_over_1e3']:.4f} of survivors past 1e-3); evaluation "
                   f"{fused_ms:.1f} ms fused, {general_ms:.1f} ms general")
    check(fvg["policy_grid"]["clamp_agreement"] >= 0.999, f"phase 28 fused vs general: {fvg['policy_grid']}")
    check(fvg["exact_grid"]["clamp_agreement"] == 1.0 and fvg["exact_grid"]["spearman"] >= 0.997,
          f"phase 28 fused vs general on equal intervals: {fvg['exact_grid']}")
    ev_ad = DynamicPolicyEvaluator(env, fset, state_size=ss, method="adaptive", adaptive_method="dopri5",
                                   substeps=budget)
    fit_ad, ad_ms, l_ad = counted(lambda: ev_ad.evaluate_population(flat, data))
    check(bool(torch.isfinite(fit_ad).all()) and bool(((fit_ad >= 0) & (fit_ad <= top)).all()),
          "phase 28 adaptive fitness outside [0, max]")
    if on_card:
        check(l_ad["policy_adaptive_wide"] == 1 and l_ad["interpret_fwd"] == 0, f"adaptive {l_ad}")
    phase_line(f"phase 28 adaptive evaluation (dopri5, {budget} per interval): {ad_ms:.1f} ms, best "
               f"{float(fit_ad.min()):.6g}, launches {l_ad}")

    # #6 and #7 wide against plain at the cut horizon, then at T = 250
    kernels = {}
    for kind, key in (("fixed", "policy_wide"), ("adaptive", "policy_adaptive_wide")):
        (res, launches) = counted(lambda: policy_pair(device, kind, flat, data, env, fset, ss, t_cut, sub))[::2]
        if on_card:
            check(launches[key] == 1, f"phase 28 {key} check launches {launches}")
        kernels[key] = dict(check=res, max_abs_err=res["max_abs_err"], plain_ms=res["plain_ms"],
                            plain_t_steps=t_cut)
        phase_line(f"phase 28 #{6 if kind == 'fixed' else 7} wide vs plain, {ss} hidden states, T={t_cut}, "
                   f"{res['lanes']} lanes: identical {res['identical']:.6f}, max abs {res['max_abs_err']:.3e}, "
                   f"alive {res['alive']:.4f}; plain {res['plain_ms']:.1f} ms")
    full6 = (flat, x0, ts, tgt, par, env, fset, sub, "rk4", ss)
    full7 = (flat, x0, ts, tgt, par, env, fset, 1e-4, 1e-4, budget, "dopri5", 0.9, ss)
    shapes = dict(policy_wide=("fixed", lambda: cp.rollout_policy(*full6), "policy_wide_kernel",
                               s["wide_policy_runs"]),
                  policy_adaptive_wide=("adaptive", lambda: cp.rollout_policy_adaptive(*full7, return_steps=True),
                                        "policy_adaptive_wide_kernel", 1))
    for key, (kind, fn, kernel, runs) in shapes.items():
        k = kernels[key]
        k.update(t_steps=t_steps, ms=None, device_ms=None, runs=runs)
        if on_card:
            k["ms"] = cuda_time_ms(fn, runs, torch)
            k["device_ms"] = kernel_device_ms(((key, fn, kernel),), runs, torch)[key]
        out = fn()
        bnd, ops, nb = policy_bound(kind, out, flat, fset, ss, data, sub)
        k.update(bound=bnd, ops=ops, bytes=nb, alive=float(out[2][-1].float().mean()))
        if kind == "adaptive":
            st = out[3].float()
            k.update(steps_min=int(st.min()), steps_median=float(st.median()), steps_max=int(st.max()))
        phase_line(f"phase 28 #{6 if kind == 'fixed' else 7} wide T={t_steps}, {out[2][0].numel()} lanes: "
                   + (f"{k['ms']:.3f} ms events (median of {runs}), device {k['device_ms']:.4f} ms a launch; "
                      if on_card else "") + f"alive {k['alive']:.4f}; bound {bnd[0]:.4f} ms by {bnd[1]} "
                   f"({ops:.4e} operations, {nb / 1e6:.1f} MB)")
    kernels["policy_wide"]["launches"] = sum(g["eval_launches"]["policy_wide"] for g in r["generations"])
    kernels["policy_adaptive_wide"]["launches"] = l_ad["policy_adaptive_wide"]

    # three targets: the reactor, static, at phase 12's leg shape
    g = torch.Generator(device=device).manual_seed(282)
    reactor = StirredTankReactor(n_targets=3)
    names = [f"y{i}" for i in range(reactor.n_obs)] + [f"tgt{i}" for i in range(reactor.n_targets)]
    fset3 = build_function_set(POLICY_OPERATORS, [names], [reactor.n_control])
    ts3 = torch.arange(s["legs_t"], dtype=torch.float32, device=device) * s["dt"]
    data3 = generate_control_data(reactor, g, ts3, batch_size=b, param_mode="Different")
    trees3 = make_population_sampler(fset3, s["depth"], n)(g, s["legs_pop"])[0]
    targets3 = {}
    for kind, key in (("fixed", "policy_wide"), ("adaptive", "policy_adaptive_wide")):
        res, _ms, launches = counted(lambda: policy_pair(device, kind, trees3, data3, reactor, fset3, 0,
                                                         s["legs_t"], 2))
        if on_card:
            check(launches[key] == 1, f"phase 28 reactor {key} launches {launches}")
        targets3[kind] = res
        kernels[key]["three_targets"] = dict(identical=res["identical"], lanes=res["lanes"], t_steps=s["legs_t"])
        phase_line(f"phase 28 #{6 if kind == 'fixed' else 7} wide, StirredTankReactor with 3 targets, "
                   f"{res['lanes']} lanes, T={s['legs_t']}: identical {res['identical']:.6f}; alive {res['alive']:.4f}")

    # 2,048 trajectories: the static Acrobot through #6's fixed instance
    trees_s, fset_s = ps["trees"]["static"][: s["wide_policy_pop"]], ps["fsets"]["static"]
    data_b = generate_control_data(env, g, ts, batch_size=s["wide_batch"])
    ev_s = StaticPolicyEvaluator(env, fset_s, substeps=sub)
    fit_b, eval_b_ms, l_b = counted(lambda: ev_s.evaluate_population(trees_s, data_b))
    check(bool(torch.isfinite(fit_b).all()), "phase 28 B=2048: non-finite fitness")
    if on_card:
        check(l_b["policy"] == 1 and l_b["policy_wide"] == 0 and l_b["interpret_fwd"] == 0,
              f"phase 28 B=2048 launches {l_b}")
    res_b = policy_pair(device, "fixed", trees_s, data_b, env, fset_s, 0, t_cut, sub)
    many = dict(policies=trees_s.ops.shape[0], trajectories=s["wide_batch"], eval_ms=eval_b_ms, launches=l_b,
                check=res_b, ms=None, device_ms=None)
    if on_card:
        fn = lambda: cp.rollout_policy(trees_s, *data_b[:3], data_b[5], env, fset_s, sub, "rk4", 0)
        many["ms"] = cuda_time_ms(fn, 1, torch)
        many["device_ms"] = kernel_device_ms((("b2048", fn, "policy_kernel"),), 1, torch)["b2048"]
    phase_line(f"phase 28 static Acrobot at {s['wide_batch']} trajectories ({res_b['lanes']} lanes): evaluation "
               f"{eval_b_ms:.1f} ms at T={t_steps}, launches {l_b}; #6 (fixed instance) vs plain at T={t_cut}: "
               f"identical {res_b['identical']:.6f}, plain {res_b['plain_ms']:.1f} ms"
               + (f"; #6 T={t_steps} {many['ms']:.3f} ms events, device {many['device_ms']:.4f} ms"
                  if on_card else ""))

    # the wide and fixed instances on phase 13's shapes
    side = {}
    if on_card:
        for name in ("static", "dynamic"):
            trees, fs, ss2 = ps["trees"][name], ps["fsets"][name], ps["state_size"][name]
            a6 = (trees, x0, ts, tgt, par, env, fs, sub, "rk4", ss2)
            a7 = (trees, x0, ts, tgt, par, env, fs, 1e-4, 1e-4, budget, "dopri5", 0.9, ss2)
            pairs = (("fixed", lambda: cp.policy_rollout_cuda(*a6), "policy_kernel"),
                     ("wide", lambda: cp.policy_rollout_wide_cuda(*a6), "policy_wide_kernel"),
                     ("adaptive_fixed", lambda: cp.policy_rollout_adaptive_cuda(*a7), "policy_adaptive_kernel"),
                     ("adaptive_wide", lambda: cp.policy_rollout_adaptive_wide_cuda(*a7),
                      "policy_adaptive_wide_kernel"))
            same6 = compare_policy(pairs[1][1](), pairs[0][1]())["identical"]
            same7 = compare_policy(pairs[3][1](), pairs[2][1]())["identical"]
            turns = in_turns(pairs, s["wide_policy_runs"], torch)
            side[name] = dict(bit_equal_fixed=same6, bit_equal_adaptive=same7, device_ms=turns)
            phase_line(f"phase 28 wide vs fixed, {name} (state_size {ss2}), T={t_steps}: every lane bit-equal "
                       f"(#6 {same6:.6f}, #7 {same7:.6f}); device ms in turns (fixed, wide, wide, fixed) "
                       + "; ".join(f"{k_} {[round(v, 4) for v in vs]}" for k_, vs in turns.items()))
    kernels["policy_wide"]["fixed_vs_wide"] = {k_: dict(bit_equal=v["bit_equal_fixed"],
                                                        device_ms={t: v["device_ms"][t] for t in ("fixed", "wide")})
                                               for k_, v in side.items()}
    kernels["policy_adaptive_wide"]["fixed_vs_wide"] = {
        k_: dict(bit_equal=v["bit_equal_adaptive"],
                 device_ms={t: v["device_ms"][f"adaptive_{t}"] for t in ("fixed", "wide")})
        for k_, v in side.items()}
    seconds = time.perf_counter() - t0
    phase_line(f"phase 28 took {seconds:.1f} s")
    return {"wide_policy": dict(generations=r["generations"], fused_vs_general=fvg,
                                adaptive=dict(ms=ad_ms, launches=l_ad, best=float(fit_ad.min())),
                                kernels=kernels, three_targets=targets3, trajectories=many,
                                fixed_vs_wide=side, seconds=seconds)}


# ------------------------------------------------------ user environments

# float32 operations of one Pendulum drift with its observation, counted
# from the generated plant (the clamp, 11 drift nodes, cos and sin)
PENDULUM_DRIFT_OPS = 14


def pendulum_env(obs_noise: float = 0.0):
    """Gym's ``Pendulum-v1`` (``gym/envs/classic_control/pendulum.py``) as a
    user control environment: a ``ControlEnvironmentBase`` subclass defined
    here (the package has no such class) with ``tile_safe_drift = True``.
    State ``(theta, theta_dot)``, drift ``(theta_dot, 3 g / (2 l)
    sin(theta) + 3 / (m l^2) clip(u, -2, 2))``, parameters ``(g, m, l)`` =
    ``(10, 1, 1)`` (Constant) or drawn per trajectory or as series,
    observation ``[cos theta, sin theta, theta_dot]``, no targets, cost
    ``angle_normalize(theta)^2 + 0.1 theta_dot^2 + 0.001 u^2`` summed over
    the save grid; Gym's speed clip (a discrete-time clip, not an ODE term)
    is left out. ``tests/test_torch_user_env.py`` holds the same class."""
    import torch

    from multitreegp_tpu_torch.models.environments.base import ControlEnvironmentBase, time_varying
    from multitreegp_tpu_torch.models.environments.control_envs import _decay_series, _switch_series

    pi = math.pi
    ranges = ((8.0, 12.0), (0.8, 1.2), (0.8, 1.2))

    def uniform(shape, g, lo, hi):
        return lo + (hi - lo) * torch.rand(shape, generator=g, device=g.device)

    class Pendulum(ControlEnvironmentBase):
        tile_safe_drift = True

        def __init__(self, process_noise: float = 0.0, obs_noise: float = 0.0):
            super().__init__(process_noise, obs_noise, n_var=2, n_control=1, n_dim=1, n_obs=3)
            self.max_torque = 2.0

        def sample_init_states(self, batch_size, generator):
            x0 = torch.stack([uniform((batch_size,), generator, -pi, pi),
                              uniform((batch_size,), generator, -1.0, 1.0)], dim=-1)
            return x0, torch.zeros((batch_size, 0), device=generator.device)

        def sample_params(self, batch_size, mode, ts, generator):
            if mode == "Constant":
                ones = torch.ones(batch_size, device=ts.device)
                return 10.0 * ones, ones, ones
            series = dict(Different=lambda lo, hi: uniform((batch_size,), generator, lo, hi),
                          Switch=lambda lo, hi: _switch_series(generator, batch_size, ts, lo, hi),
                          Decay=lambda lo, hi: _decay_series(generator, batch_size, ts, lo, hi))[mode]
            return tuple(series(lo, hi) for lo, hi in ranges)

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
            theta = torch.remainder(xs[..., 0] + pi, 2 * pi) - pi  # Gym's angle_normalize
            u = torch.clamp(us[..., 0], -self.max_torque, self.max_torque)
            return (theta * theta + 0.1 * (xs[..., 1] * xs[..., 1]) + 0.001 * (u * u)).sum(dim=-1)

    return Pendulum(0.0, obs_noise)


def traced_acrobot_env():
    """``class TracedAcrobot(Acrobot): pass``: the built-in plant under
    another class, so the kernels run its traced build."""
    from multitreegp_tpu_torch.models.environments import Acrobot

    class TracedAcrobot(Acrobot):
        pass

    return TracedAcrobot(0.0, 0.0)


def user_env_variants() -> list:
    """Phase 29's builds of ``policy.cu``: the Pendulum's fixed and wide
    user-environment builds and the traced Acrobot's fixed one (with the
    default operators, ``+ - * sin cos``)."""
    import torch

    from multitreegp_tpu_torch import _build
    from multitreegp_tpu_torch.core import user_envs

    plant = lambda env, n: _build.env_variant(_build.DEFAULT, user_envs.traced(env, (torch.ones(1),) * n).header)
    pend, acro = plant(pendulum_env(), 3), plant(traced_acrobot_env(), 4)
    return [pend, _build.widened(pend), acro]


def user_env_phase(device, s, ps) -> dict:
    """Phase 29: user control environments through #6 and #7. Gym's
    Pendulum (:func:`pendulum_env`) at the ``policy`` workload's shape (8 x
    512 policies of ``max_nodes`` 30, ``+ - * sin cos``, 16 trajectories,
    ``user_env_t`` = 201 save points ``user_env_dt`` = 0.05 apart, RK4 x 1):
    3 generations of the host loop through #6's user-environment build (one
    launch an evaluation, no #8) and #2; the last population through the
    general path (``interpreter="gather"``: #8) beside the fused one; a
    dynamic population (``state_size=2``, #6's fixed instance), the static
    one under ``method="adaptive"`` (dopri5, ``policy_adaptive_substeps``
    steps an interval: #7) and with observation noise ``noise`` (#6 with
    the obs-noise rows), one evaluation each; every user-environment
    instance against its plain version on every lane at ``user_env_check_t``
    save points (fixed static and dynamic, adaptive, noisy, and the wide
    instance with ``user_env_wide_states`` hidden states, #6 and #7); #6 and
    #7 timed at the full grid with their bounds; ``TracedAcrobot`` beside
    the built-in ``Acrobot`` at phase 13's shape cut to ``user_env_acrobot_t``
    save points (#6 static and #7): every lane bit-equal, then device time in
    turns (built-in, traced, traced, built-in); the ``nvcc`` seconds of the
    new builds."""
    import torch

    from multitreegp_tpu_torch import GeneticProgramming, _build
    from multitreegp_tpu_torch.core import cuda_interpreter as ci
    from multitreegp_tpu_torch.core import cuda_policy as cp
    from multitreegp_tpu_torch.core import cuda_reproduction as cr
    from multitreegp_tpu_torch.core.registry import build_function_set
    from multitreegp_tpu_torch.models.evaluators import (
        DynamicPolicyEvaluator, StaticPolicyEvaluator, generate_control_data,
    )
    from multitreegp_tpu_torch.models.evaluators.noise import make_obs_noise_rows
    from multitreegp_tpu_torch.ops.initialization import make_population_sampler

    t0 = time.perf_counter()
    on_card = device.type == "cuda"
    env = pendulum_env()
    b, n, budget = s["batch"], s["policy_nodes"], s["policy_adaptive_substeps"]
    t_steps, t_cut, wss = s["user_env_t"], s["user_env_check_t"], s["user_env_wide_states"]
    counters = dict(policy=cp.policy_rollout_cuda, policy_adaptive=cp.policy_rollout_adaptive_cuda,
                    policy_wide=cp.policy_rollout_wide_cuda,
                    policy_adaptive_wide=cp.policy_rollout_adaptive_wide_cuda,
                    reproduce=cr.reproduce_lanes_cuda, interpret_fwd=ci.evaluate_trees_cuda)
    counted = lambda fn: counted_run(fn, counters, device)
    only = lambda launches, key: all(v == (1 if k == key else 0) for k, v in launches.items()
                                     if k != "reproduce")
    g = torch.Generator(device=device).manual_seed(29)
    ts = torch.arange(t_steps, dtype=torch.float32, device=device) * s["user_env_dt"]
    data = generate_control_data(env, g, ts, batch_size=b)
    x0, _, tgt, _, obs_keys, par = data
    ys = [f"y{i}" for i in range(env.n_obs)]
    ev = StaticPolicyEvaluator(env, substeps=1)
    gp = GeneticProgramming(
        num_generations=s["user_env_generations"], population_size=s["pop"], fitness_function=ev,
        operator_list=POLICY_OPERATORS, variable_list=[ys], layer_sizes=[env.n_control],
        num_populations=s["islands"], max_nodes=n, max_init_depth=s["depth"], device=device)
    fset = gp.fset
    library = _build.variant_name("policy", cp.policy_variant(env, par, fset))
    r = loop_generations(gp, data, device, s["user_env_generations"], 29, counters)
    for i, gen in enumerate(r["generations"]):
        e, evo = gen["eval_launches"], gen["evolve_launches"]
        if on_card:
            check(only(e, "policy") and evo["reproduce"] >= 1, f"phase 29 gen {i} launches {e} {evo}")
        phase_line(f"phase 29 Pendulum ({s['islands']}x{s['pop']} policies x {b} trajectories, T={t_steps}, "
                   f"{library}) gen {i}: eval {gen['eval_ms']:.3f} ms, evolve {gen['evolve_ms']:.3f} ms, best "
                   f"fitness {gen['best']:.6g}; launches in evaluate {e}")
    check(ev.env_refusal is None, f"phase 29: the Pendulum was refused: {ev.env_refusal}")
    if on_card:
        check(library in _build._loaded, f"phase 29: {library} not loaded")
    flat = r["pops"].map(lambda a: a.reshape((-1,) + a.shape[2:]))
    p = flat.ops.shape[0]
    top = ev.max_fitness

    # the fused path beside the general one on the last population
    general_ev = StaticPolicyEvaluator(env, fset, substeps=1, interpreter="gather")
    fused, fused_ms, l_fused = counted(lambda: ev.evaluate_population(flat, data))
    general, general_ms, l_general = counted(lambda: general_ev.evaluate_population(flat, data))
    if on_card:
        check(only(l_fused, "policy"), f"phase 29 fused {l_fused}")
        check(l_general["policy"] == 0 and l_general["interpret_fwd"] >= (t_steps - 1) * 4,
              f"phase 29 general {l_general}")
    clamp = float(((fused >= top) == (general >= top)).float().mean())
    surv = (fused < top) & (general < top)
    rho = spearman(fused[surv], general[surv]) if int(surv.sum()) > 1 else 1.0
    rel = ((fused - general).abs() / general.abs().clamp(min=1e-30))[surv]
    fvg = dict(candidates=p, clamp_agreement=clamp, survivors=int(surv.sum()), spearman=rho,
               max_rel=float(rel.max()) if rel.numel() else 0.0,
               median_rel=float(rel.median()) if rel.numel() else 0.0, fused_ms=fused_ms,
               general_ms=general_ms, ratio=general_ms / fused_ms, launches_fused=l_fused,
               launches_general=l_general)
    check(clamp >= 0.999, f"phase 29 fused vs general: {fvg}")
    phase_line(f"phase 29 fused (#6, {library}) vs general path (#8), {p} policies, T={t_steps}: clamp "
               f"agreement {clamp:.6f}, {fvg['survivors']} survivors, Spearman {rho:.8f}, max rel "
               f"{fvg['max_rel']:.3e}, median rel {fvg['median_rel']:.3e}; evaluation {fused_ms:.1f} ms fused, "
               f"{general_ms:.1f} ms general ({fvg['ratio']:.1f}x)")

    # the other paths: dynamic (state_size 2), adaptive, observation noise
    dyn_set = lambda k: build_function_set(
        POLICY_OPERATORS, [ys + [f"a{i}" for i in range(k)] + ["u0"], [f"a{i}" for i in range(k)]],
        [k, env.n_control])
    fset2, fset_w = dyn_set(2), dyn_set(wss)
    trees2 = make_population_sampler(fset2, s["depth"], n)(g, p)[0]
    trees_w = make_population_sampler(fset_w, s["depth"], n)(g, s["legs_pop"])[0]
    noisy_env = pendulum_env(s["noise"])
    paths = dict(
        dynamic=(DynamicPolicyEvaluator(env, fset2, state_size=2, substeps=1), trees2, "policy"),
        adaptive=(StaticPolicyEvaluator(env, fset, method="adaptive", adaptive_method="dopri5",
                                        substeps=budget), flat, "policy_adaptive"),
        noisy=(StaticPolicyEvaluator(noisy_env, fset, substeps=1), flat, "policy"))
    path_res = {}
    for name, (pev, trees, key) in paths.items():
        fit, ms, launches = counted(lambda: pev.evaluate_population(trees, data))
        check(bool(torch.isfinite(fit).all()) and bool(((fit >= 0) & (fit <= top)).all()),
              f"phase 29 {name}: fitness outside [0, max]")
        if on_card:
            check(only(launches, key), f"phase 29 {name} launches {launches}")
        path_res[name] = dict(ms=ms, launches=launches, best=float(fit.min()))
        phase_line(f"phase 29 {name} evaluation: {ms:.1f} ms, best {float(fit.min()):.6g}, launches {launches}")

    # every user-environment instance against its plain version at the cut horizon
    rows = dict(obs_noise_rows=make_obs_noise_rows(noisy_env, ts[:t_cut], par, obs_keys, 1, "rk4"))
    cases = (("fixed_static", "fixed", flat, env, fset, 0, None, "policy"),
             ("fixed_dynamic", "fixed", trees2, env, fset2, 2, None, "policy"),
             ("adaptive_static", "adaptive", flat, env, fset, 0, None, "policy_adaptive"),
             ("fixed_noisy", "fixed", flat, noisy_env, fset, 0, rows, "policy"),
             ("wide_fixed", "fixed", trees_w, env, fset_w, wss, None, "policy_wide"),
             ("wide_adaptive", "adaptive", trees_w, env, fset_w, wss, None, "policy_adaptive_wide"))
    checks = {}
    for name, kind, trees, e_, fs, ss, rw, key in cases:
        res, _ms, launches = counted(lambda: policy_pair(device, kind, trees, data, e_, fs, ss, t_cut, 1,
                                                         rows=rw))
        if on_card:
            check(only(launches, key), f"phase 29 {name} check launches {launches}")
        checks[name] = res
        phase_line(f"phase 29 {name} vs plain (state_size {ss}), T={t_cut}, {res['lanes']} lanes: identical "
                   f"{res['identical']:.6f}, max abs {res['max_abs_err']:.3e}, alive {res['alive']:.4f}; plain "
                   f"{res['plain_ms']:.1f} ms")

    # #6 and #7 at the full grid: events, device time, bound
    full6 = (flat, x0, ts, tgt, par, env, fset, 1, "rk4", 0)
    full7 = (flat, x0, ts, tgt, par, env, fset, 1e-4, 1e-4, budget, "dopri5", 0.9, 0)
    timed = {}
    for key, kind, fn, kernel in (
            ("policy", "fixed", lambda: cp.rollout_policy(*full6), "policy_kernel"),
            ("policy_adaptive", "adaptive", lambda: cp.rollout_policy_adaptive(*full7, return_steps=True),
             "policy_adaptive_kernel")):
        t_ = dict(t_steps=t_steps, ms=None, device_ms=None, runs=s["user_env_runs"])
        if on_card:
            t_["ms"] = cuda_time_ms(fn, s["user_env_runs"], torch)
            t_["device_ms"] = kernel_device_ms(((key, fn, kernel),), s["user_env_runs"], torch)[key]
        out = fn()
        bnd, ops, nb = policy_bound(kind, out, flat, fset, 0, data, 1, PENDULUM_DRIFT_OPS)
        t_.update(bound=bnd, ops=ops, bytes=nb, alive=float(out[2][-1].float().mean()))
        timed[key] = t_
        phase_line(f"phase 29 #{6 if kind == 'fixed' else 7} Pendulum T={t_steps}, {out[2][0].numel()} lanes: "
                   + (f"{t_['ms']:.3f} ms events (median of {t_['runs']}), device {t_['device_ms']:.4f} ms a "
                      "launch; " if on_card else "") + f"alive {t_['alive']:.4f}; bound {bnd[0]:.5f} ms by "
                   f"{bnd[1]} ({ops:.4e} operations, {nb / 1e6:.2f} MB)")

    # the traced Acrobot beside the built-in struct at phase 13's shape, cut
    acro, traced = ps["env"], traced_acrobot_env()
    a_trees, a_fset = ps["trees"]["static"], ps["fsets"]["static"]
    ax0, ats, atgt, _, _, apar = ps["data"]
    ats = ats[: s["user_env_acrobot_t"]]
    sub = s["policy_substeps"]
    a6 = lambda e_: (a_trees, ax0, ats, atgt, apar, e_, a_fset, sub, "rk4", 0)
    a7 = lambda e_: (a_trees, ax0, ats, atgt, apar, e_, a_fset, 1e-4, 1e-4, budget, "dopri5", 0.9, 0)
    fix = cp.policy_rollout_cuda if on_card else cp.policy_rollout_plain
    ada = cp.policy_rollout_adaptive_cuda if on_card else cp.policy_rollout_adaptive_plain
    same = dict(fixed=compare_policy(fix(*a6(traced)), fix(*a6(acro))),
                adaptive=compare_policy(ada(*a7(traced)), ada(*a7(acro))))
    turns = {}
    if on_card:
        turns = in_turns((("fixed_builtin", lambda: fix(*a6(acro)), "policy_kernel"),
                          ("fixed_traced", lambda: fix(*a6(traced)), "policy_kernel"),
                          ("adaptive_builtin", lambda: ada(*a7(acro)), "policy_adaptive_kernel"),
                          ("adaptive_traced", lambda: ada(*a7(traced)), "policy_adaptive_kernel")),
                         s["user_env_runs"], torch)
    acrobot = dict(t_steps=ats.shape[0], lanes=same["fixed"]["lanes"],
                   bit_equal={k: v["identical"] for k, v in same.items()}, device_ms=turns,
                   library=_build.variant_name("policy", cp.policy_variant(traced, apar, a_fset)))
    phase_line(f"phase 29 TracedAcrobot ({acrobot['library']}) vs the built-in Acrobot struct, T={ats.shape[0]}, "
               f"{acrobot['lanes']} lanes: every lane bit-equal (#6 {same['fixed']['identical']:.6f}, #7 "
               f"{same['adaptive']['identical']:.6f}); device ms in turns (built-in, traced, traced, built-in) "
               + "; ".join(f"{k} {[round(v, 4) for v in vs]}" for k, vs in turns.items()))

    nvcc = {k: v for k, v in _build.build_seconds.items() if re.match(r"policy.*_e[0-9a-f]{12}", k)}
    phase_line(f"phase 29 user-environment builds, nvcc seconds (behind the phases, beside the other builds): {nvcc}")
    launches6 = sum(gen["eval_launches"]["policy"] for gen in r["generations"])
    kernels = dict(
        policy_user_env=dict(
            launches=launches6, max_abs_err=checks["fixed_static"]["max_abs_err"], ms=timed["policy"]["ms"],
            plain_ms=checks["fixed_static"]["plain_ms"], bound=timed["policy"]["bound"],
            device_ms=timed["policy"]["device_ms"], t_steps=t_steps, plain_t_steps=t_cut, library=library,
            launches_paths={k: path_res[k]["launches"]["policy"] for k in ("dynamic", "noisy")},
            checks={k: checks[k]["identical"] for k in ("fixed_static", "fixed_dynamic", "fixed_noisy",
                                                         "wide_fixed")},
            traced_acrobot=dict(bit_equal=acrobot["bit_equal"]["fixed"],
                                device_ms={k: v for k, v in turns.items() if k.startswith("fixed")}),
            nvcc_s=nvcc),
        policy_adaptive_user_env=dict(
            launches=path_res["adaptive"]["launches"]["policy_adaptive"],
            max_abs_err=checks["adaptive_static"]["max_abs_err"], ms=timed["policy_adaptive"]["ms"],
            plain_ms=checks["adaptive_static"]["plain_ms"], bound=timed["policy_adaptive"]["bound"],
            device_ms=timed["policy_adaptive"]["device_ms"], t_steps=t_steps, plain_t_steps=t_cut,
            checks={k: checks[k]["identical"] for k in ("adaptive_static", "wide_adaptive")},
            traced_acrobot=dict(bit_equal=acrobot["bit_equal"]["adaptive"],
                                device_ms={k: v for k, v in turns.items() if k.startswith("adaptive")})))
    seconds = time.perf_counter() - t0
    phase_line(f"phase 29 took {seconds:.1f} s")
    return {"user_env": dict(generations=r["generations"], fused_vs_general=fvg, paths=path_res, checks=checks,
                             times=timed, traced_acrobot=acrobot, kernels=kernels, seconds=seconds)}


# phase 30: special functions, activations and the rest; a set past 63 ids
SPECIAL_GEN_NAMES = ("lgamma", "digamma", "i0e", "erfcx", "ndtri", "softplus", "gelu", "silu", "logaddexp",
                     "hardtanh")
SPECIAL_KERNELS = ("sr_fitness", "interpreter")  # phase 30's #1 and #8/#9 on a population


def special_sets():
    """``(gen set, every set)`` of phase 30: ``+ - * /`` and ten of
    ``registry.special_operators`` over phase 4's variables, and every
    vocabulary operator (user ids to 112) after ``+ - * /``; built before
    the kernels, so that their user libraries are compiled in the parallel
    prelude."""
    from multitreegp_tpu_torch.core.registry import build_function_set, special_operators, whole_vocabulary

    fns = {name: (fn, a) for ops in special_operators() for name, fn, a in ops}
    base = [("+", 2, 0.5), ("-", 2, 0.1), ("*", 2, 0.5), ("/", 2, 0.1)]
    gen = build_function_set(base + [(n, fns[n][0], fns[n][1], 0.1) for n in SPECIAL_GEN_NAMES],
                             [["x0", "x1"]], [2])
    every = build_function_set(base + [op + (0.1,) for op in whole_vocabulary()], [["x0", "x1"]], [2])
    check(gen.refusals == () and every.refusals == (), f"phase 30 sets refused: {gen.refusals} {every.refusals}")
    return gen, every


def special_phase(device, s, data, trees6, fset6) -> dict:
    """Phase 30: the special functions, activations, scalar bases, tensor
    clamp bounds and 0-d constants (``registry.special_operators``, traced
    by this torch) on the card. #8/#9 through the every set's user build
    (its wide instance: ids past 63) against PyTorch's own CUDA ops
    (``tools/op_sweep``): each new unary operator on every
    ``SWEEP_STRIDE``-th of the 2^32 bit patterns (the polygamma series'
    negative non-integers below -256 left out, counted, and every 4096th of
    them swept apart, forward and VJP, with both forwards' milliseconds),
    its VJP on every 256th; the binary ones on a ``SWEEP_SIDE`` square grid.
    Then a population sampled from ``+ - * /`` and ten special functions:
    #1 at T = 10 and #8/#9 in the round's layout against their plain
    versions, every lane identical; and one from every vocabulary operator
    (device op ids to 112, past the fixed instances' 63): #8/#9 through its
    wide instance, every lane identical, launch counters (#1's wide build of
    that set takes 374 s of ``nvcc``: ``pytest -m cuda
    tests/test_torch_special_ops.py`` holds it);
    #1's device time on phase 2's trees through the special library and
    through ``_ext``, in turns."""
    import torch

    from multitreegp_tpu_torch import _build
    from multitreegp_tpu_torch.core import cuda_interpreter as ci
    from multitreegp_tpu_torch.core import cuda_rollout as cf
    from multitreegp_tpu_torch.core.registry import FIXED_MAX_OP, special_operators
    from multitreegp_tpu_torch.ops.initialization import make_population_sampler
    from multitreegp_tpu_torch.tools import op_sweep

    t_start = time.perf_counter()
    on_card = device.type == "cuda"
    x0s, ts_full, ys_full, _ = data
    n, b = s["max_nodes"], s["batch"]
    gen, every = special_sets()
    names = [name for ops in special_operators() for name, *_ in ops]
    res = dict(torch=torch.__version__, sweep={}, checks={})
    if on_card:
        check(not ci.takes_fixed(4, 2, every.num_operators, every.max_device_op), "phase 30 sweep instance")
        for fset in (every,):
            for r in op_sweep.sweep_set(fset, device, SWEEP_STRIDE, SWEEP_SIDE, only=set(names)):
                res["sweep"][r["name"]] = r
                vjp = " ".join(f"{k} {v['mismatches']} (zero sign {v['zero_sign']})" for k, v in r["vjp"].items())
                skipped = f", {r['skipped']} left out (zeta series)" if r.get("skipped") else ""
                o = r.get("outside")
                if o:
                    ovjp = " ".join(f"{k} {v['mismatches']}" for k, v in o["vjp"].items())
                    skipped += (f" (every {op_sweep.OUTSIDE_STRIDE}th of them apart: {o['lanes']} lanes, "
                                f"mismatches {o['mismatches']} {o['first']}, VJP {ovjp}; forward "
                                f"{o['kernel_ms']:.1f} ms kernel, {o['torch_ms']:.1f} ms PyTorch)")
                phase_line(f"phase 30 sweep {r['name']}: {r['lanes']} lanes{skipped}, mismatches "
                           f"{r['mismatches']} {r['first']}; VJP on {r['vjp_lanes']}: {vjp}; {r['s']:.2f} s")
        bad = {k: (r["mismatches"], r["first"], r["vjp"], r.get("outside"))
               for k, r in res["sweep"].items() if not r["ok"]}
        check(not bad, f"phase 30 sweep mismatches: {bad}")
        check(sorted(res["sweep"]) == sorted(names), f"phase 30 swept {len(res['sweep'])} operators")
    res["sweep_s"] = time.perf_counter() - t_start

    t_fix = s["adaptive_short_t"]
    ts_, ys_ = ts_full[:t_fix], ys_full[:, :t_fix].contiguous()
    checks = res["checks"]
    g = torch.Generator(device=device).manual_seed(30)
    k_all = s["islands"] * s["pop"]
    # #1 and #8/#9 on the special set's population (their fixed instances),
    # #8/#9 on the every set's (its wide instance: ids past 63)
    for key, fset, k, wide in (("special", gen, k_all, False), ("every", every, min(1024, k_all), True)):
        pop = make_population_sampler(fset, s["depth"], n)(g, k)[0]
        rows = int(((pop.ops >= 2 + 4) & (pop.ops < fset.var_start)).sum())
        check(wide == (fset.max_device_op > FIXED_MAX_OP), f"phase 30 {key}: device op ids {fset.max_device_op}")
        if not wide:
            before = cf.sr_fitness_cuda.launches
            mse, alive = (cf.sr_fitness if on_card else cf.sr_fitness_plain)(pop, x0s, ts_, ys_, fset, "rk4", 1)
            launched = cf.sr_fitness_cuda.launches - before
            (ref, ref_alive), plain_ms = timed_plain(
                lambda: cf.sr_fitness_plain(pop, x0s, ts_, ys_, fset, "rk4", 1), device)
            same = float(lanes_identical(mse, alive, ref, ref_alive).float().mean())
            check(same == 1.0, f"phase 30 #1 {key}: {same:.6f} of lanes identical")
            if on_card:
                check(launched >= 1, f"phase 30 #1 {key}: {launched} launches")
            fin = torch.isfinite(mse) & torch.isfinite(ref)
            checks[f"sr_fitness_{key}"] = dict(identical=same, alive=float(alive.float().mean()),
                                               plain_ms=plain_ms, lanes=alive.numel(), t_steps=t_fix,
                                               user_rows=rows, launches=launched,
                                               max_abs_err=float((mse - ref).abs()[fin].max()) if fin.any() else 0.0)
        gc = torch.Generator(device=device).manual_seed(301)
        before = ci.evaluate_trees_cuda.launches
        checks[f"interpreter_{key}"] = lanes_check(*shape_case(device, pop[:50], b, gc), fset,
                                                   f"#8/#9 {key}, the round's layout")
        c = checks[f"interpreter_{key}"]
        c.update(wide=not ci.takes_fixed(n, 2, fset.num_operators, fset.max_device_op), user_rows=rows,
                 launches=ci.evaluate_trees_cuda.launches - before)
        check(c["wide"] == wide, f"phase 30 #8/#9 {key} instance")
        if on_card:
            check(c["launches"] >= 1, f"phase 30 #8 {key}: {c['launches']} launches")
        for name in (f"sr_fitness_{key}", f"interpreter_{key}"):
            if name not in checks:
                continue
            c = checks[name]
            phase_line(f"phase 30 {name} vs plain ({c['lanes']} lanes"
                       f"{', T=' + str(c['t_steps']) if 't_steps' in c else ''}; device op ids to "
                       f"{fset.max_device_op}, library suffix {fset.variant.suffix}"
                       f"{', wide instance' if wide else ''}): identical {c.get('identical', c.get('bit_equal'))}, "
                       f"max abs {c['max_abs_err']:.3e}, plain {c['plain_ms']:.1f} ms, "
                       f"{c['user_rows']} rows past + - * / in the population")

    if on_card:
        # #1 on phase 2's trees through _ext (an unused max appended) and
        # through the special set's library (its first four operators are
        # + - * /), in turns
        ys_c = ys_full.contiguous()
        tr_x, fs_x = with_unused_max(trees6, fset6)
        shift = gen.var_start - fset6.var_start
        check(gen.operator_names[:4] == fset6.operator_names and gen.variable_names == fset6.variable_names,
              "phase 30's special set starts with + - * /")
        tr_s = trees6._replace(ops=torch.where(trees6.ops >= fset6.var_start, trees6.ops + shift, trees6.ops))
        fit = lambda tr, fs: (lambda: cf.sr_fitness_cuda(tr, x0s, ts_full, ys_c, fs, "rk4", 1))
        cases = [("sr_fitness_ext", fit(tr_x, fs_x), "sr_fitness_kernel"),
                 ("sr_fitness_special", fit(tr_s, gen), "sr_fitness_kernel")]
        times = res["device_ms"] = in_turns(cases, 3, torch)
        x, sp = times["sr_fitness_ext"], times["sr_fitness_special"]
        phase_line(f"phase 30 #1 phase 2's trees, device ms a launch (_ext, special library, special, _ext): "
                   f"{x[0]:.4f}, {sp[0]:.4f}, {sp[1]:.4f}, {x[1]:.4f}")
        libs = ([_build.variant_name(k, gen.variant) for k in SPECIAL_KERNELS]
                + [_build.variant_name("interpreter", every.variant)])
        res["nvcc_s"] = {k: _build.build_seconds.get(k) for k in libs}
        phase_line(f"phase 30 special builds' nvcc seconds (beside the other builds): {res['nvcc_s']}")
    res["seconds"] = time.perf_counter() - t_start
    phase_line(f"phase 30 took {res['seconds']:.1f} s (the sweep {res['sweep_s']:.1f} s)")
    return {"special": res}


BEHIND_DONE = {}  # perf_counter at which each build behind the phases finished


def build_behind(names, variant):
    """``_build.build(*names, variant=variant)`` from a pool thread at the
    lowest CPU priority (nice is per thread on Linux, and ``nvcc`` inherits
    it), so that the phases' host code keeps its core while it compiles."""
    from multitreegp_tpu_torch import _build

    try:
        os.setpriority(os.PRIO_PROCESS, threading.get_native_id(), 19)
    except OSError as exc:  # then they share the CPU with the phases at one priority
        phase_line(f"phase 1 builds behind the phases keep their priority: {exc}")
    out = _build.build(*names, variant=variant)
    BEHIND_DONE[_build.variant_name(names[0], variant)] = time.perf_counter()
    return out


def sync(device) -> None:
    import torch

    if device.type == "cuda":
        torch.cuda.synchronize(device)


def main(argv=None) -> int:
    parser = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    parser.add_argument("--out", help="also write every number as JSON to this file")
    parser.add_argument("--sharded-only", action="store_true",
                        help="build the kernels and run phase 22 alone, on every card of the machine")
    opts = parser.parse_args(argv)

    import torch

    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device; this smoke run needs an NVIDIA GPU", file=sys.stderr)
        return 1
    from multitreegp_tpu_torch import _build

    device = torch.device("cuda")
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                         capture_output=True, text=True, check=True).stdout.strip().splitlines()[0]
    t0 = time.perf_counter()
    kernels = SHARDED_KERNELS if opts.sharded_only else KERNELS
    # one nvcc per library, all started together: the default builds, and
    # behind them, at the lowest CPU priority while the first phases run,
    # the wide ones, phase 24's extended ones, phase 25's, 26's, 27's and
    # 30's user ones (their function sets are traced first) and phase 29's
    # user-environment ones (their plants are traced first); a phase that
    # loads a library still being built waits for it (``_build.build``)
    extra = []
    if not opts.sharded_only:
        gen_set, control_set = user_sets()
        vocab_gen, sweep_unary, sweep_binary = vocabulary_sets()
        extra = [(EXTENDED_KERNELS, True), (USER_GEN_KERNELS, gen_set.variant),
                 (USER_CONTROL_KERNELS, control_set.variant), (VOCAB_GEN_KERNELS, vocab_gen.variant),
                 (("interpreter",), sweep_unary.variant), (("interpreter",), sweep_binary.variant),
                 (("interpreter",), many_operator_set().variant), (WIDE_KERNELS, _build.widened(False))]
        extra += [(("policy",), v) for v in user_env_variants()]
        special_gen, every = special_sets()
        extra += [(SPECIAL_KERNELS, special_gen.variant), (("interpreter",), every.variant)]
    pool = ThreadPoolExecutor(max(1, len(extra)))
    jobs = [pool.submit(build_behind, names, v) for names, v in extra]
    _build.build(*kernels)
    for name in kernels:
        _build.load(name)
    build_s = time.perf_counter() - t0
    phase_line(f"phase 1 device: {smi}; torch {torch.__version__}, CUDA {torch.version.cuda}, "
        f"{torch.cuda.get_device_name(0)} x{torch.cuda.device_count()}; default kernels built in {build_s:.1f} s "
        f"(nvcc {', '.join(f'{k} {v:.1f} s' for k, v in _build.build_seconds.items())})")
    from multitreegp_tpu_torch.kernel_ab import ptxas_report

    def report_ptxas(names):
        for name in names:
            phase_line(f"phase 1 ptxas {name}: " + "; ".join(
                f"{k} {r} registers, {st} B stack, {sp} B spilled" for k, r, st, sp in resources[name]))

    resources = {name: ptxas_report(log) for name, log in _build.build_logs.items()}
    report_ptxas(list(resources))

    try:
        if opts.sharded_only:
            out = sharded_phase(device, FULL, main_data(device, FULL)[1])
        else:
            out = run(device)
        for job in jobs:  # every build must pass, loaded or not
            job.result()
    finally:
        pool.shutdown(wait=True, cancel_futures=True)
    later = [name for name in _build.build_logs if name not in resources]
    resources.update({name: ptxas_report(_build.build_logs[name]) for name in later})
    phase_line(f"phase 1 builds behind the phases finished {max(BEHIND_DONE.values(), default=t0) - t0:.1f} s "
               f"after the start (nvcc {', '.join(f'{k} {_build.build_seconds[k]:.1f} s' for k in later)})")
    report_ptxas(later)
    if opts.sharded_only:
        if opts.out:
            with open(opts.out, "w") as f:
                json.dump(out, f, indent=1)
    else:
        out["device"] = dict(nvidia_smi=smi, torch=torch.__version__, cuda=torch.version.cuda,
                             build_s=build_s, nvcc_s=dict(_build.build_seconds), ptxas=resources,
                             builds_behind_done_s=max(BEHIND_DONE.values(), default=t0) - t0,
                             trace_drops=TRACE_DROPS)
        phase_line(f"traced runs without their kernel: {len(TRACE_DROPS)}")
        if opts.out:
            with open(opts.out, "w") as f:
                json.dump(out, f, indent=1)
        say(json.dumps({"kernels": out["kernels"]}))
    say(smi)
    say(json.dumps({"ok": True, "device": {"platform": "gpu", "kind": torch.cuda.get_device_name(0),
                                           "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
