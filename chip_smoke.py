#!/usr/bin/env python3
"""GPU smoke run of the PyTorch/CUDA port (``multitreegp_tpu_torch``).

Run from the repository root on a machine with one NVIDIA Hopper GPU::

    python3 chip_smoke.py [--out results.json]

It builds the hand-written kernels from ``multitreegp_tpu_torch/csrc`` with
``nvcc`` (one process per source, in parallel) and drives the port's paths at
the full width of the flagship workload (symbolic regression of Van der Pol;
8 islands x 512 candidates, 2 trees of ``max_nodes=32``, operators + - * /,
16 trajectories, 50 save points, RK4 with one substep). Phases, one line or
a few each:

1. device: ``nvidia-smi`` name and power limit, torch/CUDA versions, build time;
2. fitness kernel vs its plain PyTorch version (T = 5 and T = 50);
3. reproduction kernel vs its plain version on the main path's 3696 lanes;
4. the main path: ``initialize_population`` then 5 x (``evaluate_population``
   + ``evolve``), with the kernels' launch counters read around it;
5. kernel and plain-version times (CUDA events, median of several runs);
6. interpreter forward and VJP kernels vs their plain versions, per lane, at
   the constant-optimisation recompute's 50 x 16 x 2 lanes and at the whole
   population's 4096 x 16 x 2 lanes;
7. the constant-optimisation path: ``fit()`` for 20 generations with
   ``coefficient_optimisation=True`` (top-k 50, 10 Adam steps), so rounds run
   at generations 14 and 19; all four launch counters read around it, the
   refined top-k fitness against the unrefined, ms per generation and per
   round (split into the fused forward, the recompute and its backward);
8. interpreter kernel and plain-version times at both shapes (CUDA events);
9. the adaptive kernels (#5 global budget, #4 per interval; Dormand-Prince
   5(4)) and the trajectory kernel (#3) against their plain versions at the
   full width of 4096 x 16 lanes: #5 with the budget 500 at T = 10 and
   T = 50, #4 with 32 steps per interval at T = 10, #3 RK4 at T = 50;
10. the adaptive path: 5 generations of the 8 x 512 host loop with
   ``SREvaluator(method="adaptive", adaptive_method="dopri5")``, the
   attempted-step telemetry of both budgets (``adaptive_solver_stats`` and
   the global kernel's), one ``optimise`` call (top-k 50, 5 Adam steps: the
   recompute takes ~4 s an epoch) through the adaptive gradient, and
   ``evaluate_candidate`` of the best under the RK4 evaluator; all seven
   launch counters read around it;
11. adaptive and trajectory kernel and plain-version times (CUDA events),
   and the global kernel's node-evals/s.

Any failed check raises, so the script exits non-zero and prints no result.
The last lines are a JSON line of per-kernel numbers, the card's name and
power limit, and ``{"ok": true, "device": {...}}``.
"""
from __future__ import annotations

import argparse
import json
import re
import statistics
import subprocess
import sys
import time

FULL = dict(islands=8, pop=512, max_nodes=32, depth=4, batch=16, horizon=10.0, dt=0.2,
            generations=5, timing_runs=5, plain_runs=3,
            fit_generations=20, top_k=50, gradient_steps=10, elite=0.1, interp_runs=20,
            adaptive_budget=500, adaptive_interval_steps=32, adaptive_short_t=10,
            adaptive_opt_steps=5)
KERNELS = ("sr_fitness", "reproduce", "interpreter", "sr_adaptive", "sr_rollout")  # csrc/<name>.cu
# NVIDIA H100 SXM data sheet: HBM3 bytes/s, float32 FLOP/s outside the tensor
# cores (both at the full 700 W power limit)
PEAK_BYTES_PER_S = 3.35e12
PEAK_F32_PER_S = 67e12
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


def ptxas_report(log: str):
    """``[(kernel<instance>, registers, stack bytes, spill store bytes)]``
    from ``nvcc -Xptxas -v`` output."""
    out, name, stack, spill = [], None, None, None
    for line in log.splitlines():
        m = re.search(r"Function properties for (\S+)", line)
        if m:
            k = re.search(r"\d([a-z_]+_kernel)(I(?:Li\d+E)+E)?", m.group(1))
            args = ",".join(re.findall(r"Li(\d+)E", k.group(2))) if k and k.group(2) else ""
            name = (f"{k.group(1)}<{args}>" if args else k.group(1)) if k else m.group(1)
            continue
        m = re.search(r"(\d+) bytes stack frame, (\d+) bytes spill stores", line)
        if m:
            stack, spill = int(m.group(1)), int(m.group(2))
        m = re.search(r"Used (\d+) registers", line)
        if m and name:
            out.append((name, int(m.group(1)), stack, spill))
            name = None
    return out


def bound(nbytes: float, ops: float):
    """``(ms, "bytes" | "operations")``: the least time the card could take
    to move ``nbytes`` and do ``ops`` float32 operations, and which sets it."""
    t_bytes = nbytes / PEAK_BYTES_PER_S * 1e3
    t_ops = ops / PEAK_F32_PER_S * 1e3
    return (t_bytes, "bytes") if t_bytes >= t_ops else (t_ops, "operations")


def nbytes(*tensors) -> int:
    return sum(t.numel() * t.element_size() for t in tensors)


# float32 operations of one operator row per device op id (+ - * /): the
# forward's one, and the VJP's cotangent expressions plus the two adds that
# accumulate them (csrc/interpreter.cu binary_vjp)
VJP_OPS = {0: 2, 1: 3, 2: 4, 3: 6}


def operator_rows(trees, fset):
    """Per device op id, the count of operator rows in ``trees``."""
    import torch

    ids = torch.tensor([-1, -1] + list(fset.device_op_ids), device=trees.ops.device)
    is_op = (trees.ops >= 2) & (trees.ops < fset.var_start)
    dev = ids[trees.ops.clamp(0, len(ids) - 1).long()]
    return {k: int(((dev == k) & is_op).sum()) for k in VJP_OPS}


def run(device, sizes=FULL) -> dict:
    """Phases 2-11 on ``device``; returns the numbers the script prints."""
    import torch

    from multitreegp_tpu_torch import GeneticProgramming
    from multitreegp_tpu_torch.core import cuda_reproduction as cr
    from multitreegp_tpu_torch.core import cuda_rollout as cf
    from multitreegp_tpu_torch.core import tile_surgery as ts
    from multitreegp_tpu_torch.core.registry import build_function_set
    from multitreegp_tpu_torch.core.trees import TreeTensors, rebuild_pointers, validate_host
    from multitreegp_tpu_torch.models.environments import VanDerPolOscillator
    from multitreegp_tpu_torch.models.evaluators import SREvaluator, generate_sr_data
    from multitreegp_tpu_torch.ops.initialization import make_population_sampler
    from multitreegp_tpu_torch.utils.metrics import node_evals_per_evaluation

    s = sizes
    n, islands, pop, b = s["max_nodes"], s["islands"], s["pop"], s["batch"]
    total_pop = islands * pop
    fset = build_function_set(OPERATORS, [["x0", "x1"]], [2])
    g = torch.Generator(device=device).manual_seed(0)
    ts_full = torch.arange(0.0, s["horizon"], s["dt"], device=device)
    x0s, _, ys_full, _ = generate_sr_data(VanDerPolOscillator(), g, ts_full, batch_size=b)
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
    within = float((rel <= 1e-4).float().mean())
    fin = torch.isfinite(mse) & torch.isfinite(ref) & both
    a_err = float((mse - ref).abs()[fin].max())
    bit_equal = bool(torch.equal(mse[both], ref[both]) and torch.equal(alive, ref_alive))
    check(agree >= 0.999, f"T=50 alive agreement {agree}")
    check(within >= 0.999, f"T=50 lanes within 1e-4: {within}")
    phase_line(f"phase 2 fitness kernel vs plain: T=5 max rel {rel5:.3e}; T={ts_full.shape[0]} alive "
        f"agreement {agree:.6f}, max rel {float(rel.max()):.3e}, max abs {a_err:.3e}, "
        f"bit-equal {bit_equal}; lanes {total_pop * b}, alive {int(alive.sum())}")
    out["fitness"] = dict(rel_t5=rel5, alive_agreement=agree, max_rel=float(rel.max()),
                          max_abs_err=a_err, bit_equal=bit_equal)

    # -- phase 3: reproduction kernel vs plain ---------------------------------
    cfg = ts.make_config(fset, n, s["depth"])
    elite = (int(0.1 * pop) // 2) * 2
    pairs = islands * ((pop - elite) // 2)
    lanes = pairs * fset.num_trees
    flat = trees.map(lambda a: a.reshape(-1, n))
    pick = torch.randint(0, flat.ops.shape[0], (2, lanes), generator=g, device=device)
    p1o, p1c = flat.ops[pick[0]].T.contiguous(), flat.const[pick[0]].T.contiguous()
    p2o, p2c = flat.ops[pick[1]].T.contiguous(), flat.const[pick[1]].T.contiguous()
    lane = torch.arange(lanes, device=device)
    cx = lane % 4 == 0  # a quarter crossover, the rest every copy/mutate/fresh pair
    act1 = torch.where(cx, 0, (lane // 4) % 3).to(torch.int32)
    act2 = torch.where(cx, 0, (lane // 12) % 3).to(torch.int32)
    vmask = fset.variable_mask.to(device)[lane % fset.num_trees].T.contiguous()
    u = torch.rand((cr.rows_per_lane(cfg), lanes), generator=g, device=device)
    args = (p1o, p1c, p2o, p2c, cx, act1, act2, vmask, u)
    got = cr.reproduce_lanes(*args, cfg)
    ref = cr.reproduce_lanes_plain(*args, cfg)
    same = (got[0] == ref[0]).all(0) & (got[2] == ref[2]).all(0)  # lanes with identical children
    ops_same = float(same.float().mean())
    c_err = max(float((got[i] - ref[i]).abs()[:, same].max()) for i in (1, 3))
    c_rel = max(float(((got[i] - ref[i]).abs() / ref[i].abs().clamp(min=1e-30))[:, same].max())
                for i in (1, 3))
    check(ops_same >= 0.999, f"child ops identical on {ops_same} of lanes")
    check(c_rel <= 1e-6, f"child const relative difference {c_rel}")
    slots = fset.slots(device)
    for ops_t, const_t in (got[:2], got[2:]):
        ops = ops_t.T.contiguous()
        c1, c2 = rebuild_pointers(ops, slots)
        validate_host(TreeTensors(ops, c1, c2, const_t.T), slots)
    phase_line(f"phase 3 reproduction kernel vs plain: {lanes} lanes, ops identical on {ops_same:.6f}, "
        f"const max abs {c_err:.3e} max rel {c_rel:.3e}; all {2 * lanes} children valid; "
        f"uniform rows per lane {u.shape[0]}")
    out["reproduce"] = dict(lanes=lanes, ops_identical=ops_same, max_abs_err=c_err, max_rel=c_rel)

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
                               ("rep_kernel", rep_k, s["timing_runs"]), ("rep_plain", rep_p, s["plain_runs"])):
            times[name] = cuda_time_ms(fn, runs, torch)
        phase_line(f"phase 5 times (median ms): fitness kernel {times['fit_kernel']:.3f} vs plain "
            f"{times['fit_plain']:.3f}; reproduction kernel {times['rep_kernel']:.3f} vs plain "
            f"{times['rep_plain']:.3f}; fitness kernel rate {node_evals / times['fit_kernel'] * 1e3:.4e} node-evals/s")
        out["times_ms"] = times
    out.update(interpreter_phase(device, s, trees, fset, g))
    out.update(const_opt_phase(device, s, data))
    if device.type == "cuda":
        out.update(interpreter_times(device, s, trees, fset, g))
    out.update(adaptive_kernels_phase(device, s, trees, fset, x0s, ts_full, ys_full))
    out.update(adaptive_path_phase(device, s, data))
    if device.type == "cuda":
        out.update(adaptive_times(device, s, trees, fset, x0s, ts_full, ys_full))

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

    def interp_bounds(shape):
        """#8 and #9 bounds at one of phase 6's shapes: every tree on every
        trajectory, one operation per operator row forward, the VJP's
        expressions backward."""
        rows_k, kb = interp[shape]["rows"], interp[shape]["bytes"]
        fwd_ops = sum(rows_k.values()) * b
        bwd_ops = sum((1 + VJP_OPS[k]) * v for k, v in rows_k.items()) * b
        return bound(kb["fwd"], fwd_ops), bound(kb["bwd"], bwd_ops)

    k_lanes = interp["recompute"]["lanes"]
    fwd_bound, bwd_bound = interp_bounds("recompute")
    fwd_bound_pop, bwd_bound_pop = interp_bounds("population")
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

    out["kernels"] = [
        row("sr_fitness", "sr_fitness.cu", "multitreegp_tpu/core/pallas_rollout.py:279",
            launches["sr_fitness"], a_err, times.get("fit_kernel"), times.get("fit_plain"),
            fit_bound, launches_const_opt=launches7["sr_fitness"]),
        row("reproduce", "reproduce.cu", "multitreegp_tpu/core/pallas_reproduction.py:53",
            launches["reproduce"], c_err, times.get("rep_kernel"), times.get("rep_plain"),
            rep_bound, launches_const_opt=launches7["reproduce"],
            launches_adaptive=launches10["reproduce"]),
        row("interpret_fwd", "interpreter.cu", "multitreegp_tpu/core/pallas_interpreter.py:142",
            launches7["interpret_fwd"], interp["max_abs_err_fwd"], it.get("fwd_kernel"),
            it.get("fwd_plain"), fwd_bound, lanes=k_lanes, device_ms=it.get("fwd_device"),
            launches_adaptive=launches10["interpret_fwd"],
            population=dict(lanes=interp["population"]["lanes"], ms=it_pop.get("fwd_kernel"),
                            device_ms=it_pop.get("fwd_device"), plain_ms=it_pop.get("fwd_plain"),
                            bound_ms=fwd_bound_pop[0], bound_by=fwd_bound_pop[1])),
        row("interpret_bwd", "interpreter.cu", "multitreegp_tpu/core/pallas_interpreter.py:178",
            launches7["interpret_bwd"], interp["max_abs_err_bwd"], it.get("bwd_kernel"),
            it.get("bwd_plain"), bwd_bound, lanes=k_lanes, device_ms=it.get("bwd_device"),
            launches_adaptive=launches10["interpret_bwd"],
            population=dict(lanes=interp["population"]["lanes"], ms=it_pop.get("bwd_kernel"),
                            device_ms=it_pop.get("bwd_device"), plain_ms=it_pop.get("bwd_plain"),
                            bound_ms=bwd_bound_pop[0], bound_by=bwd_bound_pop[1])),
    ]
    ak, at = out["adaptive_kernels"], out.get("adaptive_times_ms", {})
    g_long, i_short = ak[f"global_t{ts_full.shape[0]}"], ak[f"interval_t{s['adaptive_short_t']}"]
    ro = ak["rollout"]
    out["kernels"] += [
        row("sr_adaptive_global", "sr_adaptive.cu", "multitreegp_tpu/core/pallas_rollout.py:1828",
            launches10["sr_adaptive_global"], g_long["max_abs_err"], at.get("global_long"),
            g_long["plain_ms"], bound(g_long["bytes"], g_long["ops"]), t_steps=ts_full.shape[0],
            node_evals_per_s=at.get("global_node_evals_per_s")),
        row("sr_adaptive_interval", "sr_adaptive.cu", "multitreegp_tpu/core/pallas_rollout.py:1277",
            launches10["sr_adaptive_interval"], i_short["max_abs_err"], at.get("interval_short"),
            i_short["plain_ms"], bound(i_short["bytes"], i_short["ops"]), t_steps=s["adaptive_short_t"]),
        row("sr_rollout", "sr_rollout.cu", "multitreegp_tpu/core/pallas_rollout.py:163",
            launches10["sr_rollout"], ro["max_abs_err"], at.get("rollout"), ro["plain_ms"],
            bound(ro["bytes"], ro["ops"]), t_steps=ts_full.shape[0]),
    ]
    return out


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
        sync(device)
        f = compare(out.detach(), ref, f"{name} forward")
        c = compare(dconst, ref_c, f"{name} dconst")
        d = compare(ddata, ref_d, f"{name} ddata")
        err_f, err_b = max(err_f, f[0]), max(err_b, c[0], d[0])
        rows = operator_rows(cands, fset)
        res[name] = dict(
            lanes=k * b * m, rows=rows, bit_equal=dict(fwd=f[2], dconst=c[2], ddata=d[2]),
            max_rel=dict(fwd=f[1], dconst=c[1], ddata=d[1]), finite=dict(fwd=f[3], dconst=c[3]),
            bytes=dict(fwd=nbytes(cands.ops, cands.c2, cands.const, states) + k * b * m * 4,
                       bwd=nbytes(cands.ops, cands.c2, cands.const, states, cot)
                       + nbytes(cands.const, states)))
        phase_line(f"phase 6 interpreter kernels vs plain, {name}: {k}x{b}x{m} = {k * b * m} lanes, "
            f"N {n}; forward max rel {f[1]:.3e} bit-equal {f[2]} (finite {f[3]:.4f}); dconst "
            f"max rel {c[1]:.3e} bit-equal {c[2]}; ddata max rel {d[1]:.3e} bit-equal {d[2]}")
    res.update(max_abs_err_fwd=err_f, max_abs_err_bwd=err_b)
    return {"interpreter": res}


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
    gp = GeneticProgramming(
        num_generations=gens, population_size=s["pop"], fitness_function=SREvaluator(substeps=1),
        operator_list=OPERATORS, variable_list=[["x0", "x1"]], layer_sizes=[2],
        num_populations=s["islands"], max_nodes=n, max_init_depth=s["depth"],
        coefficient_optimisation=True, gradient_steps=s["gradient_steps"],
        coefficient_opt_top_k=s["top_k"], elite_percentage=s["elite"], device=device,
    )
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
        for fn in counters.values():
            fn.launches = 0
        sync(device)
        t0 = time.perf_counter()
        best, _, final_pops, _ = gp.fit(torch.Generator(device=device).manual_seed(2), data)
        launches = {k: fn.launches for k, fn in counters.items()}
    finally:
        for mod, name, fn in patched:
            setattr(mod, name, fn)
        cf.SRFitness.backward = staticmethod(backward)

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
    return {"const_opt": dict(launches=launches, rounds=summary, generation_ms=gen_ms,
                              best=best_l, drift_calls=drift_calls, round_profile=profile)}


def interpreter_times(device, s, trees, fset, g) -> dict:
    """Phase 8: CUDA-event times of kernels #8 and #9 and their plain
    versions at both shapes, in turns (plain, kernel, kernel, plain)."""
    import torch

    from multitreegp_tpu_torch.core import cuda_interpreter as ci
    from multitreegp_tpu_torch.core.interpreter import evaluate_trees_plain, evaluate_trees_vjp_plain

    res = {}
    for name, (cands, states, cot) in interpreter_cases(device, s, trees, fset, g).items():
        trees_b = cands.map(lambda a: a[:, None])
        fns = dict(
            fwd_plain=(lambda: evaluate_trees_plain(trees_b, states, fset), s["plain_runs"]),
            fwd_kernel=(lambda: ci.evaluate_trees_cuda(trees_b, states, fset), s["interp_runs"]),
            bwd_kernel=(lambda: ci.evaluate_trees_vjp_cuda(trees_b, states, cot, fset), s["interp_runs"]),
            bwd_plain=(lambda: evaluate_trees_vjp_plain(trees_b, states, cot, fset), s["plain_runs"]),
        )
        res[name] = {k: cuda_time_ms(fn, runs, torch) for k, (fn, runs) in fns.items()}
        t = res[name]
        # the kernels' own device time, without the wrapper's host work
        for key, kernel in (("fwd", "interpret_fwd_kernel"), ("bwd", "interpret_bwd_kernel")):
            fn, runs = fns[f"{key}_kernel"]
            prof = profile_device(lambda: [fn() for _ in range(runs)], torch)
            hits = [v for k_, v in prof["per_kernel"].items() if kernel in k_]
            t[f"{key}_device"] = sum(ms for _, ms in hits) / max(1, sum(c for c, _ in hits)) if hits else None
        dev = lambda v: "not measured" if v is None else f"{v:.4f}"
        phase_line(f"phase 8 interpreter times (median ms), {name} {cot.numel()} lanes: forward kernel "
            f"{t['fwd_kernel']:.4f} (device {dev(t['fwd_device'])}) vs plain {t['fwd_plain']:.3f}; "
            f"VJP kernel {t['bwd_kernel']:.4f} (device {dev(t['bwd_device'])}) vs plain "
            f"{t['bwd_plain']:.3f}")
    return {"interp_times_ms": res}


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
            float(diff.max()) if diff.numel() else 0.0, rel, same)


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
        ("global", t_short, ca.sr_fitness_adaptive_global_cuda, ca.sr_fitness_adaptive_global_plain, budget),
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
        same, alive_ok, steps_ok, max_rel, max_abs, rel, same_lane = compare_adaptive(got, ref)
        both = got[1] & ref[1]
        rest_rel = float(rel[~same_lane[both]].max()) if bool((~same_lane[both]).any()) else 0.0
        check(same >= 0.999, f"{kind} T={t_steps}: only {same:.6f} of lanes identical")
        check(rest_rel <= 1e-3, f"{kind} T={t_steps}: rel {rest_rel} on a lane alive in both")
        st = got[2].float()
        key = f"{kind}_t{t_steps}"
        res[key] = dict(identical=same, alive_agreement=alive_ok, steps_agreement=steps_ok,
                        max_rel=max_rel, max_abs_err=max_abs, plain_ms=plain_ms,
                        alive=float(got[1].float().mean()), steps_total=int(got[2].sum()),
                        steps_min=int(st.min()), steps_median=float(st.median()),
                        steps_max=int(st.max()), lanes=got[1].numel())
        r = res[key]
        r["ops"] = adaptive_ops(trees, fset, got[2], x0s.shape[1], t_steps)
        r["bytes"] = nbytes(trees.ops, trees.const, x0s, ts_, ys_) + got[1].numel() * 9
        phase_line(f"phase 9 {'#5 global' if kind == 'global' else '#4 per-interval'} adaptive kernel "
                   f"vs plain, dopri5, T={t_steps}, {r['lanes']} lanes: identical {same:.6f}, alive "
                   f"agreement {alive_ok:.6f}, steps agreement {steps_ok:.6f}, max rel (alive in both) "
                   f"{max_rel:.3e}, max abs {max_abs:.3e}; alive {r['alive']:.4f}; attempted steps "
                   f"total {r['steps_total']}, per lane min {r['steps_min']} median "
                   f"{r['steps_median']:.0f} max {r['steps_max']}; plain {plain_ms:.1f} ms")
    # #3: the trajectory, RK4 with one substep over the whole grid
    xs, alive = (cf.sr_rollout_cuda if on_card else cf.sr_rollout_plain)(trees, x0s, ts_full, fset, "rk4", 1)
    (ref, ref_alive), plain_ms = timed_plain(
        lambda: cf.sr_rollout_plain(trees, x0s, ts_full, fset, "rk4", 1), device)
    same_x = (xs == ref) | (torch.isnan(xs) & torch.isnan(ref))
    lane_same = same_x.all(dim=-1).all(dim=0) & (alive == ref_alive).all(dim=0)
    fin = torch.isfinite(xs) & torch.isfinite(ref)
    max_abs = float((xs - ref).abs()[fin].max()) if bool(fin.any()) else 0.0
    share = float(lane_same.float().mean())
    check(share == 1.0, f"trajectory kernel: {share:.6f} of lanes bit-equal")
    # rk4 per step and lane: 4 tree evaluations, the stage inputs 6d, the
    # stage sums 8d, the update 2d and the liveness test 2d; a lane that
    # dies stops stepping, and is counted for one step
    rows = ((trees.ops >= 2) & (trees.ops < fset.var_start)).sum(dim=(1, 2))[:, None]
    steps = torch.where(alive[-1], t_long - 1, 1)
    res["rollout"] = dict(identical=share, max_abs_err=max_abs, plain_ms=plain_ms,
                          alive=float(alive[-1].float().mean()), lanes=lane_same.numel(),
                          ops=float((steps * (4 * rows + 18 * x0s.shape[1])).sum()),
                          bytes=nbytes(trees.ops, trees.const, x0s, ts_full, xs) + alive[-1].numel())
    phase_line(f"phase 9 #3 trajectory kernel vs plain, rk4, T={t_long}, {lane_same.numel()} lanes: "
               f"bit-equal {share:.6f}, max abs {max_abs:.3e}; alive {res['rollout']['alive']:.4f}; "
               f"plain {plain_ms:.1f} ms")
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
    return {"adaptive_path": dict(generations=gens, best=best, loop_launches=loop_launches,
                                  launches=launches, telemetry=telemetry, optimise_ms=opt_ms,
                                  optimise_split_ms=split, unrefined_sum=float(before.sum()),
                                  refined_sum=float(refined.sum()),
                                  improved=int((refined < before).sum()), candidate_fitness=call_fit)}


def adaptive_times(device, s, trees, fset, x0s, ts_full, ys_full) -> dict:
    """Phase 11: CUDA-event times of kernels #5, #4 and #3 at the phase 9
    shapes (the plain versions' single runs were timed in phase 9)."""
    from multitreegp_tpu_torch.core import cuda_adaptive as ca
    from multitreegp_tpu_torch.core import cuda_rollout as cf
    from multitreegp_tpu_torch.utils.metrics import adaptive_node_evals

    import torch

    t_short = s["adaptive_short_t"]
    short = (ts_full[:t_short], ys_full[:, :t_short].contiguous())
    fns = dict(
        global_long=lambda: ca.sr_fitness_adaptive_global_cuda(trees, x0s, ts_full, ys_full, fset,
                                                               budget=s["adaptive_budget"]),
        global_short=lambda: ca.sr_fitness_adaptive_global_cuda(trees, x0s, *short, fset,
                                                                budget=s["adaptive_budget"]),
        interval_short=lambda: ca.sr_fitness_adaptive_interval_cuda(
            trees, x0s, *short, fset, max_steps=s["adaptive_interval_steps"], method="dopri5"),
        rollout=lambda: cf.sr_rollout_cuda(trees, x0s, ts_full, fset, "rk4", 1),
    )
    times = {k: cuda_time_ms(fn, s["timing_runs"], torch) for k, fn in fns.items()}
    steps = fns["global_long"]()[2]
    rate = adaptive_node_evals(steps, "dopri5", 2, s["max_nodes"]) / times["global_long"] * 1e3
    phase_line(f"phase 11 times (median ms): #5 global T={ts_full.shape[0]} {times['global_long']:.3f}, "
               f"T={t_short} {times['global_short']:.3f}; #4 per-interval T={t_short} "
               f"{times['interval_short']:.3f}; #3 trajectory T={ts_full.shape[0]} {times['rollout']:.3f}; "
               f"#5 rate {rate:.4e} node-evals/s")
    return {"adaptive_times_ms": dict(times, global_node_evals_per_s=rate)}


def sync(device) -> None:
    import torch

    if device.type == "cuda":
        torch.cuda.synchronize(device)


def main(argv=None) -> int:
    parser = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    parser.add_argument("--out", help="also write every number as JSON to this file")
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
    _build.build(*KERNELS)  # one nvcc per source, in parallel
    for name in KERNELS:
        _build.load(name)
    build_s = time.perf_counter() - t0
    phase_line(f"phase 1 device: {smi}; torch {torch.__version__}, CUDA {torch.version.cuda}, "
        f"{torch.cuda.get_device_name(0)} x{torch.cuda.device_count()}; kernels built in {build_s:.1f} s "
        f"(nvcc {', '.join(f'{k} {v:.1f} s' for k, v in _build.build_seconds.items())})")
    resources = {name: ptxas_report(log) for name, log in _build.build_logs.items()}
    for name, rows in resources.items():
        phase_line(f"phase 1 ptxas {name}: " + "; ".join(
            f"{k} {r} registers, {st} B stack, {sp} B spilled" for k, r, st, sp in rows))

    out = run(device)
    out["device"] = dict(nvidia_smi=smi, torch=torch.__version__, cuda=torch.version.cuda, build_s=build_s,
                         nvcc_s=dict(_build.build_seconds), ptxas=resources)
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
