#!/usr/bin/env python3
"""GPU smoke run of the PyTorch/CUDA port (``multitreegp_tpu_torch``).

Run from the repository root on a machine with one NVIDIA Hopper GPU::

    python3 chip_smoke.py [--out results.json]

It builds both hand-written kernels from ``multitreegp_tpu_torch/csrc`` with
``nvcc`` and drives the port's main path at the full width of the flagship
workload (symbolic regression of Van der Pol; 8 islands x 512 candidates,
2 trees of ``max_nodes=32``, operators + - * /, 16 trajectories, 50 save
points, RK4 with one substep). Phases, one line each:

1. device: ``nvidia-smi`` name and power limit, torch/CUDA versions, build time;
2. fitness kernel vs its plain PyTorch version (T = 5 and T = 50);
3. reproduction kernel vs its plain version on the main path's 3696 lanes;
4. the main path: ``initialize_population`` then 5 x (``evaluate_population``
   + ``evolve``), with the kernels' launch counters read around it;
5. kernel and plain-version times (CUDA events, median of several runs).

Any failed check raises, so the script exits non-zero and prints no result.
The last lines are a JSON line of per-kernel numbers, the card's name and
power limit, and ``{"ok": true, "device": {...}}``.
"""
from __future__ import annotations

import argparse
import json
import statistics
import subprocess
import sys
import time

FULL = dict(islands=8, pop=512, max_nodes=32, depth=4, batch=16, horizon=10.0, dt=0.2,
            generations=5, timing_runs=5, plain_runs=3)
OPERATORS = [("+", 2, 0.5), ("-", 2, 0.1), ("*", 2, 0.5), ("/", 2, 0.1)]


def check(ok: bool, msg: str) -> None:
    if not ok:
        raise RuntimeError(f"check failed: {msg}")


def say(*parts) -> None:
    print(*parts, flush=True)


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


def run(device, sizes=FULL) -> dict:
    """Phases 2-5 on ``device``; returns the numbers the script prints."""
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
    say(f"phase 2 fitness kernel vs plain: T=5 max rel {rel5:.3e}; T={ts_full.shape[0]} alive "
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
    say(f"phase 3 reproduction kernel vs plain: {lanes} lanes, ops identical on {ops_same:.6f}, "
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
        say(f"phase 4 main path gen {i}: eval {rec['eval_ms']:.3f} ms, evolve {rec['evolve_ms']:.3f} ms, "
            f"{rec['node_evals_per_s']:.4e} node-evals/s, best fitness {rec['best']:.6g}")
    say(f"phase 4 main path: {islands}x{pop} candidates, launches {launches}, best {best_str}")
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
        say(f"phase 5 times (median ms): fitness kernel {times['fit_kernel']:.3f} vs plain "
            f"{times['fit_plain']:.3f}; reproduction kernel {times['rep_kernel']:.3f} vs plain "
            f"{times['rep_plain']:.3f}; fitness kernel rate {node_evals / times['fit_kernel'] * 1e3:.4e} node-evals/s")
        out["times_ms"] = times
    out["kernels"] = [
        dict(name="sr_fitness", route="cuda", source="multitreegp_tpu_torch/csrc/sr_fitness.cu",
             replaces="multitreegp_tpu/core/pallas_rollout.py:279", launches=launches["sr_fitness"],
             max_abs_err=a_err, ms=out.get("times_ms", {}).get("fit_kernel"),
             plain_ms=out.get("times_ms", {}).get("fit_plain")),
        dict(name="reproduce", route="cuda", source="multitreegp_tpu_torch/csrc/reproduce.cu",
             replaces="multitreegp_tpu/core/pallas_reproduction.py:53", launches=launches["reproduce"],
             max_abs_err=c_err, ms=out.get("times_ms", {}).get("rep_kernel"),
             plain_ms=out.get("times_ms", {}).get("rep_plain")),
    ]
    return out


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
    for name in ("sr_fitness", "reproduce"):
        _build.load(name)
    build_s = time.perf_counter() - t0
    say(f"phase 1 device: {smi}; torch {torch.__version__}, CUDA {torch.version.cuda}, "
        f"{torch.cuda.get_device_name(0)} x{torch.cuda.device_count()}; kernels built in {build_s:.1f} s "
        f"(nvcc {', '.join(f'{k} {v:.1f} s' for k, v in _build.build_seconds.items())})")

    out = run(device)
    out["device"] = dict(nvidia_smi=smi, torch=torch.__version__, cuda=torch.version.cuda, build_s=build_s,
                         nvcc_s=dict(_build.build_seconds))
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
