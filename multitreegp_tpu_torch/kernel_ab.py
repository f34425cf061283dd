"""Time the SR kernels of two checkouts of this package in turns, on one card.

    python -m multitreegp_tpu_torch.kernel_ab OTHER_ROOT

``OTHER_ROOT`` is a directory holding another ``multitreegp_tpu_torch``
(for example an unpacked ``git archive`` of a parent commit). The script runs
four processes, OTHER, this, this, OTHER: each builds the kernels from its
own sources and prints the CUDA-event median times of the wrapper calls,
and each kernel's mean device time per launch from torch.profiler, at the
main path's shapes (8 x 512 candidates of 2 trees, ``max_nodes=32``, ``+ - * /``, 16
Van der Pol trajectories), of the fused SR fitness (kernel #1, RK4, T = 50),
the fused reproduction (kernel #2, one generation's 3,696 lanes: the
operands its own ``reproduce_pairs`` gives it, in that version's layout),
the trajectory rollout (#3, RK4, T = 50) and the global-budget adaptive
fitness (#5, dopri5, budget 500, T = 50), and of the fixed-step policy
rollout (#6, static Acrobot, 4096 x 16 lanes, RK4 x 4, T = 250). Two
versions compare only within one such run.
"""
from __future__ import annotations

import argparse
import re
import statistics
import subprocess
import sys
from pathlib import Path

THIS_ROOT = Path(__file__).resolve().parent.parent


def time_kernels(root: Path) -> str:
    """One line of times for the package under ``root``."""
    sys.path.insert(0, str(root))
    import torch

    import multitreegp_tpu_torch as pkg
    from multitreegp_tpu_torch.core import cuda_adaptive as ca
    from multitreegp_tpu_torch.core import cuda_rollout as cf
    from multitreegp_tpu_torch.core.registry import build_function_set
    from multitreegp_tpu_torch.models.environments import VanDerPolOscillator
    from multitreegp_tpu_torch.models.evaluators import generate_sr_data
    from multitreegp_tpu_torch.ops.initialization import make_population_sampler

    if Path(pkg.__file__).resolve().parent.parent != root:
        raise RuntimeError(f"imported {pkg.__file__}, not the package under {root}")
    pkg._build.build("sr_fitness", "reproduce", "sr_rollout", "sr_adaptive", "policy")  # in parallel
    dev = torch.device("cuda")
    fset = build_function_set([("+", 2, 0.5), ("-", 2, 0.1), ("*", 2, 0.5), ("/", 2, 0.1)],
                              [["x0", "x1"]], [2])
    g = torch.Generator(device=dev).manual_seed(0)
    ts = torch.arange(0.0, 10.0, 0.2, device=dev)
    x0s, _, ys, _ = generate_sr_data(VanDerPolOscillator(), g, ts, batch_size=16)
    trees = make_population_sampler(fset, 4, 32)(g, 4096)[0]

    def median_ms(fn, runs):
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

    def device_ms(fn, kernel, runs):
        """Mean device time of one launch of ``kernel`` (its name in the
        trace) over the launches traced in ``runs`` calls, by torch.profiler:
        the events above also hold the wrapper's host work when the kernel is
        short."""
        from torch.profiler import ProfilerActivity, profile

        fn()
        torch.cuda.synchronize()
        with profile(activities=[ProfilerActivity.CUDA]) as prof:
            for _ in range(runs):
                fn()
            torch.cuda.synchronize()
        pattern = re.compile(rf"::{kernel}[<(]")
        spans = [e.time_range.end - e.time_range.start for e in prof.events()
                 if e.device_type == torch.autograd.DeviceType.CUDA and pattern.search(e.name)]
        if not spans:  # the tracer may drop an event or two of long runs
            raise RuntimeError(f"no launch of {kernel} traced in {runs} calls")
        return sum(spans) / len(spans) / 1e3

    runs = {
        "#1": (lambda: cf.sr_fitness_cuda(trees, x0s, ts, ys, fset, "rk4", 1), "sr_fitness_kernel", 30),
        "#2": (reproduction_launch(trees, fset, g), "reproduce_kernel", 30),
        "#3": (lambda: cf.sr_rollout_cuda(trees, x0s, ts, fset, "rk4", 1), "sr_rollout_kernel", 30),
        "#5": (lambda: ca.sr_fitness_adaptive_global_cuda(trees, x0s, ts, ys, fset, budget=500),
               "adaptive_global_kernel", 7),
        "#6": (policy_launch(g), "policy_kernel", 7),
    }
    return "; ".join(f"{k} {median_ms(fn, n):.4f} ms (device {device_ms(fn, name, n):.4f})"
                     for k, (fn, name, n) in runs.items())


def reproduction_launch(trees, fset, g):
    """Kernel #2's launch on one main-path generation: 8 islands x 231 pairs
    of parents drawn from ``trees``, a quarter crossover, the rest every
    copy / mutate / fresh pair; the operands are those the package's own
    ``reproduce_pairs`` hands its kernel, captured once."""
    import torch

    from multitreegp_tpu_torch.core import cuda_reproduction as cr
    from multitreegp_tpu_torch.core import tile_surgery as ts_

    dev, n, m = trees.ops.device, trees.max_nodes, trees.batch_shape[-1]
    pairs = 8 * 231
    pick = torch.randint(0, trees.ops.shape[0], (2, pairs), generator=g, device=dev)
    left, right = trees.map(lambda a: a[pick[0]]), trees.map(lambda a: a[pick[1]])
    lane = torch.arange(pairs * m, device=dev).reshape(pairs, m)
    cx = lane % 4 == 0
    act1 = torch.where(cx, 0, (lane // 4) % 3)
    act2 = torch.where(cx, 0, (lane // 12) % 3)
    cfg = ts_.make_config(fset, n, 4)
    captured = []
    real = cr.reproduce_lanes
    cr.reproduce_lanes = lambda *args: captured.append(args) or real(*args)
    try:
        cr.reproduce_pairs(left, right, cx, act1, act2, fset, cfg, g)
    finally:
        cr.reproduce_lanes = real
    return lambda: cr.reproduce_lanes_cuda(*captured[0])


def policy_launch(g):
    """Kernel #6 on the static Acrobot policy workload at full width."""
    from multitreegp_tpu_torch.core import cuda_policy as cp
    from multitreegp_tpu_torch.core.registry import build_function_set
    from multitreegp_tpu_torch.models.environments import Acrobot
    from multitreegp_tpu_torch.models.evaluators import generate_control_data
    from multitreegp_tpu_torch.ops.initialization import make_population_sampler
    import torch

    env = Acrobot(0.0, 0.0)
    ops = [("+", 2), ("-", 2), ("*", 2), ("sin", 1), ("cos", 1)]  # chip_smoke.py POLICY_OPERATORS
    fset = build_function_set(ops, [[f"y{i}" for i in range(env.n_obs)]], [env.n_control])
    ts = torch.arange(0.0, 50.0, 0.2, device=g.device)
    x0, ts, tgt, _, _, par = generate_control_data(env, g, ts, batch_size=16)
    trees = make_population_sampler(fset, 4, 30)(g, 4096)[0]
    return lambda: cp.rollout_policy(trees, x0, ts, tgt, par, env, fset, 4, "rk4", 0)


def main(argv=None) -> int:
    parser = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    parser.add_argument("other", help="root of the other checkout")
    parser.add_argument("--time", action="store_true", help=argparse.SUPPRESS)
    opts = parser.parse_args(argv)
    if opts.time:
        print(time_kernels(Path(opts.other).resolve()), flush=True)
        return 0
    other = Path(opts.other).resolve()
    for label, root in (("other", other), ("this", THIS_ROOT), ("this", THIS_ROOT), ("other", other)):
        # this file, run as a script, times the package under `root`
        proc = subprocess.run([sys.executable, str(Path(__file__).resolve()), str(root), "--time"],
                              cwd=root, capture_output=True, text=True)
        if proc.returncode != 0:
            print(proc.stderr, file=sys.stderr)
            return proc.returncode
        print(f"kernel_ab {label} ({root}): {proc.stdout.strip()}", flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
