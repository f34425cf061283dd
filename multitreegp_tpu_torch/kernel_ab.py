"""Time the SR kernels of two checkouts of this package in turns, on one card.

    python -m multitreegp_tpu_torch.kernel_ab OTHER_ROOT

``OTHER_ROOT`` is a directory holding another ``multitreegp_tpu_torch``
(for example an unpacked ``git archive`` of a parent commit). The script runs
four processes, OTHER, this, this, OTHER: each builds the kernels from its
own sources and prints the CUDA-event median times of the fused SR fitness
(kernel #1, RK4, T = 50) and the global-budget adaptive fitness (kernel #5,
dopri5, budget 500, T = 50) at the main path's shapes (8 x 512 candidates of
2 trees, ``max_nodes=32``, ``+ - * /``, 16 Van der Pol trajectories). Two
versions compare only within one such run.
"""
from __future__ import annotations

import argparse
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

    fit = median_ms(lambda: cf.sr_fitness_cuda(trees, x0s, ts, ys, fset, "rk4", 1), 30)
    adaptive = median_ms(lambda: ca.sr_fitness_adaptive_global_cuda(trees, x0s, ts, ys, fset,
                                                                    budget=500), 7)
    return f"#1 {fit:.4f} ms; #5 {adaptive:.4f} ms"


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
