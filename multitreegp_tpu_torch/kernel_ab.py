"""Time the tree kernels of two checkouts of this package in turns, on one card.

    python -m multitreegp_tpu_torch.kernel_ab OTHER_ROOT

``OTHER_ROOT`` is a directory holding another ``multitreegp_tpu_torch``
(for example an unpacked ``git archive`` of a parent commit). The script runs
four processes, OTHER, this, this, OTHER: each builds the kernels from its
own sources and prints the CUDA-event median times of the wrapper calls, and
each kernel's mean device time per launch from torch.profiler, at the main
path's shapes (8 x 512 candidates of 2 trees, ``max_nodes=32``, ``+ - * /``,
16 Van der Pol trajectories), of the fused SR fitness (kernel #1, RK4,
T = 50), the fused reproduction (kernel #2, one generation's 3,696 lanes: the
operands its own ``reproduce_pairs`` gives it, in that version's layout),
the trajectory rollout (#3, RK4, T = 50; also at the inspection shape of
``evaluate_candidate``, one candidate x 16 trajectories), the per-interval
adaptive fitness (#4, dopri5, 32 steps per interval, T = 10) and the
global-budget one (#5, dopri5, budget 500, T = 50), and at the control path's
shapes (Acrobot, 4096 policies of ``max_nodes=30``, ``+ - * sin cos``, x 16
trajectories, T = 250) of the fixed-step policy rollout (#6, RK4 x 4) and the
adaptive one (#7, dopri5, 8 steps per interval), static and dynamic
(``state_size=2``), and of the interpreter's forward (#8) and VJP (#9)
through their public wrappers in the constant-optimisation recompute's
layout (trees ``(K, 1, 2, 32)`` against states ``(K, 16, 1, 2)``) at K = 50
(1,600 lanes) and K = 4096 (131,072 lanes), and of the branch probe (#10,
256 tiles) in each of its modes, and in the skip modes on tiles past the
threshold from the start (``early_input``: one round's work). A process that
built the kernels first prints each ``nvcc``'s seconds and ptxas's
registers, stack frame and spills per instance of the policy kernels for
Acrobot at N <= 32, of the adaptive SR kernels and the trajectory kernel at
state dim 2, of the interpreter kernels and of the probe. Every process
prints a digest of each library's machine code (``cuobjdump -sass``, its
kernels' instructions), so that two versions whose builds compiled to the
same code show the same digests: every library's default build, the tree
libraries' extended build (``_ext``) and, where the package has user
operators, their user build of gplearn's protected set (``_user``), and,
where the package has wide-state builds, those of each source that compiles
a wide instance (``_wide``, ``_ext_wide``, ``_user_wide``: the SR sources,
and ``policy`` since it has one; a source without one is not built wide).
Two versions compare only within one such run. With ``--sass`` the script runs
OTHER, then this, and prints the builds' ``nvcc`` seconds and the digests
only.
"""
from __future__ import annotations

import argparse
import hashlib
import re
import statistics
import subprocess
import sys
from pathlib import Path

THIS_ROOT = Path(__file__).resolve().parent.parent


def time_kernels(root: Path, sass_only: bool = False) -> str:
    """One line of times for the package under ``root`` (with ``sass_only``,
    the builds and digests alone)."""
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
    variants = build_variants(pkg)
    built = {k: v for k, v in pkg._build.build_seconds.items() if v > 0}
    if built:  # printed before the runs, so a run that fails leaves it
        line = "nvcc " + ", ".join(f"{k} {v:.1f} s" for k, v in built.items())
        shown = (("policy", lambda k: "AcrobotEnv<0" in k and k.endswith(",32>")),
                 ("sr_adaptive", lambda k: re.search(r"_kernel<2,", k)),
                 ("sr_rollout", lambda k: re.search(r"_kernel<2,", k)),
                 ("interpreter", lambda k: True), ("branch_probe", lambda k: True),
                 *((f"{name}_wide", lambda k: "Env" not in k or "AcrobotEnv<0" in k)
                   for name in wide_libraries(pkg._build)))
        for name, keep in shown:
            if name in pkg._build.build_logs:
                line += f"; ptxas {name} " + ", ".join(
                    f"{k} {r} registers {st} B stack {sp} B spilled"
                    for k, r, st, sp in ptxas_report(pkg._build.build_logs[name]) if keep(k))
        print(line, flush=True)
    print(sass_digests(pkg._build, variants), flush=True)
    if sass_only:
        return "sass only"
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
        "#3 P=1": (lambda: cf.sr_rollout_cuda(trees[:1], x0s, ts, fset, "rk4", 1), "sr_rollout_kernel",
                   50),
        "#4": (lambda: ca.sr_fitness_adaptive_interval_cuda(trees, x0s, ts[:10], ys[:, :10].contiguous(),
                                                           fset, max_steps=32, method="dopri5"),
               "adaptive_interval_kernel", 7),
        "#5": (lambda: ca.sr_fitness_adaptive_global_cuda(trees, x0s, ts, ys, fset, budget=500),
               "adaptive_global_kernel", 7),
    }
    for key, fn in policy_launches(g).items():
        runs[key] = (fn, "policy_kernel" if key.startswith("#6") else "policy_adaptive_kernel", 7)
    times = [f"{k} {median_ms(fn, n):.4f} ms (device {device_ms(fn, name, n):.4f})"
             for k, (fn, name, n) in runs.items()]
    for key, (fn, name) in interpreter_launches(trees, g).items():
        times.append(f"{key} {median_ms(fn, 50):.4f} ms (device {device_ms(fn, name, 50):.4f})")
    from multitreegp_tpu_torch.tools import branch_probe as bp

    always = None
    for mode in bp.MODES:  # `always` first: the others' device time as a ratio of its
        x = bp.probe_input(mode, bp.REPS, dev)
        fn = lambda: bp.probe_cuda(x, mode)
        dev_ms = device_ms(fn, "probe_kernel", 30)
        always = always or dev_ms
        times.append(f"#10 {mode} {median_ms(fn, 30):.4f} ms (device {dev_ms:.4f}, "
                     f"{dev_ms / always:.3f}x of always)")
    # branch_probe.early_input, made here so that an older checkout is timed too
    early = torch.full((bp.REPS,) + bp.TILE, 3.0, device=dev)
    for mode in ("when", "dynfori", "dynval"):  # one round's work, then the flag is down
        fn = lambda: bp.probe_cuda(early, mode)
        times.append(f"#10 {mode} early (device {device_ms(fn, 'probe_kernel', 30):.4f})")
    return "; ".join(times)


LIBRARIES = ("sr_fitness", "reproduce", "sr_rollout", "sr_adaptive", "policy", "interpreter",
             "branch_probe")
# the sources with an extended and a user build (the tree kernels #1, #3-#9)
TREE_LIBRARIES = ("sr_fitness", "sr_rollout", "sr_adaptive", "policy", "interpreter")
# the sources that may have a wide-state form of each build (#1, #3, #4/#5,
# #6/#7): those of a package whose source compiles a wide instance
WIDE_LIBRARIES = ("sr_fitness", "sr_rollout", "sr_adaptive", "policy")


def wide_libraries(build):
    """The sources of ``build`` (a package's ``_build`` module) whose source
    compiles a wide-state instance (``MTGP_WIDE_STATE``)."""
    return tuple(name for name in WIDE_LIBRARIES
                 if b"MTGP_WIDE_STATE" in (build.CSRC_DIR / f"{name}.cu").read_bytes())


def variant_libraries(build, tag: str):
    """The sources built in the variant ``tag`` of :func:`build_variants`."""
    return wide_libraries(build) if tag.endswith("wide") else TREE_LIBRARIES


def build_variants(pkg) -> dict:
    """Build every library of ``pkg`` (a package under its root), the tree
    libraries also in their extended build and, where the package has user
    operators, in the user build of gplearn's protected set
    (``registry.gplearn_operators``), and where it has them the SR sources'
    wide-state form of each (``_build.widened``): every ``nvcc`` at once.
    Returns ``{tag: variant}`` of the builds made besides the default one."""
    from concurrent.futures import ThreadPoolExecutor
    import inspect

    build = pkg._build
    # an older checkout's build() names its flag `extended`
    kw = "variant" if "variant" in inspect.signature(build.build).parameters else "extended"
    variants = {"ext": True}
    registry = __import__(f"{pkg.__name__}.core.registry", fromlist=["registry"])
    if hasattr(registry, "gplearn_operators"):
        fset = registry.build_function_set(registry.gplearn_operators(), [["x0", "x1"]], [2])
        variants["user"] = fset.variant
    if hasattr(build, "widened"):
        variants.update({f"{tag}_wide": build.widened(v) for tag, v in list(variants.items())},
                        wide=build.widened(False))
    with ThreadPoolExecutor(len(variants)) as pool:
        jobs = [pool.submit(build.build, *variant_libraries(build, tag), **{kw: v})
                for tag, v in variants.items()]
        build.build(*LIBRARIES)
        for job in jobs:
            job.result()
    return variants


_INSTRUCTION = re.compile(r"/\*[0-9a-f]{4,}\*/\s+([^;]*;)")
# an interpreter kernel's name and template arguments in its mangled name
_INTERP_INSTANCE = re.compile(r"(interpret_(?:fwd|bwd)_(?:kernel|wide))I((?:L[a-z]\d+E)+)E")


def sass_digests(build, variants=None) -> str:
    """One line: per library of ``build`` (a package's ``_build`` module),
    its kernel count and a digest of their instructions as ``cuobjdump
    -sass`` prints them: each kernel's instruction lines only (its name
    carries a hash of the source's path, in its anonymous namespace), the
    kernels' digests sorted; then the same of the tree libraries in each of
    ``variants`` (``{tag: variant}``, :func:`build_variants`), as
    ``<name>_<tag>``; for the interpreter libraries also each instance's
    digest (``interpret_fwd_kernel<32,1>``), so that an instance whose code
    is unchanged shows it beside a new one."""
    tool = Path(build.find_nvcc()).parent / "cuobjdump"
    if not tool.is_file():
        return f"sass: no {tool}"
    libraries = [(name, name, False) for name in LIBRARIES]
    for tag, variant in (variants or {}).items():
        libraries += [(f"{name}_{tag}", name, variant) for name in variant_libraries(build, tag)]
    parts = []
    for label, name, variant in libraries:
        path = build.library_path(name, variant) if variant is not False else build.library_path(name)
        text = subprocess.run([str(tool), "-sass", str(path)], capture_output=True, text=True).stdout
        functions = re.split(r"\n\s*Function : ", text)[1:]
        kernels = sorted(hashlib.sha256("\n".join(_INSTRUCTION.findall(k)).encode()).hexdigest()
                         for k in functions)
        digest = hashlib.sha256("".join(kernels).encode()).hexdigest()[:16]
        parts.append(f"{label} {len(kernels)} kernels {digest}")
        if name == "interpreter":
            instances = []
            for k in functions:
                m = _INTERP_INSTANCE.search(k.split("\n", 1)[0])
                if m:
                    args = ",".join(re.findall(r"L[a-z](\d+)E", m.group(2)))
                    code = hashlib.sha256("\n".join(_INSTRUCTION.findall(k)).encode()).hexdigest()[:12]
                    instances.append(f"{m.group(1)}<{args}> {code}")
            parts.append(f"{label} instances [{'; '.join(sorted(instances))}]")
    return "sass " + ", ".join(parts)


def interpreter_launches(trees, g):
    """Kernels #8 and #9 through their public wrappers in the recompute's
    layout: the first K candidates' trees ``(K, 1, 2, N)`` against states
    ``(K, 16, 1, 2)``, the roots' cotangent ``(K, 16, 2)``."""
    import torch

    from multitreegp_tpu_torch.core import cuda_interpreter as ci
    from multitreegp_tpu_torch.core.registry import build_function_set

    fset = build_function_set([("+", 2, 0.5), ("-", 2, 0.1), ("*", 2, 0.5), ("/", 2, 0.1)],
                              [["x0", "x1"]], [2])
    out = {}
    for k in (50, trees.ops.shape[0]):
        cands = trees.map(lambda a: a[:k, None])
        states = torch.randn((k, 16, 1, 2), generator=g, device=g.device) * 2
        cot = torch.randn((k, 16, 2), generator=g, device=g.device)
        lanes = k * 16 * 2
        out[f"#8 {lanes}"] = (lambda c=cands, s=states: ci.evaluate_trees_cuda(c, s, fset),
                              "interpret_fwd_kernel")
        out[f"#9 {lanes}"] = (lambda c=cands, s=states, y=cot: ci.evaluate_trees_vjp_cuda(c, s, y, fset),
                              "interpret_bwd_kernel")
    return out


def ptxas_report(log: str):
    """``[(kernel<instance>, registers, stack bytes, spill store bytes)]``
    from ``nvcc -Xptxas -v`` output; the instance lists the kernel's
    template arguments (a plant as its struct's name)."""
    out, name, stack, spill = [], None, None, None
    for line in log.splitlines():
        m = re.search(r"Function properties for (\S+)", line)
        if m:
            k = re.search(r"\d([a-z_]+_kernel)I(.*)E[Ev]", m.group(1))
            if k:
                args = re.findall(r"\d+([A-Za-z][A-Za-z0-9]*Env)(?:IL[b]([01])EE)?|L[ib](\d+)E", k.group(2))
                parts = [f"{env}<{flag}>" if env and flag else env or num for env, flag, num in args]
                name = f"{k.group(1)}<{','.join(parts)}>"
            else:
                name = m.group(1)
            continue
        m = re.search(r"(\d+) bytes stack frame, (\d+) bytes spill stores", line)
        if m:
            stack, spill = int(m.group(1)), int(m.group(2))
        m = re.search(r"Used (\d+) registers", line)
        if m and name:
            out.append((name, int(m.group(1)), stack, spill))
            name = None
    return out


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


def policy_launches(g):
    """Kernels #6 and #7 on the static and dynamic Acrobot policy workloads
    at full width (chip_smoke.py's phases 13-14)."""
    from multitreegp_tpu_torch.core import cuda_policy as cp
    from multitreegp_tpu_torch.core.registry import build_function_set
    from multitreegp_tpu_torch.models.environments import Acrobot
    from multitreegp_tpu_torch.models.evaluators import generate_control_data
    from multitreegp_tpu_torch.ops.initialization import make_population_sampler
    import torch

    env = Acrobot(0.0, 0.0)
    ops = [("+", 2), ("-", 2), ("*", 2), ("sin", 1), ("cos", 1)]  # chip_smoke.py POLICY_OPERATORS
    ys = [f"y{i}" for i in range(env.n_obs)]
    ts = torch.arange(0.0, 50.0, 0.2, device=g.device)
    x0, ts, tgt, _, _, par = generate_control_data(env, g, ts, batch_size=16)
    out = {}
    for name, layers, sizes, ss in (("static", [ys], [1], 0),
                                    ("dynamic", [ys + ["a0", "a1", "u0"], ["a0", "a1"]], [2, 1], 2)):
        fset = build_function_set(ops, layers, sizes)
        trees = make_population_sampler(fset, 4, 30)(g, 4096)[0]
        args = (trees, x0, ts, tgt, par, env, fset)
        out[f"#6 {name}"] = lambda a=args, ss=ss: cp.rollout_policy(*a, 4, "rk4", ss)
        out[f"#7 {name}"] = lambda a=args, ss=ss: cp.rollout_policy_adaptive(
            *a, 1e-4, 1e-4, 8, "dopri5", 0.9, ss)
    return out


def main(argv=None) -> int:
    parser = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    parser.add_argument("other", help="root of the other checkout")
    parser.add_argument("--sass", action="store_true",
                        help="build and print the machine code digests only (other, this)")
    parser.add_argument("--time", action="store_true", help=argparse.SUPPRESS)
    opts = parser.parse_args(argv)
    if opts.time:
        print(time_kernels(Path(opts.other).resolve(), opts.sass), flush=True)
        return 0
    other = Path(opts.other).resolve()
    order = (("other", other), ("this", THIS_ROOT))
    if not opts.sass:
        order += order[::-1]
    for label, root in order:
        # this file, run as a script, times the package under `root`
        cmd = [sys.executable, str(Path(__file__).resolve()), str(root), "--time"]
        proc = subprocess.run(cmd + (["--sass"] if opts.sass else []), cwd=root, capture_output=True,
                              text=True)
        for line in proc.stdout.strip().splitlines():
            print(f"kernel_ab {label} ({root}): {line}", flush=True)
        if proc.returncode != 0:
            print(proc.stderr, file=sys.stderr)
            return proc.returncode
    return 0


if __name__ == "__main__":
    sys.exit(main())
