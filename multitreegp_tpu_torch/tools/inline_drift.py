"""Does the adaptive policy kernel (#7) compute the same lanes with its drift
inlined at the embedded step's call sites?

``csrc/policy.cu`` calls the closed-loop drift of #7 out of line
(``__noinline__ drift_v``). This tool builds variants of that source in which
the drift is inlined at a chosen set of ``rk_step``'s call sites, at the
shipped flags or with the device optimisers off (``-G``; ``-Xcicc -O0
-Xptxas -O0``) or ``ptxas`` at ``-O0``-``-O2``, and holds each one against
the shipped kernel, lane by lane (states, controls, alive counts, attempted
steps), on the control path's adaptive lanes (Acrobot, 8 x 512 policies x
16 trajectories, ``+ - * sin cos``, ``max_nodes=30``, Dormand-Prince or
Bogacki-Shampine with 8 steps per interval, T = 11; static and dynamic). Each
comparison runs in a process of its own, which also reruns the shipped
kernel after the variant and checks a canary tensor allocated before it, so
a variant that writes outside its outputs shows as such and cannot touch
another comparison. The variants are written into the build directory,
never into ``csrc``.

A call site is a bit of the mask: 0-2 are Bogacki-Shampine's three stage
calls (k2, k3, k_last), 3-8 Dormand-Prince's six (stages 2-7), 9 the
up-front FSAL evaluation of the lane. A variant builds only the Acrobot
instances at ``N <= 32``, so two dozen build in parallel in about a minute
and a half.

Usage (on the card)::

    python -m multitreegp_tpu_torch.tools.inline_drift [--sanitize] [--out FILE]
    python -m multitreegp_tpu_torch.tools.inline_drift --time
    python -m multitreegp_tpu_torch.tools.inline_drift --host-sanitize   # on the CPU

``--sanitize`` also reruns the shipped kernel, the all-sites variant and the
first single-site variant that differs on 512 policies under
``compute-sanitizer`` (``memcheck``, ``initcheck``); ``--time`` times the
shipped source against the all-sites variant (at ``ptxas -O0`` and at the
shipped flags) at T = 250, device time per launch by torch.profiler, in
turns (shipped, variant, variant, shipped); ``--host-sanitize`` runs the
host build of ``policy.cu`` (where the host compiler inlines the drift)
under AddressSanitizer and UndefinedBehaviorSanitizer on the CPU.
"""
from __future__ import annotations

import argparse
import ctypes
import json
import shutil
import statistics
import subprocess
import sys
import time
from pathlib import Path

from .. import _build

ALL_SITES = (1 << 10) - 1
# name -> mask of the inlined call sites
MASKS = {
    "all": ALL_SITES, "rk_step": 0x1FF, "dopri5": 0x1F8, "bosh3": 0x007, "fsal": 0x200,
    **{f"dopri5_stage{r + 2}": 1 << (3 + r) for r in range(6)},
    **{f"bosh3_site{i}": 1 << i for i in range(3)},
}
# ptxas optimisation levels tried on the all-sites variant
PTXAS_LEVELS = ("-O0", "-O1", "-O2")
VARIANT_DIR = _build.BUILD_DIR / "inline_drift"
MODULE = "multitreegp_tpu_torch.tools.inline_drift"  # run as a child process by this name
SANITIZE_S = 300  # the most one sanitizer run may take
SITES_HEADER = "adaptive_step_sites.cuh"  # adaptive_step.cuh with numbered call sites

_SITE_CALLS = (("f(xs, k2);", "f(xs, k2, 0);"), ("f(xs, k3);", "f(xs, k3, 1);"),
               ("f(x_hi, k_last);", "f(x_hi, k_last, 2);"),
               ("f(xs, ks[r + 1]);", "f(xs, ks[r + 1], 3 + r);"))
_DRIFT_OLD = """  MTGP_HD void operator()(const float (&x)[Env::kLatent + SS],
                          float (&k)[Env::kLatent + SS]) const {
    pol.drift_call(x, p, k);
  }"""
_DRIFT_NEW = """  MTGP_HD void operator()(const float (&x)[Env::kLatent + SS],
                          float (&k)[Env::kLatent + SS], int site = 9) const {
    if ((INLINE_MASK >> site) & 1)
      pol.drift(x, p, nullptr, k);
    else
      pol.drift_call(x, p, k);
  }"""


def _replace(text: str, old: str, new: str) -> str:
    if text.count(old) != 1:
        raise RuntimeError(f"expected one {old!r} in the source")
    return text.replace(old, new)


def write_sources(out: Path, mask: int) -> Path:
    """``csrc`` copied into ``out`` with ``rk_step``'s call sites numbered, the
    drift of #7 inlined at the sites of ``mask``, and only the Acrobot
    instances at ``N <= 32`` kept; returns the variant's ``policy.cu``."""
    if out.exists():
        shutil.rmtree(out)
    shutil.copytree(_build.CSRC_DIR, out)
    step = (out / "adaptive_step.cuh").read_text()
    for old, new in _SITE_CALLS:
        step = _replace(step, old, new)
    (out / SITES_HEADER).write_text(step)  # the other kernels keep adaptive_step.cuh
    src = _replace((out / "policy.cu").read_text(), _DRIFT_OLD, _DRIFT_NEW)
    src = _replace(src, '#include "adaptive_step.cuh"', f'#include "{SITES_HEADER}"')
    src = f"#define INLINE_MASK {mask}\n" + src
    switch = src[src.index("#define MTGP_ENV_SWITCH"):src.index('extern "C"')]
    small = ("#define MTGP_ENV_SWITCH                 \\\n"
             "  switch (a->env) {                       \\\n"
             "    case kAcrobot: MTGP_ENV(AcrobotEnv<false>); \\\n"
             "    default: return kInvalid;             \\\n"
             "  }\n\n")
    src = src.replace(switch, small)
    src = _replace(src, "(a->n <= 32 ? MTGP_LAUNCH(ENV, SS, 32) : MTGP_LAUNCH(ENV, SS, kMaxNodes))",
                   "(a->n <= 32 ? MTGP_LAUNCH(ENV, SS, 32) : kInvalid)")
    (out / "policy.cu").write_text(src)
    return out / "policy.cu"


def build_variants(variants) -> dict:
    """``{name: (library path, nvcc seconds, ptxas report)}`` of ``variants``
    (``[(name, mask, extra nvcc flags)]``), one ``nvcc`` each, in parallel."""
    from ..kernel_ab import ptxas_report

    nvcc, jobs, t0 = _build.find_nvcc(), [], time.perf_counter()
    for name, mask, extra in variants:
        src = write_sources(VARIANT_DIR / name, mask)
        lib = VARIANT_DIR / name / "policy.so"
        cmd = [nvcc, *_build.NVCC_FLAGS, *extra, "-o", str(lib), str(src)]
        jobs.append((name, lib, cmd, subprocess.Popen(cmd, stdout=subprocess.PIPE,
                                                      stderr=subprocess.STDOUT, text=True)))
    out = {}
    for name, lib, cmd, proc in jobs:
        log, _ = proc.communicate()
        if proc.returncode != 0:  # a flag set this nvcc refuses: reported, not run
            print(f"inline_drift nvcc failed for {name}: {' '.join(cmd)}\n{log[-2000:]}", flush=True)
            continue
        report = [r for r in ptxas_report(log) if r[0].startswith("policy_adaptive_kernel")]
        out[name] = (lib, time.perf_counter() - t0, report)
    return out


def load_library(path) -> ctypes.CDLL:
    lib = ctypes.CDLL(str(path))
    lib.mtgp_error_string.argtypes = [ctypes.c_int]
    lib.mtgp_error_string.restype = ctypes.c_char_p
    return lib


def setup(device, candidates: int, t_steps: int):
    """The control path's adaptive lanes: Acrobot, 16 trajectories on
    ``arange(0, 50, 0.2)[:t_steps]``, ``candidates`` policies of one tree
    (static) and of 2 + 1 trees (dynamic, ``state_size=2``)."""
    import torch

    from ..core.registry import build_function_set
    from ..models.environments import Acrobot
    from ..models.evaluators import generate_control_data
    from ..ops.initialization import make_population_sampler

    operators = [("+", 2, 0.5), ("-", 2, 0.1), ("*", 2, 0.5), ("sin", 1, 0.1), ("cos", 1, 0.1)]
    env = Acrobot(0.0, 0.0)
    ys = [f"y{i}" for i in range(env.n_obs)]
    fsets = dict(static=build_function_set(operators, [ys], [env.n_control]),
                 dynamic=build_function_set(operators, [ys + ["a0", "a1", "u0"], ["a0", "a1"]],
                                            [2, env.n_control]))
    g = torch.Generator(device=device).manual_seed(10)
    ts = torch.arange(0.0, 50.0, 0.2, device=device)
    x0, ts, tgt, _, _, par = generate_control_data(env, g, ts, batch_size=16)
    trees = {k: make_population_sampler(f, 4, 30)(g, candidates)[0] for k, f in fsets.items()}
    ts = ts[:t_steps]
    par = tuple(p[:, :t_steps] if p.dim() == 2 else p for p in par)
    return dict(env=env, fsets=fsets, trees=trees, x0=x0, ts=ts, tgt=tgt, par=par,
                state_size=dict(static=0, dynamic=2))


def run_kernel(lib, case: dict, kind: str, method: str = "dopri5"):
    """#7 of ``lib`` on the case's ``kind`` (static / dynamic) lanes."""
    from ..core import cuda_policy as cp

    _build._loaded["policy"] = lib
    return cp.policy_rollout_adaptive_cuda(
        case["trees"][kind], case["x0"], case["ts"], case["tgt"], case["par"], case["env"],
        case["fsets"][kind], 1e-4, 1e-4, 8, method, 0.9, case["state_size"][kind])


def differing_lanes(got, ref):
    """``(lanes, differing lanes, first differing lane or None)``: states,
    controls, alive counts and attempted steps, NaN equal to NaN."""
    lane = _same_lanes(got, ref)
    bad = (~lane).flatten().nonzero()
    return lane.numel(), int(bad.numel()), (int(bad[0]) if bad.numel() else None)


def _same_lanes(got, ref):
    import torch

    same = lambda a, b: ((a == b) | (torch.isnan(a) & torch.isnan(b))).all(-1).all(0)
    lane = same(got[0], ref[0]) & same(got[1], ref[1]) & (got[2].sum(0) == ref[2].sum(0))
    if len(got) > 3 and len(ref) > 3:
        lane &= got[3] == ref[3]
    return lane


def difference_detail(got, ref) -> dict:
    """Where the differing lanes part: the earliest save row at which a
    state differs, the attempted steps and alive counts that differ, and the
    ulp gap of the states at each lane's first differing row (median and
    largest over the lanes; finite states only)."""
    import torch

    lane = _same_lanes(got, ref)
    if bool(lane.all()):
        return {}
    xs, rs = got[0], ref[0]  # (T, P, B, d)
    row_diff = ~(((xs == rs) | (torch.isnan(xs) & torch.isnan(rs))).all(-1))  # (T, P, B)
    bad = ~lane
    first_row = torch.where(row_diff.any(0), row_diff.float().argmax(0), torch.full_like(lane, -1,
                                                                                        dtype=torch.long))
    rows = first_row[bad]
    gaps = []
    for t, (p, b) in zip(rows.tolist(), bad.nonzero().tolist()):
        if t < 0:
            continue
        a, r = xs[t, p, b], rs[t, p, b]
        fin = torch.isfinite(a) & torch.isfinite(r)
        if bool(fin.any()):
            ia = a[fin].view(torch.int32).long()
            ir = r[fin].view(torch.int32).long()
            gaps.append(int((ia - ir).abs().max()))
    out = dict(first_row_min=int(rows[rows >= 0].min()) if bool((rows >= 0).any()) else None,
               steps_differ=int((got[3] != ref[3])[bad].sum()) if len(got) > 3 else None,
               alive_differ=int((got[2].sum(0) != ref[2].sum(0))[bad].sum()))
    if gaps:
        out.update(ulp_median=float(statistics.median(gaps)), ulp_max=max(gaps),
                   ulp_le_4=sum(g <= 4 for g in gaps), lanes_with_gap=len(gaps))
    return out


def _jobs(variants) -> list:
    """``(variant, kind, method)`` to compare: Dormand-Prince on every variant
    but the Bogacki-Shampine single sites, Bogacki-Shampine on those, the
    all-sites ones, the shipped copy and the FSAL site."""
    jobs = []
    for method in ("dopri5", "bosh3"):
        for name in variants:
            bosh = name.startswith("bosh3")
            if (method == "bosh3") == bosh or name.startswith(("all", "shipped", "fsal", "dopri5_stage7_G")):
                jobs += [(name, kind, method) for kind in ("static", "dynamic")]
    return jobs


def bisect_child(paths: dict, shipped_path, job: int, candidates: int) -> None:
    """Runs one job in a fresh process (job -1: the shipped kernel against
    the plain version) and prints its ``RESULT`` line: the variant's lanes
    against the shipped kernel's, and whether the variant's launch left the
    process's other memory as it was (the shipped kernel's inputs, rerun
    after it, give the same lanes; a canary tensor holds its pattern). A
    launch that faults ends the process."""
    import torch

    from ..core import cuda_policy as cp

    device = torch.device("cuda")
    case = setup(device, candidates, 11)
    shipped = load_library(shipped_path)
    if job < 0:
        for kind in ("static", "dynamic"):
            ref = run_kernel(shipped, case, kind)
            plain = cp.policy_rollout_adaptive_plain(
                case["trees"][kind], case["x0"], case["ts"], case["tgt"], case["par"], case["env"],
                case["fsets"][kind], 1e-4, 1e-4, 8, "dopri5", 0.9, case["state_size"][kind])
            lanes, bad, first = differing_lanes(ref, plain)
            print("RESULT " + json.dumps(dict(job=-1, name="shipped_vs_plain", kind=kind,
                                              method="dopri5", lanes=lanes, differing=bad,
                                              first=first)), flush=True)
        return
    name, kind, method = _jobs(paths)[job]
    ref = [t.cpu() for t in run_kernel(shipped, case, kind, method)]
    canary = torch.full((1 << 24,), 1.5, device=device)
    got = run_kernel(load_library(paths[name]), case, kind, method)
    torch.cuda.synchronize()
    got = [t.cpu() for t in got]
    again = [t.cpu() for t in run_kernel(shipped, case, kind, method)]
    lanes, bad, first = differing_lanes(got, ref)
    print("RESULT " + json.dumps(dict(
        job=job, name=name, kind=kind, method=method, lanes=lanes, differing=bad, first=first,
        detail=difference_detail(got, ref), shipped_rerun_differing=differing_lanes(again, ref)[1],
        canary_intact=bool((canary == 1.5).all()))), flush=True)


def _child(args, timeout: float):
    """``(exit code, output)`` of this module run with ``args``."""
    cmd = [sys.executable, "-m", MODULE, *args]
    try:
        proc = subprocess.run(cmd, capture_output=True, text=True, timeout=timeout)
        return proc.returncode, proc.stdout + proc.stderr
    except subprocess.TimeoutExpired as e:
        text = "".join(x.decode() if isinstance(x, bytes) else (x or "") for x in (e.stdout, e.stderr))
        return "timeout", text


def bisect(variants: dict, shipped_path, candidates: int = 8 * 512) -> list:
    """Every job of :func:`_jobs` in a process of its own (a variant that
    writes where it should not cannot touch another job's lanes); one record
    per job, ``fault`` holding the error of a job whose launch faulted."""
    paths = {name: str(v[0]) for name, v in variants.items()}
    spec = VARIANT_DIR / "variants.json"
    spec.write_text(json.dumps(paths))
    records = []
    for job, (name, kind, method) in [(-1, ("shipped_vs_plain", "both", "dopri5"))] + list(
            enumerate(_jobs(paths))):
        rc, text = _child(["--bisect-child", str(spec), "--shipped", str(shipped_path),
                           "--start", str(job), "--candidates", str(candidates)], 600)
        done = [json.loads(ln[7:]) for ln in text.splitlines() if ln.startswith("RESULT ")]
        for r in done:
            records.append(r)
            extra = ""
            if r["first"] is not None:
                extra = f", first lane {r['first']}; {r['detail']}"
            if "canary_intact" in r:
                extra += (f"; the shipped kernel rerun after it: {r['shipped_rerun_differing']} lanes "
                          f"differ, canary intact {r['canary_intact']}")
            print(f"inline_drift {r['name']} {r['kind']} {r['method']}: {r['differing']} of "
                  f"{r['lanes']} lanes differ{extra}", flush=True)
        if rc != 0:
            err = [ln for ln in text.splitlines() if "Error" in ln or "error" in ln][-1:]
            records.append(dict(job=job, name=name, kind=kind, method=method, fault=" ".join(err),
                                rc=rc))
            print(f"inline_drift {name} {kind} {method}: the launch faulted (exit {rc}): "
                  f"{' '.join(err)}", flush=True)
    return records


def sanitize(runs) -> dict:
    """``runs`` (``[(label, library path, method)]``) on 512 static and
    dynamic policies under ``compute-sanitizer``'s memcheck and initcheck:
    each tool's exit code and its first reports (with ``-lineinfo``, the
    source line of a faulting access)."""
    tool = Path(_build.find_nvcc()).parent / "compute-sanitizer"
    if not tool.exists():
        print(f"inline_drift sanitize: {tool} not found", flush=True)
        return dict(error=f"{tool} not found")
    out = {}
    for name, path, method in runs:
        for check in ("memcheck", "initcheck"):
            cmd = [str(tool), "--tool", check, "--error-exitcode", "9", "--print-limit", "8",
                   sys.executable, "-m", MODULE, "--one", str(path), "--method", method]
            t0 = time.perf_counter()
            try:
                proc = subprocess.run(cmd, capture_output=True, text=True, timeout=SANITIZE_S)
                rc, text = proc.returncode, proc.stdout + proc.stderr
            except subprocess.TimeoutExpired as e:
                rc = "timeout"
                text = "".join(x.decode() if isinstance(x, bytes) else (x or "")
                               for x in (e.stdout, e.stderr))
            lines = [ln for ln in text.splitlines() if ln.strip()]
            reports = [ln for ln in lines if ln.startswith("=========")][:40]
            out[f"{name}_{check}"] = dict(rc=rc, seconds=time.perf_counter() - t0, reports=reports,
                                          tail=lines[-4:])
            print(f"inline_drift sanitize {name} {check} ({method}): exit {rc} in "
                  f"{time.perf_counter() - t0:.1f} s", flush=True)
            for ln in reports or lines[-4:]:
                print(f"inline_drift sanitize {name} {check}: {ln}", flush=True)
    return out


def run_one(path, method: str) -> None:
    """512 policies, T = 11, static and dynamic, through the library at
    ``path`` (what the sanitizer runs)."""
    import torch

    device = torch.device("cuda")
    case = setup(device, 512, 11)
    lib = load_library(path)
    for kind in ("static", "dynamic"):
        got = run_kernel(lib, case, kind, method)
        torch.cuda.synchronize()
        print(f"inline_drift one {kind}: alive {float(got[2][-1].float().mean()):.4f}, "
              f"steps {int(got[3].sum())}", flush=True)


def time_child(shipped_path, variant_path, runs: int = 10) -> None:
    """#7 at T = 250 on the 8 x 512 x 16 lanes: device ms per launch by
    torch.profiler, shipped, variant, variant, shipped; one ``TIME`` line
    each."""
    import torch
    from torch.profiler import ProfilerActivity, profile

    device = torch.device("cuda")
    case = setup(device, 8 * 512, 250)
    shipped, variant = load_library(shipped_path), load_library(variant_path)
    for kind in ("static", "dynamic"):
        for label, lib in (("shipped", shipped), ("inlined", variant), ("inlined", variant),
                           ("shipped", shipped)):
            run_kernel(lib, case, kind)
            torch.cuda.synchronize()
            with profile(activities=[ProfilerActivity.CUDA]) as prof:
                for _ in range(runs):
                    run_kernel(lib, case, kind)
                torch.cuda.synchronize()
            ms = [e.time_range.elapsed_us() / 1e3 for e in prof.events()
                  if e.device_type == torch.autograd.DeviceType.CUDA
                  and "policy_adaptive_kernel" in e.name]
            print("TIME " + json.dumps(dict(label=label, kind=kind, launches=len(ms),
                                            ms=statistics.mean(ms) if ms else None)), flush=True)


def host_sanitized(out_dir: Path, candidates: int = 256) -> None:
    """The host build of ``policy.cu`` (its per-lane code, the drift inlined
    at every call site as the host compiler chooses) under AddressSanitizer
    and UndefinedBehaviorSanitizer, on the adaptive Acrobot lanes (static
    and dynamic, both methods, T = 11) on the CPU; run in a child process
    that preloads the sanitizer runtime. Any report aborts it."""
    import os

    cxx = shutil.which("g++")
    out_dir.mkdir(parents=True, exist_ok=True)
    lib = out_dir / "policy_host_sanitized.so"
    cmd = [cxx, "-x", "c++", "-std=c++17", "-O1", "-g", "-ffp-contract=off", "-shared", "-fPIC",
           "-fsanitize=address,undefined", "-fno-sanitize-recover=undefined", "-fno-omit-frame-pointer",
           "-o", str(lib), str(_build.CSRC_DIR / "policy.cu")]
    subprocess.run(cmd, check=True, capture_output=True, text=True)
    runtime = subprocess.run([cxx, "-print-file-name=libasan.so"], capture_output=True,
                             text=True).stdout.strip()
    env = dict(os.environ, LD_PRELOAD=runtime, ASAN_OPTIONS="detect_leaks=0:abort_on_error=1",
               UBSAN_OPTIONS="print_stacktrace=1:halt_on_error=1")
    proc = subprocess.run([sys.executable, "-m", MODULE, "--host-child", str(lib), "--candidates",
                           str(candidates)], env=env, capture_output=True, text=True)
    reports = [ln for ln in (proc.stdout + proc.stderr).splitlines()
               if "Sanitizer" in ln or "runtime error" in ln or ln.startswith("inline_drift")]
    print(f"inline_drift host sanitizers: exit {proc.returncode}", flush=True)
    for ln in reports[:20]:
        print(ln, flush=True)


def host_child(lib_path, candidates: int) -> None:
    import torch

    from ..core import cuda_policy as cp

    lib = ctypes.CDLL(lib_path)
    lib.policy_host.argtypes = [ctypes.c_int, ctypes.c_void_p]
    lib.policy_host.restype = ctypes.c_int
    case = setup(torch.device("cpu"), candidates, 11)
    for kind in ("static", "dynamic"):
        for method in ("dopri5", "bosh3"):
            status, xs, us, count, steps = cp.run_policy(
                lambda a: lib.policy_host(cp.ADAPTIVE, a), cp.ADAPTIVE, case["trees"][kind],
                case["x0"], case["ts"], case["tgt"], case["par"], case["env"], case["fsets"][kind],
                case["state_size"][kind], method, max_steps=8, rtol=1e-4, atol=1e-4, safety=0.9)
            print(f"inline_drift host {kind} {method}: status {status}, {xs.shape[1] * xs.shape[2]} "
                  f"lanes, attempted steps {int(steps.sum())}", flush=True)


def main(argv=None) -> int:
    parser = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    parser.add_argument("--sanitize", action="store_true")
    parser.add_argument("--time", action="store_true")
    parser.add_argument("--out", help="write the results as JSON here")
    parser.add_argument("--one", help=argparse.SUPPRESS)
    parser.add_argument("--method", default="dopri5", help=argparse.SUPPRESS)
    parser.add_argument("--bisect-child", help=argparse.SUPPRESS)
    parser.add_argument("--shipped", help=argparse.SUPPRESS)
    parser.add_argument("--start", type=int, default=0, help=argparse.SUPPRESS)
    parser.add_argument("--candidates", type=int, default=8 * 512, help=argparse.SUPPRESS)
    parser.add_argument("--time-child", help=argparse.SUPPRESS)
    parser.add_argument("--host-sanitize", action="store_true",
                        help="run the host build under ASan/UBSan on the CPU and stop")
    parser.add_argument("--host-child", help=argparse.SUPPRESS)
    opts = parser.parse_args(argv)
    if opts.host_sanitize:
        host_sanitized(VARIANT_DIR / "host", opts.candidates if opts.candidates != 8 * 512 else 256)
        return 0
    if opts.host_child:
        host_child(opts.host_child, opts.candidates)
        return 0
    if opts.one:
        run_one(opts.one, opts.method)
        return 0
    if opts.bisect_child:
        bisect_child(json.loads(Path(opts.bisect_child).read_text()), opts.shipped, opts.start,
                     opts.candidates)
        return 0
    if opts.time_child:
        time_child(opts.shipped, opts.time_child)
        return 0
    import torch

    if not torch.cuda.is_available():
        print("inline_drift: no CUDA device", file=sys.stderr)
        return 1
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                         capture_output=True, text=True, check=True).stdout.strip()
    nvcc_version = subprocess.run([_build.find_nvcc(), "--version"], capture_output=True,
                                  text=True).stdout.strip().splitlines()[-1]
    print(f"inline_drift device: {smi}; {nvcc_version}; flags {' '.join(_build.NVCC_FLAGS)}", flush=True)
    result = dict(device=smi, nvcc=nvcc_version, flags=list(_build.NVCC_FLAGS))
    if opts.time:  # the shipped source against the all-sites variant, at ptxas -O0 and -O3
        built = build_variants([("shipped_copy", 0, ()), ("all_ptxas-O0", ALL_SITES, ("-Xptxas", "-O0")),
                                ("all", ALL_SITES, ())])
        result["times"] = {}
        for name in ("all_ptxas-O0", "all"):
            rc, text = _child(["--time-child", str(built[name][0]), "--shipped",
                               str(built["shipped_copy"][0])], 600)
            rows = [json.loads(ln[5:]) for ln in text.splitlines() if ln.startswith("TIME ")]
            result["times"][name] = dict(rc=rc, rows=rows)
            for r in rows:
                print(f"inline_drift time {name}: {r['label']} {r['kind']} "
                      + (f"{r['ms']:.4f} ms device a launch ({r['launches']} launches)"
                         if r["ms"] is not None else "no launch traced"), flush=True)
            if rc != 0:
                print(f"inline_drift time {name}: exit {rc}", flush=True)
    else:
        variants = [("shipped_copy", 0, ())] + [(name, mask, ()) for name, mask in MASKS.items()]
        variants += [(f"all_ptxas{lvl}", ALL_SITES, ("-Xptxas", lvl)) for lvl in PTXAS_LEVELS]
        # no device optimisation at all (-G), and the front end's optimiser off
        variants += [("shipped_G", 0, ("-G",)), ("all_G", ALL_SITES, ("-G",)),
                     ("dopri5_stage7_G", 1 << 8, ("-G",)),
                     ("all_cicc-O0", ALL_SITES, ("-Xcicc", "-O0", "-Xptxas", "-O0"))]
        t0 = time.perf_counter()
        shipped_path = _build.build("policy")[0]
        built = build_variants(variants)
        print(f"inline_drift built {len(built)} variants and the shipped library in "
              f"{time.perf_counter() - t0:.1f} s", flush=True)
        for name, (_, secs, report) in built.items():
            print(f"inline_drift ptxas {name}: nvcc {secs:.1f} s; " + "; ".join(
                f"{k} {r} registers {st} B stack {sp} B spilled" for k, r, st, sp in report), flush=True)
        result["ptxas"] = {k: v[2] for k, v in built.items()}
        result["lanes"] = records = bisect(built, shipped_path)
        if opts.sanitize:
            wrong = [r for r in records if (r.get("fault") or r.get("differing"))
                     and bin(MASKS.get(r["name"], 0)).count("1") == 1]
            runs = [("shipped", shipped_path, "dopri5"), ("all", built["all"][0], "dopri5")]
            if wrong:
                runs.append((wrong[0]["name"], built[wrong[0]["name"]][0], wrong[0]["method"]))
            result["sanitize"] = sanitize(runs)
    if opts.out:
        Path(opts.out).write_text(json.dumps(result, indent=1, default=str))
    return 0


if __name__ == "__main__":
    sys.exit(main())
