"""Which data-dependent skips does the card honour, and what does one slow
lane cost its warp?

Port of ``tools/mosaic_branch_probe.py`` (TPU kernel #10) to the H100: the
hand-written kernel ``csrc/branch_probe.cu`` times one expensive body (64
dependent ``x * 1.001 + 0.001`` on an 8 x 128 float32 tile, one block per
tile) under each skip mechanism, with a flag that drops once the tile's sum
passes ``THRESH``, after ``FLIP`` of ``TOTAL`` iterations:

  always   no skip: the roofline of "executes everything"
  when     a block-uniform flag from the tile's sum, which every warp forms
           from the warps' partials after one barrier (the flag in a register)
  dynfori  chunks of CH, the inner trip count (CH or 0) read from that flag
  dynval   the same, the trip count straight from the reduction
           (``__syncthreads_or``)
  lane     each thread tests its own element; one in 32 (one per warp)
           never crosses within TOTAL iterations

If a block-uniform mechanism skips, its time is about 9/64 (``when``) or
12/64 (the chunked ones) of ``always``; ``lane`` shows whether one slow lane
holds its warp for the whole budget.

Usage (on the card): ``python -m multitreegp_tpu_torch.tools.branch_probe``.
"""
from __future__ import annotations

import ctypes
import json
import sys

import numpy as np
import torch

from .. import _build

TOTAL = 64  # iterations in the budget
FLIP = 8  # iterations after which the flag drops, from ones
CH = 4  # chunk of the chunked modes
REPS = 256  # tiles
BODY = 64  # dependent multiply-adds per iteration
TILE = (8, 128)
MODES = ("always", "when", "dynfori", "dynval", "lane")
SLOW_EVERY = 32  # the lane mode's input: one slow element per warp
SLOW_START = -0.99  # below the lane threshold for all TOTAL iterations
_MUL, _ADD = float(np.float32(1.001)), float(np.float32(0.001))


def _values_after(iterations: int) -> np.ndarray:
    """The float32 value of one element from 1.0 after each of the first
    ``iterations`` iterations of the body, exactly the device arithmetic."""
    x = np.float32(1.0)
    vals = [x]
    for _ in range(iterations):
        for _ in range(BODY):
            x = np.float32(x * np.float32(1.001) + np.float32(0.001))
        vals.append(x)
    return np.asarray(vals, np.float32)


def thresh_after(k: int) -> float:
    """The tile-sum threshold: the midpoint between the values after ``k``
    and ``k + 1`` iterations, times the tile's 1024 elements (the TPU
    probe's ``thresh_after``)."""
    vals = _values_after(k + 1)
    return 0.5 * (float(vals[k]) + float(vals[k + 1])) * TILE[0] * TILE[1]


THRESH = thresh_after(FLIP)
LANE_THRESH = THRESH / (TILE[0] * TILE[1])  # the same, per element


def probe_input(mode: str, reps: int = REPS, device=None) -> torch.Tensor:
    """``(reps, 8, 128)`` ones; the lane mode's has every 32nd element at
    ``SLOW_START``."""
    x = torch.ones((reps,) + TILE, dtype=torch.float32, device=device)
    if mode == "lane":
        x.view(-1)[::SLOW_EVERY] = SLOW_START
    return x


def early_input(reps: int = REPS, device=None) -> torch.Tensor:
    """``(reps, 8, 128)`` tiles already past the threshold, so every mode's
    flag drops after its first round (one iteration in ``when`` and
    ``lane``, one chunk of CH in the chunked modes): a launch on them times
    the probe's cost besides the iterations (the launch, the tile's load and
    store, the rounds' reductions and barriers) with one round's work."""
    return torch.full((reps,) + TILE, 3.0, dtype=torch.float32, device=device)


def _body(x: torch.Tensor) -> torch.Tensor:
    for _ in range(BODY):
        x = x * _MUL + _ADD
    return x


def probe_plain(x: torch.Tensor, mode: str) -> torch.Tensor:
    """Plain PyTorch version of the kernel: every tile after the iterations
    its mode runs (the flags from ``torch.sum`` of each tile)."""
    if mode not in MODES:
        raise ValueError(f"unknown probe mode {mode!r}: {MODES}")
    thresh = float(np.float32(THRESH))
    tile_go = lambda v: (v.sum(dim=(1, 2)) < thresh)[:, None, None]
    if mode == "always":
        for _ in range(TOTAL):
            x = _body(x)
    elif mode == "when":
        go = torch.ones_like(x[:, :1, :1], dtype=torch.bool)
        for _ in range(TOTAL):
            x = torch.where(go, _body(x), x)
            go = go & tile_go(x)
    elif mode in ("dynfori", "dynval"):
        go = torch.ones_like(x[:, :1, :1], dtype=torch.bool)
        for _ in range(TOTAL // CH):
            y = x
            for _ in range(CH):
                y = _body(y)
            x = torch.where(go, y, x)
            go = tile_go(x)
    else:
        lane = float(np.float32(LANE_THRESH))
        go = torch.ones_like(x, dtype=torch.bool)
        for _ in range(TOTAL):
            x = torch.where(go, _body(x), x)
            go = go & (x < lane)
    return x


def probe_cuda(x: torch.Tensor, mode: str) -> torch.Tensor:
    """Launch ``csrc/branch_probe.cu`` on ``x (tiles, 8, 128)``."""
    if mode not in MODES:
        raise ValueError(f"unknown probe mode {mode!r}: {MODES}")
    if x.dtype != torch.float32 or x.shape[1:] != TILE or x.device.type != "cuda":
        raise ValueError(f"x: expected float32 (tiles, 8, 128) on a CUDA device, got "
                         f"{x.dtype} {tuple(x.shape)} on {x.device}")
    x = x.contiguous()
    out = torch.empty_like(x)
    lib = _build.load("branch_probe")
    fn = lib.branch_probe_launch
    fn.argtypes = [ctypes.c_int, ctypes.c_void_p, ctypes.c_void_p, ctypes.c_int, ctypes.c_float,
                   ctypes.c_float, ctypes.c_void_p]
    fn.restype = ctypes.c_int
    status = fn(MODES.index(mode), x.data_ptr(), out.data_ptr(), x.shape[0], THRESH, LANE_THRESH,
                torch.cuda.current_stream(x.device).cuda_stream)
    _build.check(lib, status, "branch probe kernel launch")
    probe_cuda.launches += 1
    return out


probe_cuda.launches = 0


def probe(x: torch.Tensor, mode: str) -> torch.Tensor:
    """The probe's output: the kernel for CUDA tensors, the plain version for
    CPU tensors."""
    if x.device.type == "cuda":
        return probe_cuda(x, mode)
    if x.device.type == "cpu":
        return probe_plain(x, mode)
    raise NotImplementedError(f"no probe implementation for device {x.device}")


def element_iterations(x: torch.Tensor, mode: str) -> torch.Tensor:
    """The iterations each element runs in ``mode`` on the input ``x`` (on
    the CPU): the work the card must do, for the bound."""
    x = x.detach().cpu()
    ones = torch.ones_like(x, dtype=torch.int64)
    if mode == "always":
        return ones * TOTAL
    vals = torch.from_numpy(_values_after(TOTAL))
    if mode == "lane":
        # an element from 1.0 stops after the first iteration past the
        # threshold; a slow one never does
        first = int(np.argmax(vals.numpy() >= np.float32(LANE_THRESH)))
        return torch.where(x == 1.0, first, TOTAL) * ones
    first = int(np.argmax(vals.numpy() * np.float32(TILE[0] * TILE[1]) >= np.float32(THRESH)))
    if mode == "when":
        return ones * first
    return ones * min(TOTAL, -(-first // CH) * CH)


def operations(x: torch.Tensor, mode: str) -> int:
    """Float32 operations of ``mode`` on ``x``: a multiply and an add per
    body step (the block reductions not counted)."""
    return int(element_iterations(x, mode).sum()) * BODY * 2


def time_mode(mode: str, reps: int = REPS, runs: int = 30, device="cuda") -> float:
    """Median CUDA-event milliseconds of one launch of ``mode``."""
    x = probe_input(mode, reps, device)
    probe_cuda(x, mode)  # warm-up (and the build)
    start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
    times = []
    for _ in range(runs):
        start.record()
        probe_cuda(x, mode)
        end.record()
        end.synchronize()
        times.append(start.elapsed_time(end))
    return float(np.median(times))


def measure(runs: int = 30, device="cuda") -> dict:
    """Every mode's median time, its ratio to ``always`` and its ideal ratio
    (the iterations its elements must run over TOTAL)."""
    base, rows = None, {}
    for mode in MODES:
        t = time_mode(mode, runs=runs, device=device)
        base = t if base is None else base
        ideal = float(element_iterations(probe_input(mode, 1), mode).float().mean()) / TOTAL
        rows[mode] = {"ms": t, "ratio": t / base, "ideal_ratio": ideal}
    return rows


def main(argv=None) -> int:
    """Time every mode and print its ratio to ``always`` beside the ideal
    skip, as the TPU probe does; a JSON line of the times last."""
    if not torch.cuda.is_available():
        print("the branch probe needs a CUDA device", file=sys.stderr)
        return 1
    rows = measure()
    for mode, r in rows.items():
        print(f"{mode:8s} {r['ms']:8.4f} ms  ({r['ratio']:5.2f}x of always; ideal skip "
              f"~{r['ideal_ratio']:4.2f}x, FLIP/TOTAL {FLIP / TOTAL:4.2f})", flush=True)
    print(json.dumps({"branch_probe": rows}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
