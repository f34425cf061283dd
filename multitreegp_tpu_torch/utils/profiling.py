"""Tracing and per-phase timing (port of ``multitreegp_tpu/utils/profiling.py``).

* :class:`PhaseTimer` — wall-clock seconds per named phase, with device
  synchronisation: a phase given the tensors it produces (``sync=``) waits
  for their CUDA devices on exit, so the numbers measure device work, not
  the enqueue.
* :func:`trace` — a ``torch.profiler`` trace of a block, written for
  TensorBoard (``tensorboard_trace_handler``).
* :func:`annotate` — a named region (``record_function``) that shows inside
  such a trace.
"""
from __future__ import annotations

import contextlib
import time
from collections import defaultdict
from typing import Any, Dict, Iterator, Set

import torch


def _cuda_devices(tree: Any, found: Set[torch.device]) -> Set[torch.device]:
    """The CUDA devices of every tensor in a nesting of tensors, tuples,
    lists and dicts."""
    if isinstance(tree, torch.Tensor):
        if tree.is_cuda:
            found.add(tree.device)
    elif isinstance(tree, dict):
        for v in tree.values():
            _cuda_devices(v, found)
    elif isinstance(tree, (tuple, list)):
        for v in tree:
            _cuda_devices(v, found)
    return found


class PhaseTimer:
    """Accumulates wall-clock seconds per named phase.

    Usage::

        timer = PhaseTimer()
        out = []
        with timer.phase("evaluate", sync=out):
            out.append(evaluate(pop))   # the device is waited for on exit
        print(timer)
    """

    def __init__(self) -> None:
        self.totals: Dict[str, float] = defaultdict(float)
        self.counts: Dict[str, int] = defaultdict(int)

    @contextlib.contextmanager
    def phase(self, name: str, sync: Any = None) -> Iterator[None]:
        """Time a block. ``sync`` (optional): tensors, or a nesting of them
        (a list the block fills works); on exit ``torch.cuda.synchronize``
        runs on each CUDA device found there, and nothing for CPU tensors."""
        t0 = time.perf_counter()
        try:
            yield
        finally:
            for device in _cuda_devices(sync, set()):
                torch.cuda.synchronize(device)
            self.totals[name] += time.perf_counter() - t0
            self.counts[name] += 1

    def record(self, name: str, seconds: float) -> None:
        self.totals[name] += seconds
        self.counts[name] += 1

    def summary(self) -> Dict[str, Dict[str, float]]:
        return {
            name: {
                "total_s": self.totals[name],
                "count": self.counts[name],
                "mean_s": self.totals[name] / max(self.counts[name], 1),
            }
            for name in self.totals
        }

    def __str__(self) -> str:
        lines = ["phase                       total      n      mean"]
        for name, s in sorted(self.summary().items(), key=lambda kv: -kv[1]["total_s"]):
            lines.append(
                f"{name:<24} {s['total_s']:>9.3f}s {s['count']:>6d} {s['mean_s']:>9.4f}s"
            )
        return "\n".join(lines)


@contextlib.contextmanager
def trace(log_dir: str) -> Iterator[torch.profiler.profile]:
    """Profile the block with ``torch.profiler``: CPU activity always, CUDA
    activity when a GPU is present; the trace is written under ``log_dir``
    for TensorBoard (``tensorboard_trace_handler``)."""
    activities = [torch.profiler.ProfilerActivity.CPU]
    if torch.cuda.is_available():
        activities.append(torch.profiler.ProfilerActivity.CUDA)
    with torch.profiler.profile(
        activities=activities,
        on_trace_ready=torch.profiler.tensorboard_trace_handler(log_dir),
    ) as prof:
        yield prof


def annotate(name: str) -> torch.profiler.record_function:
    """A named region visible inside a :func:`trace`."""
    return torch.profiler.record_function(name)
