"""Fused reproduction: every child of a generation, kernel and plain version.

Counterpart of ``multitreegp_tpu/core/pallas_reproduction.py``. Lanes are
flattened ``(pairs x trees)``; each lane makes two children from its two
parents and its actions (crossover flag; otherwise copy / mutate / fresh per
child), as ``tile_surgery.reproduce_tiles`` defines.

Randomness is a uniform buffer ``u (R, L)`` that :func:`reproduce_pairs`
draws from a ``torch.Generator``; ``R`` is the number of ``urand`` rows one
lane of ``reproduce_tiles`` consumes (:func:`tile_surgery.rows_per_lane`).
It is drawn as ``(R, L)`` and stored lane-major, ``(L, R)``, whose ``(R,
L)`` view is handed on (one transposing copy per generation); the ``(N,
L)`` tiles are views of the lane-major population.

* CUDA tensors launch the hand-written kernel ``csrc/reproduce.cu``, which
  reads and writes lane-major ``(L, N)`` / ``(L, R)`` memory: a tile that is
  the transposed view of such memory is passed as it is, any other is copied
  into that layout; the children come back as ``(N, L)`` views of
  lane-major tensors.
* CPU tensors run :func:`reproduce_lanes_plain`, i.e. ``reproduce_tiles``
  reading the same buffer row by row.
"""
from __future__ import annotations

import ctypes
from functools import lru_cache
from typing import Tuple

import numpy as np
import torch

from .. import _build
from . import tile_surgery as ts
from .registry import FunctionSet, device_table
from .trees import TreeTensors, rebuild_pointers

MAX_NODES = 256  # csrc/reproduce.cu kMaxNodes

Tiles = Tuple[torch.Tensor, torch.Tensor, torch.Tensor, torch.Tensor]


@lru_cache(maxsize=16)
def rows_per_lane(cfg: ts.SurgeryConfig) -> int:
    """Uniform rows per lane for this configuration (counted once)."""
    return ts.rows_per_lane(cfg)


def decay_table(cfg: ts.SurgeryConfig, device=None) -> torch.Tensor:
    """float32 ``0.7 ** depth`` per node depth, rounded as the plain version
    rounds it; cached per device."""
    depths = max(cfg.max_init_depth, 2)
    return device_table(tuple(float(np.float32(0.7**d)) for d in range(depths)), torch.float32,
                        torch.device(device or "cpu"))


def reproduce_lanes_plain(p1_ops, p1_const, p2_ops, p2_const, cxflag, act1, act2, vmask, u,
                          cfg: ts.SurgeryConfig) -> Tiles:
    """Plain version: ``reproduce_tiles`` on ``(N, L)`` tiles reading ``u``."""
    return ts.reproduce_tiles(
        p1_ops, p1_const, p2_ops, p2_const, cxflag[None, :], act1[None, :], act2[None, :],
        vmask, ts.BufferRand(u), cfg,
    )


def _check_inputs(p1_ops, p1_const, p2_ops, p2_const, cxflag, act1, act2, vmask, u, cfg):
    n, lanes = p1_ops.shape
    dev = p1_ops.device
    expected = (
        ("p1_ops", p1_ops, torch.int32, (n, lanes)), ("p1_const", p1_const, torch.float32, (n, lanes)),
        ("p2_ops", p2_ops, torch.int32, (n, lanes)), ("p2_const", p2_const, torch.float32, (n, lanes)),
        ("cxflag", cxflag, torch.bool, (lanes,)), ("act1", act1, torch.int32, (lanes,)),
        ("act2", act2, torch.int32, (lanes,)), ("vmask", vmask, torch.float32, (cfg.num_vars, lanes)),
        ("u", u, torch.float32, (rows_per_lane(cfg), lanes)),
    )
    for name, t, dtype, shape in expected:
        if t.device != dev or t.dtype != dtype or tuple(t.shape) != shape:
            raise ValueError(
                f"{name}: expected {dtype} {shape} on {dev}, got {t.dtype} {tuple(t.shape)} on {t.device}"
            )
    if n != cfg.n or n > MAX_NODES:
        raise NotImplementedError(f"max_nodes {n}: the configuration has {cfg.n}, the kernel's limit is {MAX_NODES}")


def reproduce_lanes_cuda(p1_ops, p1_const, p2_ops, p2_const, cxflag, act1, act2, vmask, u,
                         cfg: ts.SurgeryConfig) -> Tiles:
    """Launch ``csrc/reproduce.cu`` on ``(N, L)`` tiles; the children are
    ``(N, L)`` views of lane-major tensors."""
    _check_inputs(p1_ops, p1_const, p2_ops, p2_const, cxflag, act1, act2, vmask, u, cfg)
    dev = p1_ops.device
    n, lanes = p1_ops.shape
    lane_major = [t.T.contiguous() for t in (p1_ops, p1_const, p2_ops, p2_const)]
    ins = lane_major + [t.contiguous() for t in (cxflag, act1, act2, vmask)] + [u.T.contiguous()]
    outs = [torch.empty((lanes, n), dtype=dt, device=dev)
            for dt in (torch.int32, torch.float32, torch.int32, torch.float32)]
    tables = (device_table(cfg.slots, torch.int32, dev),
              device_table(cfg.operator_probs, torch.float32, dev), decay_table(cfg, dev))

    lib = _build.load("reproduce")
    fn = lib.reproduce_launch
    fn.argtypes = ([ctypes.c_void_p] * 16 + [ctypes.c_int] * 8 + [ctypes.c_float, ctypes.c_int]
                   + [ctypes.c_void_p])
    fn.restype = ctypes.c_int
    stream = torch.cuda.current_stream(dev).cuda_stream
    status = fn(
        *(t.data_ptr() for t in ins), *(t.data_ptr() for t in outs),
        *(t.data_ptr() for t in tables),
        lanes, n, cfg.num_vars, cfg.num_operators, cfg.var_start, cfg.max_init_depth,
        cfg.cx_retries, cfg.mut_retries, cfg.coefficient_sd, u.shape[0], stream,
    )
    _build.check(lib, status, "reproduce kernel launch")
    reproduce_lanes_cuda.launches += 1
    return tuple(t.T for t in outs)


reproduce_lanes_cuda.launches = 0


def reproduce_lanes(p1_ops, p1_const, p2_ops, p2_const, cxflag, act1, act2, vmask, u,
                    cfg: ts.SurgeryConfig) -> Tiles:
    """Children ``(c1_ops, c1_const, c2_ops, c2_const)`` as ``(N, L)`` tiles:
    the kernel for CUDA tensors, the plain version for CPU tensors."""
    dev = p1_ops.device
    if dev.type == "cuda":
        return reproduce_lanes_cuda(p1_ops, p1_const, p2_ops, p2_const, cxflag, act1, act2, vmask, u, cfg)
    if dev.type == "cpu":
        _check_inputs(p1_ops, p1_const, p2_ops, p2_const, cxflag, act1, act2, vmask, u, cfg)
        return reproduce_lanes_plain(p1_ops, p1_const, p2_ops, p2_const, cxflag, act1, act2, vmask, u, cfg)
    raise NotImplementedError(f"no reproduction implementation for device {dev}")


def reproduce_pairs(
    left: TreeTensors, right: TreeTensors, cxflag: torch.Tensor, act1: torch.Tensor,
    act2: torch.Tensor, fset: FunctionSet, cfg: ts.SurgeryConfig, generator: torch.Generator,
) -> Tuple[TreeTensors, TreeTensors]:
    """Children ``(child1, child2)`` of every parent pair, batch ``(Q, T)``.

    ``cxflag``/``act1``/``act2`` are ``(Q, T)`` per tree slot. Uniforms come
    from ``generator``; child pointers are rebuilt from the opcodes.
    """
    q, t = left.batch_shape
    n = left.max_nodes
    lanes = q * t
    dev = left.device

    def to_tile(x):  # (N, L) view of the lane-major trees
        return x.reshape(lanes, n).T

    vmask = fset.variable_mask_on(dev).T[:, None, :].expand(fset.num_variables, q, t)
    # the (R, L) stream of uniforms, stored lane-major for the kernel
    u = torch.rand((rows_per_lane(cfg), lanes), generator=generator, device=dev).T.contiguous().T
    c1o, c1c, c2o, c2c = reproduce_lanes(
        to_tile(left.ops), to_tile(left.const), to_tile(right.ops), to_tile(right.const),
        cxflag.reshape(lanes).to(torch.bool), act1.reshape(lanes).to(torch.int32),
        act2.reshape(lanes).to(torch.int32), vmask.reshape(fset.num_variables, lanes).contiguous(),
        u, cfg,
    )
    slots = fset.slots(dev)

    def from_tile(ops_t, const_t):
        ops = ops_t.T.reshape(q, t, n)
        c1, c2 = rebuild_pointers(ops, slots)
        return TreeTensors(ops.contiguous(), c1, c2, const_t.T.reshape(q, t, n).contiguous())

    return from_tile(c1o, c1c), from_tile(c2o, c2c)
