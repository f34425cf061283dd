"""Does the generated code of each user operator compute what PyTorch's CUDA
kernels compute, bit for bit?

Each operator of a function set runs as a one-operator tree through the
interpreter kernels' user build (#8 the forward, #9 the VJP;
``interpreter_u<hash12>``) on float32 bit patterns, and the same callable
runs through PyTorch's own CUDA ops on the same tensor (autograd for the
VJP):

* a unary operator's forward on every ``stride``-th of the 2^32 bit
  patterns (``stride=1``: all of them), in chunks of at most 2^28 lanes;
  equal bits required, NaN lanes agreeing as NaN (any payload);
* its VJP on every 256th pattern, with the cotangent 1 and with a seeded
  normal one: equal values (the kernel's data cotangent is a sum that
  starts at 0, so a -0 of autograd's reads +0: such lanes are counted
  apart), NaN agreeing as NaN;
* a binary operator on a grid of ``side`` x ``side`` bit patterns stratified
  by exponent (every exponent, both signs, random mantissas) plus the edge
  values (+-0, +-inf, NaN, subnormals, ties, the largest and smallest
  normals), the diagonal giving ``x == y``: forward and VJP as above.

The Hurwitz zeta series of ``polygamma(n >= 2, x)`` runs one step per unit
from a negative non-integer ``x`` up to 9 (in PyTorch's kernel as in the
generated code), so its sweeps leave out the negative non-integers below
:data:`ZETA_FLOOR` (:func:`sweep_domain`; each result says how many) and
take every :data:`OUTSIDE_STRIDE`-th of them apart, forward and VJP
(``outside``: up to ~8.4M ``powf`` steps in one lane, near -2^23).

Usage (on the card): ``python -m multitreegp_tpu_torch.tools.op_sweep
[--stride S] [--side N] [--only NAME ...]``: the vocabulary sets of
``registry.vocabulary_operators`` and ``registry.special_operators``, one
JSON object per operator, then a summary line.
"""
from __future__ import annotations

import argparse
import json
import sys
import time
from typing import Callable, Dict, Tuple

import numpy as np
import torch

from ..core import cuda_interpreter as ci
from ..core.registry import FunctionSet, build_function_set, special_operators, vocabulary_operators
from ..core.trees import EMPTY, OP_START, TreeTensors, rebuild_pointers

CHUNK = 2**28  # lanes of one forward launch (1 GiB of float32)
VJP_STRIDE = 256
N_ROWS = 4  # rows of a sweep tree (padding first)
EDGES = [0.0, -0.0, float("inf"), float("-inf"), float("nan"), 1.0, -1.0, 0.5, -0.5, 1.5, -1.5,
         2.5, -2.5, 3.0, -3.0, 2.0, 10.0, 1e-45, -1e-45, 1.1754942e-38, 1.1754944e-38,
         -1.1754944e-38, 3.4028235e38, -3.4028235e38]


ZETA_FLOOR = -256.0  # polygamma(n >= 2) sweeps: negative non-integers from here up
OUTSIDE_STRIDE = 4096  # and every 4096th of those below it, in bit order, apart
# operators whose sweeps keep to a domain (name -> why)
DOMAINS = {"polygamma2": "zeta"}


def _sets(groups) -> Tuple[FunctionSet, ...]:
    sets = tuple(build_function_set(ops, [["x0"]] if all(a == 1 for *_, a in ops) else [["x0", "x1"]], [1])
                 for ops in groups)
    refused = [r for fset in sets for r in fset.refusals]
    if refused:  # this torch traces a callable to a node the emitter lacks
        raise NotImplementedError(f"vocabulary operators refused: {refused}")
    return sets


def sweep_sets(device="cpu") -> Tuple[FunctionSet, FunctionSet]:
    """``(unary set, binary set)``: :func:`.registry.vocabulary_operators`
    over one variable and two."""
    return _sets(vocabulary_operators())


def special_sweep_sets() -> Tuple[FunctionSet, FunctionSet, FunctionSet]:
    """The three sets of :func:`.registry.special_operators` (two unary over
    one variable, one binary over two)."""
    return _sets(special_operators())


def sweep_domain(name: str, x: torch.Tensor) -> torch.Tensor:
    """The lanes of ``x`` that operator ``name`` is swept on: all of them,
    but for :data:`DOMAINS` (the zeta series' operators: not the negative
    non-integers below :data:`ZETA_FLOOR`)."""
    if DOMAINS.get(name) == "zeta":
        return ~((x < ZETA_FLOOR) & (x != torch.floor(x)))
    return torch.ones_like(x, dtype=torch.bool)


def op_tree(fset: FunctionSet, name: str, device) -> TreeTensors:
    """``name(x0)`` or ``name(x0, x1)`` as one tree of :data:`N_ROWS` rows
    (root last; a binary row's first operand the row below it)."""
    op = fset.string_to_op[name]
    leaves = [fset.var_start] if fset.arities[op - OP_START] == 1 else [fset.var_start + 1, fset.var_start]
    ops = torch.tensor([[EMPTY] * (N_ROWS - len(leaves) - 1) + leaves + [op]], dtype=torch.int32)
    c1, c2 = rebuild_pointers(ops, fset.slots())
    return TreeTensors(ops, c1, c2, torch.zeros((1, N_ROWS))).map(lambda a: a.to(device))


def bit_patterns(start: int, count: int, device, step: int = 1) -> torch.Tensor:
    """float32 values whose bits are ``start, start + step, ...`` (count of
    them, below 2^32)."""
    bits = torch.arange(start, start + count * step, step, dtype=torch.int64, device=device)
    bits = torch.where(bits >= 2**31, bits - 2**32, bits)
    return bits.to(torch.int32).view(torch.float32)


def _same(got: torch.Tensor, want: torch.Tensor, exact_zero: bool):
    """``(mismatching lanes, lanes differing only in the sign of zero)``."""
    nan = torch.isnan(got) & torch.isnan(want)
    bits = got.view(torch.int32) == want.view(torch.int32)
    values = got == want
    if exact_zero:
        bad = ~(bits | nan)
    else:
        bad = ~(values | nan)
    return bad, ~bits & values


def _first(bad, *cols) -> list:
    if not bool(bad.any()):
        return []
    i = int(torch.nonzero(bad)[0, 0])
    return [f"0x{int(c[i].view(torch.int32)) & 0xffffffff:08x}" for c in cols]


def _autograd(fn: Callable, xs, g):
    """``(value, per-operand cotangents)`` of ``fn`` on CUDA by autograd."""
    xs = [x.detach().requires_grad_(True) for x in xs]
    out = fn(*xs)
    if not out.requires_grad:
        return out.detach(), [torch.zeros_like(x) for x in xs]
    grads = torch.autograd.grad(out, xs, g, allow_unused=True)
    return out.detach(), [torch.zeros_like(x) if d is None else d for x, d in zip(xs, grads)]


def _unary_vjp(tree: TreeTensors, fset: FunctionSet, fn: Callable, x: torch.Tensor, seed: int) -> Dict:
    """The VJP's mismatches on ``x``, with the cotangent 1 and a seeded
    normal one."""
    gen = torch.Generator(device=x.device).manual_seed(seed)
    vjp = {}
    for tag, g in (("g1", torch.ones_like(x)),
                   ("g_normal", torch.randn(x.shape, generator=gen, device=x.device))):
        got = ci.evaluate_trees_vjp_cuda(tree, x[:, None], g, fset)[1][:, 0]
        _, (want,) = _autograd(fn, [x], g)
        bad, zero_sign = _same(got, want, exact_zero=False)
        vjp[tag] = dict(mismatches=int(bad.sum()), zero_sign=int(zero_sign.sum()),
                        first=_first(bad, x, got, want))
    return vjp


def _timed(fn: Callable):
    """``(fn(), milliseconds)`` with the device synchronised around it."""
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    out = fn()
    torch.cuda.synchronize()
    return out, (time.perf_counter() - t0) * 1e3


def sweep_unary(fset: FunctionSet, name: str, fn: Callable, device, stride: int = 1,
                seed: int = 0) -> Dict:
    """Forward on every ``stride``-th bit pattern, VJP on every 256th (and
    every ``stride``-th, if coarser): mismatch counts and the first
    counter-example's bits ``(x, kernel, PyTorch)``. An operator of
    :data:`DOMAINS` also gets ``outside``: forward and VJP on every
    :data:`OUTSIDE_STRIDE`-th lane its domain left out, and the
    milliseconds of the kernel's and PyTorch's forward there."""
    tree = op_tree(fset, name, device)
    t0 = time.perf_counter()
    lanes, bad_n, first, skipped, outside = 0, 0, [], 0, []
    span = CHUNK * stride
    for start in range(0, 2**32, span):
        x = bit_patterns(start, min(CHUNK, (2**32 - start) // stride), device, stride)
        if name in DOMAINS:
            keep = sweep_domain(name, x)
            skipped += int((~keep).sum())
            outside.append(x[~keep][::OUTSIDE_STRIDE])
            x = x[keep]
        got = ci.evaluate_trees_cuda(tree, x[:, None], fset)
        want = fn(x)
        bad, _ = _same(got, want, exact_zero=True)
        n = int(bad.sum())
        if n and not first:
            first = _first(bad, x, got, want)
        bad_n += n
        lanes += x.numel()
        del x, got, want, bad
    fwd_s = time.perf_counter() - t0
    vstride = max(VJP_STRIDE, stride)
    x = bit_patterns(0, 2**32 // vstride, device, vstride)
    x = x[sweep_domain(name, x)]
    out = dict(name=name, arity=1, lanes=lanes, stride=stride, mismatches=bad_n, first=first,
               vjp_lanes=x.numel(), vjp=_unary_vjp(tree, fset, fn, x, seed), skipped=skipped, fwd_s=fwd_s)
    if name in DOMAINS:
        x = torch.cat(outside)
        got, kernel_ms = _timed(lambda: ci.evaluate_trees_cuda(tree, x[:, None], fset))
        want, torch_ms = _timed(lambda: fn(x))
        bad, _ = _same(got, want, exact_zero=True)
        out["outside"] = dict(lanes=x.numel(), mismatches=int(bad.sum()), first=_first(bad, x, got, want),
                              vjp=_unary_vjp(tree, fset, fn, x, seed), kernel_ms=kernel_ms, torch_ms=torch_ms)
    out["s"] = time.perf_counter() - t0
    return out


def grid_values(side: int, device, seed: int = 0) -> torch.Tensor:
    """``side`` float32 values stratified by exponent (each of the 256
    exponents, both signs, random mantissas) then :data:`EDGES`."""
    rng = np.random.default_rng(seed)
    per = max(1, side // 512)
    exps = np.repeat(np.arange(256, dtype=np.uint32), 2 * per)
    signs = np.tile(np.repeat(np.array([0, 1], np.uint32), per), 256)
    mant = rng.integers(0, 2**23, size=exps.size, dtype=np.uint32)
    bits = (signs << 31) | (exps << 23) | mant
    vals = np.concatenate([bits.view(np.float32)[:side], np.asarray(EDGES, np.float32)])
    return torch.from_numpy(vals).to(device)


def sweep_binary(fset: FunctionSet, name: str, fn: Callable, device, side: int = 4096,
                 seed: int = 0) -> Dict:
    """Forward and VJP on the ``grid_values`` x ``grid_values`` grid."""
    tree = op_tree(fset, name, device)
    t0 = time.perf_counter()
    v = grid_values(side, device, seed)
    x = v[:, None].expand(-1, v.numel()).reshape(-1)
    y = v[None, :].expand(v.numel(), -1).reshape(-1)
    data = torch.stack([x, y], dim=1)
    got = ci.evaluate_trees_cuda(tree, data, fset)
    want = fn(x, y)
    bad, _ = _same(got, want, exact_zero=True)
    out = dict(name=name, arity=2, lanes=x.numel(), mismatches=int(bad.sum()),
               first=_first(bad, x, y, got, want), vjp={})
    gen = torch.Generator(device=device).manual_seed(seed + 1)
    for tag, g in (("g1", torch.ones_like(x)), ("g_normal", torch.randn(x.shape, generator=gen, device=device))):
        _, ddata = ci.evaluate_trees_vjp_cuda(tree, data, g, fset)
        _, want_d = _autograd(fn, [x, y], g)
        res = dict(mismatches=0, zero_sign=0, first=[])
        for k in range(2):
            bad, zero_sign = _same(ddata[:, k].contiguous(), want_d[k], exact_zero=False)
            res["mismatches"] += int(bad.sum())
            res["zero_sign"] += int(zero_sign.sum())
            res["first"] = res["first"] or _first(bad, x, y, ddata[:, k].contiguous(), want_d[k])
        out["vjp"][tag] = res
    out["vjp_lanes"] = x.numel()
    out["s"] = time.perf_counter() - t0
    return out


def sweep_set(fset: FunctionSet, device, stride: int = 1, side: int = 4096, report=None, only=None):
    """Every operator of ``fset`` (of those named in ``only``, if given): one
    dict each (``report(dict)`` is called as each ends)."""
    results = []
    for name, fn, arity in zip(fset.operator_names, fset.operator_fns, fset.arities):
        if only is not None and name not in only:
            continue
        # the set's callables take (x, y), a unary one ignoring y
        r = (sweep_unary(fset, name, lambda x, f=fn: f(x, x), device, stride) if arity == 1
             else sweep_binary(fset, name, fn, device, side))
        parts = [r] + ([r["outside"]] if "outside" in r else [])
        r["ok"] = all(p["mismatches"] == 0 and all(v["mismatches"] == 0 for v in p["vjp"].values())
                      for p in parts)
        results.append(r)
        if report:
            report(r)
    return results


def main(argv=None) -> int:
    parser = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    parser.add_argument("--stride", type=int, default=1, help="forward on every S-th bit pattern")
    parser.add_argument("--side", type=int, default=4096, help="the binary grid's side")
    parser.add_argument("--only", nargs="*", default=None, help="sweep only these operators")
    opts = parser.parse_args(argv)
    if not torch.cuda.is_available():
        print("op_sweep: needs an NVIDIA GPU", file=sys.stderr)
        return 1
    device = torch.device("cuda")
    print(json.dumps(dict(torch=torch.__version__, cuda=torch.version.cuda,
                          device=torch.cuda.get_device_name(0))), flush=True)
    results = []
    for fset in sweep_sets() + special_sweep_sets():
        results += sweep_set(fset, device, opts.stride, opts.side,
                             report=lambda r: print(json.dumps(r), flush=True), only=opts.only)
    bad = [r["name"] for r in results if not r["ok"]]
    print(json.dumps(dict(operators=len(results), failed=bad)))
    return 1 if bad else 0


if __name__ == "__main__":
    sys.exit(main())
