"""User control environments as generated device code: trace, check, emit.

JAX's policy kernels (#6, #7) trace the environment itself inside the
kernel body: ``env.drift``, ``env.cond_alive`` and ``env.obs_tiles`` /
``obs_tiles_noisy`` of any environment whose class sets ``tile_safe_drift =
True``. The port's kernels have a hand-written plant for each of the seven
built-in classes (``csrc/control_envs.cuh``); any other tile-safe
environment is traced here into one generated struct, which ``csrc/policy.cu``
compiles as the only plant of its user-environment build
(``_build.env_variant``: ``-DMTGP_USER_ENV -include <header>``, the
libraries ``policy_e<hash12>``, ``policy_ext_e<hash12>``,
``policy_u<hash12>_e<hash12>`` and their ``_wide`` forms).

* **Trace.** ``make_fx`` of ``drift(0.0, x, u, params)``, ``cond_alive(0.0,
  x)``, ``obs(x)`` and ``obs_noisy(x, noise)``, each functionalised as
  ``user_ops.trace`` does, on float32 CPU tensors: ``x (8, latent)``, ``u (8,
  n_control)``, one ``(8,)`` tensor per parameter leaf (in the structure the
  caller's params have), ``noise (8, n_obs)``. Time is the constant 0, as
  JAX's kernels pass ``jnp.float32(0.0)``; numbers the methods read from
  ``self`` become constants of the generated code.
* **Check.** Every value is per lane: a scalar ``(8,)``, a vector along the
  last (state) axis ``(8, k)``, or a constant. Indexing (``select``,
  ``slice``, ``unbind``, ``squeeze``, ``unsqueeze`` of the last axis by
  constants) and ``stack`` / ``cat`` along it rearrange vectors (a width-1
  vector broadcasts along the axis);
  every other node is an elementwise op of ``user_ops.EMITTERS``, applied per
  component. Refused, with the reason: a method that does not trace (Python
  control flow on values), a tensor constant (a matmul with a constant
  matrix among them), a reduction, a random draw, a value that is not
  float32 (or a comparison's bool), a value that mixes the lane axis with
  the state axis, and outputs of other shapes than ``(8, latent)`` float32,
  ``(8,)`` bool and ``(8, n_obs)`` float32.
* **Emit.** One statement per component of each node, the expression of
  ``user_ops.node_expr`` (one float32 rounding, PyTorch's CUDA formula), in
  a struct with ``kLatent``, ``kControls``, ``kParams``, ``kObs``, ``drift``,
  ``alive`` and ``observe(x, noise_or_null, y)``. The header's text is the
  same for the same code, so its sha256 names the build.

Trace results are cached per environment instance (with the parameters'
structure): the constants of an instance are read once.
"""
from __future__ import annotations

import operator
import weakref
from dataclasses import dataclass
from typing import Callable, Dict, List, Optional, Sequence, Tuple, Union

import torch

from . import user_ops
from .user_ops import TRACE_LANES, Refused

USER_ENV_ID = 7  # csrc/control_envs.cuh kUserEnv: the user-environment build's one plant

_AT = torch.ops.aten


@dataclass(frozen=True)
class TracedEnv:
    """The generated plant of one environment: its sizes and the header
    (``csrc/policy.cu`` compiles its ``mtgp_env::UserEnv``; its build is
    ``_build.env_variant(fset.variant, header)``)."""

    name: str
    latent: int
    controls: int
    params: int
    obs: int
    header: str


# ---------------------------------------------------------------- values

class _Vec(list):
    """A vector along the state axis: one C++ name per component."""


class _Tuple(tuple):
    """The values of a multi-output node (``unbind``)."""


def _shape(node) -> Tuple[int, ...]:
    val = user_ops.value_of(node)
    return tuple(val.shape) if isinstance(val, torch.Tensor) else ()


def _last_axis(node, dim: int, what: str) -> None:
    """Refuse an index, slice or concatenation of any axis but the last of a
    ``(8, k)`` value."""
    nd = len(_shape(node))
    if nd != 2 or dim % nd != 1:
        raise Refused(f"it indexes or joins the lane axis ({what}, dim {dim} of shape {_shape(node)})")


def _check_env_value(node, what: str) -> None:
    """``user_ops._check_value`` for environments: float32 or a comparison's
    bool, per lane as a scalar ``(8,)`` or a vector ``(8, k)``, or a constant
    maker's ``()``; a tensor operand of a vector node is itself a vector (a
    per-lane ``(8,)`` would broadcast along the state axis)."""
    val = user_ops.value_of(node)
    if not isinstance(val, torch.Tensor):
        raise Refused(f"{what} has no tensor value")
    if val.dtype not in (torch.float32, torch.bool):
        raise Refused(f"{what} computes in {val.dtype}, not float32")
    if val.dtype == torch.bool and node.target not in user_ops._BOOL_OPS:
        raise Refused(f"{what} makes a bool outside a comparison")
    shape = tuple(val.shape)
    if val.dim() == 0:
        if node.target not in user_ops._CONSTANT_MAKERS:
            raise Refused(f"{what} reduces over the lanes")
        return
    if shape[0] != TRACE_LANES or val.dim() > 2:
        raise Refused(f"{what} is not per lane (shape {shape})")
    if val.dim() == 2:
        skip = node.target in user_ops._SHAPE_ONLY
        for i, a in enumerate(node.args):
            if isinstance(a, torch.fx.Node) and not (skip and i == 0) and len(_shape(a)) == 1:
                raise Refused(f"{what} broadcasts a per-lane value {_shape(a)} along the state axis "
                              f"of {shape} (index it as v[..., None])")


# ops that rearrange vectors (their first argument the value, then the dim)
_VIEWS = {_AT.select_copy.int, _AT.slice_copy.Tensor, _AT.unbind_copy.int, _AT.unsqueeze_copy.default,
          _AT.squeeze_copy.dim, _AT.squeeze_copy.dims, _AT.stack.default, _AT.cat.default,
          _AT.alias_copy.default, _AT.clone.default, _AT.alias.default, _AT.detach.default}
# constant makers by size (``torch.ones(x.shape[:-1], dtype=torch.bool)``, ...)
_FILLS = {_AT.ones.default: 1.0, _AT.zeros.default: 0.0, _AT.full.default: None,
          _AT.new_ones.default: 1.0, _AT.new_zeros.default: 0.0, _AT.new_full.default: None}


class _Emitter:
    """One method's graph as statements: each node's value is a C++ name (a
    per-lane scalar), a :class:`_Vec` of names, or a :class:`_Tuple`."""

    def __init__(self, lines: List[str]):
        self.lines = lines
        self.values: Dict[torch.fx.Node, object] = {}

    def _new(self, ctype: str, expr: str) -> str:
        name = f"v{len(self.lines)}"
        self.lines.append(f"const {ctype} {name} = {expr};")
        return name

    def _component(self, a, i: int) -> str:
        v = self.values[a]
        if isinstance(v, _Vec):
            return v[i] if len(v) > 1 else v[0]  # a width-1 vector broadcasts
        return v

    def run(self, gm: torch.fx.GraphModule, inputs: Sequence) -> list:
        outs = []
        placeholders = iter(inputs)
        for node in gm.graph.nodes:
            if node.op == "placeholder":
                self.values[node] = next(placeholders)
            elif node.op == "get_attr":
                raise Refused(f"it holds a tensor constant ({node.target})")
            elif node.op == "call_function":
                self.values[node] = self._node(node)
            elif node.op == "output":
                res = node.args[0]
                for o in (res if isinstance(res, (tuple, list)) else (res,)):
                    if not isinstance(o, torch.fx.Node):
                        raise Refused(f"it returns {o!r}, not a tensor of the lanes")
                    outs.append((o, self.values[o]))
            else:
                raise Refused(f"a graph node of kind {node.op}")
        return outs

    def _node(self, node):
        target, args = node.target, node.args
        if target is operator.getitem and getattr(args[0], "target", None) in user_ops._MULTI_OUTPUT:
            # output 0 is the op's value; the others are not read by any emitted op
            v = self.values[args[0]]
            return v if args[1] == 0 else (_Vec([user_ops._f32(0.0)] * len(v)) if isinstance(v, _Vec)
                                           else user_ops._f32(0.0))
        if target is operator.getitem:
            seq = self.values[args[0]]
            if not isinstance(seq, _Tuple):
                raise Refused("it indexes a value that is not a tuple of the state axis")
            return seq[args[1]]
        what = f"{target}"
        if target in _FILLS:
            return self._fill(node, what)
        if target in _VIEWS:
            return self._view(node, what)
        user_ops.check_op(node, _check_env_value)
        ctype = "bool" if user_ops.value_of(node).dtype == torch.bool else "float"
        shape = _shape(node)
        if len(shape) < 2:
            return self._new(ctype, user_ops.node_expr(node, lambda a: self._component(a, 0)))
        return _Vec(self._new(ctype, user_ops.node_expr(node, lambda a, i=i: self._component(a, i)))
                    for i in range(shape[1]))

    def _fill(self, node, what: str):
        shape = _shape(node)
        dtype = node.kwargs.get("dtype")
        if dtype not in (None, torch.float32, torch.bool):
            raise Refused(f"a constant of dtype {dtype} ({what})")
        if not shape or shape[0] != TRACE_LANES or len(shape) > 2:
            raise Refused(f"{what} is not per lane (shape {shape})")
        value = _FILLS[node.target]
        if value is None:  # full / new_full: the fill value follows the size
            value = user_ops._scalar(node.args[2 if node.target == _AT.new_full.default else 1])
        if node.meta["val"].dtype == torch.bool:
            expr = "true" if value else "false"
        else:
            expr = user_ops._f32(value)
        return expr if len(shape) == 1 else _Vec([expr] * shape[1])

    def _view(self, node, what: str):
        target, args = node.target, node.args
        val = node.meta.get("val")
        tensors = [val] if isinstance(val, torch.Tensor) else list(val)
        for t in tensors:
            if t.dtype not in (torch.float32, torch.bool):
                raise Refused(f"{what} computes in {t.dtype}, not float32")
        if target in (_AT.stack.default, _AT.cat.default):
            parts, dim = args[0], args[1] if len(args) > 1 else 0
            want = 1 if target == _AT.stack.default else 2
            for a in parts:
                if len(_shape(a)) != want:
                    raise Refused(f"it joins values of shape {_shape(a)} ({what})")
            _last_axis(node, dim, what)
            if target == _AT.stack.default:
                return _Vec(self.values[a] for a in parts)
            return _Vec(c for a in parts for c in self.values[a])
        src = args[0]
        v = self.values[src]
        if target in (_AT.alias_copy.default, _AT.clone.default, _AT.alias.default, _AT.detach.default):
            return v
        if target == _AT.unsqueeze_copy.default:
            if len(_shape(src)) != 1 or args[1] % 2 != 1:
                raise Refused(f"it adds an axis other than the last to {_shape(src)} ({what})")
            return _Vec([v])
        dim = args[1] if len(args) > 1 else 0
        _last_axis(src, dim[0] if isinstance(dim, (list, tuple)) else dim, what)
        if target == _AT.select_copy.int:
            return v[args[2]]
        if target == _AT.unbind_copy.int:
            return _Tuple(v)
        if target in (_AT.squeeze_copy.dim, _AT.squeeze_copy.dims):
            if len(v) != 1 or (isinstance(dim, (list, tuple)) and len(dim) != 1):
                raise Refused(f"it squeezes {_shape(src)} ({what})")
            return v[0]
        start, end, step = (list(args[2:]) + [None, None, 1])[:3]  # slice_copy
        return _Vec(v[slice(start, end, step)])


# ------------------------------------------------------------------ trace

def _params_like(params, lanes: int):
    """The parameters' structure with one ``(lanes,)`` float32 tensor a
    leaf: a tuple or list of leaves, or one tensor."""
    if isinstance(params, (tuple, list)):
        return type(params)(torch.zeros(lanes) for _ in params)
    return torch.zeros(lanes)


def _trace(fn: Callable, args) -> torch.fx.GraphModule:
    from torch.fx.experimental.proxy_tensor import make_fx

    pure = torch.func.functionalize(fn, remove="mutations_and_views")
    try:
        gm = make_fx(pure)(*args)
    except Refused:
        raise
    except Exception as exc:  # noqa: BLE001 - any failure to trace refuses the environment
        first = str(exc).strip().splitlines()[0] if str(exc).strip() else ""
        raise Refused(f"it does not trace to an aten graph ({type(exc).__name__}: {first[:160]})") from exc
    if any(n.target == _AT.copy_.default for n in gm.graph.nodes):
        raise Refused("it writes into its own inputs (aten.copy_)")
    gm.graph.eliminate_dead_code()
    return gm


def _output(outs, what: str, shape: Tuple[int, ...], dtype) -> list:
    """The one output of a method as a list of C++ names, refused unless it
    has ``shape`` and ``dtype``."""
    if len(outs) != 1:
        raise Refused(f"{what} returns {len(outs)} values, not one")
    node, value = outs[0]
    val = node.meta.get("val")
    if not isinstance(val, torch.Tensor) or tuple(val.shape) != shape or val.dtype != dtype:
        got = (tuple(val.shape), val.dtype) if isinstance(val, torch.Tensor) else val
        raise Refused(f"{what} returns {got}, not {shape} {dtype}")
    return list(value) if isinstance(value, _Vec) else [value]


_HEAD = """\
// Generated by multitreegp_tpu_torch/core/user_envs.py: one control
// environment's plant, traced from its torch methods, for the policy
// kernels' user-environment build (csrc/policy.cu with -DMTGP_USER_ENV
// -include <this file>).
#pragma once

"""


def _method(signature: str, lines: Sequence[str], unused: Sequence[str]) -> List[str]:
    body = [f"(void){a};" for a in unused] + list(lines)
    return [f"  MTGP_USER_HD static {signature} {{"] + ["    " + ln for ln in body] + ["  }"]


def compile_env(env, params) -> TracedEnv:
    """Trace ``env``'s drift, liveness and observations and emit its
    header; raises :class:`Refused` with the reason where it cannot.
    ``params``: the parameters as the evaluators pass them (their structure
    is traced)."""
    lanes, latent, nc, n_obs = TRACE_LANES, env.latent_size, env.n_control, env.n_obs
    p = _params_like(params, lanes)
    leaves = list(p) if isinstance(p, (tuple, list)) else [p]
    n_par = len(leaves)
    if not n_par:
        raise Refused(f"{type(env).__name__} has no parameter leaves (the kernels read at least one)")
    x, u, noise = torch.zeros(lanes, latent), torch.zeros(lanes, nc), torch.zeros(lanes, n_obs)
    x_in = _Vec(f"x[{q}]" for q in range(latent))
    u_in = _Vec(f"u[{j}]" for j in range(nc))
    p_in = [f"p[{k}]" for k in range(n_par)]
    n_in = _Vec(f"noise[{q}]" for q in range(n_obs))
    pack = (lambda ls: type(p)(ls)) if isinstance(p, (tuple, list)) else (lambda ls: ls[0])

    def emit(what, fn, args, inputs, shape, dtype):
        lines: List[str] = []
        try:
            outs = _Emitter(lines).run(_trace(fn, args), inputs)
            return lines, _output(outs, what, shape, dtype)
        except Refused as exc:
            raise Refused(f"{type(env).__name__}.{what}: {exc}") from exc

    d_lines, dx = emit("drift", lambda x, u, *ps: env.drift(0.0, x, u, pack(list(ps))),
                       (x, u, *leaves), [x_in, u_in, *p_in], (lanes, latent), torch.float32)
    a_lines, alive = emit("cond_alive", lambda x: env.cond_alive(0.0, x), (x,), [x_in], (lanes,),
                          torch.bool)
    o_lines, y = emit("obs", lambda x: env.obs(x), (x,), [x_in], (lanes, n_obs), torch.float32)
    n_lines, yn = emit("obs_noisy", lambda x, noise: env.obs_noisy(x, noise), (x, noise),
                       [x_in, n_in], (lanes, n_obs), torch.float32)
    observe = (["if (noise == nullptr) {"] + ["  " + ln for ln in o_lines]
                + [f"  y[{q}] = {v};" for q, v in enumerate(y)] + ["  return;", "}"]
                + n_lines + [f"y[{q}] = {v};" for q, v in enumerate(yn)])
    math = user_ops.math_text(user_ops.sections_called("\n".join(d_lines + a_lines + o_lines + n_lines)))
    parts = [_HEAD + user_ops.INCLUDES,
             "// the operator header (-DMTGP_USER_OPS), included first, defines these",
             "#ifndef MTGP_USER_OPS", "namespace mtgp_user {", "", user_ops.HELPERS.rstrip(), "",
             "}  // namespace mtgp_user", "#endif", "",
             # the formulas the plant calls, each guarded: the operator header may hold them too
             *(["namespace mtgp_user {", "", math.rstrip(), "", "}  // namespace mtgp_user", ""]
               if math else []),
             "namespace mtgp_env {", "",
             "struct UserEnv {",
             "  static constexpr bool kTraced = true;",
             f"  static constexpr int kLatent = {latent}, kControls = {nc}, kParams = {n_par}, "
             f"kObs = {n_obs};",
             "  // dx = drift(0, x, u, p): x (kLatent), u (kControls), p (kParams)"]
    parts += _method("void drift(const float* x, const float* u, const float* p, float* dx)",
                     d_lines + [f"dx[{q}] = {v};" for q, v in enumerate(dx)], ("x", "u", "p"))
    parts += ["  // cond_alive(0, x)"]
    parts += _method("bool alive(const float* x)", a_lines + [f"return {alive[0]};"], ("x",))
    parts += ["  // y = obs(x) (kObs), or obs_noisy(x, noise) with the scaled draw noise (kObs)"]
    parts += _method("void observe(const float* x, const float* noise, float* y)", observe,
                     ("x", "noise"))
    parts += ["};", "", "}  // namespace mtgp_env", ""]
    return TracedEnv(type(env).__name__, latent, nc, n_par, n_obs, "\n".join(parts))


_cache: "weakref.WeakKeyDictionary" = weakref.WeakKeyDictionary()


def traced(env, params) -> Union[TracedEnv, Refused]:
    """The environment's :class:`TracedEnv`, or the :class:`Refused` that
    says why it has none; cached per instance and parameter structure."""
    key = len(params) if isinstance(params, (tuple, list)) else None
    per_env = _cache.setdefault(env, {})
    if key not in per_env:
        try:
            per_env[key] = compile_env(env, params)
        except Refused as exc:
            per_env[key] = exc
    return per_env[key]


def refusal(env, params) -> Optional[str]:
    """Why ``env`` has no traced plant (``tile_safe_drift`` False, or the
    trace's reason), or None."""
    if not getattr(env, "tile_safe_drift", False):
        return f"{type(env).__name__} sets tile_safe_drift = False"
    got = traced(env, params)
    return str(got) if isinstance(got, Refused) else None
