"""Generic ONNX-graph executor in PyTorch, the counterpart of
``supertonic_tpu.assets.onnx_exec``.

It interprets any ONNX graph op by op on top of the dependency-free
``onnx_reader``, with the design of the JAX executor:

* **Static shape math.** Integer initializers, ``Shape``/``Constant``
  outputs and every op of the static-eval set whose inputs are all host
  values are computed with numpy (partial evaluation), so ``Reshape``,
  ``Slice``, ``Expand`` and the like see concrete shapes. An operand that
  must be static but is a device tensor raises ``UnsupportedOp``: the
  executor never reads a device value on the host (no ``.item()``, no
  ``.cpu()``), so a call can be captured into a CUDA graph, and every graph
  the JAX executor refuses under ``jit`` is refused here too.
* **Device constants.** Float initializers become device tensors once, at
  construction (``_weights``). A numpy value that meets a device tensor
  goes to the device through a per-device cache keyed by its contents: the
  eager run that precedes a capture fills it, so a capture makes no
  host-to-device copy.
* **Precision.** ``matmul_precision="float32"`` is strict f32 (TF32 off in
  cuBLAS and cuDNN); any other value allows TF32, as XLA's default does on
  a GPU. The switches are process-wide: each call sets them, under a lock,
  and restores them after.
* **Integers** keep torch's int64 where the JAX executor has int32 (JAX
  runs with 32-bit ints): values agree, dtypes may not. float64 becomes
  float32 on the device, as in JAX.

Reserved env keys, as in the JAX executor: ``__opset__``, ``__time_mask__``
(bucket-padding mask re-applied after every Conv/ConvTranspose),
``__bf16_storage__`` with ``__graph_outputs__``; and ``__tx__``, the torch
namespace of the call (device and constant cache).
"""

from __future__ import annotations

import contextlib
import dataclasses
import math
import threading
from typing import Any, Callable

import numpy as np
import torch
import torch.nn.functional as F

from .onnx_reader import DTYPE_MAP, OnnxGraph, OnnxNode, load_onnx

__all__ = ["OnnxExecutor", "OnnxSession", "load_session", "UnsupportedOp"]


class UnsupportedOp(NotImplementedError):
    pass


def _is_static(v) -> bool:
    return isinstance(v, (np.ndarray, np.generic))


# ---------------------------------------------------------------------------
# dtypes and the torch namespace
# ---------------------------------------------------------------------------

_NP_TO_TORCH = {
    np.dtype(np.bool_): torch.bool,
    np.dtype(np.uint8): torch.uint8,
    np.dtype(np.int8): torch.int8,
    np.dtype(np.int16): torch.int16,
    np.dtype(np.int32): torch.int32,
    np.dtype(np.int64): torch.int64,
    # torch has few kernels for the wide unsigned types: hold their values
    np.dtype(np.uint16): torch.int32,
    np.dtype(np.uint32): torch.int64,
    np.dtype(np.uint64): torch.int64,
    np.dtype(np.float16): torch.float16,
    np.dtype(np.float32): torch.float32,
    np.dtype(np.float64): torch.float32,  # JAX's canonical float
}
try:
    import ml_dtypes

    _NP_TO_TORCH[np.dtype(ml_dtypes.bfloat16)] = torch.bfloat16
except ImportError:  # pragma: no cover
    ml_dtypes = None


def torch_dtype(dt) -> torch.dtype:
    """The device dtype for a numpy dtype (float64 -> float32)."""
    return _NP_TO_TORCH[np.dtype(dt)]


def np_dtype(dt) -> np.dtype:
    """The numpy dtype of a tensor's dtype (bf16 needs ml_dtypes)."""
    if isinstance(dt, torch.dtype):
        if dt == torch.bfloat16:
            return np.dtype(ml_dtypes.bfloat16) if ml_dtypes else np.dtype(np.float32)
        return torch.empty((), dtype=dt).numpy().dtype
    return np.dtype(dt)


def _dtype_of(v):
    return np.asarray(v).dtype if _is_static(v) else v.dtype


def _is_int(v) -> bool:
    dt = _dtype_of(v)
    if isinstance(dt, torch.dtype):
        return not dt.is_floating_point and not dt.is_complex and dt != torch.bool
    return np.issubdtype(dt, np.integer)


def to_numpy(t: torch.Tensor) -> np.ndarray:
    """A host copy of a tensor (bf16 kept when ml_dtypes is installed)."""
    t = t.detach()
    if t.dtype == torch.bfloat16:
        out = t.float().cpu().numpy()
        return out.astype(ml_dtypes.bfloat16) if ml_dtypes else out
    return t.cpu().numpy()


def from_numpy(arr, device) -> torch.Tensor:
    arr = np.asarray(arr)
    dt = torch_dtype(arr.dtype)
    if device.type == "meta":
        return torch.empty(arr.shape, dtype=dt, device=device)
    if arr.dtype == np.dtype(ml_dtypes.bfloat16 if ml_dtypes else np.float32) \
            and dt == torch.bfloat16:
        host = torch.from_numpy(np.array(arr).view(np.int16)).view(torch.bfloat16)
    else:
        host = torch.from_numpy(np.array(arr, dtype=np_dtype(dt)))
    return host.to(device)


class TX:
    """The torch counterpart of ``jnp`` in the handlers: functions named as
    numpy's, taking tensors, numpy values (moved to ``device`` through the
    executor's constant cache) and Python scalars. Two tensors of different
    dtypes are promoted by dtype alone, as JAX promotes strongly typed
    arrays (torch would let a 0-dim tensor take the other's dtype)."""

    def __init__(self, device: torch.device, consts: dict):
        self.device = device
        self._consts = consts

    def t(self, v):
        """A tensor on the device for a numpy value; tensors, scalars and
        None pass through."""
        if not _is_static(v):
            return v
        arr = np.asarray(v)
        if self.device.type == "meta":
            return from_numpy(arr, self.device)
        key = (arr.dtype.str, arr.shape, arr.tobytes())
        hit = self._consts.get(key)
        if hit is None:
            hit = self._consts[key] = from_numpy(arr, self.device)
        return hit

    def full(self, shape, value, dtype) -> torch.Tensor:
        return torch.full(tuple(shape), value, dtype=dtype, device=self.device)

    # -- promotion ---------------------------------------------------------
    def pair(self, a, b):
        a, b = self.t(a), self.t(b)
        at, bt = isinstance(a, torch.Tensor), isinstance(b, torch.Tensor)
        if at and bt:
            if a.dtype != b.dtype:
                dt = torch.promote_types(a.dtype, b.dtype)
                a, b = a.to(dt), b.to(dt)
        elif at:
            b = self.full((), b, torch.result_type(a, b))
            a = a.to(b.dtype)
        elif bt:
            a = self.full((), a, torch.result_type(b, a))
            b = b.to(a.dtype)
        return a, b

    def _bin(self, fn, a, b):
        return fn(*self.pair(a, b))

    def add(self, a, b): return self._bin(torch.add, a, b)
    def subtract(self, a, b): return self._bin(torch.sub, a, b)
    def multiply(self, a, b): return self._bin(torch.mul, a, b)
    def divide(self, a, b): return self._bin(torch.true_divide, a, b)
    def power(self, a, b): return self._bin(torch.pow, a, b)
    def maximum(self, a, b): return self._bin(torch.maximum, a, b)
    def minimum(self, a, b): return self._bin(torch.minimum, a, b)
    def equal(self, a, b): return self._bin(torch.eq, a, b)
    def greater(self, a, b): return self._bin(torch.gt, a, b)
    def greater_equal(self, a, b): return self._bin(torch.ge, a, b)
    def less(self, a, b): return self._bin(torch.lt, a, b)
    def less_equal(self, a, b): return self._bin(torch.le, a, b)
    def logical_and(self, a, b): return self._bin(torch.logical_and, a, b)
    def logical_or(self, a, b): return self._bin(torch.logical_or, a, b)
    def logical_xor(self, a, b): return self._bin(torch.logical_xor, a, b)
    def fmod(self, a, b): return self._bin(torch.fmod, a, b)
    def mod(self, a, b): return self._bin(torch.remainder, a, b)

    def where(self, c, a, b):
        a, b = self.pair(a, b)
        return torch.where(self.t(c).to(torch.bool), a, b)

    # -- unary -------------------------------------------------------------
    def __getattr__(self, name):
        fn = _UNARY.get(name)
        if fn is None:
            raise AttributeError(name)
        return lambda x: fn(self.t(x))

    def logical_not(self, x): return torch.logical_not(self.t(x))
    def isposinf(self, x): return torch.isposinf(self.t(x))
    def isneginf(self, x): return torch.isneginf(self.t(x))

    def zeros_like(self, x, dtype=None):
        x = self.t(x)
        return torch.zeros(x.shape, dtype=torch.bool if dtype is bool else (dtype or x.dtype),
                           device=self.device)

    # -- reductions (an empty axes tuple reduces nothing, as in numpy) -----
    def _red(self, fn, x, axis, keepdims):
        x = self.t(x)
        if axis is None:
            axis = tuple(range(x.ndim))
        elif not isinstance(axis, tuple):
            axis = (axis,)
        if not axis:
            return x
        axis = tuple(a % x.ndim for a in axis) if x.ndim else ()
        if not axis:
            return fn(x, ())
        return fn(x, axis, keepdims)

    def sum(self, x, axis=None, keepdims=False):
        return self._red(lambda t, a, k=False: torch.sum(t, dim=a, keepdim=k) if a else t,
                         x, axis, keepdims)

    def mean(self, x, axis=None, keepdims=False):
        return self._red(lambda t, a, k=False: torch.mean(t, dim=a, keepdim=k) if a else t,
                         x, axis, keepdims)

    def max(self, x, axis=None, keepdims=False):
        return self._red(lambda t, a, k=False: torch.amax(t, dim=a, keepdim=k) if a else t,
                         x, axis, keepdims)

    def min(self, x, axis=None, keepdims=False):
        return self._red(lambda t, a, k=False: torch.amin(t, dim=a, keepdim=k) if a else t,
                         x, axis, keepdims)

    def prod(self, x, axis=None, keepdims=False):
        def fn(t, a, k=False):
            for d in sorted(a, reverse=True):
                t = torch.prod(t, dim=d, keepdim=k)
            return t
        return self._red(fn, x, axis, keepdims)

    # -- layout ------------------------------------------------------------
    def reshape(self, x, shape): return torch.reshape(self.t(x), tuple(shape))

    def transpose(self, x, perm=None):
        x = self.t(x)
        return x.permute(*(perm if perm is not None else range(x.ndim - 1, -1, -1)))

    def squeeze(self, x, axis=None):
        x = self.t(x)
        if axis is None:
            return torch.squeeze(x)
        return torch.squeeze(x, tuple(a % x.ndim for a in axis)) if axis else x

    def expand_dims(self, x, axis): return torch.unsqueeze(self.t(x), axis)

    def concatenate(self, ins, axis=0):
        ts = [self.t(v) for v in ins]
        dt = ts[0].dtype
        for v in ts[1:]:
            dt = torch.promote_types(dt, v.dtype)
        return torch.cat([v.to(dt) for v in ts], dim=axis)

    def split(self, x, idx, axis=0):
        x = self.t(x)
        bounds = [0] + [int(i) for i in idx] + [x.shape[axis]]
        return [x.narrow(axis, lo, hi - lo) for lo, hi in zip(bounds, bounds[1:])]

    def broadcast_to(self, x, shape): return torch.broadcast_to(self.t(x), tuple(shape))
    def tile(self, x, reps): return torch.tile(self.t(x), tuple(reps))

    def pad(self, x, width, mode="constant", constant_values=0):
        x = self.t(x)
        if mode == "constant":
            flat = [p for lo_hi in reversed(width) for p in lo_hi]
            if isinstance(constant_values, torch.Tensor):
                keep = F.pad(torch.ones(x.shape, dtype=torch.bool, device=self.device),
                             flat, value=False)
                return torch.where(keep, F.pad(x, flat), constant_values.to(x.dtype))
            return F.pad(x, flat, value=constant_values)
        # reflect / edge / wrap on any axis: numpy's own index pattern
        for ax, (lo, hi) in enumerate(width):
            if lo or hi:
                idx = np.pad(np.arange(x.shape[ax]), (lo, hi), mode=mode)
                x = x.index_select(ax, self.t(idx))
        return x

    def take(self, x, idx, axis):
        """jnp.take with in-range (already wrapped) indices."""
        x, idx = self.t(x), self.t(idx).to(torch.int64)
        axis %= x.ndim
        out = x.index_select(axis, idx.reshape(-1))
        return out.reshape(x.shape[:axis] + idx.shape + x.shape[axis + 1:])


_UNARY = {
    "tanh": torch.tanh, "exp": torch.exp, "log": torch.log, "sqrt": torch.sqrt,
    "abs": torch.abs, "floor": torch.floor, "ceil": torch.ceil,
    "round": torch.round, "sin": torch.sin, "cos": torch.cos, "tan": torch.tan,
    "sign": torch.sign, "isnan": torch.isnan, "isinf": torch.isinf,
    "sinh": torch.sinh, "cosh": torch.cosh, "arcsin": torch.asin,
    "arccos": torch.acos, "arctan": torch.atan, "arcsinh": torch.asinh,
    "arccosh": torch.acosh, "arctanh": torch.atanh, "square": torch.square,
}


@dataclasses.dataclass
class Ctx:
    xp: Any  # np (static eval) or a TX (device)
    attrs: dict[str, Any]
    node: OnnxNode
    env: dict | None = None  # enclosing scope (If/Loop subgraph capture)

    def attr(self, name: str, default=None):
        return self.attrs.get(name, default)

    @property
    def tx(self) -> TX:
        return self.xp if isinstance(self.xp, TX) else self.env["__tx__"]

    def t(self, v):
        """``jnp.asarray``: a device tensor."""
        return self.tx.t(v)

    def static(self, v, what: str) -> np.ndarray:
        """Require a host value (shape/axes/pads operand)."""
        if v is None:
            raise ValueError(f"{self.node.op_type} '{self.node.name}': "
                             f"missing required static input ({what})")
        if not _is_static(v):
            raise UnsupportedOp(
                f"{self.node.op_type} '{self.node.name}': {what} is a device "
                f"tensor; data-dependent shapes cannot be captured")
        return np.asarray(v)


_REGISTRY: dict[str, Callable] = {}


def op(name: str, *, static_ok: bool = False):
    def deco(fn):
        fn.static_ok = static_ok
        _REGISTRY[name] = fn
        return fn
    return deco


# ---------------------------------------------------------------------------
# elementwise / unary
# ---------------------------------------------------------------------------

def _simple(name: str, fn, *, static_ok: bool = False):
    @op(name, static_ok=static_ok)
    def h(ctx: Ctx, *ins):
        return fn(ctx, *ins)
    h.__name__ = f"op_{name.lower()}"
    return h


_simple("Identity", lambda c, x: x, static_ok=True)
_simple("Relu", lambda c, x: c.xp.maximum(x, 0))
_simple("Sigmoid", lambda c, x: torch.sigmoid(c.t(x)))
_simple("Tanh", lambda c, x: c.xp.tanh(x))
_simple("Exp", lambda c, x: c.xp.exp(x))
_simple("Log", lambda c, x: c.xp.log(x))
_simple("Sqrt", lambda c, x: c.xp.sqrt(x))
_simple("Reciprocal", lambda c, x: torch.reciprocal(c.t(x)))
_simple("Neg", lambda c, x: -x if c.xp is np else -c.t(x), static_ok=True)
_simple("Abs", lambda c, x: c.xp.abs(x), static_ok=True)
_simple("Floor", lambda c, x: c.xp.floor(x), static_ok=True)
_simple("Ceil", lambda c, x: c.xp.ceil(x), static_ok=True)
_simple("Round", lambda c, x: c.xp.round(x))
_simple("Sin", lambda c, x: c.xp.sin(x))
_simple("Cos", lambda c, x: c.xp.cos(x))
_simple("Tan", lambda c, x: c.xp.tan(x))
_simple("Erf", lambda c, x: torch.erf(c.t(x)))
_simple("Sign", lambda c, x: c.xp.sign(x))
_simple("Softplus", lambda c, x: F.softplus(c.t(x)))
_simple("Softsign", lambda c, x: c.t(x) / (1 + torch.abs(c.t(x))))
_simple("Not", lambda c, x: c.xp.logical_not(x), static_ok=True)
_simple("IsNaN", lambda c, x: c.xp.isnan(x))


@op("IsInf")
def op_isinf(ctx: Ctx, x):
    neg = ctx.attr("detect_negative", 1)
    pos = ctx.attr("detect_positive", 1)
    if neg and pos:
        return ctx.xp.isinf(x)
    if pos:
        return ctx.xp.isposinf(x)
    if neg:
        return ctx.xp.isneginf(x)
    return ctx.xp.zeros_like(x, dtype=bool)


_simple("Sinh", lambda c, x: c.xp.sinh(x))
_simple("Cosh", lambda c, x: c.xp.cosh(x))
_simple("Asin", lambda c, x: c.xp.arcsin(x))
_simple("Acos", lambda c, x: c.xp.arccos(x))
_simple("Atan", lambda c, x: c.xp.arctan(x))
_simple("Asinh", lambda c, x: c.xp.arcsinh(x))
_simple("Acosh", lambda c, x: c.xp.arccosh(x))
_simple("Atanh", lambda c, x: c.xp.arctanh(x))
_simple("Mish", lambda c, x: c.t(x) * torch.tanh(F.softplus(c.t(x))))
_simple("HardSwish", lambda c, x: c.t(x) * torch.clamp(c.t(x) / 6.0 + 0.5, 0, 1))


@op("Gelu")
def op_gelu(ctx: Ctx, x):
    approx = ctx.attr("approximate", "none")
    return F.gelu(ctx.t(x), approximate="tanh" if approx == "tanh" else "none")


@op("LeakyRelu")
def op_leakyrelu(ctx: Ctx, x):
    x = ctx.t(x)
    return torch.where(x >= 0, x, ctx.attr("alpha", 0.01) * x)


@op("Elu")
def op_elu(ctx: Ctx, x):
    x = ctx.t(x)
    return torch.where(x >= 0, x, ctx.attr("alpha", 1.0) * (torch.exp(x) - 1))


@op("HardSigmoid")
def op_hardsigmoid(ctx: Ctx, x):
    a, b = ctx.attr("alpha", 0.2), ctx.attr("beta", 0.5)
    return torch.clamp(a * ctx.t(x) + b, 0, 1)


@op("PRelu")
def op_prelu(ctx: Ctx, x, slope):
    x = ctx.t(x)
    return ctx.tx.where(x >= 0, x, ctx.tx.multiply(slope, x))


@op("Selu")
def op_selu(ctx: Ctx, x):
    # ONNX defaults (exact f32 literals from the spec)
    alpha = ctx.attr("alpha", 1.6732631921768188)
    gamma = ctx.attr("gamma", 1.0507010221481323)
    x = ctx.t(x)
    return gamma * torch.where(x > 0, x, alpha * (torch.exp(x) - 1))


@op("Celu")
def op_celu(ctx: Ctx, x):
    alpha = ctx.attr("alpha", 1.0)
    x = ctx.t(x)
    return torch.clamp(x, min=0) + torch.clamp(alpha * (torch.exp(x / alpha) - 1), max=0.0)


@op("ThresholdedRelu")
def op_thresholdedrelu(ctx: Ctx, x):
    x = ctx.t(x)
    return torch.where(x > ctx.attr("alpha", 1.0), x, 0.0).to(x.dtype)


@op("Shrink")
def op_shrink(ctx: Ctx, x):
    lambd = ctx.attr("lambd", 0.5)
    bias = ctx.attr("bias", 0.0)
    x = ctx.t(x)
    return torch.where(x < -lambd, x + bias,
                       torch.where(x > lambd, x - bias, 0.0)).to(x.dtype)


@op("Clip")
def op_clip(ctx: Ctx, x, lo=None, hi=None):
    if lo is None and "min" in ctx.attrs:
        lo = ctx.attr("min")
    if hi is None and "max" in ctx.attrs:
        hi = ctx.attr("max")
    x = ctx.t(x)
    if lo is not None:
        x = ctx.tx.maximum(x, lo)
    if hi is not None:
        x = ctx.tx.minimum(x, hi)
    return x


# ---------------------------------------------------------------------------
# binary / variadic
# ---------------------------------------------------------------------------

def _store_mixed(ctx: Ctx, y, *ins):
    """bf16-storage policy for binary pointwise arithmetic (Add/Sub/Mul/
    Div), as in the JAX executor: under bf16-storage mode, a device f32
    result with any bf16 floating operand is stored bf16, so the activation
    stream stays bf16 between MatMuls (declared graph outputs and host
    values are exempt)."""
    env = ctx.env or {}
    if (env.get("__bf16_storage__")
            and not _is_static(y)
            and getattr(y, "dtype", None) == torch.float32
            and any(getattr(i, "dtype", None) == torch.bfloat16 for i in ins)
            and ctx.node.outputs
            and ctx.node.outputs[0] not in env.get("__graph_outputs__", ())):
        return y.to(torch.bfloat16)
    return y


_simple("Add", lambda c, a, b: _store_mixed(c, c.xp.add(a, b), a, b), static_ok=True)
_simple("Sub", lambda c, a, b: _store_mixed(c, c.xp.subtract(a, b), a, b), static_ok=True)
_simple("Mul", lambda c, a, b: _store_mixed(c, c.xp.multiply(a, b), a, b), static_ok=True)
_simple("Pow", lambda c, a, b: c.xp.power(a, b))
_simple("Equal", lambda c, a, b: c.xp.equal(a, b), static_ok=True)
_simple("Greater", lambda c, a, b: c.xp.greater(a, b), static_ok=True)
_simple("GreaterOrEqual", lambda c, a, b: c.xp.greater_equal(a, b), static_ok=True)
_simple("Less", lambda c, a, b: c.xp.less(a, b), static_ok=True)
_simple("LessOrEqual", lambda c, a, b: c.xp.less_equal(a, b), static_ok=True)
_simple("And", lambda c, a, b: c.xp.logical_and(a, b), static_ok=True)
_simple("Or", lambda c, a, b: c.xp.logical_or(a, b), static_ok=True)
_simple("Xor", lambda c, a, b: c.xp.logical_xor(a, b), static_ok=True)
_simple("Where", lambda c, cond, a, b: c.xp.where(cond, a, b), static_ok=True)


@op("Div", static_ok=True)
def op_div(ctx: Ctx, a, b):
    # ONNX integer Div truncates toward zero (not floor)
    if _is_int(a) and _is_int(b):
        if ctx.xp is np:
            return (np.abs(a) // np.abs(b)) * np.sign(a) * np.sign(b)
        return torch.div(*ctx.tx.pair(a, b), rounding_mode="trunc")
    return _store_mixed(ctx, ctx.xp.divide(a, b), a, b)


@op("Mod", static_ok=True)
def op_mod(ctx: Ctx, a, b):
    if ctx.attr("fmod", 0):
        return ctx.xp.fmod(a, b)
    return ctx.xp.mod(a, b)


@op("Min", static_ok=True)
def op_min(ctx: Ctx, *ins):
    out = ins[0]
    for v in ins[1:]:
        out = ctx.xp.minimum(out, v)
    return out


@op("Max", static_ok=True)
def op_max(ctx: Ctx, *ins):
    out = ins[0]
    for v in ins[1:]:
        out = ctx.xp.maximum(out, v)
    return out


@op("Sum", static_ok=True)
def op_sum(ctx: Ctx, *ins):
    out = ins[0]
    for v in ins[1:]:
        out = ctx.xp.add(out, v)
    return out


@op("Mean")
def op_mean(ctx: Ctx, *ins):
    out = ctx.t(ins[0])
    for v in ins[1:]:
        out = ctx.tx.add(out, v)
    return out / len(ins)


# ---------------------------------------------------------------------------
# reductions
# ---------------------------------------------------------------------------

def _acc_upcast(ctx: Ctx, x):
    """f32-accumulation policy for reductions and normalizations: a bf16
    input is upcast to f32 and the result goes back to bf16. Returns
    ``(x_f32, restore_dtype)``."""
    if getattr(x, "dtype", None) != torch.bfloat16:
        return x, None
    return x.float(), torch.bfloat16


def _reduce(fn_name: str):
    def body(ctx: Ctx, x, axes, keep):
        xp = ctx.xp
        if axes is None:
            if ctx.attr("noop_with_empty_axes", 0):
                return x
            axes_t = None
        else:
            axes_t = tuple(int(a) for a in (axes if isinstance(axes, list)
                                            else [axes]))
        red = {
            "ReduceMean": xp.mean, "ReduceSum": xp.sum,
            "ReduceMax": xp.max, "ReduceMin": xp.min,
            "ReduceProd": xp.prod,
        }
        if fn_name == "ReduceL1":
            return xp.sum(xp.abs(x), axis=axes_t, keepdims=keep)
        if fn_name == "ReduceL2":
            return xp.sqrt(xp.sum(xp.square(x), axis=axes_t, keepdims=keep))
        if fn_name == "ReduceSumSquare":
            return xp.sum(xp.square(x), axis=axes_t, keepdims=keep)
        if fn_name == "ReduceLogSum":
            return xp.log(xp.sum(x, axis=axes_t, keepdims=keep))
        if fn_name == "ReduceLogSumExp":
            if xp is np:
                m = np.max(x, axis=axes_t, keepdims=True)
                s = np.log(np.sum(np.exp(x - m), axis=axes_t, keepdims=True)) + m
                return s if keep else np.squeeze(s, axis=axes_t)
            x = ctx.t(x)
            dims = tuple(range(x.ndim)) if axes_t is None else tuple(a % x.ndim for a in axes_t)
            if not dims:
                return x
            return torch.logsumexp(x, dim=dims, keepdim=keep)
        return red[fn_name](x, axis=axes_t, keepdims=keep)

    @op(fn_name, static_ok=True)
    def h(ctx: Ctx, x, axes_in=None):
        axes = ctx.attr("axes")
        if axes_in is not None:
            axes = [int(a) for a in ctx.static(axes_in, "axes").ravel()]
        keep = bool(ctx.attr("keepdims", 1))
        x, odt = _acc_upcast(ctx, x)
        res = body(ctx, x, axes, keep)
        return res.to(odt) if odt is not None else res
    h.__name__ = f"op_{fn_name.lower()}"
    return h


for _r in ("ReduceMean", "ReduceSum", "ReduceMax", "ReduceMin",
           "ReduceProd", "ReduceL1", "ReduceL2", "ReduceSumSquare",
           "ReduceLogSum", "ReduceLogSumExp"):
    _reduce(_r)


@op("ArgMax")
def op_argmax(ctx: Ctx, x):
    axis = ctx.attr("axis", 0)
    return torch.argmax(ctx.t(x), dim=axis, keepdim=bool(ctx.attr("keepdims", 1)))


@op("ArgMin")
def op_argmin(ctx: Ctx, x):
    axis = ctx.attr("axis", 0)
    return torch.argmin(ctx.t(x), dim=axis, keepdim=bool(ctx.attr("keepdims", 1)))


@op("CumSum")
def op_cumsum(ctx: Ctx, x, axis):
    ax = int(ctx.static(axis, "axis"))
    x = ctx.t(x)
    ax %= x.ndim
    if ctx.attr("reverse", 0):
        x = torch.flip(x, dims=(ax,))
    out = torch.cumsum(x, dim=ax)
    if ctx.attr("exclusive", 0):
        # shift the inclusive sum right by one, zero first (no subtraction)
        pad = [0, 0] * (x.ndim - 1 - ax) + [1, 0]
        out = F.pad(out, pad).narrow(ax, 0, x.shape[ax])
    if ctx.attr("reverse", 0):
        out = torch.flip(out, dims=(ax,))
    return out


# ---------------------------------------------------------------------------
# shape / layout
# ---------------------------------------------------------------------------

@op("Shape", static_ok=True)
def op_shape(ctx: Ctx, x):
    shape = np.asarray(tuple(x.shape), np.int64)
    start = ctx.attr("start", 0)
    end = ctx.attr("end")
    return shape[start:end] if end is not None else shape[start:]


@op("Size", static_ok=True)
def op_size(ctx: Ctx, x):
    return np.asarray(math.prod(x.shape), np.int64)


@op("Reshape", static_ok=True)
def op_reshape(ctx: Ctx, x, shape):
    tgt = [int(v) for v in ctx.static(shape, "shape").ravel()]
    allowzero = ctx.attr("allowzero", 0)
    out = []
    for i, d in enumerate(tgt):
        if d == 0 and not allowzero:
            out.append(x.shape[i])
        else:
            out.append(d)
    return ctx.xp.reshape(x, tuple(out))


@op("Flatten", static_ok=True)
def op_flatten(ctx: Ctx, x):
    axis = ctx.attr("axis", 1)
    if axis < 0:
        axis += x.ndim
    lead = math.prod(x.shape[:axis]) if axis else 1
    return ctx.xp.reshape(x, (lead, -1))


@op("Transpose", static_ok=True)
def op_transpose(ctx: Ctx, x):
    perm = ctx.attr("perm")
    return ctx.xp.transpose(x, perm if perm is None else tuple(perm))


@op("Squeeze", static_ok=True)
def op_squeeze(ctx: Ctx, x, axes_in=None):
    axes = ctx.attr("axes")
    if axes_in is not None:
        axes = [int(a) for a in ctx.static(axes_in, "axes").ravel()]
    if axes is None:
        return ctx.xp.squeeze(x)
    if isinstance(axes, int):
        axes = [axes]
    return ctx.xp.squeeze(x, axis=tuple(int(a) for a in axes))


@op("Unsqueeze", static_ok=True)
def op_unsqueeze(ctx: Ctx, x, axes_in=None):
    axes = ctx.attr("axes")
    if axes_in is not None:
        axes = [int(a) for a in ctx.static(axes_in, "axes").ravel()]
    if isinstance(axes, int):
        axes = [axes]
    out_nd = x.ndim + len(axes)
    axes = sorted(a + out_nd if a < 0 else a for a in axes)
    out = x
    for a in axes:
        out = ctx.xp.expand_dims(out, a)
    return out


@op("Concat", static_ok=True)
def op_concat(ctx: Ctx, *ins):
    return ctx.xp.concatenate(ins, axis=ctx.attr("axis", 0))


@op("Split", static_ok=True)
def op_split(ctx: Ctx, x, split_in=None):
    axis = ctx.attr("axis", 0)
    split = ctx.attr("split")
    if split_in is not None:
        split = [int(s) for s in ctx.static(split_in, "split").ravel()]
    n_out = len(ctx.node.outputs)
    dim = x.shape[axis]
    if split is None:
        base = -(-dim // n_out)
        split = [base] * (n_out - 1) + [dim - base * (n_out - 1)]
    idx = np.cumsum(split)[:-1]
    return tuple(ctx.xp.split(x, idx, axis=axis))


def _take_slices(x, sl):
    """``x[tuple(sl)]`` for a tensor: torch slices take no negative step, so
    such an axis is flipped and sliced forward."""
    out = x
    for ax, s in enumerate(sl):
        if s.step is None or s.step > 0:
            continue
        n = out.shape[ax]
        st, en, sp = s.start, s.stop, -s.step
        out = torch.flip(out, dims=(ax,))
        sl[ax] = slice(n - 1 - st, n if en is None else n - 1 - en, sp)
    return out[tuple(sl)]


@op("Slice", static_ok=True)
def op_slice(ctx: Ctx, x, starts=None, ends=None, axes=None, steps=None):
    if starts is None:  # opset-1 attribute form
        starts = np.asarray(ctx.attr("starts"), np.int64)
        ends = np.asarray(ctx.attr("ends"), np.int64)
        axes = (np.asarray(ctx.attr("axes"), np.int64)
                if ctx.attr("axes") is not None else None)
        steps = None
    else:
        starts = ctx.static(starts, "starts")
        ends = ctx.static(ends, "ends")
        axes = None if axes is None else ctx.static(axes, "axes")
        steps = None if steps is None else ctx.static(steps, "steps")
    starts = np.atleast_1d(starts).astype(np.int64)
    ends = np.atleast_1d(ends).astype(np.int64)
    n = len(starts)
    axes = (np.arange(n, dtype=np.int64) if axes is None
            else np.atleast_1d(axes).astype(np.int64))
    steps = (np.ones(n, np.int64) if steps is None
             else np.atleast_1d(steps).astype(np.int64))
    sl = [slice(None)] * x.ndim
    for st, en, ax, sp in zip(starts, ends, axes, steps):
        ax = int(ax) + (x.ndim if ax < 0 else 0)
        dim = x.shape[ax]
        st, en, sp = int(st), int(en), int(sp)
        # ONNX clamps out-of-range starts/ends (INT_MAX conventions)
        if sp > 0:
            st = min(max(st + dim if st < 0 else st, 0), dim)
            en = min(max(en + dim if en < 0 else en, 0), dim)
            sl[ax] = slice(st, en, sp)
        else:
            st = min(max(st + dim if st < 0 else st, 0), dim - 1)
            en = min(en + dim if en < 0 else en, dim - 1)
            # per spec ends clamp to [-1, dim-1]; anything below 0 after
            # wrapping means "run through index 0" (python stop=None)
            sl[ax] = slice(st, en if en >= 0 else None, sp)
    if ctx.xp is np:
        return x[tuple(sl)]
    return _take_slices(ctx.t(x), sl)


@op("Gather", static_ok=True)
def op_gather(ctx: Ctx, x, indices):
    axis = ctx.attr("axis", 0)
    if ctx.xp is np:
        return np.take(x, np.asarray(indices), axis=axis)
    x = ctx.t(x)
    dim = x.shape[axis]
    if _is_static(indices):
        idx = np.asarray(indices).astype(np.int64)
        idx = ctx.t(np.where(idx < 0, idx + dim, idx))
    else:
        idx = indices.to(torch.int64)
        idx = torch.where(idx < 0, idx + dim, idx)
    return ctx.tx.take(x, idx, axis)


@op("GatherElements")
def op_gatherelements(ctx: Ctx, x, indices):
    axis = ctx.attr("axis", 0)
    x = ctx.t(x)
    idx = ctx.t(indices).to(torch.int64)
    idx = torch.where(idx < 0, idx + x.shape[axis], idx)
    return torch.gather(x, axis % x.ndim, idx)


@op("Expand", static_ok=True)
def op_expand(ctx: Ctx, x, shape):
    tgt = tuple(int(v) for v in ctx.static(shape, "shape").ravel())
    out_shape = np.broadcast_shapes(tuple(x.shape), tgt)
    return ctx.xp.broadcast_to(x, out_shape)


@op("Tile", static_ok=True)
def op_tile(ctx: Ctx, x, repeats):
    reps = tuple(int(v) for v in ctx.static(repeats, "repeats").ravel())
    return ctx.xp.tile(x, reps)


@op("Pad", static_ok=True)
def op_pad(ctx: Ctx, x, pads=None, cval=None, axes=None):
    mode = ctx.attr("mode", "constant")
    if pads is None:
        pads = np.asarray(ctx.attr("pads"), np.int64)
    else:
        pads = ctx.static(pads, "pads").astype(np.int64)
    if axes is not None:
        ax = [int(a) % x.ndim for a in ctx.static(axes, "axes").ravel()]
    else:
        ax = list(range(x.ndim))
    n = len(ax)
    width = [(0, 0)] * x.ndim
    for i, a in enumerate(ax):
        width[a] = (int(pads[i]), int(pads[i + n]))
    if any(lo < 0 or hi < 0 for lo, hi in width):
        # ONNX allows negative pads (cropping): crop first, pad the rest; a
        # crop beyond the dimension is a geometry bug
        for d, (lo, hi) in enumerate(width):
            if max(0, -lo) + max(0, -hi) > x.shape[d]:
                raise ValueError(
                    f"Pad: negative pads ({lo}, {hi}) crop more than "
                    f"dim {d} extent {x.shape[d]}")
        sl = tuple(
            slice(max(0, -lo), x.shape[d] - max(0, -hi))
            for d, (lo, hi) in enumerate(width)
        )
        x = x[sl]
        width = [(max(0, lo), max(0, hi)) for lo, hi in width]
    if mode == "constant":
        c = 0 if cval is None else np.asarray(cval).item() if _is_static(cval) else cval
        if ctx.xp is np:
            return np.pad(x, width, mode="constant", constant_values=c)
        return ctx.xp.pad(x, width, mode="constant", constant_values=c)
    return ctx.xp.pad(x, width, mode={"reflect": "reflect", "edge": "edge",
                                      "wrap": "wrap"}[mode])


@op("Trilu")
def op_trilu(ctx: Ctx, x, k=None):
    kk = 0 if k is None else int(ctx.static(k, "k"))
    x = ctx.t(x)
    return torch.triu(x, kk) if ctx.attr("upper", 1) else torch.tril(x, kk)


@op("DepthToSpace")
def op_depthtospace(ctx: Ctx, x):
    b = ctx.attr("blocksize")
    mode = ctx.attr("mode", "DCR")
    x = ctx.t(x)
    n, c, h, w = x.shape
    if mode == "DCR":
        y = x.reshape(n, b, b, c // (b * b), h, w).permute(0, 3, 4, 1, 5, 2)
    else:  # CRD
        y = x.reshape(n, c // (b * b), b, b, h, w).permute(0, 1, 4, 2, 5, 3)
    return y.reshape(n, c // (b * b), h * b, w * b)


@op("SpaceToDepth")
def op_spacetodepth(ctx: Ctx, x):
    b = ctx.attr("blocksize")
    x = ctx.t(x)
    n, c, h, w = x.shape
    y = x.reshape(n, c, h // b, b, w // b, b).permute(0, 3, 5, 1, 2, 4)
    return y.reshape(n, c * b * b, h // b, w // b)


@op("Upsample", static_ok=True)
def op_upsample(ctx: Ctx, x, scales=None):
    # deprecated opset-7/9 alias of Resize (mode nearest|linear, asymmetric
    # coordinates per its spec); scales via attr (opset 7) or input (opset 9)
    node = dataclasses.replace(
        ctx.node, op_type="Resize",
        attrs={"mode": ctx.attr("mode", "nearest"),
               "coordinate_transformation_mode": "asymmetric",
               "nearest_mode": "floor"},
    )
    sc = (np.asarray(ctx.attr("scales"), np.float32) if scales is None
          else ctx.static(scales, "scales"))
    return _REGISTRY["Resize"](
        Ctx(ctx.xp, node.attrs, node, ctx.env), x, None, sc, None)


# ---------------------------------------------------------------------------
# constants / generators / casts
# ---------------------------------------------------------------------------

@op("Constant", static_ok=True)
def op_constant(ctx: Ctx):
    a = ctx.attrs
    if "value" in a:
        return np.asarray(a["value"].data)
    if "value_float" in a:
        return np.asarray(a["value_float"], np.float32)
    if "value_int" in a:
        return np.asarray(a["value_int"], np.int64)
    if "value_floats" in a:
        return np.asarray(a["value_floats"], np.float32)
    if "value_ints" in a:
        return np.asarray(a["value_ints"], np.int64)
    raise UnsupportedOp("Constant: unsupported value attribute")


@op("ConstantOfShape", static_ok=True)
def op_constantofshape(ctx: Ctx, shape):
    tgt = tuple(int(v) for v in ctx.static(shape, "shape").ravel())
    val = ctx.attr("value")
    if val is None:
        return np.zeros(tgt, np.float32)
    arr = np.asarray(val.data)
    return np.full(tgt, arr.ravel()[0], arr.dtype)


@op("Range", static_ok=True)
def op_range(ctx: Ctx, start, limit, delta):
    s = ctx.static(start, "start").item()
    l = ctx.static(limit, "limit").item()
    d = ctx.static(delta, "delta").item()
    return np.arange(s, l, d)


def _cast(x: torch.Tensor, to: torch.dtype) -> torch.Tensor:
    """XLA's conversion: a float cast to an integer type saturates, NaN -> 0."""
    if x.dtype.is_floating_point and not to.is_floating_point and to != torch.bool:
        info = torch.iinfo(to)
        x = torch.nan_to_num(x.double() if to == torch.int64 else x.float(), nan=0.0)
        x = torch.clamp(x, info.min, info.max)
    return x.to(to)


@op("Cast", static_ok=True)
def op_cast(ctx: Ctx, x):
    to = DTYPE_MAP[ctx.attr("to")]
    return x.astype(to) if ctx.xp is np else _cast(ctx.t(x), torch_dtype(to))


@op("CastLike", static_ok=True)
def op_castlike(ctx: Ctx, x, like):
    if ctx.xp is np:
        return x.astype(np.asarray(like).dtype)
    dt = torch_dtype(np.asarray(like).dtype) if _is_static(like) else like.dtype
    return _cast(ctx.t(x), dt)


@op("OneHot")
def op_onehot(ctx: Ctx, indices, depth, values):
    d = int(ctx.static(depth, "depth"))
    vals = ctx.static(values, "values")  # [off, on]
    axis = ctx.attr("axis", -1)
    idx = ctx.t(indices)
    # jax.nn.one_hot: a negative or out-of-range index matches no class
    oh = (idx[..., None] == torch.arange(d, device=idx.device)).float()
    if axis != -1:
        oh = torch.movedim(oh, -1, axis % oh.ndim)
    tx = ctx.tx
    return tx.add(tx.multiply(oh, vals[1] - vals[0]), vals[0])


@op("EyeLike", static_ok=True)
def op_eyelike(ctx: Ctx, x):
    dt = DTYPE_MAP.get(ctx.attr("dtype"))
    if dt is None:
        dt = np.asarray(x).dtype if _is_static(x) else np_dtype(x.dtype)
    return np.eye(x.shape[0], x.shape[1], k=ctx.attr("k", 0), dtype=dt)


# ---------------------------------------------------------------------------
# linear algebra / NN
# ---------------------------------------------------------------------------

def _store_act(ctx: Ctx, y):
    """Activation-storage policy for MatMul/Gemm/Conv/ConvTranspose: under
    bf16-storage mode their f32 outputs are stored bfloat16, except
    declared graph outputs."""
    env = ctx.env or {}
    if (env.get("__bf16_storage__")
            and getattr(y, "dtype", None) == torch.float32
            and ctx.node.outputs
            and ctx.node.outputs[0] not in env.get("__graph_outputs__", ())):
        return y.to(torch.bfloat16)
    return y


def _matmul(tx: TX, a, b):
    return torch.matmul(*tx.pair(a, b))


@op("MatMul")
def op_matmul(ctx: Ctx, a, b):
    return _store_act(ctx, _matmul(ctx.tx, a, b))


@op("Gemm")
def op_gemm(ctx: Ctx, a, b, c=None):
    alpha = ctx.attr("alpha", 1.0)
    beta = ctx.attr("beta", 1.0)
    a, b = ctx.t(a), ctx.t(b)
    a = a.T if ctx.attr("transA", 0) else a
    b = b.T if ctx.attr("transB", 0) else b
    y = alpha * _matmul(ctx.tx, a, b)
    if c is not None:
        y = ctx.tx.add(y, beta * ctx.t(c))
    return _store_act(ctx, y)


@op("Einsum")
def op_einsum(ctx: Ctx, *ins):
    ts = [ctx.t(i) for i in ins]
    dt = ts[0].dtype
    for t in ts[1:]:
        dt = torch.promote_types(dt, t.dtype)
    return torch.einsum(ctx.attr("equation"), *[t.to(dt) for t in ts])


def _softmax_like(ctx: Ctx, x, fn):
    x = ctx.t(x)
    out_dt = x.dtype
    if x.dtype == torch.bfloat16:  # bf16-storage mode: the exp-sum reduction
        x = x.float()              # accumulates in f32 (stored back bf16)
    opset = (ctx.env or {}).get("__opset__")
    if opset is not None and opset < 13:
        # opset < 13: softmax over the FLATTENED trailing dims from `axis`
        # (default 1), not a single axis
        axis = ctx.attr("axis", 1) % x.ndim
        lead = x.shape[:axis]
        flat = x.reshape(int(np.prod(lead, dtype=np.int64)), -1)
        return fn(flat, dim=-1).reshape(x.shape).to(out_dt)
    return fn(x, dim=ctx.attr("axis", -1)).to(out_dt)


@op("Softmax")
def op_softmax(ctx: Ctx, x):
    return _softmax_like(ctx, x, torch.softmax)


@op("LogSoftmax")
def op_logsoftmax(ctx: Ctx, x):
    return _softmax_like(ctx, x, torch.log_softmax)


@op("LayerNormalization")
def op_layernorm(ctx: Ctx, x, scale, bias=None):
    tx = ctx.tx
    axis = ctx.attr("axis", -1)
    eps = ctx.attr("epsilon", 1e-5)
    x = ctx.t(x)
    if axis < 0:
        axis += x.ndim
    axes = tuple(range(axis, x.ndim))
    x, odt = _acc_upcast(ctx, x)  # stats in f32
    mean = torch.mean(x, dim=axes, keepdim=True)
    var = torch.mean(torch.square(x - mean), dim=axes, keepdim=True)
    inv = 1.0 / torch.sqrt(var + eps)
    y = tx.multiply((x - mean) * inv, scale)
    if bias is not None:
        y = tx.add(y, bias)
    if odt is not None:
        y = y.to(odt)
    outs = ctx.node.outputs
    if len(outs) == 1:
        return y
    return (y, mean, inv)[: len(outs)]


@op("InstanceNormalization")
def op_instancenorm(ctx: Ctx, x, scale, bias):
    tx = ctx.tx
    eps = ctx.attr("epsilon", 1e-5)
    x, odt = _acc_upcast(ctx, ctx.t(x))  # stats in f32
    axes = tuple(range(2, x.ndim))
    mean = torch.mean(x, dim=axes, keepdim=True)
    var = torch.mean(torch.square(x - mean), dim=axes, keepdim=True)
    shape = (1, -1) + (1,) * (x.ndim - 2)
    y = tx.add(tx.multiply((x - mean) / torch.sqrt(var + eps), ctx.t(scale).reshape(shape)),
               ctx.t(bias).reshape(shape))
    return y.to(odt) if odt is not None else y


@op("GroupNormalization")
def op_groupnorm(ctx: Ctx, x, scale, bias):
    tx = ctx.tx
    eps = ctx.attr("epsilon", 1e-5)
    g = ctx.attr("num_groups")
    x, odt = _acc_upcast(ctx, ctx.t(x))  # stats in f32
    n, c = x.shape[:2]
    sp = tuple(x.shape[2:])
    y = x.reshape((n, g, c // g) + sp)
    axes = tuple(range(2, y.ndim))
    mean = torch.mean(y, dim=axes, keepdim=True)
    var = torch.mean(torch.square(y - mean), dim=axes, keepdim=True)
    y = ((y - mean) / torch.sqrt(var + eps)).reshape(x.shape)
    shape = (1, -1) + (1,) * (x.ndim - 2)
    # opset-18 semantics: scale/bias are per-channel [C]
    y = tx.add(tx.multiply(y, ctx.t(scale).reshape(shape)), ctx.t(bias).reshape(shape))
    return y.to(odt) if odt is not None else y


@op("LpNormalization")
def op_lpnorm(ctx: Ctx, x):
    axis = ctx.attr("axis", -1)
    p = ctx.attr("p", 2)
    x = ctx.t(x)
    if p == 1:
        norm = torch.sum(torch.abs(x), dim=axis, keepdim=True)
    elif p == 2:
        norm = torch.sqrt(torch.sum(torch.square(x), dim=axis, keepdim=True))
    else:
        raise UnsupportedOp(f"LpNormalization p={p}")
    return x / norm


@op("MeanVarianceNormalization")
def op_mvn(ctx: Ctx, x):
    axes = tuple(ctx.attr("axes", [0, 2, 3]))
    x, odt = _acc_upcast(ctx, ctx.t(x))  # stats in f32
    mean = torch.mean(x, dim=axes, keepdim=True)
    var = torch.mean(torch.square(x), dim=axes, keepdim=True) - torch.square(mean)
    y = (x - mean) / torch.sqrt(var + 1e-9)
    return y.to(odt) if odt is not None else y


@op("BatchNormalization")
def op_batchnorm(ctx: Ctx, x, scale, bias, mean, var):
    tx = ctx.tx
    eps = ctx.attr("epsilon", 1e-5)
    x = ctx.t(x)
    shape = (1, -1) + (1,) * (x.ndim - 2)
    r = lambda v: ctx.t(v).reshape(shape)  # noqa: E731
    y = tx.divide(tx.subtract(x, r(mean)), torch.sqrt(r(var) + eps))
    return tx.add(tx.multiply(y, r(scale)), r(bias))


@op("Dropout")
def op_dropout(ctx: Ctx, x, ratio=None, training=None):
    outs = ctx.node.outputs
    if len(outs) == 1:
        return x
    x = ctx.t(x)
    return x, torch.ones(x.shape, dtype=torch.bool, device=x.device)


def _window_pads(ctx: Ctx, in_shape, k, strides, dils) -> list[tuple[int, int]]:
    """Per-spatial-dim (lo, hi) padding honoring auto_pad (shared by Conv
    and the pooling ops)."""
    nd = len(in_shape) - 2
    auto = ctx.attr("auto_pad", "NOTSET")
    if auto in ("SAME_UPPER", "SAME_LOWER"):
        out = []
        for i in range(nd):
            o = -(-in_shape[2 + i] // strides[i])
            total = max(0, (o - 1) * strides[i]
                        + (k[i] - 1) * dils[i] + 1 - in_shape[2 + i])
            lo = total // 2
            hi = total - lo
            out.append((hi, lo) if auto == "SAME_LOWER" else (lo, hi))
        return out
    if auto == "VALID":
        return [(0, 0)] * nd
    pads = ctx.attr("pads", [0] * (2 * nd))
    if isinstance(pads, int):
        pads = [pads] * (2 * nd)
    return [(pads[i], pads[i + nd]) for i in range(nd)]


def _conv_operands(x, w):
    """Matching operand dtypes: under bf16 activation storage an f32-weight
    conv can receive a bf16 input; it computes with bf16 operands and
    returns f32, as XLA's mixed mode does."""
    if x.dtype == w.dtype:
        return x, w, None
    if torch.bfloat16 in (x.dtype, w.dtype):
        return x.to(torch.bfloat16), w.to(torch.bfloat16), torch.float32
    dt = torch.promote_types(x.dtype, w.dtype)
    return x.to(dt), w.to(dt), None


def _apply_time_mask(ctx: Ctx, y):
    """Bucket-padding halo guard for mask-free conv-stack graphs (the
    reference vocoder runs at batch-max length with no mask input): with a
    ``time_mask`` ([T_latent] f32, 1 = real frame), every Conv/ConvTranspose
    output whose trailing axis is an integer multiple of T_latent is
    re-zeroed on the padded frames, so bucket-padded execution equals
    exact-length execution (see the JAX executor's note on the
    zero-preserving requirement between convs)."""
    m = (ctx.env or {}).get("__time_mask__")
    if m is None or getattr(y, "ndim", 0) != 3:
        return y
    t = int(m.shape[0])
    tp = int(y.shape[-1])
    if tp % t == 0:
        mm = m.to(y.dtype)[:, None].expand(t, tp // t).reshape(-1)
        return y * mm[None, None, :]
    return y


_CONV = {1: F.conv1d, 2: F.conv2d, 3: F.conv3d}
_CONV_T = {1: F.conv_transpose1d, 2: F.conv_transpose2d, 3: F.conv_transpose3d}


def _flat_pads(pads) -> list[int]:
    """[(lo, hi)] per spatial dim -> F.pad's last-dim-first list."""
    return [p for lo_hi in reversed(pads) for p in lo_hi]


def _add_bias(ctx: Ctx, out, b, nd):
    if b is None:
        return out
    return ctx.tx.add(out, ctx.t(b).reshape((1, -1) + (1,) * nd))


@op("Conv")
def op_conv(ctx: Ctx, x, w, b=None):
    x, w = ctx.t(x), ctx.t(w)
    nd = x.ndim - 2
    if nd not in _CONV:
        raise UnsupportedOp(f"Conv: {nd} spatial dims")
    strides = tuple(ctx.attr("strides", [1] * nd))
    dils = tuple(ctx.attr("dilations", [1] * nd))
    group = ctx.attr("group", 1)
    padding = _window_pads(ctx, tuple(x.shape), tuple(w.shape[2:]), strides, dils)
    x2, w2, acc = _conv_operands(x, w)
    if any(lo or hi for lo, hi in padding):
        x2 = F.pad(x2, _flat_pads(padding))
    out = _CONV[nd](x2, w2, None, strides, 0, dils, group)
    if acc is not None:
        out = out.to(acc)
    out = _add_bias(ctx, out, b, nd)
    return _store_act(ctx, _apply_time_mask(ctx, out))


@op("ConvTranspose")
def op_convtranspose(ctx: Ctx, x, w, b=None):
    # w: [C, M/group, *k] (ONNX layout = torch's). The full transposed conv
    # (no pads) is cropped by the pads; output_padding appends frames that
    # receive no input
    x, w = ctx.t(x), ctx.t(w)
    nd = x.ndim - 2
    if nd not in _CONV_T:
        raise UnsupportedOp(f"ConvTranspose: {nd} spatial dims")
    strides = tuple(ctx.attr("strides", [1] * nd))
    dils = tuple(ctx.attr("dilations", [1] * nd))
    group = ctx.attr("group", 1)
    k = tuple(w.shape[2:])
    out_padding = tuple(ctx.attr("output_padding", [0] * nd))
    output_shape = ctx.attr("output_shape")
    auto = ctx.attr("auto_pad", "NOTSET")
    if output_shape is not None:
        pads = []
        for i in range(nd):
            total = (strides[i] * (x.shape[2 + i] - 1) + out_padding[i]
                     + (k[i] - 1) * dils[i] + 1 - output_shape[i])
            lo = total - total // 2 if auto == "SAME_LOWER" else total // 2
            pads.append((lo, total - lo))
    elif auto in ("SAME_UPPER", "SAME_LOWER"):
        pads = []
        for i in range(nd):
            total = max(0, (k[i] - 1) * dils[i] + 1 - strides[i])
            lo = total - total // 2 if auto == "SAME_LOWER" else total // 2
            pads.append((lo, total - lo))
    else:
        p = ctx.attr("pads", [0] * (2 * nd))
        pads = [(p[i], p[i + nd]) for i in range(nd)]
    x2, w2, acc = _conv_operands(x, w)
    out = _CONV_T[nd](x2, w2, None, strides, 0, 0, group, dils)
    if acc is not None:
        out = out.to(acc)
    crop = [(-lo, op_ - hi) for (lo, hi), op_ in zip(pads, out_padding)]
    if any(a or c for a, c in crop):
        out = F.pad(out, _flat_pads(crop))
    out = _add_bias(ctx, out, b, nd)
    return _store_act(ctx, _apply_time_mask(ctx, out))


def _sum_pool(x, k, strides, dils):
    """Window sums (a depthwise conv with a ones kernel)."""
    nd = x.ndim - 2
    n, c = x.shape[:2]
    ones = torch.ones((1, 1) + tuple(k), dtype=x.dtype, device=x.device)
    y = _CONV[nd](x.reshape((n * c, 1) + tuple(x.shape[2:])), ones, None,
                  strides, 0, dils)
    return y.reshape((n, c) + tuple(y.shape[2:]))


def _pool(ctx: Ctx, x, is_avg: bool):
    x = ctx.t(x)
    nd = x.ndim - 2
    if nd not in _CONV:
        raise UnsupportedOp(f"{ctx.node.op_type}: {nd} spatial dims")
    k = tuple(ctx.attr("kernel_shape"))
    strides = tuple(ctx.attr("strides", [1] * nd))
    dils = tuple(ctx.attr("dilations", [1] * nd))
    pads = _window_pads(ctx, tuple(x.shape), k, strides, dils)
    extra = [0] * nd
    if ctx.attr("ceil_mode", 0):
        # extend the hi pad so output dims use ceil instead of floor; the
        # counts divisor (and -inf for max) keeps the extension inert
        for i in range(nd):
            span = x.shape[2 + i] + pads[i][0] + pads[i][1] \
                - dils[i] * (k[i] - 1) - 1
            o_ceil = -(-span // strides[i]) + 1
            # a ceil window may only overhang if it starts inside the
            # (left-padded) input
            if (o_ceil - 1) * strides[i] >= x.shape[2 + i] + pads[i][0]:
                o_ceil -= 1
            need = (o_ceil - 1) * strides[i] + dils[i] * (k[i] - 1) + 1
            extra[i] = max(0, need - (x.shape[2 + i] + pads[i][0]
                                      + pads[i][1]))
    if is_avg and ctx.attr("count_include_pad", 0):
        # explicit pads count in the divisor; the ceil extension does not
        x = F.pad(x, _flat_pads(pads))
        pads = [(0, 0)] * nd
    pads = [(lo, hi + e) for (lo, hi), e in zip(pads, extra)]
    flat = _flat_pads(pads)
    if not is_avg:
        xp = F.pad(x, flat, value=-math.inf) if any(flat) else x
        return {1: F.max_pool1d, 2: F.max_pool2d, 3: F.max_pool3d}[nd](
            xp, k, strides, 0, dils)
    out = _sum_pool(F.pad(x, flat) if any(flat) else x, k, strides, dils)
    ones = torch.ones(x.shape, dtype=x.dtype, device=x.device)
    counts = _sum_pool(F.pad(ones, flat) if any(flat) else ones, k, strides, dils)
    return out / counts


@op("MaxPool")
def op_maxpool(ctx: Ctx, x):
    return _pool(ctx, x, False)


@op("AveragePool")
def op_averagepool(ctx: Ctx, x):
    return _pool(ctx, x, True)


@op("GlobalAveragePool")
def op_globalavgpool(ctx: Ctx, x):
    x = ctx.t(x)
    return torch.mean(x, dim=tuple(range(2, x.ndim)), keepdim=True)


@op("GlobalMaxPool")
def op_globalmaxpool(ctx: Ctx, x):
    x = ctx.t(x)
    return torch.amax(x, dim=tuple(range(2, x.ndim)), keepdim=True)


def _resize_src_coords(out_dim: int, in_dim: int, scale: float,
                       coord: str) -> np.ndarray:
    """ONNX coordinate_transformation_mode -> fractional input coords,
    computed on the host in f32 (as ORT's float math)."""
    xo = np.arange(out_dim, dtype=np.float32)
    s = np.float32(scale)
    if coord == "half_pixel":
        return (xo + np.float32(0.5)) / s - np.float32(0.5)
    if coord == "pytorch_half_pixel":
        if out_dim > 1:
            return (xo + np.float32(0.5)) / s - np.float32(0.5)
        return np.zeros(1, np.float32)
    if coord == "align_corners":
        if out_dim == 1:
            return np.zeros(1, np.float32)
        return xo * np.float32((in_dim - 1) / (out_dim - 1))
    if coord == "asymmetric":
        return xo / s
    raise UnsupportedOp(f"Resize coordinate mode {coord!r}")


def _keys_cubic_weights(in_dim: int, out_dim: int) -> np.ndarray:
    """``jax.image.resize(method="cubic")``'s weight matrix [in, out] for
    one axis: the Keys kernel (a = -0.5), half-pixel centres, antialiased
    when downsampling, normalized per output sample."""
    scale = np.float32(out_dim / in_dim)
    inv = np.float32(1.0) / scale
    kscale = max(inv, np.float32(1.0))
    sample = (np.arange(out_dim, dtype=np.float32) + np.float32(0.5)) * inv - np.float32(0.5)
    x = np.abs(sample[None, :] - np.arange(in_dim, dtype=np.float32)[:, None]) / kscale
    w = ((1.5 * x - 2.5) * x) * x + 1.0
    w = np.where(x >= 1.0, ((-0.5 * x + 2.5) * x - 4.0) * x + 2.0, w)
    w = np.where(x >= 2.0, 0.0, w).astype(np.float32)
    tot = np.sum(w, axis=0, keepdims=True)
    w = np.where(np.abs(tot) > 1000.0 * float(np.finfo(np.float32).eps),
                 w / np.where(tot != 0, tot, 1), 0)
    inside = (sample >= -0.5) & (sample <= in_dim - 0.5)
    return np.where(inside[None, :], w, 0).astype(np.float32)


def _repeat_axis(x, r: int, ax: int):
    """jnp.repeat(x, r, axis=ax) for an integer r."""
    shape = tuple(x.shape)
    y = x.unsqueeze(ax + 1).expand(shape[:ax + 1] + (r,) + shape[ax + 1:])
    return y.reshape(shape[:ax] + (shape[ax] * r,) + shape[ax + 1:])


@op("Resize")
def op_resize(ctx: Ctx, x, roi=None, scales=None, sizes=None):
    mode = ctx.attr("mode", "nearest")
    coord = ctx.attr("coordinate_transformation_mode", "half_pixel")
    nearest_mode = ctx.attr("nearest_mode", "round_prefer_floor")
    if sizes is not None:
        out_shape = tuple(int(v) for v in ctx.static(sizes, "sizes").ravel())
        scale_vals = [out_shape[i] / x.shape[i] for i in range(x.ndim)]
    else:
        scale_vals = [float(s) for s in ctx.static(scales, "scales").ravel()]
        out_shape = tuple(int(math.floor(x.shape[i] * scale_vals[i]))
                          for i in range(x.ndim))
    tx = ctx.tx
    x = ctx.t(x)
    int_scales = all(abs(s - round(s)) < 1e-9 and s >= 1 for s in scale_vals)
    if mode == "nearest" and int_scales and (
            (coord, nearest_mode) in (("asymmetric", "floor"),
                                      ("half_pixel", "round_prefer_floor"))):
        # integer upsample: element repeat is index-exact only for these
        out = x
        for ax, s in enumerate(scale_vals):
            r = round(s)
            if r > 1:
                out = _repeat_axis(out, r, ax)
        return out
    if mode == "cubic":
        if coord != "half_pixel":
            raise UnsupportedOp(f"Resize cubic with coord mode {coord!r}")
        # the JAX executor's approximation: jax.image.resize's Keys kernel
        # (a = -0.5; ORT's default is -0.75), applied axis by axis
        out = x if x.dtype.is_floating_point else x.float()
        for ax in range(x.ndim):
            if out_shape[ax] == x.shape[ax]:
                continue
            wmat = tx.t(_keys_cubic_weights(x.shape[ax], out_shape[ax])).to(out.dtype)
            out = torch.movedim(torch.tensordot(out, wmat, dims=([ax], [0])), -1, ax)
        return out
    # exact per-axis nearest/linear for every ONNX coordinate mode
    out = x
    for ax in range(x.ndim):
        if (out_shape[ax] == out.shape[ax]
                and abs(scale_vals[ax] - 1.0) < 1e-9):
            continue  # identity axis
        src = _resize_src_coords(out_shape[ax], out.shape[ax],
                                 scale_vals[ax], coord)
        in_dim = out.shape[ax]
        if mode == "nearest":
            if nearest_mode == "floor":
                idx = np.floor(src)
            elif nearest_mode == "ceil":
                idx = np.ceil(src)
            elif nearest_mode == "round_prefer_floor":
                idx = np.ceil(src - 0.5)
            else:  # round_prefer_ceil
                idx = np.floor(src + 0.5)
            idx = np.clip(idx, 0, in_dim - 1).astype(np.int64)
            out = tx.take(out, idx, ax)
        elif mode == "linear":
            lo = np.clip(np.floor(src), 0, in_dim - 1).astype(np.int64)
            hi = np.clip(lo + 1, 0, in_dim - 1)
            w = np.clip(src - lo.astype(np.float32), 0.0, 1.0)
            shape = [1] * out.ndim
            shape[ax] = -1
            w_dev = tx.t(w.reshape(shape)).to(out.dtype)
            out = (tx.take(out, lo, ax) * (1 - w_dev)
                   + tx.take(out, hi, ax) * w_dev)
        else:
            raise UnsupportedOp(f"Resize mode {mode!r}")
    return out


# ---------------------------------------------------------------------------
# com.microsoft contrib ops (ORT graph-optimizer output; the registry keys on
# op_type, which is how they appear in optimized graphs)
# ---------------------------------------------------------------------------

def _rms_norm(tx: TX, x, scale, eps):
    x32 = x.float()
    inv = torch.rsqrt(torch.mean(torch.square(x32), dim=-1, keepdim=True) + eps)
    return (x32 * inv * tx.t(scale).float()).to(x.dtype)


@op("SimplifiedLayerNormalization")
def op_simplifiedlayernorm(ctx: Ctx, x, scale):
    # RMSNorm (axis must be the last — the only form ORT emits)
    return _rms_norm(ctx.tx, ctx.t(x), scale, ctx.attr("epsilon", 1e-5))


@op("SkipSimplifiedLayerNormalization")
def op_skipsimplifiedlayernorm(ctx: Ctx, x, skip, scale, bias=None):
    tx = ctx.tx
    s = tx.add(x, skip)
    if bias is not None:
        s = tx.add(s, bias)
    y = _rms_norm(tx, s, scale, ctx.attr("epsilon", 1e-5))
    # outputs: (y, mean?, inv_std_var?, input_skip_bias_sum?)
    return y, None, None, s


def _ln(tx: TX, x, gamma, beta, eps):
    x32 = tx.t(x).float()
    mu = torch.mean(x32, dim=-1, keepdim=True)
    var = torch.mean(torch.square(x32 - mu), dim=-1, keepdim=True)
    y = (x32 - mu) * torch.rsqrt(var + eps)
    y = y * tx.t(gamma).float()
    if beta is not None:
        y = y + tx.t(beta).float()
    return y


@op("SkipLayerNormalization")
def op_skiplayernorm(ctx: Ctx, x, skip, gamma, beta=None, bias=None):
    tx = ctx.tx
    s = tx.add(x, skip)
    if bias is not None:
        s = tx.add(s, bias)
    y = _ln(tx, s, gamma, beta, ctx.attr("epsilon", 1e-5)).to(ctx.t(x).dtype)
    return y, None, None, s


@op("BiasGelu")
def op_biasgelu(ctx: Ctx, x, bias):
    return F.gelu(ctx.tx.add(x, bias))


@op("FastGelu")
def op_fastgelu(ctx: Ctx, x, bias=None):
    x = ctx.t(x)
    if bias is not None:
        x = ctx.tx.add(x, bias)
    return F.gelu(x, approximate="tanh")


@op("QuickGelu")
def op_quickgelu(ctx: Ctx, x):
    alpha = ctx.attr("alpha", 1.702)
    x = ctx.t(x)
    return x * torch.sigmoid(alpha * x)


@op("FusedMatMul")
def op_fusedmatmul(ctx: Ctx, a, b):
    if ctx.attr("transBatchA", 0) or ctx.attr("transBatchB", 0):
        raise UnsupportedOp("FusedMatMul: transBatch* is not supported")
    a, b = ctx.t(a), ctx.t(b)
    if ctx.attr("transA", 0):
        a = a.transpose(-1, -2)
    if ctx.attr("transB", 0):
        b = b.transpose(-1, -2)
    return ctx.attr("alpha", 1.0) * _matmul(ctx.tx, a, b)


@op("FusedConv")
def op_fusedconv(ctx: Ctx, x, w, b=None, z=None):
    """Conv + fused activation (+ optional residual add input z)."""
    out = _REGISTRY["Conv"](ctx, x, w, b)  # same pads/strides attr names
    if z is not None:
        out = ctx.tx.add(out, z)
    act = ctx.attr("activation", "")
    if not act:
        return out
    if act == "Relu":
        return torch.clamp(out, min=0)
    if act == "Tanh":
        return torch.tanh(out)
    if act == "Sigmoid":
        return torch.sigmoid(out)
    if act == "LeakyRelu":
        alpha = (ctx.attr("activation_params") or [0.01])[0]
        return torch.where(out >= 0, out, alpha * out)
    if act == "HardSigmoid":
        p = ctx.attr("activation_params") or [0.2, 0.5]
        return torch.clamp(p[0] * out + p[1], 0, 1)
    raise UnsupportedOp(f"FusedConv: activation {act!r} not supported")


def _mha_core(tx: TX, q, k, v, scale, attention_bias, valid, causal):
    """Heads [B, H, S, Dh]: logits, bias, -1e9 masking, an f32 softmax and
    the product with v, in the JAX op's order (plain torch ops, no SDPA)."""
    logits = torch.matmul(q, k.transpose(-1, -2)) * tx.full((), scale, q.dtype)
    if attention_bias is not None:
        logits = tx.add(logits, attention_bias)
    neg = tx.full((), -1e9, logits.dtype)
    if valid is not None:
        logits = torch.where(valid[:, None, None, :], logits, neg)
    if causal is not None:
        logits = torch.where(causal[None, None], logits, neg)
    probs = torch.softmax(logits.float(), dim=-1).to(v.dtype)
    return torch.matmul(probs, v)


def _key_valid(tx: TX, m, s_kv: int, who: str):
    m = tx.t(m)
    if m.ndim == 1:      # [B] right-side key lengths
        return torch.arange(s_kv, device=m.device)[None, :] < m[:, None]
    if m.ndim == 2:      # [B, S_kv] padding mask (1 = keep)
        return m.to(torch.bool)
    raise UnsupportedOp(f"{who}: mask rank {m.ndim} not supported")


@op("Attention")
def op_attention(ctx: Ctx, x, weight, bias=None, mask_index=None,
                 past=None, attention_bias=None, past_seq_len=None):
    """com.microsoft.Attention, the common encoder subset: packed QKV
    projection + multi-head attention. No past/present KV cache."""
    if past is not None or past_seq_len is not None:
        raise UnsupportedOp("Attention: past KV cache is not supported")
    if ctx.attr("do_rotary", 0):
        raise UnsupportedOp("Attention: do_rotary is not supported")
    n_heads = ctx.attr("num_heads")
    if not n_heads:
        raise UnsupportedOp("Attention: num_heads attribute is required")
    tx = ctx.tx
    weight = ctx.t(weight)
    if ctx.attr("qkv_hidden_sizes") is not None:
        q_sz, k_sz, v_sz = [int(v) for v in ctx.attr("qkv_hidden_sizes")]
    else:
        q_sz = k_sz = v_sz = weight.shape[1] // 3
    x = ctx.t(x)
    b, s, _ = x.shape
    qkv = _matmul(tx, x, weight)
    if bias is not None:
        qkv = tx.add(qkv, bias)
    q = qkv[..., :q_sz]
    k = qkv[..., q_sz:q_sz + k_sz]
    v = qkv[..., q_sz + k_sz:]
    dh = q_sz // n_heads

    def split(t, sz):
        return t.reshape(b, s, n_heads, sz // n_heads).permute(0, 2, 1, 3)

    q, k, v = split(q, q_sz), split(k, k_sz), split(v, v_sz)
    scale = ctx.attr("scale") or 1.0 / math.sqrt(dh)
    valid = None if mask_index is None else _key_valid(tx, mask_index, s, "Attention")
    causal = (torch.tril(torch.ones((s, s), dtype=torch.bool, device=x.device))
              if ctx.attr("unidirectional", 0) else None)
    out = _mha_core(tx, q, k, v, scale, attention_bias, valid, causal)
    return out.permute(0, 2, 1, 3).reshape(b, s, v_sz)


@op("BiasAdd")
def op_biasadd(ctx: Ctx, x, bias, skip=None):
    out = ctx.tx.add(x, bias)
    if skip is not None:
        out = ctx.tx.add(out, skip)
    return out


@op("BiasSplitGelu")
def op_biassplitgelu(ctx: Ctx, x, bias):
    # diffusion-UNet geglu fusion: first half * gelu(second half)
    s = ctx.tx.add(x, bias)
    a, b = torch.chunk(s, 2, dim=-1)
    return a * F.gelu(b)


@op("GroupNorm")
def op_groupnorm_contrib(ctx: Ctx, x, gamma, beta):
    """com.microsoft.GroupNorm: NHWC layout, optional fused swish."""
    groups = ctx.attr("groups")
    eps = ctx.attr("epsilon", 1e-5)
    if ctx.attr("channels_last", 1) == 0:
        raise UnsupportedOp("GroupNorm: channels_last=0 is not emitted by "
                            "the ORT optimizer and is not supported")
    x = ctx.t(x)
    shape = tuple(x.shape)
    c = shape[-1]
    x32 = x.float().reshape(shape[0], -1, groups, c // groups)
    mu = torch.mean(x32, dim=(1, 3), keepdim=True)
    var = torch.mean(torch.square(x32 - mu), dim=(1, 3), keepdim=True)
    y = ((x32 - mu) * torch.rsqrt(var + eps)).reshape(shape)
    y = y * ctx.t(gamma).float() + ctx.t(beta).float()
    if ctx.attr("activation", 0):  # 1 = swish
        y = y * torch.sigmoid(y)
    return y.to(x.dtype)


@op("RotaryEmbedding")
def op_rotaryembedding(ctx: Ctx, x, pos_ids, cos_cache, sin_cache):
    """com.microsoft.RotaryEmbedding: rotate the head dim of x [B,S,H] or
    [B,N,S,Dh] using cached cos/sin tables indexed by position ids."""
    if ctx.attr("is_packed_batching", 0):
        raise UnsupportedOp("RotaryEmbedding: packed batching not supported")
    tx = ctx.tx
    x = ctx.t(x)
    squeeze_heads = False
    if x.ndim == 3:
        n_heads = ctx.attr("num_heads", 1) or 1
        b, s, h = x.shape
        x4 = x.reshape(b, s, n_heads, h // n_heads).permute(0, 2, 1, 3)
        squeeze_heads = True
    else:
        x4 = x
        b, _n, s, _dh = x4.shape
    pos = ctx.t(pos_ids).to(torch.int64)
    if pos.ndim == 1:
        pos = torch.broadcast_to(pos[:, None], (b, s))
    cos = tx.take(cos_cache, pos, 0)[:, None]  # [B, 1, S, Dh/2]
    sin = tx.take(sin_cache, pos, 0)[:, None]
    half = x4.shape[-1] // 2
    if ctx.attr("interleaved", 0):
        x_even = x4[..., 0::2]
        x_odd = x4[..., 1::2]
        r_even = tx.subtract(tx.multiply(x_even, cos), tx.multiply(x_odd, sin))
        r_odd = tx.add(tx.multiply(x_even, sin), tx.multiply(x_odd, cos))
        out = torch.stack([r_even, r_odd], dim=-1).reshape(x4.shape)
    else:
        x1, x2 = x4[..., :half], x4[..., half:]
        out = torch.cat([tx.subtract(tx.multiply(x1, cos), tx.multiply(x2, sin)),
                         tx.add(tx.multiply(x1, sin), tx.multiply(x2, cos))], dim=-1)
    if squeeze_heads:
        out = out.permute(0, 2, 1, 3).reshape(x.shape)
    return out.to(x.dtype)


@op("EmbedLayerNormalization")
def op_embedlayernorm(ctx: Ctx, ids, seg_ids, word_emb, pos_emb,
                      seg_emb=None, gamma=None, beta=None, mask=None,
                      position_ids=None):
    """com.microsoft.EmbedLayerNormalization: LN(word_emb[ids] + pos_emb +
    segment_emb[seg_ids]). Outputs (y, mask_index, embedding_sum)."""
    tx = ctx.tx
    ids = ctx.t(ids).to(torch.int64)
    b, s = ids.shape
    emb = tx.take(word_emb, ids, 0)
    if position_ids is not None:
        pos = tx.take(pos_emb, ctx.t(position_ids).to(torch.int64), 0)
    else:
        pos = ctx.t(pos_emb)[None, :s, :]
    emb = tx.add(emb, pos)
    if seg_emb is not None and seg_ids is not None:
        emb = tx.add(emb, tx.take(seg_emb, ctx.t(seg_ids).to(torch.int64), 0))
    y = _ln(tx, emb, gamma, beta, ctx.attr("epsilon", 1e-12)).to(ctx.t(word_emb).dtype)
    mask_index = (torch.sum(ctx.t(mask), dim=1).to(torch.int32)
                  if mask is not None else tx.full((b,), s, torch.int32))
    return y, mask_index, emb


@op("MultiHeadAttention")
def op_multiheadattention(ctx: Ctx, q, k=None, v=None, bias=None,
                          key_padding_mask=None, attention_bias=None,
                          past_key=None, past_value=None):
    """com.microsoft.MultiHeadAttention, separate-QKV encoder subset
    (no KV cache)."""
    if past_key is not None or past_value is not None:
        raise UnsupportedOp("MultiHeadAttention: past KV is not supported")
    n_heads = ctx.attr("num_heads")
    if not n_heads:
        raise UnsupportedOp("MultiHeadAttention: num_heads is required")
    tx = ctx.tx
    q = ctx.t(q)
    if k is None or v is None or ctx.t(k).ndim != 3:
        raise UnsupportedOp(
            "MultiHeadAttention: only separate 3-D q/k/v inputs supported")
    k, v = ctx.t(k), ctx.t(v)
    b, sq, _h = q.shape
    skv = k.shape[1]
    if bias is not None:
        bias = ctx.t(bias)
        hq, hk = q.shape[-1], k.shape[-1]
        q = tx.add(q, bias[:hq])
        k = tx.add(k, bias[hq:hq + hk])
        v = tx.add(v, bias[hq + hk:])

    def split(t):
        return t.reshape(b, t.shape[1], n_heads, -1).permute(0, 2, 1, 3)

    qh, kh, vh = split(q), split(k), split(v)
    scale = ctx.attr("scale") or 1.0 / math.sqrt(qh.shape[-1])
    valid = (None if key_padding_mask is None
             else _key_valid(tx, key_padding_mask, skv, "MultiHeadAttention"))
    causal = (torch.tril(torch.ones((sq, skv), dtype=torch.bool, device=q.device), skv - sq)
              if ctx.attr("unidirectional", 0) else None)
    out = _mha_core(tx, qh, kh, vh, scale, attention_bias, valid, causal)
    return out.permute(0, 2, 1, 3).reshape(b, sq, -1)


# ---------------------------------------------------------------------------
# quantization (QDQ format: QuantizeLinear/DequantizeLinear around f32 ops)
# ---------------------------------------------------------------------------

def _qdq_broadcast(ctx: Ctx, x_ndim: int, v):
    """Per-tensor (scalar) or per-axis (1-D along ``axis``) scale/zero-point
    reshaped to broadcast against x."""
    if ctx.attr("block_size"):
        raise UnsupportedOp(
            f"{ctx.node.op_type}: blocked quantization is not supported")
    v = ctx.t(v)
    if v.ndim == 0 or v.numel() == 1:
        return v.reshape(())
    axis = ctx.attr("axis", 1) % x_ndim
    shape = [1] * x_ndim
    shape[axis] = v.shape[0]
    return v.reshape(shape)


@op("DequantizeLinear")
def op_dequantizelinear(ctx: Ctx, x, scale, zp=None):
    x = ctx.t(x)
    s = _qdq_broadcast(ctx, x.ndim, scale).float()
    y = x.float()
    if zp is not None:
        y = y - _qdq_broadcast(ctx, x.ndim, zp).float()
    return y * s


_INT_INFO = {torch.uint8: (0, 255), torch.int8: (-128, 127),
             torch.int16: (-32768, 32767), torch.int32: (-2**31, 2**31 - 1)}


@op("QuantizeLinear")
def op_quantizelinear(ctx: Ctx, x, scale, zp=None):
    x = ctx.t(x).float()
    s = _qdq_broadcast(ctx, x.ndim, scale).float()
    if zp is not None:
        out_dtype = torch_dtype(np.asarray(zp).dtype) if _is_static(zp) else zp.dtype
        z = _qdq_broadcast(ctx, x.ndim, zp).float()
    else:
        out_dtype = torch.uint8
        z = 0.0
    lo, hi = _INT_INFO[out_dtype]
    # spec: round half to even, then saturate to the zero-point dtype
    q = torch.round(x / s) + z
    return torch.clamp(q, lo, hi).to(out_dtype)


@op("DynamicQuantizeLinear")
def op_dynamicquantizelinear(ctx: Ctx, x):
    """Per-spec uint8 dynamic quantization: scale from the (0-including)
    min/max range, zero point rounded and saturated."""
    x = ctx.t(x).float()
    x_min = torch.clamp(torch.amin(x), max=0.0)
    x_max = torch.clamp(torch.amax(x), min=0.0)
    scale = (x_max - x_min) / 255.0
    scale = torch.where(scale == 0, torch.ones_like(scale), scale)
    zp = torch.clamp(torch.round(-x_min / scale), 0, 255)
    y = torch.clamp(torch.round(x / scale) + zp, 0, 255).to(torch.uint8)
    return y, scale.float(), zp.to(torch.uint8)


@op("MatMulInteger")
def op_matmulinteger(ctx: Ctx, a, b, a_zp=None, b_zp=None):
    """int8/uint8 matmul accumulating in int32 (zero points subtracted
    first, per spec). The product runs in float64, which is exact for
    these ranges (torch has no general integer matmul on CUDA)."""
    a = ctx.t(a).to(torch.int32)
    b = ctx.t(b).to(torch.int32)
    if a_zp is not None:
        z = ctx.t(a_zp).to(torch.int32)
        # 1-D zero point is per-row of A -> broadcast along K
        a = a - (z[..., :, None] if z.ndim else z)
    if b_zp is not None:
        b = b - ctx.t(b_zp).to(torch.int32)
    return torch.matmul(a.double(), b.double()).to(torch.int32)


# ---------------------------------------------------------------------------
# recurrent (GRU / LSTM / RNN), unrolled per step
# ---------------------------------------------------------------------------

def _rnn_prep(ctx: Ctx, x, seq_lens, initials: list):
    """Common RNN-family plumbing. Returns (x [T,B,I], lens [B] | None,
    init_states per state [dirs, B, H], direction, clip, finish).
    ``finish(ys, hs)`` packs (Y [T,dirs,B,H], Y_h... per state)."""
    acts = ctx.attr("activations")
    if acts is not None:
        # exporters serialize the attribute even with the spec defaults:
        # only a genuine deviation is unsupported
        defaults = {"GRU": ["sigmoid", "tanh"], "LSTM":
                    ["sigmoid", "tanh", "tanh"], "RNN": ["tanh"]}[
                        ctx.node.op_type]
        per_dir = [str(a).lower() for a in acts]
        n_dirs = 2 if ctx.attr("direction", "forward") == "bidirectional" \
            else 1
        if per_dir != defaults * n_dirs and per_dir != defaults:
            raise UnsupportedOp(
                f"{ctx.node.op_type}: custom activations {acts} are not "
                f"supported (defaults: {defaults})")
    layout = ctx.attr("layout", 0)
    x = ctx.t(x)
    if layout == 1:  # [B, T, ...] -> [T, B, ...]
        x = x.transpose(0, 1)
    direction = ctx.attr("direction", "forward")
    dirs = 2 if direction == "bidirectional" else 1
    hidden = ctx.attr("hidden_size")
    b = x.shape[1]
    lens = None if seq_lens is None else ctx.t(seq_lens)
    if lens is not None and direction != "forward":
        raise UnsupportedOp(
            f"{ctx.node.op_type}: sequence_lens with reverse/bidirectional "
            f"directions is not supported")
    inits = []
    for init in initials:
        if init is None:
            inits.append(torch.zeros((dirs, b, hidden), dtype=x.dtype, device=x.device))
        else:
            init = ctx.t(init)
            if layout == 1:  # [B, dirs, H] -> [dirs, B, H]
                init = init.transpose(0, 1)
            inits.append(init)

    def finish(ys, final_states):
        y = torch.stack(ys, dim=1)  # [T, dirs, B, H]
        outs = [torch.stack(s, dim=0) for s in final_states]  # [dirs, B, H]
        if layout == 1:
            y = y.permute(2, 0, 1, 3)  # [B, T, dirs, H]
            outs = [o.transpose(0, 1) for o in outs]
        return y, outs

    return x, lens, inits, direction, ctx.attr("clip"), finish


def _rnn_scan(x, lens, step, carry0, reverse: bool):
    """Run ``step(carry, x_t) -> (carry, y_t)`` over time, holding each
    row's state past its sequence length (Y zero there; ORT semantics)."""
    n = x.shape[0]
    carry, ys = carry0, []
    for i in range(n):
        t = n - 1 - i if reverse else i
        new_carry, y = step(carry, x[t])
        if lens is not None:
            valid = (t < lens)[:, None]
            new_carry = tuple(torch.where(valid, nc, c) for nc, c in zip(new_carry, carry))
            y = torch.where(valid, y, torch.zeros_like(y))
        carry = new_carry
        ys.append(y)
    if reverse:
        ys = ys[::-1]
    return carry, torch.stack(ys)


def _gates(w, r, b, n_gates, hidden):
    """Split ONNX-packed weights for one direction into per-gate blocks:
    W [n*H, I] -> n x [I, H] (transposed for x @ w), likewise R; bias
    [2*n*H] -> n x [H] (Wb + Rb)."""
    ws = [w[i * hidden:(i + 1) * hidden].T for i in range(n_gates)]
    rs = [r[i * hidden:(i + 1) * hidden].T for i in range(n_gates)]
    if b is None:
        bs = [0.0] * n_gates
        rbs = [0.0] * n_gates
    else:
        bs = [b[i * hidden:(i + 1) * hidden] for i in range(n_gates)]
        rbs = [b[(n_gates + i) * hidden:(n_gates + i + 1) * hidden]
               for i in range(n_gates)]
    return ws, rs, bs, rbs


def _maybe_clip(v, clip):
    return v if clip is None else torch.clamp(v, -clip, clip)


def _rnn_weights(ctx: Ctx, w, r, b):
    return ctx.t(w), ctx.t(r), None if b is None else ctx.t(b)


@op("GRU")
def op_gru(ctx: Ctx, x, w, r, b=None, seq_lens=None, initial_h=None):
    hidden = ctx.attr("hidden_size")
    lbr = ctx.attr("linear_before_reset", 0)
    x, lens, (h0,), direction, clip, finish = _rnn_prep(
        ctx, x, seq_lens, [initial_h])
    w, r, b = _rnn_weights(ctx, w, r, b)

    ys, hs = [], []
    for d in range(w.shape[0]):
        (wz, wr, wh), (rz, rr, rh), (bz, br, bh), (rbz, rbr, rbh) = _gates(
            w[d], r[d], None if b is None else b[d], 3, hidden)

        def step(carry, xt, wz=wz, wr=wr, wh=wh, rz=rz, rr=rr, rh=rh,
                 bz=bz, br=br, bh=bh, rbz=rbz, rbr=rbr, rbh=rbh):
            (h,) = carry
            z = torch.sigmoid(_maybe_clip(xt @ wz + h @ rz + bz + rbz, clip))
            rg = torch.sigmoid(_maybe_clip(xt @ wr + h @ rr + br + rbr, clip))
            if lbr:
                hh = torch.tanh(_maybe_clip(xt @ wh + bh + rg * (h @ rh + rbh), clip))
            else:
                hh = torch.tanh(_maybe_clip(xt @ wh + (rg * h) @ rh + bh + rbh, clip))
            h_new = (1 - z) * hh + z * h
            return (h_new,), h_new

        reverse = (direction == "reverse") or (
            direction == "bidirectional" and d == 1)
        (h_fin,), y = _rnn_scan(x, lens, step, (h0[d],), reverse)
        ys.append(y)
        hs.append(h_fin)
    y, (y_h,) = finish(ys, [hs])
    return y, y_h


@op("LSTM")
def op_lstm(ctx: Ctx, x, w, r, b=None, seq_lens=None, initial_h=None,
            initial_c=None, peepholes=None):
    if peepholes is not None:
        raise UnsupportedOp("LSTM: peephole connections are not supported")
    hidden = ctx.attr("hidden_size")
    input_forget = ctx.attr("input_forget", 0)
    x, lens, (h0, c0), direction, clip, finish = _rnn_prep(
        ctx, x, seq_lens, [initial_h, initial_c])
    w, r, b = _rnn_weights(ctx, w, r, b)

    ys, hs, cs = [], [], []
    for d in range(w.shape[0]):
        # ONNX gate order: input, output, forget, cell
        (wi, wo, wf, wc), (ri, ro, rf, rc), (bi, bo, bf, bc), \
            (rbi, rbo, rbf, rbc) = _gates(
                w[d], r[d], None if b is None else b[d], 4, hidden)

        def step(carry, xt, wi=wi, wo=wo, wf=wf, wc=wc, ri=ri, ro=ro,
                 rf=rf, rc=rc, bi=bi, bo=bo, bf=bf, bc=bc, rbi=rbi,
                 rbo=rbo, rbf=rbf, rbc=rbc):
            h, c = carry
            i = torch.sigmoid(_maybe_clip(xt @ wi + h @ ri + bi + rbi, clip))
            f = (1.0 - i if input_forget else torch.sigmoid(
                _maybe_clip(xt @ wf + h @ rf + bf + rbf, clip)))
            g = torch.tanh(_maybe_clip(xt @ wc + h @ rc + bc + rbc, clip))
            o = torch.sigmoid(_maybe_clip(xt @ wo + h @ ro + bo + rbo, clip))
            c_new = f * c + i * g
            h_new = o * torch.tanh(c_new)
            return (h_new, c_new), h_new

        reverse = (direction == "reverse") or (
            direction == "bidirectional" and d == 1)
        (h_fin, c_fin), y = _rnn_scan(x, lens, step, (h0[d], c0[d]), reverse)
        ys.append(y)
        hs.append(h_fin)
        cs.append(c_fin)
    y, (y_h, y_c) = finish(ys, [hs, cs])
    return y, y_h, y_c


@op("RNN")
def op_rnn(ctx: Ctx, x, w, r, b=None, seq_lens=None, initial_h=None):
    hidden = ctx.attr("hidden_size")
    x, lens, (h0,), direction, clip, finish = _rnn_prep(
        ctx, x, seq_lens, [initial_h])
    w, r, b = _rnn_weights(ctx, w, r, b)

    ys, hs = [], []
    for d in range(w.shape[0]):
        (wx,), (rh,), (bx,), (rbx,) = _gates(
            w[d], r[d], None if b is None else b[d], 1, hidden)

        def step(carry, xt, wx=wx, rh=rh, bx=bx, rbx=rbx):
            (h,) = carry
            h_new = torch.tanh(_maybe_clip(xt @ wx + h @ rh + bx + rbx, clip))
            return (h_new,), h_new

        reverse = (direction == "reverse") or (
            direction == "bidirectional" and d == 1)
        (h_fin,), y = _rnn_scan(x, lens, step, (h0[d],), reverse)
        ys.append(y)
        hs.append(h_fin)
    y, (y_h,) = finish(ys, [hs])
    return y, y_h


# ---------------------------------------------------------------------------
# scatter / gather-nd / topk / control flow
# ---------------------------------------------------------------------------

def _wrap_nd_indices(tx: TX, idx: torch.Tensor, shape: tuple) -> torch.Tensor:
    """ONNX allows negative indices (wrap from the end)."""
    dims = tx.t(np.asarray(shape[: idx.shape[-1]], np.int64))
    return torch.where(idx < 0, idx + dims, idx)


def _gather_nd(d, idx):
    k = idx.shape[-1]
    return d[tuple(idx[..., i] for i in range(k))]


@op("GatherND")
def op_gathernd(ctx: Ctx, data, indices):
    b = ctx.attr("batch_dims", 0)
    d = ctx.t(data)
    idx = ctx.t(indices).to(torch.int64)
    if b:
        # fold the batch dims (leading dims of data and indices agree)
        lead = tuple(d.shape[:b])
        nb = math.prod(lead)
        dd = d.reshape((nb,) + tuple(d.shape[b:]))
        ii = _wrap_nd_indices(ctx.tx, idx.reshape((nb,) + tuple(idx.shape[b:])), tuple(dd.shape[1:]))
        k = ii.shape[-1]
        bidx = torch.arange(nb, device=d.device).reshape((nb,) + (1,) * (ii.ndim - 2))
        out = dd[(bidx,) + tuple(ii[..., i] for i in range(k))]
        return out.reshape(lead + tuple(out.shape[1:]))
    return _gather_nd(d, _wrap_nd_indices(ctx.tx, idx, tuple(d.shape)))


@op("ScatterND")
def op_scatternd(ctx: Ctx, data, indices, updates):
    red = ctx.attr("reduction", "none")
    d = ctx.t(data)
    idx = _wrap_nd_indices(ctx.tx, ctx.t(indices).to(torch.int64), tuple(d.shape))
    upd = ctx.t(updates).to(d.dtype)
    k = idx.shape[-1]
    flat_idx = idx.reshape(-1, k)
    upd_flat = upd.reshape((-1,) + tuple(d.shape[k:]))
    # rows of d viewed as [prod(shape[:k]), rest...]: a linear row index
    strides = np.cumprod((tuple(d.shape[1:k]) + (1,))[::-1])[::-1]
    lin = sum(flat_idx[:, i] * int(strides[i]) for i in range(k)) if k else \
        torch.zeros((flat_idx.shape[0],), dtype=torch.int64, device=d.device)
    rows = d.reshape((-1,) + tuple(d.shape[k:])).clone()
    if red == "none":
        rows[lin] = upd_flat
    elif red == "add":
        rows.index_add_(0, lin, upd_flat)
    elif red == "mul":
        ix = lin.reshape((-1,) + (1,) * (rows.ndim - 1)).expand(upd_flat.shape)
        rows.scatter_reduce_(0, ix, upd_flat, reduce="prod")
    else:
        raise UnsupportedOp(f"ScatterND reduction={red!r}")
    return rows.reshape(d.shape)


@op("TopK")
def op_topk(ctx: Ctx, x, k):
    kk = int(ctx.static(k, "k").ravel()[0])
    axis = ctx.attr("axis", -1)
    largest = ctx.attr("largest", 1)
    moved = torch.movedim(ctx.t(x), axis, -1)
    if largest:
        vals, idx = torch.topk(moved, kk, dim=-1, largest=True, sorted=True)
    else:  # smallest-k ascending: a stable argsort
        idx = torch.argsort(moved, dim=-1, stable=True)[..., :kk]
        vals = torch.gather(moved, -1, idx)
    return (torch.movedim(vals, -1, axis),
            torch.movedim(idx, -1, axis).to(torch.int32))


@op("ScatterElements")
def op_scatterelements(ctx: Ctx, data, indices, updates):
    axis = ctx.attr("axis", 0)
    red = ctx.attr("reduction", "none")
    d = ctx.t(data)
    axis %= d.ndim
    idx = ctx.t(indices).to(torch.int64)
    idx = torch.where(idx < 0, idx + d.shape[axis], idx)
    upd = ctx.t(updates).to(d.dtype)
    if red == "none":
        return torch.scatter(d, axis, idx, upd)
    reduce = {"add": "sum", "mul": "prod", "max": "amax", "min": "amin"}.get(red)
    if reduce is None:
        raise UnsupportedOp(f"ScatterElements reduction={red!r}")
    return torch.scatter_reduce(d, axis, idx, upd, reduce=reduce, include_self=True)


def _sub_env(ctx: Ctx, sub: OnnxGraph) -> dict:
    env = dict(ctx.env or {})
    for name, t in sub.initializers.items():
        env[name] = np.asarray(t.data)
    return env


@op("If")
def op_if(ctx: Ctx, cond):
    """The condition must be a host value (in these graphs it derives from
    shape math, which the partial evaluator keeps concrete)."""
    c = bool(np.asarray(ctx.static(cond, "condition")).ravel()[0])
    sub = ctx.attr("then_branch" if c else "else_branch")
    if sub is None:
        raise UnsupportedOp("If: missing branch subgraph")
    sub_env = _sub_env(ctx, sub)
    _run_nodes(_toposort(sub, set(sub_env)), sub_env)
    outs = tuple(sub_env[vi.name] for vi in sub.outputs)
    return outs if len(outs) > 1 else outs[0]


@op("Loop")
def op_loop(ctx: Ctx, trip_count, cond, *carried):
    """ONNX Loop with a host-known trip count, unrolled (for-loops over
    fixed lengths, the form torch exports for fixed-iteration scans). A
    data-dependent loop condition raises UnsupportedOp.

    Body signature per spec: (iter_num, cond_in, carried...) ->
    (cond_out, carried..., scan_outputs...); scan outputs stack along a new
    leading axis."""
    body = ctx.attr("body")
    if body is None:
        raise UnsupportedOp("Loop: missing body subgraph")
    m = int(ctx.static(trip_count, "trip_count (M)").ravel()[0])
    if cond is not None:
        c = np.asarray(ctx.static(cond, "initial condition"))
        if not bool(c.ravel()[0]):
            m = 0
    n_carried = len(carried)
    n_scan = len(body.outputs) - 1 - n_carried
    if m == 0 and n_scan > 0:
        raise UnsupportedOp(
            "Loop: zero trip count with scan outputs is not supported "
            "(empty scan output shapes cannot be derived without running "
            "the body)")
    in_names = [vi.name for vi in body.inputs]
    out_names = [vi.name for vi in body.outputs]
    state = list(carried)
    scans: list[list] = [[] for _ in range(n_scan)]
    for it in range(m):
        sub_env = _sub_env(ctx, body)
        sub_env[in_names[0]] = np.asarray(it, np.int64)
        if len(in_names) > 1:
            sub_env[in_names[1]] = np.asarray(True)
        for name, val in zip(in_names[2:], state):
            sub_env[name] = val
        _run_nodes(_toposort(body, set(sub_env)), sub_env)
        cond_out = sub_env[out_names[0]]
        state = [sub_env[n] for n in out_names[1: 1 + n_carried]]
        for i, n in enumerate(out_names[1 + n_carried:]):
            scans[i].append(ctx.t(sub_env[n]))
        if _is_static(cond_out):
            if not bool(np.asarray(cond_out).ravel()[0]):
                break
        else:
            raise UnsupportedOp(
                "Loop: data-dependent loop condition cannot be captured")
    outs = tuple(state) + tuple(torch.stack(s) for s in scans)
    return outs if len(outs) > 1 else outs[0]


@op("Scan")
def op_scan(ctx: Ctx, *inputs):
    """ONNX Scan: N carried states + M scan inputs iterated along an axis,
    unrolled (sequence lengths are shapes, so the trip count is known).

    Body signature per spec: (state_1..N, scan_elem_1..M) ->
    (state_1..N, scan_out_1..K); scan outputs stack along
    scan_output_axes."""
    body = ctx.attr("body")
    if body is None:
        raise UnsupportedOp("Scan: missing body subgraph")
    m = ctx.attr("num_scan_inputs")
    if not m:
        raise UnsupportedOp("Scan: num_scan_inputs attribute is required")
    n = len(inputs) - m
    state = list(inputs[:n])
    scans_in = [ctx.t(s) for s in inputs[n:]]
    in_axes = ctx.attr("scan_input_axes", [0] * m)
    in_dirs = ctx.attr("scan_input_directions", [0] * m)
    in_names = [vi.name for vi in body.inputs]
    out_names = [vi.name for vi in body.outputs]
    k = len(out_names) - n
    out_axes = ctx.attr("scan_output_axes", [0] * k)
    out_dirs = ctx.attr("scan_output_directions", [0] * k)
    ax0 = in_axes[0] % scans_in[0].ndim
    t = scans_in[0].shape[ax0]
    collect: list[list] = [[] for _ in range(k)]
    for it in range(t):
        sub_env = _sub_env(ctx, body)
        for name, val in zip(in_names[:n], state):
            sub_env[name] = val
        for j, s in enumerate(scans_in):
            ax = in_axes[j] % s.ndim
            idx = t - 1 - it if in_dirs[j] else it
            sub_env[in_names[n + j]] = s.select(ax, idx)
        _run_nodes(_toposort(body, set(sub_env)), sub_env)
        state = [sub_env[nm] for nm in out_names[:n]]
        for i, nm in enumerate(out_names[n:]):
            collect[i].append(ctx.t(sub_env[nm]))
    outs = list(state)
    for i in range(k):
        seq = collect[i][::-1] if out_dirs[i] else collect[i]
        axis = out_axes[i] % (seq[0].ndim + 1)
        outs.append(torch.stack(seq, dim=axis))
    return tuple(outs) if len(outs) > 1 else outs[0]


def _run_nodes(nodes: list[OnnxNode], env: dict, drop=None) -> None:
    """Evaluate nodes into ``env`` (shared by the executor and subgraphs).
    ``drop[i]``: the values to release after node ``i``, their last use
    (``_last_uses``)."""
    tx = env["__tx__"]
    for k, node in enumerate(nodes):
        ins = [env[i] if i else None for i in node.inputs]
        handler = _REGISTRY.get(node.op_type)
        if handler is None:
            raise UnsupportedOp(
                f"op '{node.op_type}' (node '{node.name}') is not "
                f"implemented by the ONNX executor")
        static = getattr(handler, "static_ok", False) and all(
            v is None or _is_static(v) for v in ins)
        ctx = Ctx(np if static else tx, node.attrs, node, env)
        out = handler(ctx, *ins)
        if not isinstance(out, tuple):
            out = (out,)
        for name, val in zip(node.outputs, out):
            if name:
                env[name] = val
        if drop is not None:
            for name in drop[k]:
                env.pop(name, None)


def _names_read(node: OnnxNode) -> set[str]:
    """The values a node reads: its inputs and, for If/Loop/Scan, every name
    its subgraphs read from the enclosing scope."""
    names = {i for i in node.inputs if i}
    for v in node.attrs.values():
        if isinstance(v, OnnxGraph):
            for sub in v.nodes:
                names |= _names_read(sub)
    return names


def _last_uses(nodes: list[OnnxNode], keep) -> list[list[str]]:
    """For each node, the values whose last reader it is (except ``keep``,
    the graph outputs): dropping them from the env as the run goes lets the
    allocator reuse their memory, as XLA's buffer assignment does; a run
    that kept every intermediate would hold them all at once."""
    last: dict[str, int] = {}
    for k, node in enumerate(nodes):
        for name in _names_read(node):
            last[name] = k
    for k, node in enumerate(nodes):  # outputs nothing reads go at once
        for name in node.outputs:
            if name and name not in last:
                last[name] = k
    drop: list[list[str]] = [[] for _ in nodes]
    for name, k in last.items():
        if name not in keep:
            drop[k].append(name)
    return drop


# ---------------------------------------------------------------------------
# executor
# ---------------------------------------------------------------------------

def _dce(nodes: list[OnnxNode], outputs) -> list[OnnxNode]:
    """Dead-code elimination over a topologically-ordered node list: keep
    only nodes whose outputs transitively feed ``outputs`` (every op is
    pure). Subgraph-carrying nodes are kept whole when any output is
    live."""
    live = set(outputs)
    kept_rev: list[OnnxNode] = []
    for n in reversed(nodes):
        if any(o and o in live for o in n.outputs):
            kept_rev.append(n)
            live.update(i for i in n.inputs if i)
    return kept_rev[::-1]


def _toposort(graph: OnnxGraph, available: set[str]) -> list[OnnxNode]:
    """Kahn's algorithm over value names: tolerant of producers that break
    ONNX's topological order."""
    nodes = list(graph.nodes)
    produced = dict(
        (o, i) for i, n in enumerate(nodes) for o in n.outputs if o
    )
    ordered: list[OnnxNode] = []
    ready = set(available)
    pending = list(range(len(nodes)))
    while pending:
        progressed = False
        rest = []
        for i in pending:
            n = nodes[i]
            if all((not inp) or inp in ready for inp in n.inputs):
                ordered.append(n)
                ready.update(o for o in n.outputs if o)
                progressed = True
            else:
                rest.append(i)
        if not progressed:
            missing = {
                inp for i in rest for inp in nodes[i].inputs
                if inp and inp not in ready and inp not in produced
            }
            raise ValueError(f"graph has undefined inputs: {sorted(missing)}")
        pending = rest
    return ordered


_PRECISION_LOCK = threading.RLock()
_STRICT = ("float32", "highest")


@contextlib.contextmanager
def matmul_precision(precision: str, device: torch.device):
    """TF32 off in cuBLAS and cuDNN for "float32"/"highest", on otherwise
    (XLA's default on a GPU), for the duration of the block, under a lock;
    the previous switches come back after. Nothing to set off the card."""
    if device.type != "cuda":
        yield
        return
    allow = precision not in _STRICT
    with _PRECISION_LOCK:
        old = (torch.backends.cuda.matmul.allow_tf32, torch.backends.cudnn.allow_tf32)
        torch.backends.cuda.matmul.allow_tf32 = allow
        torch.backends.cudnn.allow_tf32 = allow
        try:
            yield
        finally:
            torch.backends.cuda.matmul.allow_tf32, torch.backends.cudnn.allow_tf32 = old


class OnnxExecutor:
    """Executes one ONNX graph op by op in PyTorch on ``device``.

    ``feeds`` are numpy arrays keyed by graph input name; returns numpy
    outputs in graph-output order. Float initializers live on the device
    (``_weights``); integer initializers are host constants (shape math).
    """

    # float-typed operands that MUST be host values (everything else
    # static-required is integer and caught by dtype): Range bounds,
    # Resize/Upsample scales, OneHot values
    _STATIC_FLOAT_OPERANDS = {
        "Range": (0, 1, 2), "Resize": (2,), "Upsample": (1,), "OneHot": (2,),
    }

    @classmethod
    def _static_required_names(cls, graph: OnnxGraph) -> set[str]:
        names: set[str] = set()
        stack = [graph]
        while stack:
            g = stack.pop()
            for n in g.nodes:
                for i in cls._STATIC_FLOAT_OPERANDS.get(n.op_type, ()):
                    if len(n.inputs) > i and n.inputs[i]:
                        names.add(n.inputs[i])
                stack.extend(v for v in n.attrs.values()
                             if isinstance(v, OnnxGraph))
        return names

    def __init__(self, graph: OnnxGraph, *,
                 matmul_precision: str = "float32",
                 bf16_storage: bool = False, device=None):
        """``bf16_storage``: store MatMul/Gemm/Conv outputs as bfloat16
        (softmax, norms and reductions still compute in f32; graph outputs
        keep their declared f32 dtype): an opt-in throughput mode, not for
        parity. ``device`` defaults to ``cuda`` and raises without a card."""
        from ..engine.engine import resolve_device

        self.device = resolve_device(device)
        self.graph = graph
        self._static_inits: dict[str, np.ndarray] = {}
        self._weights: dict[str, torch.Tensor] = {}
        static_req = self._static_required_names(graph)
        for name, t in graph.initializers.items():
            arr = np.asarray(t.data)
            # integers/bools are host constants (shape math), as are the few
            # float operands ops require static; every other float array
            # becomes a device tensor, replaceable in ``_weights``
            if (np.issubdtype(arr.dtype, np.integer) or arr.dtype == np.bool_
                    or name in static_req):
                self._static_inits[name] = arr
            else:
                self._weights[name] = from_numpy(arr, self.device)
        init_names = set(graph.initializers)
        self.input_names = [vi.name for vi in graph.inputs
                            if vi.name not in init_names]
        self.output_names = [vi.name for vi in graph.outputs]
        if not self.output_names:
            raise ValueError("graph has no declared outputs")
        avail = (set(self.input_names) | init_names)
        self._nodes = _dce(_toposort(graph, avail), self.output_names)
        self._drop = _last_uses(self._nodes, set(self.output_names))
        self._matmul_precision = matmul_precision
        self._bf16_storage = bool(bf16_storage)
        self._consts: dict[torch.device, dict] = {}

    def _tx(self, device: torch.device) -> TX:
        return TX(device, self._consts.setdefault(device, {}))

    # -- evaluation --------------------------------------------------------
    def _run_traced(self, weights: dict, inputs: tuple, time_mask=None):
        """The graph on device tensors (weights by name, inputs in
        ``input_names`` order); returns a tuple of device tensors. Named as
        the JAX executor's traced body: the backend captures it."""
        device = (inputs[0].device if inputs
                  else next(iter(weights.values())).device if weights else self.device)
        tx = self._tx(device)
        env: dict[str, Any] = dict(self._static_inits)
        env["__tx__"] = tx
        # reserved key consulted by opset-sensitive ops (Softmax < 13);
        # If/Loop/Scan bodies inherit it via their env copies
        env["__opset__"] = self.graph.opset
        if time_mask is not None:
            env["__time_mask__"] = tx.t(time_mask).float()
        if self._bf16_storage:
            env["__bf16_storage__"] = True
            env["__graph_outputs__"] = frozenset(self.output_names)
        env.update(weights)
        for name, arr in zip(self.input_names, inputs):
            env[name] = arr
        with torch.inference_mode(), matmul_precision(self._matmul_precision, device):
            _run_nodes(self._nodes, env, self._drop)
            outs = []
            for name in self.output_names:
                v = tx.t(env[name])
                if self._bf16_storage and v.dtype == torch.bfloat16:
                    v = v.float()  # keep the declared output contract
                outs.append(v)
        return tuple(outs)

    # -- public API --------------------------------------------------------
    def __call__(self, feeds: dict[str, np.ndarray]) -> list[np.ndarray]:
        missing = [n for n in self.input_names if n not in feeds]
        if missing:
            raise ValueError(f"missing feeds: {missing}")
        inputs = tuple(from_numpy(feeds[n], self.device) for n in self.input_names)
        outs = self._run_traced(self._weights, inputs)
        return [to_numpy(o) for o in outs]

    def run(self, output_names=None,
            feeds: dict[str, np.ndarray] | None = None) -> list[np.ndarray]:
        """onnxruntime.InferenceSession.run-compatible signature
        (``run(None, {...})``)."""
        outs = self(feeds or {})
        if output_names:
            by_name = dict(zip(self.output_names, outs))
            return [by_name[n] for n in output_names]
        return outs


class OnnxSession(OnnxExecutor):
    """An executor read straight from an .onnx file: a stand-in for
    ``ort.InferenceSession(path)`` within this package."""

    def __init__(self, path: str, **kw):
        super().__init__(load_onnx(path), **kw)


def load_session(path: str, **kw) -> OnnxSession:
    return OnnxSession(path, **kw)
