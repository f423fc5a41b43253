"""The bf16 linear with its output fusion: the CUDA kernel ``stk_linear`` of
``csrc/linear.cu`` and its plain PyTorch version.

The fusion XLA makes of the JAX package's bf16 ``layers.linear``
(``supertonic_tpu/models/layers.py:55-62``: the f32 sum rounded to bf16,
then the bf16 bias added) with what its callers do with the result, in
torch's linear layout (``w`` [N, K]):

    linear(x [..., K] bf16, w [N, K] bf16, b [N] f32)
        -> bf16(bf16(x . w^T) + bf16(b))                      [..., N] bf16
    silu=True: F.silu of that, rounded to bf16 once more      (jax.nn.silu(linear(...)))
    tail=(x_in [B, T, N] f32, dt [B] f32, mask [B, T] f32), x [B, T, K]:
        v = float(linear) * mask;  (x_in + dt * v) * mask     [B, T, N] f32
        the flow step's out_proj, velocity mask and Euler update
        (supertonic_tpu/models/vector_estimator.py:156, :185-186)

each sum and product rounded where eager PyTorch rounds it. On the card
the sums run in another order than cuBLAS's, so a result may sit one bf16
step from the plain version's where the f32 sum lies within its order's
noise of a rounding boundary (``bf16_within``); the silu and tail forms
are bit for bit the plain silu and tail applied to the kernel's own bias
form.

The port's float32 linears stay cuBLAS's product plus ``add_bias``: the
kernel takes bf16 alone (``wgmma`` has no f32 operand), and the f32 path is
the route that holds the card against the CPU. ``linear`` is the wrapper:
plain version for CPU tensors only; CUDA tensors go to the kernel, or it
raises.
"""

from __future__ import annotations

import ctypes

import torch
import torch.nn.functional as F

from . import _build, _count
from .gated_residual import add_bias

# x, w, bias, x_in, mask, dt, y, M, N, K, T, mode, stream
_ARGTYPES = [ctypes.c_void_p] * 7 + [ctypes.c_int] * 5 + [ctypes.c_void_p]
MODE_BIAS, MODE_SILU, MODE_TAIL = 0, 1, 2
# the library's instances, in the order stk_linear_tiles lists them
_TILE_NAMES = ("bf16_many", "bf16_many_silu", "bf16_few", "bf16_fewer_or_any_n", "tail_f32",
               "tail_f32_any_n")


def kernel_tiles() -> dict:
    """The library's instances (rows, columns, ring stages): bf16 results at
    many tiles (the bias form, the silu form), at few, at fewer or an N whose
    rows no TMA map takes, and the tail's f32 results (x_in by TMA, or at any
    N) (builds the library on first use)."""
    t = (ctypes.c_int * (3 * len(_TILE_NAMES)))()
    _build.function("linear", "stk_linear_tiles", [ctypes.c_void_p])(t)
    return {name: tuple(t[3 * i:3 * i + 3]) for i, name in enumerate(_TILE_NAMES)}


def kernel_instance(m: int, k: int, n: int, form: str) -> str:
    """The instance a launch of ``form`` ("bias", "silu" or "tail") at M x K
    x N takes on the current card: a name of ``kernel_tiles()``, or "simt"
    (K off 8) (builds the library on first use)."""
    fn = _build.function("linear", "stk_linear_instance", [ctypes.c_int] * 4)
    got = fn(m, n, k, ("bias", "silu", "tail").index(form))
    if got < 0:
        raise ValueError(f"no linear launch at M={m}, K={k}, N={n}, {form}")
    return (*_TILE_NAMES, "simt")[got]


def euler_tail(v, tail):
    """The flow step's tail on the velocity ``v`` [B, T, N] (any float type):
    ``(x_in + dt * float(v) * mask) * mask`` in f32, in the JAX step's order."""
    x_in, dt, mask = tail
    m = mask[:, :, None]
    return (x_in + dt[:, None, None] * (v.float() * m)) * m


def linear_plain(x, w, b, *, silu: bool = False, tail=None):
    """Plain PyTorch version: the product in x's type, ``add_bias`` (JAX's
    bf16 rounding), then F.silu or the flow step's tail."""
    y = add_bias(F.linear(x, w), b)
    if silu:
        y = F.silu(y)
    return y if tail is None else euler_tail(y, tail)


def bf16_within(got, x, w, b, **kw) -> tuple[float, bool]:
    """For the bias or silu form ``got``: (share of elements bit-equal to
    the plain version, whether every element lies within 1.1 x 2^-7 (|y| +
    |o|) + 2^-7 |result| + the floor of the plain version, y the bf16
    product and o the bias form), the kernel's tolerance. Sums in two orders
    can round the product y one bf16 step (at most 2^-7 |y|) apart; the bias
    add carries that and rounds once more (2^-7 |o|); silu moves an error by
    at most 1.1 times and rounds again. A floor of 2^-16 of the largest |y|
    holds sums that cancel to far below their terms."""
    want = linear_plain(x, w, b, **kw).float()
    y = F.linear(x, w).float().abs()
    o = linear_plain(x, w, b).float().abs()
    err = (got.float() - want).abs()
    floor = 2.0 ** -16 * float(y.max())
    ok = bool((err <= 1.1 * 2.0 ** -7 * (y + o) + 2.0 ** -7 * want.abs() + floor).all())
    return float((err == 0).float().mean()), ok


def linear(x, w, b, *, silu: bool = False, tail=None):
    """x [..., K] bf16, w [N, K] bf16, b [N] f32 -> [..., N] bf16; with
    ``silu``, F.silu of it; with ``tail`` = (x_in [B, T, N] f32, dt [B] f32,
    mask [B, T] f32) and x [B, T, K], the flow step's new latent [B, T, N]
    f32."""
    if x.dim() < 1 or w.dim() != 2 or x.shape[-1] != w.shape[1]:
        raise ValueError(f"x must be [..., K] and w [N, K], got {tuple(x.shape)} and "
                         f"{tuple(w.shape)}")
    n, k = w.shape
    if tuple(b.shape) != (n,):
        raise ValueError(f"b must be [N] = [{n}], got {tuple(b.shape)}")
    if silu and tail is not None:
        raise ValueError("the silu and tail forms are exclusive")
    if tail is not None:
        x_in, dt, mask = tail
        if x.dim() != 3:
            raise ValueError(f"the tail form takes x [B, T, K], got {tuple(x.shape)}")
        bsz, t = x.shape[:2]
        if (tuple(x_in.shape) != (bsz, t, n) or tuple(dt.shape) != (bsz,)
                or tuple(mask.shape) != (bsz, t)):
            raise ValueError(f"the tail must be x_in [B, T, N] = {(bsz, t, n)}, dt [B] and "
                             f"mask [B, T], got {tuple(x_in.shape)}, {tuple(dt.shape)} and "
                             f"{tuple(mask.shape)}")
    if x.device.type == "cpu":
        return linear_plain(x, w, b, silu=silu, tail=tail)
    if x.device.type != "cuda":
        raise ValueError(f"unsupported device {x.device}")
    if x.dtype != torch.bfloat16 or w.dtype != torch.bfloat16:
        raise TypeError(f"the linear kernel takes bf16 x and w, got {x.dtype} and {w.dtype}")
    if b.dtype != torch.float32 or (tail is not None and any(
            t.dtype != torch.float32 for t in tail)):
        raise TypeError("b, x_in, dt and mask must be float32")
    lead = x.shape[:-1]
    x2 = x.reshape(-1, k)
    m = x2.shape[0]
    if m < 1 or n < 1 or k < 1:
        raise ValueError(f"the linear kernel takes M, N, K >= 1, got M={m}, N={n}, K={k}")
    if not x2.is_contiguous() or x2.data_ptr() % 16:
        x2 = x2.clone(memory_format=torch.contiguous_format)
    args = [x2, w, b]
    if tail is not None:
        args += [t.contiguous() for t in tail]
    # x, w and x_in are read by TMA (16-byte aligned rows); the rest by
    # cp.async or scalar loads
    for name, p in zip(("x", "w", "b", "x_in", "dt", "mask"), args):
        if (p.device != x.device or not p.is_contiguous()
                or (name in ("x", "w", "x_in") and p.data_ptr() % 16)):
            raise ValueError(f"{name} must be contiguous and on {x.device} (x, w and x_in "
                             f"16-byte aligned)")
    if tail is None:
        y = torch.empty((*lead, n), device=x.device, dtype=torch.bfloat16)
        x_in = dt = mask = None
        t_rows, mode = 1, MODE_SILU if silu else MODE_BIAS
    else:
        x_in, dt, mask = args[3:]
        y = torch.empty((*lead, n), device=x.device, dtype=torch.float32)
        t_rows, mode = x.shape[1], MODE_TAIL
    fn = _build.function("linear", "stk_linear", _ARGTYPES)
    P = _build.ptr
    with _build.on(x):
        _build.check(fn(P(x2), P(w), P(b), P(x_in), P(mask), P(dt), P(y), m, n, k, t_rows, mode,
                        _build.stream_ptr(x)), "stk_linear")
    _count.launched("linear", (m, k, n, ("bias", "silu", "tail")[mode],
                               t_rows if tail is not None else 0))
    return y
