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
    rope=(cos, sin [B, T, Dh / 2] f32), n_heads=H, x [B, T, K]:
        apply_rope of the head-split linear                 [B, T, H, Dh]
        a Q or K projection (supertonic_tpu/models/layers.py:292-294,
        :317-323, :346-349): ``rope.bias_rope_plain`` of the product
    residual=r [B, T, N], gate=g [B, 1, N] or None, x [B, T, K]:
        r + g * linear                                        [B, T, N]
        a sublayer's O or FFN-out with the gated residual (layers.py:428,
        :433, :454): ``gated_residual.gated_residual_plain`` of the product

each sum and product rounded where eager PyTorch rounds it. On the card
the sums run in another order than cuBLAS's, so a result may sit one bf16
step from the plain version's where the f32 sum lies within its order's
noise of a rounding boundary (``bf16_within``); the silu, tail, rope and
residual forms are bit for bit the plain silu, tail, rotation and gated
residual applied to the kernel's own bias form.

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
from .gated_residual import add_bias, batch_rows, gated_residual_plain
from .rope import bias_rope_plain

# x, w, bias, x_in, mask, dt, y, M, N, K, T, mode, stream
_ARGTYPES = [ctypes.c_void_p] * 7 + [ctypes.c_int] * 5 + [ctypes.c_void_p]
# stk_linear_epilogue: x, w, bias, cos, sin, residual, gate, gate batch
# stride, y, M, N, K, T, Dh, mode, stream
_EPI_ARGTYPES = ([ctypes.c_void_p] * 7 + [ctypes.c_longlong, ctypes.c_void_p]
                 + [ctypes.c_int] * 6 + [ctypes.c_void_p])
FORMS = ("bias", "silu", "tail", "rope", "residual")  # mode codes 0-4
# the library's instances, in the order stk_linear_tiles lists them
_TILE_NAMES = ("bf16_many", "bf16_many_silu", "bf16_few", "bf16_fewer_or_any_n", "tail_f32",
               "tail_f32_any_n", "rope_192", "rope_256", "residual_many")


def kernel_tiles() -> dict:
    """The library's instances (rows, columns, ring stages): bf16 results at
    many tiles (the bias and rope forms; the silu form), at few, at fewer or
    an N whose rows no TMA map takes, the tail's f32 results (x_in by TMA, or
    at any N), the rope form's at Dh 96 and 192 and at Dh 256, and the
    residual form's at many tiles (builds the library on first use)."""
    t = (ctypes.c_int * (3 * len(_TILE_NAMES)))()
    _build.function("linear", "stk_linear_tiles", [ctypes.c_void_p])(t)
    return {name: tuple(t[3 * i:3 * i + 3]) for i, name in enumerate(_TILE_NAMES)}


def kernel_instance(m: int, k: int, n: int, form: str, dh: int = 0) -> str:
    """The instance a launch of ``form`` (one of ``FORMS``; "rope" with
    heads of ``dh``) at M x K x N takes on the current card: a name of
    ``kernel_tiles()``, or "simt" (K off 8; the rope form at a head width no
    tile takes whole) (builds the library on first use)."""
    fn = _build.function("linear", "stk_linear_instance", [ctypes.c_int] * 5)
    got = fn(m, n, k, FORMS.index(form), dh)
    if got < 0:
        raise ValueError(f"no linear launch at M={m}, K={k}, N={n}, {form}")
    return (*_TILE_NAMES, "simt")[got]


def euler_tail(v, tail):
    """The flow step's tail on the velocity ``v`` [B, T, N] (any float type):
    ``(x_in + dt * float(v) * mask) * mask`` in f32, in the JAX step's order."""
    x_in, dt, mask = tail
    m = mask[:, :, None]
    return (x_in + dt[:, None, None] * (v.float() * m)) * m


def linear_plain(x, w, b, *, silu: bool = False, tail=None, rope=None, n_heads: int = 0,
                 residual=None, gate=None):
    """Plain PyTorch version: the product in x's type, ``add_bias`` (JAX's
    bf16 rounding), then F.silu or the flow step's tail; or the product
    through ``bias_rope_plain`` or ``gated_residual_plain`` (the bias add
    in them)."""
    if rope is not None:
        return bias_rope_plain(F.linear(x, w), b, *rope, n_heads)
    if residual is not None:
        return gated_residual_plain(residual, F.linear(x, w), b, gate)
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


def _check_forms(x, n, silu, tail, rope, n_heads, residual, gate):
    """Shapes of the forms' operands; returns the gate as the kernel reads
    it and its batch stride (``batch_rows``)."""
    if sum((silu, tail is not None, rope is not None, residual is not None)) > 1:
        raise ValueError("the silu, tail, rope and residual forms are exclusive")
    if gate is not None and residual is None:
        raise ValueError("a gate needs the residual form")
    if tail is None and rope is None and residual is None:
        return gate, 0
    if x.dim() != 3:
        raise ValueError(f"the tail, rope and residual forms take x [B, T, K], got "
                         f"{tuple(x.shape)}")
    bsz, t = x.shape[:2]
    if tail is not None:
        x_in, dt, mask = tail
        if (tuple(x_in.shape) != (bsz, t, n) or tuple(dt.shape) != (bsz,)
                or tuple(mask.shape) != (bsz, t)):
            raise ValueError(f"the tail must be x_in [B, T, N] = {(bsz, t, n)}, dt [B] and "
                             f"mask [B, T], got {tuple(x_in.shape)}, {tuple(dt.shape)} and "
                             f"{tuple(mask.shape)}")
    if rope is not None:
        if n_heads < 1 or n % n_heads or (n // n_heads) % 2:
            raise ValueError(f"the rope form needs heads of an even width dividing N = {n}, "
                             f"got n_heads={n_heads}")
        half = n // n_heads // 2
        for name, c in zip(("cos", "sin"), rope):
            if tuple(c.shape) != (bsz, t, half):
                raise ValueError(f"{name} must be [B, T, Dh / 2] = {(bsz, t, half)}, got "
                                 f"{tuple(c.shape)}")
    if residual is not None:
        if tuple(residual.shape) != (bsz, t, n):
            raise ValueError(f"the residual must be [B, T, N] = {(bsz, t, n)}, got "
                             f"{tuple(residual.shape)}")
        if gate is not None:
            return batch_rows(gate, bsz, n, "gate")
    return gate, 0


def linear(x, w, b, *, silu: bool = False, tail=None, rope=None, n_heads: int = 0,
           residual=None, gate=None):
    """x [..., K] bf16, w [N, K] bf16, b [N] f32 -> [..., N] bf16; with
    ``silu``, F.silu of it; with ``tail`` = (x_in [B, T, N] f32, dt [B] f32,
    mask [B, T] f32) and x [B, T, K], the flow step's new latent [B, T, N]
    f32; with ``rope`` = (cos, sin [B, T, Dh / 2] f32) and ``n_heads``, the
    rotated heads [B, T, H, Dh]; with ``residual`` [B, T, N] (and ``gate``
    [B, 1, N] or [1, 1, N]), residual + gate * linear [B, T, N]. One form at
    a time."""
    if x.dim() < 1 or w.dim() != 2 or x.shape[-1] != w.shape[1]:
        raise ValueError(f"x must be [..., K] and w [N, K], got {tuple(x.shape)} and "
                         f"{tuple(w.shape)}")
    n, k = w.shape
    if tuple(b.shape) != (n,):
        raise ValueError(f"b must be [N] = [{n}], got {tuple(b.shape)}")
    gate, gstride = _check_forms(x, n, silu, tail, rope, n_heads, residual, gate)
    if x.device.type == "cpu":
        return linear_plain(x, w, b, silu=silu, tail=tail, rope=rope, n_heads=n_heads,
                            residual=residual, gate=gate)
    if x.device.type != "cuda":
        raise ValueError(f"unsupported device {x.device}")
    if x.dtype != torch.bfloat16 or w.dtype != torch.bfloat16:
        raise TypeError(f"the linear kernel takes bf16 x and w, got {x.dtype} and {w.dtype}")
    f32 = (b, *(tail or ()), *(rope or ()))
    if any(t.dtype != torch.float32 for t in f32):
        raise TypeError("b, x_in, dt, mask, cos and sin must be float32")
    if any(t is not None and t.dtype != torch.bfloat16 for t in (residual, gate)):
        raise TypeError("the residual and the gate must be bfloat16")
    lead = x.shape[:-1]
    x2 = x.reshape(-1, k)
    m = x2.shape[0]
    if m < 1 or n < 1 or k < 1:
        raise ValueError(f"the linear kernel takes M, N, K >= 1, got M={m}, N={n}, K={k}")
    if not x2.is_contiguous() or x2.data_ptr() % 16:
        x2 = x2.clone(memory_format=torch.contiguous_format)
    args = [("x", x2), ("w", w), ("b", b)]
    args += zip(("x_in", "dt", "mask"), [t.contiguous() for t in tail or ()])
    args += zip(("cos", "sin"), [t.contiguous() for t in rope or ()])
    if residual is not None:
        args.append(("residual", residual))
    # x, w, x_in and the residual are read by TMA (16-byte aligned rows); the
    # rest by cp.async, 8-byte (cos, sin) or 4-byte (gate pairs) or scalar
    # loads
    for name, p in args:
        if (p.device != x.device or not p.is_contiguous()
                or (name in ("x", "w", "x_in", "residual", "cos", "sin") and p.data_ptr() % 16)):
            raise ValueError(f"{name} must be contiguous and on {x.device} (x, w, x_in, the "
                             f"residual, cos and sin 16-byte aligned)")
    if gate is not None:
        if gate.device != x.device:
            raise ValueError(f"gate must be on {x.device}")
        if n % 2 == 0 and (gate.data_ptr() % 4 or gstride % 2):
            gate, gstride = batch_rows(gate.clone(memory_format=torch.contiguous_format),
                                       x.shape[0], n, "gate")
    args = dict(args)
    t_rows = x.shape[1] if x.dim() == 3 else 1
    form = ("tail" if tail is not None else "rope" if rope is not None
            else "residual" if residual is not None else "silu" if silu else "bias")
    P = _build.ptr
    if form in ("bias", "silu", "tail"):
        y = torch.empty((*lead, n), device=x.device,
                        dtype=torch.float32 if form == "tail" else torch.bfloat16)
        fn = _build.function("linear", "stk_linear", _ARGTYPES)
        with _build.on(x):
            _build.check(fn(P(x2), P(w), P(b), P(args.get("x_in")), P(args.get("mask")),
                            P(args.get("dt")), P(y), m, n, k, t_rows, FORMS.index(form),
                            _build.stream_ptr(x)), "stk_linear")
        _count.launched("linear", (m, k, n, form, t_rows if form == "tail" else 0))
        return y
    dh = n // n_heads if form == "rope" else 0
    y = torch.empty((*lead, n), device=x.device, dtype=torch.bfloat16)
    fn = _build.function("linear", "stk_linear_epilogue", _EPI_ARGTYPES)
    with _build.on(x):
        _build.check(fn(P(x2), P(w), P(b), P(args.get("cos")), P(args.get("sin")),
                        P(args.get("residual")), P(gate), gstride, P(y), m, n, k, t_rows, dh,
                        FORMS.index(form), _build.stream_ptr(x)), "stk_linear_epilogue")
    # the rope form's key holds Dh, the residual form's the gate's rows a
    # batch row (0 without a gate)
    _count.launched("linear", (m, k, n, form, dh if form == "rope" else
                               t_rows if gate is not None else 0))
    return y.view(*lead, n_heads, dh) if form == "rope" else y
