"""LayerNorm with the AdaLN modulation of the transformer blocks: the CUDA
kernel ``csrc/ln_modulate.cu`` and its plain PyTorch version.

The fusion XLA makes of the JAX package's ``layer_norm``
(``supertonic_tpu/models/layers.py:106``) and ``_modulate`` (``:388``), as
``block`` and the vector estimator's output head use them:

    ln_modulate(x [B, T, D], g, b [D] f32, shift=None, scale=None)
        h = LayerNorm(x) * g + b            (f32 statistics, eps 1e-5)
        h * (1 + scale) + shift             (shift, scale [B, 1, D])

with the eager layers' rounding points: the statistics and normalization
in f32, then in bf16 the normalized value, its product with g and the sum
with b each rounded, and with the modulation ``1 + scale``, the product and
the sum with shift each rounded (not the fused FFN's one rounding at the
end, ``ffn.adaln_ffn_plain``). Without shift and scale it is the plain
LayerNorm of the text encoder's and duration predictor's blocks and of
every ``ln_out``.

Tolerance of the kernel against the plain version: its statistics are
summed in another order than ``torch.mean``, and the rest of its arithmetic
is the plain version's, rounding for rounding. In f32 it agrees to
``F32_ATOL``; in bf16 each element is the plain version's affine and
modulation of the normalized value rounded to bf16 or of one of that
value's two bf16 neighbours (``one_step_match``).

The quantizing form, where every consumer of the output is a W8A8 linear
(the int8 path's ln1, ln2 and ln3): the fusion XLA makes of ``_modulate``
with the first half of ``_linear_w8a8`` (``layers.py:77-91``),

    ln_modulate_quantize(x [B, T, D] bf16, g, b, shift=None, scale=None)
        -> quantize_rows(ln_modulate(...).reshape(B T, D)) = (xq [B T, D] int8,
                                                              sx [B T] f32)

in one pass that never stores the bf16 rows; on the card bit for bit the
kernel followed by the quantize kernel (``ops/quantize.py``), so it holds
the plain version to the same one-step rule through the bf16 rows.

``ln_modulate`` and ``ln_modulate_quantize`` are the wrappers: plain
version for CPU tensors only; CUDA tensors go to the kernel, or they raise.
"""

from __future__ import annotations

import ctypes

import torch

from . import _build, _count
from .gated_residual import batch_rows
from .quantize import quantize_rows_plain

F32_ATOL = 1e-5  # the kernel against the plain version in f32

# x, g, b, shift, scale, their batch stride, out, rows, T, D, eps, dtype
# code, stream
_ARGTYPES = ([ctypes.c_void_p] * 5 + [ctypes.c_longlong, ctypes.c_void_p]
             + [ctypes.c_int] * 3 + [ctypes.c_float, ctypes.c_int, ctypes.c_void_p])
# stk_ln_modulate_quantize: x, g, b, shift, scale, their batch stride, xq,
# sx, rows, T, D, eps, stream
_Q_ARGTYPES = ([ctypes.c_void_p] * 5 + [ctypes.c_longlong] + [ctypes.c_void_p] * 2
               + [ctypes.c_int] * 3 + [ctypes.c_float, ctypes.c_void_p])
Q_MAX_D = 1024  # the quantizing form holds a row's 8-value chunks in a warp's registers


def supports(d: int, dtype: torch.dtype) -> bool:
    """Whether the kernel takes rows of ``d`` values in ``dtype``: any."""
    return d >= 1 and dtype in (torch.float32, torch.bfloat16)


def supports_quantize(d: int, dtype: torch.dtype) -> bool:
    """Whether the quantizing form takes rows of ``d`` values in ``dtype``:
    bf16 rows of a multiple of 8 values, up to ``Q_MAX_D``."""
    return dtype == torch.bfloat16 and 8 <= d <= Q_MAX_D and d % 8 == 0


def _normalized(x, eps):
    xf = x.float()
    mean = xf.mean(-1, keepdim=True)
    var = (xf - mean).square().mean(-1, keepdim=True)
    return (xf - mean) * torch.rsqrt(var + eps)


def _affine(y, g, b, shift, scale, dtype):
    if dtype == torch.bfloat16:
        # normalize in f32, affine in bf16 (JAX layers.py:111-117)
        h = y.to(torch.bfloat16) * g.to(torch.bfloat16) + b.to(torch.bfloat16)
    else:
        h = (y * g + b).to(dtype)
    if shift is None:
        return h
    return h * (1.0 + scale) + shift


def ln_modulate_plain(x, g, b, shift=None, scale=None, eps: float = 1e-5):
    """Plain PyTorch version: the port's ``layers.layer_norm`` then
    ``h * (1 + scale) + shift``."""
    return _affine(_normalized(x, eps), g, b, shift, scale, x.dtype)


def one_step_match(got, x, g, b, shift=None, scale=None, eps: float = 1e-5):
    """For bf16 ``got``: (share of elements bit-equal to the plain version,
    share equal to the plain version's affine and modulation of the
    normalized value rounded to bf16 or of one of its two bf16 neighbours),
    the kernel's tolerance. A normalized value summed in another order can
    round one step away; a product and a sum that cancel after it move by
    the step of their larger term, which no bound in ulps of the result
    holds."""
    y = _normalized(x, eps).to(torch.bfloat16)
    bits = y.view(torch.int16)
    outs = [_affine(c, g, b, shift, scale, torch.bfloat16)
            for c in (y, (bits + 1).view(torch.bfloat16), (bits - 1).view(torch.bfloat16))]
    got_bits = got.view(torch.int16)
    same = [got_bits == o.view(torch.int16) for o in outs]
    return float(same[0].float().mean()), float((same[0] | same[1] | same[2]).float().mean())


def ln_modulate_quantize_plain(x, g, b, shift=None, scale=None, eps: float = 1e-5):
    """Plain PyTorch version of the quantizing form: ``ln_modulate_plain``,
    then ``quantize_rows_plain`` of its rows."""
    h = ln_modulate_plain(x, g, b, shift, scale, eps)
    return quantize_rows_plain(h.reshape(-1, h.shape[-1]))


def _operands(x, g, b, shift, scale):
    """(B, T, D, shift, scale, their batch stride) of checked operands."""
    if x.dim() == 3:
        bs, t, d = x.shape
    elif x.dim() >= 1 and shift is None:
        d = x.shape[-1]
        bs, t = 1, x.numel() // max(d, 1)
    else:
        raise ValueError(f"x must be [B, T, D], got {tuple(x.shape)}")
    if tuple(g.shape) != (d,) or tuple(b.shape) != (d,):
        raise ValueError(f"g and b must be [D] = [{d}], got {tuple(g.shape)} and "
                         f"{tuple(b.shape)}")
    if (shift is None) != (scale is None):
        raise ValueError("shift and scale come together")
    mstride = s_scale = 0
    if shift is not None:
        shift, mstride = batch_rows(shift, bs, d, "shift")
        scale, s_scale = batch_rows(scale, bs, d, "scale")
        if s_scale != mstride and x.device.type == "cuda":
            raise ValueError("shift and scale must be at one batch stride")
    return bs, t, d, shift, scale, mstride


def _check_card(x, g, b, shift, scale, dtypes):
    """Raise unless the card's kernel takes these operands: x, shift and
    scale of one type in ``dtypes``, g and b f32, all on x's device, x, g
    and b contiguous."""
    if x.device.type != "cuda":
        raise ValueError(f"unsupported device {x.device}")
    if x.dtype not in dtypes or (shift is not None and (shift.dtype != x.dtype
                                                        or scale.dtype != x.dtype)):
        raise TypeError(f"the LayerNorm kernel takes x, shift and scale in one type, "
                        f"{' or '.join(str(t).split('.')[-1] for t in dtypes)}, got {x.dtype}"
                        f"{'' if shift is None else f', {shift.dtype}, {scale.dtype}'}")
    if g.dtype != torch.float32 or b.dtype != torch.float32:
        raise TypeError("g and b must be float32")
    for name, p in (("x", x), ("g", g), ("b", b)):
        if p.device != x.device or not p.is_contiguous():
            raise ValueError(f"{name} must be contiguous and on {x.device}")
    if shift is not None and (shift.device != x.device or scale.device != x.device):
        raise ValueError(f"shift and scale must be on {x.device}")


def ln_modulate(x, g, b, shift=None, scale=None, *, eps: float = 1e-5):
    """x [B, T, D] -> LayerNorm(x) * g + b [* (1 + scale) + shift], in x's
    dtype; without the modulation x may be [..., D]."""
    bs, t, d, shift, scale, mstride = _operands(x, g, b, shift, scale)
    if x.device.type == "cpu":
        return ln_modulate_plain(x, g, b, shift, scale, eps)
    _check_card(x, g, b, shift, scale, (torch.float32, torch.bfloat16))
    out = torch.empty_like(x)
    fn = _build.function("ln_modulate", "stk_ln_modulate", _ARGTYPES)
    P = _build.ptr
    with _build.on(x):
        _build.check(fn(P(x), P(g), P(b), P(shift), P(scale), mstride, P(out), bs * t, t, d,
                        eps, _build.dtype_code(x.dtype), _build.stream_ptr(x)),
                     "stk_ln_modulate")
    _count.launched("ln_modulate", (bs, t, d, shift is not None))
    return out


def ln_modulate_quantize(x, g, b, shift=None, scale=None, *, eps: float = 1e-5):
    """x [B, T, D] (without the modulation [..., D]) -> (xq [B T, D] int8,
    sx [B T] f32): the W8A8 quantize pass of ``ln_modulate``'s rows, in one
    pass on the card (bf16, ``supports_quantize``)."""
    bs, t, d, shift, scale, mstride = _operands(x, g, b, shift, scale)
    if x.device.type == "cpu":
        return ln_modulate_quantize_plain(x, g, b, shift, scale, eps)
    _check_card(x, g, b, shift, scale, (torch.bfloat16,))
    if not supports_quantize(d, x.dtype) or x.data_ptr() % 16:
        raise ValueError(f"the quantizing LayerNorm takes 16-byte aligned rows of a multiple "
                         f"of 8 values up to {Q_MAX_D}, got D={d}")
    xq = torch.empty((bs * t, d), device=x.device, dtype=torch.int8)
    sx = torch.empty((bs * t,), device=x.device, dtype=torch.float32)
    fn = _build.function("ln_modulate", "stk_ln_modulate_quantize", _Q_ARGTYPES)
    P = _build.ptr
    with _build.on(x):
        _build.check(fn(P(x), P(g), P(b), P(shift), P(scale), mstride, P(xq), P(sx), bs * t, t,
                        d, eps, _build.stream_ptr(x)), "stk_ln_modulate_quantize")
    _count.launched("ln_modulate", (bs, t, d, shift is not None, "quantize"))
    return xq, sx
