"""A Q or K projection's bias add fused with its rotary embedding: the CUDA
kernel ``csrc/rope.cu`` and its plain PyTorch version.

The fusion XLA makes of the JAX package's ``linear`` bias add
(``supertonic_tpu/models/layers.py:51-63``) and ``apply_rope`` (``:162``),
fed the bias-less bf16 product, at ``mha``'s Q and K and ``kv_project``'s K:

    bias_rope(y [B, T, H * Dh], bias [H * Dh] f32 or None,
              cos, sin [B, T, Dh / 2] f32, n_heads) -> [B, T, H, Dh]

the bias added as ``linear`` adds it (``gated_residual.add_bias``), then
each head's halves rotated in f32 through type promotion, x not upcast
(``apply_rope``), rounded once to y's type; bit for bit the same on the
card and on the CPU. ``bias=None`` takes a product whose bias is already in
(W8A8, a column-parallel rank, a fused QKV or KV projection). ``y`` may be
a column slice of a wider product (its rows strided); the result is
contiguous, as the attention kernel reads it.

``bias_rope`` is the wrapper: plain version for CPU tensors only; CUDA
tensors go to the kernel, or it raises.
"""

from __future__ import annotations

import ctypes

import torch

from . import _build, _count
from .gated_residual import add_bias

# y, row stride, bias, cos, sin, out, rows, H, Dh / 2, dtype code, stream
_ARGTYPES = ([ctypes.c_void_p, ctypes.c_longlong] + [ctypes.c_void_p] * 4
             + [ctypes.c_int] * 4 + [ctypes.c_void_p])


def supports(dh: int, dtype: torch.dtype) -> bool:
    """Whether the kernel takes heads of width ``dh`` in ``dtype``: any
    even width."""
    return dh >= 2 and dh % 2 == 0 and dtype in (torch.float32, torch.bfloat16)


def apply_rope(x, cos, sin):
    """x [B, T, H, Dh]; cos/sin [B, T, Dh // 2] (broadcast over heads). The
    rotation runs in f32 through type promotion; x itself is not upcast."""
    x1, x2 = x.chunk(2, dim=-1)
    if cos.dim() == 3:
        cos = cos[:, :, None, :]
        sin = sin[:, :, None, :]
    out = torch.cat([x1 * cos - x2 * sin, x1 * sin + x2 * cos], dim=-1)
    return out.to(x.dtype)


def bias_rope_plain(y, bias, cos, sin, n_heads: int):
    """Plain PyTorch version: ``apply_rope`` of the head-split
    ``add_bias(y, bias)``."""
    if bias is not None:
        y = add_bias(y, bias)
    b, t, d = y.shape
    return apply_rope(y.reshape(b, t, n_heads, d // n_heads), cos, sin)


def bias_rope(y, bias, cos, sin, n_heads: int):
    """y [B, T, H * Dh] -> rotated heads [B, T, H, Dh] in y's dtype."""
    if y.dim() != 3 or y.shape[-1] % n_heads:
        raise ValueError(f"y must be [B, T, H * Dh] with H = {n_heads}, got {tuple(y.shape)}")
    b, t, d = y.shape
    dh = d // n_heads
    if dh % 2:
        raise ValueError(f"rotary embedding needs an even head width, got {dh}")
    half = dh // 2
    for name, c in (("cos", cos), ("sin", sin)):
        if tuple(c.shape) != (b, t, half):
            raise ValueError(f"{name} must be [B, T, Dh / 2] = {(b, t, half)}, got "
                             f"{tuple(c.shape)}")
    if bias is not None and tuple(bias.shape) != (d,):
        raise ValueError(f"bias must be [D] = [{d}], got {tuple(bias.shape)}")
    if y.device.type == "cpu":
        return bias_rope_plain(y, bias, cos, sin, n_heads)
    if y.device.type != "cuda":
        raise ValueError(f"unsupported device {y.device}")
    if not supports(dh, y.dtype):
        raise TypeError(f"the rope kernel takes float32 or bfloat16, got {y.dtype}")
    if cos.dtype != torch.float32 or sin.dtype != torch.float32 or (
            bias is not None and bias.dtype != torch.float32):
        raise TypeError("cos, sin and bias must be float32")
    # rows of y at one stride (a column slice of a wider product has them)
    ld = y.stride(1)
    if y.stride(2) != 1 or (b > 1 and y.stride(0) != t * ld) or ld < d:
        raise ValueError(f"y's rows must be contiguous at one stride, got strides {y.stride()}")
    for name, p in (("cos", cos), ("sin", sin), ("bias", bias)):
        if p is not None and (p.device != y.device or not p.is_contiguous()):
            raise ValueError(f"{name} must be contiguous and on {y.device}")
    out = torch.empty((b, t, n_heads, dh), device=y.device, dtype=y.dtype)
    fn = _build.function("rope", "stk_bias_rope", _ARGTYPES)
    P = _build.ptr
    with _build.on(y):
        _build.check(fn(P(y), ld, P(bias), P(cos), P(sin), P(out), b * t, n_heads, half,
                        _build.dtype_code(y.dtype), _build.stream_ptr(y)), "stk_bias_rope")
    _count.launched("bias_rope", (b, t, n_heads, dh, bias is not None))
    return out
