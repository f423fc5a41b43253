"""Fused AdaLN-modulated FFN sublayer: the CUDA kernel ``csrc/ffn.cu`` and
its plain PyTorch version.

Replaces ``supertonic_tpu/ops/ffn.py:_ffn_kernel`` (``fused_adaln_ffn``):

    h   = LayerNorm(x)                 (f32 statistics, eps 1e-5, affine g/b)
    h   = h * (1 + scale) + shift      (per batch row)
    y   = silu(h @ W1 + b1) @ W2 + b2  (h rounded to W's dtype; f32 sums;
                                        silu in f32, rounded to W2's dtype)
    out = x + gate * y                 (in f32, rounded once to x's dtype)

Weights come in torch's linear layout: ``w1`` [F, D] and ``w2`` [D, F]
(the port's ``Linear.weight``), biases and LN parameters in f32,
``shift``/``scale``/``gate`` [B, 1, D] in any float dtype.

What bounds the kernel on the H100 and what its design does about it is in
the header of ``csrc/ffn.cu``: in bf16, a LayerNorm-and-modulation pass
writes the modulated h once, then two tensor-core GEMMs with their
epilogues (b1 and silu; b2, gate and residual) pass the [B*T, F]
intermediate through device memory, which measured faster than keeping it
on chip (PERF.md).

``fused_adaln_ffn`` is the wrapper: plain version for CPU tensors only;
CUDA tensors go to the kernel, or it raises.
"""

from __future__ import annotations

import ctypes

import torch

from . import _build, _count


MAX_D_BF16 = 1024  # the bf16 LayerNorm pass holds a row in one warp's registers
_F32_NAMES = ("ln_g", "ln_b", "b1", "b2", "shift", "scale", "gate")

# x, ln_g, ln_b, w1, b1, w2, b2, shift, scale, gate, h, mid, out, B, T, D,
# F, eps, dtype code, stream
_ARGTYPES = ([ctypes.c_void_p] * 13 + [ctypes.c_int] * 4
             + [ctypes.c_float, ctypes.c_int, ctypes.c_void_p])


def adaln_ffn_plain(x, ln_g, ln_b, w1, b1, w2, b2, shift, scale, gate,
                    eps: float = 1e-5):
    """Plain PyTorch version, with the kernel's rounding points."""
    xf = x.float()
    mean = xf.mean(-1, keepdim=True)
    var = (xf - mean).square().mean(-1, keepdim=True)
    h = (xf - mean) * torch.rsqrt(var + eps)
    h = h * ln_g.float() + ln_b.float()
    h = h * (1.0 + scale.float()) + shift.float()
    h = h.to(w1.dtype).float()
    mid = h @ w1.float().t() + b1.float()
    mid = (mid * torch.sigmoid(mid)).to(w2.dtype).float()
    y = mid @ w2.float().t() + b2.float()
    return (xf + gate.float() * y).to(x.dtype)


def fused_adaln_ffn(x, ln_g, ln_b, w1, b1, w2, b2, shift, scale, gate,
                    *, eps: float = 1e-5):
    """x [B,T,D] -> x + gate * FFN(mod(LN(x))), [B,T,D] in x's dtype."""
    b, t, d = x.shape
    f = w1.shape[0]
    if tuple(w1.shape) != (f, d) or tuple(w2.shape) != (d, f):
        raise ValueError(f"w1 must be [F, D] and w2 [D, F], got "
                         f"{tuple(w1.shape)} and {tuple(w2.shape)}")
    for name, m in (("shift", shift), ("scale", scale), ("gate", gate)):
        if tuple(m.shape) != (b, 1, d):
            raise ValueError(f"{name} must be [B, 1, D] = {(b, 1, d)}, got "
                             f"{tuple(m.shape)}")
    if x.device.type == "cpu":
        return adaln_ffn_plain(x, ln_g, ln_b, w1, b1, w2, b2, shift, scale,
                               gate, eps)
    if x.device.type != "cuda":
        raise ValueError(f"unsupported device {x.device}")
    if w1.dtype != x.dtype or w2.dtype != x.dtype:
        raise TypeError("w1 and w2 must be in x's dtype")
    if d % 128 or f % 128 or (x.dtype == torch.bfloat16 and d > MAX_D_BF16):
        raise ValueError(f"the FFN kernel takes D and F in multiples of 128 (bf16: "
                         f"D <= {MAX_D_BF16}), got D={d}, F={f}")

    def f32(v):
        v = v.to(device=x.device, dtype=torch.float32).contiguous()
        return v.reshape(b, d) if v.dim() == 3 else v

    args = [f32(v) for v in (ln_g, ln_b, b1, b2, shift, scale, gate)]
    for name, p in (("x", x), ("w1", w1), ("w2", w2), *zip(_F32_NAMES, args)):
        if not p.is_contiguous() or p.device != x.device or p.data_ptr() % 16:
            raise ValueError(f"{name} must be contiguous, 16-byte aligned and on {x.device}")
    mid = torch.empty((b * t, f), device=x.device, dtype=x.dtype)
    # bf16: the modulated h, written by the kernel's LayerNorm pass
    h = (torch.empty((b * t, d), device=x.device, dtype=x.dtype)
         if x.dtype == torch.bfloat16 else None)
    out = torch.empty_like(x)
    fn = _build.function("ffn", "stk_adaln_ffn", _ARGTYPES)
    g, bl, b1f, b2f, sh, sc, ga = args
    P = _build.ptr
    with _build.on(x):
        _build.check(fn(P(x), P(g), P(bl), P(w1), P(b1f), P(w2), P(b2f), P(sh),
                        P(sc), P(ga), P(h), P(mid), P(out), b, t, d, f, eps,
                        _build.dtype_code(x.dtype), _build.stream_ptr(x)),
                     "stk_adaln_ffn")
    _count.launched("adaln_ffn", (b, t, d, f))
    return out
