"""Masked multi-head attention: the CUDA kernel ``csrc/attention.cu`` and
its plain PyTorch version.

Replaces ``supertonic_tpu/ops/attention.py:_attn_kernel_rows`` (the Pallas
kernel behind ``fused_attention``). Contract, in the [B, T, H, Dh] layout:
``softmax(q.k^T * (1/sqrt(Dh)) + (1 - key_mask) * -1e9) v``, logits and
softmax in f32, probabilities rounded to v's dtype before the PV product,
PV accumulated in f32, output in q's dtype. In bf16 this differs from the
JAX package's XLA ``attention_core``, which stores bf16 logits; the port
follows the kernel.

What bounds the kernel on the H100 and what its design does about it is in
the header of ``csrc/attention.cu``. Unlike the Pallas kernel there is no
panel cap: keys stream through shared memory, so every Tq and Tk the path
produces runs in the kernel.

``fused_attention`` is the wrapper: it runs the plain version for CPU
tensors only; CUDA tensors go to the kernel, or it raises.
"""

from __future__ import annotations

import ctypes
import math

import torch

from . import _build, _count

NEG_INF = -1e9

# q, k, v, key_mask, out, B, Tq, Tk, H, Dh, dtype code, stream
_ARGTYPES = [ctypes.c_void_p] * 5 + [ctypes.c_int] * 6 + [ctypes.c_void_p]


def attention_plain(q, k, v, key_mask=None):
    """Plain PyTorch version, with the kernel's rounding points."""
    scale = 1.0 / math.sqrt(q.shape[-1])
    logits = torch.einsum("bqhd,bkhd->bhqk", q.float(), k.float()) * scale
    if key_mask is not None:
        logits = logits + ((1.0 - key_mask.float()) * NEG_INF)[:, None, None, :]
    logits = logits - logits.amax(-1, keepdim=True)
    probs = torch.exp(logits)
    probs = (probs / probs.sum(-1, keepdim=True)).to(v.dtype)
    out = torch.einsum("bhqk,bkhd->bqhd", probs.float(), v.float())
    return out.to(q.dtype)


def fused_attention(q, k, v, key_mask=None):
    """q [B,Tq,H,Dh], k/v [B,Tk,H,Dh], key_mask [B,Tk] (1 = valid) or None
    -> [B,Tq,H,Dh] in q's dtype."""
    b, tq, h, d = q.shape
    tk = k.shape[1]
    if k.shape != (b, tk, h, d) or v.shape != k.shape:
        raise ValueError(f"shape mismatch q{tuple(q.shape)} k{tuple(k.shape)} "
                         f"v{tuple(v.shape)}")
    if key_mask is not None and tuple(key_mask.shape) != (b, tk):
        raise ValueError(f"key_mask must be [B, Tk] = {(b, tk)}, got "
                         f"{tuple(key_mask.shape)}")
    if q.device.type == "cpu":
        return attention_plain(q, k, v, key_mask)
    if q.device.type != "cuda":
        raise ValueError(f"unsupported device {q.device}")
    if not (q.dtype == k.dtype == v.dtype):
        raise TypeError("q, k and v must share one dtype")
    if d != 64 or tk < 1:
        raise ValueError(f"the attention kernel takes Dh = 64 and Tk >= 1, got "
                         f"Dh = {d}, Tk = {tk}")
    for name, t in (("q", q), ("k", k), ("v", v)):
        if not t.is_contiguous() or t.device != q.device or t.data_ptr() % 16:
            raise ValueError(f"{name} must be contiguous, 16-byte aligned and on "
                             f"{q.device}")
    mask = None
    if key_mask is not None:
        mask = key_mask.to(device=q.device, dtype=torch.float32).contiguous()
    out = torch.empty_like(q)
    fn = _build.function("attention", "stk_attention", _ARGTYPES)
    with _build.on(q):
        _build.check(fn(_build.ptr(q), _build.ptr(k), _build.ptr(v),
                        _build.ptr(mask), _build.ptr(out), b, tq, tk, h, d,
                        _build.dtype_code(q.dtype), _build.stream_ptr(q)),
                     "stk_attention")
    _count.launched("attention", (b, h, tq, tk, key_mask is not None))
    return out
