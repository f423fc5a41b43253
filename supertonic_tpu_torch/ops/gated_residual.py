"""The gated residual of the transformer block: the CUDA kernel
``csrc/gated_residual.cu`` and its plain PyTorch version.

The fusion XLA makes of ``x = x + gate * linear(p["o"], ...)`` in the JAX
package's ``block`` (``supertonic_tpu/models/layers.py:428``, ``:433``,
``:454``), fed the bias-less product:

    gated_residual(x [B, T, D], y [B, T, D], bias [D] f32 or None,
                   gate [B, 1, D] or None) -> x + gate * (y + bias)

with ``linear``'s bias add (``add_bias``), then the gate's product and the
residual's sum each rounded to x's type, as eager PyTorch rounds them;
bit for bit the same on the card and on the CPU. ``bias=None`` takes a
product whose bias is already in (W8A8, a row-parallel linear);
``gate=None`` the blocks without AdaLN (``1.0 * o`` is exact).

``gated_residual`` is the wrapper: plain version for CPU tensors only;
CUDA tensors go to the kernel, or it raises.
"""

from __future__ import annotations

import ctypes

import torch

from . import _build, _count

# x, y, bias, gate, gate batch stride, out, rows, T, D, dtype code, stream
_ARGTYPES = ([ctypes.c_void_p] * 4 + [ctypes.c_longlong, ctypes.c_void_p]
             + [ctypes.c_int] * 4 + [ctypes.c_void_p])


def supports(d: int, dtype: torch.dtype) -> bool:
    """Whether the kernel takes rows of ``d`` values in ``dtype``: any."""
    return d >= 1 and dtype in (torch.float32, torch.bfloat16)


def add_bias(y, bias):
    """``linear``'s bias add in the JAX package's order: in bf16 the product
    is rounded before a bf16 bias is added (layers.py:55-62); otherwise
    the f32 sum is rounded once."""
    if y.dtype == torch.bfloat16:
        return y + bias.to(torch.bfloat16)
    return (y + bias).to(y.dtype)


def gated_residual_plain(x, y, bias, gate):
    """Plain PyTorch version: ``x + gate * add_bias(y, bias)``."""
    o = y if bias is None else add_bias(y, bias)
    return x + (o if gate is None else gate * o)


def batch_rows(m, b: int, d: int, name: str):
    """A [B, 1, D] (or [1, 1, D]) vector of the block's modulation, as
    the kernels read it: a view whose last axis is contiguous, and its batch
    stride (0 where one row serves every batch row)."""
    if m.dim() != 3 or m.shape[1] != 1 or m.shape[2] != d or m.shape[0] not in (1, b):
        raise ValueError(f"{name} must be [B, 1, D] = {(b, 1, d)}, got {tuple(m.shape)}")
    if m.stride(2) != 1:
        m = m.contiguous()
    return m, (0 if m.shape[0] == 1 else m.stride(0))


def gated_residual(x, y, bias=None, gate=None):
    """x, y [B, T, D] -> x + gate * (y + bias), [B, T, D] in x's dtype."""
    if x.dim() != 3 or tuple(y.shape) != tuple(x.shape):
        raise ValueError(f"x and y must be one [B, T, D] shape, got {tuple(x.shape)} and "
                         f"{tuple(y.shape)}")
    b, t, d = x.shape
    if bias is not None and tuple(bias.shape) != (d,):
        raise ValueError(f"bias must be [D] = [{d}], got {tuple(bias.shape)}")
    gstride = 0
    if gate is not None:
        gate, gstride = batch_rows(gate, b, d, "gate")
    if x.device.type == "cpu":
        return gated_residual_plain(x, y, bias, gate)
    if x.device.type != "cuda":
        raise ValueError(f"unsupported device {x.device}")
    if not supports(d, x.dtype) or y.dtype != x.dtype or (
            gate is not None and gate.dtype != x.dtype):
        raise TypeError(f"the gated-residual kernel takes x, y and gate in one type, float32 "
                        f"or bfloat16, got {x.dtype}, {y.dtype}"
                        f"{'' if gate is None else f', {gate.dtype}'}")
    if bias is not None and bias.dtype != torch.float32:
        raise TypeError(f"bias must be float32, got {bias.dtype}")
    for name, p in (("x", x), ("y", y), ("bias", bias)):
        if p is not None and (p.device != x.device or not p.is_contiguous()):
            raise ValueError(f"{name} must be contiguous and on {x.device}")
    if gate is not None and gate.device != x.device:
        raise ValueError(f"gate must be on {x.device}")
    out = torch.empty_like(x)
    fn = _build.function("gated_residual", "stk_gated_residual", _ARGTYPES)
    P = _build.ptr
    with _build.on(x):
        _build.check(fn(P(x), P(y), P(bias), P(gate), gstride, P(out), b * t, t, d,
                        _build.dtype_code(x.dtype), _build.stream_ptr(x)), "stk_gated_residual")
    _count.launched("gated_residual", (b, t, d, gate is not None, bias is not None))
    return out
