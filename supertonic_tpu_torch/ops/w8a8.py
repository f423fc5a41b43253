"""The W8A8 linear's int8 product with its rescale-and-bias epilogue: the
CUDA kernel ``stk_w8a8_matmul`` of ``csrc/int8_matmul.cu`` and its plain
PyTorch version.

The second half of the JAX package's ``_linear_w8a8``
(``supertonic_tpu/models/layers.py``), after the quantize pass
(``ops/quantize.py``); the product is the port of
``tools/int8_microbench.py:_pallas_i8_matmul`` (``ops/int8_matmul.py``),
here with the epilogue that turns the exact int32 sums into the linear's
output, in torch's linear layout (``QLinear.w_q`` is [dout, din]):

    w8a8_matmul(xq [M, K] int8, sx [M] f32, w_q [N, K] int8, w_scale [N] f32,
                bias [N] f32, dtype) -> (float(xq . w_q^T) * sx) * w_scale + bias
                                        [M, N], rounded once to dtype

bit for bit the same on the card and on the CPU, and no int32 [M, N] tensor
is written. What bounds the kernel on the H100 and what its design does
about it is in the header of ``csrc/int8_matmul.cu``.

``w8a8_matmul`` is the wrapper: plain version for CPU tensors only; CUDA
tensors go to the kernel, or it raises.
"""

from __future__ import annotations

import ctypes

import torch

from . import _build, _count
from .int8_matmul import K_MULTIPLE, int8_matmul_plain

# a, w, sx, w_scale, bias, y, M, N, K, dtype code, stream
_ARGTYPES = [ctypes.c_void_p] * 6 + [ctypes.c_int] * 4 + [ctypes.c_void_p]


def w8a8_matmul_plain(xq, sx, w_q, w_scale, bias, dtype):
    """Plain PyTorch version: the exact product, then the rescale and bias
    in f32 in the JAX ``_linear_w8a8``'s order, one rounding to dtype."""
    acc = int8_matmul_plain(xq, w_q)
    y = acc.float() * sx[:, None] * w_scale
    return (y + bias).to(dtype)


def w8a8_matmul(xq, sx, w_q, w_scale, bias, dtype):
    """xq [M, K] int8, sx [M], w_q [N, K] int8, w_scale [N], bias [N]
    (float32) -> [M, N] in dtype (float32 or bfloat16)."""
    if xq.dim() != 2 or w_q.dim() != 2 or xq.shape[1] != w_q.shape[1]:
        raise ValueError(f"xq must be [M, K] and w_q [N, K], got {tuple(xq.shape)} "
                         f"and {tuple(w_q.shape)}")
    m, k = xq.shape
    n = w_q.shape[0]
    if tuple(sx.shape) != (m,) or tuple(w_scale.shape) != (n,) or tuple(bias.shape) != (n,):
        raise ValueError(f"sx must be [M], w_scale and bias [N], got {tuple(sx.shape)}, "
                         f"{tuple(w_scale.shape)} and {tuple(bias.shape)}")
    if xq.dtype != torch.int8 or w_q.dtype != torch.int8:
        raise TypeError(f"xq and w_q must be int8, got {xq.dtype} and {w_q.dtype}")
    if any(t.dtype != torch.float32 for t in (sx, w_scale, bias)):
        raise TypeError("sx, w_scale and bias must be float32")
    if dtype not in (torch.float32, torch.bfloat16):
        raise TypeError(f"the output is float32 or bfloat16, got {dtype}")
    if xq.device.type == "cpu":
        return w8a8_matmul_plain(xq, sx, w_q, w_scale, bias, dtype)
    if xq.device.type != "cuda":
        raise ValueError(f"unsupported device {xq.device}")
    if m < 1 or n < 1 or k < K_MULTIPLE or k % K_MULTIPLE:
        raise ValueError(f"the int8 kernel takes M, N >= 1 and K a positive "
                         f"multiple of {K_MULTIPLE}, got M={m}, N={n}, K={k}")
    for name, t in (("xq", xq), ("w_q", w_q), ("sx", sx), ("w_scale", w_scale),
                    ("bias", bias)):
        if not t.is_contiguous() or t.device != xq.device or t.data_ptr() % 16:
            raise ValueError(f"{name} must be contiguous, 16-byte aligned and "
                             f"on {xq.device}")
    y = torch.empty((m, n), device=xq.device, dtype=dtype)
    fn = _build.function("int8_matmul", "stk_w8a8_matmul", _ARGTYPES)
    P = _build.ptr
    with _build.on(xq):
        _build.check(fn(P(xq), P(w_q), P(sx), P(w_scale), P(bias), P(y), m, n, k,
                        _build.dtype_code(dtype), _build.stream_ptr(xq)), "stk_w8a8_matmul")
    _count.launched("w8a8_matmul", (m, k, n))
    return y
