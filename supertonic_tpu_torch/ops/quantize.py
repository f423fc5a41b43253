"""Per-token activation quantization of the W8A8 linears: the CUDA kernel
``csrc/quantize.cu`` and its plain PyTorch version.

The first half of the JAX package's ``_linear_w8a8``
(``supertonic_tpu/models/layers.py``), which leaves it to XLA; in the port
it is the W8A8 linear's own prologue, before the int8 product
(``ops/w8a8.py``):

    quantize_rows(x [M, K] f32 or bf16) -> (xq [M, K] int8, sx [M] f32)
    sx = max(amax_k |x|, 1e-12) / 127;  xq = round_half_even(x / sx)

bit for bit the same on the card and on the CPU. What bounds the kernel on
the H100 and what its design does about it is in the header of
``csrc/quantize.cu``.

``quantize_rows`` is the wrapper: plain version for CPU tensors only; CUDA
tensors go to the kernel, or it raises.
"""

from __future__ import annotations

import ctypes

import torch

from . import _build, _count

# x, xq, sx, M, K, dtype code, stream
_ARGTYPES = [ctypes.c_void_p] * 3 + [ctypes.c_int] * 3 + [ctypes.c_void_p]

K_MULTIPLE = 8  # the kernel reads 16-byte chunks of bf16


def quantize_rows_plain(x):
    """Plain PyTorch version, in the JAX ``_linear_w8a8``'s order:
    per-row symmetric quantization, round half to even (as ``jnp.round``)."""
    xf = x.float()
    amax = torch.clamp(xf.abs().amax(-1), min=1e-12)
    # a tensor divisor: CUDA divides by a Python scalar as a product with
    # its reciprocal, which can be an ulp off and flip a rounding below
    sx = amax / amax.new_full((), 127.0)
    xq = torch.round(xf / sx[:, None]).to(torch.int8)  # |xf / sx| <= 127
    return xq, sx


def quantize_rows(x):
    """x [M, K] float32 or bfloat16 -> (xq [M, K] int8, sx [M] float32)."""
    if x.dim() != 2:
        raise ValueError(f"x must be [M, K], got {tuple(x.shape)}")
    if x.dtype not in (torch.float32, torch.bfloat16):
        raise TypeError(f"x must be float32 or bfloat16, got {x.dtype}")
    if x.device.type == "cpu":
        return quantize_rows_plain(x)
    if x.device.type != "cuda":
        raise ValueError(f"unsupported device {x.device}")
    m, k = x.shape
    if m < 1 or k < K_MULTIPLE or k % K_MULTIPLE:
        raise ValueError(f"the quantize kernel takes M >= 1 and K a positive multiple "
                         f"of {K_MULTIPLE}, got M={m}, K={k}")
    if not x.is_contiguous() or x.data_ptr() % 16:
        raise ValueError("x must be contiguous and 16-byte aligned")
    xq = torch.empty((m, k), device=x.device, dtype=torch.int8)
    sx = torch.empty((m,), device=x.device, dtype=torch.float32)
    fn = _build.function("quantize", "stk_quantize_rows", _ARGTYPES)
    with _build.on(x):
        _build.check(fn(_build.ptr(x), _build.ptr(xq), _build.ptr(sx), m, k,
                        _build.dtype_code(x.dtype), _build.stream_ptr(x)), "stk_quantize_rows")
    _count.launched("quantize", (m, k))
    return xq, sx
