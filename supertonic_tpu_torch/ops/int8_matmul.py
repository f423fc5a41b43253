"""int8 x int8 -> int32 matrix product: the CUDA kernel ``csrc/int8_matmul.cu``
and its plain PyTorch version.

Replaces ``tools/int8_microbench.py:_pallas_i8_matmul``, the Pallas int8
product behind the JAX package's W8A8 ``linear`` (``_linear_w8a8``, which
leaves the same product to XLA's ``dot_general``). Contract, in torch's
linear layout (``QLinear.w_q`` is [dout, din]):

    int8_matmul(a [M, K] int8, w [N, K] int8) -> a . w^T  [M, N] int32

exact integer sums, any M >= 1 and N >= 1, K a multiple of 32 on the card.
The W8A8 path takes the same kernel with its rescale-and-bias epilogue
(``ops/w8a8.py``), which writes the linear's output instead of the int32
sums; this int32 form is the direct port of the Pallas kernel, and the TP
int8 path's product (the row-parallel linears sum its exact partials).

The kernel is ``wgmma`` s8 fed by a TMA ring (csrc/wgmma_gemm.cuh), its
tile chosen by the library from the shape (``kernel_tiles``): what bounds
it on the H100 and what its design does about it is in the header of
``csrc/int8_matmul.cu``.

``int8_matmul`` is the wrapper: plain version for CPU tensors only; CUDA
tensors go to the kernel, or it raises.
"""

from __future__ import annotations

import ctypes

import torch

from . import _build, _count

# a, w, c, M, N, K, stream
_ARGTYPES = [ctypes.c_void_p] * 3 + [ctypes.c_int] * 3 + [ctypes.c_void_p]

K_MULTIPLE = 32  # the depth of one wgmma m64nNk32 s8 product (32 bytes)


def kernel_tiles() -> dict:
    """The library's instances (rows, columns, ring stages) for bf16 and for
    4-byte results, at many tiles, at few and at an N whose rows no TMA map
    takes (builds the library on first use)."""
    t = (ctypes.c_int * 18)()
    _build.function("int8_matmul", "stk_int8_tiles", [ctypes.c_void_p])(t)
    names = [f"{out}_{case}" for out in ("bf16", "4-byte")
             for case in ("many_tiles", "few_tiles", "any_n")]
    return {name: tuple(t[3 * i:3 * i + 3]) for i, name in enumerate(names)}


def int8_matmul_plain(a, w):
    """Plain PyTorch version. The sums run in float64, exact because
    |sum| <= 127^2 * K < 2^53 (float32 is not once 127^2 * K passes 2^24,
    above K = 1040), and torch has no int32 matrix product on the card."""
    return (a.double() @ w.double().t()).to(torch.int32)


def int8_matmul(a, w):
    """a [M, K] int8, w [N, K] int8 -> [M, N] int32."""
    if a.dim() != 2 or w.dim() != 2 or a.shape[1] != w.shape[1]:
        raise ValueError(f"a must be [M, K] and w [N, K], got {tuple(a.shape)} "
                         f"and {tuple(w.shape)}")
    if a.dtype != torch.int8 or w.dtype != torch.int8:
        raise TypeError(f"a and w must be int8, got {a.dtype} and {w.dtype}")
    if a.device.type == "cpu":
        return int8_matmul_plain(a, w)
    if a.device.type != "cuda":
        raise ValueError(f"unsupported device {a.device}")
    m, k = a.shape
    n = w.shape[0]
    if m < 1 or n < 1 or k < K_MULTIPLE or k % K_MULTIPLE:
        raise ValueError(f"the int8 kernel takes M, N >= 1 and K a positive "
                         f"multiple of {K_MULTIPLE}, got M={m}, N={n}, K={k}")
    for name, t in (("a", a), ("w", w)):
        if not t.is_contiguous() or t.device != a.device or t.data_ptr() % 16:
            raise ValueError(f"{name} must be contiguous, 16-byte aligned and "
                             f"on {a.device}")
    out = torch.empty((m, n), device=a.device, dtype=torch.int32)
    fn = _build.function("int8_matmul", "stk_int8_matmul", _ARGTYPES)
    with _build.on(a):
        _build.check(fn(_build.ptr(a), _build.ptr(w), _build.ptr(out), m, n, k,
                        _build.stream_ptr(a)), "stk_int8_matmul")
    _count.launched("int8_matmul", (m, k, n))
    return out
