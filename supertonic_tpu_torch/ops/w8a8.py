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
    silu=True: F.silu of that, rounded to dtype once more (the FFN's first
               linear: ``jax.nn.silu(_linear_w8a8(...))``)
    silu=True, quantize=True (bf16): that output's rows as the FFN-out's
               quantize pass makes them, (hq [M, N] int8, hs [M] f32),
               ``quantize_rows_plain`` of the silu form: the bf16 [M, N]
               activation is never stored
    rope=(cos, sin [B, T, Dh / 2] f32), n_heads=H, M = B T:
        the rotated heads [B, T, H, Dh] of that (bf16): a Q or K projection,
        ``apply_rope(_split_heads(_linear_w8a8(p, x)), cos, sin)``
        (supertonic_tpu/models/layers.py:292-294, :317-323, :346-349):
        ``rope.bias_rope_plain(y, None, cos, sin, H)`` of the product y
    residual=r [B, T, N], gate=g [B, 1, N] or None, M = B T:
        r + g * that [B, T, N] (bf16): a sublayer's O or FFN-out,
        ``x + gate * _linear_w8a8(p, h)`` (layers.py:428, :433, :454):
        ``gated_residual.gated_residual_plain(r, y, None, g)``

bit for bit the same on the card and on the CPU, and no int32 [M, N] tensor
is written. The bias and silu forms are the int32 form's ``wgmma`` s8 GEMM
(``csrc/int8_matmul.cu``) with this epilogue in place of the int32 store;
what bounds it on the H100 and what its design does about it is in that
file's header. The rope and residual forms run the linear kernel's GEMM
(``csrc/linear.cu``, C entry ``stk_w8a8_epilogue``) with its s8 operand and
this rescale in place of JAX's bf16 bias rounding: the rotation or the gated
residual in the epilogue, in registers, as the bf16 linear's forms (``ops/
linear.py``) do it. The silu-quantize form runs that GEMM too, W's columns
resident, the blocks of a row block's column tiles one thread-block
cluster that exchanges the rows' partial maxima through distributed shared
memory (``stk_w8a8_silu_quantize``). Those forms take bf16 results alone:
an f32 W8A8 linear (a test route; the engine's int8 path runs bf16
activations) and a
sharded one (``layers.col_linear`` / ``row_linear``) keep the product, then
``rope.bias_rope`` or ``gated_residual.gated_residual``.

``w8a8_matmul`` is the wrapper: plain version for CPU tensors only; CUDA
tensors go to the kernel, or it raises.
"""

from __future__ import annotations

import ctypes

import torch
import torch.nn.functional as F

from . import _build, _count
from .gated_residual import batch_rows, gated_residual_plain
from .int8_matmul import K_MULTIPLE, int8_matmul_plain
from .linear import FORMS, _check_forms
from .linear import kernel_instance as linear_instance
from .quantize import quantize_rows_plain
from .rope import bias_rope_plain

# a, w, sx, w_scale, bias, y, M, N, K, dtype code, stream, silu
_ARGTYPES = [ctypes.c_void_p] * 6 + [ctypes.c_int] * 4 + [ctypes.c_void_p, ctypes.c_int]
# stk_w8a8_epilogue (csrc/linear.cu): xq, w_q, sx, w_scale, bias, cos, sin,
# residual, gate, gate batch stride, y, M, N, K, T, Dh, mode, stream
_EPI_ARGTYPES = ([ctypes.c_void_p] * 9 + [ctypes.c_longlong, ctypes.c_void_p]
                 + [ctypes.c_int] * 6 + [ctypes.c_void_p])
# stk_w8a8_silu_quantize (csrc/linear.cu): xq, w_q, sx, w_scale, bias, hq,
# hs, M, N, K, stream
_SQ_ARGTYPES = [ctypes.c_void_p] * 7 + [ctypes.c_int] * 3 + [ctypes.c_void_p]
SQ_BN = 128         # the silu-quantize form's columns a block of its cluster
SQ_MAX_BLOCKS = 16  # blocks a cluster: N up to 2,048
SQ_MAX_K = 512     # W's columns resident in a block's shared memory


def supports_silu_quantize(n: int, k: int) -> bool:
    """Whether the silu-quantize form takes N outputs of K inputs: N a
    multiple of ``SQ_BN`` up to ``SQ_MAX_BLOCKS`` of them, K a multiple of 32
    up to ``SQ_MAX_K``."""
    return (SQ_BN <= n <= SQ_BN * SQ_MAX_BLOCKS and n % SQ_BN == 0
            and K_MULTIPLE <= k <= SQ_MAX_K and k % K_MULTIPLE == 0)


def kernel_instance(m: int, k: int, n: int, form: str, dh: int = 0) -> str:
    """The instance the rope or residual form (``form``; "rope" with heads
    of ``dh``) takes at M x K x N on the current card: the linear kernel's
    choice for the same form (``linear.kernel_instance``; the W8A8 forms
    share its rule), where its "bf16_many" is the W8A8 rope form's own 128
    x 128 tiles of two consumers with 4 ring stages, "rope_many" (builds the
    library on first use)."""
    if form not in ("rope", "residual"):
        raise ValueError(f"the W8A8 product's forms here are rope and residual, got {form}")
    name = linear_instance(m, k, n, form, dh)
    return "rope_many" if name == "bf16_many" else name


def w8a8_matmul_plain(xq, sx, w_q, w_scale, bias, dtype, *, silu: bool = False, rope=None,
                      n_heads: int = 0, residual=None, gate=None, quantize: bool = False):
    """Plain PyTorch version: the exact product, then the rescale and bias
    in f32 in the JAX ``_linear_w8a8``'s order, one rounding to dtype; then
    F.silu with ``silu`` (and ``quantize_rows_plain`` of it with
    ``quantize``), ``bias_rope_plain`` with ``rope``, or
    ``gated_residual_plain`` with ``residual``."""
    if quantize:
        return quantize_rows_plain(w8a8_matmul_plain(xq, sx, w_q, w_scale, bias, dtype,
                                                     silu=True))
    acc = int8_matmul_plain(xq, w_q)
    y = acc.float() * sx[:, None] * w_scale
    y = (y + bias).to(dtype)
    if rope is not None:
        return bias_rope_plain(y.view(*rope[0].shape[:2], -1), None, *rope, n_heads)
    if residual is not None:
        return gated_residual_plain(residual, y.view(residual.shape), None, gate)
    return F.silu(y) if silu else y


def _batch_shape(m, rope, residual):
    """(B, T) of the rope or residual form's operands, which must hold M
    rows; None without those forms."""
    if rope is None and residual is None:
        return None
    ref = rope[0] if rope is not None else residual
    if ref.dim() != 3 or ref.shape[0] * ref.shape[1] != m:
        raise ValueError(f"the rope and residual forms take [B, T, ...] operands of B T = M "
                         f"= {m} rows, got {tuple(ref.shape)}")
    return tuple(ref.shape[:2])


def w8a8_matmul(xq, sx, w_q, w_scale, bias, dtype, *, silu: bool = False, rope=None,
                n_heads: int = 0, residual=None, gate=None, quantize: bool = False):
    """xq [M, K] int8, sx [M], w_q [N, K] int8, w_scale [N], bias [N]
    (float32) -> [M, N] in dtype (float32 or bfloat16); with ``silu``, F.silu
    of it; with ``rope`` = (cos, sin [B, T, Dh / 2] f32) and ``n_heads``
    (M = B T), the rotated heads [B, T, H, Dh]; with ``residual`` [B, T, N]
    (and ``gate`` [B, 1, N] or [1, 1, N]), residual + gate * product [B, T,
    N]; with ``silu`` and ``quantize``, the silu form's rows quantized,
    (hq [M, N] int8, hs [M] f32). One form at a time. On the card the rope,
    residual and silu-quantize forms take bfloat16 alone (an f32 or sharded
    W8A8 linear runs the product, then ``rope.bias_rope`` or
    ``gated_residual.gated_residual``), the last at the shapes
    ``supports_silu_quantize`` takes."""
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
    if quantize and not silu:
        raise ValueError("the quantizing form is the silu form's")
    bt = _batch_shape(m, rope, residual)
    gstride = 0
    if bt is not None or gate is not None:
        lead = (1, m) if bt is None else bt
        gate, gstride = _check_forms(xq.view(*lead, k), n, silu, None, rope, n_heads, residual,
                                     gate)
    if xq.device.type == "cpu":
        return w8a8_matmul_plain(xq, sx, w_q, w_scale, bias, dtype, silu=silu, rope=rope,
                                 n_heads=n_heads, residual=residual, gate=gate,
                                 quantize=quantize)
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
    if bt is not None:
        return _epilogue_form(xq, sx, w_q, w_scale, bias, dtype, bt, rope, n_heads, residual,
                              gate, gstride)
    if quantize:
        return _silu_quantize(xq, sx, w_q, w_scale, bias, dtype)
    y = torch.empty((m, n), device=xq.device, dtype=dtype)
    fn = _build.function("int8_matmul", "stk_w8a8_matmul", _ARGTYPES)
    P = _build.ptr
    with _build.on(xq):
        _build.check(fn(P(xq), P(w_q), P(sx), P(w_scale), P(bias), P(y), m, n, k,
                        _build.dtype_code(dtype), _build.stream_ptr(xq), int(silu)),
                     "stk_w8a8_matmul")
    _count.launched("w8a8_matmul", (m, k, n))
    return y


def _epilogue_form(xq, sx, w_q, w_scale, bias, dtype, bt, rope, n_heads, residual, gate, gstride):
    """The rope or residual form on the card (operands checked by
    ``w8a8_matmul``): one launch of ``stk_w8a8_epilogue``."""
    if dtype != torch.bfloat16:
        raise TypeError(f"the W8A8 rope and residual forms take bfloat16 results, got {dtype} "
                        f"(an f32 W8A8 linear runs the product, then the rotation or the "
                        f"gated residual)")
    if any(t.dtype != torch.float32 for t in rope or ()):
        raise TypeError("cos and sin must be float32")
    if any(t is not None and t.dtype != torch.bfloat16 for t in (residual, gate)):
        raise TypeError("the residual and the gate must be bfloat16")
    m, k = xq.shape
    n = w_q.shape[0]
    cos, sin = (t.contiguous() for t in rope) if rope is not None else (None, None)
    # cos, sin and the residual are read 8 or 16 bytes at a time (the
    # residual by TMA); the gate by 4-byte pairs
    for name, t in (("cos", cos), ("sin", sin), ("residual", residual)):
        if t is not None and (t.device != xq.device or not t.is_contiguous()
                              or t.data_ptr() % 16):
            raise ValueError(f"{name} must be contiguous, 16-byte aligned and on {xq.device}")
    if gate is not None:
        if gate.device != xq.device:
            raise ValueError(f"gate must be on {xq.device}")
        if n % 2 == 0 and (gate.data_ptr() % 4 or gstride % 2):
            gate, gstride = batch_rows(gate.clone(memory_format=torch.contiguous_format),
                                       bt[0], n, "gate")
    form = "rope" if rope is not None else "residual"
    dh = n // n_heads if form == "rope" else 0
    y = torch.empty((*bt, n), device=xq.device, dtype=torch.bfloat16)
    fn = _build.function("linear", "stk_w8a8_epilogue", _EPI_ARGTYPES)
    P = _build.ptr
    with _build.on(xq):
        _build.check(fn(P(xq), P(w_q), P(sx), P(w_scale), P(bias), P(cos), P(sin), P(residual),
                        P(gate), gstride, P(y), m, n, k, bt[1], dh, FORMS.index(form),
                        _build.stream_ptr(xq)), "stk_w8a8_epilogue")
    # the key as the linear kernel's: the rope form's holds Dh, the residual
    # form's the gate's rows a batch row (0 without a gate)
    _count.launched("w8a8_matmul", (m, k, n, form, dh if form == "rope" else
                                    bt[1] if gate is not None else 0))
    return y.view(*bt, n_heads, dh) if form == "rope" else y


def _silu_quantize(xq, sx, w_q, w_scale, bias, dtype):
    """The silu-quantize form on the card (operands checked by
    ``w8a8_matmul``): one launch of ``stk_w8a8_silu_quantize``."""
    m, k = xq.shape
    n = w_q.shape[0]
    if dtype != torch.bfloat16:
        raise TypeError(f"the W8A8 silu-quantize form quantizes bfloat16 rows, got {dtype}")
    if not supports_silu_quantize(n, k):
        raise ValueError(f"the W8A8 silu-quantize form takes N a multiple of {SQ_BN} up to "
                         f"{SQ_BN * SQ_MAX_BLOCKS} and K a multiple of {K_MULTIPLE} up to "
                         f"{SQ_MAX_K}, got N={n}, K={k}")
    hq = torch.empty((m, n), device=xq.device, dtype=torch.int8)
    hs = torch.empty((m,), device=xq.device, dtype=torch.float32)
    fn = _build.function("linear", "stk_w8a8_silu_quantize", _SQ_ARGTYPES)
    P = _build.ptr
    with _build.on(xq):
        _build.check(fn(P(xq), P(w_q), P(sx), P(w_scale), P(bias), P(hq), P(hs), m, n, k,
                        _build.stream_ptr(xq)), "stk_w8a8_silu_quantize")
    _count.launched("w8a8_matmul", (m, k, n, "silu_quantize", 0))
    return hq, hs
