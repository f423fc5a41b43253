"""One conv1d with the elementwise ops around it: the CUDA kernel
``csrc/conv1d.cu`` and its plain PyTorch version.

The fusion XLA makes of the JAX package's ``layers.conv1d``
(``supertonic_tpu/models/layers.py:127-145``: layout NHC, weights HIO, f32
accumulation, the f32 bias added before one rounding) with what its callers
do around it: the vocoder's pre conv and mask, its up convs with silu,
depth-to-space and mask, its head with silu and tanh, each conv of
``_resblock`` (``supertonic_tpu/models/vocoder.py:41-52``, ``:160-177``),
and the text encoder's prenet (``supertonic_tpu/models/text_encoder.py:55-56``):

    conv1d_fused(x [B, T, Cin], w [k, Cin, Cout] (HIO), bias [Cout] f32, *,
                 dilation, silu_in, silu_out, mask, fold, residual, tanh_f32, int16)

        s = silu(x) rounded to x's type            (silu_in)
        y = round(conv_{k, dilation}(s) + bias)    f32 sums, SAME zero padding
        y = silu(y) rounded                        (silu_out)
        y = round(y * mask)                        (mask [T * fold] or [B, T * fold])
        y = round(residual + y)                    (residual [B, T, Cout])
        tanh(y) in f32                             (tanh_f32: an f32 result)
        clamp(tanh(y) * 32767, -32768, 32767)      (int16, with tanh_f32: the
            truncated to int16                      engine's int16 egress)

``fold = f`` reads the output [B, T, Cout] as [B, T * f, Cout / f] for the
mask (the vocoder's depth-to-space, a view of the same memory): column n of
frame t is fine frame ``t * f + n // (Cout / f)``. Silu is ``v * sigmoid(v)``
in f32, rounded once, as ``vocoder_fused._silu_rounded``; the mask is 0/1.

Tolerance of the kernel against the plain version: in f32 the sums run in
another order (``F32_RTOL``); in bf16 the f32 sums of the kernel and of the
plain version's convolution round apart where a sum lies within its order's
noise of a rounding boundary, so the conv's output may move by one bf16
step, and what follows it by what silu, the residual's rounding and tanh
make of that step (``bf16_within``).

The kernel takes any Cin, Cout, size, dilation and masked fold in f32 and
bf16 (``supports`` checks only that the shape is one); its bf16 weights
come in rows of Cout rounded up to 8 elements (``weight_buffer``).
``conv1d_fused`` is the wrapper: plain version for CPU tensors only; CUDA
tensors go to the kernel, or it raises.
"""

from __future__ import annotations

import ctypes

import torch
import torch.nn.functional as F

from . import _build, _count
from .vocoder_fused import _silu_rounded

F32_RTOL = 1e-5  # the kernel against the plain version in f32, relative

# x, w, bias, mask, mask batch stride, residual, out, B, T, Cin, Cout, k,
# dilation, silu_in, silu_out, fold, tanh_f32, dtype code, stream, int16
_ARGTYPES = ([ctypes.c_void_p] * 4 + [ctypes.c_longlong] + [ctypes.c_void_p] * 2
             + [ctypes.c_int] * 11 + [ctypes.c_void_p, ctypes.c_int])


def supports(cin: int, cout: int, k: int, dilation: int, dtype: torch.dtype) -> bool:
    """Whether the kernel takes a conv of ``cin`` -> ``cout`` channels,
    size ``k`` and ``dilation`` in ``dtype``: any of each at least 1, in
    float32 or bfloat16."""
    return (min(cin, cout, k, dilation) >= 1
            and dtype in (torch.float32, torch.bfloat16))


def weight_rows(cout: int, dtype: torch.dtype) -> int:
    """Elements between the kernel's weight rows: Cout, rounded up to 8 in
    bf16 (a TMA map's rows are multiples of 16 bytes)."""
    return -(-cout // 8) * 8 if dtype == torch.bfloat16 else cout


def weight_buffer(k: int, cin: int, cout: int, dtype: torch.dtype, device) -> torch.Tensor:
    """An empty [k, Cin, Cout] weight in the kernel's layout: a view of
    [k, Cin, weight_rows(Cout)] rows where Cout is padded (the pad columns
    zero), else a contiguous tensor."""
    rows = weight_rows(cout, dtype)
    if rows == cout:
        return torch.empty((k, cin, cout), dtype=dtype, device=device)
    return torch.zeros((k, cin, rows), dtype=dtype, device=device)[..., :cout]


def options(*, silu_in=False, silu_out=False, mask=None, fold=1, residual=None,
            tanh_f32=False, int16=False, batch=1) -> str:
    """The options of one call as the launch tallies name them, e.g.
    "silu_in+mask+residual" ("mask" a [T] mask, "row_mask" a [B, T] one,
    "fold8" the up convs' depth-to-space; "" for none)."""
    parts = ["silu_in"] * silu_in + ["silu_out"] * silu_out
    if mask is not None:
        parts.append("row_mask" if mask.dim() == 2 and mask.shape[0] == batch > 1 else "mask")
    if fold != 1:
        parts.append(f"fold{fold}")
    parts += ["residual"] * (residual is not None) + ["tanh"] * tanh_f32 + ["int16"] * int16
    return "+".join(parts)


def encode_int16(wav):
    """The int16 egress of f32 samples: clamp(wav * 32767, -32768, 32767),
    truncated (the engine's ``encode_egress(wav, "int16")``)."""
    return torch.clamp(wav * 32767.0, -32768.0, 32767.0).to(torch.int16)


def conv1d_fused_plain(x, w, bias, *, dilation=1, silu_in=False, silu_out=False, mask=None,
                       fold=1, residual=None, tanh_f32=False, int16=False):
    """Plain PyTorch version, with the JAX package's rounding points. Any
    kernel size (an even one pads (k - 1) // 2 frames on the left)."""
    dt = x.dtype
    b, t, _ = x.shape
    k, _, cout = w.shape
    total = dilation * (k - 1)
    s = _silu_rounded(x) if silu_in else x
    h = F.pad(s.float().transpose(1, 2), (total // 2, total - total // 2))
    y = F.conv1d(h, w.float().permute(2, 1, 0), dilation=dilation).transpose(1, 2)
    y = (y + bias.float()).to(dt).contiguous()  # the kernel's [B, T, Cout] rows
    if silu_out:
        y = _silu_rounded(y)
    if mask is not None:
        m = mask.reshape(-1, t * fold, 1).to(dt)
        y = (y.reshape(b, t * fold, cout // fold) * m).reshape(b, t, cout)
    if residual is not None:
        y = residual + y
    if not tanh_f32:
        return y
    return encode_int16(torch.tanh(y.float())) if int16 else torch.tanh(y.float())


def bf16_within(got, x, w, bias, **kw) -> tuple[float, bool]:
    """For a bf16 ``got``: (share of elements bit-equal to the plain
    version, whether every element lies within 2^-5 of the conv's rounded
    output v and 2^-7 of the result of it), the kernel's tolerance in bf16.
    Sums in two orders can round v one bf16 step (at most 2^-7 |v|) apart;
    silu_out moves that by at most 1.1 times and rounds again (|silu v| <=
    |v|), the residual's sum rounds once more (2^-7 of the result); the mask
    is exact, tanh does not widen it. A floor of 2^-16 of the largest |v|
    holds sums that cancel to far below their terms."""
    want = conv1d_fused_plain(x, w, bias, **kw).float()
    v = conv1d_fused_plain(x, w, bias, **{**kw, "silu_out": False, "residual": None,
                                          "tanh_f32": False, "int16": False}).float().abs()
    err = (got.float() - want).abs()
    floor = 2.0 ** -16 * float(v.max())
    ok = bool((err <= 2.0 ** -5 * v + 2.0 ** -7 * want.abs() + floor).all())
    return float((err == 0).float().mean()), ok


def conv1d_fused(x, w, bias, *, dilation: int = 1, silu_in: bool = False,
                 silu_out: bool = False, mask=None, fold: int = 1, residual=None,
                 tanh_f32: bool = False, int16: bool = False):
    """x [B, T, Cin] -> [B, T, Cout] in x's type (f32 with ``tanh_f32``,
    int16 with ``int16`` too); see the module docstring. ``mask``: [T *
    fold], [1, T * fold] or [B, T * fold], any float type (0/1)."""
    if x.dim() != 3 or w.dim() != 3 or w.shape[1] != x.shape[2]:
        raise ValueError(f"x must be [B, T, Cin] and w [k, Cin, Cout], got {tuple(x.shape)} "
                         f"and {tuple(w.shape)}")
    b, t, cin = x.shape
    k, _, cout = w.shape
    if tuple(bias.shape) != (cout,):
        raise ValueError(f"bias must be [Cout] = [{cout}], got {tuple(bias.shape)}")
    if fold < 1 or cout % fold:
        raise ValueError(f"fold {fold} must divide Cout {cout}")
    if mask is not None:
        if mask.dim() == 1:
            mask = mask[None]
        if mask.dim() != 2 or mask.shape[1] != t * fold or mask.shape[0] not in (1, b):
            raise ValueError(f"mask must be [T * fold] or [B, T * fold] = [{b}, {t * fold}], "
                             f"got {tuple(mask.shape)}")
    if int16 and not tanh_f32:
        raise ValueError("int16 egress follows the head's tanh: it takes tanh_f32")
    if residual is not None and tuple(residual.shape) != (b, t, cout):
        raise ValueError(f"residual must be [B, T, Cout] = {(b, t, cout)}, got "
                         f"{tuple(residual.shape)}")
    kw = dict(dilation=dilation, silu_in=silu_in, silu_out=silu_out, mask=mask, fold=fold,
              residual=residual, tanh_f32=tanh_f32, int16=int16)
    if x.device.type == "cpu":
        return conv1d_fused_plain(x, w, bias, **kw)
    if x.device.type != "cuda":
        raise ValueError(f"unsupported device {x.device}")
    if not supports(cin, cout, k, dilation, x.dtype):
        raise ValueError(f"the conv1d kernel takes float32 or bfloat16 and sizes >= 1; got "
                         f"Cin {cin}, Cout {cout}, k {k}, dilation {dilation}, {x.dtype}")
    if w.dtype != x.dtype or (residual is not None and residual.dtype != x.dtype):
        raise TypeError(f"w and residual must be in x's type {x.dtype}")
    if bias.dtype != torch.float32:
        raise TypeError("bias must be float32")
    rows = weight_rows(cout, x.dtype)
    if w.stride() != (cin * rows, rows, 1) and w.is_contiguous():
        w = weight_buffer(k, cin, cout, x.dtype, w.device).copy_(w)  # bf16 rows padded
    if w.device != x.device or w.stride() != (cin * rows, rows, 1) or w.data_ptr() % 16:
        raise ValueError(f"w must be on {x.device}, 16-byte aligned, in rows of {rows} "
                         f"elements (weight_buffer)")
    for name, p in (("x", x), ("bias", bias), ("residual", residual)):
        if p is not None and (p.device != x.device or not p.is_contiguous()
                              or p.data_ptr() % 16):
            raise ValueError(f"{name} must be contiguous, 16-byte aligned and on {x.device}")
    mstride = 0
    if mask is not None:
        mask = mask.to(device=x.device, dtype=torch.float32).contiguous()
        mstride = mask.shape[1] if mask.shape[0] > 1 else 0
    out = torch.empty((b, t, cout), device=x.device,
                      dtype=torch.int16 if int16 else torch.float32 if tanh_f32 else x.dtype)
    fn = _build.function("conv1d", "stk_conv1d", _ARGTYPES)
    P = _build.ptr
    with _build.on(x):
        _build.check(fn(P(x), P(w), P(bias), P(mask), mstride, P(residual), P(out), b, t, cin,
                        cout, k, dilation, int(silu_in), int(silu_out), fold, int(tanh_f32),
                        _build.dtype_code(x.dtype), _build.stream_ptr(x), int(int16)),
                     "stk_conv1d")
    del kw["dilation"]
    _count.launched("conv1d", (b, t, cin, cout, k, dilation, options(**kw, batch=b)))
    return out
