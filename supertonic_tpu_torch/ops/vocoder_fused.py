"""Fused dilated-resblock chain of the vocoder's fine timelines: the CUDA
kernel ``csrc/resblock_chain.cu`` and its plain PyTorch version.

Replaces ``supertonic_tpu/ops/vocoder_fused.py:_kernel``
(``resblock_chain``/``fused_resblock``). For each dilation d_i:

    h = mask * round(conv_{k,d_i}(silu x) + ba_i)
    x = x + mask * round(conv_{k,1}(silu h) + bb_i)

silu in f32 rounded to the storage dtype, convs accumulated in f32 with the
bias added in f32, rounded to the storage dtype, then the 0/1 frame mask;
the residual add in the storage dtype. The frame mask is the batch-shared
[T] mask (None = all frames real); SAME zero padding at the sequence
edges, so positions outside [0, T) and masked frames are exactly zero
after every conv.

What bounds the kernel on the H100 and what its design does about it is in
the header of ``csrc/resblock_chain.cu``, which also chooses the kernel's
time tiling (each block holds ``tile + 2*halo`` frames; ``chain_tile`` asks
the kernel's library for ``tile``).

``resblock_chain`` is the wrapper: plain version for CPU tensors only; CUDA
tensors go to the kernel, or it raises.
"""

from __future__ import annotations

import ctypes

import torch
import torch.nn.functional as F

from . import _build, _count

# x, frame_mask, wa, ba, wb, bb, out, B, T, C, P, dilations, dtype code,
# stream
_ARGTYPES = ([ctypes.c_void_p] * 7 + [ctypes.c_int] * 4
             + [ctypes.c_void_p, ctypes.c_int, ctypes.c_void_p])


def chain_halo(kernel: int, dilations) -> int:
    """One-sided receptive field of the dilated(a)+plain(b) conv chain."""
    half = (kernel - 1) // 2
    return sum(d * half + half for d in dilations)


def _dils(dilations):
    dilations = tuple(int(d) for d in dilations)
    return dilations, (ctypes.c_int * len(dilations))(*dilations)


def chain_tile(channels: int, dtype: torch.dtype, dilations) -> int:
    """Output frames per block that the CUDA kernel uses (builds it)."""
    dilations, dils = _dils(dilations)
    fn = _build.function("resblock_chain", "stk_resblock_chain_tile",
                         [ctypes.c_int, ctypes.c_int, ctypes.c_void_p, ctypes.c_int])
    tile = fn(channels, len(dilations), ctypes.cast(dils, ctypes.c_void_p),
              _build.dtype_code(dtype))
    if tile <= 0:
        raise ValueError(f"no chain tiling for C={channels}, {dtype}, "
                         f"dilations {dilations}")
    return tile


def _silu_rounded(v: torch.Tensor) -> torch.Tensor:
    vf = v.float()
    return (vf * torch.sigmoid(vf)).to(v.dtype)


def resblock_chain_plain(x, frame_mask, wa, ba, wb, bb, dilations):
    """Plain PyTorch version, with the kernel's rounding points.
    x [B,T,C]; frame_mask [T] or None; wa/wb [P,k,C,C] HIO; ba/bb [P,C]."""
    dt = x.dtype
    t_len = x.shape[1]
    m = (torch.ones(t_len, device=x.device) if frame_mask is None
         else frame_mask.float())
    m = m.to(dt)[None, :, None]
    k = wa.shape[1]

    def conv(v, w, b, d):
        pad = d * (k - 1) // 2
        y = F.conv1d(v.float().transpose(1, 2), w.float().permute(2, 1, 0),
                     b.float(), padding=pad, dilation=d)
        return y.transpose(1, 2).to(dt) * m

    for i, d in enumerate(dilations):
        h = conv(_silu_rounded(x), wa[i], ba[i], d)
        h = conv(_silu_rounded(h), wb[i], bb[i], 1)
        x = x + h
    return x


def resblock_chain(x, frame_mask, wa, ba, wb, bb, dilations):
    """x [B,T,C] -> [B,T,C] in x's dtype (see the module docstring)."""
    b, t_len, c = x.shape
    p, k = wa.shape[0], wa.shape[1]
    dilations, dils = _dils(dilations)
    if (tuple(wa.shape) != (p, k, c, c) or wb.shape != wa.shape
            or tuple(ba.shape) != (p, c) or bb.shape != ba.shape
            or len(dilations) != p):
        raise ValueError("chain weights must be [P,k,C,C], biases [P,C], "
                         "one dilation per conv pair")
    if frame_mask is not None and tuple(frame_mask.shape) != (t_len,):
        raise ValueError(f"frame_mask must be [T] = ({t_len},), got "
                         f"{tuple(frame_mask.shape)}")
    if x.device.type == "cpu":
        return resblock_chain_plain(x, frame_mask, wa, ba, wb, bb, dilations)
    if x.device.type != "cuda":
        raise ValueError(f"unsupported device {x.device}")
    if k != 3 or c not in (128, 256) or not 1 <= p <= 4 or min(dilations) < 1:
        raise ValueError(f"the chain kernel takes k=3, C in (128, 256) and up "
                         f"to 4 conv pairs with dilations >= 1, got k={k}, "
                         f"C={c}, P={p}, dilations {dilations}")
    if wa.dtype != x.dtype or wb.dtype != x.dtype:
        raise TypeError("wa and wb must be in x's dtype")
    for name, tns in (("x", x), ("wa", wa), ("wb", wb)):
        if not tns.is_contiguous() or tns.device != x.device or tns.data_ptr() % 16:
            raise ValueError(f"{name} must be contiguous, 16-byte aligned and on "
                             f"{x.device}")

    def f32(v):
        return None if v is None else v.to(device=x.device,
                                           dtype=torch.float32).contiguous()

    fm, baf, bbf = f32(frame_mask), f32(ba), f32(bb)
    out = torch.empty_like(x)
    fn = _build.function("resblock_chain", "stk_resblock_chain", _ARGTYPES)
    P = _build.ptr
    _build.check(fn(P(x), P(fm), P(wa), P(baf), P(wb), P(bbf), P(out), b, t_len,
                    c, p, ctypes.cast(dils, ctypes.c_void_p),
                    _build.dtype_code(x.dtype), _build.stream_ptr(x)),
                 "stk_resblock_chain")
    _count.launched("resblock_chain", (b, t_len, c))
    return out


def stack_resblock(params, dtype) -> tuple[torch.Tensor, ...]:
    """Stack a vocoder resblock module ({"convs": [{"a", "b"}, ...]}, conv
    weights [cout, cin, k]) into the kernel's [P, k, C, C] HIO weights in
    ``dtype`` and [P, C] f32 biases."""
    convs = params["convs"]
    wa = torch.stack([cp["a"].weight.permute(2, 1, 0) for cp in convs]).to(dtype)
    wb = torch.stack([cp["b"].weight.permute(2, 1, 0) for cp in convs]).to(dtype)
    ba = torch.stack([cp["a"].bias for cp in convs]).float()
    bb = torch.stack([cp["b"].bias for cp in convs]).float()
    return wa.contiguous(), ba, wb.contiguous(), bb


def fused_resblock(params, x, dilations, mask=None):
    """Drop-in for models.vocoder._resblock(params, x, dilations, mask) with
    the batch-shared mask [1, T, 1] (or None)."""
    wa, ba, wb, bb = stack_resblock(params, x.dtype)
    fm = None if mask is None else mask.reshape(mask.shape[-2])
    return resblock_chain(x, fm, wa, ba, wb, bb, dilations)
