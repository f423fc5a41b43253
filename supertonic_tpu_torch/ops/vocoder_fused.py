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
the header of ``csrc/resblock_chain.cu``, which also chooses the fused
kernels' time tiling (each block holds ``tile + 2*halo`` frames; ``_tile``
asks the kernel's library for ``tile`` at a launch's shape).

``supports`` states the kernel's domain: C <= ``MAX_CHANNELS`` (the Pallas
kernel's VMEM rule), an odd conv size, and any number of conv pairs with
any dilations >= 1. A fused launch takes up to ``MAX_PAIRS`` pairs whose
halo fits its tile (every pair that reaches at most ``MAX_PAIR_REACH``
frames fits alone: the library asserts it); the wrapper runs a longer
chain as consecutive launches over groups of pairs (``launch_plan``),
which gives the same values as one launch, and a pair that no fused
kernel tiles as two per-conv launches (conv a into a scratch, conv b onto
x) that keep no halo in shared memory. The kernel has one instance per C
in ``CHAIN_WIDTHS``; the wrapper pads another C with zero channels to the
next (``pad_channels``), which leaves the real channels as they are: zero
weights and biases keep the padded ones at exactly 0.

``resblock_chain`` is the wrapper: plain version for CPU tensors only; CUDA
tensors go to the kernel, or it raises.
"""

from __future__ import annotations

import ctypes
import functools

import torch
import torch.nn.functional as F

from . import _build, _count

# x, frame_mask, wa, ba, wb, bb, out, B, T, C, k, P, dilations, dtype code,
# stream
_ARGTYPES = ([ctypes.c_void_p] * 7 + [ctypes.c_int] * 5
             + [ctypes.c_void_p, ctypes.c_int, ctypes.c_void_p])
# in, x, frame_mask, w, bias, out, B, T, C, k, dilation, is conv b, dtype
# code, stream
_CONV_ARGTYPES = [ctypes.c_void_p] * 6 + [ctypes.c_int] * 7 + [ctypes.c_void_p]
MAX_CHANNELS = 384
CHAIN_WIDTHS = (64, 128, 192, 256, 320, 384)  # the kernel's instances
MAX_PAIRS = 4  # conv pairs a launch
# the largest reach of one conv pair, (d + 1) * (k - 1) / 2, that the fused
# kernels take alone at every instance (the library's MAX_REACH; phase 5 of
# chip_smoke.py reads it); a pair past it may run as two per-conv launches
MAX_PAIR_REACH = {torch.float32: 23, torch.bfloat16: 31}


def kernel_width(channels: int) -> int:
    """The instance that runs ``channels``: the next of CHAIN_WIDTHS."""
    return next(w for w in CHAIN_WIDTHS if w >= channels)


def pair_reach(kernel: int, dilation: int) -> int:
    """One-sided reach of a conv pair: conv a at ``dilation``, conv b at 1."""
    return (dilation + 1) * ((kernel - 1) // 2)


def supports(channels: int, kernel: int, dilations, dtype: torch.dtype | None = None) -> bool:
    """Whether the kernel takes a chain of ``channels`` with conv ``kernel``
    and ``dilations`` (one per conv pair) in ``dtype`` (None: both)."""
    dilations = tuple(int(d) for d in dilations)
    return (kernel >= 1 and kernel % 2 == 1 and bool(dilations) and min(dilations) >= 1
            and 1 <= channels <= MAX_CHANNELS
            and dtype in (None, torch.float32, torch.bfloat16))


def pad_channels(x, frame_mask, wa, ba, wb, bb, width: int):
    """The chain's arguments with C zero-padded to ``width`` channels."""
    c = x.shape[-1]
    p = width - c
    x = F.pad(x, (0, p)).contiguous()
    wa, wb = (F.pad(w, (0, p, 0, p)).contiguous() for w in (wa, wb))
    ba, bb = (F.pad(b, (0, p)).contiguous() for b in (ba, bb))
    return x, frame_mask, wa, ba, wb, bb


def chain_halo(kernel: int, dilations) -> int:
    """One-sided receptive field of the dilated(a)+plain(b) conv chain."""
    return sum(pair_reach(kernel, d) for d in dilations)


def _dils(dilations):
    dilations = tuple(int(d) for d in dilations)
    return dilations, (ctypes.c_int * len(dilations))(*dilations)


def _tile(width: int, kernel: int, dilations, dtype: torch.dtype, batch: int = 0,
          frames: int = 0) -> int:
    """Output frames a block of one fused launch (the tensor-core kernel in
    bf16, the SIMT kernel in f32), from the library: at ``batch`` x
    ``frames`` (where the bf16 kernel may take a smaller tile to fill the
    card), or with both 0 its largest tile; <= 0 when the fused kernel does
    not tile the launch."""
    dilations, dils = _dils(dilations)
    fn = _build.function("resblock_chain", "stk_resblock_chain_tile",
                         [ctypes.c_int] * 3 + [ctypes.c_void_p] + [ctypes.c_int] * 3)
    return fn(width, kernel, len(dilations), ctypes.cast(dils, ctypes.c_void_p),
              _build.dtype_code(dtype), batch, frames)


def kernel_layout(width: int, half: bool = False) -> dict:
    """The bf16 tensor-core kernel's layout at instance ``width``: of its
    largest tile, or with ``half`` of its instance at half the frames
    (builds the library)."""
    info = (ctypes.c_int * 7)()
    fn = _build.function("resblock_chain", "stk_resblock_chain_layout",
                         [ctypes.c_int, ctypes.c_int, ctypes.c_void_p])
    if fn(width, int(half), info) != 0:
        raise ValueError(f"no chain instance at C={width}{' (half)' if half else ''}")
    return dict(zip(("frames_per_block", "consumers", "m_tiles_per_consumer",
                     "panels_per_consumer", "channels_per_stage", "stages", "smem_bytes"), info))


def chain_tile(channels: int, dtype: torch.dtype, dilations, kernel: int = 3) -> int:
    """Output frames per block (the largest) that the fused CUDA kernel uses
    for a chain of ``channels`` in one launch (run by the ``kernel_width``
    instance; builds it)."""
    tile = _tile(kernel_width(channels), kernel, tuple(dilations), dtype)
    if tile <= 0:
        raise ValueError(f"no chain tiling for C={channels}, k={kernel}, {dtype}, "
                         f"dilations {tuple(dilations)}")
    return tile


def max_pair_reach(dtype: torch.dtype) -> int:
    """The library's MAX_REACH in ``dtype`` (builds it)."""
    fn = _build.function("resblock_chain", "stk_resblock_chain_max_reach", [ctypes.c_int])
    return fn(_build.dtype_code(dtype))


@functools.lru_cache(maxsize=None)
def launch_plan(width: int, kernel: int, dilations: tuple, dtype: torch.dtype) -> tuple:
    """The launches that run a chain: (first pair, end, route) of each group
    of consecutive pairs. From each pair on, the longest group of at most
    MAX_PAIRS that the fused kernel tiles (route "fused"); a pair that it
    does not tile alone runs as two per-conv launches (route "conv")."""
    plan, i = [], 0
    while i < len(dilations):
        end = None
        for j in range(i + 1, min(i + MAX_PAIRS, len(dilations)) + 1):
            if _tile(width, kernel, dilations[i:j], dtype) <= 0:
                break
            end = j
        plan.append((i, end, "fused") if end else (i, i + 1, "conv"))
        i = end or i + 1
    return tuple(plan)


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
    dilations = tuple(int(d) for d in dilations)
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
    if not supports(c, k, dilations, x.dtype):
        raise ValueError(f"the chain kernel takes C <= {MAX_CHANNELS}, an odd k and "
                         f"dilations >= 1 in float32 or bfloat16, got k={k}, C={c}, "
                         f"dilations {dilations}, {x.dtype}")
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
    width = kernel_width(c)
    xk = x
    if width != c:
        xk, fm, wa, baf, wb, bbf = pad_channels(x, fm, wa, baf, wb, bbf, width)
    fn = _build.function("resblock_chain", "stk_resblock_chain", _ARGTYPES)
    P = _build.ptr
    code = _build.dtype_code(x.dtype)
    for i, j, route in launch_plan(width, k, dilations, x.dtype):
        out = torch.empty_like(xk)
        if route == "conv":
            conv = _build.function("resblock_chain", "stk_resblock_conv", _CONV_ARGTYPES)
            silu_h = torch.empty_like(xk)
            for src, w, bias, dst, d, is_b in ((xk, wa[i], baf[i], silu_h, dilations[i], 0),
                                               (silu_h, wb[i], bbf[i], out, 1, 1)):
                with _build.on(x):
                    _build.check(conv(P(src), P(xk), P(fm), P(w), P(bias), P(dst), b, t_len,
                                      width, k, d, is_b, code, _build.stream_ptr(x)),
                                 "stk_resblock_conv")
                _count.launched("resblock_chain", (b, t_len, c))
        else:
            _, dils = _dils(dilations[i:j])
            with _build.on(x):
                _build.check(fn(P(xk), P(fm), P(wa[i:j]), P(baf[i:j]), P(wb[i:j]),
                                P(bbf[i:j]), P(out), b, t_len, width, k, j - i,
                                ctypes.cast(dils, ctypes.c_void_p), code,
                                _build.stream_ptr(x)),
                             "stk_resblock_chain")
            _count.launched("resblock_chain", (b, t_len, c))
        xk = out
    return xk if width == c else xk[..., :c].contiguous()


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
    the batch-shared mask [1, T, 1] (or None), for ``x`` in any layout (the
    vocoder's first chain takes a conv's transposed output)."""
    wa, ba, wb, bb = stack_resblock(params, x.dtype)
    fm = None if mask is None else mask.reshape(mask.shape[-2])
    return resblock_chain(x.contiguous(), fm, wa, ba, wb, bb, dilations)
