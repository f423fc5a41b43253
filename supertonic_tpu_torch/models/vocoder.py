"""Neural vocoder: latent frames -> waveform, the counterpart of
``supertonic_tpu.models.vocoder`` ("coarse-timeline subpixel" design: conv
upsample stages with depth-to-space, dilated residual chains at each
timeline, one subpixel head, tanh). Layout [B, T, C]; returns the padded
waveform [B, T * chunk_size] float32.

Routing of the residual chains follows the JAX package's rule for its
fused kernel, and that rule alone: with ``fused_resblocks``, a chain with
C <= ``vocoder_fused.MAX_CHANNELS`` (384) and a frame mask shared by the
batch goes through the chain kernel's wrapper (ops/vocoder_fused.py), which
raises on the card for a chain outside its kernel's domain
(``vocoder_fused.supports``); the others (the C=512 ``pre_res`` at the
default config), and every chain without ``fused_resblocks``, run each conv
as one launch of the conv kernel (``_resblock``).

Every conv goes through ``layers.conv1d``, the conv kernel's wrapper
(ops/conv1d.py), with the elementwise ops XLA fuses around it in the JAX
program: the pre conv's mask, each up conv's silu, depth-to-space (the
kernel's output read as the finer timeline, a view) and fine mask, the
head's silu and tanh, each resblock pair's silu, mask and residual (the
silu between the pair's convs in conv a's output). The
``up_matmul`` lever stays a cuBLAS product, as the JAX package leaves it to
``jnp.matmul``.
"""

from __future__ import annotations

import math

import torch
import torch.nn.functional as F

from ..config import TTSConfig
from ..ops import vocoder_fused
from . import layers as L


def _resblock_init(rng, ch: int, kernel: int, dilations) -> L.Params:
    return {
        "convs": [
            {
                "a": L.conv1d_init(rng, ch, ch, kernel),
                "b": L.conv1d_init(rng, ch, ch, kernel),
            }
            for _ in range(len(dilations))
        ],
    }


def _resblock(p, x: torch.Tensor, dilations, mask=None) -> torch.Tensor:
    """Each pair as two conv kernel launches: h = mask * conv_a(silu x),
    then x = x + mask * conv_b(silu h). The mask re-zeroes pad frames after
    every conv: a conv bias makes padded positions nonzero, and the next
    conv would bleed them back. ``mask`` [1 or B, T, 1].

    h feeds nothing but conv b, so conv a writes silu(h) = mask *
    silu(conv_a(silu x)) (silu out before the mask), which conv b reads as
    it is: the mask is 0/1 and silu(0) = 0, so each value is the one conv b
    would make of h, and silu runs once an element rather than once for
    each of conv b's column tiles."""
    rows = None if mask is None else mask.reshape(mask.shape[0], -1)
    for cp, d in zip(p["convs"], dilations):
        s = L.conv1d(cp["a"], x, dilation=d, silu_in=True, silu_out=True, mask=rows)
        x = L.conv1d(cp["b"], s, mask=rows, residual=x)
    return x


def final_depth(cfg: TTSConfig) -> int:
    """Samples emitted per finest-timeline step by the subpixel head."""
    return cfg.chunk_size // math.prod(cfg.vocoder.upsample_factors)


def receptive_field_frames(cfg: TTSConfig) -> int:
    """One-sided receptive field of the whole conv stack, in latent frames
    (ceil)."""
    from fractions import Fraction

    hp = cfg.vocoder

    def half(k: int, d: int = 1) -> int:
        return d * (k - 1) // 2

    def res_reach() -> int:
        return sum(half(hp.resblock_kernel, d) + half(hp.resblock_kernel)
                   for d in hp.resblock_dilations)

    r = Fraction(half(7) + res_reach())  # pre conv + pre_res at T
    prod = 1
    for f in hp.upsample_factors:
        r += Fraction(half(hp.stage_kernel), prod)  # up conv (pre-d2s)
        prod *= f
        r += Fraction(res_reach(), prod)
    r += Fraction(half(3), prod)  # subpixel head
    return math.ceil(r)


def _up_matmul(p: L.Conv1d, s: torch.Tensor) -> torch.Tensor:
    """conv1d with SAME padding as one product: the k shifted copies of
    ``s`` [B, T, Cin] stacked along channels, times the weight [k*Cin,
    Cout], bias added as the convolution adds it."""
    cout, cin, k = p.weight.shape
    half = (k - 1) // 2
    t_len = s.shape[1]
    sp = F.pad(s, (0, 0, half, k - 1 - half))
    xk = torch.cat([sp[:, i:i + t_len] for i in range(k)], dim=-1)
    # [Cout, Cin, k] -> [Cout, k*Cin], tap-major as the stacked channels
    w = L._weight(p, s.dtype).permute(0, 2, 1).reshape(cout, k * cin)
    return F.linear(xk, w, p.bias.to(s.dtype))


def fused_resblocks_default() -> bool:
    """``TTS_VOC_FUSED`` as the port reads it: the chain kernel unless the
    variable is "0" (the JAX package runs it only at "1")."""
    import os

    return os.environ.get("TTS_VOC_FUSED", "1") != "0"


def init(rng, cfg: TTSConfig) -> L.Params:
    hp = cfg.vocoder
    c_lat = cfg.latent_channels
    stages = []
    cin = hp.dim
    pre = L.conv1d_init(rng, c_lat, hp.dim, 7)
    pre_res = _resblock_init(rng, hp.dim, hp.resblock_kernel,
                             hp.resblock_dilations)
    for factor, cout in zip(hp.upsample_factors, hp.channels):
        stages.append({
            "up": L.conv1d_init(rng, cin, cout * factor, hp.stage_kernel),
            "res": _resblock_init(rng, cout, hp.resblock_kernel,
                                  hp.resblock_dilations),
        })
        cin = cout
    return {
        "pre": pre,
        "pre_res": pre_res,
        "stages": stages,
        "head": L.conv1d_init(rng, cin, final_depth(cfg), 3),
    }


def apply(params, cfg: TTSConfig, latent: torch.Tensor, *, frame_mask=None,
          dtype=torch.float32, fused_resblocks: bool | None = None,
          up_matmul: bool = False, egress: str = "f32") -> torch.Tensor:
    """latent [B, T, C] -> wav [B, T * chunk_size] float32. ``frame_mask``
    ([T] or [B, T], 1 = real frame) marks batch-max-valid frames; with it,
    bucket-padded execution equals exact-length execution.

    ``egress="int16"``: the int16 samples of the engine's egress,
    clamp(wav * 32767, -32768, 32767) truncated, from the head's epilogue
    (the f32 wav is never written); any other egress takes the f32 wav.

    ``up_matmul``: each upsample conv as one K-stacked product ([B, T,
    k*Cin] @ [k*Cin, Cout*f]) instead of a convolution, the JAX package's
    ``TTS_VOC_UP_MATMUL`` lever; the same sums in another order. The engine
    reads that variable once when it is built and passes the flag here.

    ``fused_resblocks``: the fine-timeline chains through the chain kernel
    (``ops.vocoder_fused``), the JAX package's ``TTS_VOC_FUSED`` lever.
    None reads that variable as JAX does, but the port's default is on:
    only "0" turns the kernel off (the engine reads it once when it is
    built and passes the flag here)."""
    hp = cfg.vocoder
    if fused_resblocks is None:
        fused_resblocks = fused_resblocks_default()

    def res(p, x, m):
        if (fused_resblocks and x.shape[-1] <= vocoder_fused.MAX_CHANNELS
                and (m is None or m.shape[0] == 1)):
            return vocoder_fused.fused_resblock(p, x, hp.resblock_dilations, m)
        return _resblock(p, x, hp.resblock_dilations, m)

    # the frame mask [1 or B, T] f32 for the conv kernel (which rounds it to
    # dtype as JAX's frame_mask.astype(dtype)), and [1 or B, T, 1] in dtype
    # for the chain
    rows = m = None
    if frame_mask is not None:
        rows = frame_mask.float()
        rows = rows[None] if rows.dim() == 1 else rows
        m = rows.to(dtype)[:, :, None]
    x = L.conv1d(params["pre"], latent.to(dtype), mask=rows)
    x = res(params["pre_res"], x, m)
    for sp, factor in zip(params["stages"], hp.upsample_factors):
        if rows is not None:
            rows = torch.repeat_interleave(rows, factor, dim=1)
            m = rows.to(dtype)[:, :, None]
        if up_matmul:
            h = _up_matmul(sp["up"], F.silu(x))
            b, t, cf = h.shape
            x = h.reshape(b, t * factor, cf // factor)   # depth-to-space
            if m is not None:
                x = x * m
        else:
            # silu, the conv, depth-to-space (a view of the kernel's rows)
            # and the fine mask in one launch
            h = L.conv1d(sp["up"], x, silu_in=True, mask=rows, fold=factor)
            b, t, cf = h.shape
            x = h.view(b, t * factor, cf // factor)
        x = res(sp["res"], x, m)
    # silu, the subpixel head and tanh in f32 (and the int16 egress) in one launch
    wav = L.conv1d(params["head"], x, silu_in=True, tanh_f32=True,
                   int16=egress == "int16")  # [B, Tf, final_depth]
    b, tf, d = wav.shape
    return wav.reshape(b, tf * d)
