"""Synthesis stages, the counterpart of ``supertonic_tpu.engine.synthesis``.

  text_stage:      text ids, masks, styles -> duration [B] (divided by
                   speed), text_emb
  flow_stage:      text_emb, styles, masks, noise -> denoised latent: the
                   cross-attention K/V computed once, ``total_step`` Euler
                   steps of the vector estimator
  acoustic_stage:  flow_stage, then the vocoder -> waveform
  synthesize_padded: both stages, with the latent mask derived on the
                   device from the predicted duration and the latent length
                   fixed by the injected noise
  synthesize_fused: the production call: noise drawn on the device from a
                   ``torch.Generator``, int16 / mu-law / f32 egress
  flow_padded:     the text stage and the flow loop at the latent length of
                   injected noise: latent, duration and frame mask, the
                   input of windowed vocoding, optionally with halo frames
  flow_fused:      flow_padded on noise drawn from a ``torch.Generator``
  vocode_span:     one vocoder window with its halo, given as its own
                   tensors; only the interior samples are kept
  vocode_window:   vocode_span of the window at ``start`` of a padded latent
  cross_cache, euler_step, vocode: the progress path's three calls (the
                   cross K/V once, one Euler step, the vocoder)

These functions run eagerly. Where the JAX package compiles one program per
static shape (``jit_synthesize_fused``, ``jit_flow_fused``,
``jit_vocode_window``), the engine on the card replays a CUDA graph captured
per shape (``engine/programs.py``) of ``synthesize_padded`` plus egress,
``flow_padded`` and ``vocode_span``: the bodies that take their noise and
their window as inputs. ``speed`` may be a Python float or a 0-dim f32
tensor; the engine passes a tensor, as the JAX engine passes an array: on
CUDA a division by a Python scalar is a product with its reciprocal, by a
tensor a true division.
"""

from __future__ import annotations

import torch
import torch.nn.functional as F

from ..config import TTSConfig
from ..models import duration_predictor, text_encoder, vector_estimator, vocoder


def dtype_of(precision: str) -> torch.dtype:
    """The compute dtype. "int8" quantizes the estimator-block linears
    (params carry int8 ``w_q``, see models.quantize_params); everything else
    in that mode computes in bf16."""
    if precision == "f32":
        return torch.float32
    if precision in ("bf16", "int8"):
        return torch.bfloat16
    raise ValueError(f"precision must be 'f32', 'bf16' or 'int8', got {precision!r}")


def text_stage(params, cfg: TTSConfig, text_ids, text_mask, style_dp, style_ttl,
               speed, *, precision: str = "bf16"):
    """Duration prediction + text encoding. Returns (duration [B] f32
    seconds, already divided by speed — a float or a 0-dim tensor —, and
    text_emb)."""
    dtype = dtype_of(precision)
    dur = duration_predictor.apply(params["duration_predictor"], cfg, text_ids,
                                   style_dp, text_mask, dtype=dtype)
    dur = dur / speed
    emb = text_encoder.apply(params["text_encoder"], cfg, text_ids, style_ttl,
                             text_mask, dtype=dtype)
    return dur, emb


def flow_stage(params, cfg: TTSConfig, text_emb, style_ttl, text_mask,
               latent_mask, noise, total_step: int, *,
               precision: str = "bf16", fused_ffn: bool = True) -> torch.Tensor:
    """The Euler loop: returns the denoised latent [B, T, C] f32. The
    initial latent is noise * latent_mask; each step feeds x_t with
    (current_step, total_step) to the estimator, which applies the update;
    the step-invariant cross K/V is computed once. ``fused_ffn``: the
    estimator's AdaLN FFN through the fused kernel (``layers.block``)."""
    dtype = dtype_of(precision)
    b = text_emb.shape[0]
    ve = params["vector_estimator"]
    x = noise.float() * latent_mask[:, :, None]
    tot = torch.full((b,), float(total_step), dtype=torch.float32,
                     device=x.device)
    cache = vector_estimator.precompute_cross(ve, cfg, text_emb, style_ttl,
                                              text_mask, dtype=dtype)
    for i in range(total_step):
        cur = torch.full((b,), float(i), dtype=torch.float32, device=x.device)
        x = vector_estimator.step(ve, cfg, x, text_emb, style_ttl, text_mask,
                                  latent_mask, cur, tot, dtype=dtype,
                                  cross_cache=cache, fused_ffn=fused_ffn)
    return x


def acoustic_stage(params, cfg: TTSConfig, text_emb, style_ttl, text_mask,
                   latent_mask, noise, total_step: int, *,
                   precision: str = "bf16", fused_ffn: bool = True,
                   up_matmul: bool = False, frame_mask=None) -> torch.Tensor:
    """Euler loop + vocoder. Returns wav [B, T*chunk] f32. ``up_matmul``:
    the vocoder's upsample convs as products (``vocoder.apply``).
    ``frame_mask`` [T]: the vocoder's frame mask when the batch is one
    shard of a larger one (the whole batch's; by default this batch's)."""
    x = flow_stage(params, cfg, text_emb, style_ttl, text_mask, latent_mask,
                   noise, total_step, precision=precision, fused_ffn=fused_ffn)
    # batch-max frame validity: frames past the longest utterance are
    # bucket padding, masked inside the vocoder
    if frame_mask is None:
        frame_mask = latent_mask.amax(0)
    return vocoder.apply(params["vocoder"], cfg, x, frame_mask=frame_mask,
                         dtype=dtype_of(precision), up_matmul=up_matmul)


def _latent_mask(cfg: TTSConfig, dur, t_pad: int):
    """[B, t_pad] 1/0 mask of the frames the predicted duration covers,
    clamped into t_pad."""
    latent_len = torch.clamp(torch.ceil(dur * cfg.sample_rate / cfg.chunk_size),
                             max=float(t_pad))
    frame_idx = torch.arange(t_pad, dtype=torch.float32, device=dur.device)[None, :]
    return (frame_idx < latent_len[:, None]).float()


def _noise(cfg: TTSConfig, b: int, t_pad: int, generator, device, out=None):
    """Noise [b, t_pad, C] ~ N(0, 1) from ``generator``; into ``out`` when it
    is given (a captured program's static input), with the same op and so
    the same numbers."""
    return torch.randn((b, t_pad, cfg.latent_channels), generator=generator,
                       dtype=torch.float32, device=device, out=out)


def synthesize_padded(params, cfg: TTSConfig, text_ids, text_mask, style_dp,
                      style_ttl, noise, speed, total_step: int, *,
                      precision: str = "bf16", fused_ffn: bool = True,
                      up_matmul: bool = False):
    """Text stage + acoustic stage at the latent length of ``noise``
    [B, T, C]; the latent mask comes from the predicted duration, clamped
    into T. Returns (wav [B, T*chunk] f32, duration [B] f32, unclamped)."""
    dur, emb = text_stage(params, cfg, text_ids, text_mask, style_dp, style_ttl,
                          speed, precision=precision)
    latent_mask = _latent_mask(cfg, dur, noise.shape[1])
    wav = acoustic_stage(params, cfg, emb, style_ttl, text_mask, latent_mask,
                         noise, total_step, precision=precision,
                         fused_ffn=fused_ffn, up_matmul=up_matmul)
    return wav, dur


def synthesize_fused(params, cfg: TTSConfig, text_ids, text_mask, style_dp,
                     style_ttl, generator: torch.Generator, speed,
                     total_step: int, t_pad: int, *, precision: str = "bf16",
                     egress: str = "int16", fused_ffn: bool = True,
                     up_matmul: bool = False):
    """The production call: noise [B, t_pad, C] ~ N(0, 1) drawn on the
    device from ``generator``, then ``synthesize_padded``. Returns (wav
    [B, t_pad*chunk] int16, uint8 mu-law or f32, duration [B] f32 —
    unclamped, so the caller detects an overflow as
    ceil(dur*sr/chunk) > t_pad)."""
    noise = _noise(cfg, text_ids.shape[0], t_pad, generator, text_ids.device)
    wav, dur = synthesize_padded(params, cfg, text_ids, text_mask, style_dp,
                                 style_ttl, noise, speed, total_step,
                                 precision=precision, fused_ffn=fused_ffn,
                                 up_matmul=up_matmul)
    return encode_egress(wav, egress), dur


def flow_padded(params, cfg: TTSConfig, text_ids, text_mask, style_dp,
                style_ttl, noise, speed, total_step: int, *,
                precision: str = "bf16", halo: int = 0, fused_ffn: bool = True):
    """The text stage and the flow loop at the latent length of ``noise``
    [B, T, C]. Returns (latent [B, T + 2*halo, C], duration [B] — unclamped,
    for overflow detection —, and the batch-max frame mask [T + 2*halo]),
    with ``halo`` zero frames each side of the latent and the mask: the
    input of ``vocode_window``."""
    dur, emb = text_stage(params, cfg, text_ids, text_mask, style_dp, style_ttl,
                          speed, precision=precision)
    latent_mask = _latent_mask(cfg, dur, noise.shape[1])
    xt = flow_stage(params, cfg, emb, style_ttl, text_mask, latent_mask, noise,
                    total_step, precision=precision, fused_ffn=fused_ffn)
    fmask = latent_mask.amax(0)
    if halo:
        xt = F.pad(xt, (0, 0, halo, halo))
        fmask = F.pad(fmask, (halo, halo))
    return xt, dur, fmask


def flow_fused(params, cfg: TTSConfig, text_ids, text_mask, style_dp,
               style_ttl, generator: torch.Generator, speed,
               total_step: int, t_pad: int, *, precision: str = "bf16",
               halo: int = 0, fused_ffn: bool = True):
    """synthesize_fused without the vocoder: ``flow_padded`` on noise
    [B, t_pad, C] drawn on the device from ``generator``."""
    noise = _noise(cfg, text_ids.shape[0], t_pad, generator, text_ids.device)
    return flow_padded(params, cfg, text_ids, text_mask, style_dp, style_ttl,
                       noise, speed, total_step, precision=precision, halo=halo,
                       fused_ffn=fused_ffn)


def cross_cache(params, cfg: TTSConfig, text_emb, style_ttl, text_mask, *,
                precision: str = "bf16") -> tuple:
    """The step-invariant cross-attention memory of the progress path,
    ``vector_estimator.precompute_cross`` flattened: (mem_mask, k_0, v_0,
    k_1, v_1, ...); over a model group each block's (k, v) per rank, in
    rank order."""
    mem_mask, kvs = vector_estimator.precompute_cross(
        params["vector_estimator"], cfg, text_emb, style_ttl, text_mask,
        dtype=dtype_of(precision))
    return (mem_mask, *[t for kv in kvs
                        for pair in (kv if isinstance(kv, list) else [kv])
                        for t in pair])


def euler_step(params, cfg: TTSConfig, x, text_emb, style_ttl, text_mask,
               latent_mask, current_step, total_step, cache: tuple, *,
               precision: str = "bf16", fused_ffn: bool = True) -> torch.Tensor:
    """One Euler step of the progress path on the flat ``cross_cache``."""
    from ..models.layers import tp_ranks

    mem_mask, flat = cache[0], cache[1:]
    kvs = [(flat[i], flat[i + 1]) for i in range(0, len(flat), 2)]
    ranks = tp_ranks(params["vector_estimator"]["blocks"][0]["cross"])
    if ranks > 1:  # each block's per-rank pairs
        kvs = [kvs[i:i + ranks] for i in range(0, len(kvs), ranks)]
    return vector_estimator.step(params["vector_estimator"], cfg, x, text_emb,
                                 style_ttl, text_mask, latent_mask, current_step,
                                 total_step, dtype=dtype_of(precision),
                                 cross_cache=(mem_mask, kvs), fused_ffn=fused_ffn)


def vocode(params, cfg: TTSConfig, x, frame_mask, *, precision: str = "bf16",
           up_matmul: bool = False) -> torch.Tensor:
    """The progress path's vocoder call: wav [B, T*chunk] f32."""
    return vocoder.apply(params["vocoder"], cfg, x, frame_mask=frame_mask,
                         dtype=dtype_of(precision), up_matmul=up_matmul)


def window_span(xt_pad, mask_pad, start: int, window: int, halo: int):
    """Frames [start, start + window + 2*halo) of the padded latent and of
    its frame mask: the window ``vocode_span`` takes."""
    span = window + 2 * halo
    if not 0 <= start <= xt_pad.shape[1] - span:
        raise ValueError(f"window [{start}, {start + span}) outside the padded "
                         f"latent of {xt_pad.shape[1]} frames")
    return xt_pad[:, start:start + span], mask_pad[start:start + span]


def vocode_span(params, cfg: TTSConfig, x_win, m_win, window: int, halo: int,
                *, precision: str = "bf16", egress: str = "int16",
                up_matmul: bool = False) -> torch.Tensor:
    """Vocode one window given as its own tensors, ``x_win`` [B, window +
    2*halo, C] and its frame mask ``m_win``, and return only the interior
    samples [B, window*chunk]."""
    wav = vocoder.apply(params["vocoder"], cfg, x_win, frame_mask=m_win,
                        dtype=dtype_of(precision), up_matmul=up_matmul)
    chunk = cfg.chunk_size
    return encode_egress(wav[:, halo * chunk:(halo + window) * chunk], egress)


def vocode_window(params, cfg: TTSConfig, xt_pad, mask_pad, start: int,
                  window: int, halo: int, *, precision: str = "bf16",
                  egress: str = "int16", up_matmul: bool = False) -> torch.Tensor:
    """Vocode one window: frames [start, start + window + 2*halo) of the
    latent pre-padded with ``halo`` zero frames each side (``xt_pad``
    [B, T+2H, C], ``mask_pad`` [T+2H], the batch-max frame mask, zero in
    the pads), and return only the interior samples [B, window*chunk].
    With halo >= vocoder.receptive_field_frames(cfg) the interior is
    full-sequence vocoding of those frames, so audio can leave before the
    whole chunk is vocoded."""
    x_win, m_win = window_span(xt_pad, mask_pad, start, window, halo)
    return vocode_span(params, cfg, x_win, m_win, window, halo,
                       precision=precision, egress=egress, up_matmul=up_matmul)


def encode_egress(wav: torch.Tensor, egress: str) -> torch.Tensor:
    """The on-device egress form of an f32 waveform: "int16" (clamped
    x * 32767), "mulaw" (8-bit G.711) or "f32" (unchanged)."""
    if egress == "int16":
        return torch.clamp(wav * 32767.0, -32768.0, 32767.0).to(torch.int16)
    if egress == "mulaw":
        return _mulaw_encode(wav)
    if egress != "f32":
        raise ValueError(f"egress must be 'int16', 'mulaw' or 'f32', got {egress!r}")
    return wav


def _mulaw_encode(x: torch.Tensor) -> torch.Tensor:
    """On-device G.711 mu-law companding: 8-bit egress (a quarter of f32, half
    of int16) at ~13-bit speech quality. Host decode: utils.mulaw.decode."""
    pcm = torch.clamp(x * 32767.0, -32635.0, 32635.0)
    sign = (pcm < 0).to(torch.int32) * 0x80
    mag = pcm.abs().to(torch.int32) + 0x84
    # segment exponent by integer threshold comparisons: a float log2 can
    # land just below an exact integer at power-of-two magnitudes, dropping
    # the exponent and halving the decoded sample
    exp = torch.zeros_like(mag)
    for th in (256, 512, 1024, 2048, 4096, 8192, 16384):
        exp += (mag >= th).to(torch.int32)
    mant = torch.bitwise_right_shift(mag, exp + 3) & 0x0F
    return (~(sign | (exp << 4) | mant) & 0xFF).to(torch.uint8)
