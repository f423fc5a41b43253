"""Synthesis stages, the counterpart of ``supertonic_tpu.engine.synthesis``.

  text_stage:      text ids, masks, styles -> duration [B] (divided by
                   speed), text_emb
  acoustic_stage:  text_emb, styles, masks, noise -> waveform: the
                   cross-attention K/V computed once, ``total_step`` Euler
                   steps of the vector estimator, the vocoder
  synthesize_padded: both, with the latent mask derived on the device from
                   the predicted duration and the latent length fixed by
                   the injected noise
  synthesize_fused: the production call: noise drawn on the device from a
                   ``torch.Generator``, optional int16 egress

PyTorch runs eagerly, so where the JAX package compiles one program per
bucket, these functions simply run; the shapes are still bucketed by the
engine.
"""

from __future__ import annotations

import torch

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
               speed: float, *, precision: str = "bf16"):
    """Duration prediction + text encoding. Returns (duration [B] f32
    seconds, already divided by speed, and text_emb)."""
    dtype = dtype_of(precision)
    dur = duration_predictor.apply(params["duration_predictor"], cfg, text_ids,
                                   style_dp, text_mask, dtype=dtype)
    dur = dur / speed
    emb = text_encoder.apply(params["text_encoder"], cfg, text_ids, style_ttl,
                             text_mask, dtype=dtype)
    return dur, emb


def acoustic_stage(params, cfg: TTSConfig, text_emb, style_ttl, text_mask,
                   latent_mask, noise, total_step: int, *,
                   precision: str = "bf16") -> torch.Tensor:
    """Euler loop + vocoder. Returns wav [B, T*chunk] f32. The initial
    latent is noise * latent_mask; each step feeds x_t with
    (current_step, total_step) to the estimator, which applies the update."""
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
                                  cross_cache=cache)
    # batch-max frame validity: frames past the longest utterance are
    # bucket padding, masked inside the vocoder
    frame_mask = latent_mask.amax(0)
    return vocoder.apply(params["vocoder"], cfg, x, frame_mask=frame_mask,
                         dtype=dtype)


def synthesize_padded(params, cfg: TTSConfig, text_ids, text_mask, style_dp,
                      style_ttl, noise, speed: float, total_step: int, *,
                      precision: str = "bf16"):
    """Text stage + acoustic stage at the latent length of ``noise``
    [B, T, C]; the latent mask comes from the predicted duration, clamped
    into T. Returns (wav [B, T*chunk] f32, duration [B] f32, unclamped)."""
    dur, emb = text_stage(params, cfg, text_ids, text_mask, style_dp, style_ttl,
                          speed, precision=precision)
    t_pad = noise.shape[1]
    latent_len = torch.clamp(torch.ceil(dur * cfg.sample_rate / cfg.chunk_size),
                             max=float(t_pad))
    frame_idx = torch.arange(t_pad, dtype=torch.float32, device=dur.device)[None, :]
    latent_mask = (frame_idx < latent_len[:, None]).float()
    wav = acoustic_stage(params, cfg, emb, style_ttl, text_mask, latent_mask,
                         noise, total_step, precision=precision)
    return wav, dur


def synthesize_fused(params, cfg: TTSConfig, text_ids, text_mask, style_dp,
                     style_ttl, generator: torch.Generator, speed: float,
                     total_step: int, t_pad: int, *, precision: str = "bf16",
                     egress: str = "int16"):
    """The production call: noise [B, t_pad, C] ~ N(0, 1) drawn on the
    device from ``generator``, then ``synthesize_padded``. Returns (wav
    [B, t_pad*chunk] int16 or f32, duration [B] f32 — unclamped, so the
    caller detects an overflow as ceil(dur*sr/chunk) > t_pad)."""
    noise = torch.randn((text_ids.shape[0], t_pad, cfg.latent_channels),
                        generator=generator, dtype=torch.float32,
                        device=text_ids.device)
    wav, dur = synthesize_padded(params, cfg, text_ids, text_mask, style_dp,
                                 style_ttl, noise, speed, total_step,
                                 precision=precision)
    if egress == "int16":
        wav = torch.clamp(wav * 32767.0, -32768.0, 32767.0).to(torch.int16)
    elif egress != "f32":
        raise ValueError(f"egress must be 'int16' or 'f32', got {egress!r}")
    return wav, dur
