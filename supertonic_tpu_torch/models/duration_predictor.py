"""Utterance-level duration predictor, the counterpart of
``supertonic_tpu.models.duration_predictor``: character embeddings ->
transformer blocks -> masked mean pool -> MLP head -> softplus speaking rate
(seconds per character) times the true character count. Returns duration
[B] float32 seconds."""

from __future__ import annotations

import numpy as np
import torch

from ..config import TTSConfig
from . import layers as L


def init(rng, cfg: TTSConfig) -> L.Params:
    hp = cfg.duration_predictor
    style_dim = cfg.dp.style.style_value_dim
    return {
        "embed": L.embedding_init(rng, hp.vocab_size, hp.dim),
        "style_proj": L.linear_init(rng, style_dim, hp.dim),
        "blocks": [
            L.block_init(rng, hp.dim, hp.ffn_mult, cross_dim=hp.dim)
            for _ in range(hp.n_layers)
        ],
        "ln_out": L.layer_norm_init(hp.dim),
        "head1": L.linear_init(rng, hp.dim, hp.dim),
        "head2": _rate_head_init(rng, hp.dim),
    }


def _rate_head_init(rng, dim: int) -> L.Params:
    head = L.linear_init(rng, dim, 1)
    # softplus(bias) = 1/15 s per char  =>  ~15 chars/sec at init
    head["b"] = np.full((1,), np.log(np.expm1(1.0 / 15.0)), np.float32)
    # damp the random contribution so init-time rates stay near the prior
    head["w"] = (head["w"] * 0.1).astype(np.float32)
    return head


def apply(params, cfg: TTSConfig, text_ids, style_dp, text_mask, *,
          dtype=torch.float32) -> torch.Tensor:
    hp = cfg.duration_predictor
    x = L.embedding(params["embed"], text_ids, dtype=dtype)
    style = L.linear(params["style_proj"], style_dp.to(dtype))
    text_len = text_mask.sum(-1)
    pos = L.larope_positions(text_len, text_ids.shape[1],
                             cfg.vector_estimator.larope_scale)
    rope = L.rope_angles(pos, hp.dim // hp.n_heads,
                         cfg.vector_estimator.larope_theta)
    for bp in params["blocks"]:
        x = L.block(bp, x, hp.n_heads, self_mask=text_mask, self_rope=rope,
                    memory=style, memory_mask=None)
    x = L.layer_norm(params["ln_out"], x)
    m = text_mask.to(x.dtype)[:, :, None]
    pooled = (x * m).sum(1) / torch.clamp(m.sum(1), min=1.0)
    h = L.linear(params["head1"], pooled, silu=True)
    logit = L.linear(params["head2"], h)[..., 0].float()
    rate = torch.logaddexp(logit, torch.zeros_like(logit))  # softplus
    return rate * text_len.float()
