"""Text encoder, the counterpart of ``supertonic_tpu.models.text_encoder``:
character embedding -> conv prenet -> transformer blocks (RoPE
self-attention, cross-attention to style tokens) -> proj_out, masked.
Returns text_emb [B, L, odim]."""

from __future__ import annotations

import torch

from ..config import TTSConfig
from . import layers as L


def init(rng, cfg: TTSConfig) -> L.Params:
    hp = cfg.text_encoder
    style_dim = cfg.ttl.style.style_value_dim
    return {
        "embed": L.embedding_init(rng, hp.vocab_size, hp.dim),
        "style_proj": L.linear_init(rng, style_dim, hp.dim),
        "prenet1": L.conv1d_init(rng, hp.dim, hp.dim, hp.conv_kernel),
        "prenet2": L.conv1d_init(rng, hp.dim, hp.dim, hp.conv_kernel),
        "blocks": [
            L.block_init(rng, hp.dim, hp.ffn_mult, cross_dim=hp.dim)
            for _ in range(hp.n_layers)
        ],
        "ln_out": L.layer_norm_init(hp.dim),
        "proj_out": L.linear_init(rng, cfg.ttl.proj_out_idim,
                                  cfg.ttl.proj_out_odim),
    }


def apply(params, cfg: TTSConfig, text_ids, style_ttl, text_mask, *,
          dtype=torch.float32) -> torch.Tensor:
    hp = cfg.text_encoder
    m = text_mask.to(dtype)[:, :, None]
    x = L.embedding(params["embed"], text_ids, dtype=dtype) * m
    # x + silu(conv(x)) * m, one conv kernel each (JAX text_encoder.py:55-56)
    rows = text_mask.float()
    for name in ("prenet1", "prenet2"):
        x = L.conv1d(params[name], x, silu_out=True, mask=rows, residual=x)
    style = L.linear(params["style_proj"], style_ttl.to(dtype))
    pos = L.larope_positions(text_mask.sum(-1), text_ids.shape[1],
                             cfg.vector_estimator.larope_scale)
    rope = L.rope_angles(pos, hp.dim // hp.n_heads,
                         cfg.vector_estimator.larope_theta)
    for bp in params["blocks"]:
        x = L.block(bp, x, hp.n_heads, self_mask=text_mask, self_rope=rope,
                    memory=style, memory_mask=None)
    x = L.layer_norm(params["ln_out"], x)
    return L.linear(params["proj_out"], x) * m
