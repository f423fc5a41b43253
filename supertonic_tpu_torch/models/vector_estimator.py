"""Flow-matching vector estimator (the denoiser), the counterpart of
``supertonic_tpu.models.vector_estimator``.

``step`` computes the velocity field and applies the Euler update
``x_{t+dt} = x_t + (1/total_step) * v(x_t, t)``, masked by the latent mask.
DiT-style blocks with AdaLN-Zero time conditioning, RoPE self-attention
over latent frames and LARoPE cross-attention into [style tokens ; text]
memory. Layout [B, T, C].

PyTorch runs eagerly, so the caller hoists what is step-invariant out of
the Euler loop, as XLA's loop-invariant motion does in the JAX package's
``fori_loop``: the cross K/V (``precompute_cross``, passed as
``cross_cache``) and the latent's LARoPE angles (``latent_rope``, passed as
``q_rope``); the math is the JAX package's. The step's tail (the velocity
mask and the Euler update) runs in ``out_proj``'s epilogue (``layers.linear``
with ``tail=``).
"""

from __future__ import annotations

import torch

from ..config import TTSConfig
from . import layers as L


def init(rng, cfg: TTSConfig) -> L.Params:
    hp = cfg.vector_estimator
    c_lat = cfg.latent_channels
    style_dim = cfg.ttl.style.style_value_dim
    text_dim = cfg.ttl.proj_out_odim
    return {
        "in_proj": L.linear_init(rng, c_lat, hp.dim),
        "style_proj": L.linear_init(rng, style_dim, hp.dim),
        "text_proj": L.linear_init(rng, text_dim, hp.dim),
        "time_mlp1": L.linear_init(rng, hp.time_embed_dim, hp.dim),
        "time_mlp2": L.linear_init(rng, hp.dim, hp.dim),
        "blocks": [
            L.block_init(rng, hp.dim, hp.ffn_mult, cross_dim=hp.dim,
                         adaln=True, cond_dim=hp.dim)
            for _ in range(hp.n_layers)
        ],
        "ln_out": L.layer_norm_init(hp.dim),
        "adaln_out": L.linear_init(rng, hp.dim, 2 * hp.dim, zero=True),
        "out_proj": L.linear_init(rng, hp.dim, c_lat, zero=True),
    }


def precompute_cross(params, cfg: TTSConfig, text_emb, style_ttl, text_mask,
                     *, dtype=torch.float32):
    """The step-invariant part of cross-attention: the [style;text] memory
    mask and, per block, head-split and rotated (K, V). Style tokens take
    RoPE position 0 (identity rotation), text tokens LARoPE positions.
    Returns (mem_mask [B, S+L], [(k, v)] per block)."""
    hp = cfg.vector_estimator
    b = text_emb.shape[0]
    style = L.linear(params["style_proj"], style_ttl.to(dtype))
    text = L.linear(params["text_proj"], text_emb.to(dtype))
    memory = torch.cat([style, text], dim=1)
    s_len = style.shape[1]
    mem_mask = torch.cat(
        [torch.ones((b, s_len), dtype=text_mask.dtype, device=text_mask.device),
         text_mask], dim=1)
    head_dim = hp.dim // hp.n_heads
    text_pos = L.larope_positions(text_mask.sum(-1), text.shape[1],
                                  hp.larope_scale)
    mem_pos = torch.cat(
        [torch.zeros((b, s_len), dtype=torch.float32, device=text_pos.device),
         text_pos], dim=1)
    mem_rope = L.rope_angles(mem_pos, head_dim, hp.larope_theta)
    kvs = [L.kv_project(bp["cross"], memory, hp.n_heads, k_rope=mem_rope)
           for bp in params["blocks"]]
    return mem_mask, kvs


def latent_rope(cfg: TTSConfig, latent_mask):
    """The latent frames' LARoPE (cos, sin) [B, T, head_dim // 2], from the
    latent mask [B, T] alone: the same in every flow step."""
    hp = cfg.vector_estimator
    q_pos = L.larope_positions(latent_mask.sum(-1), latent_mask.shape[1],
                               hp.larope_scale)
    return L.rope_angles(q_pos, hp.dim // hp.n_heads, hp.larope_theta)


def velocity(params, cfg: TTSConfig, latent, text_emb, style_ttl, text_mask,
             latent_mask, t, *, dtype=torch.float32, cross_cache=None,
             fused_ffn: bool = True, q_rope=None, tail=None):
    """The masked velocity [B, T, C] f32; with ``tail`` = (x_in, dt, mask),
    the Euler update on it (``layers.linear``), the next latent."""
    hp = cfg.vector_estimator
    x = L.linear(params["in_proj"], latent.to(dtype))
    temb = L.sinusoidal_embedding(t, hp.time_embed_dim).to(dtype)
    cond = L.linear(params["time_mlp2"],
                    L.linear(params["time_mlp1"], temb, silu=True))
    if cross_cache is None:
        cross_cache = precompute_cross(params, cfg, text_emb, style_ttl,
                                       text_mask, dtype=dtype)
    mem_mask, kvs = cross_cache

    if q_rope is None:
        q_rope = latent_rope(cfg, latent_mask)
    for bp, kv in zip(params["blocks"], kvs):
        x = L.block(bp, x, hp.n_heads, self_mask=latent_mask, self_rope=q_rope,
                    memory_mask=mem_mask, q_rope_cross=q_rope, cond=cond,
                    cross_kv=kv, fused_ffn=fused_ffn)

    shift, scale = L.linear(params["adaln_out"], cond)[:, None, :].chunk(2, dim=-1)
    h = L.layer_norm(params["ln_out"], x, shift=shift, scale=scale)
    if tail is not None:
        return L.linear(params["out_proj"], h, tail=tail)
    v = L.linear(params["out_proj"], h)
    return v.float() * latent_mask[:, :, None]


def step(params, cfg: TTSConfig, noisy_latent, text_emb, style_ttl, text_mask,
         latent_mask, current_step, total_step, *, dtype=torch.float32,
         cross_cache=None, fused_ffn: bool = True, q_rope=None):
    """One flow step: x_{t+dt} = x_t + dt * v(x_t, t), masked, the update in
    ``out_proj``'s epilogue. ``fused_ffn``: the blocks' AdaLN FFN through
    the fused kernel (``layers.block``); ``q_rope``: ``latent_rope`` of the
    latent mask, computed once for all steps."""
    t = current_step / total_step
    dt = 1.0 / total_step
    return velocity(params, cfg, noisy_latent, text_emb, style_ttl, text_mask,
                    latent_mask, t, dtype=dtype, cross_cache=cross_cache,
                    fused_ffn=fused_ffn, q_rope=q_rope,
                    tail=(noisy_latent.float(), dt.float(), latent_mask.float()))
