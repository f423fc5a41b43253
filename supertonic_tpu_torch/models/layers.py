"""Core functional layers in PyTorch, the counterpart of
``supertonic_tpu.models.layers``.

Conventions:
  * Public functions keep the JAX package's layout: [B, T, C] channels-last,
    attention tensors [B, T, H, Dh].
  * Parameters live in small ``nn.Module`` leaves (``Linear``, ``Conv1d``,
    ``LayerNorm``, ``Embedding``) inside ``nn.ModuleDict``/``nn.ModuleList``
    containers that mirror the JAX param tree key for key, so the network
    code reads ``p["blocks"][i]["self"]["q"]`` exactly like the reference.
    ``tree_to_modules``/``modules_to_tree`` convert between the two; torch
    layouts (linear [dout, din], conv [cout, cin, k]) are made at load time
    and transposed back on export.
  * Weight matrices are stored in the compute dtype, biases and norm
    parameters in float32, so each call reproduces the JAX package's
    ``w.astype(x.dtype)`` without a per-call cast.
  * The bf16 rounding points of the JAX layers are kept: ``linear`` rounds
    the f32 accumulator to bf16 before the bias add, ``layer_norm``
    normalizes in f32 and applies the affine in bf16, ``apply_rope`` does
    not upcast x.
  * W8A8 linears (``QLinear``, from ``models.quantize_params``) keep int8
    weights whatever the compute dtype; ``linear`` routes them through the
    quantize pass (ops/quantize.py) and the int8 product with its
    rescale-and-bias epilogue (ops/w8a8.py), in the JAX ``_linear_w8a8``'s
    order.

The ``*_init`` helpers are verbatim numpy copies of the JAX package's, so
that ``models.init_all`` draws the same numbers in the same order.
"""

from __future__ import annotations

import math
from typing import Any

import numpy as np
import torch
import torch.nn.functional as F
from torch import nn

from ..ops.attention import fused_attention
from ..ops.ffn import fused_adaln_ffn
from ..ops.quantize import quantize_rows
from ..ops.w8a8 import w8a8_matmul

Params = dict[str, Any]

NEG_INF = -1e9


# ---------------------------------------------------------------------------
# numpy init helpers (copied verbatim: same RNG call order as the JAX package)
# ---------------------------------------------------------------------------

def _uniform_init(rng: np.random.Generator, shape, scale):
    return rng.uniform(-scale, scale, shape).astype(np.float32)


def linear_init(rng, din: int, dout: int, *, zero: bool = False) -> Params:
    if zero:
        return {"w": np.zeros((din, dout), np.float32),
                "b": np.zeros((dout,), np.float32)}
    scale = 1.0 / math.sqrt(din)
    return {"w": _uniform_init(rng, (din, dout), scale),
            "b": np.zeros((dout,), np.float32)}


def quantize_linear(p: Params) -> Params:
    """Offline W8A8 quantization of one linear layer: symmetric per-output-
    channel int8 weights + f32 scales. Applied by models.quantize_params for
    the opt-in int8 serving path."""
    w = np.asarray(p["w"], np.float32)
    scale = np.maximum(np.max(np.abs(w), axis=0), 1e-12) / 127.0
    w_q = np.clip(np.rint(w / scale), -127, 127).astype(np.int8)
    return {"w_q": w_q, "w_scale": scale.astype(np.float32),
            "b": np.asarray(p["b"], np.float32)}


def embedding_init(rng, vocab: int, dim: int) -> Params:
    return {"table": (rng.standard_normal((vocab, dim)) * 0.02).astype(np.float32)}


def layer_norm_init(dim: int) -> Params:
    return {"g": np.ones((dim,), np.float32), "b": np.zeros((dim,), np.float32)}


def conv1d_init(rng, cin: int, cout: int, kernel: int) -> Params:
    scale = 1.0 / math.sqrt(cin * kernel)
    return {"w": _uniform_init(rng, (kernel, cin, cout), scale),
            "b": np.zeros((cout,), np.float32)}


def mha_init(rng, dim: int, *, kv_dim: int | None = None) -> Params:
    kv_dim = kv_dim or dim
    return {
        "q": linear_init(rng, dim, dim),
        "k": linear_init(rng, kv_dim, dim),
        "v": linear_init(rng, kv_dim, dim),
        "o": linear_init(rng, dim, dim),
    }


def ffn_init(rng, dim: int, mult: int) -> Params:
    return {"in": linear_init(rng, dim, dim * mult),
            "out": linear_init(rng, dim * mult, dim)}


def block_init(rng, dim: int, ffn_mult: int, *,
               cross_dim: int | None = None, adaln: bool = False,
               cond_dim: int | None = None) -> Params:
    p: Params = {
        "ln1": layer_norm_init(dim),
        "self": mha_init(rng, dim),
        "ln3": layer_norm_init(dim),
        "ffn": ffn_init(rng, dim, ffn_mult),
    }
    if cross_dim is not None:
        p["ln2"] = layer_norm_init(dim)
        p["cross"] = mha_init(rng, dim, kv_dim=cross_dim)
    if adaln:
        n_sub = 3 if cross_dim is not None else 2
        p["adaln"] = linear_init(rng, cond_dim or dim, 3 * n_sub * dim, zero=True)
    return p


# ---------------------------------------------------------------------------
# parameter modules: the JAX param tree as nn.Modules
# ---------------------------------------------------------------------------

class Linear(nn.Module):
    """JAX ``{"w": [din, dout], "b": [dout]}``; held as torch's [dout, din]."""

    def __init__(self, w: torch.Tensor, b: torch.Tensor):
        super().__init__()
        self.weight = nn.Parameter(w, requires_grad=False)
        self.bias = nn.Parameter(b, requires_grad=False)

    def to_tree(self) -> Params:
        return {"w": _np(self.weight.t()), "b": _np(self.bias)}


class QLinear(nn.Module):
    """JAX ``{"w_q": int8 [din, dout], "w_scale": [dout], "b": [dout]}``;
    held as int8 [dout, din], scales and bias in f32."""

    def __init__(self, w_q: torch.Tensor, w_scale: torch.Tensor, b: torch.Tensor):
        super().__init__()
        self.w_q = nn.Parameter(w_q, requires_grad=False)
        self.w_scale = nn.Parameter(w_scale, requires_grad=False)
        self.bias = nn.Parameter(b, requires_grad=False)

    def to_tree(self) -> Params:
        return {"w_q": self.w_q.detach().t().contiguous().cpu().numpy().copy(),
                "w_scale": _np(self.w_scale), "b": _np(self.bias)}


class Conv1d(nn.Module):
    """JAX ``{"w": [k, cin, cout] (HIO), "b": [cout]}``; held as [cout, cin, k]."""

    def __init__(self, w: torch.Tensor, b: torch.Tensor):
        super().__init__()
        self.weight = nn.Parameter(w, requires_grad=False)
        self.bias = nn.Parameter(b, requires_grad=False)

    def to_tree(self) -> Params:
        return {"w": _np(self.weight.permute(2, 1, 0)), "b": _np(self.bias)}


class LayerNorm(nn.Module):
    def __init__(self, g: torch.Tensor, b: torch.Tensor):
        super().__init__()
        self.g = nn.Parameter(g, requires_grad=False)
        self.b = nn.Parameter(b, requires_grad=False)

    def to_tree(self) -> Params:
        return {"g": _np(self.g), "b": _np(self.b)}


class Embedding(nn.Module):
    def __init__(self, table: torch.Tensor):
        super().__init__()
        self.table = nn.Parameter(table, requires_grad=False)

    def to_tree(self) -> Params:
        return {"table": _np(self.table)}


def _np(t: torch.Tensor) -> np.ndarray:
    return t.detach().to("cpu", torch.float32).contiguous().numpy().copy()


def tree_to_modules(tree, *, device, dtype=torch.float32) -> nn.Module:
    """Build the module tree from a JAX-layout numpy param tree. Weight
    matrices (linear, conv, embedding) go to ``dtype``; biases, norm
    parameters and W8A8 scales stay float32, W8A8 weights int8."""

    def mat(a, perm=None):
        t = torch.as_tensor(np.asarray(a, np.float32))
        if perm is not None:
            t = t.permute(*perm)
        return t.contiguous().to(device=device, dtype=dtype)

    def vec(a):
        return torch.as_tensor(np.asarray(a, np.float32)).to(device)

    def build(node):
        if isinstance(node, (list, tuple)):
            return nn.ModuleList([build(v) for v in node])
        keys = set(node)
        if keys == {"w", "b"}:
            w = np.asarray(node["w"])
            if w.ndim == 2:
                return Linear(mat(w, (1, 0)), vec(node["b"]))
            if w.ndim == 3:
                return Conv1d(mat(w, (2, 1, 0)), vec(node["b"]))
            raise ValueError(f"unsupported weight rank {w.ndim}")
        if keys == {"w_q", "w_scale", "b"}:
            w_q = torch.as_tensor(np.asarray(node["w_q"], np.int8))
            return QLinear(w_q.t().contiguous().to(device), vec(node["w_scale"]),
                           vec(node["b"]))
        if keys == {"g", "b"}:
            return LayerNorm(vec(node["g"]), vec(node["b"]))
        if keys == {"table"}:
            return Embedding(mat(node["table"]))
        return nn.ModuleDict({k: build(v) for k, v in node.items()})

    return build(tree)


def modules_to_tree(mod: nn.Module):
    """Inverse of ``tree_to_modules``: numpy arrays in JAX layout, float32
    except the int8 W8A8 weights."""
    if isinstance(mod, nn.ModuleList):
        return [modules_to_tree(m) for m in mod]
    if isinstance(mod, nn.ModuleDict):
        return {k: modules_to_tree(m) for k, m in mod.items()}
    return mod.to_tree()


def _weight(p, dtype) -> torch.Tensor:
    w = p.weight
    return w if w.dtype == dtype else w.to(dtype)


# ---------------------------------------------------------------------------
# layers
# ---------------------------------------------------------------------------

def linear(p: Linear | QLinear, x: torch.Tensor) -> torch.Tensor:
    if isinstance(p, QLinear):
        return _linear_w8a8(p, x)
    y = F.linear(x, _weight(p, x.dtype))
    if x.dtype == torch.bfloat16:
        # accumulator rounded to bf16 BEFORE the bias add (JAX layers.py:55-62)
        return y + p.bias.to(torch.bfloat16)
    return (y + p.bias).to(x.dtype)


def _linear_w8a8(p: QLinear, x: torch.Tensor) -> torch.Tensor:
    """Dynamic-activation int8 linear in the JAX ``_linear_w8a8``'s order,
    as two kernels: per-token symmetric activation quant (round half to
    even, as ``jnp.round``), then int8 x int8 with the rescale and bias in
    f32 and one rounding to x's dtype in the product's epilogue."""
    xq, sx = quantize_rows(x.reshape(-1, x.shape[-1]).contiguous())
    y = w8a8_matmul(xq, sx, p.w_q, p.w_scale, p.bias, x.dtype)
    return y.reshape(*x.shape[:-1], -1)


def embedding(p: Embedding, ids: torch.Tensor, dtype=torch.float32) -> torch.Tensor:
    return p.table.to(dtype)[ids]


def layer_norm(p: LayerNorm, x: torch.Tensor, eps: float = 1e-5) -> torch.Tensor:
    xf = x.float()
    mean = xf.mean(-1, keepdim=True)
    var = (xf - mean).square().mean(-1, keepdim=True)
    y = (xf - mean) * torch.rsqrt(var + eps)
    if x.dtype == torch.bfloat16:
        # normalize in f32, affine in bf16 (JAX layers.py:111-117)
        return (y.to(torch.bfloat16) * p.g.to(torch.bfloat16)
                + p.b.to(torch.bfloat16))
    return (y * p.g + p.b).to(x.dtype)


def conv1d(p: Conv1d, x: torch.Tensor, *, dilation: int = 1) -> torch.Tensor:
    """x: [B, T, C] -> [B, T, C'] with SAME padding
    (d(k-1)//2, d(k-1) - d(k-1)//2), f32 accumulation and bias."""
    k = p.weight.shape[-1]
    total = dilation * (k - 1)
    h = F.pad(x.transpose(1, 2), (total // 2, total - total // 2))
    y = F.conv1d(h, _weight(p, x.dtype), p.bias.to(x.dtype), dilation=dilation)
    return y.transpose(1, 2)


# ---------------------------------------------------------------------------
# rotary position embeddings (standard + length-aware)
# ---------------------------------------------------------------------------

def rope_angles(positions: torch.Tensor, head_dim: int, theta: float):
    """positions [..., T] -> (cos, sin) each [..., T, head_dim//2]."""
    half = head_dim // 2
    freqs = torch.exp(
        -math.log(theta)
        * torch.arange(half, dtype=torch.float32, device=positions.device) / half
    )
    ang = positions.float()[..., None] * freqs
    return torch.cos(ang), torch.sin(ang)


def apply_rope(x: torch.Tensor, cos: torch.Tensor, sin: torch.Tensor) -> torch.Tensor:
    """x: [B, T, H, Dh]; cos/sin: [B, T, Dh//2] (broadcast over heads). The
    rotation runs in f32 through type promotion; x itself is not upcast."""
    x1, x2 = x.chunk(2, dim=-1)
    if cos.dim() == 3:
        cos = cos[:, :, None, :]
        sin = sin[:, :, None, :]
    out = torch.cat([x1 * cos - x2 * sin, x1 * sin + x2 * cos], dim=-1)
    return out.to(x.dtype)


def larope_positions(lengths: torch.Tensor, padded_len: int, scale: float) -> torch.Tensor:
    """Length-Aware RoPE positions: index i of a sequence of true length L
    maps to ``i * scale / L``. lengths [B] -> [B, padded_len] float32."""
    idx = torch.arange(padded_len, dtype=torch.float32, device=lengths.device)[None, :]
    return idx * (scale / torch.clamp(lengths.float(), min=1.0))[:, None]


# ---------------------------------------------------------------------------
# attention
# ---------------------------------------------------------------------------

def _split_heads(x: torch.Tensor, n_heads: int) -> torch.Tensor:
    b, t, d = x.shape
    return x.reshape(b, t, n_heads, d // n_heads)


def _merge_heads(x: torch.Tensor) -> torch.Tensor:
    b, t, h, dh = x.shape
    return x.reshape(b, t, h * dh)


def attention_core(q, k, v, key_mask=None):
    """q,v,k: [B,T,H,Dh]; key_mask [B,Tk] (1 = valid) -> [B,Tq,H,Dh].

    Routed through the attention kernel's wrapper (ops/attention.py): the
    CUDA kernel on the card, its plain version for CPU tensors. Unlike the
    JAX package's XLA path, bf16 logits are never stored: the port follows
    the Pallas kernel, whose logits stay f32."""
    return fused_attention(q, k, v, key_mask)


def _split_fused(y: torch.Tensor, parts: int, n_heads: int):
    """A fused projection's output split into head-split, contiguous parts
    (the attention kernel takes contiguous tensors)."""
    return [_split_heads(t.contiguous(), n_heads) for t in y.chunk(parts, dim=-1)]


def mha(p, x, n_heads: int, memory=None, *, key_mask=None, q_rope=None,
        k_rope=None, kv_cache=None) -> torch.Tensor:
    """Multi-head attention; self-attention when memory is None.
    ``kv_cache``: precomputed (k, v), head-split and rotated. Fused
    projections (``models.fuse_projections``): "qkv" replaces q/k/v in
    self-attention, "kv" replaces k/v in cross-attention."""
    if memory is None and kv_cache is None and "qkv" in p:
        q, k, v = _split_fused(linear(p["qkv"], x), 3, n_heads)
        if k_rope is not None:
            k = apply_rope(k, *k_rope)
    else:
        q = _split_heads(linear(p["q"], x), n_heads)
        k, v = kv_cache if kv_cache is not None else kv_project(
            p, x if memory is None else memory, n_heads, k_rope)
    if q_rope is not None:
        q = apply_rope(q, *q_rope)
    return linear(p["o"], _merge_heads(attention_core(q, k, v, key_mask)))


def kv_project(p, mem, n_heads: int, k_rope=None):
    """Project memory into head-split (k, v) with optional rotation."""
    if "kv" in p:
        k, v = _split_fused(linear(p["kv"], mem), 2, n_heads)
    else:
        k = _split_heads(linear(p["k"], mem), n_heads)
        v = _split_heads(linear(p["v"], mem), n_heads)
    if k_rope is not None:
        k = apply_rope(k, *k_rope)
    return k, v


# ---------------------------------------------------------------------------
# FFN + transformer blocks
# ---------------------------------------------------------------------------

def ffn(p, x: torch.Tensor) -> torch.Tensor:
    return linear(p["out"], F.silu(linear(p["in"], x)))


def _modulate(x, shift, scale):
    return x * (1.0 + scale) + shift


def block(p, x: torch.Tensor, n_heads: int, *, self_mask=None, self_rope=None,
          memory=None, memory_mask=None, q_rope_cross=None, k_rope_cross=None,
          cond=None, cross_kv=None, fused_ffn: bool = True) -> torch.Tensor:
    """Pre-LN transformer block: self-attn [+ cross-attn] + FFN, optionally
    AdaLN-Zero conditioned on ``cond`` [B, cond_dim]. With ``fused_ffn`` the
    AdaLN FFN sublayer goes through the fused AdaLN-FFN kernel's wrapper
    (ops/ffn.py) when its linears are plain; without it, and for W8A8
    linears, it is mod(LN), ``linear``, silu and ``linear``, as in the JAX
    package's unfused path."""
    has_cross = "cross" in p
    if cond is not None and "adaln" in p:
        n_sub = 3 if has_cross else 2
        mods = linear(p["adaln"], cond)[:, None, :].chunk(3 * n_sub, dim=-1)
    else:
        mods = None

    def mod(i, h):
        if mods is None:
            return h, 1.0
        shift, scale, gate = mods[3 * i], mods[3 * i + 1], mods[3 * i + 2]
        return _modulate(h, shift, scale), gate

    i_sub = 0
    h, gate = mod(i_sub, layer_norm(p["ln1"], x))
    x = x + gate * mha(p["self"], h, n_heads, key_mask=self_mask,
                       q_rope=self_rope, k_rope=self_rope)
    i_sub += 1
    if has_cross:
        h, gate = mod(i_sub, layer_norm(p["ln2"], x))
        x = x + gate * mha(p["cross"], h, n_heads, memory=memory,
                           key_mask=memory_mask, q_rope=q_rope_cross,
                           k_rope=k_rope_cross, kv_cache=cross_kv)
        i_sub += 1
    f = p["ffn"]
    if (fused_ffn and mods is not None and isinstance(f["in"], Linear)
            and isinstance(f["out"], Linear)):
        shift, scale, gate = (mods[3 * i_sub], mods[3 * i_sub + 1],
                              mods[3 * i_sub + 2])
        ln = p["ln3"]
        return fused_adaln_ffn(
            x, ln.g, ln.b, _weight(f["in"], x.dtype), f["in"].bias,
            _weight(f["out"], x.dtype), f["out"].bias, shift, scale, gate)
    h, gate = mod(i_sub, layer_norm(p["ln3"], x))
    return x + gate * ffn(f, h)


# ---------------------------------------------------------------------------
# time embedding (flow step conditioning)
# ---------------------------------------------------------------------------

def sinusoidal_embedding(t: torch.Tensor, dim: int, max_period: float = 10000.0) -> torch.Tensor:
    """t: [B] in [0, 1] -> [B, dim]."""
    half = dim // 2
    freqs = torch.exp(
        -math.log(max_period)
        * torch.arange(half, dtype=torch.float32, device=t.device) / half
    )
    ang = t.float()[:, None] * freqs[None, :] * 1000.0
    return torch.cat([torch.cos(ang), torch.sin(ang)], dim=-1)
