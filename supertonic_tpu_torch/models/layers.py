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
  * The transformer block's elementwise passes, which XLA fuses in the JAX
    package, each run as one kernel (ops/ln_modulate.py, ops/rope.py,
    ops/gated_residual.py) with those rounding points: ``layer_norm`` with
    the AdaLN modulation, a Q or K projection's bias add with its rotary
    embedding, and a sublayer's output bias, gate and residual. For W8A8
    and f32 linears ``linear`` takes the bias-less product (``_product``)
    and hands the bias to the kernel.
  * A bf16 ``linear`` is one launch of the linear kernel (ops/linear.py):
    the product with JAX's bias rounding in its epilogue, and there too
    the caller's silu (``silu=True``), the flow step's Euler update
    (``tail=``), a Q or K projection's rotary embedding (``rope=``) or a
    sublayer's gated residual (``residual=``, ``gate=``). f32 linears stay
    cuBLAS's product plus ``add_bias``.
  * W8A8 linears (``QLinear``, from ``models.quantize_params``) keep int8
    weights whatever the compute dtype; ``linear`` routes them through the
    quantize pass (ops/quantize.py) and the int8 product with its
    rescale-and-bias epilogue (ops/w8a8.py), in the JAX ``_linear_w8a8``'s
    order, silu too in that epilogue, and in bf16 a Q or K projection's
    rotation and a sublayer's gated residual as well (the W8A8 product's
    rope and residual forms). Linears that share an input (self Q, K and V;
    cross K and V) take one quantize pass of it (a ``Quantized`` x), as XLA
    computes it once in the JAX program; where every consumer of a block's
    LayerNorm output is a bf16 W8A8 linear, the LayerNorm kernel writes that
    pass's (xq, sx) itself (``layer_norm(..., quantize=True)``, a
    ``Quantized`` in place of the bf16 rows).
  * Tensor parallelism (``parallel.mesh``): a sharded linear is a
    ``ShardedLinear`` of per-rank shards; ``mha``, ``kv_project`` and
    ``ffn`` run each rank's heads or hidden columns on its device and sum
    the row-parallel partials onto the group's lead device
    (``col_linear``, ``row_linear``). Everything else is replicated and
    runs on the lead.

The ``*_init`` helpers are verbatim numpy copies of the JAX package's, so
that ``models.init_all`` draws the same numbers in the same order.
"""

from __future__ import annotations

import math
from typing import Any, NamedTuple

import numpy as np
import torch
import torch.nn.functional as F
from torch import nn

from ..ops.attention import fused_attention
from ..ops.conv1d import conv1d_fused, weight_buffer
from ..ops.ffn import fused_adaln_ffn
from ..ops.gated_residual import add_bias, gated_residual
from ..ops.int8_matmul import int8_matmul
from ..ops.linear import euler_tail
from ..ops.linear import linear as linear_fused
from ..ops.ln_modulate import ln_modulate, ln_modulate_quantize, supports_quantize
from ..ops.quantize import quantize_rows
from ..ops.rope import apply_rope, bias_rope  # noqa: F401 (apply_rope: this module's API)
from ..ops.w8a8 import supports_silu_quantize, w8a8_matmul

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


class ShardedLinear(nn.Module):
    """A linear split over the ranks of a model group
    (``parallel.mesh.shard_params``), each shard a ``Linear`` or ``QLinear``
    on its rank's device. ``split="col"`` (QKV, FFN-in): a rank holds its
    output columns and their bias; ``"row"`` (O, FFN-out): a rank holds its
    input rows and the whole bias, and the ranks' partial products are
    summed across the group before the bias (``row_linear``)."""

    def __init__(self, shards, split: str):
        super().__init__()
        if split not in ("col", "row"):
            raise ValueError(f"split must be 'col' or 'row', got {split!r}")
        self.shards = nn.ModuleList(shards)
        self.split = split

    def to_tree(self) -> Params:
        """The unsharded JAX-layout leaves."""
        parts = [s.to_tree() for s in self.shards]
        col = self.split == "col"
        out = {}
        for k in parts[0]:
            if k in ("w", "w_q"):
                out[k] = np.concatenate([t[k] for t in parts], axis=1 if col else 0)
            elif col:  # "b", "w_scale": per output column
                out[k] = np.concatenate([t[k] for t in parts])
            else:
                out[k] = parts[0][k]
        return out


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


class Quantized(NamedTuple):
    """An activation that only W8A8 linears read, made by its producer as
    their quantize pass would make it: xq [M, K] int8 and sx [M] f32 of the
    rows of an x of ``shape`` in ``dtype`` that was never stored. It stands
    for x where ``linear``, ``mha`` and ``kv_project`` need x's shape, dtype
    and device alone."""

    xq: torch.Tensor
    sx: torch.Tensor
    shape: torch.Size
    dtype: torch.dtype

    @property
    def device(self) -> torch.device:
        return self.xq.device


# ---------------------------------------------------------------------------
# layers
# ---------------------------------------------------------------------------

def linear(p: Linear | QLinear, x: torch.Tensor, *, silu: bool = False, tail=None,
           rope=None, n_heads: int = 0, residual=None, gate=None, quantize: bool = False):
    """JAX's ``linear`` (the bias in its rounding); with ``silu``,
    ``jax.nn.silu`` of it; with ``tail`` = (x_in [B, T, N] f32, dt [B],
    mask [B, T]), the flow step's Euler update on it as the velocity
    (``ops.linear.euler_tail``), an f32 [B, T, N]; with ``n_heads``, a Q, K
    or V projection head-split [B, T, H, Dh], rotated with ``rope`` = (cos,
    sin); with ``residual``, a sublayer's last linear closing it as
    ``residual + gate * linear`` (no gate: the blocks without AdaLN). A bf16
    ``Linear`` is one launch of the linear kernel, each of these in its
    epilogue; a W8A8 one is one quantize pass and one launch of the int8
    product, its silu and, in bf16, the rotation or the gated residual in
    that product's epilogue; an ``x`` that is a ``Quantized`` (W8A8 linears
    only: its pass made already, by its producer or for another W8A8 linear
    on it) spares the pass. With ``silu`` and
    ``quantize`` (a bf16 W8A8 linear whose output only W8A8 linears read: the
    FFN-in) a ``Quantized`` of the silu form's output, from the W8A8
    product's silu-quantize form. f32 linears and f32 W8A8 ones take the
    rotation or the gated residual in one pass after the product
    (``_heads``, ``_close``)."""
    if quantize:
        xq, sx = _quantize(x)
        hq, hs = w8a8_matmul(xq, sx, p.w_q, p.w_scale, p.bias, x.dtype, silu=True,
                             quantize=True)
        return Quantized(hq, hs, torch.Size((*x.shape[:-1], p.w_q.shape[0])), x.dtype)
    if rope is not None:
        rope = tuple(t.to(x.device) for t in rope)
    if not isinstance(p, QLinear) and x.dtype == torch.bfloat16:
        y = linear_fused(x, _weight(p, x.dtype), p.bias, silu=silu, tail=tail, rope=rope,
                         n_heads=n_heads, residual=residual, gate=gate)
        return _split_heads(y, n_heads) if n_heads and rope is None else y
    if isinstance(p, QLinear) and x.dtype == torch.bfloat16 and (
            rope is not None or residual is not None):
        return _linear_w8a8(p, x, rope=rope, n_heads=n_heads, residual=residual, gate=gate)
    if n_heads:
        return _heads(*_product(p, x), rope, n_heads)
    if residual is not None:
        return _close(*_product(p, x), residual, gate)
    if isinstance(p, QLinear):
        y = _linear_w8a8(p, x, silu=silu)
    else:
        y = add_bias(F.linear(x, _weight(p, x.dtype)), p.bias)
        if silu:
            y = F.silu(y)
    return y if tail is None else euler_tail(y, tail)


def _product(p: Linear | QLinear, x: torch.Tensor):
    """``linear`` without its bias add: (product in x's dtype, the bias
    left to add), the bias None where the product added it (W8A8)."""
    if isinstance(p, QLinear):
        return _linear_w8a8(p, x), None
    return F.linear(x, _weight(p, x.dtype)), p.bias


def _quantize(x):
    """The W8A8 linears' quantize pass of ``x`` [..., K]: (xq [M, K] int8,
    sx [M] f32); a ``Quantized`` x is its own."""
    if isinstance(x, Quantized):
        return x.xq, x.sx
    return quantize_rows(x.reshape(-1, x.shape[-1]).contiguous())


def _quantized_once(x, *ps):
    """``x`` as the linears ``ps`` sharing it take it: a ``Quantized`` of
    its one quantize pass where all of them are W8A8, else ``x`` itself
    (each linear its own pass)."""
    if isinstance(x, Quantized) or not all(isinstance(p, QLinear) for p in ps):
        return x
    return Quantized(*_quantize(x), x.shape, x.dtype)


def _linear_w8a8(p: QLinear, x: torch.Tensor, *, silu: bool = False, rope=None,
                 n_heads: int = 0, residual=None, gate=None) -> torch.Tensor:
    """Dynamic-activation int8 linear in the JAX ``_linear_w8a8``'s order,
    as two kernels: per-token symmetric activation quant (round half to
    even, as ``jnp.round``; a ``Quantized`` x is that pass made already),
    then int8 x int8 with the rescale
    and bias in f32 and one rounding to x's dtype in the product's epilogue
    (and with ``silu``, F.silu there, rounded once more; with ``rope``, the
    rotated heads [B, T, H, Dh]; with ``residual``, ``residual + gate *``
    the product: ops/w8a8.py's forms)."""
    xq, sx = _quantize(x)
    y = w8a8_matmul(xq, sx, p.w_q, p.w_scale, p.bias, x.dtype, silu=silu, rope=rope,
                    n_heads=n_heads, residual=residual, gate=gate)
    return y if rope is not None or residual is not None else y.reshape(*x.shape[:-1], -1)


def _device_of(p: nn.Module) -> torch.device:
    return next(p.parameters()).device


def col_linear(p: ShardedLinear, x: torch.Tensor) -> list[torch.Tensor]:
    """A column-parallel linear on the replicated input ``x``: each rank's
    output columns, on its device. A W8A8 linear quantizes ``x`` once and
    gives every rank the same (xq, sx): each rank's slice is then exactly
    those columns of the unsharded product."""
    if isinstance(p.shards[0], QLinear):
        xq, sx = _quantize(x)
        outs = []
        for s in p.shards:
            dev = s.w_q.device
            y = w8a8_matmul(xq.to(dev), sx.to(dev), s.w_q, s.w_scale, s.bias, x.dtype)
            outs.append(y.reshape(*x.shape[:-1], -1))
        return outs
    return [linear(s, x.to(_device_of(s))) for s in p.shards]


def row_linear(p: ShardedLinear, xs: list[torch.Tensor], out_device) -> torch.Tensor:
    """A row-parallel linear on each rank's input columns ``xs``: the
    ranks' partial products summed across the group onto ``out_device``
    (the all-reduce of the JAX mesh, explicit here), then the bias in
    ``linear``'s order. A W8A8 linear quantizes the whole activation row
    (its amax over every rank's columns, as GSPMD reduces it), takes each
    rank's int32 partial from the int8 product, sums them exactly and
    rescales once: bit for bit the unsharded ``_linear_w8a8``."""
    lead = p.shards[0]
    dtype = xs[0].dtype
    lead_shape = xs[0].shape[:-1]
    if isinstance(lead, QLinear):
        x = torch.cat([t.to(out_device) for t in xs], dim=-1)
        xq, sx = _quantize(x)
        acc, k0 = None, 0
        for s, t in zip(p.shards, xs):
            k1 = k0 + t.shape[-1]
            part = int8_matmul(xq[:, k0:k1].contiguous().to(s.w_q.device), s.w_q)
            part = part.to(out_device)
            acc = part if acc is None else acc + part  # int32: exact
            k0 = k1
        y = acc.float() * sx[:, None] * lead.w_scale.to(out_device)
        y = (y + lead.bias.to(out_device)).to(dtype)
        return y.reshape(*lead_shape, -1)
    acc = None
    for s, t in zip(p.shards, xs):
        part = F.linear(t, _weight(s, dtype)).to(out_device, torch.float32)
        acc = part if acc is None else acc + part
    if dtype == torch.bfloat16:
        acc = acc.to(torch.bfloat16)
    return add_bias(acc, lead.bias.to(out_device)).to(dtype)


def tp_ranks(p) -> int:
    """The model-group size of an attention or FFN sublayer's params (1
    when unsharded)."""
    for leaf in p.values():
        if isinstance(leaf, ShardedLinear):
            return len(leaf.shards)
    return 1


def embedding(p: Embedding, ids: torch.Tensor, dtype=torch.float32) -> torch.Tensor:
    return p.table.to(dtype)[ids]


def layer_norm(p: LayerNorm, x: torch.Tensor, eps: float = 1e-5, *, shift=None,
               scale=None, quantize: bool = False):
    """LayerNorm of x [B, T, D] (normalize in f32, affine in x's dtype),
    with ``shift``/``scale`` [B, 1, D] the AdaLN modulation ``h * (1 +
    scale) + shift`` too: one pass of the LayerNorm kernel
    (ops/ln_modulate.py). With ``quantize`` (bf16, for W8A8 consumers
    alone) a ``Quantized`` of that output from the kernel's quantizing form:
    the bf16 rows are never stored."""
    if quantize:
        xq, sx = ln_modulate_quantize(x, p.g, p.b, shift, scale, eps=eps)
        return Quantized(xq, sx, x.shape, x.dtype)
    return ln_modulate(x, p.g, p.b, shift, scale, eps=eps)


def _quantized_input(x: torch.Tensor, *ps) -> bool:
    """Whether a LayerNorm output ``x`` whose consumers are the linears
    ``ps`` is better made quantized: every one a W8A8 linear, in bf16, at a
    width the quantizing LayerNorm takes."""
    return (all(isinstance(p, QLinear) for p in ps)
            and supports_quantize(x.shape[-1], x.dtype))


def conv_weight(p: Conv1d, dtype) -> torch.Tensor:
    """The conv's weight in the JAX layout [k, Cin, Cout] (HIO), in
    ``dtype``, in the conv kernel's rows (``conv1d.weight_buffer``: bf16
    rows padded to 8 elements where Cout is no multiple of 8): one copy."""
    cout, cin, k = p.weight.shape
    w = weight_buffer(k, cin, cout, dtype, p.weight.device)
    return w.copy_(p.weight.permute(2, 1, 0))


def conv1d(p: Conv1d, x: torch.Tensor, *, dilation: int = 1, **fused) -> torch.Tensor:
    """x: [B, T, C] -> [B, T, C'] with SAME padding
    (d(k-1)//2, d(k-1) - d(k-1)//2), f32 accumulation and the f32 bias
    before one rounding (JAX layers.py:145): the conv kernel's wrapper
    (ops/conv1d.py), which ``fused`` options (silu_in, silu_out, mask,
    fold, residual, tanh_f32, int16) pass to."""
    return conv1d_fused(x.contiguous(), conv_weight(p, x.dtype), p.bias, dilation=dilation,
                        **fused)


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


def _heads(y: torch.Tensor, bias, rope, n_heads: int) -> torch.Tensor:
    """A projection's product ``y`` [B, T, H * Dh] (maybe a column slice of a
    fused one) with ``bias`` added, head-split, contiguous (the attention
    kernel takes contiguous tensors) and, with ``rope`` = (cos, sin),
    rotated: then one pass of the bias-and-rope kernel (ops/rope.py)."""
    if rope is not None:
        cos, sin = (t.to(y.device) for t in rope)
        return bias_rope(y, bias, cos, sin, n_heads)
    y = y.contiguous() if bias is None else add_bias(y, bias)
    return _split_heads(y, n_heads)


def _close(y: torch.Tensor, bias, residual, gate) -> torch.Tensor:
    """A sublayer's output: ``y`` + ``bias`` alone, or with ``residual``
    ``residual + gate * (y + bias)`` in one pass of the gated-residual
    kernel (ops/gated_residual.py; no gate: the blocks without AdaLN)."""
    if residual is None:
        return y if bias is None else add_bias(y, bias)
    return gated_residual(residual, y, bias, gate)


def mha(p, x, n_heads: int, memory=None, *, key_mask=None, q_rope=None,
        k_rope=None, kv_cache=None, residual=None, gate=None) -> torch.Tensor:
    """Multi-head attention; self-attention when memory is None.
    ``kv_cache``: precomputed (k, v), head-split and rotated. Fused
    projections (``models.fuse_projections``): "qkv" replaces q/k/v in
    self-attention, "kv" replaces k/v in cross-attention. With
    ``residual``, returns ``residual + gate * attention`` (O's bias, the
    gate and the residual in one pass: for a bf16 ``Linear`` the linear
    kernel's epilogue, where its Q and K also rotate; for a bf16 W8A8 one
    the int8 product's). W8A8 self Q, K and V take one quantize pass of
    ``x``. Sharded over a model group
    (``ShardedLinear``), each rank runs its own heads through the attention
    kernel, and O sums the ranks' partials (``row_linear``); ``kv_cache``
    is then the per-rank list of ``kv_project``."""
    if isinstance(p["o"], ShardedLinear):
        return _mha_tp(p, x, n_heads, memory, key_mask, q_rope, k_rope, kv_cache,
                       residual, gate)
    if memory is None and kv_cache is None and "qkv" in p:
        q, k, v = linear(p["qkv"], x).chunk(3, dim=-1)
        q, k, v = (_heads(t, None, rope, n_heads) for t, rope in
                   ((q, q_rope), (k, k_rope), (v, None)))
    else:
        if memory is None and kv_cache is None:  # self Q, K and V: one quantize pass
            x = _quantized_once(x, p["q"], p["k"], p["v"])
        q = linear(p["q"], x, rope=q_rope, n_heads=n_heads)
        k, v = kv_cache if kv_cache is not None else kv_project(
            p, x if memory is None else memory, n_heads, k_rope)
    o = _merge_heads(attention_core(q, k, v, key_mask))
    return linear(p["o"], o, residual=residual, gate=gate)


def _mha_tp(p, x, n_heads, memory, key_mask, q_rope, k_rope, kv_cache, residual, gate):
    ranks = len(p["o"].shards)
    kvs = kv_cache if kv_cache is not None else kv_project(
        p, x if memory is None else memory, n_heads, k_rope)
    outs = []
    for q, (k, v) in zip(col_linear(p["q"], x), kvs):
        q = _heads(q, None, q_rope, n_heads // ranks)
        mask = None if key_mask is None else key_mask.to(q.device)
        outs.append(_merge_heads(attention_core(q, k, v, mask)))
    return _close(row_linear(p["o"], outs, x.device), None, residual, gate)


def kv_project(p, mem, n_heads: int, k_rope=None):
    """Project memory into head-split (k, v) with optional rotation; over
    a model group, a list of each rank's (k, v) for its heads. W8A8 K and V
    take one quantize pass of ``mem`` (none where ``mem`` is a
    ``Quantized``)."""
    if "k" in p and isinstance(p["k"], ShardedLinear):
        ranks = len(p["k"].shards)
        return [(_heads(k, None, k_rope, n_heads // ranks), _split_heads(v, n_heads // ranks))
                for k, v in zip(col_linear(p["k"], mem), col_linear(p["v"], mem))]
    if "kv" in p:
        k, v = linear(p["kv"], mem).chunk(2, dim=-1)
        return _heads(k, None, k_rope, n_heads), _heads(v, None, None, n_heads)
    mem = _quantized_once(mem, p["k"], p["v"])
    return (linear(p["k"], mem, rope=k_rope, n_heads=n_heads),
            linear(p["v"], mem, n_heads=n_heads))


# ---------------------------------------------------------------------------
# FFN + transformer blocks
# ---------------------------------------------------------------------------

def ffn(p, x, *, residual=None, gate=None) -> torch.Tensor:
    """linear, silu, linear; with ``residual``, ``residual + gate * ffn``
    (the second linear's bias, the gate and the residual in one pass). In
    bf16 with W8A8 linears the first one's silu form quantizes its rows for
    the second (``linear(..., quantize=True)``), where that form takes the
    shape."""
    if isinstance(p["in"], ShardedLinear):
        y = row_linear(p["out"], [F.silu(u) for u in col_linear(p["in"], x)], x.device)
        return _close(y, None, residual, gate)
    fin = p["in"]
    quantize = (isinstance(fin, QLinear) and isinstance(p["out"], QLinear)
                and x.dtype == torch.bfloat16
                and supports_silu_quantize(fin.w_q.shape[0], fin.w_q.shape[1]))
    h = linear(fin, x, silu=True, quantize=quantize)
    return linear(p["out"], h, residual=residual, gate=gate)


def block(p, x: torch.Tensor, n_heads: int, *, self_mask=None, self_rope=None,
          memory=None, memory_mask=None, q_rope_cross=None, k_rope_cross=None,
          cond=None, cross_kv=None, fused_ffn: bool = True) -> torch.Tensor:
    """Pre-LN transformer block: self-attn [+ cross-attn] + FFN, optionally
    AdaLN-Zero conditioned on ``cond`` [B, cond_dim]. Each sublayer opens
    with one pass of the LayerNorm kernel (with the AdaLN shift and scale;
    its quantizing form where every consumer of its output is a bf16 W8A8
    linear: self Q, K and V, cross Q, the FFN-in) and closes with the gated
    residual: the linear kernel's residual form for a bf16 ``Linear``, the
    W8A8 product's for a bf16 W8A8 one, else the gated-residual kernel.
    With ``fused_ffn`` the AdaLN FFN sublayer goes through the fused
    AdaLN-FFN kernel's wrapper (ops/ffn.py) when its linears are plain;
    without it, and for W8A8 linears, it is mod(LN), ``linear``, silu and
    ``linear``, as in the JAX package's unfused path. Over a model group (``ShardedLinear``) it
    is the unfused path too: the kernel fuses the bias, gate and residual
    into its second product's epilogue, which cannot take partial sums."""
    has_cross = "cross" in p
    if cond is not None and "adaln" in p:
        n_sub = 3 if has_cross else 2
        mods = linear(p["adaln"], cond)[:, None, :].chunk(3 * n_sub, dim=-1)
    else:
        mods = None

    def sub(i):
        """Sublayer i's (shift, scale, gate), None without AdaLN."""
        return (None,) * 3 if mods is None else mods[3 * i:3 * i + 3]

    def ln(name, i, *consumers):
        shift, scale, _gate = sub(i)
        return layer_norm(p[name], x, shift=shift, scale=scale,
                          quantize=_quantized_input(x, *consumers))

    a = p["self"]
    x = mha(a, ln("ln1", 0, *([a["qkv"]] if "qkv" in a else [a["q"], a["k"], a["v"]])),
            n_heads, key_mask=self_mask, q_rope=self_rope, k_rope=self_rope, residual=x,
            gate=sub(0)[2])
    i_sub = 1
    if has_cross:
        x = mha(p["cross"], ln("ln2", 1, p["cross"]["q"]), n_heads, memory=memory,
                key_mask=memory_mask, q_rope=q_rope_cross, k_rope=k_rope_cross,
                kv_cache=cross_kv, residual=x, gate=sub(1)[2])
        i_sub = 2
    f = p["ffn"]
    if (fused_ffn and mods is not None and isinstance(f["in"], Linear)
            and isinstance(f["out"], Linear)):
        shift, scale, gate = sub(i_sub)
        ln3 = p["ln3"]
        return fused_adaln_ffn(
            x, ln3.g, ln3.b, _weight(f["in"], x.dtype), f["in"].bias,
            _weight(f["out"], x.dtype), f["out"].bias, shift, scale, gate)
    return ffn(f, ln("ln3", i_sub, f["in"]), residual=x, gate=sub(i_sub)[2])


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
