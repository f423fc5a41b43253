"""Masked multi-head attention: the CUDA kernel ``csrc/attention.cu`` and
its plain PyTorch version.

Replaces ``supertonic_tpu/ops/attention.py:_attn_kernel_rows`` (the Pallas
kernel behind ``fused_attention``). Contract, in the [B, T, H, Dh] layout:
``softmax(q.k^T * (1/sqrt(Dh)) + (1 - key_mask) * -1e9) v``, logits and
softmax in f32, probabilities rounded to v's dtype before the PV product,
PV accumulated in f32, output in q's dtype. In bf16 this differs from the
JAX package's XLA ``attention_core``, which stores bf16 logits; the port
follows the kernel.

What bounds the kernel on the H100 and what its design does about it is in
the header of ``csrc/attention.cu``. The C launcher picks one of two bf16
forms from the shape alone (``kernel_form`` mirrors it): at Dh 64 and Tk up
to ``ROW_KEYS`` the whole-row form, which holds a 64-query tile's whole row
of logits, as the Pallas kernel holds its panel, so each logit takes one
q.k product and one exponential; at other widths and longer rows the
two-pass kernel, whose keys stream through shared memory twice. So unlike
the Pallas kernel there is no panel cap: every Tq and Tk the path produces
runs in a kernel. ``supports`` states the kernel's domain: any
head width Dh and any Tk >= 1, as the Pallas kernel takes (in f32, and
above Dh ``MAX_PANEL_DH`` in bf16, a SIMT kernel with a grid axis over
slices of the output columns takes any Dh as it is). The bf16 tensor-core
kernel takes Dh in steps of ``HEAD_STEP`` up to ``MAX_PANEL_DH``: the
wrapper pads another Dh there with zero columns (``pad_head_dim``) and
keeps the scale 1/sqrt(Dh) of the true width, which leaves every logit and
every kept output column as they are.

``fused_attention`` is the wrapper: it runs the plain version for CPU
tensors only; CUDA tensors go to the kernel, or it raises.
"""

from __future__ import annotations

import ctypes
import math

import torch

from . import _build, _count

NEG_INF = -1e9
HEAD_STEP = 16  # the bf16 tensor-core kernel's head widths: multiples of 16
MAX_PANEL_DH = 256  # up to four 64-column panels
ROW_DH = 64  # the whole-row form's head width
ROW_KEYS = 512  # the whole-row form's cap on Tk (ROW_KEYS in csrc/attention.cu)

# q, k, v, key_mask, out, B, Tq, Tk, H, Dh, dtype code, stream, scale
_ARGTYPES = ([ctypes.c_void_p] * 5 + [ctypes.c_int] * 6 + [ctypes.c_void_p]
             + [ctypes.c_float])


def supports(head_dim: int, keys: int = 1) -> bool:
    """Whether the kernel takes heads of ``head_dim`` over ``keys`` keys."""
    return head_dim >= 1 and keys >= 1


def pad_head_dim(t: torch.Tensor, width: int) -> torch.Tensor:
    """[B, T, H, Dh] -> [B, T, H, width] with zero columns past Dh."""
    return torch.nn.functional.pad(t, (0, width - t.shape[-1])).contiguous()


def kernel_form(dtype, head_dim: int, keys: int) -> str:
    """The kernel a launch takes on the card, as ``launch`` in
    csrc/attention.cu picks it from the shape alone: "rows" (the whole-row
    form: bf16 heads padded to ``ROW_DH`` and Tk up to ``ROW_KEYS``),
    "two_pass" (the other bf16 heads up to ``MAX_PANEL_DH``) or "wide" (f32,
    and wider bf16 heads)."""
    if dtype != torch.bfloat16 or head_dim > MAX_PANEL_DH:
        return "wide"
    width = -(-head_dim // HEAD_STEP) * HEAD_STEP
    return "rows" if width == ROW_DH and keys <= ROW_KEYS else "two_pass"


def kernel_tiles() -> dict:
    """The bf16 kernels' tile choices (builds the library on first use): the
    two-pass kernel's and the whole-row form's, with its cap on Tk."""
    tiles = (ctypes.c_int * 8)()
    _build.function("attention", "stk_attention_tiles", [ctypes.c_void_p])(tiles)
    return dict(zip(("queries_per_block", "keys_per_stage", "stages", "blocks_per_sm",
                     "row_queries", "row_keys_per_tile", "row_consumers", "row_keys"),
                    tiles))


def attention_plain(q, k, v, key_mask=None, scale: float | None = None):
    """Plain PyTorch version, with the kernel's rounding points; ``scale``
    defaults to 1/sqrt(Dh)."""
    if scale is None:
        scale = 1.0 / math.sqrt(q.shape[-1])
    logits = torch.einsum("bqhd,bkhd->bhqk", q.float(), k.float()) * scale
    if key_mask is not None:
        logits = logits + ((1.0 - key_mask.float()) * NEG_INF)[:, None, None, :]
    logits = logits - logits.amax(-1, keepdim=True)
    probs = torch.exp(logits)
    probs = (probs / probs.sum(-1, keepdim=True)).to(v.dtype)
    out = torch.einsum("bhqk,bkhd->bqhd", probs.float(), v.float())
    return out.to(q.dtype)


def fused_attention(q, k, v, key_mask=None):
    """q [B,Tq,H,Dh], k/v [B,Tk,H,Dh], key_mask [B,Tk] (1 = valid) or None
    -> [B,Tq,H,Dh] in q's dtype."""
    b, tq, h, d = q.shape
    tk = k.shape[1]
    if k.shape != (b, tk, h, d) or v.shape != k.shape:
        raise ValueError(f"shape mismatch q{tuple(q.shape)} k{tuple(k.shape)} "
                         f"v{tuple(v.shape)}")
    if key_mask is not None and tuple(key_mask.shape) != (b, tk):
        raise ValueError(f"key_mask must be [B, Tk] = {(b, tk)}, got "
                         f"{tuple(key_mask.shape)}")
    if q.device.type == "cpu":
        return attention_plain(q, k, v, key_mask)
    if q.device.type != "cuda":
        raise ValueError(f"unsupported device {q.device}")
    if not (q.dtype == k.dtype == v.dtype) or q.dtype not in (torch.float32, torch.bfloat16):
        raise TypeError("q, k and v must share one dtype, float32 or bfloat16")
    if not supports(d, tk):
        raise ValueError(f"the attention kernel takes Dh >= 1 and Tk >= 1, got Dh = {d}, "
                         f"Tk = {tk}")
    for name, t in (("q", q), ("k", k), ("v", v)):
        if not t.is_contiguous() or t.device != q.device or t.data_ptr() % 16:
            raise ValueError(f"{name} must be contiguous, 16-byte aligned and on "
                             f"{q.device}")
    mask = None
    if key_mask is not None:
        mask = key_mask.to(device=q.device, dtype=torch.float32).contiguous()
    width = d
    if q.dtype == torch.bfloat16 and d <= MAX_PANEL_DH:
        width = -(-d // HEAD_STEP) * HEAD_STEP
    if width != d:
        q, k, v = (pad_head_dim(t, width) for t in (q, k, v))
    out = torch.empty_like(q)
    fn = _build.function("attention", "stk_attention", _ARGTYPES)
    with _build.on(q):
        _build.check(fn(_build.ptr(q), _build.ptr(k), _build.ptr(v),
                        _build.ptr(mask), _build.ptr(out), b, tq, tk, h, width,
                        _build.dtype_code(q.dtype), _build.stream_ptr(q),
                        1.0 / math.sqrt(d)),
                     "stk_attention")
    _count.launched("attention", (b, h, tq, tk, key_mask is not None, d))
    return out if width == d else out[..., :d].contiguous()
