"""The W8A8 product's rope and residual forms (``ops.w8a8.w8a8_matmul`` with
``rope=`` or ``residual=``): the int8 path's Q, K and O output fusion, on
the CPU. Their plain versions bit for bit the JAX package's
``apply_rope(_split_heads(_linear_w8a8(...)))`` and ``x + gate *
_linear_w8a8(...)``; the layers' routing over whole W8A8 blocks (a bf16
``QLinear``'s Q, K and O take the forms, no bias-and-rope or gated-residual
call; one quantize pass for self Q, K and V and one for cross K and V) bit
for bit the earlier route (each linear quantized on its own, the product,
then those two kernels); f32 W8A8 blocks still on those kernels; and what
the wrapper refuses. chip_smoke.py holds the CUDA kernel against these plain
versions on the card.

No tolerance: the W8A8 product is exact and its rescale is the same f32
operations on both sides, and JAX runs ``apply_rope`` and the gated
residual op by op here (eager), so each product and sum is rounded apart
as eager PyTorch rounds it."""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from supertonic_tpu.models import layers as jL
from supertonic_tpu_torch.models import layers as L
from supertonic_tpu_torch.models import quantize_params
from supertonic_tpu_torch.ops import quantize, w8a8

BF16 = torch.bfloat16
HEAD_WIDTHS = [16, 32, 64, 96, 128, 192, 256]


def _dtypes(name):
    return (torch.float32, jnp.float32) if name == "f32" else (BF16, jnp.bfloat16)


def _w8a8_params(rng, k, n):
    """A W8A8 linear of JAX's quantize_linear, with a random bias."""
    p = {"w": (rng.standard_normal((k, n)) / np.sqrt(k)).astype(np.float32),
         "b": (0.3 * rng.standard_normal(n)).astype(np.float32)}
    return jL.quantize_linear(p)


def _jax_w8a8(q, x, jdt):
    return jL._linear_w8a8({k: jnp.asarray(v) for k, v in q.items()},
                           jnp.asarray(x.float().numpy(), jdt))


def _np(x):
    return np.asarray(jnp.asarray(x, jnp.float32))


# ---------------------------------------------------------------------------
# the forms against the JAX functions
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("dtype", ["f32", "bf16"])
@pytest.mark.parametrize("dh", HEAD_WIDTHS)
def test_w8a8_rope_form_matches_jax(dh, dtype):
    """``w8a8_matmul(..., rope=(cos, sin), n_heads=H)`` and ``layers.linear``
    of a QLinear with ``rope=`` bit for bit JAX's
    ``apply_rope(_split_heads(_linear_w8a8(p, x)))`` with LARoPE angles, and
    the earlier route: the product, then the bias-and-rope kernel's wrapper
    (``layers._heads``)."""
    tdt, jdt = _dtypes(dtype)
    rng = np.random.default_rng(dh)
    b, t, heads, k = 2, 7, 2, 64
    q = _w8a8_params(rng, k, heads * dh)
    lengths = np.array([t, t - 3], np.float32)
    pos = jL.larope_positions(jnp.asarray(lengths), t, 100.0)
    cos, sin = (np.array(a) for a in jL.rope_angles(pos, dh, 10000.0))
    mod = L.tree_to_modules(q, device="cpu")
    x = torch.as_tensor((2 * rng.standard_normal((b, t, k))).astype(np.float32)).to(tdt)
    x[0, 0] = 0.0  # a zero row (sx at its floor)
    rope = (torch.as_tensor(cos), torch.as_tensor(sin))
    xq, sx = quantize.quantize_rows(x.reshape(-1, k))
    got = w8a8.w8a8_matmul(xq, sx, mod.w_q, mod.w_scale, mod.bias, tdt, rope=rope,
                           n_heads=heads)
    assert got.dtype == tdt and got.shape == (b, t, heads, dh)
    want = _np(jL.apply_rope(jL._split_heads(_jax_w8a8(q, x, jdt), heads), cos, sin))
    np.testing.assert_array_equal(got.float().numpy(), want)
    assert torch.equal(L.linear(mod, x, rope=rope, n_heads=heads), got)
    assert torch.equal(got, L._heads(*L._product(mod, x), rope, heads))


@pytest.mark.parametrize("dtype", ["f32", "bf16"])
@pytest.mark.parametrize("gate", ["batch rows", "one row", "none"])
@pytest.mark.parametrize("n", HEAD_WIDTHS)
def test_w8a8_residual_form_matches_jax(n, gate, dtype):
    """``w8a8_matmul(..., residual=r, gate=g)`` and ``layers.linear`` of a
    QLinear with ``residual=`` bit for bit JAX's ``r + g *
    _linear_w8a8(p, h)`` with a gate of a row a batch row (a strided [B, 1,
    N] slice of one AdaLN projection, as ``block`` takes it), of one row for
    all, and without a gate (``r + _linear_w8a8``); and the earlier route:
    the product, then the gated-residual kernel's wrapper
    (``layers._close``)."""
    tdt, jdt = _dtypes(dtype)
    rng = np.random.default_rng(n + len(gate))
    b, t, k = 3, 5, 32
    q = _w8a8_params(rng, k, n)
    mod = L.tree_to_modules(q, device="cpu")
    h = torch.as_tensor(rng.standard_normal((b, t, k)).astype(np.float32)).to(tdt)
    r = torch.as_tensor(rng.standard_normal((b, t, n)).astype(np.float32)).to(tdt)
    mods = torch.as_tensor((0.5 * rng.standard_normal((b, 1, 3 * n))).astype(np.float32))
    g = {"batch rows": mods.to(tdt).chunk(3, dim=-1)[2], "one row": mods[:1].to(tdt)[..., :n],
         "none": None}[gate]
    xq, sx = quantize.quantize_rows(h.reshape(-1, k))
    got = w8a8.w8a8_matmul(xq, sx, mod.w_q, mod.w_scale, mod.bias, tdt, residual=r, gate=g)
    assert got.dtype == tdt and got.shape == (b, t, n)
    jg = 1.0 if g is None else jnp.asarray(g.float().numpy(), jdt)
    want = _np(jnp.asarray(r.float().numpy(), jdt) + jg * _jax_w8a8(q, h, jdt))
    np.testing.assert_array_equal(got.float().numpy(), want)
    assert torch.equal(L.linear(mod, h, residual=r, gate=g), got)
    assert torch.equal(got, L._close(*L._product(mod, h), r, g))


# ---------------------------------------------------------------------------
# the layers' routing over whole W8A8 blocks
# ---------------------------------------------------------------------------

def _block_params(seed, dim, *, cross, adaln):
    """block_init's tree with random biases and AdaLN weights (block_init
    zeroes them: the gates would be zero and every bias add trivial)."""
    rng = np.random.default_rng(seed)
    p = L.block_init(rng, dim, 2, cross_dim=dim if cross else None, adaln=adaln, cond_dim=dim)

    def perturb(node):
        if isinstance(node, dict):
            if set(node) == {"w", "b"}:
                node["b"] = (0.2 * rng.standard_normal(node["b"].shape)).astype(np.float32)
                if not node["w"].any():
                    node["w"] = (0.2 * rng.standard_normal(node["w"].shape)).astype(np.float32)
            for v in node.values():
                perturb(v)
    perturb(p)
    return p


def _w8a8_block(p, dtype):
    """The block's attention and FFN linears W8A8, as the int8 path's VE."""
    q = quantize_params({"vector_estimator": {"blocks": [p]}})["vector_estimator"]["blocks"][0]
    return L.tree_to_modules(q, device="cpu", dtype=dtype)


def _block_inputs(seed, dim, heads, dtype, *, cross, adaln):
    """Keyword arguments of ``layers.block``: masks with padded rows, LARoPE
    angles for the self-attention and, with ``cross``, for the cross Q and
    the memory's K (as the vector estimator), an AdaLN condition."""
    rng = np.random.default_rng(seed)
    b, t, s = 2, 9, 6
    dh = dim // heads
    kw = {"self_mask": torch.as_tensor(np.arange(t)[None] < np.array([[t], [t - 4]])).float()}
    q_pos = L.larope_positions(kw["self_mask"].sum(-1), t, 100.0)
    kw["self_rope"] = L.rope_angles(q_pos, dh, 10000.0)
    if cross:
        kw["memory"] = torch.as_tensor(rng.standard_normal((b, s, dim)).astype(np.float32)).to(
            dtype)
        kw["memory_mask"] = torch.as_tensor(np.arange(s)[None] < np.array([[s], [s - 2]])).float()
        kw["q_rope_cross"] = kw["self_rope"]
        kw["k_rope_cross"] = L.rope_angles(L.larope_positions(kw["memory_mask"].sum(-1), s,
                                                              100.0), dh, 10000.0)
    if adaln:
        kw["cond"] = torch.as_tensor(rng.standard_normal((b, dim)).astype(np.float32)).to(dtype)
    x = torch.as_tensor(rng.standard_normal((b, t, dim)).astype(np.float32)).to(dtype)
    return x, kw


def _earlier_route(monkeypatch):
    """The routing before the forms: each W8A8 linear its own quantize pass
    and product; each Q and K then the bias-and-rope kernel (or head-split),
    each O and FFN-out the gated-residual kernel."""
    real = L.linear

    def earlier(p, x, *, rope=None, n_heads=0, residual=None, gate=None, **kw):
        if rope is not None:
            return L._heads(*L._product(p, x), rope, n_heads)
        if residual is not None:
            return L._close(*L._product(p, x), residual, gate)
        y = real(p, x, **kw)
        return L._split_heads(y, n_heads) if n_heads else y
    monkeypatch.setattr(L, "linear", earlier)
    monkeypatch.setattr(L, "_quantized_once", lambda x, *ps: x)


def _counted(monkeypatch):
    """Counts of the quantize, quantizing LayerNorm, bias-and-rope and
    gated-residual wrappers' calls and of the W8A8 product's calls by form,
    over what runs after this call."""
    seen = dict.fromkeys(("quantize", "ln_modulate_quantize", "bias_rope", "gated_residual",
                          "bias", "silu", "rope", "residual"), 0)
    for name, key in (("quantize_rows", "quantize"), ("bias_rope", "bias_rope"),
                      ("gated_residual", "gated_residual"),
                      ("ln_modulate_quantize", "ln_modulate_quantize")):
        def counted(*args, _fn=getattr(L, name), _key=key, **kw):
            seen[_key] += 1
            return _fn(*args, **kw)
        monkeypatch.setattr(L, name, counted)
    real = L.w8a8_matmul

    def counting(*args, **kw):
        seen["rope" if kw.get("rope") is not None else "residual"
             if kw.get("residual") is not None else "silu" if kw.get("silu") else "bias"] += 1
        return real(*args, **kw)
    monkeypatch.setattr(L, "w8a8_matmul", counting)
    return seen


BLOCKS = {  # (cross-attention, AdaLN, dtype): the int8 path's VE blocks, and others
    "VE: cross, AdaLN, unfused FFN, bf16": (True, True, BF16),
    "cross, no AdaLN, bf16": (True, False, BF16),
    "self-attention and AdaLN, bf16": (False, True, BF16),
    "self-attention alone, bf16": (False, False, BF16),
    "VE: cross, AdaLN, unfused FFN, f32": (True, True, torch.float32)}


@pytest.mark.parametrize("heads", [2, 4])
@pytest.mark.parametrize("case", list(BLOCKS))
def test_w8a8_block_routing_is_the_earlier_route(case, heads, monkeypatch):
    """A W8A8 block (the int8 path's VE blocks take no fused FFN) bit for bit
    the block through the earlier route. In bf16 its Q and K (self and
    cross) take the rope form, its O (self and cross) and FFN-out the
    residual form, and the bias-and-rope and gated-residual wrappers are not
    called; in f32 the product keeps those two kernels after it. Either way
    one quantize pass serves self Q, K and V and one cross K and V: a
    quantize call a W8A8 linear less two for self-attention and one for
    cross-attention; in bf16 the LayerNorms whose outputs only W8A8 linears
    read (ln1, ln2, ln3) make those linears' (xq, sx) themselves, a quantize
    call fewer each, and the FFN-in's silu-quantize form makes the FFN-out's
    where it takes the FFN's width (``w8a8.supports_silu_quantize``), one
    fewer again."""
    cross, adaln, dtype = BLOCKS[case]
    dim = 64
    p = _w8a8_block(_block_params(len(case) + heads, dim, cross=cross, adaln=adaln), dtype)
    x, kw = _block_inputs(heads, dim, heads, dtype, cross=cross, adaln=adaln)
    with monkeypatch.context() as m:
        seen = _counted(m)
        got = L.block(p, x, heads, fused_ffn=False, **kw)
    n_rope, n_residual = 2 + 2 * cross, 2 + cross  # Q and K; O (and cross O) and FFN-out
    linears = 4 + 4 * cross + 2  # Q, K, V, O (self and cross), FFN in and out
    quantizing_lns = 2 + cross if dtype == BF16 else 0  # ln1, ln3 (and ln2)
    fin = p["ffn"]["in"].w_q.shape
    silu_quantize = int(dtype == BF16 and w8a8.supports_silu_quantize(*fin))
    assert seen["quantize"] == linears - 2 - cross - quantizing_lns - silu_quantize
    assert seen["ln_modulate_quantize"] == quantizing_lns
    assert seen["rope"] + seen["residual"] + seen["silu"] + seen["bias"] == linears
    assert seen["silu"] == 1
    if dtype == BF16:
        assert seen["bias_rope"] == seen["gated_residual"] == 0
        assert (seen["rope"], seen["residual"]) == (n_rope, n_residual)
    else:
        assert seen["rope"] == seen["residual"] == 0
        assert (seen["bias_rope"], seen["gated_residual"]) == (n_rope, n_residual)
    with monkeypatch.context() as m:
        _earlier_route(m)
        want = L.block(p, x, heads, fused_ffn=False, **kw)
    assert got.dtype == dtype and torch.equal(got, want)


# ---------------------------------------------------------------------------
# refusals
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("case", [
    "rope with silu", "residual with silu", "residual with rope", "a gate without the residual",
    "heads that do not divide N", "an odd head width", "cos of another length",
    "rows that are not B T", "residual of another width", "gate of another width",
    "residual on 2-d rows"])
def test_w8a8_refuses_bad_forms(case):
    xq = torch.zeros((10, 32), dtype=torch.int8)
    sx = torch.ones(10)
    w = torch.zeros((12, 32), dtype=torch.int8)
    ws, b = torch.ones(12), torch.zeros(12)
    half = (torch.zeros((2, 5, 3)), torch.zeros((2, 5, 3)))
    r = torch.zeros((2, 5, 12), dtype=BF16)

    def call(**kw):
        return w8a8.w8a8_matmul(xq, sx, w, ws, b, BF16, **kw)
    calls = {
        "rope with silu": lambda: call(rope=half, n_heads=2, silu=True),
        "residual with silu": lambda: call(residual=r, silu=True),
        "residual with rope": lambda: call(residual=r, rope=half, n_heads=2),
        "a gate without the residual": lambda: call(gate=r[:, :1]),
        "heads that do not divide N": lambda: call(rope=half, n_heads=5),
        "an odd head width": lambda: call(rope=half, n_heads=4),
        "cos of another length": lambda: call(
            rope=(torch.zeros((2, 4, 3)), torch.zeros((2, 4, 3))), n_heads=2),
        "rows that are not B T": lambda: call(residual=torch.zeros((3, 5, 12), dtype=BF16)),
        "residual of another width": lambda: call(residual=r[..., :6]),
        "gate of another width": lambda: call(residual=r, gate=torch.zeros((2, 1, 6),
                                                                           dtype=BF16)),
        "residual on 2-d rows": lambda: call(residual=r.reshape(10, 12)),
    }
    with pytest.raises(ValueError):
        calls[case]()
