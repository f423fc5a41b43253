"""The int8 path's quantize pass inside its producers, on the CPU: the
quantizing LayerNorm (``ops.ln_modulate.ln_modulate_quantize``) and the W8A8
product's silu-quantize form (``ops.w8a8.w8a8_matmul(..., silu=True,
quantize=True)``) against the JAX functions whose XLA fusions they port
(``layer_norm`` + ``_modulate`` + the first half of ``_linear_w8a8``;
``jax.nn.silu(_linear_w8a8(...))`` + that half), whole W8A8 blocks and a
vector-estimator step on the new route bit for bit the earlier route, and
what the wrappers refuse. chip_smoke.py holds the CUDA kernels bit for bit
against the two-kernel pairs they replace on the card.

Tolerances. The quantize half is exact: on the same rows the port's (xq,
sx) are JAX's bit for bit. The rows themselves carry the producers' own
tolerances: the f32 LayerNorm's statistics are summed in another order than
XLA's (``ln_modulate.F32_ATOL``), the bf16 one may round its normalized
value one step away (``ln_modulate.one_step_match``), and XLA rounds the
sigmoid to bf16 before silu's product where F.silu rounds once (two bf16
steps, tests/test_torch_linear.py). So against JAX's whole chain sx is held
to the rows' tolerance and xq to one quantization step, and bit for bit
wherever the rows are bit for bit."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
import torch.nn.functional as F

from supertonic_tpu.models import layers as jL
from supertonic_tpu_torch.models import layers as L
from supertonic_tpu_torch.models import vector_estimator as tve
from supertonic_tpu_torch.ops import ln_modulate as LN
from supertonic_tpu_torch.ops import quantize, w8a8

BF16 = torch.bfloat16


def _jax_quantize(h):
    """The first half of JAX's ``_linear_w8a8`` on rows h [M, K]."""
    xf = jnp.asarray(h).astype(jnp.float32)
    sx = jnp.maximum(jnp.max(jnp.abs(xf), axis=-1, keepdims=True), 1e-12) / 127.0
    xq = jnp.round(xf / sx).astype(jnp.int8)
    return np.asarray(xq), np.asarray(sx).reshape(-1)


def _j(t):
    """A torch tensor as a JAX array of its own type."""
    if t.dtype == BF16:
        return jnp.asarray(t.float().numpy(), jnp.bfloat16)
    return jnp.asarray(t.numpy())


def _assert_quantized_like(xq, sx, jxq, jsx, rtol):
    """(xq, sx) against JAX's from rows within ``rtol`` of the port's: sx
    within rtol, xq within one step."""
    np.testing.assert_allclose(sx.numpy(), jsx, rtol=rtol, atol=0)
    assert np.abs(xq.numpy().astype(np.int32) - jxq.astype(np.int32)).max() <= 1


# ---------------------------------------------------------------------------
# the quantizing LayerNorm
# ---------------------------------------------------------------------------

def _ln_case(seed, b, t, d, modulated):
    rng = np.random.default_rng(seed)
    x = (rng.standard_normal((b, t, d)) * 2 + 0.3).astype(np.float32)
    ln = {"g": (1 + 0.2 * rng.standard_normal(d)).astype(np.float32),
          "b": (0.2 * rng.standard_normal(d)).astype(np.float32)}
    mods = (0.5 * rng.standard_normal((b, 1, 3 * d))).astype(np.float32) if modulated else None
    return x, ln, mods


@pytest.mark.parametrize("dtype", [torch.float32, BF16])
@pytest.mark.parametrize("modulated", [False, True])
@pytest.mark.parametrize("d", [24, 64])
def test_ln_quantize_matches_jax(d, modulated, dtype):
    """The quantizing LayerNorm's plain version against ``jL.layer_norm``,
    ``jL._modulate`` (shift and scale as block takes them: [B, 1, D] slices
    of one AdaLN projection) and the quantize half of ``_linear_w8a8``: on
    its own rows that half is JAX's bit for bit; JAX's rows are within the
    LayerNorm's tolerance (f32: F32_ATOL; bf16: the one-step rule), and
    every row JAX rounds to the same bf16 values quantizes bit for bit."""
    b, t = 3, 7
    x, ln, mods = _ln_case(d + 2 * modulated, b, t, d, modulated)
    tx = torch.as_tensor(x).to(dtype)
    g, bb = torch.as_tensor(ln["g"]), torch.as_tensor(ln["b"])
    want = jL.layer_norm({k: jnp.asarray(v) for k, v in ln.items()}, _j(tx))
    shift = scale = None
    if modulated:
        tm = torch.as_tensor(mods).to(dtype)
        shift, scale = tm.chunk(3, dim=-1)[:2]  # strided views, as in block
        want = jL._modulate(want, _j(shift), _j(scale))
    xq, sx = LN.ln_modulate_quantize(tx, g, bb, shift, scale)
    assert xq.dtype == torch.int8 and xq.shape == (b * t, d)
    assert sx.dtype == torch.float32 and sx.shape == (b * t,)
    rows = LN.ln_modulate(tx, g, bb, shift, scale).reshape(-1, d)
    oq, os_ = _jax_quantize(_j(rows))
    np.testing.assert_array_equal(xq.numpy(), oq)
    np.testing.assert_array_equal(sx.numpy().view(np.int32), os_.view(np.int32))
    jrows = np.asarray(jnp.asarray(want, jnp.float32)).reshape(-1, d)
    jxq, jsx = _jax_quantize(want.reshape(-1, d))
    if dtype == torch.float32:
        np.testing.assert_allclose(rows.numpy(), jrows, rtol=0, atol=LN.F32_ATOL)
        _assert_quantized_like(xq, sx, jxq, jsx, rtol=1e-5)
        return
    jgot = torch.tensor(jrows).to(BF16).reshape(b, t, d)  # exact: JAX's values are bf16
    assert LN.one_step_match(jgot, tx, g, bb, shift, scale)[1] == 1.0
    same = (rows.float().numpy() == jrows).all(-1)
    assert same.any()
    np.testing.assert_array_equal(xq.numpy()[same], jxq[same])
    np.testing.assert_array_equal(sx.numpy()[same], jsx[same])
    _assert_quantized_like(xq, sx, jxq, jsx, rtol=2.0 ** -7)


def test_ln_quantize_is_the_pair():
    """The quantizing LayerNorm is ``quantize_rows`` of ``ln_modulate``'s rows
    bit for bit (as the card's kernel is of the two kernels), with one row
    of modulation for every batch row; a constant row without shift comes
    out exactly 0 (its LayerNorm is its bias b = 0): sx the 1e-12 clamp over
    127, xq all 0."""
    x, ln, mods = _ln_case(5, 2, 5, 16, True)
    tx = torch.as_tensor(x).to(BF16)
    tx[1, 2] = 1.0
    g, bb = torch.as_tensor(ln["g"]), torch.zeros(16)
    shift, scale = torch.as_tensor(mods[:1]).to(BF16).chunk(3, dim=-1)[:2]
    xq, sx = LN.ln_modulate_quantize(tx, g, bb, shift, scale * 0)
    rq, rs = quantize.quantize_rows(LN.ln_modulate(tx, g, bb, shift, scale * 0).reshape(-1, 16))
    assert torch.equal(xq, rq) and torch.equal(sx, rs)
    row = 1 * 5 + 2
    xq, sx = LN.ln_modulate_quantize(tx, g, bb, shift * 0, scale * 0)
    assert sx[row].item() == float(np.float32(1e-12) / np.float32(127))
    assert not xq[row].any() and xq.any()


@pytest.mark.parametrize("d", [8, 64, 384, 512, 1024])
def test_ln_quantize_supports_the_int8_widths(d):
    """The quantizing form takes bf16 rows of a multiple of 8 values up to
    1,024: the int8 cell's 512 and phase 12's VE widths 384 and 192."""
    assert LN.supports_quantize(d, BF16)
    assert not LN.supports_quantize(d, torch.float32)
    assert not LN.supports_quantize(d + 4, BF16) and not LN.supports_quantize(1032, BF16)


# ---------------------------------------------------------------------------
# the W8A8 silu-quantize form
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("dtype", [torch.float32, BF16])
@pytest.mark.parametrize("m,k,n", [(64, 128, 256), (37, 32, 512), (1, 64, 768)])
def test_w8a8_silu_quantize_matches_jax(dtype, m, k, n):
    """The silu-quantize form's plain version: JAX's ``_linear_w8a8`` bit
    for bit (the W8A8 linear, tests/test_torch_int8.py), F.silu of it, then
    the quantize half of ``_linear_w8a8`` bit for bit; against
    ``jax.nn.silu(_linear_w8a8(...))`` and that half, within silu's two bf16
    steps (f32: the two CPUs' exponentials)."""
    rng = np.random.default_rng(m + k + n)
    p = {"w": (rng.standard_normal((k, n)) / np.sqrt(k)).astype(np.float32),
         "b": (0.3 * rng.standard_normal(n)).astype(np.float32)}
    q = jL.quantize_linear(p)
    mod = L.tree_to_modules(q, device="cpu")
    x = (2 * rng.standard_normal((m, k))).astype(np.float32)
    x[0] = 0.0
    xt = torch.as_tensor(x).to(dtype)
    xq, sx = quantize.quantize_rows(xt)
    hq, hs = w8a8.w8a8_matmul(xq, sx, mod.w_q, mod.w_scale, mod.bias, dtype, silu=True,
                              quantize=True)
    assert hq.dtype == torch.int8 and hq.shape == (m, n) and hs.shape == (m,)
    jy = jL._linear_w8a8({kk: jnp.asarray(v) for kk, v in q.items()}, _j(xt))
    y = torch.as_tensor(np.array(jnp.asarray(jy, jnp.float32))).to(dtype)
    assert torch.equal(y, w8a8.w8a8_matmul(xq, sx, mod.w_q, mod.w_scale, mod.bias, dtype))
    oq, os_ = _jax_quantize(_j(F.silu(y)))
    np.testing.assert_array_equal(hq.numpy(), oq)
    np.testing.assert_array_equal(hs.numpy().view(np.int32), os_.view(np.int32))
    jxq, jsx = _jax_quantize(jax.nn.silu(jy))
    _assert_quantized_like(hq, hs, jxq, jsx, rtol=2.0 ** -6 if dtype == BF16 else 1e-6)


def test_w8a8_silu_quantize_refuses_bad_operands():
    """The quantizing form is the silu form's; on the card it quantizes bf16
    rows at the shapes ``supports_silu_quantize`` takes."""
    xq = torch.zeros((4, 64), dtype=torch.int8)
    w = torch.zeros((256, 64), dtype=torch.int8)
    sx, ws, b = torch.ones(4), torch.ones(256), torch.zeros(256)
    with pytest.raises(ValueError):
        w8a8.w8a8_matmul(xq, sx, w, ws, b, BF16, quantize=True)
    for n, k in ((2048, 512), (768, 192), (384, 512), (128, 64)):
        assert w8a8.supports_silu_quantize(n, k)
    for n, k in ((2176, 512), (320, 512), (2048, 544), (2048, 48), (64, 64)):
        assert not w8a8.supports_silu_quantize(n, k)


@pytest.mark.parametrize("case", [
    "g of another width", "b of another width", "shift without scale",
    "shift of another batch", "modulation on 2-d x"])
def test_ln_quantize_refuses_bad_operands(case):
    """The wrapper's shape checks, on every device (the card's kernel also
    takes bf16 rows of ``supports_quantize``'s widths alone, and raises on
    others: there is no other route on a CUDA tensor)."""
    v = torch.ones(8)
    x = torch.ones((2, 3, 8), dtype=BF16)
    calls = {
        "g of another width": lambda: LN.ln_modulate_quantize(x, torch.ones(6), v),
        "b of another width": lambda: LN.ln_modulate_quantize(x, v, torch.ones(16)),
        "shift without scale": lambda: LN.ln_modulate_quantize(x, v, v, x[:, :1], None),
        "shift of another batch": lambda: LN.ln_modulate_quantize(
            x, v, v, torch.ones((3, 1, 8), dtype=BF16), torch.ones((3, 1, 8), dtype=BF16)),
        "modulation on 2-d x": lambda: LN.ln_modulate_quantize(x[0], v, v, x[:, :1], x[:, :1]),
    }
    with pytest.raises(ValueError):
        calls[case]()


# ---------------------------------------------------------------------------
# the new route against the earlier one
# ---------------------------------------------------------------------------

def _w8a8_block(seed, dim, ffn_mult, cross, adaln, heads):
    rng = np.random.default_rng(seed)
    p = jL.block_init(rng, dim, ffn_mult, cross_dim=dim if cross else None, adaln=adaln,
                      cond_dim=dim)
    if adaln:
        p["adaln"]["w"] = (0.3 * rng.standard_normal(p["adaln"]["w"].shape)).astype(np.float32)
    for sub in ("self", "cross"):
        if sub in p:
            p[sub] = {key: jL.quantize_linear(v) for key, v in p[sub].items()}
    p["ffn"] = {key: jL.quantize_linear(v) for key, v in p["ffn"].items()}
    mod = L.tree_to_modules(p, device="cpu", dtype=BF16)
    b, t, tk = 2, 9, 5
    kw = {}
    if cross:
        kw["memory"] = torch.as_tensor(
            rng.standard_normal((b, tk, dim)).astype(np.float32)).to(BF16)
        kw["memory_mask"] = torch.ones((b, tk))
    if adaln:
        kw["cond"] = torch.as_tensor(rng.standard_normal((b, dim)).astype(np.float32)).to(BF16)
    pos = torch.arange(t, dtype=torch.float32)[None].expand(b, t)
    kw["self_rope"] = L.rope_angles(pos, dim // heads, 10000.0)
    x = torch.as_tensor(rng.standard_normal((b, t, dim)).astype(np.float32)).to(BF16)
    return mod, x, kw


def _earlier_route(monkeypatch):
    """The route before this one: every LayerNorm writes its bf16 rows and
    the FFN-in its bf16 silu output, each quantized by its consumers'
    quantize pass."""
    monkeypatch.setattr(L, "_quantized_input", lambda x, *ps: False)
    monkeypatch.setattr(L, "supports_silu_quantize", lambda n, k: False)


def _calls(monkeypatch, names):
    seen = dict.fromkeys(names, 0)
    for name in names:
        def counted(*args, _fn=getattr(L, name), _name=name, **kw):
            seen[_name] += 1
            return _fn(*args, **kw)
        monkeypatch.setattr(L, name, counted)
    return seen


@pytest.mark.parametrize("cross,adaln", [(True, True), (False, True), (True, False)])
def test_w8a8_block_on_the_new_route_is_the_earlier_route(cross, adaln, monkeypatch):
    """A bf16 W8A8 block (FFN N 256: the silu-quantize form's shape) on the
    new route, bit for bit the block on the earlier route: ln1, ln2 and ln3
    in the quantizing form, the FFN-in in the silu-quantize form, quantize
    passes only for the O inputs and the cross K and V."""
    mod, x, kw = _w8a8_block(7 + cross + 2 * adaln, 64, 4, cross, adaln, 2)
    names = ("quantize_rows", "ln_modulate_quantize", "ln_modulate")
    with monkeypatch.context() as m:
        seen = _calls(m, names)
        got = L.block(mod, x, 2, fused_ffn=False, **kw)
    assert seen == {"quantize_rows": 1 + 2 * cross, "ln_modulate_quantize": 2 + cross,
                    "ln_modulate": 0}
    with monkeypatch.context() as m:
        _earlier_route(m)
        seen = _calls(m, names)
        want = L.block(mod, x, 2, fused_ffn=False, **kw)
    assert seen == {"quantize_rows": 4 + 3 * cross, "ln_modulate_quantize": 0,
                    "ln_modulate": 2 + cross}
    assert got.dtype == BF16 and torch.equal(got, want)


def test_ve_step_on_the_new_route_is_the_earlier_route(tiny_config, monkeypatch):
    """One int8 vector-estimator step (``vector_estimator.step`` with the
    tree ``quantize_params`` makes, bf16) bit for bit the earlier route."""
    from supertonic_tpu_torch.models import init_all, load_params, quantize_params

    cfg = tiny_config
    params = load_params(quantize_params(init_all(0, cfg)), device="cpu", dtype=BF16)
    ve = cfg.vector_estimator
    rng = np.random.default_rng(3)
    b, t, lt = 2, 12, 6
    noisy = torch.as_tensor(rng.standard_normal((b, t, cfg.latent_channels))
                            .astype(np.float32)).to(BF16)
    text = torch.as_tensor(rng.standard_normal((b, lt, cfg.ttl.proj_out_odim))
                           .astype(np.float32)).to(BF16)
    style = torch.as_tensor(rng.standard_normal((b, cfg.ttl.style.n_style,
                                                 cfg.ttl.style.style_value_dim))
                            .astype(np.float32)).to(BF16)
    args = (params["vector_estimator"], cfg, noisy, text, style, torch.ones((b, lt)),
            torch.ones((b, t)), torch.full((b,), 2.0), torch.full((b,), 5.0))
    with monkeypatch.context() as m:
        seen = _calls(m, ("ln_modulate_quantize",))
        got = tve.step(*args, dtype=BF16)
    assert seen["ln_modulate_quantize"] == 3 * ve.n_layers
    with monkeypatch.context() as m:
        _earlier_route(m)
        want = tve.step(*args, dtype=BF16)
    assert torch.equal(got, want)
