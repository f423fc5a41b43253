"""The transformer block's three elementwise kernels' plain versions
(ops/ln_modulate.py, ops/rope.py, ops/gated_residual.py) on the CPU against
the JAX functions whose XLA fusions they port, on seeded numpy inputs at
tiny sizes; each wrapper's rejection of bad shapes; and the number of
launches each makes in one batch of the engine, which chip_smoke.py holds
the card's replayed batches to.

Tolerances. f32: 1e-5 absolute (only sum orders differ). bf16: the
LayerNorm against JAX, each element the plain version's affine and
modulation of the normalized value at its bf16 rounding or one bf16 step
beside it (``ln_modulate.one_step_match``: the statistics are summed in
another order); the bias add with the rotation, and the gated residual,
within one bf16 ulp of JAX's (XLA may contract a product into the f32 sum
that eager PyTorch rounds apart), fed identity weights so that the
products themselves are exact on both sides, and bit-equal to the port's
unfused eager chain."""

import dataclasses

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from supertonic_tpu.models import layers as jL
from supertonic_tpu_torch.config import (DurationPredictorHParams, TextEncoderHParams,
                                         VectorEstimatorHParams)
from supertonic_tpu_torch.engine import SynthesisEngine, VoiceStyle
from supertonic_tpu_torch.frontend import UnicodeProcessor, build_default_indexer
from supertonic_tpu_torch.models import init_all
from supertonic_tpu_torch.models import layers as L
from supertonic_tpu_torch.ops import gated_residual as GR
from supertonic_tpu_torch.ops import ln_modulate as LN
from supertonic_tpu_torch.ops import rope as R

BF16 = torch.bfloat16


def _t(a, dtype=torch.float32):
    return torch.as_tensor(np.asarray(a, np.float32)).to(dtype)


def _j(a, dtype=jnp.float32):
    return jnp.asarray(np.asarray(a, np.float32), dtype)


def _np(x):
    return np.asarray(jnp.asarray(x, jnp.float32))


def _within_one_bf16_ulp(got: torch.Tensor, want: np.ndarray) -> None:
    """|got - want| at most one bf16 step at the larger magnitude."""
    g = got.float().numpy()
    mag = np.maximum(np.abs(g), np.abs(want))
    ulp = np.exp2(np.floor(np.log2(np.maximum(mag, 2.0 ** -126))) - 7)
    assert np.all(np.abs(g - want) <= ulp), float(np.max(np.abs(g - want) / ulp))


# ---------------------------------------------------------------------------
# ln_modulate
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("dtype", ["f32", "bf16"])
@pytest.mark.parametrize("modulated", [False, True])
@pytest.mark.parametrize("d", [24, 40])
def test_ln_modulate_matches_jax(d, modulated, dtype):
    """Against jL.layer_norm, then jL._modulate with shift and scale taken
    as block takes them: [B, 1, D] slices of one AdaLN projection."""
    rng = np.random.default_rng(d + 2 * modulated)
    b, t = 3, 7
    x = rng.standard_normal((b, t, d)) * 2 + 0.3
    ln = {"g": (1 + 0.2 * rng.standard_normal(d)).astype(np.float32),
          "b": (0.2 * rng.standard_normal(d)).astype(np.float32)}
    mods = 0.5 * rng.standard_normal((b, 1, 3 * d))
    tdt, jdt = (torch.float32, jnp.float32) if dtype == "f32" else (BF16, jnp.bfloat16)
    jx, jm = _j(x, jdt), _j(mods, jdt)
    want = jL.layer_norm({k: jnp.asarray(v) for k, v in ln.items()}, jx)
    tx, tm = _t(x, tdt), _t(mods, tdt)
    g, bb = torch.as_tensor(ln["g"]), torch.as_tensor(ln["b"])
    if modulated:
        want = jL._modulate(want, jm[..., :d], jm[..., d:2 * d])
        shift, scale = tm.chunk(3, dim=-1)[:2]  # strided views, as in block
        got = LN.ln_modulate(tx, g, bb, shift, scale)
        assert torch.equal(got, LN.ln_modulate_plain(tx, g, bb, shift.contiguous(),
                                                     scale.contiguous()))
    else:
        shift = scale = None
        got = LN.ln_modulate(tx, g, bb)
    assert got.dtype == tdt and got.shape == (b, t, d)
    if dtype == "f32":
        np.testing.assert_allclose(got.numpy(), _np(want), rtol=0, atol=LN.F32_ATOL)
    else:
        jgot = torch.tensor(_np(want)).to(BF16)  # exact: JAX's values are bf16
        _bit_equal, matched = LN.one_step_match(jgot, tx, g, bb, shift, scale)
        assert matched == 1.0


def test_ln_modulate_is_the_layers_chain():
    """layers.layer_norm with shift and scale is the unfused eager chain
    (layer_norm, then h * (1 + scale) + shift) bit for bit, rank-generic
    without the modulation, and a [1, 1, D] modulation serves every row."""
    rng = np.random.default_rng(3)
    p = L.tree_to_modules({"g": (1 + 0.1 * rng.standard_normal(16)).astype(np.float32),
                           "b": (0.1 * rng.standard_normal(16)).astype(np.float32)},
                          device="cpu")
    for dtype in (torch.float32, BF16):
        x = _t(rng.standard_normal((2, 5, 16)), dtype)
        shift, scale = (_t(0.3 * rng.standard_normal((1, 1, 16)), dtype) for _ in range(2))
        h = L.layer_norm(p, x)
        assert torch.equal(L.layer_norm(p, x, shift=shift, scale=scale),
                           h * (1.0 + scale) + shift)
        assert torch.equal(L.layer_norm(p, x[0]), h[0])


# ---------------------------------------------------------------------------
# bias_rope
# ---------------------------------------------------------------------------

def _rope_case(rng, b, t, heads, dh, with_bias):
    d = heads * dh
    x = rng.standard_normal((b, t, d))
    p = {"w": np.eye(d, dtype=np.float32),  # the product is x, exactly
         "b": (rng.standard_normal(d) if with_bias else np.zeros(d)).astype(np.float32)}
    lengths = np.array([t, max(1, t - 3), 2][:b], np.float32)
    pos = jL.larope_positions(jnp.asarray(lengths), t, 100.0)  # LARoPE positions
    cos, sin = (np.array(a) for a in jL.rope_angles(pos, dh, 10000.0))
    return x, p, cos, sin


@pytest.mark.parametrize("dtype", ["f32", "bf16"])
@pytest.mark.parametrize("with_bias", [False, True])
@pytest.mark.parametrize("dh", [16, 64, 96])
def test_bias_rope_matches_jax(dh, with_bias, dtype):
    """Against jL.linear, then _split_heads and jL.apply_rope with LARoPE
    angles; and bit-equal to the port's unfused chain (linear, split,
    apply_rope). Without a bias, y is the product with its bias already in."""
    rng = np.random.default_rng(dh + with_bias)
    b, t, heads = 3, 9, 2
    x, p, cos, sin = _rope_case(rng, b, t, heads, dh, with_bias)
    tdt, jdt = (torch.float32, jnp.float32) if dtype == "f32" else (BF16, jnp.bfloat16)
    jx = _j(x, jdt)
    want = jL.apply_rope(jL._split_heads(jL.linear({k: jnp.asarray(v) for k, v in p.items()},
                                                   jx), heads),
                         jnp.asarray(cos), jnp.asarray(sin))
    mod = L.tree_to_modules(p, device="cpu", dtype=tdt)
    tx, tc, ts = _t(x, tdt), torch.as_tensor(cos), torch.as_tensor(sin)
    y, bias = (L._product(mod, tx) if with_bias else (L.linear(mod, tx), None))
    got = R.bias_rope(y, bias, tc, ts, heads)
    assert got.dtype == tdt and got.shape == (b, t, heads, dh) and got.is_contiguous()
    unfused = L.apply_rope(L._split_heads(L.linear(mod, tx), heads), tc, ts)
    assert torch.equal(got, unfused)
    if dtype == "f32":
        np.testing.assert_allclose(got.numpy(), _np(want), rtol=0, atol=1e-5)
    else:
        _within_one_bf16_ulp(got, _np(want))


def test_bias_rope_takes_a_column_slice_of_a_fused_product():
    """A fused QKV product's Q and K slices (rows strided) give what their
    contiguous copies give."""
    rng = np.random.default_rng(5)
    x, _p, cos, sin = _rope_case(rng, 2, 6, 4, 16, False)
    qkv = _t(np.concatenate([x, x[..., ::-1], x * 2], axis=-1), BF16)
    tc, ts = torch.as_tensor(cos), torch.as_tensor(sin)
    for part in qkv.chunk(3, dim=-1)[:2]:
        assert not part.is_contiguous()
        assert torch.equal(R.bias_rope(part, None, tc, ts, 4),
                           R.bias_rope(part.contiguous(), None, tc, ts, 4))


# ---------------------------------------------------------------------------
# gated_residual
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("dtype", ["f32", "bf16"])
@pytest.mark.parametrize("form", ["gate and bias", "no gate", "no bias"])
def test_gated_residual_matches_jax(form, dtype):
    """Against x + gate * jL.linear(...): a gate in x's type (a [B, 1, D]
    slice of one AdaLN projection, as block takes it), no gate (the blocks
    without AdaLN: 1.0 * o), no bias (the product with its bias already in).
    Bit-equal to the port's unfused eager chain."""
    rng = np.random.default_rng(len(form))
    b, t, d = 3, 5, 24
    x, h = rng.standard_normal((2, b, t, d))
    p = {"w": np.eye(d, dtype=np.float32), "b": rng.standard_normal(d).astype(np.float32)}
    mods = 0.5 * rng.standard_normal((b, 1, 2 * d))
    tdt, jdt = (torch.float32, jnp.float32) if dtype == "f32" else (BF16, jnp.bfloat16)
    o = jL.linear({k: jnp.asarray(v) for k, v in p.items()}, _j(h, jdt))
    jgate = _j(mods, jdt)[..., d:] if form != "no gate" else 1.0
    want = _j(x, jdt) + jgate * o
    mod = L.tree_to_modules(p, device="cpu", dtype=tdt)
    tx, th = _t(x, tdt), _t(h, tdt)
    gate = _t(mods, tdt).chunk(2, dim=-1)[1] if form != "no gate" else None
    y, bias = L._product(mod, th)
    if form == "no bias":
        y, bias = L.linear(mod, th), None
    got = GR.gated_residual(tx, y, bias, gate)
    assert got.dtype == tdt and got.shape == (b, t, d)
    assert torch.equal(got, tx + (1.0 if gate is None else gate) * L.linear(mod, th))
    if dtype == "f32":
        np.testing.assert_allclose(got.numpy(), _np(want), rtol=0, atol=1e-5)
    else:
        _within_one_bf16_ulp(got, _np(want))


# ---------------------------------------------------------------------------
# shapes each wrapper refuses
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("case", [
    "ln: g of another width", "ln: shift without scale", "ln: shift of another batch",
    "ln: modulation on 2-d x", "rope: odd head width", "rope: heads do not divide D",
    "rope: cos of another length", "rope: bias of another width",
    "residual: y of another shape", "residual: gate of another width",
    "residual: gate without its row axis"])
def test_wrappers_refuse_bad_shapes(case):
    x = torch.zeros((2, 3, 8))
    v8, half = torch.zeros(8), torch.zeros((2, 3, 2))
    calls = {
        "ln: g of another width": lambda: LN.ln_modulate(x, torch.zeros(6), v8),
        "ln: shift without scale": lambda: LN.ln_modulate(x, v8, v8, x[:, :1], None),
        "ln: shift of another batch": lambda: LN.ln_modulate(
            x, v8, v8, torch.zeros((3, 1, 8)), torch.zeros((3, 1, 8))),
        "ln: modulation on 2-d x": lambda: LN.ln_modulate(x[0], v8, v8, x[:, :1], x[:, :1]),
        "rope: odd head width": lambda: R.bias_rope(torch.zeros((2, 3, 6)), None,
                                                    torch.zeros((2, 3, 1)),
                                                    torch.zeros((2, 3, 1)), 2),
        "rope: heads do not divide D": lambda: R.bias_rope(x, None, half, half, 3),
        "rope: cos of another length": lambda: R.bias_rope(x, None, torch.zeros((2, 4, 2)),
                                                           torch.zeros((2, 4, 2)), 2),
        "rope: bias of another width": lambda: R.bias_rope(x, torch.zeros(4), half, half, 2),
        "residual: y of another shape": lambda: GR.gated_residual(x, x[:, :2], None, None),
        "residual: gate of another width": lambda: GR.gated_residual(
            x, x, None, torch.zeros((2, 1, 4))),
        "residual: gate without its row axis": lambda: GR.gated_residual(
            x, x, None, torch.zeros((2, 8))),
    }
    with pytest.raises(ValueError):
        calls[case]()


@pytest.mark.parametrize("module", [LN, R, GR])
def test_supports_states_the_domain(module):
    """Every width the JAX functions take: any D for the LayerNorm and the
    residual, any even head width for the rotation; f32 and bf16 only."""
    for width in (2, 12, 16, 96, 200, 256, 4104):
        assert module.supports(width, torch.float32) and module.supports(width, BF16)
    assert not module.supports(16, torch.float16)
    assert R.supports(96, BF16) and not R.supports(15, BF16)


# ---------------------------------------------------------------------------
# launches per batch
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("precision,fused_ffn,per_batch", [
    ("bf16", True, {"ln_modulate": 97, "bias_rope": 0, "gated_residual": 0}),
    ("bf16", False, {"ln_modulate": 127, "bias_rope": 0, "gated_residual": 0}),
    ("int8", True, {"ln_modulate": 37, "ln_modulate_quantize": 90, "bias_rope": 0,
                    "gated_residual": 0, "quantize_rows": 66})])
def test_wrapper_calls_per_batch(tiny_config, tmp_path, monkeypatch, precision, fused_ffn,
                                 per_batch):
    """One 5-step batch at the default depths (text encoder 6 blocks,
    duration predictor 4, vector estimator 6; tiny widths) calls each
    wrapper as often as chip_smoke.py requires of the card's replayed b64
    batch: LayerNorm 3 a text-side block and 2 a VE block and step with the
    fused FFN (3 without it: the int8 path takes the unfused FFN), + 3
    ln_out; no rotation or residual kernel: a bf16 plain Linear takes them
    in the linear kernel's epilogue (tests/test_torch_linear.py counts
    those), a bf16 W8A8 one (the int8 path's VE) in the W8A8 product's; and
    on the int8 path the VE's ln1, ln2 and ln3 in the quantizing form (their
    outputs feed W8A8 linears alone: 3 a block and step), the FFN-out's
    input from the FFN-in's silu-quantize form, and one quantize pass for
    each other W8A8 input: self O and cross O a VE block and step + 1 a
    block for the cross K and V."""
    monkeypatch.setenv("TTS_RATE_CACHE_DIR", str(tmp_path))
    cfg = dataclasses.replace(
        tiny_config,
        text_encoder=dataclasses.replace(tiny_config.text_encoder,
                                         n_layers=TextEncoderHParams().n_layers),
        duration_predictor=dataclasses.replace(tiny_config.duration_predictor,
                                               n_layers=DurationPredictorHParams().n_layers),
        vector_estimator=dataclasses.replace(tiny_config.vector_estimator,
                                             n_layers=VectorEstimatorHParams().n_layers))
    eng = SynthesisEngine(init_all(0, cfg), cfg, UnicodeProcessor(build_default_indexer()),
                          precision=precision, device="cpu", fused_ffn=fused_ffn)
    calls = dict.fromkeys(per_batch, 0)
    for name in per_batch:
        fn = getattr(L, name)

        def counted(*args, _fn=fn, _name=name, **kw):
            calls[_name] += 1
            return _fn(*args, **kw)
        monkeypatch.setattr(L, name, counted)
    rng = np.random.default_rng(0)
    style = VoiceStyle(rng.standard_normal((1, cfg.ttl.style.n_style,
                                            cfg.ttl.style.style_value_dim)).astype(np.float32),
                       rng.standard_normal((1, cfg.dp.style.n_style,
                                            cfg.dp.style.style_value_dim)).astype(np.float32))
    noise = rng.standard_normal((1, 256, cfg.latent_channels)).astype(np.float32)
    eng.infer_batch(["Hello there."], ["en"], style, total_step=5, noise=noise)
    assert calls == per_batch
