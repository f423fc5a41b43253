"""The linear's output fusions of the port against the JAX package, on the
CPU: the bf16 linear with JAX's bias rounding (``ops.linear``), its silu and
flow-step-tail forms, the W8A8 product's silu form, the vocoder head's int16
egress, and the flow loop's latent LARoPE angles computed once. On CPU
tensors the wrappers run their plain versions; the CUDA kernels are held
against those plain versions on the card by chip_smoke.py."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
import torch.nn.functional as F

from supertonic_tpu.engine import synthesis as JS
from supertonic_tpu.models import layers as jL
from supertonic_tpu.models import vector_estimator as jve
from supertonic_tpu.models import vocoder as jvoc
from supertonic_tpu_torch import models as tM
from supertonic_tpu_torch.engine import synthesis
from supertonic_tpu_torch.models import layers as tL
from supertonic_tpu_torch.models import vector_estimator as tve
from supertonic_tpu_torch.models import vocoder as tvoc
from supertonic_tpu_torch.ops import conv1d, linear, quantize, w8a8


@pytest.fixture(scope="module")
def params(tiny_config):
    """init_all with the VE's zero-init heads and AdaLN gates de-zeroed (as
    chip_smoke.smoke_params does), so that out_proj's tail sees a velocity."""
    p = tM.init_all(0, tiny_config)
    rng = np.random.default_rng(42)
    ve = p["vector_estimator"]
    for key in ("out_proj", "adaln_out"):
        ve[key]["w"] = (rng.standard_normal(ve[key]["w"].shape) * 0.05).astype(np.float32)
    for bp in ve["blocks"]:
        bp["adaln"]["w"] = (rng.standard_normal(bp["adaln"]["w"].shape) * 0.05).astype(np.float32)
    return p


def _linear_case(seed, m, k, n):
    rng = np.random.default_rng(seed)
    p = {"w": (rng.standard_normal((k, n)) / np.sqrt(k)).astype(np.float32),
         "b": (0.3 * rng.standard_normal(n)).astype(np.float32)}
    x = rng.standard_normal((m, k)).astype(np.float32)
    return p, x


def _jax(dtype):
    return jnp.bfloat16 if dtype == torch.bfloat16 else jnp.float32


def _assert_linear_close(got, ref, y, dtype):
    """f32: rtol 1e-5 (the sums' order). bf16: two bf16 steps, 2^-7 (|y| +
    |ref|), the product's rounding (its sums run in another order than
    XLA's) and the bias add's, plus 2^-14 of the largest |y| for sums that
    cancel far below their terms."""
    got, ref = got.float().numpy(), np.asarray(ref, np.float32)
    assert got.shape == ref.shape
    if dtype == torch.float32:
        np.testing.assert_allclose(got, ref, rtol=1e-5, atol=1e-6)
        return
    bound = 2.0 ** -7 * (np.abs(y) + np.abs(ref)) + 2.0 ** -14 * np.abs(y).max()
    assert (np.abs(got - ref) <= bound).all(), float(np.abs(got - ref).max())


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("m,k,n", [(37, 96, 96), (130, 256, 1)])
def test_linear_matches_jax(dtype, m, k, n):
    """The bias form, through ``layers.linear`` and the wrapper's plain
    version, against the JAX ``linear``: M off 64, K 96 and N 96 (the
    estimator's in_proj and out_proj widths), N 1 (the DP's rate head)."""
    p, x = _linear_case(m + k + n, m, k, n)
    mod = tL.tree_to_modules(p, device="cpu", dtype=dtype)
    xt = torch.as_tensor(x).to(dtype)
    ref = jL.linear(p, jnp.asarray(xt.float().numpy(), _jax(dtype))).astype(jnp.float32)
    y = F.linear(xt, mod.weight).float().numpy()
    got = tL.linear(mod, xt)
    assert got.dtype == dtype
    _assert_linear_close(got, ref, y, dtype)
    if dtype == torch.bfloat16:  # the wrapper's plain version is the bf16 route
        assert torch.equal(linear.linear(xt, mod.weight, mod.bias), got)


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_linear_silu_matches_jax(dtype):
    """``linear(..., silu=True)`` against ``jax.nn.silu(linear(...))``, the
    FFN's first linear (layers.py:365): the tolerance of the bias form, silu
    moving an error by at most 1.1 times and rounding once more (2^-7 of the
    result); bit for bit F.silu of the port's bias form."""
    p, x = _linear_case(7, 45, 64, 256)
    mod = tL.tree_to_modules(p, device="cpu", dtype=dtype)
    xt = torch.as_tensor(x).to(dtype)
    ref = jax.nn.silu(jL.linear(p, jnp.asarray(xt.float().numpy(), _jax(dtype))))
    got = tL.linear(mod, xt, silu=True)
    assert torch.equal(got, F.silu(tL.linear(mod, xt)))
    y = F.linear(xt, mod.weight).float().numpy()
    _assert_linear_close(got, np.asarray(ref.astype(jnp.float32)), 1.1 * y, dtype)


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_w8a8_silu_matches_jax(dtype):
    """The W8A8 product's silu form against ``jax.nn.silu(_linear_w8a8(...))``
    (the W8A8 linear itself is bit-equal to JAX's): in bf16 within two steps
    (rtol 2^-6: XLA rounds the sigmoid to bf16 before its product, F.silu
    rounds once), in f32 the two CPUs' exponentials (rtol 1e-6); bit for bit
    F.silu of the port's W8A8 linear."""
    p, x = _linear_case(11, 64, 128, 192)
    q = jL.quantize_linear(p)
    mod = tL.tree_to_modules(q, device="cpu")
    xt = torch.as_tensor(2 * x).to(dtype)
    ref = jax.nn.silu(jL.linear(q, jnp.asarray(xt.float().numpy(), _jax(dtype))))
    got = tL.linear(mod, xt, silu=True)
    assert got.dtype == dtype
    assert torch.equal(got, F.silu(tL.linear(mod, xt)))
    rtol = 2.0 ** -6 if dtype == torch.bfloat16 else 1e-6
    np.testing.assert_allclose(got.float().numpy(), np.asarray(ref.astype(jnp.float32)),
                               rtol=rtol, atol=1e-7)
    xq, sx = quantize.quantize_rows(xt)  # the wrapper on its own operands
    assert torch.equal(w8a8.w8a8_matmul(xq, sx, mod.w_q, mod.w_scale, mod.bias, dtype, silu=True),
                       F.silu(w8a8.w8a8_matmul_plain(xq, sx, mod.w_q, mod.w_scale, mod.bias,
                                                     dtype)))


def _step_args(cfg, seed=5):
    rng = np.random.default_rng(seed)
    b, t, l = 2, 16, 12
    latent = rng.standard_normal((b, t, cfg.latent_channels)).astype(np.float32)
    emb = rng.standard_normal((b, l, cfg.ttl.proj_out_odim)).astype(np.float32)
    style = rng.standard_normal(
        (b, cfg.ttl.style.n_style, cfg.ttl.style.style_value_dim)).astype(np.float32)
    tmask = (np.arange(l)[None] < np.array([[l], [l - 3]])).astype(np.float32)
    lmask = (np.arange(t)[None] < np.array([[t], [t - 5]])).astype(np.float32)
    cur, tot = np.array([0.0, 2.0], np.float32), np.full((b,), 4.0, np.float32)
    return latent, emb, style, tmask, lmask, cur, tot


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_step_tail_matches_jax(params, tiny_config, dtype):
    """The flow step, its velocity mask and Euler update in out_proj's
    epilogue, against JAX ``vector_estimator.step``: f32 atol 1e-5 (sum
    order); bf16 atol 0.02 (the velocity's bf16 roundings through two blocks,
    times dt = 1/4, against |x| up to ~4); and bit for bit the port's earlier
    order: the masked velocity, then x + dt * v, masked."""
    cfg = tiny_config
    args = _step_args(cfg)
    targs = [torch.as_tensor(a) for a in args]
    mods = tM.load_params(params["vector_estimator"], device="cpu", dtype=dtype)
    jp = jax.tree_util.tree_map(jnp.asarray, params["vector_estimator"])
    ref = np.asarray(jve.step(jp, cfg, *map(jnp.asarray, args), dtype=_jax(dtype)))
    got = tve.step(mods, cfg, *targs, dtype=dtype)
    assert got.dtype == torch.float32
    np.testing.assert_allclose(got.numpy(), ref, rtol=0,
                               atol=1e-5 if dtype == torch.float32 else 0.02)
    latent, emb, style, tmask, lmask, cur, tot = targs
    v = tve.velocity(mods, cfg, latent, emb, style, tmask, lmask, cur / tot, dtype=dtype)
    want = (latent + (1.0 / tot)[:, None, None] * v) * lmask[:, :, None]
    assert torch.equal(got, want)


def test_linear_plain_tail_is_the_unfused_sequence():
    """``linear_plain(tail=...)`` is the bias form, then the velocity mask and
    the Euler update as the step ran them, bit for bit, in bf16 and f32."""
    rng = np.random.default_rng(3)
    b, t, k, n = 3, 21, 64, 96
    x = torch.as_tensor(rng.standard_normal((b, t, k)).astype(np.float32))
    w = torch.as_tensor((rng.standard_normal((n, k)) / 8).astype(np.float32))
    bias = torch.as_tensor(rng.standard_normal(n).astype(np.float32))
    x_in = torch.as_tensor(rng.standard_normal((b, t, n)).astype(np.float32))
    dt = torch.tensor([0.25, 0.5, 0.2])
    mask = (torch.arange(t)[None] < torch.tensor([[t], [t - 4], [3]])).float()
    for dtype in (torch.float32, torch.bfloat16):
        xd, wd = x.to(dtype), w.to(dtype)
        got = linear.linear(xd, wd, bias, tail=(x_in, dt, mask))
        v = linear.linear(xd, wd, bias).float() * mask[:, :, None]
        want = (x_in + dt[:, None, None] * v) * mask[:, :, None]
        assert got.dtype == torch.float32 and torch.equal(got, want)


def test_linear_refuses_bad_operands():
    x = torch.zeros((2, 5, 8), dtype=torch.bfloat16)
    w = torch.zeros((4, 8), dtype=torch.bfloat16)
    b = torch.zeros(4)
    with pytest.raises(ValueError, match=r"\[N\]"):
        linear.linear(x, w, torch.zeros(5))
    with pytest.raises(ValueError, match="exclusive"):
        linear.linear(x, w, b, silu=True, tail=(torch.zeros(2, 5, 4), torch.ones(2),
                                               torch.ones(2, 5)))
    with pytest.raises(ValueError, match="tail must be"):
        linear.linear(x, w, b, tail=(torch.zeros(2, 5, 3), torch.ones(2), torch.ones(2, 5)))
    with pytest.raises(ValueError, match="K"):
        linear.linear(x, torch.zeros((4, 7), dtype=torch.bfloat16), b)


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_int16_head_matches_jax_egress(params, tiny_config, dtype):
    """The vocoder with ``egress="int16"`` (the head's epilogue encodes the
    samples) bit for bit the port's ``encode_egress`` of its own f32 wav, and
    in f32 within one int16 step of JAX ``encode_egress`` of JAX's wav (the
    f32 wavs agree to ~1e-6, 0.03 of a step). The conv wrapper's int16 form
    is the plain encode of its f32 form, and takes tanh alone."""
    cfg = tiny_config
    rng = np.random.default_rng(9)
    lat = rng.standard_normal((2, 10, cfg.latent_channels)).astype(np.float32)
    fmask = (np.arange(10) < 8).astype(np.float32)
    mods = tM.load_params(params["vocoder"], device="cpu", dtype=dtype)
    kw = dict(frame_mask=torch.as_tensor(fmask), dtype=dtype)
    wav = tvoc.apply(mods, cfg, torch.as_tensor(lat), **kw)
    got = tvoc.apply(mods, cfg, torch.as_tensor(lat), egress="int16", **kw)
    assert got.dtype == torch.int16
    assert torch.equal(got, synthesis.encode_egress(wav, "int16"))
    assert synthesis.encode_egress(got, "int16") is got
    if dtype == torch.float32:
        jw = jvoc.apply(params["vocoder"], cfg, jnp.asarray(lat), frame_mask=jnp.asarray(fmask))
        ref = np.asarray(jnp.clip(jw * 32767.0, -32768.0, 32767.0).astype(jnp.int16))
        assert np.abs(got.numpy().astype(np.int32) - ref.astype(np.int32)).max() <= 1
    x = torch.randn(2, 9, 16)
    cw, cb = torch.randn(3, 16, 8) / 7, torch.randn(8)
    f32 = conv1d.conv1d_fused(x, cw, cb, silu_in=True, tanh_f32=True)
    assert torch.equal(conv1d.conv1d_fused(x, cw, cb, silu_in=True, tanh_f32=True, int16=True),
                       synthesis.encode_egress(f32, "int16"))
    with pytest.raises(ValueError, match="tanh_f32"):
        conv1d.conv1d_fused(x, cw, cb, int16=True)


def test_window_int16_matches_whole(params, tiny_config):
    """A vocoder window's int16 samples, encoded in the head and sliced, are
    bit for bit the slice of the whole vocoding's int16 samples (halo at
    the receptive field), and JAX's window function's within one step."""
    cfg = tiny_config
    rng = np.random.default_rng(4)
    t, halo, window = 24, tvoc.receptive_field_frames(cfg), 8
    lat = np.pad(rng.standard_normal((1, t, cfg.latent_channels)).astype(np.float32),
                 ((0, 0), (halo, halo), (0, 0)))
    fmask = np.pad(np.ones(t, np.float32), (halo, halo))
    mods = tM.load_params(params, device="cpu")
    whole = synthesis.vocode_window(mods, cfg, torch.as_tensor(lat), torch.as_tensor(fmask),
                                    0, t + 2 * halo, 0, precision="f32")
    chunk = cfg.chunk_size
    for start in (0, 8):
        got = synthesis.vocode_window(mods, cfg, torch.as_tensor(lat), torch.as_tensor(fmask),
                                      start, window, halo, precision="f32")
        assert got.dtype == torch.int16
        assert torch.equal(got, whole[:, (start + halo) * chunk:(start + halo + window) * chunk])
        ref = np.asarray(JS.vocode_window(params, cfg, jnp.asarray(lat), jnp.asarray(fmask),
                                          start, window, halo, precision="f32",
                                          egress="int16"))
        assert np.abs(got.numpy().astype(np.int32) - ref.astype(np.int32)).max() <= 1


def test_hoisted_latent_rope_is_the_per_step_one(params, tiny_config):
    """flow_stage computes the latent's LARoPE angles once; its latent is bit
    for bit the loop that recomputes them in every step (bf16)."""
    cfg = tiny_config
    latent, emb, style, tmask, lmask, _cur, _tot = map(torch.as_tensor, _step_args(cfg))
    mods = tM.load_params(params, device="cpu", dtype=torch.bfloat16)
    got = synthesis.flow_stage(mods, cfg, emb, style, tmask, lmask, latent, 3)
    ve = mods["vector_estimator"]
    x = latent * lmask[:, :, None]
    tot = torch.full((2,), 3.0)
    for i in range(3):
        x = tve.step(ve, cfg, x, emb, style, tmask, lmask, torch.full((2,), float(i)), tot,
                     dtype=torch.bfloat16)
    assert torch.equal(got, x)
    cos, sin = tve.latent_rope(cfg, lmask)
    cache = synthesis.cross_cache(mods, cfg, emb, style, tmask, lmask)
    assert torch.equal(cache[1], cos) and torch.equal(cache[2], sin)


def _forms_per_batch(cfg, steps, fused_ffn=True):
    """Plain-Linear ``layers.linear`` calls a batch takes, by form: the
    self and cross V and the cross Q and K (no rotation there) of each TE and
    DP block and each VE block's self V and AdaLN a step, the cross V once,
    in_proj, time_mlp2 and adaln_out a step, the three style and text
    projections, proj_out and the rate head's second linear; silu: each TE
    and DP block's FFN-in, the rate head's first linear and time_mlp1 a step
    (and each VE block's FFN-in without the fused FFN); the tail: out_proj a
    step; rope: the self Q and K of each TE and DP block and each VE block's
    self Q and K and cross Q a step, its cross K once; residual: each TE and
    DP block's self O, cross O and FFN-out, each VE block's self and cross O
    a step (and its FFN-out without the fused FFN)."""
    n_td = cfg.text_encoder.n_layers + cfg.duration_predictor.n_layers
    n_ve = cfg.vector_estimator.n_layers
    silu = n_td + 1 + steps * (1 + (0 if fused_ffn else n_ve))
    return {"bias": 4 * n_td + n_ve + steps * (2 * n_ve + 3) + 6, "silu": silu, "tail": steps,
            "rope": 2 * n_td + steps * 3 * n_ve + n_ve,
            "residual": 3 * n_td + steps * n_ve * (2 if fused_ffn else 3)}


@pytest.mark.parametrize("fused_ffn", [True, False])
def test_linear_forms_per_batch(params, tiny_config, monkeypatch, fused_ffn):
    """On CPU tensors, the bf16 plain-Linear calls of one batch reach the
    linear wrapper, each in its form: the counts a batch that phase 3 holds
    the card's launches to (354 bias, silu, tail, rope and residual calls at
    the default config, 414 without the fused FFN)."""
    seen = dict.fromkeys(linear.FORMS, 0)
    real = tL.linear_fused

    def counting(x, w, b, *, silu=False, tail=None, rope=None, n_heads=0, residual=None,
                 gate=None):
        seen["tail" if tail is not None else "rope" if rope is not None
             else "residual" if residual is not None else "silu" if silu else "bias"] += 1
        return real(x, w, b, silu=silu, tail=tail, rope=rope, n_heads=n_heads,
                    residual=residual, gate=gate)

    monkeypatch.setattr(tL, "linear_fused", counting)
    cfg = tiny_config
    rng = np.random.default_rng(1)
    st = cfg.ttl.style
    ids = torch.as_tensor(rng.integers(1, 200, (2, 16)))
    tmask = (torch.arange(16)[None] < torch.tensor([[16], [11]])).float()
    sdp, sttl = (torch.as_tensor(rng.standard_normal((2, st.n_style, st.style_value_dim))
                                 .astype(np.float32)) for _ in range(2))
    mods = tM.load_params(params, device="cpu", dtype=torch.bfloat16)
    wav, _dur = synthesis.synthesize_fused(mods, cfg, ids, tmask, sdp, sttl,
                                           torch.Generator().manual_seed(0), 1.0, 2, 24,
                                           fused_ffn=fused_ffn)
    assert wav.dtype == torch.int16
    assert seen == _forms_per_batch(tiny_config, 2, fused_ffn)
    assert sum(_forms_per_batch(_default_config(), 5).values()) == 354
    assert sum(_forms_per_batch(_default_config(), 5, fused_ffn=False).values()) == 414


def _default_config():
    from supertonic_tpu_torch.config import TTSConfig

    return TTSConfig()


def test_instance_names_match_the_kernels_lists():
    """``kernel_tiles`` and ``kernel_instance`` name the instances in the
    order csrc/linear.cu lists them: three numbers an instance in
    ``stk_linear_tiles``, one ``Instance`` enumerator an instance, then the
    SIMT kernel."""
    import re

    from supertonic_tpu_torch.ops import _build

    src = (_build.CSRC_DIR / "linear.cu").read_text()
    size = re.search(r"const int v\[(\d+)\] = \{", src)
    enum = re.search(r"enum Instance \{([^}]*)\};", src)
    assert size and enum
    assert int(size.group(1)) == 3 * len(linear._TILE_NAMES)
    assert [e.strip() for e in enum.group(1).split(",")][-1] == "I_SIMT"
    assert len(enum.group(1).split(",")) == len(linear._TILE_NAMES) + 1
