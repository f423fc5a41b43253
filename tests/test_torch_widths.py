"""The three path kernels at every width the JAX package runs them, on the
CPU: each plain version (what a CUDA tensor's kernel is held to on the card)
against the JAX package's Pallas kernel in interpret mode at head widths,
FFN widths and chain channels off the default config; the pad helpers the
wrappers use on the card, exact; each ``supports`` against a table of shapes
in and out of its kernel's domain; the whole path at two configs whose
widths differ from the default against the JAX engine on injected noise; and
the vocoder's ``fused_resblocks`` switch against JAX's, through the engine
(``TTS_VOC_FUSED``) and into the program keys."""

import dataclasses
import math

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from jax.experimental.pallas import tpu as pltpu

from supertonic_tpu import config as jconfig
from supertonic_tpu.engine import SynthesisEngine as JEngine
from supertonic_tpu.engine import VoiceStyle as JVoiceStyle
from supertonic_tpu.frontend import UnicodeProcessor as JProcessor
from supertonic_tpu.frontend import build_default_indexer as j_indexer
from supertonic_tpu.models import vocoder as jvocoder
from supertonic_tpu.ops import fused_attention_interpret
from supertonic_tpu.ops import vocoder_fused as jvf
from supertonic_tpu.ops.ffn import fused_adaln_ffn as j_fused_adaln_ffn
from supertonic_tpu_torch.engine import SynthesisEngine, VoiceStyle, programs
from supertonic_tpu_torch.frontend import UnicodeProcessor, build_default_indexer
from supertonic_tpu_torch.models import init_all, load_params, vocoder
from supertonic_tpu_torch.ops import attention, ffn, vocoder_fused

TEXTS = ["Hello there.", "A rather longer sentence, for a second row."]
F32 = dict(rtol=1e-5, atol=1e-5)  # f32 on both sides, only the sum order differs


@pytest.fixture(scope="module", autouse=True)
def env(tmp_path_factory):
    with pytest.MonkeyPatch.context() as mp:
        mp.setenv("TTS_RATE_CACHE_DIR", str(tmp_path_factory.mktemp("rates")))
        mp.delenv("TTS_VOC_FUSED", raising=False)
        mp.delenv("TTS_VOC_UP_MATMUL", raising=False)
        yield


def _t(a, dtype=torch.float32):
    return torch.as_tensor(np.asarray(a, np.float32)).to(dtype)


# ---------------------------------------------------------------------------
# each plain version against its Pallas kernel, off the default widths
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("masked", [True, False], ids=["masked", "unmasked"])
@pytest.mark.parametrize("dh", [12, 16, 32, 96, 128])
def test_attention_at_head_widths_matches_pallas(dh, masked):
    rng = np.random.default_rng(dh * 2 + masked)
    q, k, v = (rng.standard_normal((2, t, 2, dh)).astype(np.float32) for t in (19, 27, 27))
    mask = None
    if masked:
        mask = (np.arange(27)[None, :] < rng.integers(5, 28, (2, 1))).astype(np.float32)
    ref = fused_attention_interpret(jnp.asarray(q), jnp.asarray(k), jnp.asarray(v),
                                    None if mask is None else jnp.asarray(mask))
    got = attention.fused_attention(_t(q), _t(k), _t(v), None if mask is None else _t(mask))
    assert got.shape == (2, 19, 2, dh)
    np.testing.assert_allclose(got.numpy(), np.asarray(ref), **F32)


@pytest.mark.parametrize("d,f", [(64, 256), (200, 808)])
def test_adaln_ffn_at_widths_matches_pallas(d, f):
    rng = np.random.default_rng(d + f)
    b, t = 2, 13
    x = rng.standard_normal((b, t, d)).astype(np.float32)
    g = (1 + 0.1 * rng.standard_normal(d)).astype(np.float32)
    bl = (0.1 * rng.standard_normal(d)).astype(np.float32)
    w1 = (rng.standard_normal((d, f)) / np.sqrt(d)).astype(np.float32)
    b1 = (0.1 * rng.standard_normal(f)).astype(np.float32)
    w2 = (rng.standard_normal((f, d)) / np.sqrt(f)).astype(np.float32)
    b2 = (0.1 * rng.standard_normal(d)).astype(np.float32)
    shift, scale, gate = (rng.standard_normal((b, 1, d)).astype(np.float32) for _ in range(3))
    ref = j_fused_adaln_ffn(*(jnp.asarray(a) for a in
                              (x, g, bl, w1, b1, w2, b2, shift, scale, gate)), interpret=True)
    got = ffn.fused_adaln_ffn(_t(x), _t(g), _t(bl), _t(w1.T).contiguous(), _t(b1),
                              _t(w2.T).contiguous(), _t(b2), _t(shift), _t(scale), _t(gate))
    np.testing.assert_allclose(got.numpy(), np.asarray(ref), **F32)


def _chain_arrays(rng, c, t, dils, p_sparse=False, k=3):
    """x [2, t, c], the frame mask (last fifth masked) and the [P, k, C, C]
    HIO weights and [P, C] biases of a chain. ``p_sparse``: each output
    channel reads one input channel at the centre tap alone, so every conv
    sum has one term and no sum order can round it differently."""
    x = rng.standard_normal((2, t, c)).astype(np.float32)
    fm = np.ones((t,), np.float32)
    fm[-max(1, t // 5):] = 0.0
    p = len(dils)
    s = (k * c) ** -0.5
    if p_sparse:
        ws = []
        for _ in range(2):
            w = np.zeros((p, k, c, c), np.float32)
            for i in range(p):
                w[i, k // 2, rng.permutation(c), np.arange(c)] = rng.uniform(-1, 1, c)
            ws.append(w)
        wa, wb = ws
    else:
        wa, wb = ((rng.uniform(-1, 1, (p, k, c, c)) * s).astype(np.float32) for _ in range(2))
    ba, bb = ((0.1 * rng.standard_normal((p, c))).astype(np.float32) for _ in range(2))
    return x, fm, wa, ba, wb, bb


@pytest.mark.parametrize("c,k,dils", [(16, 3, (1, 3, 9)), (32, 3, (1, 3, 9)),
                                      (64, 3, (1, 3, 9)), (192, 3, (1, 3, 9)),
                                      (384, 3, (1, 3, 9)), (64, 5, (1, 3)),
                                      (32, 3, (1, 3, 9, 1, 3)), (128, 3, (1, 3, 9, 27))])
def test_resblock_chain_at_channels_matches_pallas(c, k, dils):
    """At chain channels off the default, and at a conv size, a pair count
    and a dilation the kernel runs as several launches or on its SIMT form
    in bf16."""
    rng = np.random.default_rng(c + k + len(dils))
    x, fm, wa, ba, wb, bb = _chain_arrays(rng, c, 45, dils, k=k)
    with pltpu.force_tpu_interpret_mode():
        ref = jvf.resblock_chain(*(jnp.asarray(a) for a in (x, fm, wa, ba, wb, bb)),
                                 dilations=dils)
    got = vocoder_fused.resblock_chain(*(_t(a) for a in (x, fm, wa, ba, wb, bb)), dils)
    np.testing.assert_allclose(got.numpy(), np.asarray(ref), **F32)
    np.testing.assert_array_equal(got.numpy()[:, -1], x[:, -1])  # a masked frame


# ---------------------------------------------------------------------------
# the pad helpers, exact
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("step", [attention.HEAD_STEP])
@pytest.mark.parametrize("dh", [12, 24, 40, 100, 140, 180, 200, 250])
def test_attention_head_pad_is_exact(dh, step):
    """The wrapper's zero columns up to the bf16 kernel's step of 16 (two,
    three and four 64-column panels too) with the true width's scale: the
    plain version on the padded heads, cut back to Dh, equals it on the
    heads as they are (rtol = atol = 0)."""
    rng = np.random.default_rng(dh)
    q, k, v = (_t(rng.standard_normal((2, t, 2, dh))) for t in (9, 14, 14))
    mask = _t(np.arange(14)[None, :] < np.array([[14], [6]]))
    width = -(-dh // step) * step
    padded = [attention.pad_head_dim(t, width) for t in (q, k, v)]
    assert all(t.shape[-1] == width and t.is_contiguous() for t in padded)
    assert not padded[0][..., dh:].any()
    got = attention.attention_plain(*padded, mask, scale=1.0 / math.sqrt(dh))[..., :dh]
    torch.testing.assert_close(got, attention.attention_plain(q, k, v, mask), rtol=0, atol=0)


@pytest.mark.parametrize("c,sparse", [(16, False), (32, False), (96, True), (200, True)])
def test_chain_channel_pad_is_exact(c, sparse):
    """The wrapper's zero channels up to the kernel's instance: the plain
    version on the padded chain, cut back to C, equals it on the chain as
    it is, and the padded channels stay exactly 0 (rtol = atol = 0). At C
    96 and 200 the CPU's convolution sums a padded channel row in another
    order, so those cases take weights whose sums have one term each."""
    rng = np.random.default_rng(c)
    dils = (1, 3, 9)
    args = [_t(a) for a in _chain_arrays(rng, c, 40, dils, p_sparse=sparse)]
    width = vocoder_fused.kernel_width(c)
    assert width in vocoder_fused.CHAIN_WIDTHS and width >= c
    padded = vocoder_fused.pad_channels(*args, width)
    assert padded[0].shape[-1] == width and padded[2].shape[-2:] == (width, width)
    out = vocoder_fused.resblock_chain_plain(*padded, dils)
    assert not out[..., c:].any()
    torch.testing.assert_close(out[..., :c], vocoder_fused.resblock_chain_plain(*args, dils),
                               rtol=0, atol=0)


# ---------------------------------------------------------------------------
# the kernels' domains
# ---------------------------------------------------------------------------

def test_supports_tables():
    # every head width >= 1 (wider than 256 in bf16 and 128 in f32: the
    # kernel's slices of the output columns)
    for dh, keys, ok in [(1, 1, True), (12, 5, True), (64, 370, True), (96, 1, True),
                         (128, 9, True), (129, 9, True), (256, 9, True), (320, 9, True),
                         (0, 4, False), (64, 0, False)]:
        assert attention.supports(dh, keys) is ok, (dh, keys)
    bf, f32 = torch.bfloat16, torch.float32
    for d, f, dt, ok in [(512, 2048, bf, True), (64, 256, bf, True), (200, 808, bf, True),
                         (1024, 4096, bf, True), (1032, 4096, bf, False),
                         (1032, 4096, f32, True), (200, 804, f32, False),
                         (100, 808, bf, False), (8, 8, f32, True), (0, 8, f32, False)]:
        assert ffn.supports(d, f, dt) is ok, (d, f, dt)
    d139 = (1, 3, 9)
    for c, k, dils, dt, ok in [(128, 3, d139, None, True), (256, 3, d139, None, True),
                               (16, 3, (1, 3), None, True), (384, 3, d139, None, True),
                               (385, 3, d139, None, False), (512, 3, d139, None, False),
                               (0, 3, d139, None, False), (64, 3, (0, 3), None, False),
                               (64, 3, (), None, False),
                               # any odd conv size, any number of pairs
                               (200, 5, d139, None, True), (64, 1, d139, None, True),
                               (64, 3, (1, 3, 9, 27, 1), bf, True),
                               (64, 4, (1, 3), None, False), (64, 0, (1,), None, False),
                               # any reach: a pair that no fused kernel tiles runs
                               # as two per-conv launches
                               (384, 3, (1, 3, 9, 27), bf, True),
                               (128, 3, (1, 3, 9, 27), f32, True),
                               (128, 3, (1, 3, 9, 27), None, True),
                               (384, 3, (22,), f32, True), (384, 3, (23,), f32, True),
                               (384, 3, (30,), bf, True), (384, 3, (31,), bf, True),
                               (96, 11, (1, 3, 5), None, True), (96, 11, (1, 3), None, True),
                               (96, 7, (1, 3, 7), bf, True), (96, 7, (1, 3, 7), f32, True),
                               (96, 11, (5,), None, True), (64, 3, (32,), bf, True),
                               (384, 3, (1000,), None, True),
                               (64, 3, (1,), torch.float16, False)]:
        assert vocoder_fused.supports(c, k, dils, dt) is ok, (c, k, dils, dt)


def test_chain_launch_plan_groups_pairs(monkeypatch):
    """The wrapper's launches over a chain's pairs, against a tiling that
    fits at most three pairs up to a dilation of 9, two past it, and none
    past a pair's reach of 31: the longest group with a tile, at most
    MAX_PAIRS a launch; a pair with no fused tile runs per conv."""

    def tile(width, kernel, dils, dtype):
        if max(dils) > 30:
            return -1
        if len(dils) <= 3 and max(dils) <= 9:
            return 100
        return 50 if len(dils) <= 2 else -1

    monkeypatch.setattr(vocoder_fused, "_tile", tile)
    plan = vocoder_fused.launch_plan.__wrapped__
    bf = torch.bfloat16
    assert vocoder_fused.MAX_PAIRS == 4
    fused = "fused"
    assert plan(128, 3, (1, 3, 9), bf) == ((0, 3, fused),)
    assert plan(128, 3, (1, 3, 9, 1, 3, 9, 1), bf) == ((0, 3, fused), (3, 6, fused),
                                                       (6, 7, fused))
    assert plan(128, 3, (1, 3, 9, 27), bf) == ((0, 3, fused), (3, 4, fused))
    assert plan(128, 3, (27, 1, 3), bf) == ((0, 2, fused), (2, 3, fused))
    assert plan(128, 3, (1, 31), bf) == ((0, 1, fused), (1, 2, "conv"))


def test_chain_launch_plan_routes_pairs_past_every_tile(monkeypatch):
    """Pairs that no fused tile holds, against a tiling whose fused kernel
    holds a halo of at most 31 frames: each such pair alone in a per-conv
    group, the pairs around it still grouped, and a chain of them all per
    conv."""

    def tile(width, kernel, dils, dtype):
        halo = vocoder_fused.chain_halo(kernel, dils)
        return 64 - 2 * halo if 2 * halo < 64 else -1

    monkeypatch.setattr(vocoder_fused, "_tile", tile)
    plan = vocoder_fused.launch_plan.__wrapped__
    f32 = torch.float32
    assert plan(256, 3, (1, 3, 40, 1, 3), f32) == ((0, 2, "fused"), (2, 3, "conv"),
                                                    (3, 5, "fused"))
    assert plan(256, 11, (7, 9), f32) == ((0, 1, "conv"), (1, 2, "conv"))
    assert plan(256, 3, (1,) * 6, f32) == ((0, 4, "fused"), (4, 6, "fused"))


# ---------------------------------------------------------------------------
# the whole path at two configs off the default widths
# ---------------------------------------------------------------------------

def _te_dh96_config():
    """A reference-format tts.json whose proj_out.idim is 384: the text
    encoder at width 384, Dh 96 over its 4 heads; every network one or two
    blocks deep."""
    cfg = jconfig.tts_config_from_reference_dict(
        {"ttl": {"text_encoder": {"proj_out": {"idim": 384, "odim": 512}}}})
    assert cfg.text_encoder.dim // cfg.text_encoder.n_heads == 96
    return dataclasses.replace(
        cfg, text_encoder=dataclasses.replace(cfg.text_encoder, n_layers=1),
        duration_predictor=dataclasses.replace(cfg.duration_predictor, n_layers=1),
        vector_estimator=dataclasses.replace(cfg.vector_estimator, n_layers=1))


def _ve_dh128_config():
    """The vector estimator at Dh 128 (width 256 over 2 heads, FFN 1024)
    and the vocoder's fine timelines at 384 and 192 channels."""
    cfg = jconfig.TTSConfig()
    return dataclasses.replace(
        cfg, text_encoder=dataclasses.replace(cfg.text_encoder, n_layers=1),
        duration_predictor=dataclasses.replace(cfg.duration_predictor, n_layers=1),
        vector_estimator=dataclasses.replace(cfg.vector_estimator, dim=256, n_heads=2,
                                             n_layers=1),
        vocoder=dataclasses.replace(cfg.vocoder, channels=(384, 192)))


WIDTH_CONFIGS = {"te_dh96": _te_dh96_config, "ve_dh128_voc384": _ve_dh128_config}


@pytest.mark.parametrize("name", sorted(WIDTH_CONFIGS))
def test_whole_path_at_other_widths_matches_jax_engine(name):
    """Durations rtol 1e-6 and the same latent grid; wav atol 1e-4 (f32,
    two Euler steps and the vocoder, sum order only), as at the tiny
    config (tests/test_torch_engine.py). Both engines take the JAX
    package's config object, as the tiny config's tests do."""
    cfg = WIDTH_CONFIGS[name]()
    params = init_all(0, cfg)
    rng = np.random.default_rng(42)
    ve = params["vector_estimator"]
    for key in ("out_proj", "adaln_out"):
        ve[key]["w"] = (rng.standard_normal(ve[key]["w"].shape) * 0.05).astype(np.float32)
    for bp in ve["blocks"]:
        bp["adaln"]["w"] = (rng.standard_normal(bp["adaln"]["w"].shape) * 0.05).astype(np.float32)
    st = cfg.ttl.style
    ttl = rng.standard_normal((1, st.n_style, st.style_value_dim)).astype(np.float32)
    dp = rng.standard_normal((1, cfg.dp.style.n_style,
                              cfg.dp.style.style_value_dim)).astype(np.float32)
    noise = np.random.default_rng(3).standard_normal(
        (2, 64, cfg.latent_channels)).astype(np.float32)
    jeng = JEngine(params, cfg, JProcessor(j_indexer()), precision="f32")
    jw, jd = jeng.infer_batch(TEXTS, ["en", "en"], JVoiceStyle(ttl, dp).tile(2),
                              total_step=2, noise=noise)
    eng = SynthesisEngine(params, cfg, UnicodeProcessor(build_default_indexer()),
                          precision="f32", device="cpu")
    assert eng.fused_resblocks  # the port's default: the chain kernel's path
    w, d = eng.infer_batch(TEXTS, ["en", "en"], VoiceStyle(ttl, dp).tile(2),
                           total_step=2, noise=noise)
    np.testing.assert_allclose(d, jd, rtol=1e-6)
    np.testing.assert_array_equal(np.ceil(d * cfg.sample_rate / cfg.chunk_size),
                                  np.ceil(jd * cfg.sample_rate / cfg.chunk_size))
    assert w.shape == jw.shape and np.abs(w).max() > 0
    np.testing.assert_allclose(w, jw, rtol=0, atol=1e-4)


# ---------------------------------------------------------------------------
# fused_resblocks
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("fused", [True, False], ids=["fused", "unfused"])
def test_fused_resblocks_matches_jax_vocoder(tiny_config, fused):
    """vocoder.apply(fused_resblocks=) against JAX's at the tiny config (the
    chains at 64, 32 and 16 channels), the last frames masked as bucket
    padding; f32, 1e-5. JAX's fused chains run the Pallas kernel in
    interpret mode."""
    cfg = tiny_config
    rng = np.random.default_rng(11)
    tree = vocoder.init(rng, cfg)
    mods = load_params({"vocoder": tree}, device="cpu")["vocoder"]
    lat = rng.standard_normal((2, 20, cfg.latent_channels)).astype(np.float32)
    fm = np.ones((20,), np.float32)
    fm[-4:] = 0.0
    with pltpu.force_tpu_interpret_mode():
        want = jvocoder.apply(jax.tree_util.tree_map(jnp.asarray, tree), cfg, jnp.asarray(lat),
                              frame_mask=jnp.asarray(fm), fused_resblocks=fused)
    got = vocoder.apply(mods, cfg, torch.from_numpy(lat), frame_mask=torch.from_numpy(fm),
                        fused_resblocks=fused)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), **F32)


def test_engine_reads_tts_voc_fused_once(tiny_config, monkeypatch):
    """Unset: the chain kernel's path (the port's default); "0": no chain
    reaches the kernel's wrapper; read when the engine is built."""
    params = init_all(0, tiny_config)
    proc = UnicodeProcessor(build_default_indexer())
    rng = np.random.default_rng(5)
    st = tiny_config.ttl.style
    style = VoiceStyle(rng.standard_normal((1, st.n_style, st.style_value_dim)).astype(
        np.float32), rng.standard_normal((1, tiny_config.dp.style.n_style,
                                          tiny_config.dp.style.style_value_dim)).astype(
        np.float32))
    calls = []
    real = vocoder_fused.fused_resblock
    monkeypatch.setattr(vocoder_fused, "fused_resblock",
                        lambda *a, **kw: calls.append(1) or real(*a, **kw))
    on = SynthesisEngine(params, tiny_config, proc, precision="f32", device="cpu")
    monkeypatch.setenv("TTS_VOC_FUSED", "0")
    off = SynthesisEngine(params, tiny_config, proc, precision="f32", device="cpu")
    monkeypatch.setenv("TTS_VOC_FUSED", "1")
    assert on.fused_resblocks and not off.fused_resblocks
    assert not SynthesisEngine(params, tiny_config, proc, precision="f32", device="cpu",
                               fused_resblocks=False).fused_resblocks
    off.infer_batch(TEXTS[:1], ["en"], style, total_step=1)
    assert calls == []
    on.infer_batch(TEXTS[:1], ["en"], style, total_step=1)
    assert len(calls) == 1 + len(tiny_config.vocoder.channels)  # pre_res and each stage


def test_program_keys_hold_fused_resblocks(monkeypatch):
    """The vocoding programs' keys differ between the settings (a trailing
    marker when the kernel is off), so an engine never replays a graph
    captured under the other; the keys that do not vocode do not change."""
    ids = torch.zeros((4, 64), dtype=torch.int64)
    emb = torch.zeros((4, 64, 8))
    x = torch.zeros((4, 448, 8))
    lmask = torch.zeros((4, 448))
    pairs = [
        (programs.fused_key(ids, 5, 448, "bf16", "int16"),
         programs.fused_key(ids, 5, 448, "bf16", "int16", fused_resblocks=False)),
        (programs.window_key(x, 64, 24, "bf16", "int16"),
         programs.window_key(x, 64, 24, "bf16", "int16", fused_resblocks=False)),
        (programs.acoustic_key(emb, lmask, 5, "bf16", frame_mask=True),
         programs.acoustic_key(emb, lmask, 5, "bf16", frame_mask=True,
                               fused_resblocks=False)),
        (programs.vocoder_key(x, "bf16"),
         programs.vocoder_key(x, "bf16", fused_resblocks=False)),
    ]
    for on, off in pairs:
        assert on != off and on[0] == off[0] and off[-1] == "unfused_resblocks"
    monkeypatch.setenv("TTS_VOC_FUSED", "0")
    assert not vocoder.fused_resblocks_default()
    monkeypatch.setenv("TTS_VOC_FUSED", "1")
    assert vocoder.fused_resblocks_default()
    monkeypatch.delenv("TTS_VOC_FUSED")
    assert vocoder.fused_resblocks_default()
