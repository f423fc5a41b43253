"""The port's streaming slice on the CPU, held against the JAX package: the
flow stage and windowed vocoding against JAX's on the same inputs, window
interiors against whole-sequence vocoding, long-form and windowed streaming
(mirroring tests/test_stream.py), mu-law egress bit for bit, and the
per-step progress path."""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from supertonic_tpu.engine import SynthesisEngine as JEngine
from supertonic_tpu.engine import VoiceStyle as JVoiceStyle
from supertonic_tpu.engine import synthesis as JS
from supertonic_tpu.frontend import UnicodeProcessor as JProcessor
from supertonic_tpu.frontend import build_default_indexer as j_indexer
from supertonic_tpu.models.vocoder import receptive_field_frames as j_receptive_field
from supertonic_tpu.utils import mulaw as jmulaw
from supertonic_tpu_torch.engine import SynthesisEngine, VoiceStyle, synthesis
from supertonic_tpu_torch.frontend import (UnicodeProcessor, build_default_indexer,
                                           chunk_text)
from supertonic_tpu_torch.models import init_all, load_params, vocoder
from supertonic_tpu_torch.models.vocoder import receptive_field_frames
from supertonic_tpu_torch.utils import mulaw

# random weights predict long durations (~0.06 s a character at the tiny
# config); the long-text tests speak at FAST to keep the latents short
FAST = 3.0
LONG = " ".join(
    f"Sentence number {i} continues the long running document with a few "
    "extra words for padding." for i in range(5)
)  # ~460 chars -> two 300-char chunks (a short LONG keeps the CPU run quick)


@pytest.fixture(scope="module", autouse=True)
def _few_threads():
    """The suite runs several test processes at once: two threads each keep
    these many small ops from oversubscribing the host's cores."""
    n = torch.get_num_threads()
    torch.set_num_threads(min(n, 2))
    yield
    torch.set_num_threads(n)


@pytest.fixture(scope="module")
def params(tiny_config):
    """init_all with the zero-init heads of the vector estimator perturbed,
    so the flow loop does real work."""
    p = init_all(0, tiny_config)
    rng = np.random.default_rng(42)
    ve = p["vector_estimator"]
    for key in ("out_proj", "adaln_out"):
        ve[key]["w"] = (rng.standard_normal(ve[key]["w"].shape) * 0.05).astype(np.float32)
    for bp in ve["blocks"]:
        bp["adaln"]["w"] = (rng.standard_normal(bp["adaln"]["w"].shape) * 0.05).astype(np.float32)
    return p


@pytest.fixture(scope="module")
def mods(params):
    return load_params(params, device="cpu")


@pytest.fixture(scope="module")
def style_arrays(tiny_config):
    rng = np.random.default_rng(7)
    cfg = tiny_config
    return (rng.standard_normal((1, cfg.ttl.style.n_style,
                                 cfg.ttl.style.style_value_dim)).astype(np.float32),
            rng.standard_normal((1, cfg.dp.style.n_style,
                                 cfg.dp.style.style_value_dim)).astype(np.float32))


@pytest.fixture(scope="module")
def rate_dir(tmp_path_factory):
    with pytest.MonkeyPatch.context() as mp:
        d = tmp_path_factory.mktemp("rates")
        mp.setenv("TTS_RATE_CACHE_DIR", str(d))
        yield d


@pytest.fixture(scope="module")
def engine(params, tiny_config, rate_dir):
    return SynthesisEngine(params, tiny_config, UnicodeProcessor(build_default_indexer()),
                           precision="f32", device="cpu")


@pytest.fixture(scope="module")
def style(style_arrays):
    return VoiceStyle(*style_arrays)


def test_flow_stage_matches_jax(params, mods, tiny_config):
    """f32, two Euler steps, same inputs: atol 1e-4 (sum order only), as the
    engine's injected-noise test."""
    cfg = tiny_config
    rng = np.random.default_rng(5)
    b, l_len, t_len = 2, 24, 40
    emb = rng.standard_normal((b, l_len, cfg.ttl.proj_out_odim)).astype(np.float32)
    sttl = rng.standard_normal((b, cfg.ttl.style.n_style,
                                cfg.ttl.style.style_value_dim)).astype(np.float32)
    tmask = (np.arange(l_len)[None] < np.array([[24], [15]])).astype(np.float32)
    lmask = (np.arange(t_len)[None] < np.array([[40], [27]])).astype(np.float32)
    noise = rng.standard_normal((b, t_len, cfg.latent_channels)).astype(np.float32)
    want = np.asarray(JS.flow_stage(params, cfg, emb, sttl, tmask, lmask, noise, 2,
                                    precision="f32"))
    got = synthesis.flow_stage(mods, cfg, *(torch.as_tensor(a) for a in
                                            (emb, sttl, tmask, lmask, noise)), 2,
                               precision="f32")
    assert got.shape == want.shape == (b, t_len, cfg.latent_channels)
    np.testing.assert_allclose(got.numpy(), want, rtol=0, atol=1e-4)
    assert np.all(got.numpy()[1, 27:] == 0.0)  # masked frames stay zero


def test_flow_fused_is_flow_stage_on_its_noise(mods, tiny_config, engine, style):
    """flow_fused = text stage + the noise its generator draws + flow_stage;
    the frame mask is the batch max of the latent mask."""
    cfg = tiny_config
    texts = ["Hello there.", "A rather longer sentence, for a second row."]
    dev_args, *_ = engine._prepare_inputs(texts, ["en", "en"], style.tile(2))
    t_pad = 64
    xt, dur, fmask = synthesis.flow_fused(mods, cfg, *dev_args,
                                          torch.Generator().manual_seed(3), 1.05, 2,
                                          t_pad, precision="f32")
    dur_t, emb = synthesis.text_stage(mods, cfg, *dev_args, 1.05, precision="f32")
    lmask = synthesis._latent_mask(cfg, dur_t, t_pad)
    noise = torch.randn((dev_args[0].shape[0], t_pad, cfg.latent_channels),
                        generator=torch.Generator().manual_seed(3))
    want = synthesis.flow_stage(mods, cfg, emb, dev_args[3], dev_args[1], lmask, noise, 2,
                                precision="f32")
    torch.testing.assert_close(xt, want, rtol=0, atol=0)
    torch.testing.assert_close(dur, dur_t, rtol=0, atol=0)
    torch.testing.assert_close(fmask, lmask.amax(0), rtol=0, atol=0)


def _padded_latent(cfg, t_len, halo, seed=3, valid=None):
    rng = np.random.default_rng(seed)
    xt = rng.standard_normal((1, t_len, cfg.latent_channels)).astype(np.float32)
    mask = np.zeros(t_len, np.float32)
    mask[:t_len if valid is None else valid] = 1.0
    xt_pad = np.pad(xt, ((0, 0), (halo, halo), (0, 0)))
    return xt, mask, xt_pad, np.pad(mask, (halo, halo))


@pytest.mark.parametrize("start", [0, 5, 17])
def test_vocode_window_matches_jax(params, mods, tiny_config, start):
    """One window (4 frames, halo the receptive field) on the same padded
    latent: f32, atol 1e-5."""
    cfg = tiny_config
    halo = receptive_field_frames(cfg)
    assert halo == j_receptive_field(cfg)
    _xt, _m, xt_pad, mask_pad = _padded_latent(cfg, 21, halo, valid=19)
    want = np.asarray(JS.vocode_window(params, cfg, xt_pad, mask_pad, jnp.int32(start),
                                       4, halo, precision="f32", egress="f32"))
    got = synthesis.vocode_window(mods, cfg, torch.as_tensor(xt_pad),
                                  torch.as_tensor(mask_pad), start, 4, halo,
                                  precision="f32", egress="f32")
    assert got.shape == want.shape == (1, 4 * cfg.chunk_size)
    np.testing.assert_allclose(got.numpy(), want, rtol=0, atol=1e-5)


def test_vocode_window_rejects_a_window_past_the_latent(mods, tiny_config):
    cfg = tiny_config
    halo = receptive_field_frames(cfg)
    _xt, _m, xt_pad, mask_pad = _padded_latent(cfg, 21, halo)
    with pytest.raises(ValueError, match="outside"):
        synthesis.vocode_window(mods, cfg, torch.as_tensor(xt_pad),
                                torch.as_tensor(mask_pad), 18, 4, halo, precision="f32")


@pytest.mark.parametrize("t_len,w", [(21, 4), (40, 8)])
def test_window_interiors_equal_the_whole_sequence(mods, tiny_config, t_len, w):
    """The halo guarantee, as tests/test_stream.py holds it in JAX: windows
    emitted from k0 = 0, w, 2w, ... (the last one clamped into the latent)
    put together equal full-sequence vocoding of the same latent. On the CPU
    in f32 they agree bit for bit (each window's convs see the same values
    at every interior position)."""
    cfg = tiny_config
    halo = receptive_field_frames(cfg)
    xt, mask, xt_pad, mask_pad = _padded_latent(cfg, t_len, halo, valid=t_len - 3)
    full = vocoder.apply(mods["vocoder"], cfg, torch.as_tensor(xt),
                         frame_mask=torch.as_tensor(mask)).numpy()
    pieces = []
    for k0 in range(0, t_len, w):
        start = max(0, min(k0, t_len - w))
        wav = synthesis.vocode_window(mods, cfg, torch.as_tensor(xt_pad),
                                      torch.as_tensor(mask_pad), start, w, halo,
                                      precision="f32", egress="f32").numpy()
        off = (k0 - start) * cfg.chunk_size
        n = min(t_len - k0, w) * cfg.chunk_size
        pieces.append(wav[:, off: off + n])
    np.testing.assert_array_equal(np.concatenate(pieces, axis=1), full)


def test_stream_yields_all_chunks(engine, style):
    assert len(chunk_text(LONG, max_len=120)) >= 2
    got = list(engine.stream(LONG, "en", style, total_step=2, speed=FAST))
    assert len(got) == len(chunk_text(LONG, max_len=300))
    for wav, dur in got:
        assert dur > 0
        assert len(wav) == int(engine.cfg.sample_rate * dur)


def test_stream_first_chunk_before_rest(engine, style):
    gen = engine.stream(LONG, "en", style, total_step=2, speed=FAST, group_size=1)
    wav, dur = next(gen)  # first audio without draining the rest
    assert dur > 0 and np.isfinite(wav).all()
    assert len(list(gen)) >= 1


def test_stream_windows_pieces_and_flags(engine, style):
    """Continuation pieces, then exactly one chunk_end; the samples cover
    exactly the trimmed duration."""
    text = "One single chunk of text, streamed in vocoder windows."
    pieces = list(engine.stream_windows(text, "en", style, total_step=2,
                                        window_frames=4))
    assert len(pieces) > 1, "windowing must split the chunk"
    assert all(not end for *_x, end in pieces[:-1])
    assert pieces[-1][2] is True
    total = sum(len(p[0]) for p in pieces)
    dur = sum(p[1] for p in pieces)
    assert total == int(round(dur * engine.cfg.sample_rate))
    assert all(np.isfinite(p[0]).all() for p in pieces)


def test_stream_windows_multichunk_flags(engine, style):
    got = list(engine.stream_windows(LONG, "en", style, total_step=2, speed=FAST,
                                     window_frames=16))
    assert sum(1 for *_x, end in got if end) == len(chunk_text(LONG, max_len=300))
    assert sum(1 for *_x, end in got if not end) >= 1


def test_stream_windows_learns_the_rate(params, tiny_config, style, rate_dir):
    """A stream-only server learns the rate too: an overflow re-run, then the
    observation ratchets the prior."""
    eng = SynthesisEngine(params, tiny_config, UnicodeProcessor(build_default_indexer()),
                          precision="f32", device="cpu")
    eng._pin_rate(1e-4)  # far too fast: the first bucket overflows
    pieces = list(eng.stream_windows("A sentence streamed after a bad guess.", "en",
                                     style, total_step=2, window_frames=4))
    assert eng.stats["bucket_overflows"] == 1
    assert eng._spc_priors and max(eng._spc_priors.values()) > 1e-4
    total = sum(len(p[0]) for p in pieces)
    assert total == int(round(sum(p[1] for p in pieces) * tiny_config.sample_rate))


def _mulaw_grid() -> np.ndarray:
    """Every power-of-two magnitude (and its neighbours) in the int16 range,
    both signs, full scale and past it, zero, and a random sweep."""
    p2 = np.array([2.0 ** e for e in range(16)])
    mags = np.concatenate([p2 - 1, p2, p2 + 1, p2 - 132, p2 - 133,
                           [32635, 32636, 32767, 40000]]) / 32767.0
    rng = np.random.default_rng(0)
    x = np.concatenate([mags, -mags, [0.0, 1.0, -1.0, 1.5, -1.5],
                        rng.uniform(-1.1, 1.1, 4096)])
    return x.astype(np.float32)


def test_mulaw_encode_bit_equal_to_jax():
    x = _mulaw_grid()
    want = np.asarray(JS._mulaw_encode(jnp.asarray(x)))
    got = synthesis._mulaw_encode(torch.as_tensor(x)).numpy()
    assert got.dtype == want.dtype == np.uint8
    np.testing.assert_array_equal(got, want)
    np.testing.assert_array_equal(mulaw.encode(x), jmulaw.encode(x))


def test_mulaw_decode_equal_to_the_original():
    codes = np.arange(256, dtype=np.uint8)
    np.testing.assert_array_equal(mulaw.decode(codes), jmulaw.decode(codes))
    x = _mulaw_grid()
    round_trip = mulaw.decode(synthesis._mulaw_encode(torch.as_tensor(x)).numpy())
    pcm = np.clip(x, -1.0, 1.0) * 32767.0
    # within half a segment step (the step is 1/16 of the segment's floor)
    bound = (np.abs(pcm) + 132.0) / 32.0 + 2.0
    assert np.all(np.abs(round_trip * 32767.0 - np.clip(pcm, -32635, 32635)) <= bound)


def test_egress_forms_of_one_batch(params, tiny_config, style, rate_dir):
    """Engines with the same seed draw the same noise: the mu-law and f32
    egress of a batch stay within the G.711 step and the int16 step of the
    int16 egress."""
    out = {}
    for fmt in ("int16", "mulaw", "f32"):
        eng = SynthesisEngine(params, tiny_config, UnicodeProcessor(build_default_indexer()),
                              precision="f32", device="cpu", egress_format=fmt)
        eng._pin_rate()
        out[fmt] = eng.infer_batch(["Egress check sentence."], ["en"], style,
                                   total_step=2)
    (w16, d16), (wmu, dmu), (w32, d32) = out["int16"], out["mulaw"], out["f32"]
    np.testing.assert_array_equal(d16, dmu)
    assert w16.shape == wmu.shape == w32.shape
    assert np.abs(w32 - w16).max() <= 1.0 / 32767.0
    bound = (np.abs(w16) * 32767.0 + 132.0) / 32.0 + 2.0
    assert np.all(np.abs(wmu - w16) * 32767.0 <= bound)
    with pytest.raises(ValueError, match="egress_format"):
        SynthesisEngine(params, tiny_config, UnicodeProcessor(build_default_indexer()),
                        device="cpu", egress_format="mp3")


def test_infer_with_progress_matches_jax(params, tiny_config, engine, style_arrays):
    """The callback fires once per step, in order, after the step; the
    duration equals the JAX engine's (rtol 1e-6); the audio covers it."""
    text = "Progress reported at every denoising step."
    calls = []
    wav, dur = engine.infer_with_progress(text, "en", VoiceStyle(*style_arrays),
                                          total_step=3,
                                          progress_callback=lambda s, n: calls.append((s, n)))
    assert calls == [(1, 3), (2, 3), (3, 3)]
    jeng = JEngine(params, tiny_config, JProcessor(j_indexer()), precision="f32")
    jwav, jdur = jeng.infer_with_progress(text, "en", JVoiceStyle(*style_arrays),
                                          total_step=3)
    np.testing.assert_allclose(dur, jdur, rtol=1e-6)
    assert wav.shape == jwav.shape
    assert np.isfinite(wav).all()
    assert wav.shape[1] >= int(tiny_config.sample_rate * float(dur[0]))
    with pytest.raises(ValueError, match="single style"):
        engine.infer_with_progress(text, "en", VoiceStyle(*style_arrays).tile(2))
