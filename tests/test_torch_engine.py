"""The port's synthesis slice end to end on the CPU: the engine against the
JAX engine on injected noise, the fused call against the padded call, the
TTS API, and the device rule of the entry points."""

import numpy as np
import pytest
import torch

from supertonic_tpu.engine import SynthesisEngine as JEngine
from supertonic_tpu.engine import VoiceStyle as JVoiceStyle
from supertonic_tpu.frontend import UnicodeProcessor as JProcessor
from supertonic_tpu.frontend import build_default_indexer as j_indexer
from supertonic_tpu_torch import TTS
from supertonic_tpu_torch.engine import SynthesisEngine, VoiceStyle, synthesis
from supertonic_tpu_torch.frontend import UnicodeProcessor, build_default_indexer
from supertonic_tpu_torch.models import init_all, load_params

TEXTS = ["Hello there.", "A rather longer sentence, for a second row."]


@pytest.fixture(scope="module", autouse=True)
def rate_dir(tmp_path_factory):
    """The engines' learned-rate cache in a fresh folder, never the user's."""
    with pytest.MonkeyPatch.context() as mp:
        d = tmp_path_factory.mktemp("rates")
        mp.setenv("TTS_RATE_CACHE_DIR", str(d))
        yield d


@pytest.fixture(scope="module")
def params(tiny_config):
    p = init_all(0, tiny_config)
    rng = np.random.default_rng(42)
    ve = p["vector_estimator"]
    for key in ("out_proj", "adaln_out"):
        ve[key]["w"] = (rng.standard_normal(ve[key]["w"].shape) * 0.05).astype(np.float32)
    for bp in ve["blocks"]:
        bp["adaln"]["w"] = (rng.standard_normal(bp["adaln"]["w"].shape) * 0.05).astype(np.float32)
    return p


@pytest.fixture(scope="module")
def style_arrays(tiny_config):
    rng = np.random.default_rng(7)
    cfg = tiny_config
    return (rng.standard_normal((1, cfg.ttl.style.n_style,
                                 cfg.ttl.style.style_value_dim)).astype(np.float32),
            rng.standard_normal((1, cfg.dp.style.n_style,
                                 cfg.dp.style.style_value_dim)).astype(np.float32))


@pytest.fixture(scope="module")
def engine(params, tiny_config):
    return SynthesisEngine(params, tiny_config, UnicodeProcessor(build_default_indexer()),
                           precision="f32", device="cpu")


def test_infer_batch_matches_jax_engine(params, tiny_config, style_arrays, engine):
    """Duration rtol 1e-6 and the same latent grid; wav atol 1e-4 (f32,
    two Euler steps and the vocoder, sum order only)."""
    ttl, dp = style_arrays
    noise = np.random.default_rng(3).standard_normal(
        (2, 256, tiny_config.latent_channels)).astype(np.float32)
    jeng = JEngine(params, tiny_config, JProcessor(j_indexer()), precision="f32")
    jw, jd = jeng.infer_batch(TEXTS, ["en", "en"], JVoiceStyle(ttl, dp).tile(2),
                              total_step=2, noise=noise)
    w, d = engine.infer_batch(TEXTS, ["en", "en"], VoiceStyle(ttl, dp).tile(2),
                              total_step=2, noise=noise)
    np.testing.assert_allclose(d, jd, rtol=1e-6)
    cfg = tiny_config
    lat = np.ceil(d * cfg.sample_rate / cfg.chunk_size)
    jlat = np.ceil(jd * cfg.sample_rate / cfg.chunk_size)
    np.testing.assert_array_equal(lat, jlat)
    assert lat[0] != lat[1]
    assert w.shape == jw.shape
    np.testing.assert_allclose(w, jw, rtol=0, atol=1e-4)


def test_fused_equals_padded_with_same_noise(params, tiny_config, style_arrays):
    cfg = tiny_config
    mods = load_params(params, device="cpu")
    eng = SynthesisEngine(mods, cfg, UnicodeProcessor(build_default_indexer()),
                          precision="f32", device="cpu")
    ttl, dp = style_arrays
    dev_args, *_ = eng._prepare_inputs(TEXTS, ["en", "en"], VoiceStyle(ttl, dp).tile(2))
    b, t_pad = dev_args[0].shape[0], 64
    gen = torch.Generator().manual_seed(11)
    wav_f, dur_f = synthesis.synthesize_fused(mods, cfg, *dev_args, gen, 1.05, 2, t_pad,
                                              precision="f32", egress="f32")
    noise = torch.randn((b, t_pad, cfg.latent_channels),
                        generator=torch.Generator().manual_seed(11))
    wav_p, dur_p = synthesis.synthesize_padded(mods, cfg, *dev_args, noise, 1.05, 2,
                                               precision="f32")
    torch.testing.assert_close(wav_f, wav_p, rtol=0, atol=0)
    torch.testing.assert_close(dur_f, dur_p, rtol=0, atol=0)
    wav_i, _ = synthesis.synthesize_fused(mods, cfg, *dev_args,
                                          torch.Generator().manual_seed(11), 1.05, 2,
                                          t_pad, precision="f32")
    assert wav_i.dtype == torch.int16
    want = torch.clamp(wav_p * 32767.0, -32768.0, 32767.0).to(torch.int16)
    torch.testing.assert_close(wav_i, want, rtol=0, atol=0)


def test_overflow_rerun_fits_the_duration(engine, tiny_config, style_arrays):
    ttl, dp = style_arrays
    engine._pin_rate(1e-4)  # far too fast: the first bucket overflows
    n0 = engine.stats["bucket_overflows"]
    w, d = engine.infer_batch(TEXTS, ["en", "en"], VoiceStyle(ttl, dp).tile(2),
                              total_step=2)
    assert engine.stats["bucket_overflows"] > n0
    assert w.shape[1] >= int(np.max(d) * tiny_config.sample_rate)
    assert np.isfinite(w).all()
    engine._pin_rate()


def test_engine_rejects_bad_requests(engine, style_arrays):
    style = VoiceStyle(*style_arrays)
    with pytest.raises(ValueError, match="must match"):
        engine.infer_batch(TEXTS, ["en", "en"], style)
    with pytest.raises(ValueError, match="speed"):
        engine.infer_batch(TEXTS[:1], ["en"], style, speed=0.0)
    with pytest.raises(ValueError, match="single style"):
        engine(TEXTS[0], "en", style.tile(2))


def test_tts_api_on_cpu(tiny_config, tmp_path):
    tts = TTS(device="cpu", cfg=tiny_config)
    assert tts.engine.precision == "bf16"
    style = tts.get_voice_style("M1")
    wav, dur = tts.synthesize("Hello world, this is the port.", style, total_step=2)
    assert wav.shape[0] == 1 and np.isfinite(wav).all()
    assert tts.sample_rate == 16000
    assert abs(wav.shape[1] - int(16000 * float(dur[0]))) <= 1
    wavs, durs = tts.synthesize_batch(TEXTS, ["en", "en"], style.tile(2), total_step=2)
    assert wavs.shape[0] == 2 and durs.shape == (2,) and np.isfinite(wavs).all()
    for row, d in zip(tts.engine.trim(wavs, durs), durs):
        assert len(row) == int(16000 * float(d))
    path = tmp_path / "out.wav"
    tts.save_audio(wav, str(path))
    assert path.stat().st_size == 44 + 2 * wav.shape[1]


def test_entry_points_default_to_cuda(tiny_config, params):
    if torch.cuda.is_available():
        pytest.skip("a CUDA card is present: the default device is usable")
    with pytest.raises(RuntimeError, match="no CUDA device"):
        TTS(cfg=tiny_config)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        SynthesisEngine(params, tiny_config, UnicodeProcessor(build_default_indexer()))
