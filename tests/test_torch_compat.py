"""The port's reference-compatible API (``supertonic_tpu_torch.compat``)
against the JAX package's, case by case as tests/test_compat.py holds the
JAX one: the loader on one asset bundle for both packages (a tiny config
whose runtime precision is f32), ``__call__`` and ``batch`` (durations
identical to JAX's, audio finite and of the duration's length;
the noise differs: a torch generator against a JAX key), each ``run_*``
against JAX's on the same params and inputs in the reference layouts
(rtol/atol 1e-5), the re-exports, the ONNX-subdirectory probe, an empty
directory, and ``python -m supertonic_tpu_torch --help``."""

import dataclasses
import json
import os
import shutil
import subprocess
import sys

import numpy as np
import pytest

from supertonic_tpu import compat as jcompat
from supertonic_tpu.assets import save_assets, save_voice_style, synthesize_default_styles
from supertonic_tpu_torch import compat
from supertonic_tpu_torch.assets.onnx_pipeline import OnnxPipeline
from supertonic_tpu_torch.frontend import build_default_indexer
from supertonic_tpu_torch.models import init_all

from test_onnx_pipeline import onnx_dir  # noqa: F401  (module fixture)

ROOT = os.path.join(os.path.dirname(__file__), "..")


@pytest.fixture(scope="module", autouse=True)
def rate_dir(tmp_path_factory):
    with pytest.MonkeyPatch.context() as mp:
        mp.setenv("TTS_RATE_CACHE_DIR", str(tmp_path_factory.mktemp("rates")))
        yield


def _params(cfg):
    """init_all with the estimator's zero-init heads perturbed (else the
    estimator's output is zero and run_vector_estimator shows nothing)."""
    p = init_all(0, cfg)
    rng = np.random.default_rng(42)
    ve = p["vector_estimator"]
    for key in ("out_proj", "adaln_out"):
        ve[key]["w"] = (rng.standard_normal(ve[key]["w"].shape) * 0.05).astype(np.float32)
    for bp in ve["blocks"]:
        bp["adaln"]["w"] = (rng.standard_normal(bp["adaln"]["w"].shape) * 0.05).astype(np.float32)
    return p


@pytest.fixture(scope="module")
def bundle(tiny_config, tmp_path_factory):
    """One asset bundle, written by the JAX package, in f32."""
    cfg = dataclasses.replace(
        tiny_config, runtime=dataclasses.replace(tiny_config.runtime, precision="f32"))
    d = tmp_path_factory.mktemp("assets")
    save_assets(str(d), cfg, _params(cfg))
    return str(d)


@pytest.fixture(scope="module")
def pair(bundle):
    t = compat.load_text_to_speech(bundle, device="cpu")
    assert t.engine.precision == "f32"
    return t, jcompat.load_text_to_speech(bundle)


@pytest.fixture(scope="module")
def style(tiny_config, tmp_path_factory):
    d = tmp_path_factory.mktemp("styles")
    styles = synthesize_default_styles(tiny_config)
    p1, p2 = str(d / "M1.json"), str(d / "F1.json")
    save_voice_style(p1, styles["M1"])
    save_voice_style(p2, styles["F1"])
    return compat.load_voice_style([p1]), compat.load_voice_style([p1, p2])


def _dur_len_ok(tts, wav, dur):
    assert np.isfinite(wav).all()
    for row, d in zip(wav, dur):
        assert row.shape[0] >= int(tts.sample_rate * d)


def test_call_signature_matches_reference(pair, style):
    tts, jtts = pair
    single, _ = style
    wav, dur = tts("Compatibility check.", "en", single, 2, 1.05, 0.3)
    jwav, jdur = jtts("Compatibility check.", "en", single, 2, 1.05, 0.3)
    assert wav.shape[0] == 1 and dur.shape == (1,)
    np.testing.assert_array_equal(dur, jdur)
    _dur_len_ok(tts, wav, dur)


def test_batch_signature(pair, style):
    tts, jtts = pair
    _, two = style
    texts = ["One here.", "Two there, a longer one."]
    wav, dur = tts.batch(texts, ["en", "en"], two, 2)
    jwav, jdur = jtts.batch(texts, ["en", "en"], two, 2)
    assert wav.shape[0] == 2 and dur.shape == (2,)
    np.testing.assert_array_equal(dur, jdur)
    _dur_len_ok(tts, wav, dur)


def test_single_style_assertion(pair, style):
    _, two = style
    with pytest.raises(AssertionError):
        pair[0]("text", "en", two, 2)


def test_cfg_attributes(pair, tiny_config):
    tts, jtts = pair
    assert tts.sample_rate == tiny_config.sample_rate
    assert tts.base_chunk_size == tiny_config.ae.base_chunk_size
    assert tts.chunk_compress_factor == tiny_config.ttl.chunk_compress_factor
    assert tts.ldim == tiny_config.ttl.latent_dim
    assert tts.cfgs == jtts.cfgs
    assert tts.cfgs["ae"]["sample_rate"] == tiny_config.sample_rate


def _run_all(tts, ids, mask, single, cfg):
    rng = np.random.default_rng(0)
    t_lat = 8
    noisy = rng.standard_normal((1, cfg.latent_channels, t_lat)).astype(np.float32)
    lat_mask = np.ones((1, 1, t_lat), np.float32)
    dur = tts.run_duration_predictor(ids, single.dp, mask)
    emb = tts.run_text_encoder(ids, single.ttl, mask)
    out = tts.run_vector_estimator(noisy, emb, single.ttl, mask, lat_mask,
                                   np.zeros(1, np.float32), np.full(1, 4.0, np.float32))
    return dur, emb, out, tts.run_vocoder(out)


def test_per_network_onnx_layouts_match_jax(pair, style, tiny_config):
    """Each run_* in the ONNX session layouts ([B,1,L] masks, [B,C,T]
    latents) against the JAX one, rtol/atol 1e-5."""
    tts, jtts = pair
    single, _ = style
    ids, mask = compat.UnicodeProcessor(build_default_indexer())(["Layout check."], ["en"])
    assert mask.ndim == 3 and mask.shape[1] == 1
    got = _run_all(tts, ids, mask, single, tiny_config)
    want = _run_all(jtts, ids, mask, single, tiny_config)
    dur, emb, out, wav = got
    assert dur.shape == (1,) and dur[0] > 0
    assert emb.shape[:2] == (1, ids.shape[1])
    assert out.shape == (1, tiny_config.latent_channels, 8)
    assert wav.shape == (1, 8 * tiny_config.chunk_size)
    for g, w in zip(got, want):
        np.testing.assert_allclose(g, np.asarray(w), rtol=1e-5, atol=1e-5)


def test_run_entry_points_compute_in_f32_on_a_bf16_engine(bundle, pair, style, tmp_path):
    """The loader keeps the f32 tree: a bf16 engine's run_* equal the f32
    engine's, not its rounded weights'."""
    d = tmp_path / "bf16"
    shutil.copytree(bundle, d)
    with open(d / "model_config.json") as f:
        mc = json.load(f)
    mc["runtime"]["precision"] = "bf16"
    with open(d / "model_config.json", "w") as f:
        json.dump(mc, f)
    t16 = compat.load_text_to_speech(str(d), use_gpu=True, device="cpu")  # use_gpu ignored
    assert t16.engine.precision == "bf16"
    single, _ = style
    ids, mask = compat.UnicodeProcessor(build_default_indexer())(["Layout check."], ["en"])
    for g, w in zip(_run_all(t16, ids, mask, single, t16.engine.cfg),
                    _run_all(pair[0], ids, mask, single, t16.engine.cfg)):
        np.testing.assert_array_equal(g, w)


def test_reexports():
    from supertonic_tpu_torch.compat import (  # noqa: F401
        AVAILABLE_LANGS, Style, TextToSpeech, chunk_text, get_latent_mask, length_to_mask,
        load_text_to_speech, load_voice_style, sanitize_filename, timer)

    assert "en" in AVAILABLE_LANGS
    assert chunk_text("A. B.", max_len=4) == ["A.", "B."]
    for name in ("AVAILABLE_LANGS", "chunk_text", "get_latent_mask", "length_to_mask",
                 "sanitize_filename", "timer", "Style", "TextToSpeech", "UnicodeProcessor",
                 "load_text_to_speech", "load_voice_style"):
        assert hasattr(jcompat, name) and hasattr(compat, name), name


def test_compat_auto_backend_probes_onnx_subdir(onnx_dir, tmp_path):  # noqa: F811
    """A fetched-but-unflattened bundle (assets/onnx/*.onnx) selects the
    graph backend, never random-init native weights."""
    root = tmp_path / "assets"
    (root / "onnx").mkdir(parents=True)
    for f in os.listdir(onnx_dir):
        shutil.copy(os.path.join(onnx_dir, f), root / "onnx" / f)
    tts = compat.load_text_to_speech(str(root), device="cpu")
    assert isinstance(tts, OnnxPipeline)
    assert isinstance(compat.load_text_to_speech(str(root), backend="onnx", device="cpu"),
                      OnnxPipeline)
    with pytest.raises(FileNotFoundError):
        compat.load_text_to_speech(str(root), backend="native", device="cpu")


def test_empty_directory_raises(tmp_path):
    with pytest.raises(FileNotFoundError):
        compat.load_text_to_speech(str(tmp_path), device="cpu")


def test_device_defaults_to_the_card(bundle, monkeypatch):
    import torch

    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        compat.load_text_to_speech(bundle)


def test_python_dash_m_runs_the_cli():
    proc = subprocess.run([sys.executable, "-m", "supertonic_tpu_torch", "--help"],
                          capture_output=True, text=True, timeout=120, cwd=ROOT)
    assert proc.returncode == 0, proc.stderr
    assert "--total-step" in proc.stdout and "--platform" in proc.stdout
