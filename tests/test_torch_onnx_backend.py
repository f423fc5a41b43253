"""The port's graph-bundle backend against the JAX one on the CPU: the
per-call pipeline, ``SynthesisEngine(backend=...)``, the adapter, progress
callbacks, ``TTS``'s choice of backend, and the bf16-storage parity floor.

The bundle is the JAX tests' hand-written four-graph contract bundle
(``tests/test_onnx_pipeline.py``). Tolerances: noise bit-equal, durations
rtol=1e-6, wav atol=1e-4 (as ``tests/test_torch_engine.py``)."""

import json
import os
import shutil
import sys

import numpy as np
import pytest
import torch

from supertonic_tpu import TTS as JTTS
from supertonic_tpu import SynthesisEngine as JEngine
from supertonic_tpu.assets.onnx_backend import load_onnx_backend as j_load_backend
from supertonic_tpu.assets.onnx_pipeline import load_onnx_pipeline as j_load_pipeline
from supertonic_tpu.config import load_tts_json as j_load_tts_json
from supertonic_tpu.engine import VoiceStyle as JVoiceStyle
from supertonic_tpu.frontend import UnicodeProcessor as JProcessor
from supertonic_tpu_torch import TTS, SynthesisEngine
from supertonic_tpu_torch.assets import onnx_reader as R
from supertonic_tpu_torch.assets.onnx_backend import (ContractMismatch,
                                                      load_onnx_backend)
from supertonic_tpu_torch.assets.onnx_pipeline import load_onnx_pipeline
from supertonic_tpu_torch.config import load_tts_json
from supertonic_tpu_torch.engine import VoiceStyle
from supertonic_tpu_torch.engine.onnx_adapter import OnnxEngineAdapter
from supertonic_tpu_torch.frontend import UnicodeProcessor

from test_onnx_pipeline import CCF, onnx_dir  # noqa: F401  (module fixture)

F32 = np.float32
TEXTS = ["Hello there, world.", "A second, different sentence!"]


@pytest.fixture(scope="module", autouse=True)
def rate_dir(tmp_path_factory):
    with pytest.MonkeyPatch.context() as mp:
        mp.setenv("TTS_RATE_CACHE_DIR", str(tmp_path_factory.mktemp("rates")))
        mp.delenv("TTS_ONNX_FUSED", raising=False)
        # tests/test_reference_differential.py leaves a module stub for
        # onnxruntime in sys.modules, with no __spec__. The first meta-tensor
        # op of the fused backend's validate() imports torch._dynamo, whose
        # import runs find_spec("onnxruntime"), which raises on such a stub:
        # validate() then fails and TTS picks the per-call adapter.
        if getattr(sys.modules.get("onnxruntime"), "__spec__", True) is None:
            mp.delitem(sys.modules, "onnxruntime")
        mp.delenv("TTS_ONNX_BF16", raising=False)
        yield


def _styles(seed, b=1):
    rng = np.random.default_rng(seed)
    ttl = rng.standard_normal((b, 2, 4)).astype(F32)
    dp = rng.standard_normal((b, 2, 4)).astype(F32)
    return JVoiceStyle(ttl, dp), VoiceStyle(ttl, dp)


def _processors(d):
    with open(os.path.join(d, "unicode_indexer.json")) as f:
        idx = np.asarray(json.load(f), np.int64)
    return JProcessor(idx), UnicodeProcessor(idx)


def _engines(d, *, mp="float32", seed=0):
    jproc, tproc = _processors(d)
    jcfg, tcfg = j_load_tts_json(os.path.join(d, "tts.json")), load_tts_json(
        os.path.join(d, "tts.json"))
    jb = j_load_backend(d, jcfg, matmul_precision=mp)
    tb = load_onnx_backend(d, tcfg, matmul_precision=mp, device="cpu")
    je = JEngine(jb.params, jcfg, jproc, precision="f32", seed=seed, backend=jb)
    te = SynthesisEngine(None, tcfg, tproc, precision="f32", seed=seed, backend=tb)
    for e in (je, te):
        e._pin_rate(1.0 / 11.0)
    return je, te


def test_pipeline_matches_the_jax_pipeline(onnx_dir):  # noqa: F811
    """Same seed: the host noise is bit-equal, so the audio agrees."""
    jp = j_load_pipeline(onnx_dir, seed=5)
    tp = load_onnx_pipeline(onnx_dir, seed=5, device="cpu")
    js, ts = _styles(3, b=2)
    for bucketed in (False, True):
        if bucketed:
            jp = j_load_pipeline(onnx_dir, seed=5, bucketed=True)
            tp = load_onnx_pipeline(onnx_dir, seed=5, bucketed=True, device="cpu")
        dur = np.array([0.9, 1.3], F32)
        n_j, m_j = jp.sample_noisy_latent(dur)
        n_t, m_t = tp.sample_noisy_latent(dur)
        np.testing.assert_array_equal(n_t, n_j)
        np.testing.assert_array_equal(m_t, m_j)
        jw, jd = jp.batch(TEXTS, ["en", "en"], js, total_step=3)
        tw, td = tp.batch(TEXTS, ["en", "en"], ts, total_step=3)
        np.testing.assert_allclose(td, jd, rtol=1e-6)
        assert tw.shape == jw.shape
        np.testing.assert_allclose(tw, jw, atol=1e-4)
    jw, jd = jp("One. Two sentences here, both short.", "en", _styles(4)[0])
    tw, td = tp("One. Two sentences here, both short.", "en", _styles(4)[1])
    np.testing.assert_allclose(td, jd, rtol=1e-6)
    np.testing.assert_allclose(tw, jw, atol=1e-4)


def test_backend_engine_matches_the_jax_engine_on_injected_noise(onnx_dir):  # noqa: F811
    je, te = _engines(onnx_dir)
    js, ts = _styles(3, b=2)
    noise = np.random.default_rng(1).standard_normal((2, 64, CCF * 3)).astype(F32)
    jw, jd = je.infer_batch(TEXTS, ["en", "en"], js, 3, 1.05, noise=noise)
    tw, td = te.infer_batch(TEXTS, ["en", "en"], ts, 3, 1.05, noise=noise)
    np.testing.assert_allclose(td, jd, rtol=1e-6)
    assert tw.shape == jw.shape
    np.testing.assert_allclose(tw, jw, atol=1e-4)


def test_backend_fused_path(onnx_dir):  # noqa: F811
    """The fused call: the same durations and audio shape (the latent
    bucket) as the JAX engine, whose noise comes from another generator,
    and the same audio for the same seed."""
    je, te = _engines(onnx_dir, seed=11)
    _, te2 = _engines(onnx_dir, seed=11)
    js, ts = _styles(5, b=2)
    jw, jd = je.infer_batch(TEXTS, ["en", "en"], js, total_step=2)
    tw, td = te.infer_batch(TEXTS, ["en", "en"], ts, total_step=2)
    np.testing.assert_allclose(td, jd, rtol=1e-6)
    assert tw.shape == jw.shape and np.isfinite(tw).all()
    tw2, td2 = te2.infer_batch(TEXTS, ["en", "en"], ts, total_step=2)
    np.testing.assert_array_equal(tw, tw2)
    np.testing.assert_array_equal(td, td2)


def test_fused_body_equals_the_stages(onnx_dir):  # noqa: F811
    """padded_fn (what the card captures) equals text_fn + acoustic_fn on
    the same noise, and fused_fn draws its noise with the native op."""
    from supertonic_tpu_torch.engine import synthesis as S

    _, te = _engines(onnx_dir)
    b = te.backend
    dev_args, *_ = te._prepare_inputs(TEXTS, ["en", "en"], _styles(6, b=2)[1])
    speed = te._speed(1.05)
    gen = torch.Generator().manual_seed(3)
    noise = S._noise(te.cfg, dev_args[0].shape[0], 32,
                     torch.Generator().manual_seed(3), "cpu")
    wav_f, dur_f = b.fused_fn(te.params, *dev_args, gen, speed, 2, 32, "f32")
    wav_p, dur_p = b.padded_fn(te.params, *dev_args, noise, speed, 2, "f32")
    dur, emb = b.text_fn(te.params, *dev_args, speed)
    lmask = S._latent_mask(te.cfg, dur, 32)
    wav = b.acoustic_fn(te.params, emb, dev_args[3], dev_args[1], lmask, noise, 2)
    for w in (wav_f, wav_p):
        np.testing.assert_array_equal(w.numpy(), wav.numpy())
    np.testing.assert_array_equal(dur_f.numpy(), dur.numpy())
    b.validate()  # meta tensors: shapes only


def test_backend_progress_callbacks(onnx_dir):  # noqa: F811
    je, te = _engines(onnx_dir)
    js, ts = _styles(7)
    for eng, st in ((je, js), (te, ts)):
        seen = []
        wav, dur = eng.infer_with_progress(
            "Progress check.", "en", st, total_step=3,
            progress_callback=lambda s, t: seen.append((s, t)))
        assert seen == [(1, 3), (2, 3), (3, 3)]
        assert wav.shape[0] == 1 and np.isfinite(wav).all()
        if eng is je:
            jdur = dur
    np.testing.assert_allclose(dur, jdur, rtol=1e-6)


def test_adapter_matches_the_jax_adapter(onnx_dir, monkeypatch):  # noqa: F811
    monkeypatch.setenv("TTS_ONNX_FUSED", "0")
    jt, tt = JTTS(onnx_dir), TTS(onnx_dir, device="cpu")
    assert isinstance(tt.engine, OnnxEngineAdapter)
    js, ts = _styles(8)
    noise = np.random.default_rng(2).standard_normal((1, CCF * 3, 64)).astype(F32)
    jw, jd = jt.engine.infer_batch(["Adapter check."], ["en"], js, 2, noise=noise)
    tw, td = tt.engine.infer_batch(["Adapter check."], ["en"], ts, 2, noise=noise)
    np.testing.assert_allclose(td, jd, rtol=1e-6)
    np.testing.assert_allclose(tw, jw, atol=1e-4)
    # seeded host noise: the whole call agrees too, and so do batch/stream
    jw, jd = jt.synthesize("A seeded adapter sentence.", js)
    tw, td = tt.synthesize("A seeded adapter sentence.", ts)
    np.testing.assert_allclose(td, jd, rtol=1e-6)
    np.testing.assert_allclose(tw, jw, atol=1e-4)
    pieces = list(tt.engine.stream_windows("One. Two.", "en", ts, total_step=2))
    assert pieces and all(p[2] for p in pieces)
    seen = []
    tt.engine.infer_with_progress("Steps.", "en", ts, total_step=2,
                                  progress_callback=lambda s, t: seen.append(s))
    assert seen == [1, 2]
    assert tt.engine.warmup(total_steps=(2,)) == 1


def test_tts_picks_its_backend(onnx_dir, tmp_path, monkeypatch):  # noqa: F811
    """Fused by default (also from <dir>/onnx), the adapter with
    TTS_ONNX_FUSED=0 or when validate() fails, ContractMismatch raises, and
    a directory with neither graphs nor params.npz raises."""
    tts = TTS(onnx_dir, device="cpu")
    assert isinstance(tts.engine, SynthesisEngine) and tts.engine.backend is not None
    assert tts.cfg.sample_rate == 80
    wav, dur = tts.synthesize("A fused backend sentence.", _styles(9)[1])
    assert wav.shape[0] == 1 and float(dur[0]) > 0 and np.isfinite(wav).all()
    nested = tmp_path / "nested"
    shutil.copytree(onnx_dir, nested / "onnx")
    assert TTS(str(nested), device="cpu").engine.backend is not None

    monkeypatch.setenv("TTS_ONNX_FUSED", "0")
    assert isinstance(TTS(onnx_dir, device="cpu").engine, OnnxEngineAdapter)
    monkeypatch.delenv("TTS_ONNX_FUSED")

    # an estimator whose output grows T by one cannot run the step loop:
    # validate() catches it and the adapter serves
    d = tmp_path / "loopbreaker"
    shutil.copytree(onnx_dir, d)
    w = np.load(os.path.join(onnx_dir, "weights.npy"), allow_pickle=True).item()
    c = CCF * 3
    vis_in = [R.encode_value_info(n, F32, s) for n, s in (
        ("noisy_latent", ("B", c, "T")), ("text_emb", ("B", 5, "L")),
        ("style_ttl", ("B", 2, 4)), ("text_mask", ("B", 1, "L")),
        ("latent_mask", ("B", 1, "T")), ("current_step", ("B",)),
        ("total_step", ("B",)))]
    (d / "vector_estimator.onnx").write_bytes(R.encode_model(
        "g", [R.encode_node("Conv", ["noisy_latent", "w_conv"], ["cv"], name="n0",
                            attrs={"pads": [1, 1], "kernel_shape": [3]}),
              R.encode_node("Pad", ["cv", "pads"], ["denoised_latent"], name="n1")],
        [R.encode_tensor("w_conv", w["w_conv"]),
         R.encode_tensor("pads", np.asarray([0, 0, 0, 0, 0, 1], np.int64))],
        vis_in, [R.encode_value_info("denoised_latent", F32, ("B", c, "T1"))]))
    from supertonic_tpu.engine.onnx_adapter import OnnxEngineAdapter as JAdapter

    assert isinstance(JTTS(str(d)).engine, JAdapter)
    assert isinstance(TTS(str(d), device="cpu").engine, OnnxEngineAdapter)

    bad = tmp_path / "bad"
    shutil.copytree(onnx_dir, bad)
    (bad / "duration_predictor.onnx").write_bytes(R.encode_model(
        "g", [R.encode_node("Identity", ["x"], ["duration"], name="n0")], [],
        [R.encode_value_info("x", F32, ("B",))],
        [R.encode_value_info("duration", F32, ("B",))]))
    with pytest.raises(ContractMismatch, match="contract"):
        TTS(str(bad), device="cpu")
    empty = tmp_path / "empty"
    empty.mkdir()
    (empty / "tts.json").write_text("{}")
    with pytest.raises(FileNotFoundError, match="neither params.npz nor"):
        TTS(str(empty), device="cpu")


def test_bf16_storage_parity_floor(onnx_dir):  # noqa: F811
    """The bf16-storage default of "default" precision keeps the wav within
    1% RMS of the strict-f32 executor's on the same seed."""
    cfg = load_tts_json(os.path.join(onnx_dir, "tts.json"))
    _, proc = _processors(onnx_dir)
    b_f32 = load_onnx_backend(onnx_dir, cfg, matmul_precision="float32", device="cpu")
    b_fast = load_onnx_backend(onnx_dir, cfg, matmul_precision="default", device="cpu")
    assert not b_f32.execs["vector_estimator"]._bf16_storage
    assert b_fast.execs["vector_estimator"]._bf16_storage
    ts = _styles(7)[1]
    text = ["Parity floor sentence for the bf16 gate."]
    outs = []
    for b in (b_f32, b_fast):
        e = SynthesisEngine(None, cfg, proc, precision="f32", seed=3, backend=b)
        e._pin_rate(1.0 / 11.0)
        outs.append(e.infer_batch(text, ["en"], ts, total_step=2))
    (w32, d32), (w16, d16) = outs
    np.testing.assert_allclose(d32, d16, rtol=1e-2)
    sig = float(np.sqrt(np.mean(w32 ** 2)))
    diff = float(np.sqrt(np.mean((w32 - w16) ** 2)))
    assert sig > 0 and diff <= 0.01 * sig, diff / sig
