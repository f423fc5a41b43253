"""The port's graph-bundle surface end to end on the CPU: foreign graph bytes
from ``torch.onnx.export`` through the port's executor against torch eager,
an exported ``init_all`` bundle served by ``TTS`` against the native engine
on the same params, and the HTTP server over a bundle."""

import dataclasses
import io
import os
import sys
import threading

import httpx
import numpy as np
import pytest
import torch

from supertonic_tpu_torch import TTS
from supertonic_tpu_torch.assets.onnx_exec import OnnxSession
from supertonic_tpu_torch.assets.onnx_export import export_bundle
from supertonic_tpu_torch.assets.onnx_pipeline import load_onnx_pipeline
from supertonic_tpu_torch.config import TTSConfig, _dataclass_from_dict
from supertonic_tpu_torch.engine import SynthesisEngine, VoiceStyle
from supertonic_tpu_torch.frontend import UnicodeProcessor, build_default_indexer
from supertonic_tpu_torch.models import init_all
from supertonic_tpu_torch.utils import read_wav

sys.path.insert(0, os.path.join(os.path.dirname(__file__), "..", "tools"))
import torch_export_bundle as TB  # noqa: E402

from test_onnx_pipeline import onnx_dir  # noqa: E402,F401  (module fixture)
from test_onnx_torch_export import _torch_chain  # noqa: E402

F32 = np.float32


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
        yield


@pytest.fixture(scope="module")
def torch_bundle(tmp_path_factory):
    d = tmp_path_factory.mktemp("torch_bundle")
    TB.export_bundle(str(d), seed=0)
    return str(d)


def test_torch_exported_layers_match_torch_eager(tmp_path):
    """Conv/deconv, attention-shaped and GRU graphs exported by torch."""
    torch.manual_seed(0)
    cases = [
        (torch.nn.Sequential(torch.nn.Conv1d(4, 8, 3, padding=1), torch.nn.SiLU(),
                             torch.nn.ConvTranspose1d(8, 4, 4, stride=2, padding=1)),
         (torch.randn(2, 4, 11),)),
        (torch.nn.MultiheadAttention(16, 2, batch_first=True),
         (torch.randn(2, 5, 16),) * 3),
        (torch.nn.GRU(6, 8, batch_first=True), (torch.randn(2, 7, 6),)),
    ]
    for i, (model, args) in enumerate(cases):
        model.eval()
        p = str(tmp_path / f"m{i}.onnx")
        names = [f"in{j}" for j in range(len(args))]
        TB.export_onnx(model, args, p, input_names=names, output_names=["out"],
                       dynamic_axes={})
        got = OnnxSession(p, device="cpu").run(None, {n: a.numpy() for n, a in zip(names, args)})
        with torch.no_grad():
            want = model(*args)
        want = want[0] if isinstance(want, tuple) else want
        np.testing.assert_allclose(got[0], want.numpy(), rtol=1e-4, atol=1e-5)


def test_torch_exported_bundle_matches_torch_eager(torch_bundle):
    """The four-graph bundle of torch-exporter bytes through the port's
    pipeline, against the traced modules' eager chain on the same noise."""
    pipe = load_onnx_pipeline(torch_bundle, device="cpu")
    rng = np.random.default_rng(3)
    style = VoiceStyle(rng.standard_normal((2, TB.N_STYLE, TB.STYLE_DIM)).astype(F32),
                       rng.standard_normal((2, TB.N_STYLE, TB.STYLE_DIM)).astype(F32))
    texts, langs = ["Hello there, world.", "A second, different sentence!"], ["en", "en"]
    ids, mask = pipe.processor(texts, langs)
    dp = torch.jit.load(os.path.join(torch_bundle, "duration_predictor.pt"))
    with torch.no_grad():
        dur = dp(torch.from_numpy(ids.astype(np.int64)), torch.from_numpy(style.dp),
                 torch.from_numpy(mask.astype(F32))).numpy() / 1.05
    t_lat = int((dur.max() * TB.SR + TB.CHUNK - 1) // TB.CHUNK)
    noise = rng.standard_normal((2, TB.C, t_lat)).astype(F32)
    wav, dur_got = pipe._infer(texts, langs, style, total_step=3, speed=1.05, noise=noise)
    np.testing.assert_allclose(dur_got, dur, rtol=1e-5, atol=1e-6)
    want = _torch_chain(torch_bundle, ids, mask, style, noise, 3, dur)
    assert wav.shape == want.shape
    np.testing.assert_allclose(wav, want, rtol=1e-4, atol=1e-4)
    # the fused backend serves the same foreign graphs
    tts = TTS(torch_bundle, device="cpu", precision="f32")
    assert tts.engine.backend is not None
    w, d = tts.synthesize("Foreign graph bytes.", style.take([0]), total_step=2)
    assert np.isfinite(w).all() and float(d[0]) > 0


def test_exported_bundle_serves_like_the_native_engine(tiny_config, tmp_path):
    """TTS(<exported bundle>) in f32 against the native f32 engine on the
    same params and the same injected noise: durations rtol=1e-6 with the
    same latent lengths, wav atol=1e-4."""
    cfg = _dataclass_from_dict(TTSConfig, dataclasses.asdict(tiny_config))
    params = init_all(42, cfg)
    d = str(tmp_path / "bundle")
    export_bundle(params, cfg, d, indexer=build_default_indexer())
    tts = TTS(d, device="cpu", precision="f32")
    assert tts.engine.backend is not None
    native = SynthesisEngine(params, cfg, UnicodeProcessor(build_default_indexer()),
                             precision="f32", device="cpu")
    rng = np.random.default_rng(5)
    style = VoiceStyle(
        rng.standard_normal((2, cfg.ttl.style.n_style, cfg.ttl.style.style_value_dim)).astype(F32),
        rng.standard_normal((2, cfg.dp.style.n_style, cfg.dp.style.style_value_dim)).astype(F32))
    texts = ["The exported bundle check.", "A second row, somewhat longer than the first."]
    noise = rng.standard_normal((2, 64, cfg.latent_channels)).astype(F32)
    gw, gd = tts.engine.infer_batch(texts, ["en", "en"], style, 2, noise=noise)
    nw, nd = native.infer_batch(texts, ["en", "en"], style, 2, noise=noise)
    np.testing.assert_allclose(gd, nd, rtol=1e-6)
    chunk = cfg.chunk_size
    lat = lambda d: ((d * cfg.sample_rate).astype(np.int64) + chunk - 1) // chunk  # noqa: E731
    np.testing.assert_array_equal(lat(gd), lat(nd))
    assert gw.shape == nw.shape
    np.testing.assert_allclose(gw, nw, atol=1e-4)


@pytest.mark.parametrize("fused", ["1", "0"], ids=["fused", "adapter"])
def test_http_server_over_a_bundle(onnx_dir, monkeypatch, fused):  # noqa: F811
    from supertonic_tpu_torch.serve.http_server import make_server

    monkeypatch.setenv("TTS_ONNX_FUSED", fused)
    tts = TTS(onnx_dir, device="cpu")
    server = make_server(tts, "127.0.0.1", 0)  # batcher on
    port = server.server_address[1]
    threading.Thread(target=server.serve_forever, daemon=True).start()
    base = f"http://127.0.0.1:{port}"
    try:
        assert httpx.get(f"{base}/health").status_code == 200
        r = httpx.post(f"{base}/tts", json={"text": "Served from graphs.",
                                            "total_step": 2}, timeout=120)
        assert r.status_code == 200 and r.headers["content-type"].startswith("audio/wav")
        wav, sr = read_wav(io.BytesIO(r.content))
        assert sr == 80 and len(wav) > 0
        r = httpx.post(f"{base}/tts/stream",
                       json={"text": "Streaming over the graph backend. Two chunks.",
                             "total_step": 2}, timeout=120)
        assert r.status_code == 200 and len(r.content) > 44
        m = httpx.get(f"{base}/metrics").json()
        assert m["requests"] >= 1 and m["batcher"]["batches"] >= 1
    finally:
        server.shutdown()
        server.service.close()
