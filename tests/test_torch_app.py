"""The port's FastAPI app (``serve/app.py``). FastAPI is optional: the
module imports without it and ``create_app`` raises a clear ImportError;
where FastAPI is installed, the app serves the stdlib server's contract on
a small CPU model."""

import dataclasses
import io
import json
import sys

import pytest

import supertonic_tpu_torch.serve.app as app_mod


def test_module_imports_and_create_app_says_what_is_missing(monkeypatch):
    monkeypatch.setitem(sys.modules, "fastapi", None)  # as if not installed
    with pytest.raises(ImportError, match="needs fastapi and pydantic"):
        app_mod.create_app(object())
    assert callable(app_mod.main)


def test_app_serves_the_contract(tiny_config, tmp_path, monkeypatch):
    pytest.importorskip("fastapi")
    pytest.importorskip("httpx")
    from fastapi.testclient import TestClient

    from supertonic_tpu_torch import TTS
    from supertonic_tpu_torch.assets import save_params
    from supertonic_tpu_torch.models import init_all
    from supertonic_tpu_torch.utils import read_wav

    monkeypatch.setenv("TTS_RATE_CACHE_DIR", str(tmp_path / "rates"))
    d = tmp_path / "assets"
    d.mkdir()
    with open(d / "model_config.json", "w") as f:
        json.dump(dataclasses.asdict(tiny_config), f)
    save_params(str(d / "params.npz"), init_all(0, tiny_config))
    client = TestClient(app_mod.create_app(TTS(str(d), device="cpu"), use_batcher=False))
    assert client.get("/health").json() == {"status": "ok"}
    r = client.post("/tts", json={"text": "Hi there.", "total_step": 2})
    assert r.status_code == 200
    wav, sr = read_wav(io.BytesIO(r.content))
    assert sr == tiny_config.sample_rate and len(wav) > 0
    assert client.post("/tts", json={"text": "x", "total_step": 0}).status_code == 422
    assert client.get("/metrics").json()["requests"] >= 1
