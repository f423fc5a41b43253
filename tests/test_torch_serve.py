"""The port's serving surface on the CPU, mirroring tests/test_service.py
against the port's ``make_server`` (stdlib HTTP over the ContinuousBatcher),
plus the CLI's flag parity and runs, the router in front of the port's
server, and the framework-free copies (logging, StageProfiler, router
policy, demo page) held against the originals."""

import argparse
import io
import json
import os
import threading
import zipfile

import httpx
import numpy as np
import pytest
import torch

import supertonic_tpu.serve.cli as jcli
import supertonic_tpu.serve.demo_page as jdemo
import supertonic_tpu.serve.http_server as jhttp
import supertonic_tpu.serve.router as jrouter
import supertonic_tpu.utils.logging as jlogging
import supertonic_tpu.utils.timing as jtiming
import supertonic_tpu_torch.serve.cli as cli
import supertonic_tpu_torch.serve.demo_page as demo
import supertonic_tpu_torch.serve.http_server as http_server
import supertonic_tpu_torch.serve.router as router
import supertonic_tpu_torch.utils.logging as tlogging
import supertonic_tpu_torch.utils.timing as ttiming
from supertonic_tpu_torch import TTS
from supertonic_tpu_torch.serve.http_server import TTSService, make_server
from supertonic_tpu_torch.utils import read_wav, wav_bytes

from test_onnx_pipeline import onnx_dir  # noqa: F401  (a four-graph bundle)

LONG = " ".join(f"Streaming sentence number {i} with several more words attached."
                for i in range(6))


@pytest.fixture(scope="module", autouse=True)
def _few_threads():
    """The suite runs several test processes at once: two threads each keep
    these many small ops from oversubscribing the host's cores."""
    n = torch.get_num_threads()
    torch.set_num_threads(min(n, 2))
    yield
    torch.set_num_threads(n)


@pytest.fixture(scope="module")
def tts(tiny_config, tmp_path_factory):
    with pytest.MonkeyPatch.context() as mp:
        mp.setenv("TTS_RATE_CACHE_DIR", str(tmp_path_factory.mktemp("rates")))
        yield TTS(device="cpu", cfg=tiny_config, precision="f32")


@pytest.fixture(scope="module")
def tts_server(tts):
    server = make_server(tts, "127.0.0.1", 0)
    thread = threading.Thread(target=server.serve_forever, daemon=True)
    thread.start()
    yield f"http://127.0.0.1:{server.server_address[1]}", server
    server.shutdown()
    server.service.close()
    thread.join(timeout=30)


@pytest.fixture(scope="module")
def base_url(tts_server):
    return tts_server[0]


def test_health(base_url):
    r = httpx.get(f"{base_url}/health")
    assert r.status_code == 200 and r.json() == {"status": "ok"}


def test_single_tts_returns_wav(base_url):
    r = httpx.post(f"{base_url}/tts", json={"text": "Hello service.", "total_step": 2},
                   timeout=120)
    assert r.status_code == 200
    assert r.headers["content-type"].startswith("audio/wav")
    assert r.headers["content-disposition"] == 'attachment; filename="Hello_service_.wav"'
    wav, sr = read_wav(io.BytesIO(r.content))
    assert sr == 16000 and len(wav) > 0


def test_batch_returns_zip(base_url):
    r = httpx.post(f"{base_url}/tts", json={
        "text": ["First one.", "Second one."], "lang": ["en", "en"],
        "voice_style": ["M1", "F1"], "batch": True, "total_step": 2}, timeout=120)
    assert r.status_code == 200
    assert r.headers["content-type"] == "application/zip"
    zf = zipfile.ZipFile(io.BytesIO(r.content))
    assert sorted(zf.namelist()) == ["First_one_.wav", "Second_one_.wav"]


@pytest.mark.parametrize("body,status,detail", [
    ({"text": "Hi.", "lang": "de"}, 400, "Invalid language"),
    ({"text": ["a", "b"], "lang": ["en"], "voice_style": ["M1"], "batch": True}, 400,
     "same length"),
    ({"text": ["a", "b"]}, 400, "Non-batch mode"),
    ({"text": "Hi.", "total_step": 0}, 422, "total_step"),
    ({"text": "Hi.", "total_step": 51}, 422, "total_step"),
    ({"text": "Hi.", "voice_style": "Z9"}, 400, "not found"),
    ({}, 422, "'text' is required"),
])
def test_rejections(base_url, body, status, detail):
    r = httpx.post(f"{base_url}/tts", json=body, timeout=60)
    assert r.status_code == status
    assert detail in r.json()["detail"]


def test_type_validation_422(base_url):
    """Malformed field types give a clean 422, never a stack trace."""
    bad = [{"text": "hi", "silence_duration": "x"}, {"text": "hi", "crossfade_duration": None},
           {"text": 42}, {"text": ["ok"], "lang": [7]}, {"text": "hi", "speed": "fast"},
           {"text": "hi", "total_step": 2.5}, {"text": "hi", "voice_style": 3}]
    for body in bad:
        r = httpx.post(f"{base_url}/tts", json=body)
        assert r.status_code == 422, body
        assert "detail" in r.json()
    r = httpx.post(f"{base_url}/tts", content=b"{not json",
                   headers={"content-type": "application/json"})
    assert r.status_code == 422 and r.json()["detail"] == "invalid JSON body"


def test_not_found_404(base_url):
    assert httpx.get(f"{base_url}/nope").status_code == 404
    assert httpx.post(f"{base_url}/nope", json={}).status_code == 404


def test_concurrent_requests(base_url):
    results = []

    def hit():
        r = httpx.post(f"{base_url}/tts", json={"text": "Concurrency check.", "total_step": 2},
                       timeout=180)
        results.append(r.status_code)

    threads = [threading.Thread(target=hit) for _ in range(4)]
    for t in threads:
        t.start()
    for t in threads:
        t.join(timeout=300)
    assert results == [200] * 4


def test_streaming_endpoint(base_url):
    pcm = bytearray()
    with httpx.stream("POST", f"{base_url}/tts/stream",
                      json={"text": LONG, "total_step": 2, "speed": 3.0}, timeout=300) as r:
        assert r.status_code == 200
        assert r.headers["content-type"] == "audio/wav"
        assert r.headers["transfer-encoding"] == "chunked"
        for chunk in r.iter_bytes():
            pcm.extend(chunk)
    assert pcm[:4] == b"RIFF" and pcm[8:12] == b"WAVE"
    assert len(pcm) > 44 + 16000 * 2  # at least a second of 16 kHz PCM16
    samples = np.frombuffer(bytes(pcm[44:]), dtype="<i2")
    assert np.abs(samples).max() > 0


def test_streaming_rejects_batch_and_bad_lang(base_url):
    r = httpx.post(f"{base_url}/tts/stream", json={
        "text": ["a", "b"], "lang": ["en", "en"], "voice_style": ["M1", "M1"]})
    assert r.status_code == 400
    r = httpx.post(f"{base_url}/tts/stream", json={"text": "Hi.", "lang": "xx"})
    assert r.status_code == 400


def test_http_concurrency_soak_batches(tts_server):
    """40 concurrent requests through the batcher: fewer device batches
    than requests, every response a WAV, /metrics populated."""
    base_url, server = tts_server
    batcher = server.service.batcher
    start_batches, start_requests = batcher.stats["batches"], batcher.stats["requests"]
    texts = ["Short one.", "A medium length sentence for the soak test run.",
             "This is a somewhat longer sentence so that multiple text buckets are "
             "exercised by the grouping logic."]
    results = []

    def hit(i):
        r = httpx.post(f"{base_url}/tts", json={"text": texts[i % 3], "total_step": 2},
                       timeout=300)
        results.append((r.status_code, r.content[:4]))

    threads = [threading.Thread(target=hit, args=(i,)) for i in range(40)]
    for t in threads:
        t.start()
    for t in threads:
        t.join(timeout=600)
    assert [s for s, _ in results] == [200] * 40
    assert all(head == b"RIFF" for _, head in results)
    assert batcher.stats["requests"] - start_requests == 40
    assert batcher.stats["batches"] - start_batches < 40
    m = httpx.get(f"{base_url}/metrics").json()
    assert m["requests"] >= 40 and m["latency_p50_s"] > 0
    assert m["batcher"]["batched_requests"] >= 40


def test_metrics(base_url):
    m = httpx.get(f"{base_url}/metrics").json()
    for key in ("rtf", "audio_sec_per_sec", "latency_p50_s", "latency_p95_s",
                "ttfa_p50_s", "stages_s", "counters", "batcher"):
        assert key in m
    # device memory comes from torch.cuda, one row per visible card
    assert ("device_memory" in m) == torch.cuda.is_available()


def test_device_memory_stats_without_a_card():
    if torch.cuda.is_available():
        pytest.skip("a CUDA card is present: the stats are real")
    assert http_server._device_memory_stats() is None


def test_stream_records_ttfa(tts_server):
    base_url, _server = tts_server
    with httpx.stream("POST", f"{base_url}/tts/stream",
                      json={"text": LONG, "total_step": 2, "speed": 3.0}, timeout=300) as r:
        assert r.status_code == 200
        next(r.iter_bytes())  # first audio arrived
    m = httpx.get(f"{base_url}/metrics").json()
    assert m["streams"] >= 1 and m["ttfa_p50_s"] > 0


def test_oversized_body_413(base_url):
    big = b'{"text": "' + b"a" * (9 * 1024 * 1024) + b'"}'
    r = httpx.post(f"{base_url}/tts", content=big,
                   headers={"content-type": "application/json"}, timeout=30)
    assert r.status_code == 413 and "exceeds" in r.json()["detail"]


def test_malformed_content_length_400(base_url):
    import socket
    from urllib.parse import urlparse

    u = urlparse(base_url)
    with socket.create_connection((u.hostname, u.port), timeout=10) as s:
        s.sendall(b"POST /tts HTTP/1.1\r\nHost: x\r\nContent-Length: abc\r\n\r\n")
        resp = s.recv(4096)
    assert resp.startswith(b"HTTP/1.1 400")


def test_voices_endpoint(base_url):
    body = httpx.get(f"{base_url}/voices").json()
    assert body["voices"] and "M1" in body["voices"] and body["source"] == "presets"


def test_style_path_rejected_over_http(base_url):
    for bad in ("../styles/M1", "/tmp/anything.json", ".hidden"):
        r = httpx.post(f"{base_url}/tts", json={"text": "x", "voice_style": bad}, timeout=60)
        assert r.status_code == 400, (bad, r.status_code)


def test_empty_stream_chunk_not_a_terminator(tts_server):
    base_url, server = tts_server
    orig = server.service.stream_wav_bytes
    try:
        server.service.stream_wav_bytes = lambda req: iter([b"HEAD", b"", b"TAIL"])
        with httpx.stream("POST", f"{base_url}/tts/stream", json={"text": "x"},
                          timeout=30) as r:
            assert r.status_code == 200
            body = b"".join(r.iter_bytes())
        assert body == b"HEADTAIL"
    finally:
        server.service.stream_wav_bytes = orig


def test_stream_failure_after_headers_aborts_cleanly(tts_server):
    base_url, server = tts_server

    def boom(req):
        yield b"PARTIAL"
        raise RuntimeError("device fell over")

    orig = server.service.stream_wav_bytes
    try:
        server.service.stream_wav_bytes = boom
        got = bytearray()
        with pytest.raises(httpx.HTTPError):
            with httpx.stream("POST", f"{base_url}/tts/stream", json={"text": "x"},
                              timeout=30) as r:
                for chunk in r.iter_bytes():
                    got.extend(chunk)
        assert b"500" not in got and b"detail" not in got
    finally:
        server.service.stream_wav_bytes = orig


def test_openai_speech_wav_and_pcm(base_url):
    wav = httpx.post(f"{base_url}/v1/audio/speech",
                     json={"input": "Same words twice.", "voice": "alloy", "total_step": 2},
                     timeout=120)
    assert wav.status_code == 200 and wav.headers["content-type"] == "audio/wav"
    assert wav.content[:4] == b"RIFF" and "content-disposition" not in wav.headers
    pcm = httpx.post(f"{base_url}/v1/audio/speech",
                     json={"input": "Same words twice.", "voice": "alloy", "total_step": 2,
                           "response_format": "pcm"}, timeout=120)
    assert pcm.status_code == 200 and pcm.headers["content-type"] == "audio/pcm"
    assert pcm.content[:4] != b"RIFF"
    assert len(pcm.content) == len(wav.content) - 44


@pytest.mark.parametrize("body,want", [
    ({"voice": "M1"}, 422), ({"input": ""}, 422),
    ({"input": "x", "response_format": "mp3"}, 400), ({"input": "x", "speed": 9.0}, 422),
    ({"input": "x", "speed": 0.1}, 422), ({"input": "x", "voice": "nope"}, 400),
    ({"input": "x", "lang": "zz"}, 400), ({"input": "hi", "lang": 5}, 422),
])
def test_openai_speech_validation(base_url, body, want):
    r = httpx.post(f"{base_url}/v1/audio/speech", json=body, timeout=60)
    assert r.status_code == want, (body, r.status_code, r.text)


def test_parsers_equal_the_originals():
    """The request parsers of the copy accept and reject like the JAX
    package's, with the same details."""
    bodies = [{"text": "hi"}, {"text": ["a", "b"], "batch": 1, "speed": 2},
              {"text": "hi", "total_step": True}, {"text": "hi", "silence_duration": -1},
              [1], {"input": "x", "voice": "ECHO", "speed": 4}, {"input": "x", "speed": True}]
    for parse, jparse in ((http_server._parse_request, jhttp._parse_request),
                          (http_server._parse_speech_request, jhttp._parse_speech_request)):
        for body in bodies:
            try:
                want = ("ok", jparse(body))
            except jhttp.ValidationError as e:
                want = ("err", e.status, e.detail)
            try:
                got = ("ok", parse(body))
            except http_server.ValidationError as e:
                got = ("err", e.status, e.detail)
            assert got == want, body


def test_wav_data_payload_chunk_walk():
    import struct

    samples = np.linspace(-0.5, 0.5, 64, dtype=np.float32)
    w = wav_bytes(samples, 80)
    assert http_server._wav_data_payload(w) == w[44:] == jhttp._wav_data_payload(w)
    data = (samples * 32767).astype("<i2").tobytes()
    fmt = struct.pack("<HHIIHH", 1, 1, 80, 160, 2, 16)
    lst = b"LIST" + struct.pack("<I", 10) + b"INFOabcdef"
    body = (b"WAVE" + b"fmt " + struct.pack("<I", len(fmt)) + fmt + lst
            + b"data" + struct.pack("<I", len(data)) + data)
    assert http_server._wav_data_payload(b"RIFF" + struct.pack("<I", len(body)) + body) == data
    with pytest.raises(http_server.ValidationError, match="data chunk"):
        http_server._wav_data_payload(b"RIFF" + struct.pack("<I", 4) + b"WAVE")


def test_voice_style_blend_syntax(tts_server):
    base_url, server = tts_server
    svc = server.service
    s_blend, s_m1, s_f1 = svc.get_style("M1+F1:0.25"), svc.get_style("M1"), svc.get_style("F1")
    np.testing.assert_allclose(s_blend.ttl, 0.75 * s_m1.ttl + 0.25 * s_f1.ttl, rtol=1e-6)
    s_half, s_m2, s_f2 = svc.get_style("M2+F2"), svc.get_style("M2"), svc.get_style("F2")
    np.testing.assert_allclose(s_half.dp, 0.5 * s_m2.dp + 0.5 * s_f2.dp, rtol=1e-6)
    r = httpx.post(f"{base_url}/tts", json={"text": "Blended voice.", "total_step": 2,
                                            "voice_style": "M1+F1:0.5"}, timeout=120)
    assert r.status_code == 200 and r.content[:4] == b"RIFF"
    for bad in ("M1+F1:1.5", "M1+", "+F1", "M1+F1+M2", "M1+F1:x", "M1+nope"):
        r = httpx.post(f"{base_url}/tts", json={"text": "x", "voice_style": bad}, timeout=60)
        assert r.status_code == 400, (bad, r.status_code)


def test_nonbatcher_stream_does_not_hold_lock_for_slow_reader(tts):
    """Without the batcher the engine lock is held per computed piece,
    never across client writes: a suspended stream does not block /tts."""
    svc = TTSService(tts, use_batcher=False)
    req = {"text": LONG, "lang": "en", "voice_style": "M1", "total_step": 2, "speed": 3.0,
           "batch": False, "silence_duration": 0.3, "crossfade_duration": 0.0}
    gen = svc.stream_chunks(req)
    next(gen)  # the generator is now suspended mid-stream
    done = threading.Event()

    def other_request():
        svc.synthesize(dict(req, text="Quick one."))
        done.set()

    t = threading.Thread(target=other_request, daemon=True)
    t.start()
    assert done.wait(timeout=120), "concurrent /tts blocked behind a suspended stream"
    list(gen)
    svc.close()


def test_demo_page_served_at_root(base_url):
    r = httpx.get(f"{base_url}/", timeout=30)
    assert r.status_code == 200 and r.headers["content-type"].startswith("text/html")
    assert r.text == demo.DEMO_HTML == jdemo.DEMO_HTML
    assert "/tts" in r.text and "streamPlay" in r.text and "getReader()" in r.text


def test_logger_and_profiler_equal_the_originals():
    a, b = io.StringIO(), io.StringIO()
    tlogging.JsonLogger(stream=a, name="t").warning("hello", n=3, x=[1, 2])
    jlogging.JsonLogger(stream=b, name="t").warning("hello", n=3, x=[1, 2])
    ra, rb = json.loads(a.getvalue()), json.loads(b.getvalue())
    assert ra.pop("ts") > 0 and rb.pop("ts") > 0
    assert ra == rb == {"level": "warning", "logger": "t", "event": "hello", "n": 3,
                        "x": [1, 2]}
    profs = ttiming.StageProfiler(), jtiming.StageProfiler()
    for p in profs:
        p.bump("bucket_overflows")
        p.bump("egress_tail_fetches", 2)
        p.record_throughput(2.0, 40, 0.5)
        for lat in (0.1, 0.3, 0.2, 0.9):
            p.record_result(1.0, 10, lat)
        p.record_request_latency(0.4)
        p.record_ttfa(0.05)
        p.record_ttfa(0.07)
    got, want = (p.summary() for p in profs)
    assert got == want and got["requests"] == 5 and got["counters"]["egress_tail_fetches"] == 2
    assert ttiming.sanitize_filename("Héllo, wörld!", 9) == jtiming.sanitize_filename(
        "Héllo, wörld!", 9) == "Héllo__wö"


def test_device_trace_writes_a_chrome_trace(tmp_path):
    """``device_trace`` (the port's counterpart of the JAX package's
    ``jax.profiler`` trace) writes a Chrome trace of the block into its
    folder; on the CPU it holds the host's ops."""
    import json

    import torch

    logdir = tmp_path / "trace"
    with ttiming.device_trace(str(logdir)) as prof:
        torch.randn(64, 64) @ torch.randn(64, 64)
    assert os.path.dirname(prof.trace_path) == str(logdir)
    with open(prof.trace_path) as f:
        events = json.load(f)["traceEvents"]
    assert any(e.get("name") == "aten::mm" for e in events)


def test_router_policy_equals_the_original():
    """Backend state and least-expected-wait dispatch of the copy follow the
    original's on the same sequence of events (no network: the idle probe
    window is pushed out of reach)."""
    urls = ["http://a:1", "http://b:2/", "http://c:3"]
    rs = [mod.Router(urls, probe_after_s=1e12, failure_threshold=2)
          for mod in (router, jrouter)]
    picks = [[], []]
    for r, out in zip(rs, picks):
        a, b, c = r.backends
        for lat in (0.5, 0.2, 0.9):
            a.observe_latency(lat)
        b.observe_latency(0.3)
        out.append(r.pick().url)      # c unproven and idle: optimistic
        c.acquire()
        out.append(r.pick().url)      # c busy and unproven: never stacked
        a.acquire(), a.acquire()
        out.append(r.pick(exclude={"http://b:2"}).url)
        b.mark_failed(2), b.mark_failed(2)
        out.append(r.pick().url)
        b.mark_ok(), c.release()
        out.append(r.pick().url)
        for bk in r.backends:
            bk.mark_failed(2), bk.mark_failed(2)
        out.append(r.pick().url)      # desperation pass
        out.append(json.dumps(r.health(), sort_keys=True))
    assert picks[0] == picks[1]
    with pytest.raises(router.NoBackendAvailable):
        rs[0].pick(exclude=set(u.rstrip("/") for u in urls))
    with pytest.raises(ValueError):
        router.Router([])


def test_router_forwards_to_the_port_server(base_url):
    r = router.Router([base_url], health_interval_s=0.2, failure_threshold=1)
    r.check_health()
    front = router.make_router_server(r, "127.0.0.1", 0)
    thread = threading.Thread(target=front.serve_forever, daemon=True)
    thread.start()
    try:
        url = f"http://127.0.0.1:{front.server_address[1]}"
        assert httpx.get(f"{url}/health").json()["status"] == "ok"
        resp = httpx.post(f"{url}/tts", json={"text": "Hello router.", "total_step": 2},
                          timeout=120)
        assert resp.status_code == 200 and resp.content[:4] == b"RIFF"
        assert r.backends[0].requests == 1 and r.backends[0].pending == 0
    finally:
        front.shutdown()
        r.close()
        thread.join(timeout=30)


@pytest.mark.parametrize("argv", [
    [],
    ["--onnx-dir", "/x", "--use-gpu", "--total-step", "3", "--speed", "1.2", "--n-test",
     "2", "--voice-style", "M1", "--text", "Hi.", "--lang", "en", "--save-dir", "/tmp/o"],
    ["--assets-dir", "/y", "--batch", "--text", "a", "b", "--voice-style", "M1", "F1",
     "--precision", "int8", "--crossfade", "0.05", "--platform", "cpu"],
])
def test_cli_flag_parity(argv, monkeypatch):
    """Every flag of the JAX CLI, with the same destinations and defaults
    (--platform names a torch device: cpu or cuda)."""
    for var in ("TTS_ASSETS_DIR", "TTS_ONNX_DIR", "TTS_PLATFORM"):
        monkeypatch.delenv(var, raising=False)
    assert vars(cli.parse_args(argv)) == vars(jcli.parse_args(argv))
    jparser_flags = {s for a in _parser(jcli)._actions for s in a.option_strings}
    assert {s for a in _parser(cli)._actions for s in a.option_strings} == jparser_flags


def _parser(mod) -> argparse.ArgumentParser:
    """The parser parse_args builds (captured at parse time)."""
    got = {}
    real = argparse.ArgumentParser.parse_args

    def grab(self, *a, **kw):
        got["p"] = self
        return real(self, *a, **kw)

    argparse.ArgumentParser.parse_args = grab
    try:
        mod.parse_args([])
    finally:
        argparse.ArgumentParser.parse_args = real
    return got["p"]


@pytest.fixture(scope="module")
def tiny_assets(tiny_config, tmp_path_factory):
    """An assets dir holding the tiny config and random-init weights."""
    import dataclasses

    from supertonic_tpu_torch.assets import save_params
    from supertonic_tpu_torch.models import init_all

    d = tmp_path_factory.mktemp("assets")
    (d / "model_config.json").write_text(json.dumps(dataclasses.asdict(tiny_config)))
    save_params(str(d / "params.npz"), init_all(0, tiny_config))
    return str(d)


def test_cli_single_and_batch(tiny_assets, tmp_path, monkeypatch, capsys):
    monkeypatch.setenv("TTS_RATE_CACHE_DIR", str(tmp_path / "rates"))
    out = tmp_path / "wavs"
    cli.main(["--platform", "cpu", "--assets-dir", tiny_assets, "--n-test", "1",
              "--total-step", "2", "--save-dir", str(out), "--text", "One short sentence.",
              "--use-gpu"])
    wavs = list(out.glob("*.wav"))
    assert [w.name for w in wavs] == ["One_short_sentence__1.wav"]
    data, sr = read_wav(str(wavs[0]))
    assert sr == 16000 and len(data) > 0 and np.isfinite(np.asarray(data, np.float64)).all()
    out2 = tmp_path / "batch"
    cli.main(["--platform", "cpu", "--assets-dir", tiny_assets, "--batch", "--n-test", "1",
              "--total-step", "2", "--save-dir", str(out2), "--text", "First one.",
              "Second one.", "--voice-style", "M1", "F1+M2:0.3", "--lang", "en"])
    assert len(list(out2.glob("*.wav"))) == 2
    assert "Synthesis completed successfully" in capsys.readouterr().out


@pytest.mark.parametrize("argv,match", [
    (["--text", "One.", "Two.", "--voice-style", "M1"], "must match"),
    (["--text", "x", "--voice-style", "M1+F1:abc"], "blend"),
])
def test_cli_rejects_bad_arguments(tiny_assets, tmp_path, argv, match):
    with pytest.raises(SystemExit, match=match):
        cli.main(["--platform", "cpu", "--assets-dir", tiny_assets,
                  "--save-dir", str(tmp_path)] + argv)


def test_entry_points_need_a_card_unless_asked_for_the_cpu(tiny_assets, tmp_path,
                                                           monkeypatch):
    """Without a card, the server's main and the CLI raise unless the CPU is
    asked for; they never move to the CPU on their own."""
    if torch.cuda.is_available():
        pytest.skip("a CUDA card is present: the default device is usable")
    monkeypatch.delenv("TTS_PLATFORM", raising=False)
    monkeypatch.setenv("TTS_ASSETS_DIR", tiny_assets)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        http_server.main()
    with pytest.raises(RuntimeError, match="no CUDA device"):
        cli.main(["--assets-dir", tiny_assets, "--save-dir", str(tmp_path)])
    with pytest.raises(RuntimeError, match="no CUDA device"):
        cli.main(["--platform", "cuda", "--assets-dir", tiny_assets,
                  "--save-dir", str(tmp_path)])


@pytest.mark.parametrize("entry", ["server", "cli"])
def test_entry_points_refuse_an_onnx_bundle(entry, onnx_dir, tmp_path, monkeypatch):
    """TTS_ONNX_DIR, the reference service's name for the assets directory,
    serves a bundle of the four ONNX graphs through the server and the CLI;
    a directory with neither the graphs nor params.npz still raises instead
    of serving random weights."""
    monkeypatch.setenv("TTS_PLATFORM", "cpu")
    monkeypatch.setenv("TTS_RATE_CACHE_DIR", str(tmp_path / "rates"))
    monkeypatch.delenv("TTS_ASSETS_DIR", raising=False)
    monkeypatch.setenv("TTS_ONNX_DIR", onnx_dir)
    out = tmp_path / "out"
    if entry == "server":
        served = []
        real_make = http_server.make_server

        def make(tts, host, port, **kw):
            server = real_make(tts, "127.0.0.1", 0, **kw)
            serve = server.serve_forever

            def serve_one_request():
                thread = threading.Thread(target=serve, daemon=True)
                thread.start()
                url = f"http://127.0.0.1:{server.server_address[1]}"
                served.append((tts, httpx.post(f"{url}/tts", json={
                    "text": "Served from graphs.", "total_step": 2}, timeout=120)))
                server.shutdown()
                thread.join(timeout=30)

            server.serve_forever = serve_one_request
            return server

        monkeypatch.setattr(http_server, "make_server", make)
        http_server.main()
        (tts, resp), = served
        assert tts.engine.backend is not None and tts.cfg.sample_rate == 80
        assert resp.status_code == 200 and resp.content[:4] == b"RIFF"
        run = http_server.main
    else:
        cli.main(["--save-dir", str(out), "--n-test", "1", "--total-step", "2"])
        assert any(f.endswith(".wav") for f in os.listdir(out))

        def run():
            cli.main(["--save-dir", str(out)])
    empty = tmp_path / "empty"
    empty.mkdir()
    (empty / "tts.json").write_text("{}")
    monkeypatch.setenv("TTS_ONNX_DIR", str(empty))
    with pytest.raises(FileNotFoundError, match="neither params.npz nor"):
        run()
    monkeypatch.delenv("TTS_ONNX_DIR")
    with pytest.raises(FileNotFoundError, match="neither params.npz nor"):
        cli.main(["--onnx-dir", str(empty), "--save-dir", str(out)])
    with pytest.raises(FileNotFoundError, match="neither params.npz nor"):
        TTS(str(tmp_path / "missing"), device="cpu")
