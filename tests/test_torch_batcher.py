"""The port's continuous batcher and the engine state behind it on the CPU,
mirroring tests/test_batcher.py, and held against the JAX engine: the
learned-rate priors in JAX's sequence, voice blends, and the thread-safe
first build of the kernel libraries."""

import ctypes
import json
import sys
import threading
import time

import numpy as np
import pytest
import torch

from supertonic_tpu.engine import SynthesisEngine as JEngine
from supertonic_tpu.engine import VoiceStyle as JVoiceStyle
from supertonic_tpu.engine.engine import parse_blend_spec as j_parse_blend_spec
from supertonic_tpu.frontend import UnicodeProcessor as JProcessor
from supertonic_tpu.frontend import build_default_indexer as j_indexer
from supertonic_tpu_torch.engine import SynthesisEngine, VoiceStyle, parse_blend_spec
from supertonic_tpu_torch.frontend import (UnicodeProcessor, build_default_indexer,
                                           preprocess_text)
from supertonic_tpu_torch.models import init_all
from supertonic_tpu_torch.ops import _build
from supertonic_tpu_torch.parallel import ContinuousBatcher


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
    return init_all(0, tiny_config)


@pytest.fixture()
def engine(params, tiny_config, monkeypatch, tmp_path):
    monkeypatch.setenv("TTS_RATE_CACHE_DIR", str(tmp_path))
    return SynthesisEngine(params, tiny_config, UnicodeProcessor(build_default_indexer()),
                           precision="f32", seed=0, device="cpu")


def _style(cfg, seed=7, cls=VoiceStyle):
    rng = np.random.default_rng(seed)
    return cls(
        rng.standard_normal((1, cfg.ttl.style.n_style,
                             cfg.ttl.style.style_value_dim)).astype(np.float32),
        rng.standard_normal((1, cfg.dp.style.n_style,
                             cfg.dp.style.style_value_dim)).astype(np.float32),
    )


def test_requests_are_batched(engine, tiny_config):
    batcher = ContinuousBatcher(engine, max_batch=8, max_wait_ms=150.0)
    style = _style(tiny_config)
    try:
        futures = [batcher.submit(f"Concurrent request number {i}.", "en", style,
                                  total_step=2) for i in range(6)]
        for wav, dur in (f.result(timeout=300) for f in futures):
            assert dur > 0
            assert len(wav) == int(tiny_config.sample_rate * dur)
        # 6 same-bucket requests arriving together -> far fewer batches
        assert batcher.stats["batches"] < 6
        assert batcher.stats["batched_requests"] == 6
    finally:
        batcher.shutdown()


def test_mixed_styles_and_langs(engine, tiny_config):
    batcher = ContinuousBatcher(engine, max_batch=8, max_wait_ms=100.0)
    try:
        futs = [batcher.submit("Hello there.", "en", _style(tiny_config, 1), 2),
                batcher.submit("Bonjour le monde.", "fr", _style(tiny_config, 2), 2),
                batcher.submit("Hola mundo.", "es", _style(tiny_config, 3), 2)]
        for f in futs:
            wav, dur = f.result(timeout=300)
            assert dur > 0 and np.isfinite(wav).all()
    finally:
        batcher.shutdown()


def test_different_steps_split_groups(engine, tiny_config):
    batcher = ContinuousBatcher(engine, max_batch=8, max_wait_ms=100.0)
    style = _style(tiny_config)
    try:
        f1 = batcher.submit("Steps two.", "en", style, total_step=2)
        f2 = batcher.submit("Steps three.", "en", style, total_step=3)
        assert f1.result(timeout=300)[1] > 0
        assert f2.result(timeout=300)[1] > 0
        assert batcher.stats["batches"] == 2
    finally:
        batcher.shutdown()


def test_shutdown_rejects_new_work(engine, tiny_config):
    batcher = ContinuousBatcher(engine, max_batch=4, max_wait_ms=10.0)
    batcher.shutdown()
    assert not batcher._thread.is_alive()
    with pytest.raises(RuntimeError, match="shut down"):
        batcher.submit("Late.", "en", _style(tiny_config))


def test_soak_concurrent_mixed_requests(engine, tiny_config):
    """Many concurrent submitters, mixed languages, styles and steps: every
    future resolves, and requests coalesce."""
    import concurrent.futures

    batcher = ContinuousBatcher(engine, max_batch=8, max_wait_ms=20.0)
    langs = ["en", "ko", "es", "pt", "fr"]
    try:
        def submit(i):
            return batcher.submit(f"Soak request {i} with some words.", langs[i % 5],
                                  _style(tiny_config, seed=i % 5), total_step=2 + (i % 2))

        with concurrent.futures.ThreadPoolExecutor(max_workers=8) as pool:
            futures = list(pool.map(submit, range(40)))
        results = [f.result(timeout=600) for f in futures]
        assert len(results) == 40
        for wav, dur in results:
            assert dur > 0 and len(wav) > 0
        assert batcher.stats["batched_requests"] == 40
        assert batcher.stats["batches"] < 40
    finally:
        batcher.shutdown()


class TestFaultInjection:
    """An engine failure mid-batch fails exactly that batch's futures with
    the real exception and leaves the batcher serving."""

    def test_dispatch_failure_fails_futures_then_recovers(self, engine, tiny_config):
        real_begin = engine.infer_batch_begin
        boom = {"armed": True}

        def flaky_begin(*a, **kw):
            if boom.pop("armed", False):
                raise RuntimeError("injected dispatch failure")
            return real_begin(*a, **kw)

        engine.infer_batch_begin = flaky_begin
        batcher = ContinuousBatcher(engine, max_batch=4, max_wait_ms=10.0)
        style = _style(tiny_config)
        try:
            f = batcher.submit("Doomed request.", "en", style, total_step=2)
            with pytest.raises(RuntimeError, match="injected dispatch"):
                f.result(timeout=300)
            wav, dur = batcher.submit("Recovered request.", "en", style,
                                      total_step=2).result(timeout=300)
            assert dur > 0 and np.isfinite(wav).all()
        finally:
            batcher.shutdown()

    def test_resolve_failure_fails_futures_then_recovers(self, engine, tiny_config):
        real_end = engine.infer_batch_end
        boom = {"armed": True}

        def flaky_end(pending):
            if boom.pop("armed", False):
                raise RuntimeError("injected resolve failure")
            return real_end(pending)

        engine.infer_batch_end = flaky_end
        batcher = ContinuousBatcher(engine, max_batch=4, max_wait_ms=10.0)
        style = _style(tiny_config)
        try:
            f = batcher.submit("Doomed at resolve.", "en", style, total_step=2)
            with pytest.raises(RuntimeError, match="injected resolve"):
                f.result(timeout=300)
            wav, dur = batcher.submit("Still serving.", "en", style,
                                      total_step=2).result(timeout=300)
            assert dur > 0
        finally:
            batcher.shutdown()


def test_batcher_matches_direct_engine(engine, tiny_config):
    """Batched synthesis equals a direct engine call on the same text,
    including expansion-heavy text, which would catch a double
    normalization of the pre-normalized dispatch."""
    text = "Use abbreviations, e.g., this one & that @ home."
    style = _style(tiny_config)
    batcher = ContinuousBatcher(engine, max_batch=4, max_wait_ms=20.0)
    try:
        wav_b, dur_b = batcher.submit(text, "en", style, total_step=2).result(timeout=300)
    finally:
        batcher.shutdown()
    wav_d, dur_d = engine.infer_batch([text], ["en"], style, total_step=2)
    assert float(dur_b) == pytest.approx(float(dur_d[0]), abs=1e-5)
    assert len(wav_b) == len(engine.trim(wav_d, dur_d)[0])
    ids_raw, mask_raw = engine.processor([text], ["en"])
    ids_pre, mask_pre = engine.processor([preprocess_text(text, "en")], ["en"],
                                         pre_normalized=True)
    np.testing.assert_array_equal(ids_raw, ids_pre)
    np.testing.assert_array_equal(mask_raw, mask_pre)


def test_mismatched_style_shape_fails_alone(engine, tiny_config):
    good = _style(tiny_config)
    bad = VoiceStyle(good.ttl[:, :, :-1], good.dp)  # wrong style_value_dim
    batcher = ContinuousBatcher(engine, max_batch=8, max_wait_ms=150.0)
    try:
        f_good = [batcher.submit(f"Valid request {i}.", "en", good, total_step=2)
                  for i in range(3)]
        f_bad = batcher.submit("Valid request X.", "en", bad, total_step=2)
        for f in f_good:
            wav, dur = f.result(timeout=300)
            assert dur > 0 and len(wav) > 0
        with pytest.raises(Exception):
            f_bad.result(timeout=300)
    finally:
        batcher.shutdown()


def test_speed_zero_rejected(engine, tiny_config):
    with pytest.raises(ValueError, match="speed"):
        engine.infer_batch(["Hi."], ["en"], _style(tiny_config), 2, 0.0)


def test_device_output_and_to_host(engine, tiny_config):
    """begin(device_output=True) leaves the waveform on the device; to_host
    brings it back decoded, equal to the host path's output for the same
    noise (engines with the same seed)."""
    style = _style(tiny_config)
    engine._pin_rate()
    p = engine.infer_batch_begin(["Device output."], ["en"], style, 2,
                                 device_output=True)
    assert p.wav_src is None and p.device_output
    wav_dev, dur = engine.infer_batch_end(p)
    assert wav_dev.dtype.is_floating_point is False  # int16 egress, undecoded
    wav = engine.to_host(wav_dev, p.ready)
    twin = SynthesisEngine(engine.params, tiny_config, engine.processor,
                           precision="f32", seed=0, device="cpu")
    twin._pin_rate()
    wav2, dur2 = twin.infer_batch(["Device output."], ["en"], style, total_step=2)
    np.testing.assert_array_equal(dur, dur2)
    n = wav2.shape[1]
    np.testing.assert_array_equal(wav[:, :n], wav2)
    assert engine.profiler.summary()["audio_seconds"] > 0


def test_warmup_does_not_pollute_learned_rate(engine, tiny_config, tmp_path):
    style = _style(tiny_config)
    # one real observation first (this one legitimately writes the cache)
    engine.infer_batch(["A real sentence for the rate learner."], ["en"], style,
                       total_step=2)
    window_before = {k: list(w) for k, w in engine._spc_windows.items()}
    cache_before = {p: p.read_text() for p in tmp_path.glob("stpu_rate*")}
    requests_before = engine.profiler.n_requests
    assert engine.warmup(batch_sizes=(1,), text_buckets=(32,), total_steps=(2,)) == 1
    assert {k: list(w) for k, w in engine._spc_windows.items()} == window_before
    assert {p: p.read_text() for p in tmp_path.glob("stpu_rate*")} == cache_before
    assert engine.profiler.n_requests == requests_before
    # empty tuples warm nothing (not the default lattice)
    assert engine.warmup(batch_sizes=(), total_steps=(2,)) == 0


def test_rate_prior_ratchets_and_self_heals(engine, tiny_config, tmp_path):
    """The persisted per-bucket prior ratchets up on new highs and writes
    down once a full window of real observations sits well below a
    poisoned prior; the file is the port's own."""
    style = _style(tiny_config)
    text = "A steady sentence for the rate learner to observe."
    engine.infer_batch([text], ["en"], style, total_step=2)
    lb = next(iter(engine._spc_windows))
    obs = engine._spc_window_for(lb)[-1]  # the observation (after the seed)
    assert engine._spc_priors[lb] >= obs
    assert engine._rate_cache_path().startswith(str(tmp_path))
    engine._spc_priors[lb] = obs * 2.0  # an outlier twice the real rate
    engine._spc_counts[lb] = 0
    engine._spc_windows.pop(lb)
    for _ in range(engine._spc_window_for(lb).maxlen):
        engine.infer_batch([text], ["en"], style, total_step=2)
    healed = engine._spc_priors[lb]
    assert healed < obs * 1.5, f"prior did not heal: {healed} vs obs {obs}"
    assert engine._load_rate_cache()[lb] == healed


def test_rate_priors_follow_the_jax_sequence(params, tiny_config, monkeypatch, tmp_path):
    """Given the same observations, the port's engine and the JAX engine
    hold the same priors and windows after each one, and write the same
    cache file (each in its own directory)."""
    jdir, tdir = tmp_path / "jax", tmp_path / "torch"
    monkeypatch.setenv("JAX_COMPILATION_CACHE_DIR", str(jdir))
    monkeypatch.setenv("TTS_RATE_CACHE_DIR", str(tdir))
    jeng = JEngine(params, tiny_config, JProcessor(j_indexer()), precision="f32")
    teng = SynthesisEngine(params, tiny_config, UnicodeProcessor(build_default_indexer()),
                           precision="f32", device="cpu")
    rng = np.random.default_rng(1)
    # a rise, a new bucket inheriting a smaller one's prior, an outlier, then
    # a full window well below it (the write-down)
    seq = ([(64, 0.09), (64, 0.095), (128, 0.07), (64, 0.3)]
           + [(64, 0.08 + 0.001 * rng.random()) for _ in range(18)]
           + [(192, 0.05), (32, 0.12)])
    for lb, obs in seq:
        jeng._observe_rate(lb, obs)
        teng._observe_rate(lb, obs)
        assert teng._spc_priors == jeng._spc_priors
        assert {k: list(w) for k, w in teng._spc_windows.items()} == \
            {k: list(w) for k, w in jeng._spc_windows.items()}
        assert teng._spc_estimate(320) == jeng._spc_estimate(320)
    assert teng._spc_priors[64] < 0.3  # the outlier was written down
    jfile = json.loads(next(jdir.glob("stpu_rates_*.json")).read_text())
    tfile = json.loads(next(tdir.glob("stpu_rates_*.json")).read_text())
    assert tfile == jfile
    assert next(jdir.glob("stpu_rates_*.json")).name == next(tdir.glob("stpu_rates_*.json")).name
    reread = SynthesisEngine(params, tiny_config, UnicodeProcessor(build_default_indexer()),
                             precision="f32", device="cpu")
    assert reread._spc_priors == teng._spc_priors


def test_corrupt_rate_cache_starts_from_defaults(params, tiny_config, monkeypatch, tmp_path):
    monkeypatch.setenv("TTS_RATE_CACHE_DIR", str(tmp_path))
    eng = SynthesisEngine(params, tiny_config, UnicodeProcessor(build_default_indexer()),
                          precision="f32", device="cpu")
    with open(eng._rate_cache_path(), "w") as f:
        f.write('{"64": 0.')  # torn
    assert eng._load_rate_cache() == {}
    with open(eng._rate_cache_path(), "w") as f:
        f.write('{"64": 0.5, "128": 7.0, "192": 0.0}')  # out-of-range values dropped
    assert eng._load_rate_cache() == {64: 0.5}


@pytest.mark.parametrize("spec", ["M1+F1", "M1+F1:0.3", "A+B:0", "A+B:1", "x+y:0.25"])
def test_parse_blend_spec_equals_jax(spec):
    assert parse_blend_spec(spec) == j_parse_blend_spec(spec)


@pytest.mark.parametrize("spec", ["M1+F1:1.5", "M1+", "+F1", "M1+F1+M2", "M1+F1:x",
                                  "M1", "M1+F1:-0.1"])
def test_parse_blend_spec_rejects_like_jax(spec):
    with pytest.raises(ValueError) as want:
        j_parse_blend_spec(spec)
    with pytest.raises(ValueError) as got:
        parse_blend_spec(spec)
    assert str(got.value) == str(want.value)


def test_blend_and_take_equal_jax(tiny_config):
    a, b = _style(tiny_config, 1), _style(tiny_config, 2)
    ja, jb = _style(tiny_config, 1, JVoiceStyle), _style(tiny_config, 2, JVoiceStyle)
    for t in (0.0, 0.3, 0.5, 1.0):
        got, want = a.blend(b, t), ja.blend(jb, t)
        np.testing.assert_array_equal(got.ttl, want.ttl)
        np.testing.assert_array_equal(got.dp, want.dp)
        assert got.ttl.dtype == np.float32
    four = VoiceStyle(np.concatenate([a.ttl, b.ttl] * 2), np.concatenate([a.dp, b.dp] * 2))
    jfour = JVoiceStyle(four.ttl, four.dp)
    for idx in (slice(0, 1), slice(1, 3), [3, 0]):
        np.testing.assert_array_equal(four.take(idx).ttl, jfour.take(idx).ttl)
        np.testing.assert_array_equal(four.take(idx).dp, jfour.take(idx).dp)
    with pytest.raises(ValueError, match="style shapes differ"):
        a.blend(four, 0.5)


def test_dispatch_generators_are_distinct_under_threads(engine):
    """Each dispatch seeds its own noise generator from the engine's chain
    under the host mutex: many threads at once never share a seed."""
    seeds, lock = [], threading.Lock()

    def draw():
        for _ in range(50):
            g = engine._next_generator()
            with lock:
                seeds.append(g.initial_seed())

    old = sys.getswitchinterval()
    sys.setswitchinterval(1e-6)
    try:
        threads = [threading.Thread(target=draw) for _ in range(8)]
        for t in threads:
            t.start()
        for t in threads:
            t.join(timeout=60)
        assert not any(t.is_alive() for t in threads)
    finally:
        sys.setswitchinterval(old)
    assert len(seeds) == 400 and len(set(seeds)) == 400


def test_first_build_runs_once_across_threads(monkeypatch):
    """Two threads making the first launch together build and load the
    kernel library once (the build is slow, so both are inside it at once
    without the lock)."""
    calls = {"build": 0, "cdll": 0}

    def fake_build_all(*, verbose=False):
        calls["build"] += 1
        time.sleep(0.2)
        return {name: f"/nonexistent/lib{name}.so" for name in _build.KERNELS}

    class FakeLib:
        def __getattr__(self, name):
            return type("Fn", (), {})()

    def fake_cdll(path):
        calls["cdll"] += 1
        return FakeLib()

    monkeypatch.setattr(_build, "build_all", fake_build_all)
    monkeypatch.setattr(ctypes, "CDLL", fake_cdll)
    monkeypatch.setattr(_build, "_libs", {})
    monkeypatch.setattr(_build, "_fns", {})
    got = []
    barrier = threading.Barrier(2)

    def first_launch():
        barrier.wait(timeout=30)
        got.append(_build.function("attention", "stk_attention", [ctypes.c_int]))

    threads = [threading.Thread(target=first_launch) for _ in range(2)]
    for t in threads:
        t.start()
    for t in threads:
        t.join(timeout=60)
    assert not any(t.is_alive() for t in threads)
    assert calls == {"build": 1, "cdll": 1}
    assert len(got) == 2 and got[0] is got[1]
    assert got[0].restype is ctypes.c_int and got[0].argtypes == [ctypes.c_int]
