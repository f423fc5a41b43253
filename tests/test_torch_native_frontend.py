"""The port's native C++ frontend (``frontend/native.py`` over its own copy of
the sources in ``supertonic_tpu_torch/native``) on the CPU: the library
built with make and g++ from the port's sources into a temporary build
directory, then its normalization, tokenization (ids and masks) and
chunking equal, character for character, to the port's Python frontend and
to the JAX package's native frontend on the corpora of
tests/test_native_frontend.py and seeded fuzz sets; the whole-batch call
under threads; the NUL and contract edges; ``TTS_NATIVE_FRONTEND=1`` in
``load_assets`` and ``chunk_text``; the fall-back to Python without a
toolchain; and the sanitizer build of the C++ test driver."""

import concurrent.futures
import ctypes
import os
import subprocess
import sys

import numpy as np
import pytest

from supertonic_tpu.frontend import native as jnative
from supertonic_tpu_torch.assets import load_assets
from supertonic_tpu_torch.frontend import UnicodeProcessor, build_default_indexer
from supertonic_tpu_torch.frontend import chunker, native, preprocess_text

from test_native_frontend import CHUNK_CORPUS, CORPUS

PORT_NATIVE = os.path.join(os.path.dirname(__file__), "..", "supertonic_tpu_torch", "native")


@pytest.fixture(scope="module", autouse=True)
def lib(tmp_path_factory):
    """The library built from the port's sources into a temporary
    directory, installed as the module's loaded library for every test."""
    out = tmp_path_factory.mktemp("native_build")
    path = native.build_native(out_dir=str(out))
    assert path == os.path.join(str(out), "libstpu_frontend.so") and os.path.exists(path)
    lib = ctypes.CDLL(path)
    native._bind(lib)
    with pytest.MonkeyPatch.context() as mp:
        mp.setattr(native, "_lib", lib)
        mp.delenv("TTS_NATIVE_FRONTEND", raising=False)
        yield lib


def test_built_from_the_ports_own_sources(lib, tmp_path):
    """The sources live in the port's tree, the build writes only to its
    output directory, and a failed build returns None."""
    for f in ("frontend.cpp", "gen_nfkd_table.py", "Makefile", "test_frontend.cpp"):
        assert os.path.exists(os.path.join(PORT_NATIVE, f))
    assert not os.path.exists(os.path.join(PORT_NATIVE, "libstpu_frontend.so"))
    assert not os.path.exists(os.path.join(PORT_NATIVE, "nfkd_table.h"))
    assert native.load_native() is lib
    blocked = tmp_path / "file"
    blocked.write_text("")  # an output "directory" that is a file: make fails
    assert native.build_native(out_dir=str(blocked / "sub")) is None


def test_preprocess_equals_python_and_jax_native():
    assert jnative.load_native() is not None
    for text, lang in CORPUS:
        want = preprocess_text(text, lang)
        assert native.native_preprocess(text, lang) == want, (text, lang)
        assert jnative.native_preprocess(text, lang) == want, (text, lang)
    with pytest.raises(ValueError):
        native.native_preprocess("hi", "de")


def test_ids_and_masks_equal_python_and_jax_native():
    idx = build_default_indexer()
    texts = [t for t, _ in CORPUS if t]
    langs = [g for t, g in CORPUS if t]
    ids_py, mask_py = UnicodeProcessor(idx)(texts, langs)
    ids_cc, mask_cc = native.NativeUnicodeProcessor(idx)(texts, langs)
    ids_j, mask_j = jnative.NativeUnicodeProcessor(idx)(texts, langs)
    for ids, mask in ((ids_cc, mask_cc), (ids_j, mask_j)):
        np.testing.assert_array_equal(ids, ids_py)
        np.testing.assert_array_equal(mask, mask_py)
    got, _ = native.NativeUnicodeProcessor(idx)(["Short."], ["en"], max_len=64)
    np.testing.assert_array_equal(got, UnicodeProcessor(idx)(["Short."], ["en"], max_len=64)[0])


def test_fuzz_preprocess_and_batch_ids():
    """Seeded random text through preprocessing, combining marks and the
    whole-batch call: the port's native equals its Python frontend."""
    rng = np.random.default_rng(0)
    pools = (list(range(0x20, 0x7F)) + list(range(0xA0, 0x100))
             + list(range(0xAC00, 0xAC80)) + list(range(0x2010, 0x2030))
             + [0x1F600, 0x1F680, 0x2764, 0x2026])
    for _ in range(50):
        text = "".join(chr(int(c)) for c in rng.choice(pools, int(rng.integers(1, 80))))
        assert native.native_preprocess(text, "en") == preprocess_text(text, "en"), text
    marks = [0x0300, 0x0301, 0x0308, 0x0304, 0x0323, 0x0327, 0x0331, 0x0345]
    base = list(range(0x61, 0x7B)) + [0xE9, 0xE7, 0x6E]
    for _ in range(50):
        text = "".join(chr(int(rng.choice(base))) + "".join(
            chr(int(rng.choice(marks))) for _ in range(int(rng.integers(0, 4))))
            for _ in range(int(rng.integers(1, 25))))
        assert native.native_preprocess(text, "fr") == preprocess_text(text, "fr"), text
    idx = build_default_indexer()
    py, cc = UnicodeProcessor(idx), native.NativeUnicodeProcessor(idx)
    langs5 = ["en", "ko", "es", "pt", "fr"]
    for _ in range(30):
        n = int(rng.integers(1, 9))
        texts = ["".join(chr(int(c)) for c in rng.choice(pools, int(rng.integers(1, 60))))
                 for _ in range(n)]
        langs = [str(rng.choice(langs5)) for _ in range(n)]
        for a, b in zip(py(texts, langs), cc(texts, langs)):
            np.testing.assert_array_equal(a, b, err_msg=repr(texts))


@pytest.mark.parametrize("max_len", [20, 40, 120, 300])
def test_chunks_equal_python_and_jax_native(max_len):
    for text in CHUNK_CORPUS:
        want = chunker._chunk_text_py(text, max_len)
        assert native.native_chunk_text(text, max_len) == want, text
        assert jnative.native_chunk_text(text, max_len) == want, text


def test_chunk_fuzz_and_comma_growth():
    rng = np.random.default_rng(21)
    words = ["alpha", "beta", "Dr.", "Mr.", "U.S.", "F.", "gamma,", "delta", "안녕", "café",
             "№", "x" * 35, "e.g.,", "—", "5", "ﬁn", "end."]
    seps = [" ", " ", " ", "  ", "\n", "\n\n", ". ", "! ", "? ", ", ", ".\n\n", "\t"]
    for _ in range(100):
        text = "".join(str(rng.choice(words)) + str(rng.choice(seps))
                       for _ in range(int(rng.integers(1, 60))))
        max_len = int(rng.choice([15, 30, 60, 120, 300]))
        assert native.native_chunk_text(text, max_len) == chunker._chunk_text_py(text, max_len)
    text = ",".join(str(i) for i in range(400)) + "."
    for max_len in (30, 120, 300):
        assert native.native_chunk_text(text, max_len) == chunker._chunk_text_py(text, max_len)


def test_batch_call_under_threads_and_contract_edges():
    idx = build_default_indexer()
    cc, py = native.NativeUnicodeProcessor(idx), UnicodeProcessor(idx)
    texts = ["Thread safety check sentence number %d." % i for i in range(16)]
    want = cc(texts, ["en"] * 16)

    def run(_):
        got = cc(texts, ["en"] * 16)
        return all(np.array_equal(a, b) for a, b in zip(got, want))

    with concurrent.futures.ThreadPoolExecutor(4) as pool:
        assert all(pool.map(run, range(32)))
    for texts, langs in ((["has a \x00 nul", "normal text"], ["en", "en"]),
                         (["a.", "b.", "c."], ["en", "en"])):
        for a, b in zip(py(texts, langs), cc(texts, langs)):
            np.testing.assert_array_equal(a, b)
    with pytest.raises(ValueError):
        cc(["a.", "b."], ["en\x00ko", "fr"])
    table = np.arange(7, 7 + 128, dtype=np.int64)  # out-of-table clamps to table[0]
    np.testing.assert_array_equal(native.NativeUnicodeProcessor(table).tokenize_text("a中"),
                                  UnicodeProcessor(table).tokenize("a中"))


def test_env_selects_the_native_frontend(monkeypatch):
    """TTS_NATIVE_FRONTEND=1: load_assets serves the native processor and
    chunk_text chunks natively (a NUL takes the Python path)."""
    assert isinstance(load_assets(None).processor, UnicodeProcessor)
    monkeypatch.setenv("TTS_NATIVE_FRONTEND", "1")
    proc = load_assets(None).processor
    assert isinstance(proc, native.NativeUnicodeProcessor)
    calls = []
    real = native.native_chunk_text
    monkeypatch.setattr(native, "native_chunk_text",
                        lambda *a: calls.append(a) or real(*a))
    text = "Dr. Smith spoke at length. " * 30
    assert chunker.chunk_text(text, 80) == chunker._chunk_text_py(text, 80)
    assert len(calls) == 1
    nul = "First sentence here. \x00 Second sentence after the nul byte."
    assert chunker.chunk_text(nul, 30) == chunker._chunk_text_py(nul, 30)
    assert len(calls) == 1


def test_falls_back_to_python_without_a_toolchain(monkeypatch):
    """Host code, not a device kernel: without a library the Python
    frontend serves, as in the JAX package."""
    monkeypatch.setattr(native, "_lib", None)
    monkeypatch.setattr(native, "_build_failed", False)
    monkeypatch.setattr(native, "build_native", lambda *a, **k: None)
    assert native.load_native() is None
    assert isinstance(native.best_processor(build_default_indexer()), UnicodeProcessor)
    monkeypatch.setenv("TTS_NATIVE_FRONTEND", "1")
    assert type(load_assets(None).processor) is UnicodeProcessor
    text = "One sentence. Two sentences here."
    assert chunker.chunk_text(text, 20) == chunker._chunk_text_py(text, 20)


def test_sanitized_build_of_the_test_driver(tmp_path):
    """The C++ test driver under ASan and UBSan (make sanitize), built into
    a temporary directory."""
    proc = subprocess.run(["make", "-C", PORT_NATIVE, "sanitize", f"OUT={tmp_path}",
                           f"PYTHON={sys.executable}"],
                          capture_output=True, text=True, timeout=300)
    assert proc.returncode == 0, proc.stdout + proc.stderr
    assert "NATIVE FRONTEND TESTS PASSED" in proc.stdout
