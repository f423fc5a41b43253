"""ctypes binding for the C++ text frontend, the counterpart of
``supertonic_tpu.frontend.native`` over the port's own copy of the sources
(``supertonic_tpu_torch/native``).

``NativeUnicodeProcessor`` is a drop-in replacement for the pure-Python
``UnicodeProcessor``; ``load_native()`` builds the shared library on first
use (make + g++, into ``supertonic_tpu_torch/build/native``) and returns
None when no toolchain is available, so callers can always fall back to
Python: this is host code, not a device kernel. Parity between the two
implementations is held by tests/test_torch_native_frontend.py.
"""

from __future__ import annotations

import ctypes
import os
import subprocess
import sys

import numpy as np

from .normalize import length_to_mask

_PKG_DIR = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
_NATIVE_DIR = os.path.join(_PKG_DIR, "native")
_BUILD_DIR = os.path.join(_PKG_DIR, "build", "native")
_LIB_NAME = "libstpu_frontend.so"
_LIB_PATH = os.path.join(_BUILD_DIR, _LIB_NAME)

_lib = None
_build_failed = False


def build_native(force: bool = False, out_dir: str | None = None) -> str | None:
    """Build libstpu_frontend.so from the port's sources with make into
    ``out_dir`` (default ``supertonic_tpu_torch/build/native``); returns
    its path, or None when the build fails or no toolchain exists."""
    global _build_failed
    out = os.path.abspath(out_dir or _BUILD_DIR)
    path = os.path.join(out, _LIB_NAME)
    if os.path.exists(path) and not force:
        return path
    try:
        subprocess.run(
            ["make", "-C", _NATIVE_DIR, f"OUT={out}", f"PYTHON={sys.executable}"]
            + (["-B"] if force else []),
            check=True, capture_output=True, timeout=300,
        )
        return path if os.path.exists(path) else None
    except (subprocess.CalledProcessError, subprocess.TimeoutExpired,
            FileNotFoundError):
        if out_dir is None:
            _build_failed = True
        return None


def _bind(lib) -> None:
    """Declare the C ABI (all entry points)."""
    lib.stpu_preprocess.restype = ctypes.c_int
    lib.stpu_preprocess.argtypes = [
        ctypes.c_char_p, ctypes.c_char_p, ctypes.c_char_p, ctypes.c_int,
    ]
    lib.stpu_tokenize.restype = ctypes.c_long
    lib.stpu_tokenize.argtypes = [
        ctypes.c_char_p,
        ctypes.POINTER(ctypes.c_longlong),
        ctypes.c_long,
        ctypes.POINTER(ctypes.c_longlong),
        ctypes.c_long,
    ]
    lib.stpu_chunk_text.restype = ctypes.c_long
    lib.stpu_chunk_text.argtypes = [
        ctypes.c_char_p,
        ctypes.c_long,
        ctypes.c_char_p,
        ctypes.c_long,
        ctypes.POINTER(ctypes.c_long),
        ctypes.c_long,
    ]
    lib.stpu_frontend_batch.restype = ctypes.c_long
    lib.stpu_frontend_batch.argtypes = [
        ctypes.c_char_p,
        ctypes.c_char_p,
        ctypes.c_long,
        ctypes.POINTER(ctypes.c_longlong),
        ctypes.c_long,
        ctypes.POINTER(ctypes.c_longlong),
        ctypes.c_long,
        ctypes.POINTER(ctypes.c_long),
    ]


# the newest required C entry point — a library missing it is a stale
# build from an earlier repo revision and gets rebuilt once
_NEWEST_SYMBOL = "stpu_frontend_batch"


def load_native():
    """Returns the loaded ctypes library, building if needed, else None."""
    global _lib, _build_failed
    if _lib is not None:
        return _lib
    if _build_failed:
        return None
    path = build_native()
    if path is None:
        return None
    lib = ctypes.CDLL(path)
    if not hasattr(lib, _NEWEST_SYMBOL):  # stale .so: rebuild once
        if build_native(force=True) is None:
            _build_failed = True
            return None
        lib = ctypes.CDLL(_LIB_PATH)
        if not hasattr(lib, _NEWEST_SYMBOL):
            # dlopen dedups by pathname, so the stale mapping can survive
            # the rebuild within this process — degrade to the Python
            # fallback instead of raising AttributeError out of load_native
            # (a fresh process picks up the rebuilt library)
            _build_failed = True
            return None
    _bind(lib)
    _lib = lib
    return lib


def native_preprocess(text: str, lang: str) -> str:
    lib = load_native()
    if lib is None:
        raise RuntimeError("native frontend unavailable")
    raw = text.encode("utf-8")
    cap = 4 * len(raw) + 64
    for _attempt in range(3):  # NFKD can expand one codepoint up to 18x
        buf = ctypes.create_string_buffer(cap)
        n = lib.stpu_preprocess(raw, lang.encode(), buf, cap)
        if n != -2:
            break
        cap *= 4
    if n == -1:
        raise ValueError(f"Invalid language: {lang}")
    if n < 0:
        raise RuntimeError(f"native preprocess error {n}")
    return buf.raw[:n].decode("utf-8")


def native_chunk_text(text: str, max_len: int = 300) -> list[str]:
    """Long-form chunking in C++ (char-exact twin of chunker.chunk_text;
    the reference's C++ port also chunks natively, cpp/helper.cpp:1117).
    Raises RuntimeError when the native library is unavailable."""
    lib = load_native()
    if lib is None:
        raise RuntimeError("native frontend unavailable")
    raw = text.encode("utf-8")
    # packing may INSERT a space per piece (comma fallback splits "a,b"
    # with no whitespace to consume), so output can exceed the input; one
    # inserted space per >=1-char piece bounds it at 2x + slack
    out_cap = 2 * len(raw) + 64
    # worst case one chunk per codepoint (pathological max_len=1 inputs)
    off_cap = len(text) + 2
    out = ctypes.create_string_buffer(out_cap)
    offsets = (ctypes.c_long * off_cap)()
    n = lib.stpu_chunk_text(raw, max_len, out, out_cap, offsets, off_cap)
    if n < 0:
        raise RuntimeError(f"native chunk_text error {n}")
    data = out.raw
    return [data[offsets[k]: offsets[k + 1]].decode("utf-8")
            for k in range(n)]


class NativeUnicodeProcessor:
    """Same call contract as frontend.normalize.UnicodeProcessor, backed by
    the C++ library (normalization AND tokenization run native)."""

    def __init__(self, indexer):
        if load_native() is None:
            raise RuntimeError("native frontend unavailable")
        self.indexer = np.ascontiguousarray(np.asarray(indexer, np.int64))
        self._indexer_ptr = self.indexer.ctypes.data_as(
            ctypes.POINTER(ctypes.c_longlong)
        )

    def _rows(self, text_list, lang_list):
        """All rows' token ids in ONE native call (preprocess + tokenize
        fused): per-utterance ctypes calls are so fine-grained that the
        GIL-held Python overhead around them dominates — threaded feeders
        measured 0.32x scaling at 4 threads. The whole-batch call keeps
        the GIL released for essentially all of the work."""
        # mirror UnicodeProcessor's zip semantics (extra rows truncated)
        n_rows = min(len(text_list), len(lang_list))
        text_list = list(text_list[:n_rows])
        lang_list = list(lang_list[:n_rows])
        if any("\x00" in t for t in text_list) or any(
                "\x00" in g for g in lang_list):
            # NUL can't cross the C string boundary at all (every native
            # entry point truncates there) — use the pure-Python frontend
            # for these rare rows; char-exact by definition
            from .normalize import UnicodeProcessor, preprocess_text

            py = UnicodeProcessor(self.indexer)
            rows = [py.tokenize(preprocess_text(t, g))
                    for t, g in zip(text_list, lang_list)]
            return rows, np.array([len(r) for r in rows], np.int64)
        lib = load_native()
        n = len(text_list)
        texts_blob = b"\x00".join(t.encode("utf-8") for t in text_list) \
            + b"\x00"
        langs_blob = b"\x00".join(g.encode() for g in lang_list) + b"\x00"
        # preprocessing can expand text (e.g. "e.g.," -> "for example, ",
        # "@" -> " at ") plus lang tags; 4x codepoints + slack bounds the
        # common case, but NFKD can expand a single codepoint up to 18x
        # (U+FDFA) — retry twice (up to 64x), then fall back to the
        # pure-Python frontend rather than failing the request
        cap = 4 * sum(len(t) for t in text_list) + 32 * n + 64
        for _attempt in range(3):
            ids = np.empty(cap, np.int64)
            lens = (ctypes.c_long * n)()
            total = lib.stpu_frontend_batch(
                texts_blob, langs_blob, n,
                self._indexer_ptr, len(self.indexer),
                ids.ctypes.data_as(ctypes.POINTER(ctypes.c_longlong)),
                cap, lens)
            if total != -2:
                break
            cap *= 4
        if total == -2:
            from .normalize import UnicodeProcessor, preprocess_text

            py = UnicodeProcessor(self.indexer)
            rows = [py.tokenize(preprocess_text(t, g))
                    for t, g in zip(text_list, lang_list)]
            return rows, np.array([len(r) for r in rows], np.int64)
        if total == -1:
            from ..config import AVAILABLE_LANGS

            bad = [g for g in lang_list if g not in AVAILABLE_LANGS]
            raise ValueError(f"Invalid language: {bad[0] if bad else '?'}")
        if total < 0:
            raise RuntimeError(f"native frontend batch error {total}")
        lengths = np.array(list(lens), np.int64)
        offs = np.concatenate([[0], np.cumsum(lengths)])
        rows = [ids[offs[i]: offs[i + 1]] for i in range(n)]
        return rows, lengths

    def tokenize_text(self, text: str) -> np.ndarray:
        lib = load_native()
        raw = text.encode("utf-8")
        cap = len(text) + 8
        out = np.empty(cap, np.int64)
        n = lib.stpu_tokenize(
            raw, self._indexer_ptr, len(self.indexer),
            out.ctypes.data_as(ctypes.POINTER(ctypes.c_longlong)), cap,
        )
        if n < 0:
            raise RuntimeError(f"native tokenize error {n}")
        return out[:n]

    def __call__(
        self,
        text_list: list[str],
        lang_list: list[str],
        max_len: int | None = None,
        pre_normalized: bool = False,
    ) -> tuple[np.ndarray, np.ndarray]:
        if pre_normalized:
            # texts already went through preprocess_text (NOT idempotent —
            # lang tags would wrap twice): tokenize-only path
            n_rows = min(len(text_list), len(lang_list))
            token_rows = []
            for t in text_list[:n_rows]:
                if "\x00" in t:  # NUL can't cross the C string boundary
                    cps = np.array([ord(c) for c in t], np.int64)
                    cps = np.where(
                        (cps >= 0) & (cps < len(self.indexer)), cps, 0)
                    token_rows.append(self.indexer[cps])
                else:
                    token_rows.append(self.tokenize_text(t))
            lengths = np.array([len(r) for r in token_rows], np.int64)
        else:
            token_rows, lengths = self._rows(text_list, lang_list)
        pad_to = int(max_len if max_len is not None else lengths.max())
        if pad_to < int(lengths.max()):
            raise ValueError(
                f"max_len={pad_to} is smaller than longest text {int(lengths.max())}"
            )
        ids = np.zeros((len(token_rows), pad_to), dtype=np.int64)
        for i, row in enumerate(token_rows):
            ids[i, : len(row)] = row
        return ids, length_to_mask(lengths, pad_to)


def best_processor(indexer):
    """Native processor when buildable, else the Python one."""
    try:
        return NativeUnicodeProcessor(indexer)
    except RuntimeError:
        from .normalize import UnicodeProcessor

        return UnicodeProcessor(indexer)
