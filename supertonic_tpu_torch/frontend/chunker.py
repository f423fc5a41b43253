"""Long-form text chunking.

Behavior of reference ``chunk_text`` (py/helper.py:388-429): paragraphs split
on blank lines, sentences split on ``[.!?]\\s+`` guarded by an
abbreviation/initial list, greedy re-pack into <= max_len chunks. We adopt the
Rust port's two extra fallback levels for oversized sentences — split by comma
then by word (reference rust/src/helper.rs:330-450) — which the Python port
lacks (an unchunkable 400-char sentence would blow the length budget there).

max_len policy: 120 for Korean, 300 otherwise (reference py/helper.py:229).
"""

from __future__ import annotations

import re

_ABBREVIATIONS = (
    "Mr.", "Mrs.", "Ms.", "Dr.", "Prof.", "Sr.", "Jr.", "Ph.D.", "etc.",
    "e.g.", "i.e.", "vs.", "Inc.", "Ltd.", "Co.", "Corp.", "St.", "Ave.",
    "Blvd.",
)

_PARA_SPLIT = re.compile(r"\n\s*\n+")
_SENT_END = re.compile(r"[.!?]\s")


def max_len_for_lang(lang: str) -> int:
    return 120 if lang == "ko" else 300


def _ends_with_abbreviation(prefix: str) -> bool:
    """True if ``prefix`` (text up to and including a period) ends in a known
    abbreviation or a single-capital initial like ``F.`` (the reference's
    lookbehind list, py/helper.py:413; procedural form per
    rust/src/helper.rs:452-497)."""
    for abbr in _ABBREVIATIONS:
        if prefix.endswith(abbr):
            return True
    # single capital initial with a word boundary before it, matching the
    # reference's (?<!\b[A-Z]\.) lookbehind exactly: A-Z only (not any
    # uppercase), and a preceding '.' IS a boundary ('U.S. Government' must
    # not split mid-acronym)
    if len(prefix) >= 2 and "A" <= prefix[-2] <= "Z":
        if len(prefix) == 2 or not (prefix[-3].isalnum() or prefix[-3] == "_"):
            return True
    return False


def split_sentences(paragraph: str) -> list[str]:
    """Sentence segmentation with abbreviation guards."""
    sentences: list[str] = []
    start = 0
    i = 0
    n = len(paragraph)
    while i < n:
        ch = paragraph[i]
        if ch in ".!?" and i + 1 < n and paragraph[i + 1].isspace():
            if ch != "." or not _ends_with_abbreviation(paragraph[start : i + 1]):
                sentences.append(paragraph[start : i + 1].strip())
                i += 1
                while i < n and paragraph[i].isspace():
                    i += 1
                start = i
                continue
        i += 1
    tail = paragraph[start:].strip()
    if tail:
        sentences.append(tail)
    return [s for s in sentences if s]


def _split_oversized(sentence: str, max_len: int) -> list[str]:
    """Comma- then word-level fallback for a sentence longer than max_len
    (reference rust/src/helper.rs:330-450). Delimiters stay attached to the
    preceding segment so packed chunks never exceed max_len (unless a single
    word does)."""
    if len(sentence) <= max_len:
        return [sentence]
    # level 1: comma segments, trailing comma kept on each segment
    segments = [s for s in re.split(r"(?<=,)\s*", sentence) if s]
    pieces: list[str] = []
    for seg in segments:
        if len(seg) <= max_len:
            pieces.append(seg)
        else:
            pieces.extend(seg.split())  # level 2: words
    parts: list[str] = []
    current = ""
    for piece in pieces:
        candidate = f"{current} {piece}" if current else piece
        if len(candidate) <= max_len:
            current = candidate
        else:
            if current:
                parts.append(current)
            current = piece
    if current:
        parts.append(current)
    return parts or [sentence]


def chunk_text(text: str, max_len: int = 300) -> list[str]:
    """Split ``text`` into synthesis chunks of at most ``max_len`` chars.

    With TTS_NATIVE_FRONTEND=1 the C++ twin chunks it (the same opt-in as
    the native normalizer in assets.load_assets), falling back to the
    Python implementation when the library is unavailable."""
    import os

    if os.getenv("TTS_NATIVE_FRONTEND", "0") != "0" and "\x00" not in text:
        # a NUL would truncate the C string: such texts take the Python path
        try:
            from .native import native_chunk_text

            return native_chunk_text(text, max_len)
        except RuntimeError:
            pass  # no toolchain: the Python implementation below
    return _chunk_text_py(text, max_len)


def _chunk_text_py(text: str, max_len: int = 300) -> list[str]:
    chunks: list[str] = []
    for paragraph in _PARA_SPLIT.split(text.strip()):
        paragraph = paragraph.strip()
        if not paragraph:
            continue
        current = ""
        for sentence in split_sentences(paragraph):
            for piece in _split_oversized(sentence, max_len):
                if len(current) + len(piece) + 1 <= max_len:
                    current = f"{current} {piece}" if current else piece
                else:
                    if current:
                        chunks.append(current.strip())
                    current = piece
        if current:
            chunks.append(current.strip())
    return chunks
