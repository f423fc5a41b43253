"""Text frontend: normalization, tokenization, masks.

Character-exact re-implementation of the reference ``UnicodeProcessor``
(reference py/helper.py:16-131):

  1. NFKD Unicode normalization                       (py/helper.py:23)
  2. Emoji stripping across 13 Unicode blocks         (py/helper.py:26-41)
  3. Symbol replacement table (17 entries)            (py/helper.py:44-62)
  4. Special-symbol removal                           (py/helper.py:67)
  5. Expression expansion (@ / e.g., / i.e.,)         (py/helper.py:70-76)
  6. Punctuation spacing fixes + quote collapse       (py/helper.py:79-93)
  7. Whitespace collapse                              (py/helper.py:96)
  8. Terminal punctuation guarantee                   (py/helper.py:99-100)
  9. Language tag wrap <xx>...</xx>                   (py/helper.py:102-104)
 10. Per-codepoint tokenization via unicode indexer   (py/helper.py:111-129)

The host-side work is pure Python/numpy (it never touches the device).
This is a copy of the JAX package's framework-free frontend, so that the
PyTorch port never imports that package; ``tests/test_torch_frontend.py``
holds the two against each other.
"""

from __future__ import annotations

import re
from unicodedata import normalize as _unicodedata_normalize

import numpy as np

from ..config import AVAILABLE_LANGS

_EMOJI_PATTERN = re.compile(
    "[\U0001f600-\U0001f64f"
    "\U0001f300-\U0001f5ff"
    "\U0001f680-\U0001f6ff"
    "\U0001f700-\U0001f77f"
    "\U0001f780-\U0001f7ff"
    "\U0001f800-\U0001f8ff"
    "\U0001f900-\U0001f9ff"
    "\U0001fa00-\U0001fa6f"
    "\U0001fa70-\U0001faff"
    "☀-⛿"
    "✀-➿"
    "\U0001f1e6-\U0001f1ff]+",
    flags=re.UNICODE,
)

_REPLACEMENTS = (
    ("–", "-"),   # en dash
    ("‑", "-"),   # non-breaking hyphen
    ("—", "-"),   # em dash
    ("_", " "),
    ("“", '"'),
    ("”", '"'),
    ("‘", "'"),
    ("’", "'"),
    ("´", "'"),
    ("`", "'"),
    ("[", " "),
    ("]", " "),
    ("|", " "),
    ("/", " "),
    ("#", " "),
    ("→", " "),   # →
    ("←", " "),   # ←
)

_SPECIAL_REMOVE = re.compile(r"[♥☆♡©\\]")  # ♥☆♡©\

_EXPR_REPLACEMENTS = (
    ("@", " at "),
    ("e.g.,", "for example, "),
    ("i.e.,", "that is, "),
)

_SPACING_FIXES = (
    (re.compile(r" ,"), ","),
    (re.compile(r" \."), "."),
    (re.compile(r" !"), "!"),
    (re.compile(r" \?"), "?"),
    (re.compile(r" ;"), ";"),
    (re.compile(r" :"), ":"),
    (re.compile(r" '"), "'"),
)

_WS = re.compile(r"\s+")

_TERMINAL = re.compile(
    "[.!?;:,'\"')\\]}"
    "…。」』】〉》›»]$"
)


def preprocess_text(text: str, lang: str) -> str:
    """Normalize one utterance and wrap it in language tags.

    Exact semantics of reference py/helper.py:21-105 (including operation
    order — NFKD first, emoji strip second, etc.).
    """
    text = _unicodedata_normalize("NFKD", text)
    text = _EMOJI_PATTERN.sub("", text)
    for k, v in _REPLACEMENTS:
        text = text.replace(k, v)
    text = _SPECIAL_REMOVE.sub("", text)
    for k, v in _EXPR_REPLACEMENTS:
        text = text.replace(k, v)
    for pat, rep in _SPACING_FIXES:
        text = pat.sub(rep, text)
    while '""' in text:
        text = text.replace('""', '"')
    while "''" in text:
        text = text.replace("''", "'")
    while "``" in text:
        text = text.replace("``", "`")
    text = _WS.sub(" ", text).strip()
    if not _TERMINAL.search(text):
        text += "."
    if lang not in AVAILABLE_LANGS:
        raise ValueError(f"Invalid language: {lang}")
    return f"<{lang}>{text}</{lang}>"


def length_to_mask(lengths: np.ndarray, max_len: int | None = None) -> np.ndarray:
    """lengths [B] -> mask [B, 1, max_len] float32 (reference py/helper.py:257-271)."""
    lengths = np.asarray(lengths)
    max_len = int(max_len if max_len is not None else lengths.max())
    ids = np.arange(max_len)
    mask = (ids[None, :] < lengths[:, None]).astype(np.float32)
    return mask.reshape(-1, 1, max_len)


def get_latent_mask(
    wav_lengths: np.ndarray,
    base_chunk_size: int,
    chunk_compress_factor: int,
    max_len: int | None = None,
) -> np.ndarray:
    """Per-sample latent frame mask (reference py/helper.py:274-280)."""
    latent_size = base_chunk_size * chunk_compress_factor
    latent_lengths = (np.asarray(wav_lengths) + latent_size - 1) // latent_size
    return length_to_mask(latent_lengths, max_len)


class UnicodeProcessor:
    """Codepoint → token-id lookup + batching, reference py/helper.py:16-131.

    ``indexer`` is a dense int array indexed by codepoint value (the format of
    the reference's ``unicode_indexer.json``). Codepoints beyond the table map
    to 0 (pad) — the reference's uint16 cast (py/helper.py:113) silently wraps
    instead; we deliberately clamp because wrapping is a bug, not a feature.
    """

    def __init__(self, indexer):
        self.indexer = np.asarray(indexer, dtype=np.int64)

    def tokenize(self, text: str) -> np.ndarray:
        cps = np.array([ord(c) for c in text], dtype=np.int64)
        cps = np.where((cps >= 0) & (cps < len(self.indexer)), cps, 0)
        return self.indexer[cps]

    def __call__(
        self,
        text_list: list[str],
        lang_list: list[str],
        max_len: int | None = None,
        pre_normalized: bool = False,
    ) -> tuple[np.ndarray, np.ndarray]:
        """Returns (text_ids [B, L] int64, text_mask [B, 1, L] float32).

        ``max_len`` pads to a bucketed length (TPU shape discipline); ``None``
        reproduces the reference's pad-to-batch-max behavior.
        ``pre_normalized``: the texts already went through preprocess_text
        (normalization is NOT idempotent — lang tags would wrap twice);
        callers that normalize for bucketing (the continuous batcher) pass
        the result through instead of paying the pipeline again.
        """
        if pre_normalized:
            texts = list(text_list[: len(lang_list)])
        else:
            texts = [preprocess_text(t, g)
                     for t, g in zip(text_list, lang_list)]
        lengths = np.array([len(t) for t in texts], dtype=np.int64)
        pad_to = int(max_len if max_len is not None else lengths.max())
        if pad_to < int(lengths.max()):
            raise ValueError(
                f"max_len={pad_to} is smaller than longest text {int(lengths.max())}"
            )
        ids = np.zeros((len(texts), pad_to), dtype=np.int64)
        for i, t in enumerate(texts):
            ids[i, : lengths[i]] = self.tokenize(t)
        return ids, length_to_mask(lengths, pad_to)


# ---------------------------------------------------------------------------
# Default indexer (used when the reference's unicode_indexer.json asset is
# unavailable). Deterministic dense table over the BMP covering every script
# the 5 supported languages can produce AFTER NFKD: ASCII, combining marks,
# Latin extras, Hangul Jamo + precomposed syllables, common punctuation.
# ---------------------------------------------------------------------------

_DEFAULT_RANGES = (
    (0x0020, 0x007F),  # ASCII printable
    (0x00A0, 0x0100),  # Latin-1 supplement
    (0x0300, 0x0370),  # combining diacritics (NFKD output for es/pt/fr)
    (0x1100, 0x1200),  # Hangul Jamo (NFKD output for ko)
    (0x2000, 0x2070),  # general punctuation
    (0x20A0, 0x20C0),  # currency
    (0x3000, 0x3040),  # CJK punctuation
    (0xAC00, 0xD7A4),  # precomposed Hangul syllables (pre-NFKD input)
)


def build_default_indexer(table_size: int = 0xD7A4, vocab_cap: int = 2048) -> np.ndarray:
    """Dense codepoint→id table; ids assigned in codepoint order, folded into
    ``vocab_cap`` for ranges that exceed it (Hangul syllables hash onto their
    leading-Jamo bucket, which NFKD makes nearly moot)."""
    table = np.zeros(table_size, dtype=np.int64)
    next_id = 1  # 0 is pad
    for lo, hi in _DEFAULT_RANGES:
        hi = min(hi, table_size)
        for cp in range(lo, hi):
            if next_id < vocab_cap:
                table[cp] = next_id
                next_id += 1
            else:
                table[cp] = 1 + (cp % (vocab_cap - 1))
    return table
