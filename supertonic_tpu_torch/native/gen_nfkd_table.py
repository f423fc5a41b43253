"""Generate nfkd_table.h from Python's unicodedata.

Guarantees the C++ frontend's NFKD agrees with the Python frontend (which
uses unicodedata directly, matching reference py/helper.py:23). The reference
native ports hand-roll this with a 50-entry accent table + Hangul algorithm
(cpp/helper.cpp:202-300); generating the full table from the same Unicode
database the Python side uses is strictly more faithful.

Coverage is the FULL codepoint space (every codepoint whose NFKD form
differs from itself, ~5.9k entries) — selected ranges proved insufficient:
texts quoting Cyrillic (й, ё), polytonic Greek, or Kana decomposed on the
Python side but not in C++, breaking the character-exact guarantee.
Hangul syllables (0xAC00-0xD7A3) are decomposed algorithmically in C++ and
deliberately excluded here (11 k entries for a 3-line algorithm).
"""

import sys
import unicodedata

HANGUL_SYLLABLES = (0xAC00, 0xD7A3)


def _ranges(pred) -> list[tuple[int, int]]:
    """[lo, hi) intervals over the full codepoint space where pred holds."""
    out: list[tuple[int, int]] = []
    start = None
    for cp in range(0x110000):
        if pred(chr(cp)):
            if start is None:
                start = cp
        elif start is not None:
            out.append((start, cp))
            start = None
    if start is not None:
        out.append((start, 0x110000))
    return out


def main(out_path: str) -> None:
    entries = []
    for cp in range(0x110000):
        if HANGUL_SYLLABLES[0] <= cp <= HANGUL_SYLLABLES[1]:
            continue
        ch = chr(cp)
        dec = unicodedata.normalize("NFKD", ch)
        if dec != ch:
            entries.append((cp, dec))
    # canonical combining classes: needed for the post-decomposition
    # canonical-ordering pass (unicodedata.normalize sorts adjacent nonzero-
    # ccc marks; without this the C++ twin diverges on stacked diacritics)
    ccc_entries = [
        (cp, unicodedata.combining(chr(cp)))
        for cp in range(0x110000)
        if unicodedata.combining(chr(cp))
    ]
    with open(out_path, "w") as f:
        f.write("// Auto-generated by gen_nfkd_table.py — do not edit.\n")
        f.write("#pragma once\n#include <cstdint>\n\n")
        f.write("struct NfkdEntry { uint32_t cp; const char32_t* dec; };\n")
        f.write("static const NfkdEntry kNfkdTable[] = {\n")
        for cp, dec in entries:
            lit = "".join(f"\\U{ord(c):08X}" for c in dec)
            f.write(f'  {{0x{cp:04X}, U"{lit}"}},\n')
        f.write("};\n")
        f.write(
            f"static const int kNfkdTableSize = {len(entries)};\n\n"
        )
        f.write("struct CccEntry { uint32_t cp; uint8_t ccc; };\n")
        f.write("static const CccEntry kCccTable[] = {\n")
        for cp, ccc in ccc_entries:
            f.write(f"  {{0x{cp:05X}, {ccc}}},\n")
        f.write("};\n")
        f.write(f"static const int kCccTableSize = {len(ccc_entries)};\n\n")
        # str.isspace / str.isalnum interval tables: the native chunker
        # (frontend.cpp ChunkText) must agree with Python's chunker to the
        # character, and the Python chunker uses str.isspace/.isalnum —
        # generating the predicates from the SAME interpreter guarantees it
        space_ranges = _ranges(str.isspace)
        alnum_ranges = _ranges(str.isalnum)
        f.write("struct CpRange { uint32_t lo; uint32_t hi; };  // [lo, hi)\n")
        for name, ranges in (("kSpaceRanges", space_ranges),
                             ("kAlnumRanges", alnum_ranges)):
            f.write(f"static const CpRange {name}[] = {{\n")
            for lo, hi in ranges:
                f.write(f"  {{0x{lo:05X}, 0x{hi:05X}}},\n")
            f.write("};\n")
            f.write(f"static const int {name}Size = {len(ranges)};\n")
    print(f"wrote {len(entries)} NFKD + {len(ccc_entries)} ccc entries + "
          f"{len(space_ranges)} space + {len(alnum_ranges)} alnum ranges "
          f"-> {out_path}")


if __name__ == "__main__":
    main(sys.argv[1] if len(sys.argv) > 1 else "nfkd_table.h")
