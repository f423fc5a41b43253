// Native text frontend for supertonic_tpu_torch (a copy of the JAX
// package's supertonic_tpu/native/frontend.cpp).
//
// Character-exact C++17 twin of the Python frontend
// (supertonic_tpu_torch/frontend/normalize.py, itself matching reference
// py/helper.py:16-131). This is the one truly native compute component of
// the reference outside ONNX Runtime (SURVEY.md §2.1: hand NFKD in
// cpp/helper.cpp:202-347) — here it exists so per-host feeders can
// normalize/tokenize at pod scale without the Python GIL.
//
// NFKD: generated table (nfkd_table.h, from Python's own unicodedata via
// gen_nfkd_table.py) + algorithmic Hangul decomposition (SBase 0xAC00,
// LBase 0x1100, VBase 0x1161, TBase 0x11A7 — same constants the reference
// uses, cpp/helper.cpp:202-211).
//
// Build: make -C supertonic_tpu_torch/native   (produces
// supertonic_tpu_torch/build/native/libstpu_frontend.so; OUT=<dir> elsewhere)
// API (C ABI, ctypes-friendly):
//   int stpu_preprocess(const char* utf8, const char* lang,
//                       char* out, int out_cap);
//     -> bytes written, -1 invalid lang, -2 out_cap too small
//   long stpu_tokenize(const char* utf8, const long long* indexer,
//                      long table_len, long long* out_ids, long cap);
//     -> token count (one per codepoint), -2 cap too small

#include <cstdint>
#include <cstring>
#include <string>
#include <vector>

#include "nfkd_table.h"

namespace {

using std::u32string;

// ---------------------------------------------------------------- UTF-8 ---
u32string DecodeUtf8(const char* s) {
  u32string out;
  const unsigned char* p = reinterpret_cast<const unsigned char*>(s);
  while (*p) {
    uint32_t cp = 0;
    int extra = 0;
    if (*p < 0x80) {
      cp = *p;
    } else if ((*p >> 5) == 0x6) {
      cp = *p & 0x1F;
      extra = 1;
    } else if ((*p >> 4) == 0xE) {
      cp = *p & 0x0F;
      extra = 2;
    } else if ((*p >> 3) == 0x1E) {
      cp = *p & 0x07;
      extra = 3;
    } else {  // invalid byte: skip
      ++p;
      continue;
    }
    ++p;
    bool ok = true;
    for (int i = 0; i < extra; ++i, ++p) {
      if ((*p & 0xC0) != 0x80) {
        ok = false;
        break;
      }
      cp = (cp << 6) | (*p & 0x3F);
    }
    if (ok) out.push_back(cp);
  }
  return out;
}

void EncodeUtf8(const u32string& in, std::string* out) {
  out->clear();
  for (uint32_t cp : in) {
    if (cp < 0x80) {
      out->push_back(static_cast<char>(cp));
    } else if (cp < 0x800) {
      out->push_back(static_cast<char>(0xC0 | (cp >> 6)));
      out->push_back(static_cast<char>(0x80 | (cp & 0x3F)));
    } else if (cp < 0x10000) {
      out->push_back(static_cast<char>(0xE0 | (cp >> 12)));
      out->push_back(static_cast<char>(0x80 | ((cp >> 6) & 0x3F)));
      out->push_back(static_cast<char>(0x80 | (cp & 0x3F)));
    } else {
      out->push_back(static_cast<char>(0xF0 | (cp >> 18)));
      out->push_back(static_cast<char>(0x80 | ((cp >> 12) & 0x3F)));
      out->push_back(static_cast<char>(0x80 | ((cp >> 6) & 0x3F)));
      out->push_back(static_cast<char>(0x80 | (cp & 0x3F)));
    }
  }
}

// ----------------------------------------------------------------- NFKD ---
const char32_t* LookupNfkd(uint32_t cp) {
  int lo = 0, hi = kNfkdTableSize - 1;
  while (lo <= hi) {
    int mid = (lo + hi) / 2;
    if (kNfkdTable[mid].cp == cp) return kNfkdTable[mid].dec;
    if (kNfkdTable[mid].cp < cp)
      lo = mid + 1;
    else
      hi = mid - 1;
  }
  return nullptr;
}

void AppendNfkd(uint32_t cp, u32string* out) {
  // Hangul syllable: algorithmic decomposition to Jamo.
  constexpr uint32_t SBase = 0xAC00, LBase = 0x1100, VBase = 0x1161,
                     TBase = 0x11A7;
  constexpr uint32_t VCount = 21, TCount = 28, SCount = 11172;
  if (cp >= SBase && cp < SBase + SCount) {
    uint32_t idx = cp - SBase;
    out->push_back(LBase + idx / (VCount * TCount));
    out->push_back(VBase + (idx % (VCount * TCount)) / TCount);
    uint32_t t = idx % TCount;
    if (t) out->push_back(TBase + t);
    return;
  }
  if (const char32_t* dec = LookupNfkd(cp)) {
    for (const char32_t* p = dec; *p; ++p) out->push_back(*p);
    return;
  }
  out->push_back(cp);
}

uint8_t Ccc(uint32_t cp) {
  int lo = 0, hi = kCccTableSize - 1;
  while (lo <= hi) {
    int mid = (lo + hi) / 2;
    if (kCccTable[mid].cp == cp) return kCccTable[mid].ccc;
    if (kCccTable[mid].cp < cp)
      lo = mid + 1;
    else
      hi = mid - 1;
  }
  return 0;
}

// Canonical ordering (UAX #15): stable-sort adjacent nonzero-ccc marks by
// combining class. Python's unicodedata.normalize does this after
// decomposition; without it, stacked diacritics (possible in es/pt/fr
// input) tokenize differently here than in the Python frontend.
void CanonicalOrder(u32string* s) {
  size_t i = 1;
  while (i < s->size()) {
    uint8_t c = Ccc((*s)[i]);
    if (c != 0) {
      uint8_t prev = Ccc((*s)[i - 1]);
      if (prev > c) {
        std::swap((*s)[i - 1], (*s)[i]);
        if (i > 1) {
          --i;
          continue;
        }
      }
    }
    ++i;
  }
}

u32string Nfkd(const u32string& in) {
  u32string out;
  out.reserve(in.size() + 8);
  for (uint32_t cp : in) AppendNfkd(cp, &out);
  CanonicalOrder(&out);
  return out;
}

// -------------------------------------------------------------- helpers ---
bool IsEmoji(uint32_t cp) {
  // exact ranges of the reference emoji regex (py/helper.py:26-41)
  return (cp >= 0x1F600 && cp <= 0x1F64F) || (cp >= 0x1F300 && cp <= 0x1F5FF) ||
         (cp >= 0x1F680 && cp <= 0x1F6FF) || (cp >= 0x1F700 && cp <= 0x1F77F) ||
         (cp >= 0x1F780 && cp <= 0x1F7FF) || (cp >= 0x1F800 && cp <= 0x1F8FF) ||
         (cp >= 0x1F900 && cp <= 0x1F9FF) || (cp >= 0x1FA00 && cp <= 0x1FA6F) ||
         (cp >= 0x1FA70 && cp <= 0x1FAFF) || (cp >= 0x2600 && cp <= 0x26FF) ||
         (cp >= 0x2700 && cp <= 0x27BF) || (cp >= 0x1F1E6 && cp <= 0x1F1FF);
}

bool IsSpace(uint32_t cp) {
  // Python str \s on post-NFKD text (most exotic spaces already folded to
  // U+0020 by NFKD): ASCII whitespace + NEL + remaining unicode spaces.
  return cp == ' ' || cp == '\t' || cp == '\n' || cp == '\r' || cp == '\f' ||
         cp == '\v' || cp == 0x85 || cp == 0x1C || cp == 0x1D || cp == 0x1E ||
         cp == 0x1F || cp == 0x1680 || cp == 0x2028 || cp == 0x2029;
}

void ReplaceAll(u32string* s, const u32string& from, const u32string& to) {
  size_t pos = 0;
  while ((pos = s->find(from, pos)) != u32string::npos) {
    s->replace(pos, from.size(), to);
    pos += to.size();
  }
}

bool EndsWithTerminal(const u32string& s) {
  if (s.empty()) return false;
  static const u32string kTerminal =
      U".!?;:,'\")]}…。」』】〉》›»";
  return kTerminal.find(s.back()) != u32string::npos;
}

u32string Preprocess(const u32string& input, const std::string& lang) {
  // 1. NFKD (py/helper.py:23)
  u32string text = Nfkd(input);

  // 2. emoji strip (py/helper.py:26-41)
  {
    u32string tmp;
    tmp.reserve(text.size());
    for (uint32_t cp : text)
      if (!IsEmoji(cp)) tmp.push_back(cp);
    text.swap(tmp);
  }

  // 3. symbol replacements, in the reference's table order (py/helper.py:44-62)
  struct Rep {
    char32_t from;
    const char32_t* to;
  };
  static const Rep kReps[] = {
      {0x2013, U"-"}, {0x2011, U"-"}, {0x2014, U"-"}, {U'_', U" "},
      {0x201C, U"\""}, {0x201D, U"\""}, {0x2018, U"'"}, {0x2019, U"'"},
      {0x00B4, U"'"}, {U'`', U"'"}, {U'[', U" "}, {U']', U" "},
      {U'|', U" "}, {U'/', U" "}, {U'#', U" "}, {0x2192, U" "},
      {0x2190, U" "},
  };
  for (const auto& r : kReps)
    ReplaceAll(&text, u32string(1, r.from), r.to);

  // 4. special-symbol removal ♥☆♡©\ (py/helper.py:67)
  {
    u32string tmp;
    tmp.reserve(text.size());
    for (uint32_t cp : text)
      if (cp != 0x2665 && cp != 0x2606 && cp != 0x2661 && cp != 0x00A9 &&
          cp != U'\\')
        tmp.push_back(cp);
    text.swap(tmp);
  }

  // 5. expression expansion (py/helper.py:70-76)
  ReplaceAll(&text, U"@", U" at ");
  ReplaceAll(&text, U"e.g.,", U"for example, ");
  ReplaceAll(&text, U"i.e.,", U"that is, ");

  // 6. spacing fixes — single left-to-right pass per pattern, matching
  //    re.sub semantics (py/helper.py:79-85)
  for (char32_t punct : {U',', U'.', U'!', U'?', U';', U':', U'\''}) {
    u32string tmp;
    tmp.reserve(text.size());
    for (size_t i = 0; i < text.size(); ++i) {
      if (text[i] == U' ' && i + 1 < text.size() && text[i + 1] == punct) {
        tmp.push_back(punct);
        ++i;
      } else {
        tmp.push_back(text[i]);
      }
    }
    text.swap(tmp);
  }

  // 7. duplicate-quote collapse (py/helper.py:87-93)
  auto collapse = [&](const u32string& pair, const u32string& single) {
    while (text.find(pair) != u32string::npos) ReplaceAll(&text, pair, single);
  };
  collapse(U"\"\"", U"\"");
  collapse(U"''", U"'");
  collapse(U"``", U"`");

  // 8. whitespace collapse + strip (py/helper.py:96)
  {
    u32string tmp;
    bool in_space = false;
    for (uint32_t cp : text) {
      if (IsSpace(cp)) {
        in_space = true;
      } else {
        if (in_space && !tmp.empty()) tmp.push_back(U' ');
        in_space = false;
        tmp.push_back(cp);
      }
    }
    text.swap(tmp);
  }

  // 9. terminal punctuation guarantee (py/helper.py:99-100)
  if (!EndsWithTerminal(text)) text.push_back(U'.');

  // 10. language tag wrap (py/helper.py:102-104)
  u32string out;
  out.push_back(U'<');
  for (char c : lang) out.push_back(static_cast<char32_t>(c));
  out.push_back(U'>');
  out += text;
  out += U"</";
  for (char c : lang) out.push_back(static_cast<char32_t>(c));
  out.push_back(U'>');
  return out;
}

bool ValidLang(const std::string& lang) {
  return lang == "en" || lang == "ko" || lang == "es" || lang == "pt" ||
         lang == "fr";
}

// ---------------------------------------------------------------- chunker ---
// Character-exact C++ twin of the Python chunker
// (supertonic_tpu_torch/frontend/chunker.py, differential-tested against reference
// py/helper.py:388-429 + the Rust port's oversize fallbacks,
// rust/src/helper.rs:330-450). The reference C++ port chunks natively too
// (cpp/helper.cpp:1117); here it keeps per-host feeders GIL-free end-to-end.
// All lengths are CODEPOINT counts (Python len), not bytes.

bool InRanges(uint32_t cp, const CpRange* table, int n) {
  int lo = 0, hi = n - 1;
  while (lo <= hi) {
    int mid = (lo + hi) / 2;
    if (cp < table[mid].lo)
      hi = mid - 1;
    else if (cp >= table[mid].hi)
      lo = mid + 1;
    else
      return true;
  }
  return false;
}

// Python str.isspace / str.isalnum (tables generated from the interpreter)
bool IsPySpace(uint32_t cp) {
  return InRanges(cp, kSpaceRanges, kSpaceRangesSize);
}
bool IsPyAlnum(uint32_t cp) {
  return InRanges(cp, kAlnumRanges, kAlnumRangesSize);
}

u32string StripPy(const u32string& s) {
  size_t b = 0, e = s.size();
  while (b < e && IsPySpace(s[b])) ++b;
  while (e > b && IsPySpace(s[e - 1])) --e;
  return s.substr(b, e - b);
}

// paragraph split on r"\n\s*\n+": post-strip this is equivalent to
// splitting at every whitespace run containing >= 2 newlines
std::vector<u32string> SplitParagraphs(const u32string& text) {
  std::vector<u32string> out;
  size_t start = 0, i = 0;
  const size_t n = text.size();
  while (i < n) {
    if (IsPySpace(text[i])) {
      size_t j = i;
      int newlines = 0;
      while (j < n && IsPySpace(text[j])) {
        if (text[j] == U'\n') ++newlines;
        ++j;
      }
      if (newlines >= 2) {
        out.push_back(text.substr(start, i - start));
        start = j;
      }
      i = j;
    } else {
      ++i;
    }
  }
  if (start < n) out.push_back(text.substr(start));
  return out;
}

const char* kAbbreviations[] = {
    "Mr.",  "Mrs.", "Ms.",  "Dr.",  "Prof.", "Sr.",  "Jr.",
    "Ph.D.", "etc.", "e.g.", "i.e.", "vs.",  "Inc.", "Ltd.",
    "Co.",  "Corp.", "St.",  "Ave.", "Blvd.",
};

bool EndsWithAscii(const u32string& s, const char* suffix) {
  size_t m = std::strlen(suffix);
  if (s.size() < m) return false;
  for (size_t i = 0; i < m; ++i)
    if (s[s.size() - m + i] != static_cast<uint32_t>(suffix[i])) return false;
  return true;
}

// chunker.py _ends_with_abbreviation: known abbreviation, or a single
// capital initial "F." with a word boundary before it (a preceding '.' IS a
// boundary — "U.S. Government" must not split mid-acronym)
bool EndsWithAbbreviation(const u32string& prefix) {
  for (const char* a : kAbbreviations)
    if (EndsWithAscii(prefix, a)) return true;
  size_t n = prefix.size();
  if (n >= 2 && prefix[n - 2] >= U'A' && prefix[n - 2] <= U'Z') {
    if (n == 2) return true;
    uint32_t before = prefix[n - 3];
    if (!(IsPyAlnum(before) || before == U'_')) return true;
  }
  return false;
}

std::vector<u32string> SplitSentences(const u32string& para) {
  std::vector<u32string> out;
  size_t start = 0, i = 0;
  const size_t n = para.size();
  while (i < n) {
    uint32_t ch = para[i];
    if ((ch == U'.' || ch == U'!' || ch == U'?') && i + 1 < n &&
        IsPySpace(para[i + 1])) {
      if (ch != U'.' ||
          !EndsWithAbbreviation(para.substr(start, i + 1 - start))) {
        u32string s = StripPy(para.substr(start, i + 1 - start));
        if (!s.empty()) out.push_back(s);
        ++i;
        while (i < n && IsPySpace(para[i])) ++i;
        start = i;
        continue;
      }
    }
    ++i;
  }
  u32string tail = StripPy(para.substr(start));
  if (!tail.empty()) out.push_back(tail);
  return out;
}

// chunker.py _split_oversized: comma segments (trailing comma kept,
// following whitespace consumed — re.split(r"(?<=,)\s*")), then words,
// greedily re-packed
std::vector<u32string> SplitOversized(const u32string& sentence,
                                      size_t max_len) {
  if (sentence.size() <= max_len) return {sentence};
  std::vector<u32string> segments;
  size_t start = 0, i = 0;
  const size_t n = sentence.size();
  while (i < n) {
    if (sentence[i] == U',') {
      segments.push_back(sentence.substr(start, i + 1 - start));
      ++i;
      while (i < n && IsPySpace(sentence[i])) ++i;
      start = i;
    } else {
      ++i;
    }
  }
  if (start < n) segments.push_back(sentence.substr(start));
  std::vector<u32string> pieces;
  for (const auto& seg : segments) {
    if (seg.size() <= max_len) {
      pieces.push_back(seg);
    } else {  // word-level fallback (str.split on whitespace runs)
      size_t b = 0;
      while (b < seg.size()) {
        while (b < seg.size() && IsPySpace(seg[b])) ++b;
        size_t e = b;
        while (e < seg.size() && !IsPySpace(seg[e])) ++e;
        if (e > b) pieces.push_back(seg.substr(b, e - b));
        b = e;
      }
    }
  }
  std::vector<u32string> parts;
  u32string current;
  for (const auto& piece : pieces) {
    size_t cand = current.empty() ? piece.size()
                                  : current.size() + 1 + piece.size();
    if (cand <= max_len) {
      if (!current.empty()) current.push_back(U' ');
      current += piece;
    } else {
      if (!current.empty()) parts.push_back(current);
      current = piece;
    }
  }
  if (!current.empty()) parts.push_back(current);
  if (parts.empty()) parts.push_back(sentence);
  return parts;
}

std::vector<u32string> ChunkText(const u32string& raw, size_t max_len) {
  std::vector<u32string> chunks;
  for (const auto& para_raw : SplitParagraphs(StripPy(raw))) {
    u32string para = StripPy(para_raw);
    if (para.empty()) continue;
    u32string current;
    for (const auto& sentence : SplitSentences(para)) {
      for (const auto& piece : SplitOversized(sentence, max_len)) {
        if (current.size() + piece.size() + 1 <= max_len) {
          if (!current.empty()) current.push_back(U' ');
          current += piece;
        } else {
          if (!current.empty()) chunks.push_back(StripPy(current));
          current = piece;
        }
      }
    }
    if (!current.empty()) chunks.push_back(StripPy(current));
  }
  return chunks;
}

}  // namespace

extern "C" {

int stpu_preprocess(const char* utf8, const char* lang_c, char* out,
                    int out_cap) {
  std::string lang(lang_c ? lang_c : "");
  if (!ValidLang(lang)) return -1;
  u32string processed = Preprocess(DecodeUtf8(utf8), lang);
  std::string encoded;
  EncodeUtf8(processed, &encoded);
  if (static_cast<int>(encoded.size()) + 1 > out_cap) return -2;
  std::memcpy(out, encoded.data(), encoded.size());
  out[encoded.size()] = '\0';
  return static_cast<int>(encoded.size());
}

long stpu_tokenize(const char* utf8, const long long* indexer, long table_len,
                   long long* out_ids, long cap) {
  u32string cps = DecodeUtf8(utf8);
  if (static_cast<long>(cps.size()) > cap) return -2;
  for (size_t i = 0; i < cps.size(); ++i) {
    uint32_t cp = cps[i];
    // out-of-table codepoints CLAMP to index 0 like the Python frontend
    // (normalize.py tokenize) — literal 0 diverges when indexer[0] != 0
    out_ids[i] = (cp < static_cast<uint32_t>(table_len))
                     ? indexer[cp]
                     : (table_len > 0 ? indexer[0] : 0);
  }
  return static_cast<long>(cps.size());
}

// Whole-batch frontend: preprocess + tokenize ALL rows in ONE call.
// ``texts``/``langs``: n NUL-terminated UTF-8 strings back to back. Writes
// token ids row-major into out_ids and per-row lengths into out_lens.
// Returns total ids written, -1 invalid lang, -2 ids_cap too small.
// Rationale: per-utterance ctypes calls are too fine-grained — the
// GIL-holding Python overhead around each call dominates and threaded
// feeders scale WORSE than pure Python (measured 0.32x at 4 threads).
// One call per batch keeps the GIL released for the whole batch's work.
long stpu_frontend_batch(const char* texts, const char* langs, long n,
                         const long long* indexer, long table_len,
                         long long* out_ids, long ids_cap, long* out_lens) {
  const char* tp = texts;
  const char* lp = langs;
  long pos = 0;
  for (long i = 0; i < n; ++i) {
    std::string lang(lp);
    lp += lang.size() + 1;
    if (!ValidLang(lang)) return -1;
    u32string processed = Preprocess(DecodeUtf8(tp), lang);
    tp += std::strlen(tp) + 1;
    if (pos + static_cast<long>(processed.size()) > ids_cap) return -2;
    for (char32_t cp : processed)
      out_ids[pos++] =
          (static_cast<uint32_t>(cp) < static_cast<uint32_t>(table_len))
              ? indexer[static_cast<uint32_t>(cp)]
              : (table_len > 0 ? indexer[0] : 0);  // clamp like Python
    out_lens[i] = static_cast<long>(processed.size());
  }
  return pos;
}

// Long-form chunking (see ChunkText above). Writes the chunks' UTF-8 bytes
// concatenated into ``out`` and their byte offsets into ``offsets``
// (n_chunks + 1 entries: chunk k spans [offsets[k], offsets[k+1])).
// Returns n_chunks, or -2 when either buffer is too small.
long stpu_chunk_text(const char* utf8, long max_len, char* out, long out_cap,
                     long* offsets, long offsets_cap) {
  std::vector<u32string> chunks =
      ChunkText(DecodeUtf8(utf8), static_cast<size_t>(max_len));
  if (static_cast<long>(chunks.size()) + 1 > offsets_cap) return -2;
  long pos = 0;
  std::string bytes;
  for (size_t k = 0; k < chunks.size(); ++k) {
    offsets[k] = pos;
    EncodeUtf8(chunks[k], &bytes);
    if (pos + static_cast<long>(bytes.size()) > out_cap) return -2;
    std::memcpy(out + pos, bytes.data(), bytes.size());
    pos += static_cast<long>(bytes.size());
  }
  offsets[chunks.size()] = pos;
  return static_cast<long>(chunks.size());
}

int stpu_version() { return 3; }

}  // extern "C"
