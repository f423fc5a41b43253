// Native self-test driver for the C++ frontend — built with ASan/UBSan via
// `make sanitize` (the reference has no sanitizer coverage at all; its C++
// port even uses deliberately unsafe global tensor buffers,
// cpp/helper.cpp:17-24). Exercises preprocessing across scripts, edge cases
// and adversarial buffers; exit 0 = pass.

#include <cassert>
#include <cstdio>
#include <cstring>
#include <string>
#include <vector>

extern "C" {
int stpu_preprocess(const char* utf8, const char* lang, char* out, int cap);
long stpu_tokenize(const char* utf8, const long long* indexer, long table_len,
                   long long* out_ids, long cap);
long stpu_chunk_text(const char* utf8, long max_len, char* out, long out_cap,
                     long* offsets, long offsets_cap);
long stpu_frontend_batch(const char* texts, const char* langs, long n,
                         const long long* indexer, long table_len,
                         long long* out_ids, long ids_cap, long* out_lens);
int stpu_version();
}

static int check(const char* text, const char* lang, const char* expect) {
  char buf[4096];
  int n = stpu_preprocess(text, lang, buf, sizeof buf);
  if (n < 0) {
    std::printf("FAIL %s: rc=%d\n", text, n);
    return 1;
  }
  if (expect && std::strcmp(buf, expect) != 0) {
    std::printf("FAIL %s: got %s want %s\n", text, buf, expect);
    return 1;
  }
  return 0;
}

int main() {
  int fails = 0;
  assert(stpu_version() == 3);

  fails += check("Hello world", "en", "<en>Hello world.</en>");
  fails += check("what ?", "en", "<en>what?</en>");
  fails += check("a–b", "en", "<en>a-b.</en>");
  fails += check("café", "fr", nullptr);        // NFKD decomposition
  fails += check("안녕", "ko", nullptr);      // Hangul Jamo
  fails += check("", "en", "<en>.</en>");

  // invalid lang
  char buf[64];
  if (stpu_preprocess("hi", "de", buf, sizeof buf) != -1) {
    std::printf("FAIL: invalid lang accepted\n");
    ++fails;
  }
  // overflow guard
  if (stpu_preprocess("hello", "en", buf, 3) != -2) {
    std::printf("FAIL: overflow not detected\n");
    ++fails;
  }
  // malformed UTF-8 must not crash (ASan-guarded)
  const char bad[] = {char(0xC3), char(0x28), char(0xE2), char(0x82),
                      char(0xFF), char(0xF0), 0};
  fails += check(bad, "en", nullptr);
  // truncated multibyte at end of string
  const char trunc[] = {'a', char(0xE2), char(0x82), 0};
  fails += check(trunc, "en", nullptr);

  // tokenize path
  long long table[128];
  for (int i = 0; i < 128; ++i) table[i] = i + 1;
  long long ids[64];
  long n = stpu_tokenize("abc", table, 128, ids, 64);
  if (n != 3 || ids[0] != 'a' + 1) {
    std::printf("FAIL tokenize\n");
    ++fails;
  }
  // out-of-table codepoint clamps to indexer[0] (Python np.where semantics)
  n = stpu_tokenize("é", table, 128, ids, 64);
  if (n != 1 || ids[0] != table[0]) {
    std::printf("FAIL tokenize oob\n");
    ++fails;
  }
  // cap too small
  if (stpu_tokenize("abcdef", table, 128, ids, 2) != -2) {
    std::printf("FAIL tokenize cap\n");
    ++fails;
  }

  // stress: long mixed-script input
  std::string big;
  for (int i = 0; i < 2000; ++i) big += "café 안녕 x ";
  std::vector<char> out(big.size() * 4 + 64);
  if (stpu_preprocess(big.c_str(), "en", out.data(),
                      static_cast<int>(out.size())) < 0) {
    std::printf("FAIL stress\n");
    ++fails;
  }

  // chunker: abbreviation guard, acronym, paragraph split, oversize packing
  {
    char cbuf[4096];
    long offs[64];
    const char* text =
        "Dr. Smith met Mr. Jones. The U.S. Government agreed!\n\n"
        "A second paragraph, with commas, goes here and keeps going on.";
    long nc = stpu_chunk_text(text, 40, cbuf, sizeof cbuf, offs, 64);
    if (nc < 2) {
      std::printf("FAIL chunker: nc=%ld\n", nc);
      ++fails;
    }
    for (long k = 0; k < nc; ++k) {
      long len = offs[k + 1] - offs[k];
      if (len <= 0 || len > 4 * 40) {  // bytes <= 4x codepoint budget
        std::printf("FAIL chunker span %ld: %ld bytes\n", k, len);
        ++fails;
      }
    }
    // abbreviation must not split: "Dr. Smith" stays in chunk 0
    std::string first(cbuf + offs[0], cbuf + offs[1]);
    if (first.find("Dr. Smith") == std::string::npos) {
      std::printf("FAIL chunker abbrev: %s\n", first.c_str());
      ++fails;
    }
    // capacity guards
    if (stpu_chunk_text(text, 40, cbuf, 8, offs, 64) != -2 ||
        stpu_chunk_text(text, 40, cbuf, sizeof cbuf, offs, 1) != -2) {
      std::printf("FAIL chunker cap guard\n");
      ++fails;
    }
    // malformed UTF-8 through the chunker must not crash (ASan-guarded)
    const char badc[] = {char(0xF0), char(0x9F), 'a', '.', ' ',
                         char(0xC3), 0};
    if (stpu_chunk_text(badc, 10, cbuf, sizeof cbuf, offs, 64) < 0) {
      std::printf("FAIL chunker bad utf8\n");
      ++fails;
    }
  }

  // whole-batch frontend: two rows, mixed langs, capacity + lang guards
  {
    long long table[256];
    for (int i = 0; i < 256; ++i) table[i] = i;
    const char texts[] = "Hi there.\0caf\xc3\xa9.\0";
    const char langs[] = "en\0fr\0";
    long long ids[256];
    long lens[2];
    long total = stpu_frontend_batch(texts, langs, 2, table, 256, ids, 256,
                                     lens);
    if (total <= 0 || lens[0] <= 0 || lens[1] <= 0 ||
        total != lens[0] + lens[1]) {
      std::printf("FAIL frontend_batch: total=%ld\n", total);
      ++fails;
    }
    if (stpu_frontend_batch(texts, langs, 2, table, 256, ids, 3, lens)
        != -2) {
      std::printf("FAIL frontend_batch cap\n");
      ++fails;
    }
    const char badlang[] = "en\0de\0";
    if (stpu_frontend_batch(texts, badlang, 2, table, 256, ids, 256, lens)
        != -1) {
      std::printf("FAIL frontend_batch lang\n");
      ++fails;
    }
  }

  if (fails == 0) std::printf("NATIVE FRONTEND TESTS PASSED\n");
  return fails ? 1 : 0;
}
