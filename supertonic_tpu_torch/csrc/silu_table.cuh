// F.silu of a bf16 value, rounded to bf16, by table lookup: the function of
// 16 bits that stk::silu_bf16_torch computes (F.silu on the card, bit for
// bit), for the GEMM epilogues whose silu input is a bf16 value (csrc/
// linear.cu's silu and silu-quantize forms, csrc/int8_matmul.cu's W8A8 silu
// form).
//
// Over the 65,536 bf16 bit patterns x (F.silu in f32, rounded to bf16):
//   |x| < 2^SILU_TAB_EMIN             rnd(x * 0.5) (zeros and subnormals too)
//   x >= 2^(SILU_TAB_EMAX + 1)        x (+inf too)
//   x <= -2^(SILU_TAB_EMAX + 1)       -0
//   NaN, -inf                         NaN (x / inf for -inf)
// and between them, at the 2 x 18 exponents SILU_TAB_EMIN..SILU_TAB_EMAX of
// either sign, a table of SILU_TAB_ENTRIES bf16 values (9 KB) that each block
// fills in shared memory at its start, every entry stk::silu_bf16_torch of
// its value: 4,608 evaluations a block, no global table, no extra launch,
// nothing a CUDA graph captures.
//
// The table holds |x|'s two results in one word (silu(|x|) in the low half,
// silu(-|x|) in the high half), so a pair of values costs two ld.shared at
// |x|'s indices, clamped to the table, and one prmt whose selector each
// value's sign sets; the small values below the table (down to 2^-125,
// silu(x) = x / 2) take the first word's result with their exponent one
// less, by a packed 16-bit add. About six integer instructions a value, in
// place of an expf, a rcp.approx and the division's FMAs. The rest (zeros,
// subnormals and 2^-126, |x| from 2^(SILU_TAB_EMAX + 1), NaN: none in a
// network's activations, as a rule) takes the closed forms on a branch of
// its own. The integer pipe, half the FP32 one's rate on this card, sets
// the lookup's cost, so its instructions are counted: a lookup that handled
// every case by selects (about fifteen integer instructions a value) cost
// as much as the exact sequence.
//
// These lines hold the bounds for the kernels and for the CPU test
// (tests/test_torch_silu_table.py reads them from this file, mirrors the
// rule in plain PyTorch and holds it against F.silu at every bit pattern);
// chip_smoke.py holds every kernel that uses it against F.silu on the card
// at every finite bf16 value.
#pragma once

#include "common.cuh"

namespace stk {

constexpr int SILU_TAB_EMIN = -10;  // the table's least exponent of |x|
constexpr int SILU_TAB_EMAX = 7;    // and its greatest
// entries a sign: 128 mantissas an exponent
constexpr int SILU_TAB_HALF = (SILU_TAB_EMAX - SILU_TAB_EMIN + 1) * 128;
constexpr int SILU_TAB_ENTRIES = 2 * SILU_TAB_HALF;  // bf16 results, two a word
constexpr int SILU_TAB_BYTES = 2 * SILU_TAB_ENTRIES;
// the bits of |x| (bf16, sign cleared) at the table's first word
constexpr uint32_t SILU_TAB_LO = (uint32_t)(127 + SILU_TAB_EMIN) << 7;
static_assert(SILU_TAB_BYTES % 16 == 0, "the table keeps what follows it 16-byte aligned");

// the bf16 bits of a float rounded to bf16 (nearest even)
__device__ __forceinline__ uint32_t bf16_bits(float v) {
  return __bfloat16_as_ushort(__float2bfloat16_rn(v));
}

// Fills the block's table: threads tid = 0 .. threads - 1 of the block take
// words tid, tid + threads, ...; the caller synchronises the block after.
__device__ __forceinline__ void silu_table_fill(uint32_t* tab, int tid, int threads) {
  for (int i = tid; i < SILU_TAB_HALF; i += threads) {
    const float v = __uint_as_float((SILU_TAB_LO + i) << 16);
    tab[i] = bf16_bits(silu_bf16_torch(v)) | (bf16_bits(silu_bf16_torch(-v)) << 16);
  }
}

// Packed 16-bit integer arithmetic (sm_90), one instruction for both halves
__device__ __forceinline__ uint32_t add_s16x2(uint32_t a, uint32_t b) {
  uint32_t d;
  asm("add.s16x2 %0, %1, %2;" : "=r"(d) : "r"(a), "r"(b));
  return d;
}
__device__ __forceinline__ uint32_t min_s16x2(uint32_t a, uint32_t b) {
  uint32_t d;
  asm("min.s16x2 %0, %1, %2;" : "=r"(d) : "r"(a), "r"(b));
  return d;
}
__device__ __forceinline__ uint32_t max_s16x2(uint32_t a, uint32_t b) {
  uint32_t d;
  asm("max.s16x2 %0, %1, %2;" : "=r"(d) : "r"(a), "r"(b));
  return d;
}
__device__ __forceinline__ uint32_t min_relu_s16x2(uint32_t a, uint32_t b) {  // max(min(a, b), 0)
  uint32_t d;
  asm("min.s16x2.relu %0, %1, %2;" : "=r"(d) : "r"(a), "r"(b));
  return d;
}
__device__ __forceinline__ uint32_t min_u16x2(uint32_t a, uint32_t b) {
  uint32_t d;
  asm("min.u16x2 %0, %1, %2;" : "=r"(d) : "r"(a), "r"(b));
  return d;
}
__device__ __forceinline__ uint32_t max_u16x2(uint32_t a, uint32_t b) {
  uint32_t d;
  asm("max.u16x2 %0, %1, %2;" : "=r"(d) : "r"(a), "r"(b));
  return d;
}

// |x|'s bits from which a value is taken on silu_bf16x2_table's fast path:
// normal values down to 2^-125, below them the table's small ones (and the
// zeros and the least subnormals, |x| bits 0 and 1, whose silu is +-0)
constexpr uint32_t SILU_FAST_LO = 0x100;
constexpr uint32_t SILU_TAB_HI = SILU_TAB_LO + SILU_TAB_HALF;  // |x|'s bits past the table

// Gathers, of each half of the bf16 pair o, the least |x| bits less 2
// (wrapping below: the zeros and the least subnormals past any other) and
// the greatest |x| bits into lo2 and hi2, for silu_outside
__device__ __forceinline__ void silu_gather(uint32_t o, uint32_t& lo2, uint32_t& hi2) {
  lo2 = min_u16x2(lo2, add_s16x2(o & 0x7fff7fffu, 0xfffefffeu));
  hi2 = max_u16x2(hi2, o & 0x7fff7fffu);
}

// whether a value that silu_gather saw lies off silu_bf16x2_table's path:
// |x| bits from 2 below SILU_FAST_LO (subnormals, 2^-126) or past the table
__device__ __forceinline__ bool silu_outside(uint32_t lo2, uint32_t hi2) {
  return min(lo2 & 0xffffu, lo2 >> 16) < SILU_FAST_LO - 2 ||
         max(hi2 & 0xffffu, hi2 >> 16) >= SILU_TAB_HI;
}

// whether a value of the pair o lies off silu_bf16x2_table's path: |x|
// bits less SILU_FAST_LO (wrapping below it) clamped to the path's width by
// one packed min, which changes them only there
__device__ __forceinline__ bool silu_outside(uint32_t o) {
  constexpr uint32_t two = 0x00010001u;
  const uint32_t t2 = add_s16x2(o & 0x7fff7fffu, (0x10000u - SILU_FAST_LO) * two);
  return min_u16x2(t2, (SILU_TAB_HI - SILU_FAST_LO - 1) * two) != t2;
}

// silu of a pair of bf16 values in one word o (the lower column in the low
// half) by the table, as such a word, exact where both values' |x| bits lie
// in [SILU_FAST_LO, SILU_TAB_HI) or are 0 or 1: each value's word at |x|'s
// index clamped to the table, the half x's sign picks (a prmt whose selector
// the sign bits set: nibbles 9 and B replicate the signs of o's bytes 1 and
// 3), and for 2^-125 <= |x| < 2^SILU_TAB_EMIN, where silu(x) = x / 2, the
// first word's result, +-2^(SILU_TAB_EMIN - 1), plus (|x|'s bits -
// SILU_TAB_LO): an exponent one less; that sum no less than +-0 (|x| bits 0
// and 1). About seven integer instructions a value, three of them packed
// 16-bit ones for both, and one ld.shared.
__device__ __forceinline__ uint32_t silu_bf16x2_table(const uint32_t* tab, uint32_t o) {
  constexpr uint32_t two = 0x00010001u;
  const uint32_t i2 = add_s16x2(o & 0x7fff7fffu, (0x10000u - SILU_TAB_LO) * two);  // |x| - LO
  const uint32_t c2 = min_relu_s16x2(i2, (SILU_TAB_HALF - 1) * two);  // clamped to the table
  const uint32_t wlo = tab[c2 & 0xffffu], whi = tab[c2 >> 16];
  uint32_t sel, r;
  asm("prmt.b32 %0, %1, %2, 0xB9;" : "=r"(sel) : "r"(o), "r"(0u));
  sel = (sel & 0x2222u) | 0x5410u;
  asm("prmt.b32 %0, %1, %2, %3;" : "=r"(r) : "r"(wlo), "r"(whi), "r"(sel));
  // the small values' exponent one less, down to +-0
  return add_s16x2(r, max_s16x2(min_s16x2(i2, 0u), (0x10000u - (SILU_TAB_LO - 0x80)) * two));
}

// silu of the bf16 value whose bits are u (the low 16 bits) off the fast
// path, as bf16 bits: the table for |x| in it, else the closed forms and NaN
// (NAN_AS_ZERO: -0 for NaN and -inf, which the quantize pass treats alike:
// the row max skips a NaN and it quantizes to 0)
template <bool NAN_AS_ZERO = false>
__device__ __forceinline__ uint32_t silu_bf16_rest(const uint32_t* tab, uint32_t u) {
  const uint32_t a = u & 0x7fffu;
  const bool neg = (u & 0x8000u) != 0;
  if (a - SILU_TAB_LO < (uint32_t)SILU_TAB_HALF) {
    const uint32_t w = tab[a - SILU_TAB_LO];
    return neg ? w >> 16 : w & 0xffffu;
  }
  if (a < SILU_TAB_LO) return bf16_bits(__fmul_rn(__uint_as_float(u << 16), 0.5f));
  if (a > 0x7f80u || (neg && a == 0x7f80u)) return NAN_AS_ZERO ? 0x8000u : 0x7fffu;
  return neg ? 0x8000u : u;
}

template <bool NAN_AS_ZERO = false>
__device__ __forceinline__ uint32_t silu_bf16x2_rest(const uint32_t* tab, uint32_t o) {
  return silu_bf16_rest<NAN_AS_ZERO>(tab, o & 0xffffu) |
         (silu_bf16_rest<NAN_AS_ZERO>(tab, o >> 16) << 16);
}

// silu of a pair of bf16 values in one word o, as such a word: the fast
// path, or value by value where one lies off it (NAN_AS_ZERO: as
// silu_bf16_rest takes it)
template <bool NAN_AS_ZERO = false>
__device__ __forceinline__ uint32_t silu_bf16x2(const uint32_t* tab, uint32_t o) {
  const uint32_t r = silu_bf16x2_table(tab, o);
  return silu_outside(o) ? silu_bf16x2_rest<NAN_AS_ZERO>(tab, o) : r;
}

}  // namespace stk
