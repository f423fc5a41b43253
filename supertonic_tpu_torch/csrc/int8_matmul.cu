// The int8 product of the W8A8 linears, in two forms of one kernel:
//   int8_matmul: C[M, N] (int32) = A[M, K] (int8) . W[N, K]^T (int8), exact;
//   w8a8_matmul: Y[M, N] = (float(A . W^T) * sx[m]) * w_scale[n] + bias[n],
//                rounded once to Y's type (bf16 or f32); with silu, then
//                y / (1 + expf(-y)), F.silu's formula, rounded once more
//                (the FFN's first linear on the int8 path:
//                supertonic_tpu/models/layers.py:365).
// The W8A8 product's two other forms, the Q and K projections' rotation
// and the O and FFN-out's gated residual in the epilogue (bf16 results,
// the int8 path's VE), need a column's partner c + Dh / 2 in the same
// thread, which this GEMM's epilogue (a column pair at a time) cannot see:
// they run csrc/linear.cu's GEMM with its s8 operand and this rescale
// (stk_w8a8_epilogue there, w8a8_matmul(..., rope=, residual=) in
// ops/w8a8.py). f32 results and the sharded W8A8 linears keep this kernel,
// then csrc/rope.cu or csrc/gated_residual.cu.
//
// Replaces tools/int8_microbench.py:_pallas_i8_matmul, the Pallas int8 x int8
// -> int32 kernel (the product that the JAX package's _linear_w8a8 leaves to
// XLA's dot_general). Both operands are contiguous in K: A is the per-token
// quantized activation (csrc/quantize.cu writes it and sx), W the quantized
// weight in torch's linear layout [dout, din]. |sum| <= 127^2 * K, far
// inside int32 for every K the path has.
//
// Bound on the H100: the bytes. At the W8A8 path's main shape (M = 28,672
// rows, K = 512, N = 512, bf16 out) 14.7 MB of A, 0.26 MB of W and 29.4 MB
// of Y take 0.0133 ms at 3.35 TB/s, against 0.0076 ms for the 15 G
// operations at 1,979 TOPS int8. So the W8A8 path writes the linear's
// output straight from the accumulators and never an int32 tensor. The
// epilogue is bit-equal to the plain version's f32 operations:
// __int2float_rn (which rounds above 2^24, as torch's .float() does), then
// __fmul_rn, __fmul_rn and __fadd_rn in the plain order, so nvcc cannot
// contract them into an FMA, and one rounding to the stored type.
//
// Design: the warp-specialised GEMM of csrc/wgmma_gemm.cuh with its s8
// operation (WgmmaS8: wgmma.mma_async m64nBNk32 s32.s8.s8, both operands
// K-major from 128-byte-swizzled shared memory). A producer warpgroup
// streams K in stages of 128 bytes (128 int8, four products) by TMA (the
// unsigned 8-bit map type moves the bytes unchanged); persistent blocks of
// two consumer warpgroups take turns over whole tiles, n fastest so that
// the tiles in flight share their A rows in L2, and each one's epilogue
// (the row's and the column's scales, the rounding, the swizzled staging
// and the TMA store) runs beside the other's products: with K = 512 a
// tile is only four stages, and its epilogue is about as long as its
// mainloop. Results leave by TMA stores in 128-byte rows (64 bf16 columns,
// or 32 of int32 / f32); rows past M and columns past N load as zeros and
// are not stored; an N whose rows are no multiple of 16 bytes (an odd N,
// say) takes the register-store instance, which writes element by element
// where it must. The three tensor maps are encoded at every launch (a
// graph capture keeps them): a cache of encoded maps measured no faster
// host-launched at the TP int8 path's shapes, where the Python wrapper's
// own work is the host time (PERF.md section 6). A launch takes the large
// tile while that gives every consumer warpgroup of the card a tile (896
// tiles of 128 x 128 at the cell's M 28,672 N 512), else the small one (the
// TP int8 path's M 1,792). With silu (the FFN's first linear) the epilogue
// is longer than the tile's products and runs at one warp a scheduler a
// consumer: four consumer warpgroups on 64 x 64 tiles take the ffn.in shape
// (M 28,672 K 512 N 2,048) from 0.215 ms a launch (two on 128 x 128) to
// 0.175, against 0.079 for the product alone and 0.079 for F.silu's pass
// (replayed graphs, kernel_variants.py int8). Silu from the block's table
// (silu_table.cuh; the GEMM keeps an epilogue's table, Epi::TABLE_BYTES):
// 0.144-0.147 against the exact sequence's 0.175-0.177 (the same, NVIDIA
// H100 80GB HBM3, 700 W). The mma.sync design this replaces is
// csrc/earlier/int8_matmul_mma_sync.cu (with csrc/mma_gemm.cuh).
#include <type_traits>

#include "silu_table.cuh"
#include "wgmma_gemm.cuh"

namespace {

using Op = stk::WgmmaS8;
// NC, MI (rows 64 MI), BN, stages, blocks an SM, persistent, shared tiles,
// TMA store, result bytes, any N (kernel_variants.py builds others): bf16
// results, then 4-byte (int32, f32) ones, at many tiles, at few, and at an
// N whose rows no TMA map takes
using Bf16Tile = stk::WgTile<2, 2, 128, 4, 1, true>;
using Bf16TileFew = stk::WgTile<2, 1, 64, 8, 1, true>;
using Bf16TileAnyN = stk::WgTile<2, 1, 64, 8, 1, true, false, false, 2, true>;
// bf16 results with silu at many tiles: 64 x 64 tiles, four consumer warpgroups
using Bf16SiluTile = stk::WgTile<4, 1, 64, 8, 1, true>;
using WideTile = stk::WgTile<2, 1, 128, 4, 1, true, false, true, 4>;
using WideTileFew = stk::WgTile<2, 1, 64, 8, 1, true, false, true, 4>;
using WideTileAnyN = stk::WgTile<2, 1, 64, 8, 1, true, false, false, 4, true>;

// int8_matmul: C = the exact sums
struct Int32Out {
  using Out = int32_t;
  struct Row {
    __device__ __forceinline__ uint2 operator()(int, int v0, int v1) const {
      return make_uint2((uint32_t)v0, (uint32_t)v1);
    }
  };
  __device__ __forceinline__ Row row(int) const { return {}; }
};

// bf16 results with silu take it from the block's table (silu_table.cuh),
// else by the exact sequence a value
constexpr bool SILU_BY_TABLE = true;

// silu as F.silu computes it on the card (opmath f32): for bf16 results of a
// bf16 value, without the IEEE division's slow path (stk::silu_bf16_torch);
// f32 results (off the int8 path) by the division itself
template <typename T>
__device__ __forceinline__ float silu_torch(float x) {
  if constexpr (sizeof(T) == 2)
    return stk::silu_bf16_torch(x);
  else
    return x / (1.0f + expf(-x));
}

// w8a8_matmul: Y = (float(sums) * sx[row]) * ws[col] + bias[col], rounded
// once to T (SILU: then silu, rounded again; in bf16 from the block's silu
// table, TAB); ANY_N reads the last odd column's scale and bias alone
template <typename T, bool ANY_N, bool SILU = false>
struct ScaleOut {
  using Out = T;
  static constexpr bool TAB = SILU && SILU_BY_TABLE && sizeof(T) == 2;
  static constexpr size_t TABLE_BYTES = TAB ? stk::SILU_TAB_BYTES : 0;
  const float* sx;
  const float* ws;
  const float* bias;
  int N;
  struct Row {
    float s;
    const float* ws;
    const float* bias;
    int N;
    const uint32_t* tab;
    __device__ __forceinline__ stk::Pair<sizeof(T)> operator()(int col, int v0, int v1) const {
      float2 w, b;
      if (!ANY_N || col + 1 < N) {  // col is even: 8-byte aligned
        w = *reinterpret_cast<const float2*>(ws + col);
        b = *reinterpret_cast<const float2*>(bias + col);
      } else {
        w = make_float2(ws[col], 0.0f);
        b = make_float2(bias[col], 0.0f);
      }
      float y0 = __fadd_rn(__fmul_rn(__fmul_rn(__int2float_rn(v0), s), w.x), b.x);
      float y1 = __fadd_rn(__fmul_rn(__fmul_rn(__int2float_rn(v1), s), w.y), b.y);
      if constexpr (TAB) {
        return stk::silu_bf16x2(tab, stk::pack_bf16(y0, y1));
      } else if constexpr (SILU) {
        y0 = silu_torch<T>(stk::rnd<T>(y0));
        y1 = silu_torch<T>(stk::rnd<T>(y1));
      }
      if constexpr (sizeof(T) == 2) {
        return stk::pack_bf16(y0, y1);  // round to nearest even, as torch's .to(bf16)
      } else {
        return make_uint2(__float_as_uint(y0), __float_as_uint(y1));
      }
    }
  };
  __device__ __forceinline__ Row row(int r) const { return {sx[r], ws, bias, N, nullptr}; }
  __device__ __forceinline__ Row row(int r, const uint8_t* table) const {
    return {sx[r], ws, bias, N, reinterpret_cast<const uint32_t*>(table)};
  }
  static __device__ __forceinline__ void fill(uint8_t* table, int tid, int threads) {
    stk::silu_table_fill(reinterpret_cast<uint32_t*>(table), tid, threads);
  }
};

template <typename S, typename Epi>
int go(const void* a, const void* w, void* c, int M, int N, int K, Epi epi, void* stream) {
  return stk::launch_wgmma_gemm<Op, S, Epi>(
      (const int8_t*)a, (const int8_t*)w, (typename stk::EpiOut<Epi>::type*)c, M, N, K, epi,
      (cudaStream_t)stream);
}

// the instance for results of T (with silu: SILU) at this shape
template <typename T, bool SILU = false, typename Epi, typename EpiAnyN>
int launch(const void* a, const void* w, void* c, int M, int N, int K, Epi epi,
           EpiAnyN epi_any_n, void* stream) {
  constexpr bool B16 = sizeof(T) == 2;
  using Many = std::conditional_t<B16, std::conditional_t<SILU, Bf16SiluTile, Bf16Tile>, WideTile>;
  using Few = std::conditional_t<B16, Bf16TileFew, WideTileFew>;
  using AnyN = std::conditional_t<B16, Bf16TileAnyN, WideTileAnyN>;
  if (M < 1 || N < 1 || K < 32 || K % 32) return (int)cudaErrorInvalidValue;
  if ((N * sizeof(T)) % 16) return go<AnyN>(a, w, c, M, N, K, epi_any_n, stream);
  int sms = 0;
  if (int err = stk::sm_count(sms)) return err;
  if (stk::gemm_tiles<Many>(M, N) >= (long long)Many::NC * sms)
    return go<Many>(a, w, c, M, N, K, epi, stream);
  return go<Few>(a, w, c, M, N, K, epi, stream);
}

}  // namespace

// a [M, K] int8, w [N, K] int8, c [M, N] int32; all contiguous, a and w
// 16-byte aligned; M, N >= 1; K a positive multiple of 32.
extern "C" int stk_int8_matmul(const void* a, const void* w, void* c, int M, int N,
                               int K, void* stream) {
  return launch<int32_t>(a, w, c, M, N, K, Int32Out{}, Int32Out{}, stream);
}

// a [M, K] int8, w [N, K] int8 as above; sx [M], w_scale [N], bias [N]
// float; y [M, N] in dtype 0 float, 1 bf16; silu 1: F.silu of the result.
// All contiguous and 16-byte aligned. silu comes after the stream, so that
// the earlier design's entry (csrc/earlier/), which lacks it, takes the same
// call without silu.
extern "C" int stk_w8a8_matmul(const void* a, const void* w, const void* sx,
                               const void* w_scale, const void* bias, void* y, int M,
                               int N, int K, int dtype, void* stream, int silu) {
  auto f = [](const void* p) { return (const float*)p; };
  using bf16 = __nv_bfloat16;
#define STK_W8A8(T, SILU)                                                     \
  launch<T, SILU>(a, w, y, M, N, K,                                           \
                  ScaleOut<T, false, SILU>{f(sx), f(w_scale), f(bias), N},    \
                  ScaleOut<T, true, SILU>{f(sx), f(w_scale), f(bias), N}, stream)
  if (dtype == 0) return silu ? STK_W8A8(float, true) : STK_W8A8(float, false);
  if (dtype == 1) return silu ? STK_W8A8(bf16, true) : STK_W8A8(bf16, false);
#undef STK_W8A8
  return (int)cudaErrorInvalidValue;
}

// the instances' tiles, rows x columns x ring stages: bf16 results at many
// tiles, at few and at any N, then the same for 4-byte results
extern "C" int stk_int8_tiles(int* tiles) {
  const int v[18] = {Bf16Tile::BM, Bf16Tile::BN, Bf16Tile::NS, Bf16TileFew::BM,
                     Bf16TileFew::BN, Bf16TileFew::NS, Bf16TileAnyN::BM, Bf16TileAnyN::BN,
                     Bf16TileAnyN::NS, WideTile::BM, WideTile::BN, WideTile::NS,
                     WideTileFew::BM, WideTileFew::BN, WideTileFew::NS, WideTileAnyN::BM,
                     WideTileAnyN::BN, WideTileAnyN::NS};
  for (int i = 0; i < 18; ++i) tiles[i] = v[i];
  return 0;
}
