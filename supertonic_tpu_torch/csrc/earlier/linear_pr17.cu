// The replaced design of the linear kernel (csrc/linear.cu: the FFN's
// GEMM template in wgmma_gemm.cuh with three epilogues), kept for
// comparison: kernel_variants.py builds it as the "earlier" row of the
// linear kernel.
// The bf16 linear with the output fusion XLA makes of the JAX package's
// layers.linear (supertonic_tpu/models/layers.py:55-62) and of what its
// callers do with the result:
//   Y[M, N] = X[M, K] . W[N, K]^T, f32 sums, then per element
//   o = rnd(rnd(y) + rnd(bias))          the bf16 product plus the bf16 bias
//                                        (MODE_BIAS: o stored in bf16)
//   s = rnd(o / (1 + exp(-o)))           MODE_SILU: jax.nn.silu(linear(...)),
//                                        the FFN's first linear
//                                        (supertonic_tpu/models/layers.py:365),
//                                        the time MLP and the DP head
//   v = o * mask[row]                    MODE_TAIL: the flow step's tail
//   x = x_in[row, col] + dt[batch] * v   (supertonic_tpu/models/
//   out = x * mask[row], stored in f32   vector_estimator.py:156, :185-186)
// where rnd rounds to bf16 (nearest even). Each sum and product is its own
// IEEE operation (__fadd_rn, __fmul_rn), as eager PyTorch rounds them: nvcc
// would otherwise contract a*b+c into one FMA. Silu is the plain version's
// F.silu on the card (opmath f32, x / (1 + expf(-x))) bit for bit, its
// division by the IEEE division's fast sequence (stk::silu_bf16_torch): the
// division itself, with its per-element check and slow-path call, tripled
// the FFN-in's time (kernel_variants.py linear).
//
// It replaces no Pallas kernel: XLA fuses the bias add (and the silu, and
// the Euler update) into the dot's output. The port ran them as PyTorch's
// own kernels after a cuBLAS product: a cast of the f32 bias to bf16 and an
// add over the whole product, a silu pass, and four elementwise passes of
// the flow step. A cuBLAS bias epilogue adds the bias in f32 before it
// rounds, which is not JAX's rounding.
//
// Bound on the H100 (3.35 TB/s, 989 TFLOP/s bf16), per b64/5-step batch at
// T = 448: the VE's self V (M 28,672, K 512, N 512) moves 59.3 MB in 0.0177
// ms against 0.0152 ms of products; the TE's FFN-in with silu (M 20,480, K
// 256, N 1,024) 0.0158 ms of bytes; out_proj with the tail (M 28,672, K 512,
// N 96) reads X (29.4 MB), x_in and writes x (11 MB each), 0.0155 ms; the
// M = 64 linears (adaln N 4,608) read their weights, 4.7 MB, 0.0014 ms.
// Bytes bound every shape of the path.
//
// Design: the warp-specialised wgmma GEMM of csrc/wgmma_gemm.cuh (the FFN's
// and the int8 product's) with WgmmaBf16 and this epilogue, run from the
// accumulator registers: a producer warp streams 64-element K slices of X
// and W by TMA (rows past M, columns past K and rows of W past N load as
// zeros: K 96 is two slices, the second half zero), persistent blocks of
// two consumer warpgroups take whole tiles in turns, so one's epilogue runs
// beside the other's products. Each mode is its own instance (a conv
// epilogue that read its options at run time measured several times slower,
// csrc/conv1d.cu). bf16 results leave by TMA stores (128 x 128 tiles while
// they give every consumer of the card a tile, else 64 x 64: the M = 64
// linears, a streamed chunk's B = 1 rows) or, at an N whose rows no TMA map
// takes (N 1, the DP's rate head), from the registers; the tail's f32
// results from the registers in 64 x 128 tiles (N = 96 is one column tile,
// so X is read once). The silu form's epilogue (silu's exponential and
// division a value) is longer than its tile's products, and a consumer's
// epilogue runs at one warp a scheduler: it takes four consumer warpgroups
// on 64 x 64 tiles, which left the FFN-in's 0.082 ms a launch at 0.070
// (two on 128 x 128: the bias form's tiles; three on 64 x 128: 0.073; from
// replayed graphs, kernel_variants.py linear). Neither the division's fast
// sequence nor rounding on the integer pipe moved it; the silu form stays
// ~2.5x cuBLAS's product with its bias epilogue there. A K that is no multiple of 8 (a row no TMA map takes:
// the latent width 15 of a reference config) runs linear_simt: 64 x 64
// tiles from scalar loads, f32 FMA sums, the same epilogue.
#include <type_traits>

#include "wgmma_gemm.cuh"

namespace {

using bf16 = __nv_bfloat16;
using Op = stk::WgmmaBf16;

constexpr int MODE_BIAS = 0, MODE_SILU = 1, MODE_TAIL = 2;

// NC, MI (rows 64 MI), BN, stages, blocks an SM, persistent, shared tiles,
// TMA store, result bytes, any N
using Many = stk::WgTile<2, 2, 128, 4, 1, true>;
using Few = stk::WgTile<2, 1, 64, 8, 1, true>;
using AnyN = stk::WgTile<2, 1, 64, 8, 1, true, false, false, 2, true>;
using TailTile = stk::WgTile<2, 1, 128, 4, 1, true, false, false, 4, true>;
// the silu form at many tiles: 64 x 64 tiles, four consumer warpgroups
using ManySilu = stk::WgTile<4, 1, 64, 8, 1, true>;

// JAX's bf16 bias add: the f32 sum rounded to bf16, plus the bias rounded
// to bf16, their f32 sum rounded once more
__device__ __forceinline__ float bias_rn(float acc, float b) {
  return stk::rnd<bf16>(__fadd_rn(stk::rnd<bf16>(acc), stk::rnd<bf16>(b)));
}

// F.silu of the bf16 pair (y0, y1), packed to bf16
__device__ __forceinline__ uint32_t silu_pair(float y0, float y1) {
  return stk::pack_bf16(stk::silu_bf16_torch(y0), stk::silu_bf16_torch(y1));
}

// The epilogue of MODE on a column pair (col, col + 1) of a row; ANY_N:
// col + 1 may be past N (its value is then not stored)
template <int MODE, bool ANY_N>
struct LinearEpi {
  using Out = std::conditional_t<MODE == MODE_TAIL, float, bf16>;
  const float* bias;  // [N]
  const float* x_in;  // MODE_TAIL: [M, N] f32
  const float* mask;  // MODE_TAIL: [M] f32 (0/1)
  const float* dt;    // MODE_TAIL: [M / T] f32
  int N, T;
  struct Row {
    const float* bias;
    const float* x;  // the row of x_in
    float m, dt;
    int N;
    __device__ __forceinline__ stk::Pair<sizeof(Out)> operator()(int col, float v0,
                                                                 float v1) const {
      const bool two = !ANY_N || col + 1 < N;
      float y0 = bias_rn(v0, bias[col]);
      float y1 = bias_rn(v1, two ? bias[col + 1] : 0.0f);
      if constexpr (MODE == MODE_SILU) {
        return silu_pair(y0, y1);  // y0, y1 are bf16 values
      } else if constexpr (MODE == MODE_TAIL) {
        const float x0 = x[col], x1 = two ? x[col + 1] : 0.0f;
        y0 = __fmul_rn(__fadd_rn(x0, __fmul_rn(dt, __fmul_rn(y0, m))), m);
        y1 = __fmul_rn(__fadd_rn(x1, __fmul_rn(dt, __fmul_rn(y1, m))), m);
        return make_uint2(__float_as_uint(y0), __float_as_uint(y1));
      } else {
        return stk::pack_bf16(y0, y1);  // round to nearest even
      }
    }
  };
  __device__ __forceinline__ Row row(int r) const {
    if constexpr (MODE == MODE_TAIL)
      return {bias, x_in + (size_t)r * N, mask[r], dt[r / T], N};
    else
      return {bias, nullptr, 0.0f, 0.0f, N};
  }
};

// ---------------------------------------------------------------------------
// a K no multiple of 8: SIMT
// ---------------------------------------------------------------------------
constexpr int S_THREADS = 256, S_TILE = 64, S_KC = 32;

// a 64 x 64 tile of Y a block, each thread rows ty + 16 i (i < 4) and
// columns 4 tx .. 4 tx + 3 (two pairs), K in chunks of 32 staged as f32
template <typename Epi>
__global__ void __launch_bounds__(S_THREADS)
linear_simt(const bf16* __restrict__ X, const bf16* __restrict__ W,
            typename stk::EpiOut<Epi>::type* __restrict__ C, int M, int N, int K, Epi epi) {
  __shared__ float xs[S_KC][S_TILE + 1], ws[S_KC][S_TILE + 1];
  const int tx = threadIdx.x % 16, ty = threadIdx.x / 16;
  const int m0 = blockIdx.x * S_TILE, n0 = blockIdx.y * S_TILE;
  float acc[4][4];
#pragma unroll
  for (int i = 0; i < 4; ++i)
#pragma unroll
    for (int j = 0; j < 4; ++j) acc[i][j] = 0.0f;
  for (int k0 = 0; k0 < K; k0 += S_KC) {
    for (int i = threadIdx.x; i < S_TILE * S_KC; i += S_THREADS) {
      const int r = i / S_KC, kk = i % S_KC, k = k0 + kk;
      xs[kk][r] = m0 + r < M && k < K ? __bfloat162float(X[(size_t)(m0 + r) * K + k]) : 0.0f;
      ws[kk][r] = n0 + r < N && k < K ? __bfloat162float(W[(size_t)(n0 + r) * K + k]) : 0.0f;
    }
    __syncthreads();
#pragma unroll 8
    for (int kk = 0; kk < S_KC; ++kk) {
      float a[4], b[4];
#pragma unroll
      for (int i = 0; i < 4; ++i) a[i] = xs[kk][ty + 16 * i];
#pragma unroll
      for (int j = 0; j < 4; ++j) b[j] = ws[kk][4 * tx + j];
#pragma unroll
      for (int i = 0; i < 4; ++i)
#pragma unroll
        for (int j = 0; j < 4; ++j) acc[i][j] = fmaf(a[i], b[j], acc[i][j]);
    }
    __syncthreads();
  }
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const int row = m0 + ty + 16 * i;
    if (row >= M) continue;
    const auto at = epi.row(row);
#pragma unroll
    for (int p = 0; p < 2; ++p) {
      const int col = n0 + 4 * tx + 2 * p;
      if (col < N)
        stk::store_pair_any(C, (size_t)row * N + col, col, N,
                            at(col, acc[i][2 * p], acc[i][2 * p + 1]));
    }
  }
}

// ---------------------------------------------------------------------------
// launch
// ---------------------------------------------------------------------------

template <typename S, typename Epi>
int gemm(const bf16* x, const bf16* w, void* y, int M, int N, int K, const Epi& epi,
         cudaStream_t st) {
  return stk::launch_wgmma_gemm<Op, S, Epi>(x, w, (typename stk::EpiOut<Epi>::type*)y, M, N, K,
                                            epi, st);
}

template <int MODE>
int launch(const bf16* x, const bf16* w, void* y, int M, int N, int K,
           const LinearEpi<MODE, false>& epi, const LinearEpi<MODE, true>& epi_any,
           cudaStream_t st) {
  if (M < 1 || N < 1 || K < 1) return (int)cudaErrorInvalidValue;
  if (K % 8) {  // rows of X and W no TMA map takes
    const long long n_tiles = (N + S_TILE - 1) / S_TILE;
    if (n_tiles > 65535) return (int)cudaErrorInvalidValue;
    const dim3 grid((M + S_TILE - 1) / S_TILE, (unsigned)n_tiles);
    using Out = typename stk::EpiOut<LinearEpi<MODE, true>>::type;
    linear_simt<<<grid, S_THREADS, 0, st>>>(x, w, (Out*)y, M, N, K, epi_any);
    return (int)cudaGetLastError();
  }
  if constexpr (MODE == MODE_TAIL) {
    return gemm<TailTile>(x, w, y, M, N, K, epi_any, st);
  } else {
    if (N % 8) return gemm<AnyN>(x, w, y, M, N, K, epi_any, st);
    int sms = 0;
    if (int err = stk::sm_count(sms)) return err;
    if (stk::gemm_tiles<Many>(M, N) >= (long long)Many::NC * sms)
      return MODE == MODE_SILU ? gemm<ManySilu>(x, w, y, M, N, K, epi, st)
                               : gemm<Many>(x, w, y, M, N, K, epi, st);
    return gemm<Few>(x, w, y, M, N, K, epi, st);
  }
}

}  // namespace

// x [M, K] and w [N, K] bf16, bias [N] f32; mode 0 (bias) and 1 (bias,
// silu): y [M, N] bf16; mode 2 (the flow step's tail): x_in [M, N] f32,
// mask [M] f32, dt [M / T] f32 (T rows a batch row), y [M, N] f32. All
// contiguous and 16-byte aligned.
extern "C" int stk_linear(const void* x, const void* w, const void* bias, const void* x_in,
                          const void* mask, const void* dt, void* y, int M, int N, int K, int T,
                          int mode, void* stream) {
  auto f = [](const void* p) { return (const float*)p; };
  const bf16* xb = (const bf16*)x;
  const bf16* wb = (const bf16*)w;
  cudaStream_t st = (cudaStream_t)stream;
  if (T < 1) return (int)cudaErrorInvalidValue;
#define STK_LINEAR(MODE_)                                                                 \
  launch<MODE_>(xb, wb, y, M, N, K,                                                      \
                LinearEpi<MODE_, false>{f(bias), f(x_in), f(mask), f(dt), N, T},         \
                LinearEpi<MODE_, true>{f(bias), f(x_in), f(mask), f(dt), N, T}, st)
  if (mode == MODE_BIAS) return STK_LINEAR(MODE_BIAS);
  if (mode == MODE_SILU) return STK_LINEAR(MODE_SILU);
  if (mode == MODE_TAIL) return STK_LINEAR(MODE_TAIL);
#undef STK_LINEAR
  return (int)cudaErrorInvalidValue;
}

// the instances' tiles, rows x columns x ring stages: bf16 results at many
// tiles, at few, at any N, then the tail's f32 results
extern "C" int stk_linear_tiles(int* tiles) {
  const int v[12] = {Many::BM, Many::BN, Many::NS, Few::BM, Few::BN, Few::NS,
                     AnyN::BM, AnyN::BN, AnyN::NS, TailTile::BM, TailTile::BN, TailTile::NS};
  for (int i = 0; i < 12; ++i) tiles[i] = v[i];
  return 0;
}
