// Fused AdaLN-modulated FFN sublayer of the vector-estimator blocks:
//   out = x + gate * (silu(mod(LN(x)) . W1 + b1) . W2 + b2),
//   mod(h) = h * (1 + scale) + shift, per batch row, broadcast over T.
//
// Replaces supertonic_tpu/ops/ffn.py:_ffn_kernel. Numerics follow it: row
// statistics and the LN affine in f32 (eps inside the rsqrt), the
// modulated h rounded to the weights' type before the first product, both
// products accumulated in f32, b1 and silu in f32 and the result rounded to
// W2's type, the residual x_f32 + gate_f32 * y rounded once to x's type.
//
// Bound on the H100: 4*N*D*F operations against (2*N*D + 2*D*F) elements,
// about 69 GFLOP for 16384 rows at D=512, F=2048, which is compute-bound
// on the tensor cores. In bf16 the products run on the tensor cores through
// WMMA (16x16x16 bf16 fragments, f32 accumulators; 128x128 block tiles,
// 8 warps of 64x32, K in steps of 32 through shared memory, no asynchronous
// copies yet). In f32 they run on the SIMT float units (64x64 tiles, 4x4
// per thread), which keeps the f32 path exact to f32 rounding.
//
// Two launches: (1) LN statistics in the block's prologue, then normalise,
// affine, modulate and round applied while the A tile is loaded, GEMM1 +
// b1 + silu, written as the [N, F] intermediate to device memory; (2) GEMM2
// + b2 + gated residual. The intermediate passes through device memory in
// this version.
//
// Weights are in torch's linear layout: W1 [F, D], W2 [D, F] (each row one
// output channel), so both products read A and B along K.
#include <mma.h>
#include <type_traits>

#include "common.cuh"

namespace {

using bf16 = __nv_bfloat16;
constexpr int NT = 256;

// ---------------------------------------------------------------------------
// f32: SIMT tiles. C tile = A . B^T over K, A from load_a(row, r, k), B rows
// along K from b_rows[n * K + k]; epilogue(row, col, acc) stores.
// ---------------------------------------------------------------------------
constexpr int SBM = 64, SBN = 64, SBK = 16;

template <typename LoadA, typename Epi>
__device__ __forceinline__ void gemm_simt(int m0, int n0, int N, int K,
                                          const float* __restrict__ b_rows,
                                          LoadA load_a, Epi epilogue) {
  __shared__ float As[SBK][SBM + 4];
  __shared__ float Bs[SBK][SBN + 4];
  const int tid = threadIdx.x, tx = tid % 16, ty = tid / 16;
  float acc[4][4] = {};
  for (int k0 = 0; k0 < K; k0 += SBK) {
#pragma unroll
    for (int i = 0; i < (SBM * SBK) / NT; ++i) {
      int e = tid + i * NT, r = e / SBK, kk = e % SBK;
      As[kk][r] = m0 + r < N ? load_a(m0 + r, r, k0 + kk) : 0.0f;
      Bs[kk][r] = b_rows[(size_t)(n0 + r) * K + k0 + kk];
    }
    __syncthreads();
#pragma unroll
    for (int kk = 0; kk < SBK; ++kk) {
      float a[4], b[4];
#pragma unroll
      for (int i = 0; i < 4; ++i) { a[i] = As[kk][ty * 4 + i]; b[i] = Bs[kk][tx * 4 + i]; }
#pragma unroll
      for (int i = 0; i < 4; ++i)
#pragma unroll
        for (int j = 0; j < 4; ++j) acc[i][j] += a[i] * b[j];
    }
    __syncthreads();
  }
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    int row = m0 + ty * 4 + i;
    if (row >= N) continue;
#pragma unroll
    for (int j = 0; j < 4; ++j) epilogue(row, n0 + tx * 4 + j, acc[i][j]);
  }
}

// ---------------------------------------------------------------------------
// bf16: WMMA tiles. A chunks of 8 values from load_a8(row, r, k) as uint4,
// B rows along K from b_rows; epilogue(row, col, acc).
// ---------------------------------------------------------------------------
constexpr int WBM = 128, WBN = 128, WBK = 32, WLD = WBK + 8;

template <typename LoadA8, typename Epi>
__device__ __forceinline__ void gemm_wmma(int m0, int n0, int N, int K,
                                          const bf16* __restrict__ b_rows,
                                          LoadA8 load_a8, Epi epilogue) {
  using namespace nvcuda;
  __shared__ __align__(32) bf16 As[WBM][WLD];
  __shared__ __align__(32) bf16 Bs[WBN][WLD];
  __shared__ __align__(32) float Cs[NT / 32][16][16];
  const int tid = threadIdx.x, warp = tid >> 5, lane = tid & 31;
  const int wm = warp / 4, wn = warp % 4;  // 2 x 4 warps of 64 x 32
  wmma::fragment<wmma::accumulator, 16, 16, 16, float> acc[4][2];
#pragma unroll
  for (int i = 0; i < 4; ++i)
#pragma unroll
    for (int j = 0; j < 2; ++j) wmma::fill_fragment(acc[i][j], 0.0f);
  for (int k0 = 0; k0 < K; k0 += WBK) {
#pragma unroll
    for (int i = 0; i < (WBM * WBK / 8) / NT; ++i) {
      int c = tid + i * NT, r = c / (WBK / 8), kc = (c % (WBK / 8)) * 8;
      *reinterpret_cast<uint4*>(&As[r][kc]) =
          m0 + r < N ? load_a8(m0 + r, r, k0 + kc) : make_uint4(0, 0, 0, 0);
      *reinterpret_cast<uint4*>(&Bs[r][kc]) =
          *reinterpret_cast<const uint4*>(b_rows + (size_t)(n0 + r) * K + k0 + kc);
    }
    __syncthreads();
#pragma unroll
    for (int kk = 0; kk < WBK; kk += 16) {
      wmma::fragment<wmma::matrix_a, 16, 16, 16, bf16, wmma::row_major> a[4];
      wmma::fragment<wmma::matrix_b, 16, 16, 16, bf16, wmma::col_major> b[2];
#pragma unroll
      for (int i = 0; i < 4; ++i) wmma::load_matrix_sync(a[i], &As[wm * 64 + i * 16][kk], WLD);
#pragma unroll
      for (int j = 0; j < 2; ++j) wmma::load_matrix_sync(b[j], &Bs[wn * 32 + j * 16][kk], WLD);
#pragma unroll
      for (int i = 0; i < 4; ++i)
#pragma unroll
        for (int j = 0; j < 2; ++j) wmma::mma_sync(acc[i][j], a[i], b[j], acc[i][j]);
    }
    __syncthreads();
  }
#pragma unroll
  for (int i = 0; i < 4; ++i)
#pragma unroll
    for (int j = 0; j < 2; ++j) {
      wmma::store_matrix_sync(&Cs[warp][0][0], acc[i][j], 16, wmma::mem_row_major);
      __syncwarp();
      for (int e = lane; e < 256; e += 32) {
        int r = e / 16, c = e % 16, row = m0 + wm * 64 + i * 16 + r;
        if (row < N) epilogue(row, n0 + wn * 32 + j * 16 + c, Cs[warp][r][c]);
      }
      __syncwarp();
    }
}

template <typename T> struct Tile;
template <> struct Tile<float> { static constexpr int M = SBM, N = SBN; };
template <> struct Tile<bf16> { static constexpr int M = WBM, N = WBN; };

template <typename T>
__global__ void __launch_bounds__(NT)
ffn_up(const T* __restrict__ x, const float* __restrict__ ln_g,
       const float* __restrict__ ln_b, const T* __restrict__ w1,
       const float* __restrict__ b1, const float* __restrict__ shift,
       const float* __restrict__ scale, T* __restrict__ mid, int N, int Tlen,
       int D, int F, float eps) {
  constexpr int BM = Tile<T>::M;
  __shared__ float s_mean[BM], s_rstd[BM];
  const int m0 = blockIdx.y * BM, n0 = blockIdx.x * Tile<T>::N;
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  for (int r = warp; r < BM; r += NT / 32) {
    int row = m0 + r;
    float mean = 0.0f, rstd = 0.0f;
    if (row < N) {
      const T* xr = x + (size_t)row * D;
      float s = 0.0f;
      for (int k = lane; k < D; k += 32) s += stk::to_f(xr[k]);
      mean = stk::warp_sum(s) / D;
      float v = 0.0f;
      for (int k = lane; k < D; k += 32) { float c = stk::to_f(xr[k]) - mean; v += c * c; }
      rstd = 1.0f / sqrtf(stk::warp_sum(v) / D + eps);
    }
    if (lane == 0) { s_mean[r] = mean; s_rstd[r] = rstd; }
  }
  __syncthreads();
  auto mod = [&](int row, int r, int k, float xv) {
    const size_t bk = (size_t)(row / Tlen) * D + k;
    float h = (xv - s_mean[r]) * s_rstd[r];
    h = h * ln_g[k] + ln_b[k];
    return stk::rnd<T>(h * (1.0f + scale[bk]) + shift[bk]);
  };
  auto epi = [&](int row, int col, float acc) {
    mid[(size_t)row * F + col] = stk::from_f<T>(stk::silu_f(acc + b1[col]));
  };
  if constexpr (std::is_same<T, float>::value) {
    auto load_a = [&](int row, int r, int k) { return mod(row, r, k, x[(size_t)row * D + k]); };
    gemm_simt(m0, n0, N, D, w1, load_a, epi);
  } else {
    auto load_a8 = [&](int row, int r, int k) {
      uint4 raw = *reinterpret_cast<const uint4*>(x + (size_t)row * D + k);
      bf16* v = reinterpret_cast<bf16*>(&raw);
#pragma unroll
      for (int i = 0; i < 8; ++i) v[i] = __float2bfloat16(mod(row, r, k + i, __bfloat162float(v[i])));
      return raw;
    };
    gemm_wmma(m0, n0, N, D, w1, load_a8, epi);
  }
}

template <typename T>
__global__ void __launch_bounds__(NT)
ffn_down(const T* __restrict__ x, const T* __restrict__ mid,
         const T* __restrict__ w2, const float* __restrict__ b2,
         const float* __restrict__ gate, T* __restrict__ out, int N, int Tlen,
         int D, int F) {
  const int m0 = blockIdx.y * Tile<T>::M, n0 = blockIdx.x * Tile<T>::N;
  auto epi = [&](int row, int col, float acc) {
    const int bi = row / Tlen;
    size_t i = (size_t)row * D + col;
    out[i] = stk::from_f<T>(stk::to_f(x[i]) + gate[(size_t)bi * D + col] * (acc + b2[col]));
  };
  if constexpr (std::is_same<T, float>::value) {
    auto load_a = [&](int row, int, int k) { return mid[(size_t)row * F + k]; };
    gemm_simt(m0, n0, N, F, w2, load_a, epi);
  } else {
    auto load_a8 = [&](int row, int, int k) {
      return *reinterpret_cast<const uint4*>(mid + (size_t)row * F + k);
    };
    gemm_wmma(m0, n0, N, F, w2, load_a8, epi);
  }
}

template <typename T>
int launch(const void* x, const float* g, const float* b, const void* w1,
           const float* b1, const void* w2, const float* b2, const float* shift,
           const float* scale, const float* gate, void* mid, void* out, int B,
           int Tlen, int D, int F, float eps, cudaStream_t st) {
  constexpr int TM = Tile<T>::M, TN = Tile<T>::N;
  if (D % TN || F % TN) return (int)cudaErrorInvalidValue;
  const int N = B * Tlen;
  dim3 up(F / TN, (N + TM - 1) / TM), down(D / TN, (N + TM - 1) / TM);
  ffn_up<T><<<up, NT, 0, st>>>((const T*)x, g, b, (const T*)w1, b1, shift, scale,
                               (T*)mid, N, Tlen, D, F, eps);
  int err = (int)cudaGetLastError();
  if (err) return err;
  ffn_down<T><<<down, NT, 0, st>>>((const T*)x, (const T*)mid, (const T*)w2, b2,
                                   gate, (T*)out, N, Tlen, D, F);
  return (int)cudaGetLastError();
}

}  // namespace

// x/out [B,T,D]; w1 [F,D]; w2 [D,F] (storage type: dtype 0 float, 1 bf16);
// ln g/b [D], b1 [F], b2 [D], shift/scale/gate [B,D] float; mid [B*T,F]
// scratch in the storage type. All contiguous; D and F multiples of 128.
extern "C" int stk_adaln_ffn(const void* x, const void* g, const void* b,
                             const void* w1, const void* b1, const void* w2,
                             const void* b2, const void* shift, const void* scale,
                             const void* gate, void* mid, void* out, int B,
                             int Tlen, int D, int F, float eps, int dtype,
                             void* stream) {
  cudaStream_t st = (cudaStream_t)stream;
  auto f = [](const void* p) { return (const float*)p; };
  if (dtype == 0)
    return launch<float>(x, f(g), f(b), w1, f(b1), w2, f(b2), f(shift), f(scale),
                         f(gate), mid, out, B, Tlen, D, F, eps, st);
  if (dtype == 1)
    return launch<bf16>(x, f(g), f(b), w1, f(b1), w2, f(b2), f(shift), f(scale),
                        f(gate), mid, out, B, Tlen, D, F, eps, st);
  return (int)cudaErrorInvalidValue;
}
