// Whole dilated residual chain of the vocoder's fine timelines, one launch:
//   for each dilation d_i:  h = mask * (conv_{k3,d_i}(silu x) + ba_i)
//                           x = x + mask * (conv_{k3,1}(silu h) + bb_i)
//
// Replaces supertonic_tpu/ops/vocoder_fused.py:_kernel (resblock_chain).
// Numerics follow it: silu in f32 rounded to the storage type; each conv
// accumulates in f32 with its f32 bias, is rounded to the storage type and
// then multiplied by the 0/1 frame mask; the residual add is in the storage
// type. The mask is the batch-shared frame mask, zero outside [0, T), which
// reproduces SAME zero padding at the sequence edges: after every conv,
// frames outside [0, T) and masked frames are exactly 0.
//
// Bound on the H100: 6 convs of 3*C*C multiply-adds per frame, about 309
// GFLOP at C=256 over 131,072 frames and 618 GFLOP at C=128 over 1,048,576
// frames, against two passes over the activation: compute-bound. In bf16
// each conv is an implicit GEMM on the tensor cores through WMMA (16x16x16
// bf16 fragments, f32 accumulators): a warp owns up to two tiles of 16
// frames x 128 channels, A fragments come from the shifted shared buffer,
// B fragments from the tap's [C, C] weights staged through shared memory
// 32 input channels at a time. In f32 the convs run on the SIMT float
// units (each thread 16 frames x 4 channels), exact to f32 rounding.
//
// Design: one block of 256 threads per (batch row, tile of TT output
// frames). The block loads W = TT + 2*halo frames (halo = the chain's
// one-sided reach, 16 for k=3 and dilations 1,3,9) into shared memory, zero
// outside [0, T), and runs all six convs between three shared buffers
// (x, silu(x), silu(h)) in the storage type. Each buffer has `pad` zero
// rows on both sides (one conv's reach, 9), so shifted reads stay inside
// it; the values those reads feed lie outside the exact region, whose
// frontier moves inward by each conv's reach, so after the chain the
// central TT frames are exact (the argument of the JAX kernel's docstring).
// Only the central tile is written. W is the largest multiple of 16 whose
// buffers fit SMEM_BUDGET (chain_tiling, which holds the whole layout).
#include <mma.h>
#include <type_traits>

#include "common.cuh"

namespace {

using bf16 = __nv_bfloat16;
constexpr int NT = 256, TF = 16, K = 3, MAX_P = 4;

struct Dil { int d[MAX_P]; };

// SIMT conv: out[f][c] for this thread's frames and channels.
// in points at frame 0 of a buffer with `pad` readable rows on each side.
template <typename T, int C, typename Epi>
__device__ __forceinline__ void conv_simt(const T* in, const T* __restrict__ w,
                                          const float* __restrict__ bias, int d,
                                          int W, Epi epi) {
  constexpr int CG = C / 4, FG = NT / CG;
  const int cg = threadIdx.x % CG, fg = threadIdx.x / CG, c0 = cg * 4;
  float bv[4];
#pragma unroll
  for (int i = 0; i < 4; ++i) bv[i] = bias[c0 + i];
  for (int f0 = fg * TF; f0 < W; f0 += FG * TF) {
    float acc[TF][4];
#pragma unroll
    for (int j = 0; j < TF; ++j)
#pragma unroll
      for (int i = 0; i < 4; ++i) acc[j][i] = bv[i];
#pragma unroll
    for (int tap = 0; tap < K; ++tap) {
      const T* rows = in + (ptrdiff_t)(f0 + (tap - (K - 1) / 2) * d) * C;
      const T* wt = w + (size_t)tap * C * C + c0;
      for (int ci = 0; ci < C; ++ci) {
        float wv[4];
        stk::load4(wt + (size_t)ci * C, wv);
#pragma unroll
        for (int j = 0; j < TF; ++j) {
          float a = stk::to_f(rows[j * C + ci]);
#pragma unroll
          for (int i = 0; i < 4; ++i) acc[j][i] += a * wv[i];
        }
      }
    }
#pragma unroll
    for (int j = 0; j < TF; ++j)
#pragma unroll
      for (int i = 0; i < 4; ++i) epi(f0 + j, c0 + i, acc[j][i]);
  }
}

// Tensor-core conv (bf16). Tile t (16 frames x 128 channels) belongs to
// warp t % 8, so a warp owns at most two tiles, both on the same channels
// (8 % (C / 128) == 0). The tap's weights pass through shared memory in
// chunks of KC input channels, loaded once per block and read by every
// warp; scratch holds one 16x16 f32 fragment per warp for the epilogue.
constexpr int KC = 32;

template <int C, typename Epi>
__device__ __forceinline__ void conv_wmma(const bf16* in, const bf16* __restrict__ w,
                                          const float* __restrict__ bias, int d,
                                          int W, float* scratch, bf16* wchunk,
                                          Epi epi) {
  using namespace nvcuda;
  constexpr int NTILE = C / 128;
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const int ntiles = (W / 16) * NTILE, n0 = (warp % NTILE) * 128;
  const bool own[2] = {warp < ntiles, warp + 8 < ntiles};
  const int f0[2] = {(warp / NTILE) * 16, ((warp + 8) / NTILE) * 16};
  wmma::fragment<wmma::accumulator, 16, 16, 16, float> acc[2][8];
#pragma unroll
  for (int i = 0; i < 2; ++i)
#pragma unroll
    for (int j = 0; j < 8; ++j) wmma::fill_fragment(acc[i][j], 0.0f);
  for (int tap = 0; tap < K; ++tap) {
    const int off = (tap - (K - 1) / 2) * d;
    for (int kc = 0; kc < C; kc += KC) {
      __syncthreads();  // the previous chunk is consumed
      const uint4* src = reinterpret_cast<const uint4*>(w + ((size_t)tap * C + kc) * C);
      for (int e = threadIdx.x; e < KC * C / 8; e += NT)
        reinterpret_cast<uint4*>(wchunk)[e] = src[e];
      __syncthreads();
#pragma unroll
      for (int kk = 0; kk < KC; kk += 16) {
        wmma::fragment<wmma::matrix_a, 16, 16, 16, bf16, wmma::row_major> a[2];
#pragma unroll
        for (int i = 0; i < 2; ++i)
          if (own[i]) wmma::load_matrix_sync(a[i], in + (ptrdiff_t)(f0[i] + off) * C + kc + kk, C);
#pragma unroll
        for (int j = 0; j < 8; ++j) {
          wmma::fragment<wmma::matrix_b, 16, 16, 16, bf16, wmma::row_major> b;
          wmma::load_matrix_sync(b, wchunk + kk * C + n0 + j * 16, C);
#pragma unroll
          for (int i = 0; i < 2; ++i)
            if (own[i]) wmma::mma_sync(acc[i][j], a[i], b, acc[i][j]);
        }
      }
    }
  }
  float* cs = scratch + warp * 256;
#pragma unroll
  for (int i = 0; i < 2; ++i) {
    if (!own[i]) continue;
#pragma unroll
    for (int j = 0; j < 8; ++j) {
      wmma::store_matrix_sync(cs, acc[i][j], 16, wmma::mem_row_major);
      __syncwarp();
      for (int e = lane; e < 256; e += 32) {
        int c = n0 + j * 16 + e % 16;
        epi(f0[i] + e / 16, c, cs[e] + bias[c]);
      }
      __syncwarp();
    }
  }
}

// Dynamic shared memory of one block, in this order (chain_kernel carves it
// up the same way): three [W + 2*pad, C] buffers of T (x, silu x, silu h),
// the [W] f32 frame mask, 8 warps x 16x16 f32 epilogue scratch and, for the
// tensor cores, a KC x C bf16 weight chunk.
constexpr size_t SMEM_BUDGET = 224 * 1024;

template <typename T, int C>
constexpr size_t smem_bytes(int W, int pad) {
  return 3 * (size_t)(W + 2 * pad) * C * sizeof(T) + (size_t)W * sizeof(float)
         + (NT / 32) * 256 * sizeof(float)
         + (std::is_same<T, bf16>::value ? (size_t)KC * C * sizeof(bf16) : 0);
}

// halo = the chain's one-sided reach, pad = one conv's reach, W = frames a
// block holds (tile = W - 2*halo); in bf16 W also gives each of the 8 warps
// at most two 16 x 128 tiles.
struct Tiling { int halo, pad, W; };

template <typename T, int C>
Tiling chain_tiling(const Dil& dil, int P) {
  constexpr int half = (K - 1) / 2;
  Tiling t = {0, 0, 0};
  for (int i = 0; i < P; ++i) {
    t.halo += dil.d[i] * half + half;
    t.pad = dil.d[i] * half > t.pad ? dil.d[i] * half : t.pad;
  }
  t.W = std::is_same<T, bf16>::value ? 16 * 16 * 128 / C : 1024;
  while (t.W > 0 && smem_bytes<T, C>(t.W, t.pad) > SMEM_BUDGET) t.W -= 16;
  return t;
}

template <typename T, int C>
__global__ void __launch_bounds__(NT, 1)
chain_kernel(const T* __restrict__ x, const float* __restrict__ fmask,
             const T* __restrict__ wa, const float* __restrict__ ba,
             const T* __restrict__ wb, const float* __restrict__ bb,
             T* __restrict__ out, int Tlen, int P, Dil dil, int W, int halo,
             int pad) {
  extern __shared__ __align__(128) unsigned char smem[];
  const size_t buf = (size_t)(W + 2 * pad) * C;  // elements per buffer
  T* X = reinterpret_cast<T*>(smem) + (size_t)pad * C;
  T* S = X + buf;   // silu(x)
  T* Hs = S + buf;  // silu(h)
  float* M = reinterpret_cast<float*>(reinterpret_cast<T*>(smem) + 3 * buf);
  float* scratch = M + W;  // 8 warps x 16x16 f32 (tensor-core epilogue)
  bf16* wchunk = reinterpret_cast<bf16*>(scratch + (NT / 32) * 256);  // KC x C
  const int TT = W - 2 * halo;
  const int b = blockIdx.y, t0 = blockIdx.x * TT - halo;
  const T* xb = x + (size_t)b * Tlen * C;

  // zero the pad rows of the three buffers (read only by inexact frames)
  for (int e = threadIdx.x; e < 3 * 2 * pad * C; e += NT) {
    int which = e / (2 * pad * C), r = e % (2 * pad * C);
    T* base = reinterpret_cast<T*>(smem) + which * buf;
    base[r < pad * C ? r : r + (size_t)W * C] = stk::from_f<T>(0.0f);
  }
  for (int e = threadIdx.x; e < W * C; e += NT) {
    int f = e / C, tg = t0 + f;
    float v = (tg >= 0 && tg < Tlen) ? stk::to_f(xb[(size_t)tg * C + e % C]) : 0.0f;
    X[e] = stk::from_f<T>(v);
    S[e] = stk::from_f<T>(stk::silu_f(v));
  }
  for (int f = threadIdx.x; f < W; f += NT) {
    int tg = t0 + f;
    M[f] = (tg >= 0 && tg < Tlen) ? (fmask ? fmask[tg] : 1.0f) : 0.0f;
  }
  __syncthreads();

  // h = mask * round(conv_d(silu x) + ba); store silu(h)
  auto epi_a = [&](int f, int c, float acc) {
    float h = stk::rnd<T>(acc) * M[f];
    Hs[(size_t)f * C + c] = stk::from_f<T>(stk::silu_f(h));
  };
  // x = x + mask * round(conv_1(silu h) + bb); store x and silu(x)
  auto epi_b = [&](int f, int c, float acc) {
    size_t i = (size_t)f * C + c;
    float xn = stk::rnd<T>(stk::to_f(X[i]) + stk::rnd<T>(acc) * M[f]);
    X[i] = stk::from_f<T>(xn);
    S[i] = stk::from_f<T>(stk::silu_f(xn));
  };
  for (int p = 0; p < P; ++p) {
    const T* wpa = wa + (size_t)p * K * C * C;
    const T* wpb = wb + (size_t)p * K * C * C;
    if constexpr (std::is_same<T, bf16>::value) {
      conv_wmma<C>(S, wpa, ba + p * C, dil.d[p], W, scratch, wchunk, epi_a);
      __syncthreads();
      conv_wmma<C>(Hs, wpb, bb + p * C, 1, W, scratch, wchunk, epi_b);
    } else {
      conv_simt<T, C>(S, wpa, ba + p * C, dil.d[p], W, epi_a);
      __syncthreads();
      conv_simt<T, C>(Hs, wpb, bb + p * C, 1, W, epi_b);
    }
    __syncthreads();
  }

  T* ob = out + (size_t)b * Tlen * C;
  for (int e = threadIdx.x; e < TT * C; e += NT) {
    int f = halo + e / C, tg = t0 + f;
    if (tg < Tlen) ob[(size_t)tg * C + e % C] = X[(size_t)f * C + e % C];
  }
}

template <typename T, int C>
int launch(const void* x, const float* m, const void* wa, const float* ba,
           const void* wb, const float* bb, void* out, int B, int Tlen, int P,
           Dil dil, cudaStream_t st) {
  const Tiling t = chain_tiling<T, C>(dil, P);
  if (t.W <= 2 * t.halo) return (int)cudaErrorInvalidValue;
  const size_t bytes = smem_bytes<T, C>(t.W, t.pad);
  static size_t configured = 0;
  if (bytes > configured) {
    int err = (int)cudaFuncSetAttribute(chain_kernel<T, C>,
                                        cudaFuncAttributeMaxDynamicSharedMemorySize,
                                        (int)bytes);
    if (err) return err;
    configured = bytes;
  }
  const int TT = t.W - 2 * t.halo;
  dim3 grid((Tlen + TT - 1) / TT, B);
  chain_kernel<T, C><<<grid, NT, bytes, st>>>((const T*)x, m, (const T*)wa, ba,
                                              (const T*)wb, bb, (T*)out, Tlen, P,
                                              dil, t.W, t.halo, t.pad);
  return (int)cudaGetLastError();
}

template <typename T, int C>
int tile_frames(Dil dil, int P) {
  const Tiling t = chain_tiling<T, C>(dil, P);
  return t.W - 2 * t.halo;
}

bool read_dils(const int* dils, int P, Dil* dil) {
  if (P < 1 || P > MAX_P) return false;
  for (int i = 0; i < P; ++i) {
    if (dils[i] < 1) return false;
    dil->d[i] = dils[i];
  }
  return true;
}

}  // namespace

// x/out [B,T,C]; wa/wb [P,3,C,C] (HIO per conv) in the storage type (dtype
// 0 float, 1 bf16); ba/bb [P,C] float; fmask [T] float or null; dils [P].
// All contiguous. The kernel picks its own time tiling.
extern "C" int stk_resblock_chain(const void* x, const void* fmask, const void* wa,
                                  const void* ba, const void* wb, const void* bb,
                                  void* out, int B, int Tlen, int C, int P,
                                  const int* dils, int dtype, void* stream) {
  Dil dil = {};
  if (!read_dils(dils, P, &dil)) return (int)cudaErrorInvalidValue;
  cudaStream_t st = (cudaStream_t)stream;
  const float* m = (const float*)fmask;
  const float* fa = (const float*)ba;
  const float* fb = (const float*)bb;
  if (dtype == 0 && C == 128)
    return launch<float, 128>(x, m, wa, fa, wb, fb, out, B, Tlen, P, dil, st);
  if (dtype == 0 && C == 256)
    return launch<float, 256>(x, m, wa, fa, wb, fb, out, B, Tlen, P, dil, st);
  if (dtype == 1 && C == 128)
    return launch<bf16, 128>(x, m, wa, fa, wb, fb, out, B, Tlen, P, dil, st);
  if (dtype == 1 && C == 256)
    return launch<bf16, 256>(x, m, wa, fa, wb, fb, out, B, Tlen, P, dil, st);
  return (int)cudaErrorInvalidValue;
}

// Output frames per block the kernel uses for these arguments, or -1.
extern "C" int stk_resblock_chain_tile(int C, int P, const int* dils, int dtype) {
  Dil dil = {};
  if (!read_dils(dils, P, &dil)) return -1;
  if (dtype == 0 && C == 128) return tile_frames<float, 128>(dil, P);
  if (dtype == 0 && C == 256) return tile_frames<float, 256>(dil, P);
  if (dtype == 1 && C == 128) return tile_frames<bf16, 128>(dil, P);
  if (dtype == 1 && C == 256) return tile_frames<bf16, 256>(dil, P);
  return -1;
}
