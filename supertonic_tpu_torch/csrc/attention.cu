// Masked multi-head softmax attention, [B, T, H, Dh] in and out.
//
// Replaces supertonic_tpu/ops/attention.py:_attn_kernel_rows (the Pallas
// kernel behind fused_attention): out = softmax(q.k^T * scale + bias) v with
// bias = (1 - key_mask) * -1e9 added after the scale product, logits and
// softmax statistics in f32, probabilities rounded to v's storage type
// before the PV product, PV accumulated in f32, output in q's type.
//
// Bound on the H100: at the path's shapes (Tq, Tk <= ~700, Dh = 64) the
// arithmetic is 4*Tq*Tk*Dh per head against 4*(Tq+Tk)*Dh*size bytes, so on
// the tensor cores the kernel is memory-bound in bf16. In bf16 both
// products run on the tensor cores through WMMA (16x16x16 bf16 fragments,
// f32 accumulators); in f32 they run on the SIMT float units, exact to f32
// rounding and bound by those units.
//
// Design: K and V stream through shared memory in tiles of 64 keys, so any
// Tq and Tk work (no panel cap). Two passes over the keys: the first keeps
// a running max and sum per row (online softmax), the second recomputes
// each logit and forms exp(l - max) / sum exactly as the TPU kernel does,
// rounds it to v's type, and accumulates p * v. The second pass costs one
// more q.k product per key but keeps the TPU kernel's rounding point of the
// probabilities. A fully masked row sees every logit near -1e9 and so
// gives the uniform mean of v, never NaN. bf16: one block of 4 warps per
// (batch, head, 64 queries), each warp 16 query rows; the logits of a
// 16x64 tile pass through a per-warp f32 scratch for the softmax. f32: one
// block of 4 warps per (batch, head, 16 queries), each warp 4 rows, lanes
// over keys for q.k and over Dh for p.v.
#include <mma.h>
#include <type_traits>

#include "common.cuh"

namespace {

constexpr int BQ = 16;   // queries per block
constexpr int BK = 64;   // keys per shared-memory tile
constexpr int NW = 4;    // warps per block
constexpr int R = BQ / NW;  // query rows per warp

template <typename T, int D>
__global__ void __launch_bounds__(NW * 32)
attn_kernel(const T* __restrict__ q, const T* __restrict__ k,
            const T* __restrict__ v, const float* __restrict__ mask,
            T* __restrict__ out, int Tq, int Tk, int H, float scale) {
  constexpr int DL = D / 32;  // output dims per lane
  __shared__ float Qs[BQ][D];
  __shared__ float Ks[BK][D + 1];
  __shared__ float Vs[BK][D + 1];
  __shared__ float Ps[NW][R][BK];
  __shared__ float Bs[BK];

  const int tid = threadIdx.x, warp = tid >> 5, lane = tid & 31;
  const int b = blockIdx.z, h = blockIdx.y, q0 = blockIdx.x * BQ;
  const size_t rs = (size_t)H * D;  // stride between time steps
  const T* qb = q + (size_t)b * Tq * rs + (size_t)h * D;
  const T* kb = k + (size_t)b * Tk * rs + (size_t)h * D;
  const T* vb = v + (size_t)b * Tk * rs + (size_t)h * D;

  for (int e = tid; e < BQ * D; e += NW * 32) {
    int r = e / D, d = e % D, qi = q0 + r;
    Qs[r][d] = qi < Tq ? stk::to_f(qb[(size_t)qi * rs + d]) : 0.0f;
  }

  auto load_tile = [&](int k0, bool with_v) {
    __syncthreads();  // the previous tile is no longer read
    for (int e = tid; e < BK * D; e += NW * 32) {
      int j = e / D, d = e % D, kj = k0 + j;
      bool ok = kj < Tk;
      Ks[j][d] = ok ? stk::to_f(kb[(size_t)kj * rs + d]) : 0.0f;
      if (with_v) Vs[j][d] = ok ? stk::to_f(vb[(size_t)kj * rs + d]) : 0.0f;
    }
    if (tid < BK) {
      int kj = k0 + tid;
      Bs[tid] = kj >= Tk ? -INFINITY
                : (mask ? (1.0f - mask[(size_t)b * Tk + kj]) * -1e9f : 0.0f);
    }
    __syncthreads();
  };

  // logits of this warp's R rows against key j of the current tile
  auto logits = [&](int j, float s[R]) {
#pragma unroll
    for (int r = 0; r < R; ++r) s[r] = 0.0f;
#pragma unroll 8
    for (int d = 0; d < D; ++d) {
      float kv = Ks[j][d];
#pragma unroll
      for (int r = 0; r < R; ++r) s[r] += Qs[warp * R + r][d] * kv;
    }
#pragma unroll
    for (int r = 0; r < R; ++r) s[r] = s[r] * scale + Bs[j];
  };

  // pass 1: running max and sum per row, per lane, then across the warp
  float m[R], l[R];
#pragma unroll
  for (int r = 0; r < R; ++r) { m[r] = -INFINITY; l[r] = 0.0f; }
  for (int k0 = 0; k0 < Tk; k0 += BK) {
    load_tile(k0, false);
#pragma unroll
    for (int jj = 0; jj < BK / 32; ++jj) {
      float s[R];
      logits(lane + 32 * jj, s);
#pragma unroll
      for (int r = 0; r < R; ++r) {
        if (s[r] == -INFINITY) continue;  // key past Tk
        if (s[r] > m[r]) { l[r] = l[r] * expf(m[r] - s[r]) + 1.0f; m[r] = s[r]; }
        else l[r] += expf(s[r] - m[r]);
      }
    }
  }
#pragma unroll
  for (int r = 0; r < R; ++r) {
    float mx = stk::warp_max(m[r]);
    float part = m[r] == -INFINITY ? 0.0f : l[r] * expf(m[r] - mx);
    l[r] = stk::warp_sum(part);
    m[r] = mx;
  }

  // pass 2: probabilities rounded to v's type, accumulate p * v in f32
  float acc[R][DL];
#pragma unroll
  for (int r = 0; r < R; ++r)
#pragma unroll
    for (int t = 0; t < DL; ++t) acc[r][t] = 0.0f;
  for (int k0 = 0; k0 < Tk; k0 += BK) {
    load_tile(k0, true);
#pragma unroll
    for (int jj = 0; jj < BK / 32; ++jj) {
      int j = lane + 32 * jj;
      float s[R];
      logits(j, s);
#pragma unroll
      for (int r = 0; r < R; ++r)
        Ps[warp][r][j] = s[r] == -INFINITY ? 0.0f
                         : stk::rnd<T>(expf(s[r] - m[r]) / l[r]);
    }
    __syncwarp();
    for (int j = 0; j < BK; ++j) {
#pragma unroll
      for (int t = 0; t < DL; ++t) {
        float vv = Vs[j][lane + 32 * t];
#pragma unroll
        for (int r = 0; r < R; ++r) acc[r][t] += Ps[warp][r][j] * vv;
      }
    }
    __syncwarp();
  }

  T* ob = out + (size_t)b * Tq * rs + (size_t)h * D;
#pragma unroll
  for (int r = 0; r < R; ++r) {
    int qi = q0 + warp * R + r;
    if (qi >= Tq) continue;
#pragma unroll
    for (int t = 0; t < DL; ++t)
      ob[(size_t)qi * rs + lane + 32 * t] = stk::from_f<T>(acc[r][t]);
  }
}


// ---------------------------------------------------------------------------
// bf16 on the tensor cores
// ---------------------------------------------------------------------------
using bf16 = __nv_bfloat16;
constexpr int WQ = 64;          // queries per block (16 per warp)
constexpr int LD = 64 + 8;      // bf16 row stride of the Q/K/V/P tiles
constexpr int LDS = 64 + 4;     // f32 row stride of the logit scratch

struct WmmaSmem {
  bf16 q[WQ][LD];
  bf16 k[BK][LD];
  bf16 v[BK][LD];
  bf16 p[NW][16][LD];
  float s[NW][16][LDS];
  float bias[BK];
};

__global__ void __launch_bounds__(NW * 32)
attn_wmma(const bf16* __restrict__ q, const bf16* __restrict__ k,
          const bf16* __restrict__ v, const float* __restrict__ mask,
          bf16* __restrict__ out, int Tq, int Tk, int H, float scale) {
  using namespace nvcuda;
  constexpr int D = 64;
  extern __shared__ __align__(128) unsigned char raw[];
  WmmaSmem& sm = *reinterpret_cast<WmmaSmem*>(raw);
  const int tid = threadIdx.x, warp = tid >> 5, lane = tid & 31;
  const int b = blockIdx.z, h = blockIdx.y, q0 = blockIdx.x * WQ;
  const size_t rs = (size_t)H * D;
  const bf16* qb = q + (size_t)b * Tq * rs + (size_t)h * D;
  const bf16* kb = k + (size_t)b * Tk * rs + (size_t)h * D;
  const bf16* vb = v + (size_t)b * Tk * rs + (size_t)h * D;
  const uint4 zero = make_uint4(0, 0, 0, 0);

  // rows of 64 bf16 = 8 chunks of 16 bytes
  for (int c = tid; c < WQ * 8; c += NW * 32) {
    int r = c / 8, dc = (c % 8) * 8, qi = q0 + r;
    *reinterpret_cast<uint4*>(&sm.q[r][dc]) =
        qi < Tq ? *reinterpret_cast<const uint4*>(qb + (size_t)qi * rs + dc) : zero;
  }
  auto load_tile = [&](int k0, bool with_v) {
    __syncthreads();  // the previous tile is no longer read
    for (int c = tid; c < BK * 8; c += NW * 32) {
      int j = c / 8, dc = (c % 8) * 8, kj = k0 + j;
      bool ok = kj < Tk;
      *reinterpret_cast<uint4*>(&sm.k[j][dc]) =
          ok ? *reinterpret_cast<const uint4*>(kb + (size_t)kj * rs + dc) : zero;
      if (with_v)
        *reinterpret_cast<uint4*>(&sm.v[j][dc]) =
            ok ? *reinterpret_cast<const uint4*>(vb + (size_t)kj * rs + dc) : zero;
    }
    if (tid < BK) {
      int kj = k0 + tid;
      sm.bias[tid] = kj >= Tk ? -INFINITY
                     : (mask ? (1.0f - mask[(size_t)b * Tk + kj]) * -1e9f : 0.0f);
    }
    __syncthreads();
  };
  // this warp's 16 x 64 logits of the current tile -> sm.s[warp]
  auto logits = [&]() {
    wmma::fragment<wmma::accumulator, 16, 16, 16, float> acc[4];
#pragma unroll
    for (int n = 0; n < 4; ++n) wmma::fill_fragment(acc[n], 0.0f);
#pragma unroll
    for (int kk = 0; kk < D; kk += 16) {
      wmma::fragment<wmma::matrix_a, 16, 16, 16, bf16, wmma::row_major> a;
      wmma::load_matrix_sync(a, &sm.q[warp * 16][kk], LD);
#pragma unroll
      for (int n = 0; n < 4; ++n) {
        wmma::fragment<wmma::matrix_b, 16, 16, 16, bf16, wmma::col_major> bk;
        wmma::load_matrix_sync(bk, &sm.k[n * 16][kk], LD);
        wmma::mma_sync(acc[n], a, bk, acc[n]);
      }
    }
#pragma unroll
    for (int n = 0; n < 4; ++n)
      wmma::store_matrix_sync(&sm.s[warp][0][n * 16], acc[n], LDS, wmma::mem_row_major);
    __syncwarp();
  };

  // lanes l and l ^ 16 own row l & 15, one half of its 64 keys each; the
  // column order is skewed per lane so that the 32 lanes hit 32 banks
  const int row = lane & 15, half = lane >> 4, skew = (row >> 3) + 2 * half;
  auto col = [&](int i) { return half * 32 + ((i + skew) & 31); };
  float m = -INFINITY, l = 0.0f;
  for (int k0 = 0; k0 < Tk; k0 += BK) {
    load_tile(k0, false);
    logits();
    float xs[32], tmax = -INFINITY;
#pragma unroll
    for (int i = 0; i < 32; ++i) {
      int c = col(i);
      xs[i] = sm.s[warp][row][c] * scale + sm.bias[c];
      tmax = fmaxf(tmax, xs[i]);
    }
    tmax = fmaxf(tmax, __shfl_xor_sync(0xffffffffu, tmax, 16));
    const float mn = fmaxf(m, tmax);  // finite: a tile holds a key < Tk
    float part = 0.0f;
#pragma unroll
    for (int i = 0; i < 32; ++i)
      if (xs[i] != -INFINITY) part += expf(xs[i] - mn);
    part += __shfl_xor_sync(0xffffffffu, part, 16);
    l = (m == -INFINITY ? 0.0f : l * expf(m - mn)) + part;
    m = mn;
    __syncwarp();
  }

  wmma::fragment<wmma::accumulator, 16, 16, 16, float> o[4];
#pragma unroll
  for (int n = 0; n < 4; ++n) wmma::fill_fragment(o[n], 0.0f);
  for (int k0 = 0; k0 < Tk; k0 += BK) {
    load_tile(k0, true);
    logits();
#pragma unroll
    for (int i = 0; i < 32; ++i) {
      int c = col(i);
      float x = sm.s[warp][row][c] * scale + sm.bias[c];
      sm.p[warp][row][c] = __float2bfloat16(x == -INFINITY ? 0.0f : expf(x - m) / l);
    }
    __syncwarp();
#pragma unroll
    for (int kk = 0; kk < BK; kk += 16) {
      wmma::fragment<wmma::matrix_a, 16, 16, 16, bf16, wmma::row_major> a;
      wmma::load_matrix_sync(a, &sm.p[warp][0][kk], LD);
#pragma unroll
      for (int n = 0; n < 4; ++n) {
        wmma::fragment<wmma::matrix_b, 16, 16, 16, bf16, wmma::row_major> bv;
        wmma::load_matrix_sync(bv, &sm.v[kk][n * 16], LD);
        wmma::mma_sync(o[n], a, bv, o[n]);
      }
    }
    __syncwarp();
  }
#pragma unroll
  for (int n = 0; n < 4; ++n)
    wmma::store_matrix_sync(&sm.s[warp][0][n * 16], o[n], LDS, wmma::mem_row_major);
  __syncwarp();
  bf16* ob = out + (size_t)b * Tq * rs + (size_t)h * D;
  const int qi = q0 + warp * 16 + row;
  if (qi < Tq)
    for (int c = half * 32; c < half * 32 + 32; ++c)
      ob[(size_t)qi * rs + c] = __float2bfloat16(sm.s[warp][row][c]);
}

template <typename T>
int launch(const void* q, const void* k, const void* v, const float* mask,
           void* out, int B, int Tq, int Tk, int H, int D, cudaStream_t st) {
  if (D != 64) return (int)cudaErrorInvalidValue;
  const float scale = 1.0f / sqrtf((float)D);
  if constexpr (std::is_same<T, bf16>::value) {
    static bool configured = false;
    if (!configured) {
      int err = (int)cudaFuncSetAttribute(attn_wmma,
                                          cudaFuncAttributeMaxDynamicSharedMemorySize,
                                          (int)sizeof(WmmaSmem));
      if (err) return err;
      configured = true;
    }
    dim3 grid((Tq + WQ - 1) / WQ, H, B);
    attn_wmma<<<grid, NW * 32, sizeof(WmmaSmem), st>>>(
        (const bf16*)q, (const bf16*)k, (const bf16*)v, mask, (bf16*)out, Tq, Tk, H,
        scale);
  } else {
    dim3 grid((Tq + BQ - 1) / BQ, H, B);
    attn_kernel<T, 64><<<grid, NW * 32, 0, st>>>(
        (const T*)q, (const T*)k, (const T*)v, mask, (T*)out, Tq, Tk, H, scale);
  }
  return (int)cudaGetLastError();
}

}  // namespace

// q [B,Tq,H,D], k/v [B,Tk,H,D], out [B,Tq,H,D], contiguous, of one storage
// type (dtype 0 = float, 1 = bfloat16); mask [B,Tk] float or null.
extern "C" int stk_attention(const void* q, const void* k, const void* v,
                             const void* mask, void* out, int B, int Tq, int Tk,
                             int H, int D, int dtype, void* stream) {
  cudaStream_t st = (cudaStream_t)stream;
  const float* m = (const float*)mask;
  if (dtype == 0) return launch<float>(q, k, v, m, out, B, Tq, Tk, H, D, st);
  if (dtype == 1) return launch<__nv_bfloat16>(q, k, v, m, out, B, Tq, Tk, H, D, st);
  return (int)cudaErrorInvalidValue;
}
