// Not on the path: the mma.sync design that csrc/ffn.cu replaced, kept whole so
// that kernel_variants.py can build it as its "earlier" variant (the
// package builds csrc/*.cu only).
//
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
// Bound on the H100: 4*N*D*F operations against (2*N*D + 2*D*F) elements:
// 172 GFLOP for the path's 40,960 rows at D=512, F=2048, 0.174 ms at the
// 989 TFLOP/s of the bf16 tensor cores, against 0.03 ms for the bytes.
// So the design is about keeping the tensor cores fed.
//
// bf16 design, three launches:
// (1) ln_mod: one warp a row computes the row's LN statistics once, applies
//     normalise, affine and modulation once per element with ln g/b and the
//     row's scale/shift held in registers (the batch index is one division a
//     row), and writes the modulated, rounded h [N, D] (42 MB at the path's
//     shape, ~0.03 ms).
// (2) a GEMM with the UpEpi epilogue: mid [N, F] = silu(h . W1^T + b1).
// (3) a GEMM with the DownEpi epilogue: out = x + gate * (mid . W2^T + b2).
// Both run the tensor-core GEMM of csrc/mma_gemm.cuh on mma.sync.m16n8k16
// (bf16 -> f32) with its epilogue on 8 columns a lane, 16-byte stores: bias
// and silu for (2); bias, gate and residual for (3). Tiles: 128 x 128, 8
// warps of 64 x 32, two blocks an SM (~123 registers a thread, no spills),
// so one block's ring fill and epilogue overlap the other's products; that
// measured faster than 64 x 64 warp tiles (8 warps of a 128 x 256 tile, or
// 4 of a 128 x 128 tile, at ~208 registers). W1 and W2 (2 MB each) stay in
// L2; the intermediate passes through device memory (2 * 168 MB, ~0.1 ms
// at 3.35 TB/s).
//
// The alternative, one launch with the intermediate on chip (ffn_fused
// below, selected by MID_ON_CHIP), keeps a 64-row block's [64, 512] f32
// output accumulator in registers across all of F, GEMM1's chunk output in
// shared memory as GEMM2's A operand; every block then streams all of W1
// and W2 from L2 (2.6 GB per launch at the path's shape) through 32 x 32
// warp tiles for GEMM1. It measured ~1.3x the time of the kept design
// (kernel_variants.py, PERF.md).
//
// f32: SIMT tiles on the float units (64x64 tiles, 4x4 per thread), two
// launches, exact to f32 rounding: the reference for the f32 whole path.
//
// Weights are in torch's linear layout: W1 [F, D], W2 [D, F] (each row one
// output channel), so both products read A and B along K.
#include "mma_gemm.cuh"

namespace {

using bf16 = __nv_bfloat16;
using stk::load8;

// ---------------------------------------------------------------------------
// f32 on the SIMT units. C tile = A . B^T over K, A from load_a(row, r, k),
// B rows along K from b_rows[n * K + k]; epilogue(row, col, acc) stores.
// ---------------------------------------------------------------------------
constexpr int NT = 256;
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

__global__ void __launch_bounds__(NT)
ffn_up_f32(const float* __restrict__ x, const float* __restrict__ ln_g,
           const float* __restrict__ ln_b, const float* __restrict__ w1,
           const float* __restrict__ b1, const float* __restrict__ shift,
           const float* __restrict__ scale, float* __restrict__ mid, int N, int Tlen,
           int D, int F, float eps) {
  __shared__ float s_mean[SBM], s_rstd[SBM];
  const int m0 = blockIdx.y * SBM, n0 = blockIdx.x * SBN;
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  for (int r = warp; r < SBM; r += NT / 32) {
    int row = m0 + r;
    float mean = 0.0f, rstd = 0.0f;
    if (row < N) {
      const float* xr = x + (size_t)row * D;
      float s = 0.0f;
      for (int k = lane; k < D; k += 32) s += xr[k];
      mean = stk::warp_sum(s) / D;
      float v = 0.0f;
      for (int k = lane; k < D; k += 32) { float c = xr[k] - mean; v += c * c; }
      rstd = 1.0f / sqrtf(stk::warp_sum(v) / D + eps);
    }
    if (lane == 0) { s_mean[r] = mean; s_rstd[r] = rstd; }
  }
  __syncthreads();
  auto load_a = [&](int row, int r, int k) {
    const size_t bk = (size_t)(row / Tlen) * D + k;
    float h = (x[(size_t)row * D + k] - s_mean[r]) * s_rstd[r];
    h = h * ln_g[k] + ln_b[k];
    return h * (1.0f + scale[bk]) + shift[bk];
  };
  auto epi = [&](int row, int col, float acc) {
    mid[(size_t)row * F + col] = stk::silu_f(acc + b1[col]);
  };
  gemm_simt(m0, n0, N, D, w1, load_a, epi);
}

__global__ void __launch_bounds__(NT)
ffn_down_f32(const float* __restrict__ x, const float* __restrict__ mid,
             const float* __restrict__ w2, const float* __restrict__ b2,
             const float* __restrict__ gate, float* __restrict__ out, int N, int Tlen,
             int D, int F) {
  const int m0 = blockIdx.y * SBM, n0 = blockIdx.x * SBN;
  auto epi = [&](int row, int col, float acc) {
    const int bi = row / Tlen;
    size_t i = (size_t)row * D + col;
    out[i] = x[i] + gate[(size_t)bi * D + col] * (acc + b2[col]);
  };
  auto load_a = [&](int row, int, int k) { return mid[(size_t)row * F + k]; };
  gemm_simt(m0, n0, N, F, w2, load_a, epi);
}

int launch_f32(const float* x, const float* g, const float* b, const float* w1,
               const float* b1, const float* w2, const float* b2, const float* shift,
               const float* scale, const float* gate, float* mid, float* out, int B,
               int Tlen, int D, int F, float eps, cudaStream_t st) {
  if (D % SBN || F % SBN) return (int)cudaErrorInvalidValue;
  const int N = B * Tlen;
  dim3 up(F / SBN, (N + SBM - 1) / SBM), down(D / SBN, (N + SBM - 1) / SBM);
  ffn_up_f32<<<up, NT, 0, st>>>(x, g, b, w1, b1, shift, scale, mid, N, Tlen, D, F, eps);
  int err = (int)cudaGetLastError();
  if (err) return err;
  ffn_down_f32<<<down, NT, 0, st>>>(x, mid, w2, b2, gate, out, N, Tlen, D, F);
  return (int)cudaGetLastError();
}

// ---------------------------------------------------------------------------
// bf16 on the tensor cores
// ---------------------------------------------------------------------------
// the intermediate through device memory (false: three launches) or on chip
// (true: ln_mod and one ffn_fused launch, D = 512 only); kernel_variants.py
// builds the other
constexpr bool MID_ON_CHIP = false;

__device__ __forceinline__ void unpack8(const uint4& raw, float v[8]) {
  const __nv_bfloat162* h = reinterpret_cast<const __nv_bfloat162*>(&raw);
#pragma unroll
  for (int e = 0; e < 4; ++e) {
    const float2 f = __bfloat1622float2(h[e]);
    v[2 * e] = f.x;
    v[2 * e + 1] = f.y;
  }
}

// (1) h = bf16(mod(LN(x))). One warp a row, each lane CPL 16-byte chunks
// (chunk lane + 32 i) of a row of D = 8 * nc values, D <= 256 * CPL; each
// warp a contiguous run of rows, so the row's scale/shift reload only when
// the batch index changes.
constexpr int LN_NT = 256;

template <int CPL>
__global__ void __launch_bounds__(LN_NT)
ln_mod(const bf16* __restrict__ x, const float* __restrict__ ln_g,
       const float* __restrict__ ln_b, const float* __restrict__ shift,
       const float* __restrict__ scale, bf16* __restrict__ h, int N, int Tlen, int D,
       int rows_per_warp, float eps) {
  const int lane = threadIdx.x & 31;
  const int r0 = (blockIdx.x * (LN_NT / 32) + (threadIdx.x >> 5)) * rows_per_warp;
  const int r1 = min(N, r0 + rows_per_warp);
  const int nc = D / 8;
  float g[CPL][8], b[CPL][8], sc1[CPL][8], sh[CPL][8];
#pragma unroll
  for (int i = 0; i < CPL; ++i) {
    const int c = lane + 32 * i;
    if (c < nc) {
      load8(ln_g + c * 8, g[i]);
      load8(ln_b + c * 8, b[i]);
    }
  }
  int cur_b = -1;
  for (int row = r0; row < r1; ++row) {
    const int bi = row / Tlen;
    if (bi != cur_b) {
      cur_b = bi;
#pragma unroll
      for (int i = 0; i < CPL; ++i) {
        const int c = lane + 32 * i;
        if (c < nc) {
          load8(scale + (size_t)bi * D + c * 8, sc1[i]);
          load8(shift + (size_t)bi * D + c * 8, sh[i]);
#pragma unroll
          for (int e = 0; e < 8; ++e) sc1[i][e] = 1.0f + sc1[i][e];
        }
      }
    }
    const bf16* xr = x + (size_t)row * D;
    float v[CPL][8];
    float s = 0.0f;
#pragma unroll
    for (int i = 0; i < CPL; ++i) {
      const int c = lane + 32 * i;
      if (c < nc) {
        unpack8(*reinterpret_cast<const uint4*>(xr + c * 8), v[i]);
#pragma unroll
        for (int e = 0; e < 8; ++e) s += v[i][e];
      }
    }
    const float mean = stk::warp_sum(s) / D;
    float q = 0.0f;
#pragma unroll
    for (int i = 0; i < CPL; ++i)
      if (lane + 32 * i < nc)
#pragma unroll
        for (int e = 0; e < 8; ++e) {
          v[i][e] -= mean;
          q += v[i][e] * v[i][e];
        }
    const float rstd = 1.0f / sqrtf(stk::warp_sum(q) / D + eps);
#pragma unroll
    for (int i = 0; i < CPL; ++i) {
      const int c = lane + 32 * i;
      if (c >= nc) continue;
      uint4 o;
      uint32_t* p = reinterpret_cast<uint32_t*>(&o);
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        float hv[2];
#pragma unroll
        for (int u = 0; u < 2; ++u) {
          const int k = 2 * e + u;
          hv[u] = (v[i][k] * rstd) * g[i][k] + b[i][k];
          hv[u] = hv[u] * sc1[i][k] + sh[i][k];
        }
        p[e] = stk::pack_bf16(hv[0], hv[1]);
      }
      *reinterpret_cast<uint4*>(h + (size_t)row * D + c * 8) = o;
    }
  }
}

// (2), (3): mma_gemm (csrc/mma_gemm.cuh) over 128 x 128 block tiles of 8
// warps of 64 x 32, a 3-stage ring, two blocks an SM; kernel_variants.py
// times the 64 x 64 warp tiles it replaced.
using GemmTile = stk::GemmShape<128, 128, 64, 32, 3, 2>;  // BM, BN, WM, WN, stages, blocks/SM

// (2): mid = bf16(silu(acc + b1))
struct UpEpi {
  const float* b1;
  bf16* mid;
  int F;
  __device__ __forceinline__ void operator()(int row, int col, const float v[8]) const {
    float bv[8];
    load8(b1 + col, bv);
    uint4 o;
    uint32_t* p = reinterpret_cast<uint32_t*>(&o);
#pragma unroll
    for (int e = 0; e < 4; ++e)
      p[e] = stk::pack_bf16(stk::silu_fast(v[2 * e] + bv[2 * e]),
                            stk::silu_fast(v[2 * e + 1] + bv[2 * e + 1]));
    *reinterpret_cast<uint4*>(mid + (size_t)row * F + col) = o;
  }
};

// (3): out = bf16(x + gate[batch] * (acc + b2))
struct DownEpi {
  const bf16* x;
  const float* b2;
  const float* gate;
  bf16* out;
  int D, Tlen;
  __device__ __forceinline__ void operator()(int row, int col, const float v[8]) const {
    const size_t i = (size_t)row * D + col;
    float xv[8], gv[8], bv[8];
    unpack8(*reinterpret_cast<const uint4*>(x + i), xv);
    load8(gate + (size_t)(row / Tlen) * D + col, gv);
    load8(b2 + col, bv);
    uint4 o;
    uint32_t* p = reinterpret_cast<uint32_t*>(&o);
#pragma unroll
    for (int e = 0; e < 4; ++e)
      p[e] = stk::pack_bf16(xv[2 * e] + gv[2 * e] * (v[2 * e] + bv[2 * e]),
                            xv[2 * e + 1] + gv[2 * e + 1] * (v[2 * e + 1] + bv[2 * e + 1]));
    *reinterpret_cast<uint4*>(out + i) = o;
  }
};

// The rejected design: one launch per 64 rows with the intermediate on chip.
// Shared memory: the block's modulated h panel [64, 512] (swizzled rows) |
// a 2-stage ring of 64 KB stages | P [64, FC], silu(GEMM1 chunk) in bf16.
// Per F chunk of FC = 128: two stages of W1 (its FC rows, K halves of 256),
// then two of W2 (all 512 rows, the chunk's K in halves of 64). GEMM1's
// chunk [64, 128] runs on 2 x 4 warps of 32 x 32; GEMM2 accumulates
// [64, 512] in registers, 8 warps of 64 x 64 columns.
constexpr int FBM = 64, FD = 512, FC = 128;
constexpr int FSTAGE = 128 * 256;  // elements: [128, 256] of W1 or [512, 64] of W2
constexpr int FUSED_SMEM = (FBM * FD + 2 * FSTAGE + FBM * FC) * (int)sizeof(bf16);

constexpr int FNT = 256;  // 8 warps

template <int D_>
__global__ void __launch_bounds__(FNT, 1)
ffn_fused(const bf16* __restrict__ h, const bf16* __restrict__ x, const bf16* __restrict__ w1,
          const float* __restrict__ b1, const bf16* __restrict__ w2,
          const float* __restrict__ b2, const float* __restrict__ gate,
          bf16* __restrict__ out, int N, int Tlen, int F) {
  static_assert(D_ == FD, "the on-chip variant is laid out for D = 512");
  extern __shared__ __align__(128) unsigned char smem_raw[];
  bf16* panel = reinterpret_cast<bf16*>(smem_raw);
  bf16* ring = panel + FBM * FD;
  bf16* P = ring + 2 * FSTAGE;
  const int tid = threadIdx.x, warp = tid >> 5, lane = tid & 31;
  const int g = lane >> 2, t = lane & 3;
  const int m0 = blockIdx.x * FBM;
  const int steps = 4 * (F / FC);

  auto load = [&](int s) {
    const int c = s >> 2, part = s & 3;
    bf16* dst = ring + (s & 1) * FSTAGE;
    if (part < 2) {  // W1 rows [c FC, c FC + FC), k [part 256, part 256 + 256)
      for (int e = tid; e < FC * 32; e += FNT) {
        const int r = e >> 5, ch = e & 31;
        stk::cp_async16(stk::smem_u32(dst + stk::swz<256>(r, ch)),
                        w1 + (size_t)(c * FC + r) * FD + part * 256 + ch * 8, true);
      }
    } else {  // W2 rows [0, 512), k [c FC + (part - 2) 64, + 64)
      for (int e = tid; e < FD * 8; e += FNT) {
        const int r = e >> 3, ch = e & 7;
        stk::cp_async16(stk::smem_u32(dst + stk::swz<64>(r, ch)),
                        w2 + (size_t)r * F + c * FC + (part - 2) * 64 + ch * 8, true);
      }
    }
  };
  for (int e = tid; e < FBM * (FD / 8); e += FNT) {
    const int r = e / (FD / 8), ch = e % (FD / 8);
    const bool valid = m0 + r < N;
    stk::cp_async16(stk::smem_u32(panel + stk::swz<FD>(r, ch)),
                    valid ? h + (size_t)(m0 + r) * FD + ch * 8 : h, valid);
  }
  load(0);
  stk::cp_async_commit();

  const int wm1 = (warp >> 2) * 32, wn1 = (warp & 3) * 32;  // GEMM1 warp tile
  const int wn2 = warp * 64;                                 // GEMM2 warp columns
  float acc1[2][4][4] = {};
  float acc2[4][8][4] = {};
  for (int s = 0; s < steps; ++s) {
    stk::cp_async_wait<0>();
    __syncthreads();
    if (s + 1 < steps) load(s + 1);
    stk::cp_async_commit();
    const bf16* ws = ring + (s & 1) * FSTAGE;
    const int c = s >> 2, part = s & 3;
    if (part < 2) {
#pragma unroll 4
      for (int kk = 0; kk < 16; ++kk) {
        uint32_t a[2][4];
#pragma unroll
        for (int i = 0; i < 2; ++i)
          stk::ldmatrix_x4(a[i], stk::smem_u32(panel + stk::swz<FD>(wm1 + i * 16 + (lane & 15),
                                                                     part * 32 + kk * 2 +
                                                                         (lane >> 4))));
#pragma unroll
        for (int jp = 0; jp < 2; ++jp) {
          uint32_t b[4];
          stk::ldmatrix_x4(b, stk::smem_u32(ws + stk::swz<256>(wn1 + jp * 16 +
                                                                   ((lane >> 4) << 3) + (lane & 7),
                                                               kk * 2 + ((lane >> 3) & 1))));
#pragma unroll
          for (int i = 0; i < 2; ++i) {
            stk::mma_bf16(acc1[i][2 * jp], a[i], b[0], b[1]);
            stk::mma_bf16(acc1[i][2 * jp + 1], a[i], b[2], b[3]);
          }
        }
      }
      if (part == 1) {  // P = bf16(silu(acc1 + b1)); the next barrier publishes it
#pragma unroll
        for (int j = 0; j < 4; ++j) {
          const int col = wn1 + j * 8 + 2 * t;
          const float2 bv = *reinterpret_cast<const float2*>(b1 + c * FC + col);
#pragma unroll
          for (int i = 0; i < 2; ++i)
#pragma unroll
            for (int hh = 0; hh < 2; ++hh) {
              const int r = wm1 + i * 16 + g + 8 * hh;
              *reinterpret_cast<uint32_t*>(P + stk::swz<FC>(r, col >> 3) + (col & 7)) =
                  stk::pack_bf16(stk::silu_fast(acc1[i][j][2 * hh] + bv.x),
                                 stk::silu_fast(acc1[i][j][2 * hh + 1] + bv.y));
              acc1[i][j][2 * hh] = acc1[i][j][2 * hh + 1] = 0.0f;
            }
        }
      }
    } else {
#pragma unroll
      for (int kk = 0; kk < 4; ++kk) {
        uint32_t a[4][4];
#pragma unroll
        for (int i = 0; i < 4; ++i)
          stk::ldmatrix_x4(a[i], stk::smem_u32(P + stk::swz<FC>(i * 16 + (lane & 15),
                                                                 (part - 2) * 8 + kk * 2 +
                                                                     (lane >> 4))));
#pragma unroll
        for (int jp = 0; jp < 4; ++jp) {
          uint32_t b[4];
          stk::ldmatrix_x4(b, stk::smem_u32(ws + stk::swz<64>(wn2 + jp * 16 +
                                                                  ((lane >> 4) << 3) + (lane & 7),
                                                              kk * 2 + ((lane >> 3) & 1))));
#pragma unroll
          for (int i = 0; i < 4; ++i) {
            stk::mma_bf16(acc2[i][2 * jp], a[i], b[0], b[1]);
            stk::mma_bf16(acc2[i][2 * jp + 1], a[i], b[2], b[3]);
          }
        }
      }
    }
  }
  // out = bf16(x + gate * (acc2 + b2)), two columns a store
#pragma unroll
  for (int j = 0; j < 8; ++j) {
    const int col = wn2 + j * 8 + 2 * t;
    const float2 bv = *reinterpret_cast<const float2*>(b2 + col);
#pragma unroll
    for (int i = 0; i < 4; ++i)
#pragma unroll
      for (int hh = 0; hh < 2; ++hh) {
        const int row = m0 + i * 16 + g + 8 * hh;
        if (row >= N) continue;
        const size_t at = (size_t)row * FD + col;
        const float2 xv = __bfloat1622float2(*reinterpret_cast<const __nv_bfloat162*>(x + at));
        const float2 gv = *reinterpret_cast<const float2*>(gate + (size_t)(row / Tlen) * FD + col);
        *reinterpret_cast<uint32_t*>(out + at) =
            stk::pack_bf16(xv.x + gv.x * (acc2[i][j][2 * hh] + bv.x),
                           xv.y + gv.y * (acc2[i][j][2 * hh + 1] + bv.y));
      }
  }
}

int launch_ln(const bf16* x, const float* g, const float* b, const float* shift,
              const float* scale, bf16* h, int N, int Tlen, int D, float eps,
              cudaStream_t st) {
  const int warps = 132 * 2 * (LN_NT / 32);  // two blocks an SM
  const int rows_per_warp = (N + warps - 1) / warps;
  const int blocks = (N + rows_per_warp * (LN_NT / 32) - 1) / (rows_per_warp * (LN_NT / 32));
  const int cpl = (D / 8 + 31) / 32;
#define STK_LN(C)                                                                        \
  ln_mod<C><<<blocks, LN_NT, 0, st>>>(x, g, b, shift, scale, h, N, Tlen, D, rows_per_warp, \
                                      eps)
  if (cpl == 1) STK_LN(1);
  else if (cpl == 2) STK_LN(2);
  else if (cpl == 3) STK_LN(3);
  else if (cpl == 4) STK_LN(4);
  else return (int)cudaErrorInvalidValue;
#undef STK_LN
  return (int)cudaGetLastError();
}

// a template, so that only the design chosen by MID_ON_CHIP is compiled
template <bool ON_CHIP>
int launch_bf16(const bf16* x, const float* g, const float* b, const bf16* w1,
                const float* b1, const bf16* w2, const float* b2, const float* shift,
                const float* scale, const float* gate, bf16* h, bf16* mid, bf16* out,
                int B, int Tlen, int D, int F, float eps, cudaStream_t st) {
  if (D % 64 || F % 64 || D > 4 * 256) return (int)cudaErrorInvalidValue;
  const int N = B * Tlen;
  if (int err = launch_ln(x, g, b, shift, scale, h, N, Tlen, D, eps, st)) return err;
  if constexpr (ON_CHIP) {
    if (D != FD || F % FC) return (int)cudaErrorInvalidValue;
    static size_t smem_set[stk::kMaxDevices] = {};
    if (int err = stk::allow_dynamic_smem(ffn_fused<FD>, FUSED_SMEM, smem_set)) return err;
    ffn_fused<FD><<<(N + FBM - 1) / FBM, FNT, FUSED_SMEM, st>>>(h, x, w1, b1, w2, b2, gate,
                                                                out, N, Tlen, F);
    return (int)cudaGetLastError();
  } else {
    using stk::MmaBf16;
    if (int err = stk::launch_mma_gemm<MmaBf16, GemmTile>(h, w1, N, F, D, UpEpi{b1, mid, F}, st))
      return err;
    return stk::launch_mma_gemm<MmaBf16, GemmTile>(mid, w2, N, D, F,
                                                   DownEpi{x, b2, gate, out, D, Tlen}, st);
  }
}

}  // namespace

// x/out [B,T,D]; w1 [F,D]; w2 [D,F] (storage type: dtype 0 float, 1 bf16);
// ln g/b [D], b1 [F], b2 [D], shift/scale/gate [B,D] float; scratch: mid
// [B*T,F] in the storage type, and for bf16 h [B*T,D] bf16. All contiguous
// and 16-byte aligned; D and F multiples of 128 (bf16: D <= 1024).
extern "C" int stk_adaln_ffn(const void* x, const void* g, const void* b,
                             const void* w1, const void* b1, const void* w2,
                             const void* b2, const void* shift, const void* scale,
                             const void* gate, void* h, void* mid, void* out, int B,
                             int Tlen, int D, int F, float eps, int dtype,
                             void* stream) {
  cudaStream_t st = (cudaStream_t)stream;
  auto f = [](const void* p) { return (const float*)p; };
  if (B < 1 || Tlen < 1) return (int)cudaErrorInvalidValue;
  if (dtype == 0)
    return launch_f32(f(x), f(g), f(b), f(w1), f(b1), f(w2), f(b2), f(shift), f(scale),
                      f(gate), (float*)mid, (float*)out, B, Tlen, D, F, eps, st);
  if (dtype == 1)
    return launch_bf16<MID_ON_CHIP>((const bf16*)x, f(g), f(b), (const bf16*)w1, f(b1),
                                    (const bf16*)w2, f(b2), f(shift), f(scale), f(gate),
                                    (bf16*)h, (bf16*)mid, (bf16*)out, B, Tlen, D, F, eps, st);
  return (int)cudaErrorInvalidValue;
}
