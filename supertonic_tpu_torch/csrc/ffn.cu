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
// 120 GFLOP for the path's 28,672 rows at D=512, F=2048, 0.122 ms at the
// 989 TFLOP/s of the bf16 tensor cores, against ~0.02 ms for the bytes.
// So the design is about keeping the tensor cores fed, which on Hopper
// takes wgmma fed by TMA.
//
// bf16 design, three launches:
// (1) ln_mod: one warp a row computes the row's LN statistics once, applies
//     normalise, affine and modulation once per element with ln g/b and the
//     row's scale/shift held in registers (the batch index is one division a
//     row), and writes the modulated, rounded h [N, D].
// (2) a GEMM with the UpEpi epilogue: mid [N, F] = silu(h . W1^T + b1).
// (3) a GEMM with the DownEpi epilogue: out = x + gate * (mid . W2^T + b2).
// Both run the warp-specialised GEMM of csrc/wgmma_gemm.cuh: a producer
// warpgroup streams 64-element K slices of h (or mid) and W1 (or W2), both
// K-major as torch's linear layout keeps them, by TMA into a ring of
// 128-byte-swizzled stages behind full/empty mbarriers; two consumer
// warpgroups take turns over whole tiles (persistent blocks), each running
// wgmma.m64nNk16 from shared memory and its epilogue straight from the
// accumulator registers while the other's products run: bias and silu for
// (2); bias, gate (chosen by each row's batch index) and residual for (3);
// the bf16 results leave through shared memory by TMA stores. W1 and W2
// (2 MB each) stay in L2; the intermediate passes through device memory.
// The epilogues must stay shorter than the other consumer's products,
// hence silu on the SFU's bare instructions (silu_epi).
// The modulation vectors are read in bf16 as the path gives them, or f32.
// The mma.sync design this replaces (csrc/earlier/ffn_mma_sync.cu, with
// csrc/mma_gemm.cuh) and the one-launch design with the intermediate on
// chip that measured ~1.3x slower live there, for kernel_variants.py.
//
// f32: SIMT tiles on the float units (64x64 tiles, 4x4 per thread), two
// launches, exact to f32 rounding: the reference for the f32 whole path.
//
// Widths: D and F in multiples of 8 (bf16: D <= 1024, the LayerNorm pass's
// row in one warp's registers). In bf16, K and N tails come from TMA's zero
// fill on the loads, and stores past N are clipped by the TMA store or
// masked in the epilogue (csrc/wgmma_gemm.cuh). In f32 a width that is not
// a multiple of the SIMT tile runs the TAIL instance, which guards its
// loads and stores; D = 512, F = 2048 run the unguarded one.
//
// Weights are in torch's linear layout: W1 [F, D], W2 [D, F] (each row one
// output channel), so both products read A and B along K.
#include "wgmma_gemm.cuh"

namespace {

using bf16 = __nv_bfloat16;

__device__ __forceinline__ void load8(const float* p, float v[8]) {
  const float4 lo = *reinterpret_cast<const float4*>(p);
  const float4 hi = *reinterpret_cast<const float4*>(p + 4);
  v[0] = lo.x; v[1] = lo.y; v[2] = lo.z; v[3] = lo.w;
  v[4] = hi.x; v[5] = hi.y; v[6] = hi.z; v[7] = hi.w;
}

// ---------------------------------------------------------------------------
// f32 on the SIMT units. C tile = A . B^T over K, A from load_a(row, r, k),
// B rows along K from b_rows[n * K + k]; epilogue(row, col, acc) stores.
// ---------------------------------------------------------------------------
constexpr int NT = 256;
constexpr int SBM = 64, SBN = 64, SBK = 16;

// N rows of A, `cols` rows of B (columns of C); TAIL guards K and cols,
// which are otherwise multiples of SBK and SBN.
template <bool TAIL, typename LoadA, typename Epi>
__device__ __forceinline__ void gemm_simt(int m0, int n0, int N, int K, int cols,
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
      const bool k_ok = !TAIL || k0 + kk < K;
      As[kk][r] = m0 + r < N && k_ok ? load_a(m0 + r, r, k0 + kk) : 0.0f;
      Bs[kk][r] = !TAIL || (k_ok && n0 + r < cols) ? b_rows[(size_t)(n0 + r) * K + k0 + kk]
                                                   : 0.0f;
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
    for (int j = 0; j < 4; ++j)
      if (!TAIL || n0 + tx * 4 + j < cols) epilogue(row, n0 + tx * 4 + j, acc[i][j]);
  }
}

template <bool TAIL>
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
  gemm_simt<TAIL>(m0, n0, N, D, F, w1, load_a, epi);
}

template <bool TAIL>
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
  gemm_simt<TAIL>(m0, n0, N, F, D, w2, load_a, epi);
}

int launch_f32(const float* x, const float* g, const float* b, const float* w1,
               const float* b1, const float* w2, const float* b2, const float* shift,
               const float* scale, const float* gate, float* mid, float* out, int B,
               int Tlen, int D, int F, float eps, cudaStream_t st) {
  if (D % 8 || F % 8) return (int)cudaErrorInvalidValue;
  const int N = B * Tlen;
  dim3 up((F + SBN - 1) / SBN, (N + SBM - 1) / SBM), down((D + SBN - 1) / SBN, (N + SBM - 1) / SBM);
  const bool tail = D % SBN || F % SBN;  // SBK divides SBN
  if (tail) ffn_up_f32<true><<<up, NT, 0, st>>>(x, g, b, w1, b1, shift, scale, mid, N, Tlen, D, F, eps);
  else ffn_up_f32<false><<<up, NT, 0, st>>>(x, g, b, w1, b1, shift, scale, mid, N, Tlen, D, F, eps);
  int err = (int)cudaGetLastError();
  if (err) return err;
  if (tail) ffn_down_f32<true><<<down, NT, 0, st>>>(x, mid, w2, b2, gate, out, N, Tlen, D, F);
  else ffn_down_f32<false><<<down, NT, 0, st>>>(x, mid, w2, b2, gate, out, N, Tlen, D, F);
  return (int)cudaGetLastError();
}

// ---------------------------------------------------------------------------
// bf16 on the tensor cores
// ---------------------------------------------------------------------------
__device__ __forceinline__ void unpack8(const uint4& raw, float v[8]) {
  const __nv_bfloat162* h = reinterpret_cast<const __nv_bfloat162*>(&raw);
#pragma unroll
  for (int e = 0; e < 4; ++e) {
    const float2 f = __bfloat1622float2(h[e]);
    v[2 * e] = f.x;
    v[2 * e + 1] = f.y;
  }
}

__device__ __forceinline__ void load8(const bf16* p, float v[8]) {
  unpack8(*reinterpret_cast<const uint4*>(p), v);
}

// (1) h = bf16(mod(LN(x))). One warp a row, each lane CPL 16-byte chunks
// (chunk lane + 32 i) of a row of D = 8 * nc values, D <= 256 * CPL; each
// warp a contiguous run of rows, so the row's scale/shift reload only when
// the batch index changes.
constexpr int LN_NT = 256;

template <int CPL, typename TM>
__global__ void __launch_bounds__(LN_NT)
ln_mod(const bf16* __restrict__ x, const float* __restrict__ ln_g,
       const float* __restrict__ ln_b, const TM* __restrict__ shift,
       const TM* __restrict__ scale, bf16* __restrict__ h, int N, int Tlen, int D,
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

// (2), (3): the wgmma GEMM of csrc/wgmma_gemm.cuh, persistent, two consumer
// warpgroups taking turns, results stored by TMA. Tiles (kernel_variants.py
// builds others) at many rows: 128 x 128 a consumer for both GEMMs (GEMM2,
// N = D: 896 tiles at 28,672 rows, 6.8 a block on 132 SMs; 128 x 256
// would leave 3.4; GEMM1 in 64 x 256 measured the same). When there are fewer such tiles than
// consumers on the card (a streamed chunk's B1 x 448 rows), 64 x 64 for
// GEMM1 and 64 x 32 for GEMM2 (224 tiles each at 448 rows; 32 columns are
// stored from the registers, below TMA's 64-column box).
using UpTile = stk::WgTile<2, 2, 128, 4, 1, true>;  // NC, MI (BM = 64 MI), BN, NS, BPS, persistent
using DownTile = stk::WgTile<2, 2, 128, 4, 1, true>;
using UpTileSmall = stk::WgTile<2, 1, 64, 8, 1, true>;
using DownTileSmall = stk::WgTile<2, 1, 32, 8, 1, true, false, false>;  // stores from registers

// two consecutive values of a float or bf16 vector as float
__device__ __forceinline__ float2 load2(const float* p) {
  return *reinterpret_cast<const float2*>(p);
}
__device__ __forceinline__ float2 load2(const bf16* p) {
  return __bfloat1622float2(*reinterpret_cast<const __nv_bfloat162*>(p));
}

// silu in f32 for the GEMM1 epilogue, x / (1 + 2^(-x log2 e)), on the SFU's
// bare ex2 and reciprocal (rcp.approx.ftz, about 1 ulp; for x below -88
// the reciprocal of +inf gives -0, as the quotient does). The epilogue
// runs beside the other consumer's products and must stay shorter:
// __fdividef's range checks, or a reciprocal by Newton's method on the FMA
// pipe, made the FFN ~24% slower at 28,672 rows (kernel_variants.py).
__device__ __forceinline__ float silu_epi(float x) {
  const float y = 1.0f + stk::exp2_ftz(-1.4426950408889634f * x);
  float r;
  asm("rcp.approx.ftz.f32 %0, %1;\n" : "=f"(r) : "f"(y));
  return x * r;
}

// (2): mid = bf16(silu(acc + b1)), two columns a call
struct UpEpi {
  const float* b1;
  struct Row {
    const float* b1;
    __device__ __forceinline__ uint32_t operator()(int col, float v0, float v1) const {
      const float2 bv = *reinterpret_cast<const float2*>(b1 + col);
      return stk::pack_bf16(silu_epi(v0 + bv.x), silu_epi(v1 + bv.y));
    }
  };
  __device__ __forceinline__ Row row(int) const { return {b1}; }
};

// (3): out = bf16(x + gate[batch] * (acc + b2)); the gate is the row's
// batch row (row / T), so a tile that straddles two batch rows reads both
template <typename TM>
struct DownEpi {
  const bf16* x;
  const float* b2;
  const TM* gate;
  int D, Tlen;
  struct Row {
    const bf16* x;
    const float* b2;
    const TM* gate;
    __device__ __forceinline__ uint32_t operator()(int col, float v0, float v1) const {
      const float2 xv = load2(x + col);
      const float2 gv = load2(gate + col);
      const float2 bv = *reinterpret_cast<const float2*>(b2 + col);
      return stk::pack_bf16(xv.x + gv.x * (v0 + bv.x), xv.y + gv.y * (v1 + bv.y));
    }
  };
  __device__ __forceinline__ Row row(int r) const {
    return {x + (size_t)r * D, b2, gate + (size_t)(r / Tlen) * D};
  }
};

template <typename TM>
int launch_ln(const bf16* x, const float* g, const float* b, const TM* shift,
              const TM* scale, bf16* h, int N, int Tlen, int D, float eps,
              cudaStream_t st) {
  const int warps = 132 * 2 * (LN_NT / 32);  // two blocks an SM
  const int rows_per_warp = (N + warps - 1) / warps;
  const int blocks = (N + rows_per_warp * (LN_NT / 32) - 1) / (rows_per_warp * (LN_NT / 32));
  const int cpl = (D / 8 + 31) / 32;
#define STK_LN(C)                                                                        \
  ln_mod<C, TM><<<blocks, LN_NT, 0, st>>>(x, g, b, shift, scale, h, N, Tlen, D, rows_per_warp, \
                                      eps)
  if (cpl == 1) STK_LN(1);
  else if (cpl == 2) STK_LN(2);
  else if (cpl == 3) STK_LN(3);
  else if (cpl == 4) STK_LN(4);
  else return (int)cudaErrorInvalidValue;
#undef STK_LN
  return (int)cudaGetLastError();
}

// TM: the modulation vectors' type (float, or bf16 as the path gives them)
template <typename TM>
int launch_bf16(const bf16* x, const float* g, const float* b, const bf16* w1,
                const float* b1, const bf16* w2, const float* b2, const TM* shift,
                const TM* scale, const TM* gate, bf16* h, bf16* mid, bf16* out,
                int B, int Tlen, int D, int F, float eps, cudaStream_t st) {
  if (D % 8 || F % 8 || D > 4 * 256) return (int)cudaErrorInvalidValue;
  const int N = B * Tlen;
  if (int err = launch_ln(x, g, b, shift, scale, h, N, Tlen, D, eps, st)) return err;
  int sms = 0;
  if (int err = stk::sm_count(sms)) return err;
  using Op = stk::WgmmaBf16;
  const UpEpi up{b1};
  const DownEpi<TM> down{x, b2, gate, D, Tlen};
  int err = stk::gemm_tiles<UpTile>(N, F) >= 2 * sms
                ? stk::launch_wgmma_gemm<Op, UpTile>(h, w1, mid, N, F, D, up, st)
                : stk::launch_wgmma_gemm<Op, UpTileSmall>(h, w1, mid, N, F, D, up, st);
  if (err) return err;
  return stk::gemm_tiles<DownTile>(N, D) >= 2 * sms
             ? stk::launch_wgmma_gemm<Op, DownTile>(mid, w2, out, N, D, F, down, st)
             : stk::launch_wgmma_gemm<Op, DownTileSmall>(mid, w2, out, N, D, F, down, st);
}

}  // namespace

// x/out [B,T,D]; w1 [F,D]; w2 [D,F] (storage type: dtype 0 float, 1 bf16);
// ln g/b [D], b1 [F], b2 [D] float; shift/scale/gate [B,D] float, or for
// bf16 with mod_dtype 1 bf16; scratch: mid [B*T,F] in the storage type,
// and for bf16 h [B*T,D] bf16. All contiguous and 16-byte aligned; D and F
// multiples of 8 (bf16: D <= 1024). mod_dtype comes after the stream, so
// that the earlier design's entry (csrc/earlier/), which lacks it, takes
// the same call with float modulation.
extern "C" int stk_adaln_ffn(const void* x, const void* g, const void* b,
                             const void* w1, const void* b1, const void* w2,
                             const void* b2, const void* shift, const void* scale,
                             const void* gate, void* h, void* mid, void* out, int B,
                             int Tlen, int D, int F, float eps, int dtype,
                             void* stream, int mod_dtype) {
  cudaStream_t st = (cudaStream_t)stream;
  auto f = [](const void* p) { return (const float*)p; };
  auto hb = [](const void* p) { return (const bf16*)p; };
  if (B < 1 || Tlen < 1) return (int)cudaErrorInvalidValue;
  if (dtype == 0 && mod_dtype == 0)
    return launch_f32(f(x), f(g), f(b), f(w1), f(b1), f(w2), f(b2), f(shift), f(scale),
                      f(gate), (float*)mid, (float*)out, B, Tlen, D, F, eps, st);
  if (dtype == 1 && mod_dtype == 0)
    return launch_bf16(hb(x), f(g), f(b), hb(w1), f(b1), hb(w2), f(b2), f(shift), f(scale),
                       f(gate), (bf16*)h, (bf16*)mid, (bf16*)out, B, Tlen, D, F, eps, st);
  if (dtype == 1 && mod_dtype == 1)
    return launch_bf16(hb(x), f(g), f(b), hb(w1), f(b1), hb(w2), f(b2), hb(shift), hb(scale),
                       hb(gate), (bf16*)h, (bf16*)mid, (bf16*)out, B, Tlen, D, F, eps, st);
  return (int)cudaErrorInvalidValue;
}

// the bf16 GEMMs' tiles, rows x columns x stages: GEMM1 and GEMM2 at many
// rows, then at few
extern "C" int stk_adaln_ffn_tiles(int* tiles) {
  const int v[12] = {UpTile::BM, UpTile::BN, UpTile::NS, DownTile::BM, DownTile::BN,
                     DownTile::NS, UpTileSmall::BM, UpTileSmall::BN, UpTileSmall::NS,
                     DownTileSmall::BM, DownTileSmall::BN, DownTileSmall::NS};
  for (int i = 0; i < 12; ++i) tiles[i] = v[i];
  return 0;
}
