// LayerNorm of the transformer blocks with their AdaLN modulation, in one
// pass over the rows of x [rows, D] (rows = B * T):
//   y   = (x - mean) * rsqrt(var + eps)        f32 statistics of the row
//   h   = rnd(rnd(rnd(y) * rnd(g)) + rnd(b))
//   out = rnd(rnd(h * rnd(1 + scale)) + shift)  with the modulation
// where rnd rounds to the storage type (nothing in f32), g and b are f32
// [D], and shift and scale [B, 1, D] in x's type, the row's batch index
// picking their row (a batch stride of 0 shares one row).
//
// It is the fusion XLA makes of the JAX package's layer_norm
// (supertonic_tpu/models/layers.py:106) and _modulate (:388), as block
// (:427, :432, :453) and the vector estimator's output head use them: the
// rounding points are the port's eager layers.layer_norm followed by
// _modulate (normalize in f32, affine and modulation in the storage type,
// each product and sum rounded), not those of the fused FFN's LayerNorm
// pass (csrc/ffn.cu, one rounding at the end). Every product and sum after
// the statistics is an explicit __fmul_rn / __fadd_rn, so nvcc contracts
// none of them into an FMA and the kernel rounds where eager PyTorch does;
// the statistics are summed in another order than torch.mean, so the result
// can differ from the plain version by a rounding step of y.
//
// Bound on the H100: the bytes, rows * D * 2 * size (x once in, out once),
// 58.7 MB at the vector estimator's 28,672 x 512 bf16 rows: 0.0175 ms at
// 3.35 TB/s.
//
// The quantizing form (stk_ln_modulate_quantize, bf16): where every
// consumer of the output is a W8A8 linear (the int8 path's ln1, ln2 and ln3),
// the rows leave as that linear's quantize pass would make them from the
// bf16 output, (xq [rows, D] int8, sx [rows] f32), and the bf16 rows are
// never stored: the lanes hold a row's bf16 outputs in registers, its amax
// is a warp reduction, then quantize8.cuh's arithmetic (the row's scale by
// an IEEE division, each value's quotient by the division's own fast
// sequence from the row's reciprocal, correctly rounded, rounding half to
// even): bit for bit this kernel followed by csrc/quantize.cu, the fusion
// XLA makes of _modulate with the first half of _linear_w8a8
// (supertonic_tpu/models/layers.py:77-91). Bound: rows * D * 3 + 4 rows
// bytes, 44.0 MB at 28,672 x 512: 0.0131 ms, against the two kernels' 0.0175
// + 0.0132. Measured (ms from graphs, kernel_variants.py ln_quantize, NVIDIA
// H100 80GB HBM3, 700 W, at 28,672 x 512): 0.0247-0.0251 (the pair
// 0.0392-0.0393, the bf16 form alone 0.0239); with __fdiv_rn for every
// value 0.0280-0.0284.
//
// Design: rows staged through shared memory by bulk copies, several in
// flight a warp. A block takes a run of consecutive rows inside one batch
// row (one segment of T rows; without the modulation the rows are one
// segment), RUN rows (a multiple of 8, ~4 blocks an SM) and 8 warps; warp w
// takes rows w, w + 8, ... of the run. Each warp has a ring of STAGES
// row slots: its lane 0 fills them by cp.async.bulk (one copy a row,
// completing on the slot's mbarrier) and refills a slot with the row
// STAGES ahead as soon as the lanes hold the current row in registers, so
// STAGES rows a warp are in flight while it reduces and writes. The block
// loads g, b and its batch row's 1 + scale and shift once, rounded to the
// storage type, into shared memory (the earlier design held them in
// registers, a second pair of register arrays for the modulation, and
// reloaded scale and shift where a warp's rows crossed a batch row). The
// per-lane chunks (chunk lane + 32 i), the sum order and every rounding
// are the earlier design's: the outputs are bit for bit the same. In bf16
// the affine and the modulation run as packed bf16 products and sums
// (finish_bf16x8), which round as the f32 operations rounded to bf16 do.
// Rows of any other width or alignment (D past 128 chunks, no multiple of
// 16 bytes, x or out misaligned) take a scalar warp that reads its row
// three times (the later reads from L1).
// What limited the earlier design (csrc/earlier/ln_modulate_warp_rows.cu,
// kernel_variants.py ln_modulate): one row in flight a warp, whose load the
// two reductions waited on, at ~32 warps an SM.
#include <algorithm>
#include <type_traits>

#include "elementwise.cuh"
#include "quantize8.cuh"
#include "wgmma.cuh"  // bulk copies and mbarriers

namespace {

constexpr int NT = 256;  // threads a block: 8 warps
constexpr int WARPS = NT / 32;
constexpr int STAGES = 3;  // row slots a warp: rows in flight

// the plain version's rounding points after the statistics
template <typename T, bool MOD>
__device__ __forceinline__ float finish(float v, float mean, float rstd, float g, float b,
                                        float sc1, float sh) {
  float h = stk::rnd<T>(__fmul_rn(__fsub_rn(v, mean), rstd));
  h = stk::rnd<T>(__fmul_rn(h, g));
  h = stk::rnd<T>(__fadd_rn(h, b));
  if (MOD) {
    h = stk::rnd<T>(__fmul_rn(h, sc1));
    h = stk::rnd<T>(__fadd_rn(h, sh));
  }
  return h;
}

// finish for 8 bf16 values: the normalized value in f32 rounded to bf16,
// then the affine and the modulation as packed bf16 products and sums. A
// product or a sum of two bf16 values is exact in f32 (or, for a sum of
// values 2^24 apart, rounds to the larger either way), so one bf16
// rounding of the exact result, which the packed instructions make, is the
// f32 operation rounded to bf16: the same bits as finish<bf16>, in a
// quarter of the instructions. p: this chunk's g (and b, 1 + scale, shift
// D values apart) in shared memory
template <bool MOD>
__device__ __forceinline__ uint4 finish_bf16x8(const float (&v)[8], float mean, float rstd,
                                               const __nv_bfloat16* p, int D) {
  const int npar = MOD ? 4 : 2;
  uint4 par[4];
#pragma unroll
  for (int i = 0; i < npar; ++i) par[i] = *reinterpret_cast<const uint4*>(p + i * D);
  uint4 o;
  uint32_t* op = reinterpret_cast<uint32_t*>(&o);
#pragma unroll
  for (int j = 0; j < 4; ++j) {
    auto pair = [&](int i) {
      return reinterpret_cast<const __nv_bfloat162*>(&par[i])[j];
    };
    __nv_bfloat162 h = __floats2bfloat162_rn(__fmul_rn(__fsub_rn(v[2 * j], mean), rstd),
                                             __fmul_rn(__fsub_rn(v[2 * j + 1], mean), rstd));
    // the _rn forms: a plain mul and add could be contracted into one fma
    h = __hadd2_rn(__hmul2_rn(h, pair(0)), pair(1));
    if (MOD) h = __hadd2_rn(__hmul2_rn(h, pair(2)), pair(3));
    op[j] = *reinterpret_cast<uint32_t*>(&h);
  }
  return o;
}

// 8 bf16 in 16 bytes as float (bf16 -> f32 is the 16 bits shifted up)
__device__ __forceinline__ void unpack8(uint4 h, float f[8]) {
  const uint32_t w[4] = {h.x, h.y, h.z, h.w};
#pragma unroll
  for (int e = 0; e < 4; ++e) {
    f[2 * e] = __uint_as_float(w[e] << 16);
    f[2 * e + 1] = __uint_as_float(w[e] & 0xffff0000u);
  }
}

// the quantizing form's part of a row in a lane: the largest |value| of its
// chunks h (8 bf16 each; chunk k is the row's chunk lane + 32 k, below nc)
template <int CPL>
__device__ __forceinline__ float chunks_amax(const uint4 (&h)[CPL], int lane, int nc) {
  float amax = 0.0f;
#pragma unroll
  for (int k = 0; k < CPL; ++k) {
    if (lane + 32 * k >= nc) continue;
    float f[8];
    unpack8(h[k], f);
#pragma unroll
    for (int e = 0; e < 8; ++e) amax = fmaxf(amax, fabsf(f[e]));
  }
  return amax;
}

// shared memory of a block: g, b [, 1 + scale, shift] rows of D in T | the
// warps' ring slots [WARPS][STAGES][D] in T | their mbarriers
template <typename T, bool MOD>
constexpr size_t smem_bytes(int D) {
  return ((MOD ? 4 : 2) + (size_t)WARPS * STAGES) * D * sizeof(T) + 8 * WARPS * STAGES;
}

// blockIdx.x = segment * runs + run index; rows of a segment: seg_len. Q
// (bf16): the row's (xq, sx) in place of out
template <typename T, int CPL, bool MOD, bool Q>
__global__ void __launch_bounds__(NT)
layer_norm_rows(const T* __restrict__ x, const float* __restrict__ g,
                const float* __restrict__ b, const T* __restrict__ shift,
                const T* __restrict__ scale, long long mstride, T* __restrict__ out,
                int8_t* __restrict__ xq, float* __restrict__ sx, int seg_len, int D, int run,
                int runs, float eps) {
  constexpr int E = stk::kVec<T>;
  static_assert(!Q || std::is_same<T, __nv_bfloat16>::value, "the quantizing form is bf16's");
  extern __shared__ __align__(128) unsigned char smem[];
  T* par = reinterpret_cast<T*>(smem);  // g, b, 1 + scale, shift
  T* ring = par + (MOD ? 4 : 2) * D;
  uint64_t* full = reinterpret_cast<uint64_t*>(ring + (size_t)WARPS * STAGES * D);
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const int seg = blockIdx.x / runs;
  const int r0 = seg * seg_len + (blockIdx.x % runs) * run;
  const int r1 = min(r0 + run, (seg + 1) * seg_len);
  const int n_rows = r0 + warp < r1 ? (r1 - 1 - r0 - warp) / WARPS + 1 : 0;
  const uint32_t bytes = (uint32_t)(D * sizeof(T));
  T* slots = ring + (size_t)warp * STAGES * D;
  uint64_t* bar = full + warp * STAGES;
  // lane 0: row i of this warp into slot i % STAGES
  auto issue = [&](int i) {
    stk::mbar_arrive_tx(&bar[i % STAGES], bytes);
    stk::bulk_load(slots + (size_t)(i % STAGES) * D, x + (size_t)(r0 + warp + i * WARPS) * D,
                   bytes, &bar[i % STAGES]);
  };
  if (lane == 0) {
#pragma unroll
    for (int s = 0; s < STAGES; ++s) stk::mbar_init(&bar[s], 1);
    stk::mbar_fence_init();
    for (int i = 0; i < STAGES && i < n_rows; ++i) issue(i);
  }
  for (int c = threadIdx.x; c < D; c += NT) {
    par[c] = stk::from_f<T>(g[c]);
    par[D + c] = stk::from_f<T>(b[c]);
    if (MOD) {
      const long long m = seg * mstride + c;
      par[2 * D + c] = stk::from_f<T>(__fadd_rn(1.0f, stk::to_f(scale[m])));
      par[3 * D + c] = shift[m];
    }
  }
  __syncthreads();
  const int nc = D / E;
  for (int i = 0; i < n_rows; ++i) {
    const T* in = slots + (size_t)(i % STAGES) * D;
    stk::mbar_wait(&bar[i % STAGES], (i / STAGES) & 1);
    float v[CPL][E];
    float s = 0.0f;
#pragma unroll
    for (int k = 0; k < CPL; ++k) {
      const int c = lane + 32 * k;
      if (c < nc) {
        stk::load_n<T, E>(in + c * E, v[k]);
#pragma unroll
        for (int e = 0; e < E; ++e) s += v[k][e];
      }
    }
    // the row is in registers: the slot takes the row STAGES ahead
    __syncwarp();
    if (lane == 0 && i + STAGES < n_rows) issue(i + STAGES);
    const float mean = __fdiv_rn(stk::warp_sum(s), (float)D);
    float q = 0.0f;
#pragma unroll
    for (int k = 0; k < CPL; ++k)
      if (lane + 32 * k < nc)
#pragma unroll
        for (int e = 0; e < E; ++e) {
          const float d = __fsub_rn(v[k][e], mean);
          q += d * d;
        }
    const float rstd = rsqrtf(__fadd_rn(__fdiv_rn(stk::warp_sum(q), (float)D), eps));
    const size_t row = r0 + warp + i * WARPS;
    if constexpr (Q) {
      // the row's bf16 outputs held in registers, its amax over the warp,
      // then csrc/quantize.cu's arithmetic on them
      uint4 h[CPL];
#pragma unroll
      for (int k = 0; k < CPL; ++k)
        if (lane + 32 * k < nc)
          h[k] = finish_bf16x8<MOD>(v[k], mean, rstd, par + (lane + 32 * k) * E, D);
      const float sc = stk::quant_scale(stk::warp_max(chunks_amax<CPL>(h, lane, nc)));
      const float rc = stk::quant_recip(sc);
      if (lane == 0) sx[row] = sc;
#pragma unroll
      for (int k = 0; k < CPL; ++k) {
        const int c = lane + 32 * k;
        if (c >= nc) continue;
        float f[8];
        unpack8(h[k], f);
        *reinterpret_cast<uint2*>(xq + row * D + c * E) = stk::quantize8(f, sc, rc);
      }
      continue;
    }
    T* orow = out + row * D;
#pragma unroll
    for (int k = 0; k < CPL; ++k) {
      const int c = lane + 32 * k;
      if (c >= nc) continue;
      if constexpr (std::is_same<T, __nv_bfloat16>::value) {
        *reinterpret_cast<uint4*>(orow + c * E) =
            finish_bf16x8<MOD>(v[k], mean, rstd, par + c * E, D);
        continue;
      }
      float gv[E], bv[E], sc1[E], sh[E], o[E];
      stk::load_n<T, E>(par + c * E, gv);
      stk::load_n<T, E>(par + D + c * E, bv);
      if (MOD) {
        stk::load_n<T, E>(par + 2 * D + c * E, sc1);
        stk::load_n<T, E>(par + 3 * D + c * E, sh);
      }
#pragma unroll
      for (int e = 0; e < E; ++e)
        o[e] = finish<T, MOD>(v[k][e], mean, rstd, gv[e], bv[e], MOD ? sc1[e] : 0.0f,
                              MOD ? sh[e] : 0.0f);
      stk::store_n<T, E>(orow + c * E, o);
    }
  }
}

// any D and alignment: scalar loads, the row read three times
template <typename T, bool MOD>
__global__ void __launch_bounds__(NT)
layer_norm_rows_any(const T* __restrict__ x, const float* __restrict__ g,
                    const float* __restrict__ b, const T* __restrict__ shift,
                    const T* __restrict__ scale, long long mstride, T* __restrict__ out,
                    int rows, int Tlen, int D, int rows_per_warp, float eps) {
  const int lane = threadIdx.x & 31;
  const int r0 = (blockIdx.x * (NT / 32) + (threadIdx.x >> 5)) * rows_per_warp;
  const int r1 = min(rows, r0 + rows_per_warp);
  for (int row = r0; row < r1; ++row) {
    const T* xr = x + (size_t)row * D;
    float s = 0.0f;
    for (int k = lane; k < D; k += 32) s += stk::to_f(xr[k]);
    const float mean = __fdiv_rn(stk::warp_sum(s), (float)D);
    float q = 0.0f;
    for (int k = lane; k < D; k += 32) {
      const float d = __fsub_rn(stk::to_f(xr[k]), mean);
      q += d * d;
    }
    const float rstd = rsqrtf(__fadd_rn(__fdiv_rn(stk::warp_sum(q), (float)D), eps));
    const long long m = (long long)(row / Tlen) * mstride;
    T* orow = out + (size_t)row * D;
    for (int k = lane; k < D; k += 32) {
      const float sc1 = MOD ? stk::rnd<T>(__fadd_rn(1.0f, stk::to_f(scale[m + k]))) : 0.0f;
      const float sh = MOD ? stk::to_f(shift[m + k]) : 0.0f;
      orow[k] = stk::from_f<T>(finish<T, MOD>(stk::to_f(xr[k]), mean, rstd,
                                              stk::rnd<T>(g[k]), stk::rnd<T>(b[k]), sc1, sh));
    }
  }
}

template <typename T, int CPL, bool MOD, bool Q>
int launch_rows(const T* x, const float* g, const float* b, const T* shift, const T* scale,
                long long mstride, T* out, int8_t* xq, float* sx, int rows, int seg_len, int D,
                float eps, cudaStream_t st) {
  // a run of rows a block, a multiple of the warps, ~4 blocks an SM
  const int target = stk::sm_count() * 4;
  int run = (rows + target - 1) / target;
  run = std::max(WARPS, (run + WARPS - 1) / WARPS * WARPS);
  const int runs = (seg_len + run - 1) / run;
  const size_t bytes = smem_bytes<T, MOD>(D);
  auto kernel = layer_norm_rows<T, CPL, MOD, Q>;
  static size_t configured[stk::kMaxDevices] = {};
  if (int err = stk::allow_dynamic_smem(kernel, bytes, configured)) return err;
  kernel<<<rows / seg_len * runs, NT, bytes, st>>>(x, g, b, shift, scale, mstride, out, xq, sx,
                                                   seg_len, D, run, runs, eps);
  return (int)cudaGetLastError();
}

// Q: the quantizing form (xq, sx in place of out), the bulk-copied rows alone
template <typename T, bool MOD, bool Q = false>
int go(const T* x, const float* g, const float* b, const T* shift, const T* scale,
       long long mstride, T* out, int rows, int Tlen, int D, float eps, cudaStream_t st,
       int8_t* xq = nullptr, float* sx = nullptr) {
  constexpr int E = stk::kVec<T>;
  // rows by bulk copies: 16-byte rows, aligned (the modulation is read per
  // value, at any alignment and batch stride)
  const bool vec =
      D % E == 0 && stk::aligned16(x) && (Q ? stk::aligned16(xq) : stk::aligned16(out));
  const int nc = D / E;
  // without the modulation the rows are one segment
  const int seg = MOD ? Tlen : rows;
  if (vec && nc <= 32)
    return launch_rows<T, 1, MOD, Q>(x, g, b, shift, scale, mstride, out, xq, sx, rows, seg, D,
                                     eps, st);
  if (vec && nc <= 64)
    return launch_rows<T, 2, MOD, Q>(x, g, b, shift, scale, mstride, out, xq, sx, rows, seg, D,
                                     eps, st);
  if (vec && nc <= 128)
    return launch_rows<T, 4, MOD, Q>(x, g, b, shift, scale, mstride, out, xq, sx, rows, seg, D,
                                     eps, st);
  if constexpr (Q) return (int)cudaErrorInvalidValue;
  // a run of rows a warp, with about 32 warps a streaming multiprocessor
  const int warps = stk::sm_count() * 32;
  const int rpw = std::max(1, (rows + warps - 1) / warps);
  const int blocks = ((rows + rpw - 1) / rpw + NT / 32 - 1) / (NT / 32);
  layer_norm_rows_any<T, MOD><<<blocks, NT, 0, st>>>(x, g, b, shift, scale, mstride, out,
                                                     rows, Tlen, D, rpw, eps);
  return (int)cudaGetLastError();
}

template <typename T>
int launch(const void* x, const void* g, const void* b, const void* shift, const void* scale,
           long long mstride, void* out, int rows, int Tlen, int D, float eps, cudaStream_t st) {
  auto args = [&](auto mod) {
    return go<T, decltype(mod)::value>(
        static_cast<const T*>(x), static_cast<const float*>(g), static_cast<const float*>(b),
        static_cast<const T*>(shift), static_cast<const T*>(scale), mstride,
        static_cast<T*>(out), rows, Tlen, D, eps, st);
  };
  return shift ? args(std::true_type{}) : args(std::false_type{});
}

}  // namespace

// x, out [rows, D] contiguous; g, b f32 [D]; shift, scale (both or
// neither) rows of D in x's type, batch row i at i * mstride; rows = B *
// Tlen; dtype 0 = f32, 1 = bf16.
extern "C" int stk_ln_modulate(const void* x, const void* g, const void* b, const void* shift,
                               const void* scale, long long mstride, void* out, int rows,
                               int Tlen, int D, float eps, int dtype, void* stream) {
  if (rows < 1 || Tlen < 1 || D < 1 || rows % Tlen || (!shift) != (!scale) || mstride < 0)
    return (int)cudaErrorInvalidValue;
  cudaStream_t st = (cudaStream_t)stream;
  if (dtype == 0) return launch<float>(x, g, b, shift, scale, mstride, out, rows, Tlen, D, eps, st);
  if (dtype == 1)
    return launch<__nv_bfloat16>(x, g, b, shift, scale, mstride, out, rows, Tlen, D, eps, st);
  return (int)cudaErrorInvalidValue;
}

// The quantizing form: x [rows, D] bf16 (D a multiple of 8 up to 1,024, x
// and xq 16-byte aligned) -> xq [rows, D] int8 and sx [rows] f32 of the bf16
// rows stk_ln_modulate would write; the rest as there.
extern "C" int stk_ln_modulate_quantize(const void* x, const void* g, const void* b,
                                        const void* shift, const void* scale, long long mstride,
                                        void* xq, void* sx, int rows, int Tlen, int D, float eps,
                                        void* stream) {
  if (rows < 1 || Tlen < 1 || D < 1 || rows % Tlen || (!shift) != (!scale) || mstride < 0)
    return (int)cudaErrorInvalidValue;
  using bf16 = __nv_bfloat16;
  auto args = [&](auto mod) {
    return go<bf16, decltype(mod)::value, true>(
        static_cast<const bf16*>(x), static_cast<const float*>(g), static_cast<const float*>(b),
        static_cast<const bf16*>(shift), static_cast<const bf16*>(scale), mstride, nullptr, rows,
        Tlen, D, eps, (cudaStream_t)stream, static_cast<int8_t*>(xq), static_cast<float*>(sx));
  };
  return shift ? args(std::true_type{}) : args(std::false_type{});
}
