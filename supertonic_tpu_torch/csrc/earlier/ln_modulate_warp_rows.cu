// Not on the path: the one-warp-a-row design that csrc/ln_modulate.cu
// replaced, kept whole so that kernel_variants.py can build it as its
// "earlier" variant (the package builds csrc/*.cu only).
//
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
// Design: one warp a row, each lane holding CPL 16-byte chunks of the row
// (chunk lane + 32 i) in registers between the statistics and the write, so
// x is read once; g and b stay in registers over the warp's run of
// consecutive rows, and scale and shift are reloaded only where the batch
// index changes. Rows of any other width or alignment (D past 128 chunks,
// no multiple of 16 bytes, or a misaligned modulation) take a scalar warp
// that reads its row three times (the later reads from L1).
#include <algorithm>
#include <type_traits>

#include "elementwise.cuh"

namespace {

constexpr int NT = 256;  // threads a block: 8 warps

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

template <typename T, int CPL, bool MOD>
__global__ void __launch_bounds__(NT)
layer_norm_rows(const T* __restrict__ x, const float* __restrict__ g,
                const float* __restrict__ b, const T* __restrict__ shift,
                const T* __restrict__ scale, long long mstride, T* __restrict__ out, int rows,
                int Tlen, int D, int rows_per_warp, float eps) {
  constexpr int E = stk::kVec<T>;
  const int lane = threadIdx.x & 31;
  const int r0 = (blockIdx.x * (NT / 32) + (threadIdx.x >> 5)) * rows_per_warp;
  const int r1 = min(rows, r0 + rows_per_warp);
  const int nc = D / E;
  float gv[CPL][E], bv[CPL][E], sc1[CPL][E], sh[CPL][E];
#pragma unroll
  for (int i = 0; i < CPL; ++i) {
    const int c = lane + 32 * i;
    if (c < nc) {
      stk::load_n<float, E>(g + c * E, gv[i]);
      stk::load_n<float, E>(b + c * E, bv[i]);
#pragma unroll
      for (int e = 0; e < E; ++e) {
        gv[i][e] = stk::rnd<T>(gv[i][e]);
        bv[i][e] = stk::rnd<T>(bv[i][e]);
      }
    }
  }
  int cur_b = -1;
  for (int row = r0; row < r1; ++row) {
    if (MOD) {
      const int bi = row / Tlen;
      if (bi != cur_b) {
        cur_b = bi;
#pragma unroll
        for (int i = 0; i < CPL; ++i) {
          const int c = lane + 32 * i;
          if (c < nc) {
            stk::load_n<T, E>(scale + bi * mstride + c * E, sc1[i]);
            stk::load_n<T, E>(shift + bi * mstride + c * E, sh[i]);
#pragma unroll
            for (int e = 0; e < E; ++e) sc1[i][e] = stk::rnd<T>(__fadd_rn(1.0f, sc1[i][e]));
          }
        }
      }
    }
    const T* xr = x + (size_t)row * D;
    float v[CPL][E];
    float s = 0.0f;
#pragma unroll
    for (int i = 0; i < CPL; ++i) {
      const int c = lane + 32 * i;
      if (c < nc) {
        stk::load_n<T, E>(xr + c * E, v[i]);
#pragma unroll
        for (int e = 0; e < E; ++e) s += v[i][e];
      }
    }
    const float mean = __fdiv_rn(stk::warp_sum(s), (float)D);
    float q = 0.0f;
#pragma unroll
    for (int i = 0; i < CPL; ++i)
      if (lane + 32 * i < nc)
#pragma unroll
        for (int e = 0; e < E; ++e) {
          const float d = __fsub_rn(v[i][e], mean);
          q += d * d;
        }
    const float rstd = rsqrtf(__fadd_rn(__fdiv_rn(stk::warp_sum(q), (float)D), eps));
    T* orow = out + (size_t)row * D;
#pragma unroll
    for (int i = 0; i < CPL; ++i) {
      const int c = lane + 32 * i;
      if (c >= nc) continue;
      float o[E];
#pragma unroll
      for (int e = 0; e < E; ++e)
        o[e] = finish<T, MOD>(v[i][e], mean, rstd, gv[i][e], bv[i][e], MOD ? sc1[i][e] : 0.0f,
                              MOD ? sh[i][e] : 0.0f);
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

template <typename T, bool MOD>
int go(const T* x, const float* g, const float* b, const T* shift, const T* scale,
       long long mstride, T* out, int rows, int Tlen, int D, float eps, cudaStream_t st) {
  constexpr int E = stk::kVec<T>;
  // a run of rows a warp, with about 32 warps a streaming multiprocessor
  const int warps = stk::sm_count() * 32;
  const int rpw = std::max(1, (rows + warps - 1) / warps);
  const int blocks = ((rows + rpw - 1) / rpw + NT / 32 - 1) / (NT / 32);
  const bool vec = D % E == 0 && stk::aligned16(x) && stk::aligned16(out) && stk::aligned16(g) &&
                   stk::aligned16(b) &&
                   (!MOD || (stk::aligned16(shift) && stk::aligned16(scale) && mstride % E == 0));
  const int nc = D / E;
  if (vec && nc <= 32)
    layer_norm_rows<T, 1, MOD><<<blocks, NT, 0, st>>>(x, g, b, shift, scale, mstride, out, rows,
                                                      Tlen, D, rpw, eps);
  else if (vec && nc <= 64)
    layer_norm_rows<T, 2, MOD><<<blocks, NT, 0, st>>>(x, g, b, shift, scale, mstride, out, rows,
                                                      Tlen, D, rpw, eps);
  else if (vec && nc <= 128)
    layer_norm_rows<T, 4, MOD><<<blocks, NT, 0, st>>>(x, g, b, shift, scale, mstride, out, rows,
                                                      Tlen, D, rpw, eps);
  else
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
