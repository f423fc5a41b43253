// Not on the path: the one-warp-a-row design that csrc/quantize.cu replaced,
// kept whole so that kernel_variants.py can build it as its "earlier"
// variant (the package builds csrc/*.cu only).
//
// Per-token activation quantization of the W8A8 linears (the pass before
// the int8 product of csrc/int8_matmul.cu):
//   sx[m]    = max(max_k |x[m, k]|, 1e-12) / 127
//   xq[m, k] = round_half_even(x[m, k] / sx[m])   as int8, |xq| <= 127
// for x [M, K] in f32 or bf16, all arithmetic in f32.
//
// It is the W8A8 linear's own prologue, not a Pallas kernel: the JAX
// package's _linear_w8a8 (supertonic_tpu/models/layers.py) leaves it to XLA.
// Bit-equal to the plain version: the max is exact in any order, both
// divisions are true IEEE divisions (__fdiv_rn; a product with the
// reciprocal is an ulp off in some rows and flips a rounding), rintf rounds
// half to even as torch.round does, and fmaxf clamps as torch.clamp(min=).
//
// Bound on the H100: the bytes, M*K*(size + 1) + 4*M (63 MB at the path's
// 40,960 x 512 bf16, 19 us at 3.35 TB/s). One warp a row reads the row in
// 16-byte chunks, held in registers up to K = 2048 in bf16 and 1024 in f32
// (above, the row is read again, from L1), takes the max across the warp,
// and writes 8 int8 a lane at a time.
#include "common.cuh"

namespace {

constexpr int NT = 256;

// 8 consecutive values of T as raw 16-byte words (U<T> of them), and as float
template <typename T> constexpr int U = (int)sizeof(T) / 2;  // 2 for float, 1 for bf16
template <typename T>
__device__ __forceinline__ void load_raw(const T* p, uint4 r[U<T>]) {
#pragma unroll
  for (int u = 0; u < U<T>; ++u) r[u] = reinterpret_cast<const uint4*>(p)[u];
}
template <typename T> __device__ __forceinline__ void to_float(const uint4 r[U<T>], float v[8]);
template <> __device__ __forceinline__ void to_float<float>(const uint4 r[2], float v[8]) {
#pragma unroll
  for (int u = 0; u < 2; ++u) {
    v[4 * u] = __uint_as_float(r[u].x);
    v[4 * u + 1] = __uint_as_float(r[u].y);
    v[4 * u + 2] = __uint_as_float(r[u].z);
    v[4 * u + 3] = __uint_as_float(r[u].w);
  }
}
template <>
__device__ __forceinline__ void to_float<__nv_bfloat16>(const uint4 r[1], float v[8]) {
  const uint32_t w[4] = {r[0].x, r[0].y, r[0].z, r[0].w};
#pragma unroll
  for (int e = 0; e < 4; ++e) {  // bf16 -> f32 is the 16 bits shifted up
    v[2 * e] = __uint_as_float(w[e] << 16);
    v[2 * e + 1] = __uint_as_float(w[e] & 0xffff0000u);
  }
}

__device__ __forceinline__ uint2 quantize8(const float v[8], float s) {
  uint2 o;
  uint32_t* p = reinterpret_cast<uint32_t*>(&o);
#pragma unroll
  for (int w = 0; w < 2; ++w) {
    uint32_t packed = 0;
#pragma unroll
    for (int e = 0; e < 4; ++e) {
      const int q = (int)rintf(__fdiv_rn(v[4 * w + e], s));
      packed |= (uint32_t)(q & 0xff) << (8 * e);
    }
    p[w] = packed;
  }
  return o;
}

// CPL > 0: each lane holds its CPL chunks of 8 values (chunk lane + 32 i)
// in registers as loaded, so x is read once (K <= 256 CPL); CPL = 0: any
// K, the row read twice, the second time from L1.
template <typename T, int CPL>
__global__ void __launch_bounds__(NT)
quantize_rows(const T* __restrict__ x, int8_t* __restrict__ xq, float* __restrict__ sx,
              int M, int K) {
  const int lane = threadIdx.x & 31;
  const int row = blockIdx.x * (NT / 32) + (threadIdx.x >> 5);
  if (row >= M) return;
  const T* xr = x + (size_t)row * K;
  int8_t* qr = xq + (size_t)row * K;
  const int nc = K / 8;
  float amax = 0.0f;
  if constexpr (CPL > 0) {
    uint4 raw[CPL][U<T>];
#pragma unroll
    for (int i = 0; i < CPL; ++i) {
      const int c = lane + 32 * i;
      if (c < nc) {
        float v[8];
        load_raw(xr + c * 8, raw[i]);
        to_float<T>(raw[i], v);
#pragma unroll
        for (int e = 0; e < 8; ++e) amax = fmaxf(amax, fabsf(v[e]));
      }
    }
    const float s = __fdiv_rn(fmaxf(stk::warp_max(amax), 1e-12f), 127.0f);
#pragma unroll
    for (int i = 0; i < CPL; ++i) {
      const int c = lane + 32 * i;
      if (c < nc) {
        float v[8];
        to_float<T>(raw[i], v);
        *reinterpret_cast<uint2*>(qr + c * 8) = quantize8(v, s);
      }
    }
    if (lane == 0) sx[row] = s;
  } else {
    for (int c = lane; c < nc; c += 32) {
      uint4 r[U<T>];
      float v[8];
      load_raw(xr + c * 8, r);
      to_float<T>(r, v);
#pragma unroll
      for (int e = 0; e < 8; ++e) amax = fmaxf(amax, fabsf(v[e]));
    }
    const float s = __fdiv_rn(fmaxf(stk::warp_max(amax), 1e-12f), 127.0f);
    for (int c = lane; c < nc; c += 32) {
      uint4 r[U<T>];
      float v[8];
      load_raw(xr + c * 8, r);
      to_float<T>(r, v);
      *reinterpret_cast<uint2*>(qr + c * 8) = quantize8(v, s);
    }
    if (lane == 0) sx[row] = s;
  }
}

template <typename T>
int launch(const void* x, void* xq, void* sx, int M, int K, cudaStream_t st) {
  const unsigned blocks = (unsigned)((M + NT / 32 - 1) / (NT / 32));
  const int cpl = (K / 8 + 31) / 32;
  auto go = [&](auto kernel) {
    kernel<<<blocks, NT, 0, st>>>((const T*)x, (int8_t*)xq, (float*)sx, M, K);
    return (int)cudaGetLastError();
  };
  if (cpl <= 1) return go(quantize_rows<T, 1>);
  if (cpl <= 2) return go(quantize_rows<T, 2>);
  if (cpl <= 4) return go(quantize_rows<T, 4>);
  // 8 chunks of f32 a lane (64 registers of row) spill; of bf16 they do not
  if (cpl <= 8 && U<T> == 1) return go(quantize_rows<T, 8>);
  return go(quantize_rows<T, 0>);
}

}  // namespace

// x [M, K] (dtype 0 float, 1 bf16) -> xq [M, K] int8, sx [M] float. All
// contiguous and 16-byte aligned; M >= 1; K a positive multiple of 8.
extern "C" int stk_quantize_rows(const void* x, void* xq, void* sx, int M, int K, int dtype,
                                 void* stream) {
  if (M < 1 || K < 8 || K % 8) return (int)cudaErrorInvalidValue;
  cudaStream_t st = (cudaStream_t)stream;
  if (dtype == 0) return launch<float>(x, xq, sx, M, K, st);
  if (dtype == 1) return launch<__nv_bfloat16>(x, xq, sx, M, K, st);
  return (int)cudaErrorInvalidValue;
}
