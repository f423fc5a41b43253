// Shared helpers of the transformer block's elementwise kernels
// (ln_modulate.cu, rope.cu, gated_residual.cu): N consecutive storage
// values as float, in 16-byte loads and stores where N fills them, and the
// host's choice of a grid. The storage types are float and __nv_bfloat16;
// the arithmetic is float, rounded where eager PyTorch rounds (stk::rnd).
#pragma once

#include "common.cuh"

namespace stk {

// values of T in 16 bytes: 4 float, 8 bf16
template <typename T> constexpr int kVec = 16 / (int)sizeof(T);

// N consecutive values of T at p as float: 16-byte loads where N is a
// multiple of kVec<T> (p then 16-byte aligned), else N scalar loads
template <typename T, int N>
__device__ __forceinline__ void load_n(const T* __restrict__ p, float v[N]) {
  if constexpr (sizeof(T) == 4 && N % 4 == 0) {
#pragma unroll
    for (int k = 0; k < N / 4; ++k) {
      const float4 f = reinterpret_cast<const float4*>(p)[k];
      v[4 * k] = f.x;
      v[4 * k + 1] = f.y;
      v[4 * k + 2] = f.z;
      v[4 * k + 3] = f.w;
    }
  } else if constexpr (sizeof(T) == 2 && N % 8 == 0) {
#pragma unroll
    for (int k = 0; k < N / 8; ++k) {
      const uint4 raw = reinterpret_cast<const uint4*>(p)[k];
      const uint32_t w[4] = {raw.x, raw.y, raw.z, raw.w};
#pragma unroll
      for (int e = 0; e < 4; ++e) {  // bf16 -> f32 is the 16 bits shifted up
        v[8 * k + 2 * e] = __uint_as_float(w[e] << 16);
        v[8 * k + 2 * e + 1] = __uint_as_float(w[e] & 0xffff0000u);
      }
    }
  } else {
#pragma unroll
    for (int i = 0; i < N; ++i) v[i] = to_f(p[i]);
  }
}

// N floats stored to p as T (rounded to nearest even in bf16), in 16-byte
// stores where N is a multiple of kVec<T>
template <typename T, int N>
__device__ __forceinline__ void store_n(T* __restrict__ p, const float v[N]) {
  if constexpr (sizeof(T) == 4 && N % 4 == 0) {
#pragma unroll
    for (int k = 0; k < N / 4; ++k)
      reinterpret_cast<float4*>(p)[k] =
          make_float4(v[4 * k], v[4 * k + 1], v[4 * k + 2], v[4 * k + 3]);
  } else if constexpr (sizeof(T) == 2 && N % 8 == 0) {
#pragma unroll
    for (int k = 0; k < N / 8; ++k)
      reinterpret_cast<uint4*>(p)[k] =
          make_uint4(pack_bf16(v[8 * k], v[8 * k + 1]), pack_bf16(v[8 * k + 2], v[8 * k + 3]),
                     pack_bf16(v[8 * k + 4], v[8 * k + 5]), pack_bf16(v[8 * k + 6], v[8 * k + 7]));
  } else {
#pragma unroll
    for (int i = 0; i < N; ++i) p[i] = from_f<T>(v[i]);
  }
}

inline bool aligned16(const void* p) { return (reinterpret_cast<uintptr_t>(p) & 15) == 0; }

// streaming multiprocessors of the current device (the wrapper makes the
// tensors' device current), for sizing grids
inline int sm_count() {
  int dev = 0, n = 0;
  if (cudaGetDevice(&dev) != cudaSuccess ||
      cudaDeviceGetAttribute(&n, cudaDevAttrMultiProcessorCount, dev) != cudaSuccess || n < 1)
    return 132;
  return n;
}

}  // namespace stk
