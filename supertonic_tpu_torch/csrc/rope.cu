// The bias add of a Q or K projection fused with its rotary embedding:
//   a, b = halves of head h of rnd(y + rnd(bias))  (no bias: y as it is)
//   out  = [rnd(a * cos - b * sin), rnd(a * sin + b * cos)]
// for y [rows, D = H * Dh] (rows = B * T, row stride ld), f32 bias [D] and
// f32 cos, sin [rows, Dh / 2] shared by the heads; rnd rounds to the
// storage type (nothing in f32), and the rotation's products and sums are
// f32, as eager type promotion computes them. The result is the
// contiguous [B, T, H, Dh] tensor the attention kernel reads.
//
// It is the fusion XLA makes of the JAX package's linear bias add
// (supertonic_tpu/models/layers.py:51-63, a bf16 fusion) and apply_rope
// (:162), fed from the bf16 projection, at mha's Q and K and kv_project's
// K. Every product and sum is an explicit __fmul_rn / __fadd_rn /
// __fsub_rn and every rounding to bf16 __float2bfloat16_rn, so nvcc
// contracts none of them and the kernel is bit-equal to the plain version.
//
// Bound on the H100: the bytes, rows * D * 2 * size (y in, out) + rows * Dh
// * 4 (the two f32 tables): 66.1 MB at the vector estimator's 28,672 rows of
// 512 bf16 and Dh 64, 0.0197 ms at 3.35 TB/s.
//
// Design: one thread a run of V rotated pairs of one head (V = 8 in bf16,
// 4 in f32: 16-byte loads of both halves and stores of both outputs, where
// Dh / 2, the row stride and the pointers allow them; else V = 1). A row's
// heads read the same cos and sin, which the H threads of a row take from
// L1.
#include "elementwise.cuh"

namespace {

constexpr int NT = 256;

template <typename T, int V, bool BIAS>
__global__ void __launch_bounds__(NT)
rope_pairs(const T* __restrict__ y, long long ld, const float* __restrict__ bias,
           const float* __restrict__ cs, const float* __restrict__ sn, T* __restrict__ out,
           long long units, int H, int half) {
  const long long u = (long long)blockIdx.x * NT + threadIdx.x;
  if (u >= units) return;
  const int per_head = half / V;
  const long long row = u / ((long long)H * per_head);
  const int rem = (int)(u - row * H * per_head);
  const int h = rem / per_head;
  const int j = (rem - h * per_head) * V;
  const int col = h * 2 * half + j;  // of the first half's value
  float a[V], b[V], c[V], s[V];
  stk::load_n<T, V>(y + row * ld + col, a);
  stk::load_n<T, V>(y + row * ld + col + half, b);
  stk::load_n<float, V>(cs + row * half + j, c);
  stk::load_n<float, V>(sn + row * half + j, s);
  if (BIAS) {
    float ba[V], bb[V];
    stk::load_n<float, V>(bias + col, ba);
    stk::load_n<float, V>(bias + col + half, bb);
#pragma unroll
    for (int e = 0; e < V; ++e) {
      a[e] = stk::rnd<T>(__fadd_rn(a[e], stk::rnd<T>(ba[e])));
      b[e] = stk::rnd<T>(__fadd_rn(b[e], stk::rnd<T>(bb[e])));
    }
  }
  float o1[V], o2[V];
#pragma unroll
  for (int e = 0; e < V; ++e) {
    o1[e] = __fsub_rn(__fmul_rn(a[e], c[e]), __fmul_rn(b[e], s[e]));
    o2[e] = __fadd_rn(__fmul_rn(a[e], s[e]), __fmul_rn(b[e], c[e]));
  }
  T* orow = out + row * H * 2 * half + col;
  stk::store_n<T, V>(orow, o1);
  stk::store_n<T, V>(orow + half, o2);
}

template <typename T, int V, bool BIAS>
int go(const void* y, long long ld, const void* bias, const void* cs, const void* sn, void* out,
       int rows, int H, int half, cudaStream_t st) {
  const long long units = (long long)rows * H * (half / V);
  const long long blocks = (units + NT - 1) / NT;
  rope_pairs<T, V, BIAS><<<(unsigned)blocks, NT, 0, st>>>(
      static_cast<const T*>(y), ld, static_cast<const float*>(bias),
      static_cast<const float*>(cs), static_cast<const float*>(sn), static_cast<T*>(out),
      units, H, half);
  return (int)cudaGetLastError();
}

template <typename T>
int launch(const void* y, long long ld, const void* bias, const void* cs, const void* sn,
           void* out, int rows, int H, int half, cudaStream_t st) {
  constexpr int V = stk::kVec<T>;
  const bool vec = half % V == 0 && ld % V == 0 && stk::aligned16(y) && stk::aligned16(cs) &&
                   stk::aligned16(sn) && stk::aligned16(out) && (!bias || stk::aligned16(bias));
  if (vec)
    return bias ? go<T, V, true>(y, ld, bias, cs, sn, out, rows, H, half, st)
                : go<T, V, false>(y, ld, bias, cs, sn, out, rows, H, half, st);
  return bias ? go<T, 1, true>(y, ld, bias, cs, sn, out, rows, H, half, st)
              : go<T, 1, false>(y, ld, bias, cs, sn, out, rows, H, half, st);
}

}  // namespace

// y: rows of H * 2 * half values, row i at i * ld; bias f32 [H * 2 * half]
// or null; cos, sin f32 [rows, half] contiguous; out [rows, H * 2 * half]
// contiguous; dtype 0 = f32, 1 = bf16.
extern "C" int stk_bias_rope(const void* y, long long ld, const void* bias, const void* cs,
                             const void* sn, void* out, int rows, int H, int half, int dtype,
                             void* stream) {
  if (rows < 1 || H < 1 || half < 1 || ld < 2LL * H * half) return (int)cudaErrorInvalidValue;
  cudaStream_t st = (cudaStream_t)stream;
  if (dtype == 0) return launch<float>(y, ld, bias, cs, sn, out, rows, H, half, st);
  if (dtype == 1) return launch<__nv_bfloat16>(y, ld, bias, cs, sn, out, rows, H, half, st);
  return (int)cudaErrorInvalidValue;
}
