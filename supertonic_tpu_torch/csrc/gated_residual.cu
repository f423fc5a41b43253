// The gated residual that closes a transformer sublayer:
//   o   = rnd(y + rnd(bias))         (no bias: y as it is)
//   o   = rnd(gate * o)              (no gate: o as it is; 1.0 * o is exact)
//   out = rnd(x + o)
// for x, y [rows, D] (rows = B * T), f32 bias [D] and gate [B, 1, D] in x's
// type, the row's batch index picking its row (a batch stride of 0 shares
// one row); rnd rounds to the storage type (nothing in f32).
//
// It is the fusion XLA makes of the JAX package's `x = x + gate *
// linear(p["o"], ...)` in block (supertonic_tpu/models/layers.py:428, :433,
// :454): O's (or the FFN's second linear's) bias add, the AdaLN gate and
// the residual in one pass. Every product and sum is an explicit
// __fmul_rn / __fadd_rn and every rounding to bf16 __float2bfloat16_rn, so
// nvcc contracts none of them and the kernel is bit-equal to the plain
// version.
//
// Bound on the H100: the bytes, rows * D * 3 * size (x and y in, out):
// 88.1 MB at the vector estimator's 28,672 x 512 bf16 rows, 0.0263 ms at
// 3.35 TB/s.
//
// Design: a grid-stride pass over runs of V values of one row (V = 8 in
// bf16, 4 in f32: 16-byte loads and stores where D, the gate's batch
// stride and the pointers allow them; else V = 1), a few blocks an SM.
#include <algorithm>

#include "elementwise.cuh"

namespace {

constexpr int NT = 256;

template <typename T, int V, bool BIAS, bool GATE>
__global__ void __launch_bounds__(NT)
gated_residual_pass(const T* __restrict__ x, const T* __restrict__ y,
                    const float* __restrict__ bias, const T* __restrict__ gate,
                    long long gstride, T* __restrict__ out, long long units, int D, int Tlen) {
  for (long long u = (long long)blockIdx.x * NT + threadIdx.x; u < units;
       u += (long long)gridDim.x * NT) {
    const long long i = u * V;
    const long long row = i / D;
    const int d = (int)(i - row * D);
    float xv[V], o[V];
    stk::load_n<T, V>(x + i, xv);
    stk::load_n<T, V>(y + i, o);
    if (BIAS) {
      float bv[V];
      stk::load_n<float, V>(bias + d, bv);
#pragma unroll
      for (int e = 0; e < V; ++e) o[e] = stk::rnd<T>(__fadd_rn(o[e], stk::rnd<T>(bv[e])));
    }
    if (GATE) {
      float gv[V];
      stk::load_n<T, V>(gate + (row / Tlen) * gstride + d, gv);
#pragma unroll
      for (int e = 0; e < V; ++e) o[e] = stk::rnd<T>(__fmul_rn(gv[e], o[e]));
    }
#pragma unroll
    for (int e = 0; e < V; ++e) o[e] = __fadd_rn(xv[e], o[e]);
    stk::store_n<T, V>(out + i, o);
  }
}

template <typename T, int V, bool BIAS, bool GATE>
int go(const void* x, const void* y, const void* bias, const void* gate, long long gstride,
       void* out, int rows, int Tlen, int D, cudaStream_t st) {
  const long long units = (long long)rows * D / V;
  const long long need = (units + NT - 1) / NT;
  const int blocks = (int)std::min<long long>(need, 8LL * stk::sm_count());
  gated_residual_pass<T, V, BIAS, GATE><<<blocks, NT, 0, st>>>(
      static_cast<const T*>(x), static_cast<const T*>(y), static_cast<const float*>(bias),
      static_cast<const T*>(gate), gstride, static_cast<T*>(out), units, D, Tlen);
  return (int)cudaGetLastError();
}

template <typename T, int V>
int pick(const void* x, const void* y, const void* bias, const void* gate, long long gstride,
         void* out, int rows, int Tlen, int D, cudaStream_t st) {
  if (bias)
    return gate ? go<T, V, true, true>(x, y, bias, gate, gstride, out, rows, Tlen, D, st)
                : go<T, V, true, false>(x, y, bias, gate, gstride, out, rows, Tlen, D, st);
  return gate ? go<T, V, false, true>(x, y, bias, gate, gstride, out, rows, Tlen, D, st)
              : go<T, V, false, false>(x, y, bias, gate, gstride, out, rows, Tlen, D, st);
}

template <typename T>
int launch(const void* x, const void* y, const void* bias, const void* gate, long long gstride,
           void* out, int rows, int Tlen, int D, cudaStream_t st) {
  constexpr int V = stk::kVec<T>;
  const bool vec = D % V == 0 && stk::aligned16(x) && stk::aligned16(y) && stk::aligned16(out) &&
                   (!bias || stk::aligned16(bias)) &&
                   (!gate || (stk::aligned16(gate) && gstride % V == 0));
  return vec ? pick<T, V>(x, y, bias, gate, gstride, out, rows, Tlen, D, st)
             : pick<T, 1>(x, y, bias, gate, gstride, out, rows, Tlen, D, st);
}

}  // namespace

// x, y, out [rows, D] contiguous; bias f32 [D] or null; gate rows of D in
// x's type, batch row i at i * gstride, or null; rows = B * Tlen; dtype 0 =
// f32, 1 = bf16.
extern "C" int stk_gated_residual(const void* x, const void* y, const void* bias,
                                  const void* gate, long long gstride, void* out, int rows,
                                  int Tlen, int D, int dtype, void* stream) {
  if (rows < 1 || Tlen < 1 || D < 1 || rows % Tlen || gstride < 0)
    return (int)cudaErrorInvalidValue;
  cudaStream_t st = (cudaStream_t)stream;
  if (dtype == 0) return launch<float>(x, y, bias, gate, gstride, out, rows, Tlen, D, st);
  if (dtype == 1) return launch<__nv_bfloat16>(x, y, bias, gate, gstride, out, rows, Tlen, D, st);
  return (int)cudaErrorInvalidValue;
}
