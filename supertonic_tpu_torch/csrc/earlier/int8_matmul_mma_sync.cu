// Not on the path: the mma.sync design that csrc/int8_matmul.cu replaced, kept
// whole so that kernel_variants.py can build it as its "earlier" variant (the
// package builds csrc/*.cu only).
//
// The int8 product of the W8A8 linears, in two forms of one kernel:
//   int8_matmul: C[M, N] (int32) = A[M, K] (int8) . W[N, K]^T (int8), exact;
//   w8a8_matmul: Y[M, N] = (float(A . W^T) * sx[m]) * w_scale[n] + bias[n],
//                rounded once to Y's type (bf16 or f32).
//
// Replaces tools/int8_microbench.py:_pallas_i8_matmul, the Pallas int8 x int8
// -> int32 kernel (the product that the JAX package's _linear_w8a8 leaves to
// XLA's dot_general). Both operands are contiguous in K: A is the per-token
// quantized activation (csrc/quantize.cu writes it and sx), W the quantized
// weight in torch's linear layout [dout, din]. |sum| <= 127^2 * K, far
// inside int32 for every K the path has.
//
// Bound on the H100: at the path's shapes (M = 40,960 rows, K = 512, N = 2048)
// the output sets it: 336 MB of int32 (0.107 ms at 3.35 TB/s) for
// int8_matmul, 168 MB of bf16 (0.053 ms) for w8a8_matmul, against 0.043 ms
// for the 2*M*N*K operations at 1,979 TOPS int8. So the W8A8 path writes
// the linear's output from the accumulators and never an int32 tensor, and
// the output is written coalesced: each warp stages its accumulator tile
// through shared memory, and each lane then writes 8 columns (16 bytes of
// bf16). The epilogue is bit-equal to the plain version's f32 operations:
// __int2float_rn (which rounds above 2^24, as torch's .float() does), then
// __fmul_rn, __fmul_rn and __fadd_rn in the plain order, so nvcc cannot
// contract them into an FMA.
//
// Design: the tensor-core GEMM of csrc/mma_gemm.cuh on mma.sync.m16n8k32
// s8.s8.s32: 128 x 128 block tiles, 8 warps of 64 x 32, two blocks an SM;
// K in steps of 128 bytes through a 3-stage cp.async ring with XOR-swizzled
// rows, fragments by ldmatrix.x4 loaded ahead of the products. Rows past M
// or N and K past its end are zero-filled on load, and the store is masked;
// K is a multiple of 32, one product's depth.
#include "mma_gemm.cuh"

namespace {

using Int8Tile = stk::GemmShape<128, 128, 64, 32, 3, 2>;  // BM, BN, WM, WN, stages, blocks/SM

// The stored form of the product: out(row, col, v) takes the exact int32
// sums of 8 consecutive columns (fewer at the right edge, past N unused).
struct Int32Out {  // int8_matmul: C = the sums
  int32_t* C;
  int N;
  __device__ __forceinline__ void operator()(int row, int col, const int v[8]) const {
    int32_t* dst = C + (size_t)row * N + col;
    if ((N & 3) == 0 && col + 8 <= N) {
      *reinterpret_cast<int4*>(dst) = make_int4(v[0], v[1], v[2], v[3]);
      *reinterpret_cast<int4*>(dst + 4) = make_int4(v[4], v[5], v[6], v[7]);
    } else {
      for (int e = 0; e < 8 && col + e < N; ++e) dst[e] = v[e];
    }
  }
};

template <typename T>  // w8a8_matmul: Y = (float(sums) * sx[row]) * ws[col] + bias[col]
struct ScaleOut {
  T* Y;
  const float* sx;
  const float* ws;
  const float* bias;
  int N;
  __device__ __forceinline__ void operator()(int row, int col, const int v[8]) const {
    const float s = sx[row];
    T* dst = Y + (size_t)row * N + col;
    if ((N & 7) == 0 && col + 8 <= N) {  // rows 16-byte aligned: 8-wide loads and stores
      float w[8], b[8], y[8];
      stk::load4(ws + col, w);
      stk::load4(ws + col + 4, w + 4);
      stk::load4(bias + col, b);
      stk::load4(bias + col + 4, b + 4);
#pragma unroll
      for (int e = 0; e < 8; ++e)
        y[e] = __fadd_rn(__fmul_rn(__fmul_rn(__int2float_rn(v[e]), s), w[e]), b[e]);
      store8(dst, y);
    } else {
      for (int e = 0; e < 8 && col + e < N; ++e)
        dst[e] = stk::from_f<T>(
            __fadd_rn(__fmul_rn(__fmul_rn(__int2float_rn(v[e]), s), ws[col + e]), bias[col + e]));
    }
  }
  static __device__ __forceinline__ void store8(float* dst, const float y[8]) {
    *reinterpret_cast<float4*>(dst) = make_float4(y[0], y[1], y[2], y[3]);
    *reinterpret_cast<float4*>(dst + 4) = make_float4(y[4], y[5], y[6], y[7]);
  }
  static __device__ __forceinline__ void store8(__nv_bfloat16* dst, const float y[8]) {
    uint4 o;
    uint32_t* p = reinterpret_cast<uint32_t*>(&o);
#pragma unroll
    for (int e = 0; e < 4; ++e) p[e] = stk::pack_bf16(y[2 * e], y[2 * e + 1]);
    *reinterpret_cast<uint4*>(dst) = o;
  }
};

template <typename Out>
int launch(const void* a, const void* w, int M, int N, int K, Out out, void* stream) {
  if (M < 1 || N < 1 || K < 32 || K % 32) return (int)cudaErrorInvalidValue;
  return stk::launch_mma_gemm<stk::MmaS8, Int8Tile>((const int8_t*)a, (const int8_t*)w, M, N, K,
                                                    out, (cudaStream_t)stream);
}

}  // namespace

// a [M, K] int8, w [N, K] int8, c [M, N] int32; all contiguous, a and w
// 16-byte aligned; M, N >= 1; K a positive multiple of 32.
extern "C" int stk_int8_matmul(const void* a, const void* w, void* c, int M, int N,
                               int K, void* stream) {
  return launch(a, w, M, N, K, Int32Out{(int32_t*)c, N}, stream);
}

// a [M, K] int8, w [N, K] int8 as above; sx [M], w_scale [N], bias [N]
// float; y [M, N] in dtype 0 float, 1 bf16. All contiguous and 16-byte
// aligned.
extern "C" int stk_w8a8_matmul(const void* a, const void* w, const void* sx,
                               const void* w_scale, const void* bias, void* y, int M,
                               int N, int K, int dtype, void* stream) {
  auto f = [](const void* p) { return (const float*)p; };
  if (dtype == 0)
    return launch(a, w, M, N, K, ScaleOut<float>{(float*)y, f(sx), f(w_scale), f(bias), N},
                  stream);
  if (dtype == 1)
    return launch(a, w, M, N, K,
                  ScaleOut<__nv_bfloat16>{(__nv_bfloat16*)y, f(sx), f(w_scale), f(bias), N},
                  stream);
  return (int)cudaErrorInvalidValue;
}
