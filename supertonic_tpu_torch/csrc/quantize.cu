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
// reciprocal is an ulp off in some rows and flips a rounding), the
// conversion to int rounds half to even (__float2int_rn, as rintf and
// torch.round), and fmaxf clamps as torch.clamp(min=).
//
// Bound on the H100: the bytes, M*K*(size + 1) + 4*M (44 MB at the path's
// 28,672 x 512 bf16, 0.0132 ms at 3.35 TB/s). The IEEE division is the
// longest part of the arithmetic (a product with 1 / sx in its place
// takes ~30% off the time at that shape).
//
// What the split found (kernel_variants.py quantize --split, PERF.md
// section 6): the one-warp-a-row design this replaces was never slow on
// the card; 0.035 ms a launch, flat in M, was the Python wrapper's host
// time between back-to-back launches. From a replayed graph it takes
// 0.015 ms at the cell's shape, its loads and row max alone 0.0065.
//
// Design: each warp stages R whole rows (R a power of 2, up to 2 KB of
// them, or one row of up to 4 KB) into its own slot of shared memory with
// one bulk copy (cp.async.bulk, completing on the warp's mbarrier), the
// rows contiguous in x; groups of 32 / R lanes take a row each, hold its
// values in registers from one read of the slot, reduce the row's max
// over the group with shuffles, and write xq from the registers in 16-byte
// stores (8-byte where K is no multiple of 16). Blocks of 4 warps, one
// slot a warp, as many blocks as the rows need (R is smaller where fewer
// rows would leave SMs idle): the card's scheduler keeps many warps'
// copies in flight while others quantize. Persistent blocks walking rings
// of stages (csrc/variants/quantize_persistent_ring.cu) measured slower at
// every shape of the path (0.0243 against 0.0170 ms from graphs at 28,672
// x 512). Rows longer than 4 KB (K past 2048 in bf16, 1024 in f32)
// pass through a persistent warp's ring in 4 KB chunks twice, once for the
// max and once to quantize.
#include <algorithm>

#include "quantize8.cuh"
#include "wgmma.cuh"

namespace {

constexpr int WARPS = 4;            // warps a block of the row kernel
constexpr int SLOT = 4096;          // bytes of a warp's slot: its rows
constexpr int STAGED = 2048;        // bytes of rows a warp stages, or one longer row
constexpr int LONG_WARPS = 16;      // the long-row kernel: warps a block, one block an SM,
constexpr int STAGE = 4096, NS = 3;  // each warp a ring of NS chunks of STAGE bytes

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
template <typename T> __device__ __forceinline__ void load8(const T* p, float v[8]) {
  uint4 raw[U<T>];
  load_raw(p, raw);
  to_float<T>(raw, v);
}

// the largest |v| of this lane's chunks of 8 values at p: chunks first,
// first + stride, ... below n8
template <typename T>
__device__ __forceinline__ float chunk_amax(const T* p, int n8, int first, int stride,
                                            float amax) {
#pragma unroll 2
  for (int c = first; c < n8; c += stride) {
    float v[8];
    load8(p + 8 * c, v);
#pragma unroll
    for (int e = 0; e < 8; ++e) amax = fmaxf(amax, fabsf(v[e]));
  }
  return amax;
}

// One row of K values at `in` (shared memory) by the L lanes of a group
// (sub: this lane's place in it, the group L consecutive lanes): the max
// over the group by shuffles, sx, and xq. The lane's values are held in
// registers from one read of the slot, 16 values (16 bytes of xq) a step,
// at most H steps a lane: K a multiple of 16 and K / 16 <= H L, which every
// slot's R rows of at most 2 KB (or one row of at most 4 KB) meet. An
// invalid group (past the slot's rows) takes part in the shuffles only.
template <typename T>
__device__ __forceinline__ void quantize_row_held(const T* in, int8_t* out, float* sx_row,
                                                  bool valid, int K, int L, int sub) {
  constexpr int H = 4 / U<T>, W = 2 * U<T>;  // steps a lane, 16-byte words a step
  const int steps = K / 16;
  uint4 raw[H][W];
  float amax = 0.0f;
#pragma unroll
  for (int h = 0; h < H; ++h) {
    const int s = sub + h * L;
    if (valid && s < steps) {
#pragma unroll
      for (int w = 0; w < W; ++w) raw[h][w] = reinterpret_cast<const uint4*>(in + 16 * s)[w];
#pragma unroll
      for (int p = 0; p < 2; ++p) {
        float v[8];
        to_float<T>(&raw[h][p * U<T>], v);
#pragma unroll
        for (int e = 0; e < 8; ++e) amax = fmaxf(amax, fabsf(v[e]));
      }
    }
  }
  for (int o = L / 2; o > 0; o >>= 1) amax = fmaxf(amax, __shfl_xor_sync(0xffffffffu, amax, o));
  const float sc = stk::quant_scale(amax);
  if (!valid) return;
  if (sub == 0) *sx_row = sc;
#pragma unroll
  for (int h = 0; h < H; ++h) {
    const int s = sub + h * L;
    if (s < steps) {
      uint2 q[2];
#pragma unroll
      for (int p = 0; p < 2; ++p) {
        float v[8];
        to_float<T>(&raw[h][p * U<T>], v);
        q[p] = stk::quantize8(v, sc);
      }
      *reinterpret_cast<uint4*>(out + 16 * s) = make_uint4(q[0].x, q[0].y, q[1].x, q[1].y);
    }
  }
}

// R rows (a power of 2) a warp, groups of 32 / R lanes a row: unit
// blockIdx.x WARPS + warp is rows R unit .. R unit + R - 1.
template <typename T>
__global__ void __launch_bounds__(WARPS * 32)
quantize_rows(const T* __restrict__ x, int8_t* __restrict__ xq, float* __restrict__ sx, int M,
              int K, int R, int units) {
  __shared__ __align__(128) uint8_t slot[WARPS][SLOT];
  __shared__ uint64_t full[WARPS];
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const int unit = blockIdx.x * WARPS + warp;
  if (unit >= units) return;
  const int r0 = unit * R, n = min(R, M - r0);
  if (lane == 0) {
    stk::mbar_init(&full[warp], 1);
    stk::mbar_fence_init();
    const uint32_t bytes = (uint32_t)(n * K * sizeof(T));
    stk::mbar_arrive_tx(&full[warp], bytes);
    stk::bulk_load(slot[warp], x + (size_t)r0 * K, bytes, &full[warp]);
  }
  const int L = 32 / R, grp = lane / L, sub = lane % L;
  const bool valid = grp < n;
  const int row = r0 + (valid ? grp : 0);
  const T* in = reinterpret_cast<const T*>(slot[warp]) + (size_t)(valid ? grp : 0) * K;
  __syncwarp();
  stk::mbar_wait(&full[warp], 0);
  if (K % 16 == 0) {
    quantize_row_held<T>(in, xq + (size_t)row * K, sx + row, valid, K, L, sub);
    return;
  }
  // K an odd multiple of 8: 8 values a step, read from the slot twice,
  // 8-byte stores (the rows of xq are 8-byte aligned)
  float amax = 0.0f;
  if (valid) amax = chunk_amax(in, K / 8, sub, L, amax);
  for (int o = L / 2; o > 0; o >>= 1) amax = fmaxf(amax, __shfl_xor_sync(0xffffffffu, amax, o));
  const float sc = stk::quant_scale(amax);
  if (!valid) return;
  if (sub == 0) sx[row] = sc;
  for (int c = sub; c < K / 8; c += L) {
    float v[8];
    load8(in + 8 * c, v);
    *reinterpret_cast<uint2*>(xq + (size_t)row * K + 8 * c) = stk::quantize8(v, sc);
  }
}

// a warp's ring and its stages' barriers in the block's shared memory
struct Ring {
  uint8_t* base;
  uint64_t* full;
  __device__ __forceinline__ Ring(unsigned char* smem, int warp, int lane)
      : base(smem + warp * NS * STAGE),
        full(reinterpret_cast<uint64_t*>(smem + LONG_WARPS * NS * STAGE) + warp * NS) {
    if (lane == 0) {
#pragma unroll
      for (int s = 0; s < NS; ++s) stk::mbar_init(&full[s], 1);
      stk::mbar_fence_init();
    }
    __syncwarp();
  }
  __device__ __forceinline__ uint8_t* stage(int i) const { return base + (i % NS) * STAGE; }
  // lane 0: load i's bytes into its stage
  __device__ __forceinline__ void load(int i, const void* src, uint32_t bytes) const {
    stk::mbar_arrive_tx(&full[i % NS], bytes);
    stk::bulk_load(stage(i), src, bytes, &full[i % NS]);
  }
  __device__ __forceinline__ void wait(int i) const { stk::mbar_wait(&full[i % NS], (i / NS) & 1); }
};

// Rows longer than a stage: this warp's rows are gw + i tw, each through
// the ring in chunks of STAGE bytes twice (the max, then the quantization,
// lanes storing 8 bytes each).
template <typename T>
__global__ void __launch_bounds__(LONG_WARPS * 32, 1)
quantize_long_rows(const T* __restrict__ x, int8_t* __restrict__ xq, float* __restrict__ sx,
                   int M, int K) {
  constexpr int CE = STAGE / (int)sizeof(T);
  extern __shared__ __align__(128) unsigned char smem[];
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const Ring ring(smem, warp, lane);
  const int gw = blockIdx.x * LONG_WARPS + warp, tw = gridDim.x * LONG_WARPS;
  const int chunks = (K + CE - 1) / CE;
  const int n_rows = gw < M ? (M - 1 - gw) / tw + 1 : 0;
  const int n_loads = 2 * chunks * n_rows;
  auto issue = [&](int j) {  // lane 0: load j is chunk j % chunks of row j / (2 chunks)
    if (j >= n_loads) return;
    const int row = gw + (j / (2 * chunks)) * tw, e0 = (j % chunks) * CE;
    ring.load(j, x + (size_t)row * K + e0, (uint32_t)(min(CE, K - e0) * sizeof(T)));
  };
  if (lane == 0)
    for (int j = 0; j < NS; ++j) issue(j);
  int j = 0;
  for (int i = 0; i < n_rows; ++i) {
    const int row = gw + i * tw;
    float amax = 0.0f, s = 0.0f;
    for (int pass = 0; pass < 2; ++pass) {
      for (int ch = 0; ch < chunks; ++ch, ++j) {
        const int e0 = ch * CE, n8 = min(CE, K - e0) / 8;
        const T* in = reinterpret_cast<const T*>(ring.stage(j));
        ring.wait(j);
        if (pass == 0) {
          amax = chunk_amax(in, n8, lane, 32, amax);
        } else {
          for (int c = lane; c < n8; c += 32) {
            float v[8];
            load8(in + 8 * c, v);
            *reinterpret_cast<uint2*>(xq + (size_t)row * K + e0 + 8 * c) = stk::quantize8(v, s);
          }
        }
        __syncwarp();
        if (lane == 0) issue(j + NS);
      }
      if (pass == 0) {
        s = stk::quant_scale(stk::warp_max(amax));
        if (lane == 0) sx[row] = s;
      }
    }
  }
}

template <typename T>
int launch(const void* x_, void* xq_, void* sx_, int M, int K, cudaStream_t st) {
  const T* x = (const T*)x_;
  int8_t* xq = (int8_t*)xq_;
  float* sx = (float*)sx_;
  const int row_bytes = K * (int)sizeof(T);
  int sms = 0;
  if (int err = stk::sm_count(sms)) return err;
  if (row_bytes <= SLOT) {
    // rows a warp: as many as STAGED bytes hold, a power of 2 up to 8, while
    // the blocks still cover every SM
    int R = 1;
    while (2 * R <= 8 && 2 * R * row_bytes <= STAGED && 2 * R * sms * WARPS <= M) R *= 2;
    const int units = (M + R - 1) / R;
    quantize_rows<T><<<(units + WARPS - 1) / WARPS, WARPS * 32, 0, st>>>(x, xq, sx, M, K, R,
                                                                         units);
    return (int)cudaGetLastError();
  }
  constexpr size_t smem = (size_t)LONG_WARPS * NS * (STAGE + 8);
  auto kernel = quantize_long_rows<T>;
  static size_t smem_set[stk::kMaxDevices] = {};
  if (int err = stk::allow_dynamic_smem(kernel, smem, smem_set)) return err;
  kernel<<<std::min(sms, (M + LONG_WARPS - 1) / LONG_WARPS), LONG_WARPS * 32, smem, st>>>(
      x, xq, sx, M, K);
  return (int)cudaGetLastError();
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
