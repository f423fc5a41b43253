// Not on the path: the persistent design of the quantize pass that measured
// slower than csrc/quantize.cu (kernel_variants.py times it as a variant;
// the package builds csrc/*.cu only). Each warp of persistent blocks fills
// its own ring of 1-4 KB stages by bulk copies, R rows a stage, and walks
// its share of the rows through it.
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
// reciprocal is an ulp off in some rows and flips a rounding), the
// conversion to int rounds half to even (__float2int_rn, as rintf and
// torch.round), and fmaxf clamps as torch.clamp(min=).
//
// Bound on the H100: the bytes, M*K*(size + 1) + 4*M (44 MB at the path's
// 28,672 x 512 bf16, 0.0132 ms at 3.35 TB/s). The division is the longest
// part of the arithmetic (an IEEE division a value), but at ~12
// instructions a value it stays below the bytes' time.
//
// What held the earlier design back (kernel_variants.py quantize --split,
// PERF.md section 6): one warp a row of 256-thread blocks, each lane
// loading its 32 bytes, then the dependent chain of max, division and
// stores; host-launched its time was the wrapper's, flat in M.
//
// Design: persistent blocks of WARPS warps, one block an SM, each warp its
// own producer and consumer. A warp's ring of NS stages of STAGE bytes
// (STAGE the smallest of 1, 2 or 4 KB that holds a row) is filled by bulk
// copies (cp.async.bulk behind one mbarrier a stage, issued by lane 0
// ahead of use): a stage takes R consecutive rows, contiguous in x, so
// several rows' loads are in flight while the warp reduces and quantizes
// earlier ones. The warp takes the max of each row from shared memory,
// then quantizes it there, writing xq over the stage's first bytes (each
// row's int8 land on bytes its own or earlier rows' values held, read
// before), and one bulk store writes the R rows of xq (contiguous in xq
// too) while the next stages load; where K is no multiple of 16 (the rows
// of xq not 16-byte aligned) lanes store 8 bytes each instead. Rows
// longer than 4 KB (K past 2048 in bf16, 1024 in f32) pass through the
// ring in 4 KB chunks twice, once for the max and once to quantize.
#include <algorithm>

#include "wgmma.cuh"

namespace {

constexpr int WARPS = 16;           // warps a block
constexpr int NT = WARPS * 32;
constexpr int LOADS_PER_WARP = 6;   // a stage holds fewer rows while a warp would get fewer

// Blocks an SM and the bytes of a warp's ring, by stage: the warps' shares
// of 192 KB of shared memory an SM. Stages of 1 or 2 KB run two blocks an
// SM, whose warps' IEEE divisions then hide each other's latency.
template <int STAGE> struct Shape {
  static constexpr int BLOCKS = STAGE <= 2048 ? 2 : 1;
  static constexpr int RING = 12 * 1024 / BLOCKS;
  static constexpr int NS = RING / STAGE;
  static constexpr size_t SMEM = (size_t)WARPS * RING + (size_t)WARPS * NS * 8;
  static_assert(NS >= 2, "a ring holds two stages");
};

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

// the largest |v| of n8 chunks of 8 values at p, this lane's chunks
template <typename T>
__device__ __forceinline__ float chunk_amax(const T* p, int n8, int lane, float amax) {
#pragma unroll 2
  for (int c = lane; c < n8; c += 32) {
    float v[8];
    load8(p + 8 * c, v);
#pragma unroll
    for (int e = 0; e < 8; ++e) amax = fmaxf(amax, fabsf(v[e]));
  }
  return amax;
}

// four ints in [-127, 127] as the bytes q0 (lowest) .. q3 of a word: two
// cvt.pack.sat, each packing two values beside the lower half of its last
// operand shifted up by 16
__device__ __forceinline__ uint32_t pack4(int q0, int q1, int q2, int q3) {
  uint32_t hi, d;
  asm("cvt.pack.sat.s8.s32.b32 %0, %1, %2, 0;\n" : "=r"(hi) : "r"(q3), "r"(q2));
  asm("cvt.pack.sat.s8.s32.b32 %0, %1, %2, %3;\n" : "=r"(d) : "r"(q1), "r"(q0), "r"(hi));
  return d;
}

// round_half_even(v / s) as int8: __float2int_rn rounds half to even as
// rintf does, in the conversion itself
__device__ __forceinline__ uint2 quantize8(const float v[8], float s) {
  int q[8];
#pragma unroll
  for (int e = 0; e < 8; ++e) q[e] = __float2int_rn(__fdiv_rn(v[e], s));
  return make_uint2(pack4(q[0], q[1], q[2], q[3]), pack4(q[4], q[5], q[6], q[7]));
}

__device__ __forceinline__ float row_scale(float amax) {
  return __fdiv_rn(fmaxf(stk::warp_max(amax), 1e-12f), 127.0f);
}

// a warp's ring and its stages' barriers in the block's shared memory
template <int STAGE>
struct Ring {
  static constexpr int NS = Shape<STAGE>::NS, RING = Shape<STAGE>::RING;
  uint8_t* base;
  uint64_t* full;
  __device__ __forceinline__ Ring(unsigned char* smem, int warp, int lane)
      : base(smem + warp * RING),
        full(reinterpret_cast<uint64_t*>(smem + WARPS * RING) + warp * NS) {
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

// One row of K values at `in` (shared memory) by the L lanes of a group
// (sub: this lane's place in it): the max over the group (shuffles within
// the L lanes, which are L consecutive lanes), sx, and xq written from the
// registers, P chunks of 8 values a step (P = 2: 16-byte stores, K a
// multiple of 16). An invalid group (past the stage's rows) takes part in
// the shuffles only.
template <typename T, int P>
__device__ __forceinline__ void quantize_row(const T* in, int8_t* out, float* sx_row, bool valid,
                                             int K, int L, int sub) {
  const int steps = K / (8 * P);
  float amax = 0.0f;
  if (valid) {
#pragma unroll 2
    for (int s = sub; s < steps; s += L)
#pragma unroll
      for (int p = 0; p < P; ++p) {
        float v[8];
        load8(in + 8 * (P * s + p), v);
#pragma unroll
        for (int e = 0; e < 8; ++e) amax = fmaxf(amax, fabsf(v[e]));
      }
  }
  for (int o = L / 2; o > 0; o >>= 1) amax = fmaxf(amax, __shfl_xor_sync(0xffffffffu, amax, o));
  const float sc = __fdiv_rn(fmaxf(amax, 1e-12f), 127.0f);
  if (!valid) return;
  if (sub == 0) *sx_row = sc;
#pragma unroll 2
  for (int s = sub; s < steps; s += L) {
    uint2 q[P];
#pragma unroll
    for (int p = 0; p < P; ++p) {
      float v[8];
      load8(in + 8 * (P * s + p), v);
      q[p] = quantize8(v, sc);
    }
    if constexpr (P == 2)
      *reinterpret_cast<uint4*>(out + 16 * s) = make_uint4(q[0].x, q[0].y, q[1].x, q[1].y);
    else
      *reinterpret_cast<uint2*>(out + 8 * s) = q[0];
  }
}

// The same with the lane's values held in registers from one read of the
// stage, 16 values (16 bytes of xq) a step, at most H steps a lane: the
// path's case (K a multiple of 16, K / 16 <= H L).
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
  const float sc = __fdiv_rn(fmaxf(amax, 1e-12f), 127.0f);
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
        q[p] = quantize8(v, sc);
      }
      *reinterpret_cast<uint4*>(out + 16 * s) = make_uint4(q[0].x, q[0].y, q[1].x, q[1].y);
    }
  }
}

// Rows of at most STAGE bytes, R (a power of 2 up to 8) to a stage: this
// warp's units are gw + i tw (rows R unit .. R unit + R - 1), its R rows
// taken at once by groups of 32 / R lanes.
template <typename T, int STAGE>
__global__ void __launch_bounds__(NT, Shape<STAGE>::BLOCKS)
quantize_rows(const T* __restrict__ x, int8_t* __restrict__ xq, float* __restrict__ sx, int M,
              int K, int R, int units) {
  extern __shared__ __align__(128) unsigned char smem[];
  constexpr int NS = Ring<STAGE>::NS;
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const Ring<STAGE> ring(smem, warp, lane);
  const int gw = blockIdx.x * WARPS + warp, tw = gridDim.x * WARPS;
  const int n_units = gw < units ? (units - 1 - gw) / tw + 1 : 0;
  const int L = 32 / R, grp = lane / L, sub = lane % L;
  auto first_row = [&](int i) { return (gw + i * tw) * R; };
  auto issue = [&](int i) {  // lane 0
    if (i >= n_units) return;
    const int r0 = first_row(i), n = min(R, M - r0);
    ring.load(i, x + (size_t)r0 * K, (uint32_t)(n * K * sizeof(T)));
  };
  if (lane == 0)
    for (int i = 0; i < NS; ++i) issue(i);
  for (int i = 0; i < n_units; ++i) {
    const int r0 = first_row(i), n = min(R, M - r0);
    const bool valid = grp < n;
    const int row = r0 + (valid ? grp : 0);
    const T* in = reinterpret_cast<const T*>(ring.stage(i)) + (size_t)(valid ? grp : 0) * K;
    ring.wait(i);
    if (K % 16 == 0 && K / 16 <= (4 / U<T>) * L)
      quantize_row_held<T>(in, xq + (size_t)row * K, sx + row, valid, K, L, sub);
    else if (K % 16 == 0)
      quantize_row<T, 2>(in, xq + (size_t)row * K, sx + row, valid, K, L, sub);
    else
      quantize_row<T, 1>(in, xq + (size_t)row * K, sx + row, valid, K, L, sub);
    __syncwarp();  // every lane is done with the stage: refill it
    if (lane == 0) issue(i + NS);
  }
}

// Rows longer than a stage: this warp's rows are gw + i tw, each through
// the ring in chunks of STAGE bytes twice (the max, then the quantization,
// lanes storing 8 bytes each).
template <typename T>
__global__ void __launch_bounds__(NT, 1)
quantize_long_rows(const T* __restrict__ x, int8_t* __restrict__ xq, float* __restrict__ sx,
                   int M, int K) {
  constexpr int STAGE = 4096, NS = Ring<STAGE>::NS, CE = STAGE / (int)sizeof(T);
  extern __shared__ __align__(128) unsigned char smem[];
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const Ring<STAGE> ring(smem, warp, lane);
  const int gw = blockIdx.x * WARPS + warp, tw = gridDim.x * WARPS;
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
          amax = chunk_amax(in, n8, lane, amax);
        } else {
          for (int c = lane; c < n8; c += 32) {
            float v[8];
            load8(in + 8 * c, v);
            *reinterpret_cast<uint2*>(xq + (size_t)row * K + e0 + 8 * c) = quantize8(v, s);
          }
        }
        __syncwarp();
        if (lane == 0) issue(j + NS);
      }
      if (pass == 0) {
        s = row_scale(amax);
        if (lane == 0) sx[row] = s;
      }
    }
  }
}

template <typename T, int STAGE>
int launch_rows(const T* x, int8_t* xq, float* sx, int M, int K, int R, int sms,
                cudaStream_t st) {
  const int units = (M + R - 1) / R;
  const int blocks = std::min(sms * Shape<STAGE>::BLOCKS, (units + WARPS - 1) / WARPS);
  constexpr size_t smem = Shape<STAGE>::SMEM;
  auto kernel = quantize_rows<T, STAGE>;
  static size_t smem_set[stk::kMaxDevices] = {};  // one per instantiation (not per type)
  if (int err = stk::allow_dynamic_smem(kernel, smem, smem_set)) return err;
  kernel<<<blocks, NT, smem, st>>>(x, xq, sx, M, K, R, units);
  return (int)cudaGetLastError();
}

template <typename T>
int launch(const void* x_, void* xq_, void* sx_, int M, int K, cudaStream_t st) {
  const T* x = (const T*)x_;
  int8_t* xq = (int8_t*)xq_;
  float* sx = (float*)sx_;
  int sms = 0;
  if (int err = stk::sm_count(sms)) return err;
  const int row_bytes = K * (int)sizeof(T);
  if (row_bytes <= 4096) {
    // rows a stage (a power of 2): as many as 4 KB hold, up to 8, while every
    // warp of the card still gets LOADS_PER_WARP stages, else fewer; the
    // stage the smallest of 1, 2 and 4 KB that holds them
    const int most = std::min(8, std::min(4096 / row_bytes, M / (2 * sms * WARPS * LOADS_PER_WARP)));
    int R = 1;
    while (2 * R <= most) R *= 2;
    if (R * row_bytes <= 1024) return launch_rows<T, 1024>(x, xq, sx, M, K, R, sms, st);
    if (R * row_bytes <= 2048) return launch_rows<T, 2048>(x, xq, sx, M, K, R, sms, st);
    return launch_rows<T, 4096>(x, xq, sx, M, K, R, sms, st);
  }
  constexpr size_t smem = Shape<4096>::SMEM;
  auto kernel = quantize_long_rows<T>;
  static size_t smem_set[stk::kMaxDevices] = {};
  if (int err = stk::allow_dynamic_smem(kernel, smem, smem_set)) return err;
  kernel<<<std::min(sms, (M + WARPS - 1) / WARPS), NT, smem, st>>>(x, xq, sx, M, K);
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
