// The tensor-core GEMM shared by the bf16 FFN products (csrc/ffn.cu) and
// the int8 product (csrc/int8_matmul.cu):
//   C [M, N] = A [M, K] . W [N, K]^T,  both operands contiguous in K,
// on mma.sync (bf16 m16n8k16 into f32, or int8 m16n8k32 into int32: both
// take 32 bytes of K a step, with the same ldmatrix fragments), handing
// each 8 consecutive columns of C to the caller's epilogue.
//
// Design: a block tile of BM x BN, warps of WM x WN; K in steps of 128
// bytes through a cp.async ring of STAGES stages, rows XOR-swizzled by
// 16-byte chunk so that every ldmatrix.x4 is free of bank conflicts; one
// block barrier a K step. Within a K step the loads run ahead of the
// products in program order (the PTX helpers are volatile, so the compiler
// keeps the order): the A fragments of 32-byte step kk + 1 and the W
// fragments of the next pair of n8 tiles load while the products before
// them run. Each thread copies one 16-byte chunk column of every NT/8-th
// row by walking two pointers (not unrolled: a pointer per copy held ~30
// registers across the mainloop). After the mainloop each warp stages its
// accumulators through the freed ring and the epilogue reads 8 columns a
// lane. Rows past M or N, and chunks past K, are zero-filled; the epilogue
// is called for rows < M and columns < N only.
#pragma once

#include "common.cuh"

namespace stk {

// the two products, each on 32 bytes of K
struct MmaBf16 {  // c (16x8 f32) += a (16x16 bf16) . b (16x8 bf16)
  using In = __nv_bfloat16;
  using Acc = float;
  static __device__ __forceinline__ void mma(Acc c[4], const uint32_t a[4], uint32_t b0,
                                             uint32_t b1) {
    mma_bf16(c, a, b0, b1);
  }
};
struct MmaS8 {  // c (16x8 s32) += a (16x32 s8) . b (32x8 s8), exact
  using In = int8_t;
  using Acc = int;
  static __device__ __forceinline__ void mma(Acc c[4], const uint32_t a[4], uint32_t b0,
                                             uint32_t b1) {
    asm volatile(
        "mma.sync.aligned.m16n8k32.row.col.s32.s8.s8.s32 {%0, %1, %2, %3}, "
        "{%4, %5, %6, %7}, {%8, %9}, {%0, %1, %2, %3};\n"
        : "+r"(c[0]), "+r"(c[1]), "+r"(c[2]), "+r"(c[3])
        : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
  }
};

template <int BM_, int BN_, int WM_, int WN_, int STAGES_, int BLOCKS_PER_SM_>
struct GemmShape {
  static constexpr int BM = BM_, BN = BN_, WM = WM_, WN = WN_;
  static constexpr int STAGES = STAGES_, BLOCKS_PER_SM = BLOCKS_PER_SM_;
  static constexpr int ROW = 128;                  // bytes of K a stage row holds
  static constexpr int CHK = ROW / 16;             // its 16-byte chunks
  static constexpr int WARPS_N = BN / WN;
  static constexpr int NT = (BM / WM) * WARPS_N * 32;
  static constexpr int MI = WM / 16, NJ = WN / 8;  // m16 and n8 tiles of a warp tile
  static constexpr int STAGE = (BM + BN) * ROW;    // bytes of a ring stage
  static constexpr int SMEM = STAGES * STAGE;
  static constexpr int SLD = WN + 8;               // pitch of the 4-byte output staging
  static_assert((NT / 32) * WM * SLD * 4 <= SMEM, "the output staging reuses the ring");
  static_assert(NJ % 4 == 0, "an even number of n8 tile pairs: each step starts in fb[0]");
  static_assert((NT / CHK) % 8 == 0, "a thread's rows share row % 8");
};

__device__ __forceinline__ void store2(float* p, float a, float b) {
  *reinterpret_cast<float2*>(p) = make_float2(a, b);
}
__device__ __forceinline__ void store2(int* p, int a, int b) {
  *reinterpret_cast<int2*>(p) = make_int2(a, b);
}
__device__ __forceinline__ void load8(const float* p, float v[8]) {
  const float4 lo = *reinterpret_cast<const float4*>(p);
  const float4 hi = *reinterpret_cast<const float4*>(p + 4);
  v[0] = lo.x; v[1] = lo.y; v[2] = lo.z; v[3] = lo.w;
  v[4] = hi.x; v[5] = hi.y; v[6] = hi.z; v[7] = hi.w;
}
__device__ __forceinline__ void load8(const int* p, int v[8]) {
  const int4 lo = *reinterpret_cast<const int4*>(p);
  const int4 hi = *reinterpret_cast<const int4*>(p + 4);
  v[0] = lo.x; v[1] = lo.y; v[2] = lo.z; v[3] = lo.w;
  v[4] = hi.x; v[5] = hi.y; v[6] = hi.z; v[7] = hi.w;
}

// byte offset of 16-byte chunk `chunk` of row `row` in a swizzled stage
__device__ __forceinline__ int swz_row(int row, int chunk) {
  return row * 128 + ((chunk ^ (row & 7)) << 4);
}

// rows [0, rows) of one K step (128 bytes from byte k0b) of a row-major
// operand whose rows are Kb bytes long into a swizzled stage; rows past
// valid_rows and chunks past Kb are zero-filled
template <typename S>
__device__ __forceinline__ void load_rows(uint8_t* dst, const uint8_t* src, int rows,
                                          int valid_rows, int Kb, int k0b, int tid) {
  constexpr int STEP = S::NT / S::CHK;
  const int r0 = tid / S::CHK, ch = tid % S::CHK;
  const bool in_k = k0b + ch * 16 < Kb;
  const uint8_t* first = src;  // row 0 of the tile, always inside the tensor
  dst += swz_row(r0, ch);
  src += (size_t)r0 * Kb + k0b + ch * 16;
#pragma unroll 1
  for (int r = r0; r < rows; r += STEP) {
    const bool valid = in_k && r < valid_rows;
    cp_async16(smem_u32(dst), valid ? src : first, valid);
    dst += STEP * 128;
    src += (size_t)STEP * Kb;
  }
}

template <typename Mma, typename S, typename Epi>
__global__ void __launch_bounds__(S::NT, S::BLOCKS_PER_SM)
mma_gemm(const typename Mma::In* __restrict__ A, const typename Mma::In* __restrict__ W,
         int M, int N, int K, int n_tiles, Epi epi) {
  using Acc = typename Mma::Acc;
  constexpr int MI = S::MI, NP = S::NJ / 2, KK = S::ROW / 32;
  extern __shared__ __align__(128) uint8_t smem[];
  const int tid = threadIdx.x, warp = tid >> 5, lane = tid & 31;
  // n fastest: neighbouring blocks share their A rows in L2
  const int m0 = (blockIdx.x / n_tiles) * S::BM, n0 = (blockIdx.x % n_tiles) * S::BN;
  const int wm = (warp / S::WARPS_N) * S::WM, wn = (warp % S::WARPS_N) * S::WN;
  const int Kb = K * (int)sizeof(typename Mma::In);
  const int kt_n = (Kb + S::ROW - 1) / S::ROW;
  const uint8_t* a_rows = reinterpret_cast<const uint8_t*>(A) + (size_t)m0 * Kb;
  const uint8_t* w_rows = reinterpret_cast<const uint8_t*>(W) + (size_t)n0 * Kb;
  auto load_stage = [&](int stage, int kt) {
    uint8_t* st = smem + stage * S::STAGE;
    load_rows<S>(st, a_rows, S::BM, M - m0, Kb, kt * S::ROW, tid);
    load_rows<S>(st + S::BM * S::ROW, w_rows, S::BN, N - n0, Kb, kt * S::ROW, tid);
  };
  // ldmatrix addresses. A: matrices rows (0-7 | 8-15) x bytes (0-15 |
  // 16-31) = a0..a3; W: matrices (n8 tile 2jp | 2jp + 1) x bytes (0-15 |
  // 16-31). Each lane's row is 8-aligned plus lane % 8, so its swizzled
  // chunk at 32-byte step kk is (2 kk + half) ^ (lane % 8) = its step-0
  // chunk ^ 2 kk.
  const uint32_t a_lane = (wm + (lane & 15)) * S::ROW, a_x = ((lane >> 4) ^ (lane & 7)) << 4;
  const uint32_t b_lane = (S::BM + wn + ((lane >> 4) << 3) + (lane & 7)) * S::ROW;
  const uint32_t b_x = (((lane >> 3) & 1) ^ (lane & 7)) << 4;
  const uint32_t ring = smem_u32(smem);

  Acc acc[MI][S::NJ][4] = {};
#pragma unroll
  for (int s = 0; s < S::STAGES - 1; ++s) {
    if (s < kt_n) load_stage(s, s);
    cp_async_commit();
  }
  uint32_t fa[2][MI][4], fb[2][4];
  for (int kt = 0; kt < kt_n; ++kt) {
    cp_async_wait<S::STAGES - 2>();  // step kt has landed
    __syncthreads();                 // and every warp is done with step kt - 1
    const int next = kt + S::STAGES - 1;
    if (next < kt_n) load_stage(next % S::STAGES, next);
    cp_async_commit();
    const uint32_t st = ring + (kt % S::STAGES) * S::STAGE;
#pragma unroll
    for (int i = 0; i < MI; ++i) ldmatrix_x4(fa[0][i], st + a_lane + a_x + i * 16 * S::ROW);
    ldmatrix_x4(fb[0], st + b_lane + b_x);
#pragma unroll
    for (int kk = 0; kk < KK; ++kk) {
      const uint32_t x0 = kk << 5, x1 = (kk + 1) << 5;
#pragma unroll
      for (int jp = 0; jp < NP; ++jp) {
        if (jp == 0 && kk + 1 < KK)
#pragma unroll
          for (int i = 0; i < MI; ++i)
            ldmatrix_x4(fa[(kk + 1) & 1][i], st + a_lane + (a_x ^ x1) + i * 16 * S::ROW);
        if (jp + 1 < NP)
          ldmatrix_x4(fb[(jp + 1) & 1], st + b_lane + (b_x ^ x0) + (jp + 1) * 16 * S::ROW);
        else if (kk + 1 < KK)  // NP is even: step kk + 1 starts in fb[0]
          ldmatrix_x4(fb[(jp + 1) & 1], st + b_lane + (b_x ^ x1));
#pragma unroll
        for (int i = 0; i < MI; ++i) {
          Mma::mma(acc[i][2 * jp], fa[kk & 1][i], fb[jp & 1][0], fb[jp & 1][1]);
          Mma::mma(acc[i][2 * jp + 1], fa[kk & 1][i], fb[jp & 1][2], fb[jp & 1][3]);
        }
      }
    }
  }
  cp_async_wait<0>();
  __syncthreads();  // the ring is free: each warp stages its tile there

  Acc* cs = reinterpret_cast<Acc*>(smem) + warp * S::WM * S::SLD;
  const int g = lane >> 2, t = lane & 3;
#pragma unroll
  for (int i = 0; i < MI; ++i)
#pragma unroll
    for (int j = 0; j < S::NJ; ++j) {
      const Acc* f = acc[i][j];
      const int r = i * 16 + g, c = j * 8 + t * 2;
      store2(&cs[r * S::SLD + c], f[0], f[1]);
      store2(&cs[(r + 8) * S::SLD + c], f[2], f[3]);
    }
  __syncwarp();
  // LPR lanes x 8 columns = one row of the warp tile; 32 / LPR rows a pass
  constexpr int LPR = S::WN / 8, RPP = 32 / LPR;
#pragma unroll 4
  for (int p = 0; p < S::WM / RPP; ++p) {
    const int r = p * RPP + lane / LPR, c = (lane % LPR) * 8;
    const int row = m0 + wm + r, col = n0 + wn + c;
    if (row >= M || col >= N) continue;
    Acc v[8];
    load8(&cs[r * S::SLD + c], v);
    epi(row, col, v);
  }
}

// launches mma_gemm<Mma, S, Epi> over C [M, N]; returns a CUDA error code
template <typename Mma, typename S, typename Epi>
int launch_mma_gemm(const typename Mma::In* A, const typename Mma::In* W, int M, int N, int K,
                    Epi epi, cudaStream_t st) {
  static size_t smem_set[kMaxDevices] = {};  // one per instantiation
  if (int err = allow_dynamic_smem(mma_gemm<Mma, S, Epi>, S::SMEM, smem_set)) return err;
  const int n_tiles = (N + S::BN - 1) / S::BN;
  const long long blocks = (long long)((M + S::BM - 1) / S::BM) * n_tiles;
  if (M < 1 || N < 1 || K < 1 || blocks > 0x7fffffff) return (int)cudaErrorInvalidValue;
  mma_gemm<Mma, S, Epi><<<(unsigned)blocks, S::NT, S::SMEM, st>>>(A, W, M, N, K, n_tiles, epi);
  return (int)cudaGetLastError();
}

}  // namespace stk
