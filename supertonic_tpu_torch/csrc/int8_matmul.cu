// The int8 product of the W8A8 linears:
//   C[M, N] (int32) = A[M, K] (int8) . W[N, K]^T (int8), exact integer sums.
//
// Replaces tools/int8_microbench.py:_pallas_i8_matmul, the Pallas int8 x int8
// -> int32 kernel (the product that the JAX package's _linear_w8a8 leaves to
// XLA's dot_general). Both operands are contiguous in K: A is the per-token
// quantized activation, W the quantized weight in torch's linear layout
// [dout, din]. |sum| <= 127^2 * K, far inside int32 for every K the path has.
//
// Bound on the H100: at the path's shapes (M = 40,960 rows, K = 512, N = 2048)
// the int32 output (4*M*N bytes, 336 MB) sets it: 0.107 ms at 3.35 TB/s,
// against 0.043 ms for the 2*M*N*K operations at 1,979 TOPS int8. So the
// output is written coalesced: each warp stages its accumulator tile through
// shared memory and stores whole 128-byte rows with 16-byte stores.
//
// Design: 128x128 block tiles, 8 warps of 64x32; K in steps of 64 bytes
// through a 3-stage cp.async ring in shared memory (rows padded to 80 bytes,
// so ldmatrix reads are free of bank conflicts); fragments by ldmatrix.x4;
// products by mma.sync.m16n8k32 s8.s8.s32 on the int8 tensor cores. Rows past
// M or N are zero-filled on load and masked on store; K is a multiple of 32
// (the zero fill covers the last half step). wgmma and TMA are later work.
#include <climits>

#include "common.cuh"

namespace {

using stk::cp_async16;
using stk::cp_async_commit;
using stk::cp_async_wait;
using stk::ldmatrix_x4;
using stk::smem_u32;

constexpr int BM = 128, BN = 128, BK = 64;       // block tile; K step (bytes)
constexpr int LDS = BK + 16;                      // shared row pitch (bytes)
constexpr int STAGES = 3;
constexpr int NT = 256;                           // 8 warps: 2 (M) x 4 (N)
constexpr int WM = 64, WN = 32;                   // warp tile
constexpr int STAGE_BYTES = (BM + BN) * LDS;
constexpr int SMEM_BYTES = STAGES * STAGE_BYTES;  // 61,440
constexpr int CLD = WN + 8;                       // output staging pitch (int32)
static_assert((NT / 32) * (WM / 2) * CLD * 4 <= SMEM_BYTES,
              "the output staging reuses the ring");

// c += a (16x32, row) . b (32x8, col), int8 in, int32 accumulators
__device__ __forceinline__ void mma_s8(int c[4], const uint32_t a[4], const uint32_t b[2]) {
  asm volatile(
      "mma.sync.aligned.m16n8k32.row.col.s32.s8.s8.s32 {%0, %1, %2, %3}, "
      "{%4, %5, %6, %7}, {%8, %9}, {%0, %1, %2, %3};\n"
      : "+r"(c[0]), "+r"(c[1]), "+r"(c[2]), "+r"(c[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b[0]), "r"(b[1]));
}

// One K step of the block's A rows, then its W rows, into a ring stage:
// (BM + BN) rows of BK bytes, 16 bytes a copy.
__device__ __forceinline__ void load_stage(uint8_t* st, const int8_t* A, const int8_t* W,
                                           int M, int N, int K, int m0, int n0, int k0,
                                           int tid) {
#pragma unroll
  for (int i = 0; i < (BM + BN) * (BK / 16) / NT; ++i) {
    const int c = tid + i * NT, r = c >> 2, kc = (c & 3) * 16;
    const bool is_a = r < BM;
    const int row = is_a ? m0 + r : n0 + r - BM;
    const int8_t* base = is_a ? A : W;
    const bool valid = row < (is_a ? M : N) && k0 + kc < K;
    cp_async16(smem_u32(st + r * LDS + kc),
               valid ? base + (size_t)row * K + k0 + kc : base, valid);
  }
}

__global__ void __launch_bounds__(NT)
int8_gemm(const int8_t* __restrict__ A, const int8_t* __restrict__ W,
          int32_t* __restrict__ C, int M, int N, int K, int n_tiles) {
  extern __shared__ __align__(128) uint8_t smem[];
  const int tid = threadIdx.x, warp = tid >> 5, lane = tid & 31;
  // n fastest: neighbouring blocks share their A rows in L2
  const int m0 = (blockIdx.x / n_tiles) * BM, n0 = (blockIdx.x % n_tiles) * BN;
  const int wm = (warp >> 2) * WM, wn = (warp & 3) * WN;
  const int kt_n = (K + BK - 1) / BK;

  int acc[4][4][4] = {};  // [m16 tile][n8 tile][fragment]

#pragma unroll
  for (int s = 0; s < STAGES - 1; ++s) {
    if (s < kt_n) load_stage(smem + s * STAGE_BYTES, A, W, M, N, K, m0, n0, s * BK, tid);
    cp_async_commit();
  }
  for (int kt = 0; kt < kt_n; ++kt) {
    cp_async_wait<STAGES - 2>();  // step kt has landed
    __syncthreads();              // and every warp is done with step kt - 1
    const int next = kt + STAGES - 1;
    if (next < kt_n)
      load_stage(smem + (next % STAGES) * STAGE_BYTES, A, W, M, N, K, m0, n0,
                 next * BK, tid);
    cp_async_commit();
    const uint8_t* as = smem + (kt % STAGES) * STAGE_BYTES;
    const uint8_t* bs = as + BM * LDS;
#pragma unroll
    for (int kk = 0; kk < BK; kk += 32) {
      uint32_t a[4][4], b[4][2];
      // A: matrices (rows 0-7 | 8-15) x (bytes 0-15 | 16-31) = a0..a3
#pragma unroll
      for (int i = 0; i < 4; ++i)
        ldmatrix_x4(a[i], smem_u32(as + (wm + i * 16 + (lane & 15)) * LDS + kk +
                                   (lane >> 4) * 16));
      // W: two n8 tiles a load, matrices (tile j | j+1) x (bytes 0-15 | 16-31)
      const int mat = lane >> 3;
#pragma unroll
      for (int j = 0; j < 4; j += 2) {
        uint32_t r[4];
        ldmatrix_x4(r, smem_u32(bs + (wn + j * 8 + (mat >> 1) * 8 + (lane & 7)) * LDS +
                                kk + (mat & 1) * 16));
        b[j][0] = r[0]; b[j][1] = r[1]; b[j + 1][0] = r[2]; b[j + 1][1] = r[3];
      }
#pragma unroll
      for (int i = 0; i < 4; ++i)
#pragma unroll
        for (int j = 0; j < 4; ++j) mma_s8(acc[i][j], a[i], b[j]);
    }
  }
  cp_async_wait<0>();
  __syncthreads();  // the ring is free: each warp stages its output there

  int32_t* cs = reinterpret_cast<int32_t*>(smem) + warp * (WM / 2) * CLD;
  const int g = lane >> 2, t = lane & 3;
  const bool vec = (N & 3) == 0;  // rows of C 16-byte aligned
#pragma unroll
  for (int half = 0; half < 2; ++half) {
    // fragments of m16 tiles 2*half, 2*half + 1 -> 32 rows x 32 columns
#pragma unroll
    for (int ii = 0; ii < 2; ++ii)
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        const int* f = acc[half * 2 + ii][j];
        const int r = ii * 16 + g, c = j * 8 + t * 2;
        *reinterpret_cast<int2*>(&cs[r * CLD + c]) = make_int2(f[0], f[1]);
        *reinterpret_cast<int2*>(&cs[(r + 8) * CLD + c]) = make_int2(f[2], f[3]);
      }
    __syncwarp();
    // 8 lanes x 16 bytes = one 128-byte row segment; 4 rows a pass
#pragma unroll
    for (int p = 0; p < 8; ++p) {
      const int r = p * 4 + (lane >> 3), c = (lane & 7) * 4;
      const int row = m0 + wm + half * 32 + r, col = n0 + wn + c;
      if (row >= M || col >= N) continue;
      const int4 v = *reinterpret_cast<const int4*>(&cs[r * CLD + c]);
      int32_t* dst = C + (size_t)row * N + col;
      if (vec && col + 4 <= N) {
        *reinterpret_cast<int4*>(dst) = v;
      } else {
        const int vals[4] = {v.x, v.y, v.z, v.w};
        for (int e = 0; e < 4 && col + e < N; ++e) dst[e] = vals[e];
      }
    }
    __syncwarp();
  }
}

}  // namespace

// a [M, K] int8, w [N, K] int8, c [M, N] int32; all contiguous, a and w
// 16-byte aligned; M, N >= 1; K a positive multiple of 32.
extern "C" int stk_int8_matmul(const void* a, const void* w, void* c, int M, int N,
                               int K, void* stream) {
  if (M < 1 || N < 1 || K < 32 || K % 32) return (int)cudaErrorInvalidValue;
  static bool smem_set = false;
  if (!smem_set) {
    int err = (int)cudaFuncSetAttribute(
        int8_gemm, cudaFuncAttributeMaxDynamicSharedMemorySize, SMEM_BYTES);
    if (err) return err;
    smem_set = true;
  }
  const int n_tiles = (N + BN - 1) / BN;
  const long long blocks = (long long)((M + BM - 1) / BM) * n_tiles;
  if (blocks > INT_MAX) return (int)cudaErrorInvalidValue;
  int8_gemm<<<(unsigned)blocks, NT, SMEM_BYTES, (cudaStream_t)stream>>>(
      (const int8_t*)a, (const int8_t*)w, (int32_t*)c, M, N, K, n_tiles);
  return (int)cudaGetLastError();
}
