// A variant of csrc/linear.cu (kernel_variants.py linear times it beside
// the committed kernel): the same kernel, but the TMA-stored instances
// compute silu by a fast quotient on the special-function unit, exact where
// a guard can tell, and take the exact sequence (stk::silu_bf16_torch) in a
// second pass over the pairs the guard refuses (about 1%). The committed
// kernel runs the exact sequence for every value.
//
// silu_bf16_fast: x * rcp(1 + 2^u), u = -x log2(e), by ex2.approx and
// rcp.approx; it lies within 14 f32 ulps of F.silu's f32 value from x >=
// -64 (ex2.approx and expf within 2 ulps, rcp.approx 1, the roundings), an
// error model taken from the PTX manual's bounds and checked only by a
// correctly rounded emulation on the CPU. The guard keeps a value that lies
// more than 32 ulps from a bf16 rounding midpoint, so that F.silu's value
// rounds to the same bf16 value. It was checked on the card only at the b64
// cell's shapes, not at every finite bf16 value.
//
// Times, ms a launch from replayed graphs at the FFN-in (M 20,480, K 256, N
// 1,024, silu), NVIDIA H100 80GB HBM3, 700 W: this variant on 64 x 128
// tiles 0.0456, the exact sequence on the same tiles 0.0500 (10 launches a
// b64/5-step batch: 0.044 ms of a 43 ms device batch); on 64 x 64 tiles the
// fast quotient with a branch a value 0.0585, the exact sequence 0.0549,
// this second pass 0.0544. In the register-stored instances (few tiles) the
// fast quotient with a branch a value took 0.0040 against the exact
// sequence's 0.0034.
#include <type_traits>

#include "wgmma_gemm.cuh"  // encode_rows, Pair, store_pair_any

namespace {

using bf16 = __nv_bfloat16;

// the fast quotient (see the head of this file); keep: the value lies more
// than kSiluMargin f32 ulps from a bf16 rounding midpoint and x >=
// kSiluFastFrom (below, the reciprocal nears the subnormal numbers
// rcp.approx.ftz flushes)
constexpr int kSiluMargin = 32;
constexpr float kSiluFastFrom = -64.0f;
__device__ __forceinline__ float silu_bf16_fast(float x, bool& keep) {
  constexpr float kLog2eHi = 1.4426950216293335f, kLog2eLo = 1.925963033500011e-8f;
  const float xc = fminf(x, 88.0f);  // 2^u flushes to 0 from there; no overflow of u
  const float u = __fmul_rn(xc, -kLog2eHi);
  const float u_lo = __fmaf_rn(xc, -kLog2eLo, __fmaf_rn(xc, -kLog2eHi, -u));
  float e, r;
  asm("ex2.approx.ftz.f32 %0, %1;" : "=f"(e) : "f"(u));
  e = __fmaf_rn(e, __fmul_rn(u_lo, 0.6931471805599453f), e);
  asm("rcp.approx.ftz.f32 %0, %1;" : "=f"(r) : "f"(__fadd_rn(1.0f, e)));
  const float s = __fmul_rn(x, r);
  const uint32_t below = (__float_as_uint(s) - (0x8000u - kSiluMargin)) & 0xffffu;
  keep = x >= kSiluFastFrom && below > 2u * kSiluMargin;
  return s;
}

constexpr int MODE_BIAS = 0, MODE_SILU = 1, MODE_TAIL = 2;

// ---------------------------------------------------------------------------
// the epilogue of a column pair, shared by both kernels
// ---------------------------------------------------------------------------

// two floats rounded to bf16, as floats
__device__ __forceinline__ float2 bf16_pair(float lo, float hi) {
  const uint32_t p = stk::pack_bf16(lo, hi);
  return make_float2(__uint_as_float(p << 16), __uint_as_float(p & 0xffff0000u));
}

// JAX's bf16 bias add on the f32 sums (v0, v1) and the bf16-rounded bias
// pair b: the sums rounded, plus the bias, rounded once more (one packed
// conversion each); two bf16 in one word
__device__ __forceinline__ uint32_t bias_pair(float v0, float v1, float2 b) {
  const float2 y = bf16_pair(v0, v1);
  return stk::pack_bf16(__fadd_rn(y.x, b.x), __fadd_rn(y.y, b.y));
}

// The result pair of MODE from the sums (v0, v1), the bias pair b and, for
// the tail, x_in's pair x, the row's mask m and its batch row's dt: the bias
// form, then silu (the exact sequence, stk::silu_bf16_torch) or the tail.
// With SECOND_PASS the silu form returns the fast quotients
// (silu_bf16_fast) where the guard keeps both (keep), else the bias
// form, which the caller's second pass, after the whole tile, replaces by
// the exact silu: no branch in the first pass.
template <int MODE, bool SECOND_PASS = false>
__device__ __forceinline__ stk::Pair<MODE == MODE_TAIL ? 4 : 2> epi_pair(float v0, float v1,
                                                                          float2 b, float2 x,
                                                                          float m, float dt,
                                                                          bool& keep) {
  const uint32_t o = bias_pair(v0, v1, b);
  if constexpr (MODE == MODE_BIAS) {
    return o;
  } else {
    const float o0 = __uint_as_float(o << 16), o1 = __uint_as_float(o & 0xffff0000u);
    if constexpr (MODE == MODE_SILU && SECOND_PASS) {
      bool k0, k1;
      const float s0 = silu_bf16_fast(o0, k0), s1 = silu_bf16_fast(o1, k1);
      keep = k0 && k1;
      return keep ? stk::pack_bf16(s0, s1) : o;
    } else if constexpr (MODE == MODE_SILU) {
      return stk::pack_bf16(stk::silu_bf16_torch(o0), stk::silu_bf16_torch(o1));
    } else {
      const float r0 = __fmul_rn(__fadd_rn(x.x, __fmul_rn(dt, __fmul_rn(o0, m))), m);
      const float r1 = __fmul_rn(__fadd_rn(x.y, __fmul_rn(dt, __fmul_rn(o1, m))), m);
      return make_uint2(__float_as_uint(r0), __float_as_uint(r1));
    }
  }
}

// what a launch reads besides X and W, and where a register-stored result goes
struct Args {
  const float* bias;  // [N]
  const float* x_in;  // MODE_TAIL: [M, N] f32
  const float* mask;  // MODE_TAIL: [M] f32 (0/1)
  const float* dt;    // MODE_TAIL: [M / T] f32
  void* y;            // [M, N] bf16 (f32 for the tail)
  int M, N, K, T;
};

// ---------------------------------------------------------------------------
// the tensor-core kernel (bf16 operands)
// ---------------------------------------------------------------------------

// A launch's tile: NC consumer warpgroups a block, each running MI products
// of 64 rows x BN columns a K step; NS ring stages of 64 elements of K, BPS
// blocks an SM. Each consumer owns whole tiles of 64 MI rows (in turns with
// the others), or with COOP the consumers share tiles of 64 MI NC rows, each
// its own rows. TMA_STORE: results of ES bytes leave through the consumer's
// 128-byte-swizzled buffer by TMA (the tail's x_in arrives there by TMA
// first), else from the registers at any N (x_in read from device memory).
template <int NC_, int MI_, int BN_, int NS_, int BPS_, bool COOP_, bool TMA_STORE_, int ES_>
struct Tile {
  static constexpr int NC = NC_, MI = MI_, BN = BN_, NS = NS_, BPS = BPS_, ES = ES_;
  static constexpr bool COOP = COOP_, TMA_STORE = TMA_STORE_;
  static constexpr int ROWS = 64 * MI_;               // a consumer's rows of a tile
  static constexpr int BM = ROWS * (COOP_ ? NC_ : 1);  // rows of a tile
  static constexpr int THREADS = (NC_ + 1) * 128;
  static constexpr int STAGE_A = BM * 128, STAGE_W = BN_ * 128;  // bytes
  static constexpr int BOX = 128 / ES_;  // columns of a stored box
  static constexpr int OUT = TMA_STORE_ ? ROWS * BN_ * ES_ : 0;  // a consumer's buffer
  // the ring, the consumers' output buffers and bias slices, the ring's full
  // and empty barriers, the consumers' turn, x_in-full and buffer-free
  // barriers, and slack for the 1024-byte alignment
  static constexpr size_t SMEM = (size_t)NS_ * (STAGE_A + STAGE_W) + (size_t)NC_ * (OUT + 4 * BN_) +
                                 16 * NS_ + 24 * NC_ + 1024;
  static_assert(BN_ % 8 == 0 && BN_ <= 256, "wgmma takes N up to 256 in steps of 8");
  static_assert(!TMA_STORE_ || BN_ % BOX == 0, "stored in boxes of 128 bytes a row");
  static_assert(SMEM * BPS_ <= 232448, "the blocks' shared memory");
};

// the pair (row rr of the consumer's rows, columns 8j + 2t, + 1) in the
// consumer's output buffer: box j / 8 of 64 bf16 columns (chunk j % 8 of
// the row), or box j / 4 of 32 f32 columns (8 bytes at 32 (j % 4) + 8 t),
// chunks swizzled by the row as TMA's 128-byte swizzle lays them
template <typename S>
__device__ __forceinline__ uint8_t* pair_at(uint8_t* buf, int j, int rr, int t) {
  if constexpr (S::ES == 2)
    return buf + (j / 8) * S::ROWS * 128 + rr * 128 + (((j % 8) ^ (rr % 8)) << 4) + 4 * t;
  else
    return buf + (j / 4) * S::ROWS * 128 + rr * 128 + (((2 * (j % 4) + t / 2) ^ (rr % 8)) << 4) +
           8 * (t % 2);
}

template <int MODE, typename S>
__global__ void __launch_bounds__(S::THREADS, S::BPS)
linear_wgmma(__grid_constant__ const CUtensorMap tm_x, __grid_constant__ const CUtensorMap tm_w,
             __grid_constant__ const CUtensorMap tm_y, __grid_constant__ const CUtensorMap tm_xin,
             Args p, int n_tiles, int tiles) {
  constexpr int NC = S::NC, MI = S::MI, BN = S::BN, NS = S::NS;
  constexpr bool COOP = S::COOP, TAIL_TMA = MODE == MODE_TAIL && S::TMA_STORE;
  static_assert(!(TAIL_TMA && COOP), "the tail's x_in arrives a consumer's tile at a time");
  using Out = std::conditional_t<MODE == MODE_TAIL, float, bf16>;
  static_assert(sizeof(Out) == S::ES, "the tile's result size is the mode's");
  extern __shared__ __align__(1024) unsigned char raw[];
  uint8_t* ring = raw + ((1024 - (stk::smem_u32(raw) & 1023)) & 1023);
  uint8_t* out_buf = ring + NS * (S::STAGE_A + S::STAGE_W);  // NC buffers of S::OUT bytes
  float* bias_buf = reinterpret_cast<float*>(out_buf + NC * S::OUT);  // NC slices of BN
  uint64_t* full = reinterpret_cast<uint64_t*>(bias_buf + NC * BN);
  uint64_t* empty = full + NS;
  uint64_t* turn = empty + NS;
  uint64_t* xfull = turn + NC;  // the tail's x_in has landed in the consumer's buffer
  uint64_t* xfree = xfull + NC;  // the consumer's last store has read its buffer
  auto stage_a = [&](int s) { return ring + s * (S::STAGE_A + S::STAGE_W); };
  auto stage_w = [&](int s) { return ring + s * (S::STAGE_A + S::STAGE_W) + S::STAGE_A; };
  const int wg = threadIdx.x / 128, warp = (threadIdx.x / 32) & 3, lane = threadIdx.x & 31;
  const int kt_n = (p.K + 63) / 64;
  if (threadIdx.x == 0) {
#pragma unroll
    for (int s = 0; s < NS; ++s) {
      stk::mbar_init(&full[s], 1);
      stk::mbar_init(&empty[s], COOP ? 4 * NC : 4);  // the warps that read it
    }
#pragma unroll
    for (int c = 0; c < NC; ++c) {
      stk::mbar_init(&turn[c], 1);
      stk::mbar_init(&xfull[c], 1);
      stk::mbar_init(&xfree[c], 1);
    }
    stk::mbar_fence_init();
  }
  __syncthreads();

  // the block's tiles are blockIdx.x + i gridDim.x, i = 0, 1, ...; consumer
  // c takes those with i % NC == c (all of them, with COOP). Their K steps
  // pass through the ring in the order of i, so the consumers' mainloops
  // take turns and each one's epilogue runs beside the next one's
  // products; n fastest, so the tiles in flight across the card share their
  // X rows in L2. Turn barriers: a consumer starts waiting on tile i's stages
  // once the consumer of tile i - 1 has seen its last stage arrive.
  if (wg == NC) {  // producer warpgroup: one thread issues
    stk::regs_dealloc<stk::kProducerRegs>();
    if (threadIdx.x % 128 != 0) return;
    int step = 0;
    for (int i = 0, tile = blockIdx.x; tile < tiles; ++i, tile += gridDim.x) {
      const int m0 = (tile / n_tiles) * S::BM, n0 = (tile % n_tiles) * BN;
      for (int kt = 0; kt < kt_n; ++kt, ++step) {
        const int s = step % NS;
        stk::mbar_wait(&empty[s], ((step / NS) & 1) ^ 1);
        stk::mbar_arrive_tx(&full[s], S::STAGE_A + S::STAGE_W);
        stk::tma_load_2d(stage_a(s), &tm_x, &full[s], kt * 64, m0);
        stk::tma_load_2d(stage_w(s), &tm_w, &full[s], kt * 64, n0);
        if constexpr (TAIL_TMA) {
          // the tile's x_in into its consumer's buffer, once that buffer's
          // last store has read it, behind the tile's first stage
          if (kt == 0) {
            const int c = i % NC;
            stk::mbar_wait(&xfree[c], ((i / NC) & 1) ^ 1);
            stk::mbar_arrive_tx(&xfull[c], S::OUT);
#pragma unroll
            for (int h = 0; h < BN / S::BOX; ++h)
              stk::tma_load_2d(out_buf + c * S::OUT + h * S::ROWS * 128, &tm_xin, &xfull[c],
                               n0 + S::BOX * h, m0);
          }
        }
      }
    }
  } else {
    stk::regs_alloc<stk::consumer_regs(NC, S::BPS)>();
    const int tid = threadIdx.x % 128, g = lane >> 2, t = lane & 3;
    uint8_t* buf = out_buf + wg * S::OUT;
    float* bias_s = bias_buf + wg * BN;
    float acc[MI][BN / 2];
    constexpr int STRIDE = COOP ? 1 : NC;  // the consumer's turns among the block's tiles
    const int row0 = COOP ? S::ROWS * wg : 0;  // its rows of a tile
    for (int i = COOP ? 0 : wg, tile = blockIdx.x + i * gridDim.x; tile < tiles;
         i += STRIDE, tile += STRIDE * gridDim.x) {
      const int m0 = (tile / n_tiles) * S::BM, n0 = (tile % n_tiles) * BN;
      // the tile's bias columns into shared memory and the tail's per-row
      // mask and dt into registers, in flight during the products (the last
      // epilogue has read the slice: its closing barrier, or this one)
      if constexpr (!S::TMA_STORE) stk::named_bar_sync(1 + wg, 128);
      for (int c = tid; c < BN; c += 128)
        stk::cp_async4(stk::smem_u32(bias_s + c), p.bias + (n0 + c < p.N ? n0 + c : 0),
                       n0 + c < p.N);
      stk::cp_async_commit();
      float mk[MI][2], dtr[MI][2];
      if constexpr (MODE == MODE_TAIL) {
#pragma unroll
        for (int r = 0; r < MI; ++r)
#pragma unroll
          for (int half = 0; half < 2; ++half) {
            const int row = m0 + row0 + 64 * r + 16 * warp + g + 8 * half;
            const int at = row < p.M ? row : p.M - 1;  // rows past M are not stored
            mk[r][half] = p.mask[at];
            dtr[r][half] = p.dt[at / p.T];
          }
      }
#pragma unroll
      for (int r = 0; r < MI; ++r)
#pragma unroll
        for (int e = 0; e < BN / 2; ++e) acc[r][e] = 0.0f;
      const int step0 = i * kt_n;
      if (!COOP && NC > 1 && i > 0) stk::mbar_wait(&turn[wg], ((i - 1) / NC) & 1);
      for (int kt = 0; kt < kt_n; ++kt) {
        const int step = step0 + kt, s = step % NS;
        stk::mbar_wait(&full[s], (step / NS) & 1);
        if (!COOP && NC > 1 && kt == kt_n - 1 && tid == 0)
          stk::mbar_arrive(&turn[(wg + 1) % NC]);  // the next tile's consumer may start
        const uint32_t a_addr = stk::smem_u32(stage_a(s)) + row0 * 128;
        const uint32_t w_addr = stk::smem_u32(stage_w(s));
        stk::wgmma_fence();
#pragma unroll
        for (int kk = 0; kk < 4; ++kk)
#pragma unroll
          for (int r = 0; r < MI; ++r)
            stk::Wgmma<BN>::template ss<0>(acc[r], stk::desc_sw128(a_addr + r * 64 * 128 + 32 * kk),
                                           stk::desc_sw128(w_addr + 32 * kk), 1);
        stk::wgmma_commit();
        stk::wgmma_wait<1>();  // the previous step's products are done with its stage
        if (kt > 0 && lane == 0) stk::mbar_arrive(&empty[(step - 1) % NS]);
      }
      stk::wgmma_wait<0>();
      if (lane == 0) stk::mbar_arrive(&empty[(step0 + kt_n - 1) % NS]);
#pragma unroll
      for (int r = 0; r < MI; ++r) stk::fence_regs(acc[r]);
      stk::cp_async_wait<0>();
      if constexpr (S::TMA_STORE && !TAIL_TMA)
        if (tid == 0) stk::bulk_wait_read<0>();  // the last tile's store has read the buffer
      stk::named_bar_sync(1 + wg, 128);  // and every thread's bias columns have landed
      if constexpr (TAIL_TMA) stk::mbar_wait(&xfull[wg], (i / NC) & 1);
      // epilogue from the registers: rows 64r + 16 warp + g (+ 8) of the
      // consumer's rows, columns 8j + 2t (+ 1), a column pair a value; the
      // silu form's refused pairs wait in the output buffer for a second pass
      constexpr bool SECOND = MODE == MODE_SILU && S::TMA_STORE;
      static_assert(!SECOND || MI * BN / 4 <= 64, "a bit a pair");
      uint64_t refused = 0;
#pragma unroll
      for (int j = 0; j < BN / 8; ++j) {
        const int c = 8 * j + 2 * t, col = n0 + c;
        const float2 bl = *reinterpret_cast<const float2*>(bias_s + c);
        const float2 b = bf16_pair(bl.x, bl.y);
#pragma unroll
        for (int r = 0; r < MI; ++r)
#pragma unroll
          for (int half = 0; half < 2; ++half) {
            const int rr = 64 * r + 16 * warp + g + 8 * half, row = m0 + row0 + rr;
            const float v0 = acc[r][4 * j + 2 * half], v1 = acc[r][4 * j + 2 * half + 1];
            const float m = MODE == MODE_TAIL ? mk[r][half] : 0.0f;
            const float d = MODE == MODE_TAIL ? dtr[r][half] : 0.0f;
            bool keep = true;
            if constexpr (S::TMA_STORE) {
              uint8_t* at = pair_at<S>(buf, j, rr, t);
              float2 x = make_float2(0.0f, 0.0f);
              if constexpr (TAIL_TMA) x = *reinterpret_cast<const float2*>(at);
              *reinterpret_cast<stk::Pair<S::ES>*>(at) =
                  epi_pair<MODE, SECOND>(v0, v1, b, x, m, d, keep);
              if constexpr (SECOND) refused |= (uint64_t)!keep << ((j * MI + r) * 2 + half);
            } else if (row < p.M && col < p.N) {
              const size_t e = (size_t)row * p.N + col;
              float2 x = make_float2(0.0f, 0.0f);
              if constexpr (MODE == MODE_TAIL)
                x = make_float2(p.x_in[e], col + 1 < p.N ? p.x_in[e + 1] : 0.0f);
              const auto v = epi_pair<MODE>(v0, v1, b, x, m, d, keep);
              stk::store_pair_any(reinterpret_cast<Out*>(p.y), e, col, p.N, v);
            }
          }
      }
      if constexpr (SECOND) {  // the refused pairs' bias form, by the exact silu
#pragma unroll 1
        for (uint64_t left = refused; left; left &= left - 1) {
          const int i2 = __ffsll((long long)left) - 1, jr = i2 >> 1;
          uint32_t* at = reinterpret_cast<uint32_t*>(
              pair_at<S>(buf, jr / MI, 64 * (jr % MI) + 16 * warp + g + 8 * (i2 & 1), t));
          const uint32_t o = *at;
          *at = stk::pack_bf16(stk::silu_bf16_torch(__uint_as_float(o << 16)),
                               stk::silu_bf16_torch(__uint_as_float(o & 0xffff0000u)));
        }
      }
      if constexpr (S::TMA_STORE) {
        stk::fence_proxy_async();
        stk::named_bar_sync(1 + wg, 128);
        if (tid == 0) {
#pragma unroll
          for (int h = 0; h < BN / S::BOX; ++h)
            stk::tma_store_2d(&tm_y, buf + h * S::ROWS * 128, n0 + S::BOX * h, m0 + row0);
          stk::bulk_commit();
          if constexpr (TAIL_TMA) {
            stk::bulk_wait_read<0>();
            stk::mbar_arrive(&xfree[wg]);  // the producer may bring the next x_in
          }
        }
      }
    }
    if (S::TMA_STORE && threadIdx.x % 128 == 0) stk::bulk_wait<0>();  // the stores have landed
  }
}

// ---------------------------------------------------------------------------
// a K no multiple of 8: SIMT
// ---------------------------------------------------------------------------
constexpr int S_THREADS = 256, S_TILE = 64, S_KC = 32;

// a 64 x 64 tile of Y a block, each thread rows ty + 16 i (i < 4) and
// columns 4 tx .. 4 tx + 3 (two pairs), K in chunks of 32 staged as f32
template <int MODE>
__global__ void __launch_bounds__(S_THREADS) linear_simt(const bf16* __restrict__ X,
                                                         const bf16* __restrict__ W, Args p) {
  using Out = std::conditional_t<MODE == MODE_TAIL, float, bf16>;
  __shared__ float xs[S_KC][S_TILE + 1], ws[S_KC][S_TILE + 1];
  const int M = p.M, N = p.N, K = p.K;
  const int tx = threadIdx.x % 16, ty = threadIdx.x / 16;
  const int m0 = blockIdx.x * S_TILE, n0 = blockIdx.y * S_TILE;
  float acc[4][4];
#pragma unroll
  for (int i = 0; i < 4; ++i)
#pragma unroll
    for (int j = 0; j < 4; ++j) acc[i][j] = 0.0f;
  for (int k0 = 0; k0 < K; k0 += S_KC) {
    for (int i = threadIdx.x; i < S_TILE * S_KC; i += S_THREADS) {
      const int r = i / S_KC, kk = i % S_KC, k = k0 + kk;
      xs[kk][r] = m0 + r < M && k < K ? __bfloat162float(X[(size_t)(m0 + r) * K + k]) : 0.0f;
      ws[kk][r] = n0 + r < N && k < K ? __bfloat162float(W[(size_t)(n0 + r) * K + k]) : 0.0f;
    }
    __syncthreads();
#pragma unroll 8
    for (int kk = 0; kk < S_KC; ++kk) {
      float a[4], b[4];
#pragma unroll
      for (int i = 0; i < 4; ++i) a[i] = xs[kk][ty + 16 * i];
#pragma unroll
      for (int j = 0; j < 4; ++j) b[j] = ws[kk][4 * tx + j];
#pragma unroll
      for (int i = 0; i < 4; ++i)
#pragma unroll
        for (int j = 0; j < 4; ++j) acc[i][j] = fmaf(a[i], b[j], acc[i][j]);
    }
    __syncthreads();
  }
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const int row = m0 + ty + 16 * i;
    if (row >= M) continue;
    const float m = MODE == MODE_TAIL ? p.mask[row] : 0.0f;
    const float d = MODE == MODE_TAIL ? p.dt[row / p.T] : 0.0f;
#pragma unroll
    for (int q = 0; q < 2; ++q) {
      const int col = n0 + 4 * tx + 2 * q;
      if (col >= N) continue;
      const bool two = col + 1 < N;
      const size_t e = (size_t)row * N + col;
      const float2 b = bf16_pair(p.bias[col], two ? p.bias[col + 1] : 0.0f);
      float2 x = make_float2(0.0f, 0.0f);
      if constexpr (MODE == MODE_TAIL) x = make_float2(p.x_in[e], two ? p.x_in[e + 1] : 0.0f);
      bool keep = true;
      stk::store_pair_any(reinterpret_cast<Out*>(p.y), e, col, N,
                          epi_pair<MODE>(acc[i][2 * q], acc[i][2 * q + 1], b, x, m, d, keep));
    }
  }
}

// ---------------------------------------------------------------------------
// instances and launch
// ---------------------------------------------------------------------------

// NC, MI, BN, stages, blocks an SM, shared tiles, TMA store, result bytes
using Many = Tile<2, 2, 128, 5, 1, false, true, 2>;      // 128 x 128, two consumers in turns
using ManySilu = Tile<4, 1, 128, 5, 1, false, true, 2>;  // 64 x 128, four consumers in turns
using Few = Tile<1, 1, 64, 6, 2, false, true, 2>;        // 64 x 64, one consumer a block
using AnyN = Tile<1, 1, 32, 8, 2, false, false, 2>;      // 64 x 32, from the registers
using TailTile = Tile<2, 1, 96, 6, 1, false, true, 4>;   // 64 x 96 f32, x_in by TMA
using TailAnyN = Tile<1, 1, 32, 8, 2, false, false, 4>;  // 64 x 32 f32, from the registers

template <typename S>
long long tiles_of(int M, int N) {
  return (long long)((M + S::BM - 1) / S::BM) * ((N + S::BN - 1) / S::BN);
}

template <int MODE, typename S>
int launch_tiles(const bf16* x, const bf16* w, const Args& p, cudaStream_t st) {
  using Out = std::conditional_t<MODE == MODE_TAIL, float, bf16>;
  constexpr CUtensorMapDataType out_type =
      MODE == MODE_TAIL ? CU_TENSOR_MAP_DATA_TYPE_FLOAT32 : CU_TENSOR_MAP_DATA_TYPE_BFLOAT16;
  const long long tiles = tiles_of<S>(p.M, p.N);
  if (tiles > 0x7fffffff) return (int)cudaErrorInvalidValue;
  int sms = 0;
  if (int err = stk::sm_count(sms)) return err;
  const long long per_block = S::COOP ? tiles : (tiles + S::NC - 1) / S::NC;
  const int blocks = (int)(per_block > (long long)sms * S::BPS ? (long long)sms * S::BPS
                                                                : per_block);
  // encoded at every launch: a graph capture keeps this launch's maps
  CUtensorMap tx, tw, ty = {}, txin = {};
  if (int err = stk::encode_rows<bf16>(&tx, x, p.M, p.K, S::BM, CU_TENSOR_MAP_DATA_TYPE_BFLOAT16))
    return err;
  if (int err = stk::encode_rows<bf16>(&tw, w, p.N, p.K, S::BN, CU_TENSOR_MAP_DATA_TYPE_BFLOAT16))
    return err;
  if constexpr (S::TMA_STORE) {  // [M, N] in boxes of 128 bytes of a row x a consumer's rows
    if (int err = stk::encode_rows<Out>(&ty, p.y, p.M, p.N, S::ROWS, out_type)) return err;
    if constexpr (MODE == MODE_TAIL)
      if (int err = stk::encode_rows<float>(&txin, p.x_in, p.M, p.N, S::ROWS, out_type))
        return err;
  }
  auto kernel = linear_wgmma<MODE, S>;
  static size_t smem_set[stk::kMaxDevices] = {};  // one per instantiation
  if (int err = stk::allow_dynamic_smem(kernel, S::SMEM, smem_set)) return err;
  static int regs_at_entry = 0;
  if (int err = stk::check_reg_split(kernel, 128, S::NC * 128,
                                     stk::consumer_regs(S::NC, S::BPS), regs_at_entry))
    return err;
  kernel<<<blocks, S::THREADS, S::SMEM, st>>>(tx, tw, ty, txin, p,
                                              (p.N + S::BN - 1) / S::BN, (int)tiles);
  return (int)cudaGetLastError();
}

template <int MODE>
int launch(const bf16* x, const bf16* w, const Args& p, cudaStream_t st) {
  const int M = p.M, N = p.N, K = p.K;
  if (M < 1 || N < 1 || K < 1) return (int)cudaErrorInvalidValue;
  if (K % 8) {  // rows of X and W no TMA map takes
    const long long n_tiles = (N + S_TILE - 1) / S_TILE;
    if (n_tiles > 65535) return (int)cudaErrorInvalidValue;
    const dim3 grid((M + S_TILE - 1) / S_TILE, (unsigned)n_tiles);
    linear_simt<MODE><<<grid, S_THREADS, 0, st>>>(x, w, p);
    return (int)cudaGetLastError();
  }
  if constexpr (MODE == MODE_TAIL) {
    return N % 4 ? launch_tiles<MODE, TailAnyN>(x, w, p, st)
                 : launch_tiles<MODE, TailTile>(x, w, p, st);
  } else {
    int sms = 0;
    if (int err = stk::sm_count(sms)) return err;
    if (N % 8) return launch_tiles<MODE, AnyN>(x, w, p, st);  // rows no TMA map takes
    if (tiles_of<Many>(M, N) >= 2LL * sms)
      return MODE == MODE_SILU ? launch_tiles<MODE, ManySilu>(x, w, p, st)
                               : launch_tiles<MODE, Many>(x, w, p, st);
    if (2 * tiles_of<Few>(M, N) >= sms) return launch_tiles<MODE, Few>(x, w, p, st);
    return launch_tiles<MODE, AnyN>(x, w, p, st);  // more, narrower tiles
  }
}

}  // namespace

// x [M, K] and w [N, K] bf16, bias [N] f32; mode 0 (bias) and 1 (bias,
// silu): y [M, N] bf16; mode 2 (the flow step's tail): x_in [M, N] f32,
// mask [M] f32, dt [M / T] f32 (T rows a batch row), y [M, N] f32. All
// contiguous and 16-byte aligned.
extern "C" int stk_linear(const void* x, const void* w, const void* bias, const void* x_in,
                          const void* mask, const void* dt, void* y, int M, int N, int K, int T,
                          int mode, void* stream) {
  auto f = [](const void* q) { return (const float*)q; };
  const bf16* xb = (const bf16*)x;
  const bf16* wb = (const bf16*)w;
  cudaStream_t st = (cudaStream_t)stream;
  if (T < 1) return (int)cudaErrorInvalidValue;
  const Args p{f(bias), f(x_in), f(mask), f(dt), y, M, N, K, T};
  if (mode == MODE_BIAS) return launch<MODE_BIAS>(xb, wb, p, st);
  if (mode == MODE_SILU) return launch<MODE_SILU>(xb, wb, p, st);
  if (mode == MODE_TAIL) return launch<MODE_TAIL>(xb, wb, p, st);
  return (int)cudaErrorInvalidValue;
}

// the instances' tiles, rows x columns x ring stages: bf16 results at many
// tiles (the bias form, the silu form), at few, at fewer or an N whose rows
// no TMA map takes, then the tail's f32 results (x_in by TMA) and the tail's
// at any N
extern "C" int stk_linear_tiles(int* tiles) {
  const int v[18] = {Many::BM,     Many::BN,     Many::NS,     ManySilu::BM, ManySilu::BN,
                     ManySilu::NS, Few::BM,      Few::BN,      Few::NS,      AnyN::BM,
                     AnyN::BN,     AnyN::NS,     TailTile::BM, TailTile::BN, TailTile::NS,
                     TailAnyN::BM, TailAnyN::BN, TailAnyN::NS};
  for (int i = 0; i < 18; ++i) tiles[i] = v[i];
  return 0;
}
