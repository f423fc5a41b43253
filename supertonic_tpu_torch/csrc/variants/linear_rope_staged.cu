// A variant of csrc/linear.cu (kernel_variants.py linear times it beside
// the committed kernel): the same kernel, but the rope form stages its
// tile's rows' cos and sin in shared memory by cp.async during the products,
// where each consumer's share (4 Dh bytes a row) fits beside the ring, and
// its epilogue reads them from there. The committed kernel reads them from
// device memory (L2) in the epilogue.
//
// Times, ms from replayed graphs at the VE's self Q (M 28,672, K 512, N
// 512, Dh 64), kernel_variants.py linear --split, NVIDIA H100 80GB HBM3,
// 700 W: 0.0421 on 64 x 256 tiles (3 ring stages), 0.0447 on 128 x 128
// (3 stages), 0.062 on 64 x 128 tiles of four consumers, against the
// committed kernel's 0.0428 on 128 x 128 tiles of 5 stages; the rope form
// of a b64/5-step batch 4.26 ms on 64 x 256 tiles against 4.33, within the
// spread of two runs. Staging costs ring stages that the products need;
// not taken.
#include <type_traits>

#include "wgmma_gemm.cuh"  // encode_rows, Pair, store_pair_any

namespace {

using bf16 = __nv_bfloat16;

constexpr int MODE_BIAS = 0, MODE_SILU = 1, MODE_TAIL = 2, MODE_ROPE = 3, MODE_RESID = 4;

// ---------------------------------------------------------------------------
// the epilogue of a column pair, shared by both kernels
// ---------------------------------------------------------------------------

// a word of two bf16 (the lower column in the low half), as floats
__device__ __forceinline__ float2 unpack(uint32_t p) {
  return make_float2(__uint_as_float(p << 16), __uint_as_float(p & 0xffff0000u));
}

// two floats rounded to bf16, as floats
__device__ __forceinline__ float2 bf16_pair(float lo, float hi) {
  return unpack(stk::pack_bf16(lo, hi));
}

// JAX's bf16 bias add on the f32 sums (v0, v1) and the bf16-rounded bias
// pair b: the sums rounded, plus the bias, rounded once more (one packed
// conversion each); two bf16 in one word
__device__ __forceinline__ uint32_t bias_pair(float v0, float v1, float2 b) {
  const float2 y = bf16_pair(v0, v1);
  return stk::pack_bf16(__fadd_rn(y.x, b.x), __fadd_rn(y.y, b.y));
}

// The result pair of MODE from the sums (v0, v1), the bias pair b and, for
// the tail, x_in's pair x, the row's mask m and its batch row's dt, for the
// residual form the residual's pair x and the gate's g: the bias form, then
// silu (the exact sequence, stk::silu_bf16_torch), the gated residual
// (csrc/gated_residual.cu's order: rnd(x + rnd(g * o)); g = 1 without a
// gate, 1 * o is exact) or the tail.
template <int MODE>
__device__ __forceinline__ stk::Pair<MODE == MODE_TAIL ? 4 : 2> epi_pair(float v0, float v1,
                                                                          float2 b, float2 x,
                                                                          float2 g, float m,
                                                                          float dt) {
  const uint32_t o = bias_pair(v0, v1, b);
  if constexpr (MODE == MODE_BIAS) {
    return o;
  } else {
    const float o0 = __uint_as_float(o << 16), o1 = __uint_as_float(o & 0xffff0000u);
    if constexpr (MODE == MODE_SILU) {
      return stk::pack_bf16(stk::silu_bf16_torch(o0), stk::silu_bf16_torch(o1));
    } else if constexpr (MODE == MODE_RESID) {
      const float2 go = bf16_pair(__fmul_rn(g.x, o0), __fmul_rn(g.y, o1));
      return stk::pack_bf16(__fadd_rn(x.x, go.x), __fadd_rn(x.y, go.y));
    } else {
      const float r0 = __fmul_rn(__fadd_rn(x.x, __fmul_rn(dt, __fmul_rn(o0, m))), m);
      const float r1 = __fmul_rn(__fadd_rn(x.y, __fmul_rn(dt, __fmul_rn(o1, m))), m);
      return make_uint2(__float_as_uint(r0), __float_as_uint(r1));
    }
  }
}

// The rope form's rotation of a head's pair of column pairs (csrc/rope.cu's
// order): from the bias forms a (the head's first half) and b (its second
// half) and their angles' cos c and sin s, o1 = rnd(a c - b s) and o2 =
// rnd(a s + b c), each product and sum in f32.
__device__ __forceinline__ void rotate(uint32_t a, uint32_t b, float2 c, float2 s, uint32_t& o1,
                                       uint32_t& o2) {
  const float2 x = unpack(a), y = unpack(b);
  o1 = stk::pack_bf16(__fsub_rn(__fmul_rn(x.x, c.x), __fmul_rn(y.x, s.x)),
                      __fsub_rn(__fmul_rn(x.y, c.y), __fmul_rn(y.y, s.y)));
  o2 = stk::pack_bf16(__fadd_rn(__fmul_rn(x.x, s.x), __fmul_rn(y.x, c.x)),
                      __fadd_rn(__fmul_rn(x.y, s.y), __fmul_rn(y.y, c.y)));
}

// what a launch reads besides X and W, and where a register-stored result goes
struct Args {
  const float* bias;   // [N]
  const float* x_in;   // MODE_TAIL: [M, N] f32
  const float* mask;   // MODE_TAIL: [M] f32 (0/1)
  const float* dt;     // MODE_TAIL: [M / T] f32
  const float* cs;     // MODE_ROPE: cos [M, dh / 2] f32
  const float* sn;     // MODE_ROPE: sin [M, dh / 2] f32
  const bf16* res;     // MODE_RESID: the residual [M, N]
  const bf16* gate;    // MODE_RESID: rows of N, batch row i at i * gstride, or null
  long long gstride;
  void* y;             // [M, N] bf16 (f32 for the tail)
  int M, N, K, T, dh;  // T rows a batch row; dh the rope form's head width
};

// the pair at element e (column col) of rows of N bf16, as floats (a lone
// last column with 0)
__device__ __forceinline__ float2 load_pair(const bf16* p, size_t e, int col, int N) {
  if (N % 2 == 0) return unpack(__ldg(reinterpret_cast<const unsigned int*>(p + e)));
  const unsigned short* q = reinterpret_cast<const unsigned short*>(p);
  return make_float2(__uint_as_float((uint32_t)q[e] << 16),
                     col + 1 < N ? __uint_as_float((uint32_t)q[e + 1] << 16) : 0.0f);
}

// the residual form's gate pair at column col of row `row` (a row past M
// reads the last row's); 1 without a gate, or past N
__device__ __forceinline__ float2 gate_pair(const Args& p, int row, int col) {
  if (!p.gate || col >= p.N) return make_float2(1.0f, 1.0f);
  const long long ofs = (long long)((row < p.M ? row : p.M - 1) / p.T) * p.gstride;
  return load_pair(p.gate, (size_t)(ofs + col), col, p.N);
}

// shared memory a launch of MODE on tiles S takes: the tile's, and for the
// residual form on TMA-stored tiles each consumer's gate rows of two batch
// rows (4 BN bytes)
template <int MODE, typename S>
__host__ __device__ constexpr size_t smem_of() {
  return S::SMEM + (MODE == MODE_RESID && S::TMA_STORE ? (size_t)S::NC * 4 * S::BN : 0);
}

// whether the rope form at DH stages its cos and sin in shared memory: each
// consumer's rows x DH / 2 of each, 4 DH bytes a row
template <int MODE, typename S, int DH>
__host__ __device__ constexpr bool stages_angles() {
  return MODE == MODE_ROPE &&
         (smem_of<MODE, S>() + (size_t)S::NC * S::ROWS * DH * 4) * S::BPS <= 232448;
}

// the 16-byte chunk (cos pair, sin pair) of pair pr (columns 2 pr, + 1 of a
// head's first half) in row rr of a consumer's staged angles: chunks of odd
// rows swap halves of 4, so the 8 lanes of a quarter warp (two rows, four
// pairs) read all 32 banks
template <int DH>
__device__ __forceinline__ int angle_chunk(int rr, int pr) {
  return rr * (DH / 4) + (pr ^ (DH >= 32 ? (rr & 1) << 2 : 0));
}

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
  // and empty barriers, the consumers' turn and x_in-full barriers, and
  // slack for the 1024-byte alignment
  static constexpr size_t SMEM = (size_t)NS_ * (STAGE_A + STAGE_W) + (size_t)NC_ * (OUT + 4 * BN_) +
                                 16 * NS_ + 16 * NC_ + 1024;
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

// DH: the rope form's head width (0 in the other forms)
template <int MODE, typename S, int DH>
__global__ void __launch_bounds__(S::THREADS, S::BPS)
linear_wgmma(__grid_constant__ const CUtensorMap tm_x, __grid_constant__ const CUtensorMap tm_w,
             __grid_constant__ const CUtensorMap tm_y, __grid_constant__ const CUtensorMap tm_xin,
             Args p, int n_tiles, int tiles) {
  constexpr int NC = S::NC, MI = S::MI, BN = S::BN, NS = S::NS;
  // the tail's x_in or the residual lands by TMA in the consumer's output buffer
  constexpr bool COOP = S::COOP,
                 IN_TMA = (MODE == MODE_TAIL || MODE == MODE_RESID) && S::TMA_STORE;
  static_assert(!(IN_TMA && COOP), "x_in or the residual arrives a consumer's tile at a time");
  static_assert(MODE != MODE_ROPE || (S::TMA_STORE && DH % 16 == 0 && BN % DH == 0),
                "a rope tile holds whole heads, each half in whole 8-column groups");
  using Out = std::conditional_t<MODE == MODE_TAIL, float, bf16>;
  static_assert(sizeof(Out) == S::ES, "the tile's result size is the mode's");
  extern __shared__ __align__(1024) unsigned char raw[];
  uint8_t* ring = raw + ((1024 - (stk::smem_u32(raw) & 1023)) & 1023);
  uint8_t* out_buf = ring + NS * (S::STAGE_A + S::STAGE_W);  // NC buffers of S::OUT bytes
  float* bias_buf = reinterpret_cast<float*>(out_buf + NC * S::OUT);  // NC slices of BN
  uint64_t* full = reinterpret_cast<uint64_t*>(bias_buf + NC * BN);
  uint64_t* empty = full + NS;
  uint64_t* turn = empty + NS;
  uint64_t* xfull = turn + NC;  // x_in or the residual has landed in the consumer's buffer
  // the residual form: NC slices of the gate rows of the tile's first two
  // batch rows, BN / 2 bf16 pairs a row
  uint32_t* gate_buf = reinterpret_cast<uint32_t*>(xfull + NC);
  // the rope form, stages_angles: NC slices of the tile's rows' cos and sin,
  // 16-byte chunks (angle_chunk)
  float4* angle_buf = reinterpret_cast<float4*>(xfull + NC);
  constexpr bool STAGED = stages_angles<MODE, S, DH>();
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
      }
    }
  } else {
    stk::regs_alloc<stk::consumer_regs(NC, S::BPS)>();
    const int tid = threadIdx.x % 128, g = lane >> 2, t = lane & 3;
    uint8_t* buf = out_buf + wg * S::OUT;
    float* bias_s = bias_buf + wg * BN;
    uint32_t* gate_s = gate_buf + wg * BN;
    float acc[MI][BN / 2];
    constexpr int STRIDE = COOP ? 1 : NC;  // the consumer's turns among the block's tiles
    const int row0 = COOP ? S::ROWS * wg : 0;  // its rows of a tile
    for (int i = COOP ? 0 : wg, tile = blockIdx.x + i * gridDim.x; tile < tiles;
         i += STRIDE, tile += STRIDE * gridDim.x) {
      const int m0 = (tile / n_tiles) * S::BM, n0 = (tile % n_tiles) * BN;
      // the tile's bias columns into shared memory and the tail's per-row
      // mask and dt (the residual form's gate row slots) into registers, in
      // flight during the products (the last epilogue has read the slice:
      // its closing barrier, or this one)
      if constexpr (!S::TMA_STORE) stk::named_bar_sync(1 + wg, 128);
      if constexpr (IN_TMA) {
        // the tile's x_in or residual into the consumer's output buffer, once
        // the last tile's store has read it: issued by the consumer itself,
        // so the producer never waits on an epilogue; it lands during the
        // products
        if (tid == 0) {
          stk::bulk_wait_read<0>();
          stk::mbar_arrive_tx(&xfull[wg], S::OUT);
#pragma unroll
          for (int h = 0; h < BN / S::BOX; ++h)
            stk::tma_load_2d(buf + h * S::ROWS * 128, &tm_xin, &xfull[wg], n0 + S::BOX * h, m0);
        }
      }
      for (int c = tid; c < BN; c += 128)
        stk::cp_async4(stk::smem_u32(bias_s + c), p.bias + (n0 + c < p.N ? n0 + c : 0),
                       n0 + c < p.N);
      // the residual form: the gate rows of the tile's first two batch rows
      // (zeros past the last batch row or N); rows of other batch rows read
      // theirs from device memory in the epilogue
      const int b0 = MODE == MODE_RESID ? (m0 + row0) / p.T : 0;
      if constexpr (MODE == MODE_RESID && S::TMA_STORE) {
        if (p.gate)
          for (int c = tid; c < BN; c += 128) {
            const int bb = b0 + c / (BN / 2), col = n0 + 2 * (c % (BN / 2));
            const bool ok = bb < p.M / p.T && col < p.N;
            stk::cp_async4(stk::smem_u32(gate_s + c),
                           p.gate + (ok ? (size_t)bb * p.gstride + col : 0), ok);
          }
      }
      stk::cp_async_commit();
      float mk[MI][2], dtr[MI][2];
      int gsel[MI][2];  // the residual form: the row's gate row in the slice, or 2 and up
      if constexpr (STAGED) {
        // the rows' cos and sin pairs into the consumer's angle slice (rows
        // past M read the last row's), in flight during the products
        float4* ang = angle_buf + wg * (S::ROWS * DH / 4);
        for (int c = tid; c < S::ROWS * DH / 4; c += 128) {
          const int rr = c / (DH / 4), pr = c % (DH / 4), row = m0 + row0 + rr;
          const size_t e = (size_t)(row < p.M ? row : p.M - 1) * (DH / 2) + 2 * pr;
          const uint32_t at = stk::smem_u32(ang + angle_chunk<DH>(rr, pr));
          asm volatile("cp.async.ca.shared.global [%0], [%1], 8;\n" ::"r"(at), "l"(p.cs + e));
          asm volatile("cp.async.ca.shared.global [%0], [%1], 8;\n" ::"r"(at + 8), "l"(p.sn + e));
        }
        stk::cp_async_commit();
      }
      if constexpr (MODE == MODE_TAIL || MODE == MODE_RESID) {
#pragma unroll
        for (int r = 0; r < MI; ++r)
#pragma unroll
          for (int half = 0; half < 2; ++half) {
            const int row = m0 + row0 + 64 * r + 16 * warp + g + 8 * half;
            const int at = row < p.M ? row : p.M - 1;  // rows past M are not stored
            if constexpr (MODE == MODE_TAIL) {
              mk[r][half] = p.mask[at];
              dtr[r][half] = p.dt[at / p.T];
            } else {
              gsel[r][half] = at / p.T - b0;
            }
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
      if constexpr (S::TMA_STORE && !IN_TMA)
        if (tid == 0) stk::bulk_wait_read<0>();  // the last tile's store has read the buffer
      stk::named_bar_sync(1 + wg, 128);  // and every thread's bias columns have landed
      if constexpr (IN_TMA) stk::mbar_wait(&xfull[wg], (i / NC) & 1);
      if constexpr (MODE == MODE_ROPE) {
        // the rope form: the pair (j, jp = j + QN) of a head's two halves
        // sits in one thread (columns 8j + 2t and 8jp + 2t); each angle pair
        // (cos and sin of the head's columns 8q + 2t, + 1 at the row, from
        // device memory) serves the tile's BN / DH heads
        constexpr int QN = DH / 16;  // 8-column groups of a half head
#pragma unroll
        for (int q = 0; q < QN; ++q)
#pragma unroll
          for (int r = 0; r < MI; ++r)
#pragma unroll
            for (int half = 0; half < 2; ++half) {
              const int rr = 64 * r + 16 * warp + g + 8 * half, row = m0 + row0 + rr;
              const size_t ce = (size_t)(row < p.M ? row : p.M - 1) * (DH / 2) + 8 * q + 2 * t;
              float2 cv, sv;
              if constexpr (STAGED) {
                const float4 v =
                    angle_buf[wg * (S::ROWS * DH / 4) + angle_chunk<DH>(rr, 4 * q + t)];
                cv = make_float2(v.x, v.y);
                sv = make_float2(v.z, v.w);
              } else {
                cv = __ldg(reinterpret_cast<const float2*>(p.cs + ce));
                sv = __ldg(reinterpret_cast<const float2*>(p.sn + ce));
              }
#pragma unroll
              for (int h = 0; h < BN / DH; ++h) {
                const int j = h * (DH / 8) + q, jp = j + QN;
                const float2 ba = *reinterpret_cast<const float2*>(bias_s + 8 * j + 2 * t);
                const float2 bb = *reinterpret_cast<const float2*>(bias_s + 8 * jp + 2 * t);
                const uint32_t a = bias_pair(acc[r][4 * j + 2 * half],
                                             acc[r][4 * j + 2 * half + 1], bf16_pair(ba.x, ba.y));
                const uint32_t b = bias_pair(acc[r][4 * jp + 2 * half],
                                             acc[r][4 * jp + 2 * half + 1], bf16_pair(bb.x, bb.y));
                uint32_t o1, o2;
                rotate(a, b, cv, sv, o1, o2);
                *reinterpret_cast<uint32_t*>(pair_at<S>(buf, j, rr, t)) = o1;
                *reinterpret_cast<uint32_t*>(pair_at<S>(buf, jp, rr, t)) = o2;
              }
            }
      } else {
        // epilogue from the registers: rows 64r + 16 warp + g (+ 8) of the
        // consumer's rows, columns 8j + 2t (+ 1), a column pair a value
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
              float2 gv = make_float2(1.0f, 1.0f);
              if constexpr (MODE == MODE_RESID) {
                if (S::TMA_STORE && p.gate && gsel[r][half] < 2)
                  gv = unpack(gate_s[gsel[r][half] * (BN / 2) + 4 * j + t]);
                else
                  gv = gate_pair(p, row, col);
              }
              if constexpr (S::TMA_STORE) {
                uint8_t* at = pair_at<S>(buf, j, rr, t);
                float2 x = make_float2(0.0f, 0.0f);
                if constexpr (MODE == MODE_TAIL) x = *reinterpret_cast<const float2*>(at);
                if constexpr (MODE == MODE_RESID)
                  x = unpack(*reinterpret_cast<const uint32_t*>(at));
                *reinterpret_cast<stk::Pair<S::ES>*>(at) = epi_pair<MODE>(v0, v1, b, x, gv, m, d);
              } else if (row < p.M && col < p.N) {
                const size_t e = (size_t)row * p.N + col;
                float2 x = make_float2(0.0f, 0.0f);
                if constexpr (MODE == MODE_TAIL)
                  x = make_float2(p.x_in[e], col + 1 < p.N ? p.x_in[e + 1] : 0.0f);
                if constexpr (MODE == MODE_RESID) x = load_pair(p.res, e, col, p.N);
                const auto v = epi_pair<MODE>(v0, v1, b, x, gv, m, d);
                stk::store_pair_any(reinterpret_cast<Out*>(p.y), e, col, p.N, v);
              }
            }
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
// columns 4 tx .. 4 tx + 3 (two pairs), K in chunks of 32 staged as f32. In
// the rope form (any even head width) the block's 64 columns are 32 rotated
// pairs u0 + c (u0 = 32 blockIdx.y; pair u: position u % (dh / 2) of head u /
// (dh / 2)): column c < 32 the first half's, c + 32 its partner in the
// second half; a thread's are pairs 2 tx, 2 tx + 1 and their partners.
template <int MODE>
__global__ void __launch_bounds__(S_THREADS) linear_simt(const bf16* __restrict__ X,
                                                         const bf16* __restrict__ W, Args p) {
  using Out = std::conditional_t<MODE == MODE_TAIL, float, bf16>;
  constexpr int HT = S_TILE / 2;
  __shared__ float xs[S_KC][S_TILE + 1], ws[S_KC][S_TILE + 1];
  const int M = p.M, N = p.N, K = p.K, hf = p.dh / 2;
  const int tx = threadIdx.x % 16, ty = threadIdx.x / 16;
  const int m0 = blockIdx.x * S_TILE, n0 = blockIdx.y * S_TILE;
  // the block's column c (past N for pairs past the last head)
  auto column = [&](int c) {
    if constexpr (MODE == MODE_ROPE) {
      const int u = blockIdx.y * HT + c % HT;
      return (u / hf) * p.dh + u % hf + (c >= HT ? hf : 0);
    } else {
      return n0 + c;
    }
  };
  // the block column of the thread's column j < 4
  auto mine = [&](int j) {
    return MODE == MODE_ROPE ? 2 * tx + (j & 1) + (j >> 1) * HT : 4 * tx + j;
  };
  float acc[4][4];
#pragma unroll
  for (int i = 0; i < 4; ++i)
#pragma unroll
    for (int j = 0; j < 4; ++j) acc[i][j] = 0.0f;
  for (int k0 = 0; k0 < K; k0 += S_KC) {
    for (int i = threadIdx.x; i < S_TILE * S_KC; i += S_THREADS) {
      const int r = i / S_KC, kk = i % S_KC, k = k0 + kk, n = column(r);
      xs[kk][r] = m0 + r < M && k < K ? __bfloat162float(X[(size_t)(m0 + r) * K + k]) : 0.0f;
      ws[kk][r] = n < N && k < K ? __bfloat162float(W[(size_t)n * K + k]) : 0.0f;
    }
    __syncthreads();
#pragma unroll 8
    for (int kk = 0; kk < S_KC; ++kk) {
      float a[4], b[4];
#pragma unroll
      for (int i = 0; i < 4; ++i) a[i] = xs[kk][ty + 16 * i];
#pragma unroll
      for (int j = 0; j < 4; ++j) b[j] = ws[kk][mine(j)];
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
      if constexpr (MODE == MODE_ROPE) {
        // pair u: the bias forms of its two columns, rotated
        const int u = blockIdx.y * HT + 2 * tx + q;
        if (u >= N / 2) continue;
        const int ca = column(2 * tx + q), cb = ca + hf;
        const float2 ab = unpack(bias_pair(acc[i][q], acc[i][2 + q],
                                           bf16_pair(p.bias[ca], p.bias[cb])));
        const size_t ce = (size_t)row * hf + u % hf;
        const float c = p.cs[ce], s = p.sn[ce];
        bf16* y = reinterpret_cast<bf16*>(p.y) + (size_t)row * N;
        y[ca] = __float2bfloat16_rn(__fsub_rn(__fmul_rn(ab.x, c), __fmul_rn(ab.y, s)));
        y[cb] = __float2bfloat16_rn(__fadd_rn(__fmul_rn(ab.x, s), __fmul_rn(ab.y, c)));
      } else {
        const int col = n0 + 4 * tx + 2 * q;
        if (col >= N) continue;
        const bool two = col + 1 < N;
        const size_t e = (size_t)row * N + col;
        const float2 b = bf16_pair(p.bias[col], two ? p.bias[col + 1] : 0.0f);
        float2 x = make_float2(0.0f, 0.0f), gv = make_float2(1.0f, 1.0f);
        if constexpr (MODE == MODE_TAIL) x = make_float2(p.x_in[e], two ? p.x_in[e + 1] : 0.0f);
        if constexpr (MODE == MODE_RESID) {
          x = load_pair(p.res, e, col, N);
          gv = gate_pair(p, row, col);
        }
        stk::store_pair_any(reinterpret_cast<Out*>(p.y), e, col, N,
                            epi_pair<MODE>(acc[i][2 * q], acc[i][2 * q + 1], b, x, gv, m, d));
      }
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
using ManyResid = Tile<3, 1, 128, 7, 1, false, true, 2>;  // the residual form at many tiles
using RopeMany = Tile<2, 2, 128, 5, 1, false, true, 2>;   // the rope form at Dh 16, 32, 64, 128
using Rope192 = Tile<2, 1, 192, 5, 1, false, true, 2>;   // 64 x 192: the rope form at Dh 96, 192
using Rope256 = Tile<2, 1, 256, 3, 1, false, true, 2>;   // 64 x 256: the rope form at Dh 256

template <typename S>
long long tiles_of(int M, int N) {
  return (long long)((M + S::BM - 1) / S::BM) * ((N + S::BN - 1) / S::BN);
}

template <int MODE, typename S, int DH = 0>
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
    if constexpr (MODE == MODE_RESID)
      if (int err = stk::encode_rows<bf16>(&txin, p.res, p.M, p.N, S::ROWS, out_type)) return err;
  }
  auto kernel = linear_wgmma<MODE, S, DH>;
  constexpr size_t smem = smem_of<MODE, S>() +
                         (stages_angles<MODE, S, DH>() ? (size_t)S::NC * S::ROWS * DH * 4 : 0);
  static_assert(smem * S::BPS <= 232448, "the blocks' shared memory");
  static size_t smem_set[stk::kMaxDevices] = {};  // one per instantiation
  if (int err = stk::allow_dynamic_smem(kernel, smem, smem_set)) return err;
  static int regs_at_entry = 0;
  if (int err = stk::check_reg_split(kernel, 128, S::NC * 128,
                                     stk::consumer_regs(S::NC, S::BPS), regs_at_entry))
    return err;
  kernel<<<blocks, S::THREADS, smem, st>>>(tx, tw, ty, txin, p,
                                              (p.N + S::BN - 1) / S::BN, (int)tiles);
  return (int)cudaGetLastError();
}

// the instances, in stk_linear_tiles' order, and the SIMT kernel
enum Instance { I_MANY, I_MANY_SILU, I_FEW, I_ANY_N, I_TAIL, I_TAIL_ANY_N, I_ROPE_192, I_ROPE_256,
                I_RESID_MANY, I_SIMT };

// the instance a launch of mode at M x N x K (the rope form: heads of dh)
// takes on a card of sms SMs
Instance pick(int mode, int M, int N, int K, int dh, int sms) {
  if (K % 8) return I_SIMT;  // rows of X and W no TMA map takes
  if (mode == MODE_TAIL) return N % 4 ? I_TAIL_ANY_N : I_TAIL;
  if (mode == MODE_ROPE) {  // a tile of whole heads, each half in whole 8-column groups
    switch (dh) {
      case 16: case 32: case 128: return I_MANY;
      case 64: return tiles_of<Many>(M, N) >= 2LL * sms ? I_MANY : I_FEW;
      case 96: case 192: return I_ROPE_192;
      case 256: return I_ROPE_256;
      default: return I_SIMT;  // any other even width
    }
  }
  if (N % 8) return I_ANY_N;  // rows no TMA map takes
  if (tiles_of<Many>(M, N) >= 2LL * sms)
    return mode == MODE_SILU ? I_MANY_SILU : mode == MODE_RESID ? I_RESID_MANY : I_MANY;
  // the residual form keeps TMA-stored tiles (the residual lands during the
  // products) where the bias form takes narrower ones from the registers
  if (mode == MODE_RESID || 2 * tiles_of<Few>(M, N) >= sms) return I_FEW;
  return I_ANY_N;  // more, narrower tiles
}

template <int MODE>
int launch(const bf16* x, const bf16* w, const Args& p, cudaStream_t st) {
  const int M = p.M, N = p.N, K = p.K;
  if (M < 1 || N < 1 || K < 1) return (int)cudaErrorInvalidValue;
  int sms = 0;
  if (int err = stk::sm_count(sms)) return err;
  const Instance in = pick(MODE, M, N, K, p.dh, sms);
  if (in == I_SIMT) {
    const long long n_tiles = (N + S_TILE - 1) / S_TILE;
    if (n_tiles > 65535) return (int)cudaErrorInvalidValue;
    const dim3 grid((M + S_TILE - 1) / S_TILE, (unsigned)n_tiles);
    linear_simt<MODE><<<grid, S_THREADS, 0, st>>>(x, w, p);
    return (int)cudaGetLastError();
  }
  if constexpr (MODE == MODE_TAIL) {
    return in == I_TAIL ? launch_tiles<MODE, TailTile>(x, w, p, st)
                        : launch_tiles<MODE, TailAnyN>(x, w, p, st);
  } else if constexpr (MODE == MODE_ROPE) {
    if (in == I_FEW) return launch_tiles<MODE, Few, 64>(x, w, p, st);
    if (in == I_ROPE_256) return launch_tiles<MODE, Rope256, 256>(x, w, p, st);
    if (in == I_ROPE_192)
      return p.dh == 96 ? launch_tiles<MODE, Rope192, 96>(x, w, p, st)
                        : launch_tiles<MODE, Rope192, 192>(x, w, p, st);
    switch (p.dh) {
      case 16: return launch_tiles<MODE, RopeMany, 16>(x, w, p, st);
      case 32: return launch_tiles<MODE, RopeMany, 32>(x, w, p, st);
      case 64: return launch_tiles<MODE, RopeMany, 64>(x, w, p, st);
      default: return launch_tiles<MODE, RopeMany, 128>(x, w, p, st);
    }
  } else {
    using ManyOfMode = std::conditional_t<MODE == MODE_SILU, ManySilu,
                                          std::conditional_t<MODE == MODE_RESID, ManyResid, Many>>;
    if (in == I_MANY || in == I_MANY_SILU || in == I_RESID_MANY)
      return launch_tiles<MODE, ManyOfMode>(x, w, p, st);
    if (in == I_FEW) return launch_tiles<MODE, Few>(x, w, p, st);
    return launch_tiles<MODE, AnyN>(x, w, p, st);
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
  const Args p{f(bias), f(x_in), f(mask), f(dt), nullptr, nullptr, nullptr, nullptr, 0, y,
               M, N, K, T, 0};
  if (mode == MODE_BIAS) return launch<MODE_BIAS>(xb, wb, p, st);
  if (mode == MODE_SILU) return launch<MODE_SILU>(xb, wb, p, st);
  if (mode == MODE_TAIL) return launch<MODE_TAIL>(xb, wb, p, st);
  return (int)cudaErrorInvalidValue;
}

// The Q, K and O projections' forms, x [M, K] and w [N, K] bf16, bias [N]
// f32, y [M, N] bf16: mode 3 (rope) cs, sn [M, dh / 2] f32, heads of dh
// columns (dh even, dividing N) rotated; mode 4 (the gated residual) res
// [M, N] bf16 and gate rows of N bf16, batch row i (T rows a batch row) at i
// * gstride, or null (gate and gstride 4-byte aligned at an even N). All
// else contiguous and 16-byte aligned.
extern "C" int stk_linear_epilogue(const void* x, const void* w, const void* bias, const void* cs,
                                   const void* sn, const void* res, const void* gate,
                                   long long gstride, void* y, int M, int N, int K, int T, int dh,
                                   int mode, void* stream) {
  const bf16* xb = (const bf16*)x;
  const bf16* wb = (const bf16*)w;
  cudaStream_t st = (cudaStream_t)stream;
  if (T < 1 || gstride < 0) return (int)cudaErrorInvalidValue;
  const Args p{(const float*)bias, nullptr, nullptr, nullptr, (const float*)cs, (const float*)sn,
               (const bf16*)res, (const bf16*)gate, gstride, y, M, N, K, T, dh};
  if (mode == MODE_ROPE) {
    if (dh < 2 || dh % 2 || N % dh) return (int)cudaErrorInvalidValue;
    return launch<MODE_ROPE>(xb, wb, p, st);
  }
  if (mode == MODE_RESID) return launch<MODE_RESID>(xb, wb, p, st);
  return (int)cudaErrorInvalidValue;
}

// the instances' tiles, rows x columns x ring stages: bf16 results at many
// tiles (the bias and rope forms; the silu form), at few, at fewer
// or an N whose rows no TMA map takes, then the tail's f32 results (x_in by
// TMA) and the tail's at any N, then the rope form's at Dh 96 and 192 and at
// Dh 256, and the residual form's at many tiles
extern "C" int stk_linear_tiles(int* tiles) {
  const int v[27] = {Many::BM,      Many::BN,      Many::NS,      ManySilu::BM, ManySilu::BN,
                     ManySilu::NS,  Few::BM,       Few::BN,       Few::NS,      AnyN::BM,
                     AnyN::BN,      AnyN::NS,      TailTile::BM,  TailTile::BN, TailTile::NS,
                     TailAnyN::BM,  TailAnyN::BN,  TailAnyN::NS,  Rope192::BM,  Rope192::BN,
                     Rope192::NS,   Rope256::BM,   Rope256::BN,   Rope256::NS,  ManyResid::BM,
                     ManyResid::BN, ManyResid::NS};
  for (int i = 0; i < 27; ++i) tiles[i] = v[i];
  return 0;
}

// the instance a launch of mode at M x N x K (the rope form: heads of dh)
// takes on the current card: an index into stk_linear_tiles' list, 9 for the
// SIMT kernel, -1 for no launch
extern "C" int stk_linear_instance(int M, int N, int K, int mode, int dh) {
  int sms = 0;
  if (M < 1 || N < 1 || K < 1 || mode < MODE_BIAS || mode > MODE_RESID ||
      (mode == MODE_ROPE && (dh < 2 || dh % 2 || N % dh)) || stk::sm_count(sms))
    return -1;
  return (int)pick(mode, M, N, K, dh, sms);
}
