// Not on the path: the two-pass design that csrc/attention.cu's whole-row
// form replaced at bf16 Dh 64 (Tk up to ROW_KEYS), kept whole so that
// kernel_variants.py can build it as its "earlier" variant and split its
// time (the package builds csrc/*.cu only). csrc/attention.cu keeps the
// same two-pass kernel for the other shapes.
//
// Masked multi-head softmax attention, [B, T, H, Dh] in and out.
//
// Replaces supertonic_tpu/ops/attention.py:_attn_kernel_rows (the Pallas
// kernel behind fused_attention): out = softmax(q.k^T * scale + bias) v with
// bias = (1 - key_mask) * -1e9 added after the scale product, logits and
// softmax statistics in f32, probabilities rounded to v's storage type
// before the PV product, PV accumulated in f32, output in q's type. Keys
// past Tk get -inf; a fully masked row sees every logit at -1e9 and so gives
// the uniform mean of v, never NaN. Any Tq and Tk (keys stream through
// shared memory, so there is no length cap) and any Dh, with the
// scale the caller passes (1/sqrt of the model's true head width, which a
// caller that pads Dh with zero columns keeps: zero columns change no logit
// and no kept output column).
//
// Bound on the H100: at the path's shapes (Tq, Tk <= ~700, Dh = 64) the
// arithmetic is 4*Tq*Tk*Dh per head against 4*(Tq+Tk)*Dh*size bytes, so in
// bf16 the tensor-core bound sits near the memory bound. Keeping the Pallas
// kernel's rounding point (probabilities normalised, then rounded) needs
// two passes over the keys: q.k is computed twice and every logit takes two
// exponentials, which on the SFU (16 a clock an SM) cost about as much as
// the products. What sets the pace is keeping the products, the
// exponentials and the loads in flight together.
//
// bf16 design (attn_wgmma), on Hopper's own instructions: a block is one
// producer warpgroup and CONSUMERS consumer warpgroups of 64 queries of one
// (batch, head) each. The producer's first warp loads Q once and streams K
// (pass 1) then K and V (pass 2) in STAGE_KEYS-key tiles through a
// STAGES-deep ring by TMA (one 4-D map per operand over (Dh, H, T, B), box
// (64, 1, rows, 1), 128-byte swizzle: a box never crosses a batch row, and
// keys past Tk arrive as zeros) behind full/empty mbarriers; its lanes
// write each stage's key bias (log2 units; -inf for keys past Tk, which
// the zero fill alone would leave at logit 0), loaded from the mask a step
// ahead. setmaxnreg moves the producer's registers to the consumers. Pass
// 1: S = Q.K^T by wgmma.m64nNk16 (N = STAGE_KEYS) with Q and K both K-major
// from shared memory, scale and bias in registers, running max and sum per
// row reduced in trees. Pass 2: S again, p = exp2(s - max) / sum rounded to
// bf16 and repacked from the accumulators straight into wgmma's
// A-from-registers fragments, O += P.V by wgmma.m64n64k16 with V the
// MN-major (transposed) B operand; a tile's P.V products run on beside the
// next tile's S products. The exponentials are ex2 with log2(e) folded into
// the scale and bias, 1/sum once a row. O leaves as bf16 through the
// consumer's Q tile, in 16-byte stores.
// One tile's softmax overlaps another's products across the blocks that
// share an SM: the measured alternatives (kernel_variants.py: starting the
// next tile's S products before this tile's softmax, with a second S and P
// in registers; two consumer warpgroups a block; three blocks an SM) were
// slower, the first two for the registers and instructions they add, the
// last for spills. Keep every accumulator written by wgmma alone while
// products are in flight: a plain write to one (even its zeroing) makes the
// compiler serialise them.
// Tiles for the path's lengths (T = 448 and 640, L = 320, cross Tk = 370
// and 50): 64 queries a block and 64 keys a stage divide 448, 640 and 320
// with no waste (a 128 tile wastes 1/8 at 448) and give a B = 1 call twice
// the blocks of 128; 370 keys take 6 stages (384). The mma.sync design
// this replaces (csrc/earlier/attention_mma_sync.cu) is kernel_variants.py's
// "earlier" variant.
// Other head widths: one instance per DK = Dh in steps of 16 (16 .. 256;
// the wrapper pads a Dh up to 256 that is not a multiple of 16 with zero
// columns).
// Every operand tile keeps the layout above in panels of 64 columns (one
// 128-byte swizzled row a panel row; DK 80-128 take two panels, 144-192
// three, 208-256 four): the TMA box stays 64 columns wide and zero-fills
// the columns past Dh, the S product runs DK / 16 k16 steps across the
// panels, and P.V one n64 product a panel, whose columns past Dh come out 0
// and are not stored. Two panels double the ring's bytes, so they take 2
// ring stages (two blocks an SM still fit); three and four panels take one
// block an SM, its consumer 240 registers (O is 32 NP floats a thread), and
// as many stages of 64 keys as fit 227 KB (4 and 3: a four-panel stage of K
// and V is 64 KB). DK = 64 is the one-panel kernel above.
//
// f32 at every Dh, and bf16 above 256 (attn_wide): SIMT, exact to f32
// rounding, the same two passes; one block of 4 warps per (batch, head
// and slice of WIDE_DS output columns, 16 queries), each warp 4 rows,
// lanes over keys for q.k and over output columns for p.v. A block computes
// the full logits, Q and K in WIDE_DC-column chunks through shared memory
// in turn, and P.V for its own slice of V and O, so shared memory does not
// grow with Dh and any Dh runs unpadded. It replaced an f32 kernel with
// instances at D 32-128 and the same sum orders
// (csrc/earlier/attention_f32_simt.cu), which kernel_variants.py times
// beside it.
#include "wgmma.cuh"

namespace {

constexpr int BQ = 16;   // queries per block
constexpr int NW = 4;    // warps per block
constexpr int R = BQ / NW;  // query rows per warp

constexpr int WIDE_DC = 64;   // columns of a q.k chunk
constexpr int WIDE_DS = 128;  // output columns a block
constexpr int WIDE_BK = 32;   // keys a tile: one a lane

template <typename T>
__global__ void __launch_bounds__(NW * 32)
attn_wide(const T* __restrict__ q, const T* __restrict__ k, const T* __restrict__ v,
          const float* __restrict__ mask, T* __restrict__ out, int Tq, int Tk, int H, int D,
          float scale) {
  constexpr int DL = WIDE_DS / 32;  // output columns per lane
  __shared__ float Qs[BQ][WIDE_DC];
  __shared__ float Ks[WIDE_BK][WIDE_DC + 1];
  __shared__ float Vs[WIDE_BK][WIDE_DS + 1];
  __shared__ float Ps[NW][R][WIDE_BK];
  __shared__ float Bs[WIDE_BK];

  const int tid = threadIdx.x, warp = tid >> 5, lane = tid & 31;
  const int slices = (D + WIDE_DS - 1) / WIDE_DS;
  const int b = blockIdx.z, h = blockIdx.y / slices, c0 = (blockIdx.y % slices) * WIDE_DS;
  const int q0 = blockIdx.x * BQ;
  const size_t rs = (size_t)H * D;  // stride between time steps
  const T* qb = q + (size_t)b * Tq * rs + (size_t)h * D;
  const T* kb = k + (size_t)b * Tk * rs + (size_t)h * D;
  const T* vb = v + (size_t)b * Tk * rs + (size_t)h * D;

  // the tile's key bias and (pass 2) its V columns of this block's slice
  auto load_tile = [&](int k0, bool with_v) {
    __syncthreads();  // the previous tile is no longer read
    if (with_v)
      for (int e = tid; e < WIDE_BK * WIDE_DS; e += NW * 32) {
        const int j = e / WIDE_DS, c = c0 + e % WIDE_DS, kj = k0 + j;
        Vs[j][e % WIDE_DS] = kj < Tk && c < D ? stk::to_f(vb[(size_t)kj * rs + c]) : 0.0f;
      }
    if (tid < WIDE_BK) {
      const int kj = k0 + tid;
      Bs[tid] = kj >= Tk ? -INFINITY
                : (mask ? (1.0f - mask[(size_t)b * Tk + kj]) * -1e9f : 0.0f);
    }
  };
  // logits of this warp's R rows against key `lane` of the tile at k0, over
  // Dh in chunks of WIDE_DC columns (every thread loads, so every thread
  // calls)
  auto logits = [&](int k0, float s[R]) {
#pragma unroll
    for (int r = 0; r < R; ++r) s[r] = 0.0f;
    for (int d0 = 0; d0 < D; d0 += WIDE_DC) {
      __syncthreads();  // the last chunk is no longer read
      for (int e = tid; e < BQ * WIDE_DC; e += NW * 32) {
        const int r = e / WIDE_DC, d = d0 + e % WIDE_DC, qi = q0 + r;
        Qs[r][e % WIDE_DC] = qi < Tq && d < D ? stk::to_f(qb[(size_t)qi * rs + d]) : 0.0f;
      }
      for (int e = tid; e < WIDE_BK * WIDE_DC; e += NW * 32) {
        const int j = e / WIDE_DC, d = d0 + e % WIDE_DC, kj = k0 + j;
        Ks[j][e % WIDE_DC] = kj < Tk && d < D ? stk::to_f(kb[(size_t)kj * rs + d]) : 0.0f;
      }
      __syncthreads();
      const int n = D - d0 < WIDE_DC ? D - d0 : WIDE_DC;
      for (int d = 0; d < n; ++d) {
        const float kv = Ks[lane][d];
#pragma unroll
        for (int r = 0; r < R; ++r) s[r] += Qs[warp * R + r][d] * kv;
      }
    }
#pragma unroll
    for (int r = 0; r < R; ++r) s[r] = s[r] * scale + Bs[lane];
  };

  // pass 1: running max and sum per row, per lane, then across the warp
  float m[R], l[R];
#pragma unroll
  for (int r = 0; r < R; ++r) { m[r] = -INFINITY; l[r] = 0.0f; }
  for (int k0 = 0; k0 < Tk; k0 += WIDE_BK) {
    load_tile(k0, false);
    float s[R];
    logits(k0, s);
#pragma unroll
    for (int r = 0; r < R; ++r) {
      if (s[r] == -INFINITY) continue;  // key past Tk
      if (s[r] > m[r]) { l[r] = l[r] * expf(m[r] - s[r]) + 1.0f; m[r] = s[r]; }
      else l[r] += expf(s[r] - m[r]);
    }
  }
#pragma unroll
  for (int r = 0; r < R; ++r) {
    float mx = stk::warp_max(m[r]);
    float part = m[r] == -INFINITY ? 0.0f : l[r] * expf(m[r] - mx);
    l[r] = stk::warp_sum(part);
    m[r] = mx;
  }

  // pass 2: probabilities rounded to v's type, accumulate p * v in f32
  float acc[R][DL];
#pragma unroll
  for (int r = 0; r < R; ++r)
#pragma unroll
    for (int t = 0; t < DL; ++t) acc[r][t] = 0.0f;
  for (int k0 = 0; k0 < Tk; k0 += WIDE_BK) {
    load_tile(k0, true);
    float s[R];
    logits(k0, s);  // its barriers also order the V and bias loads
#pragma unroll
    for (int r = 0; r < R; ++r)
      Ps[warp][r][lane] = s[r] == -INFINITY ? 0.0f : stk::rnd<T>(expf(s[r] - m[r]) / l[r]);
    __syncwarp();
    for (int j = 0; j < WIDE_BK; ++j) {
#pragma unroll
      for (int t = 0; t < DL; ++t) {
        const float vv = Vs[j][lane + 32 * t];
#pragma unroll
        for (int r = 0; r < R; ++r) acc[r][t] += Ps[warp][r][j] * vv;
      }
    }
    __syncwarp();
  }

  T* ob = out + (size_t)b * Tq * rs + (size_t)h * D;
#pragma unroll
  for (int r = 0; r < R; ++r) {
    const int qi = q0 + warp * R + r;
    if (qi >= Tq) continue;
#pragma unroll
    for (int t = 0; t < DL; ++t) {
      const int c = c0 + lane + 32 * t;
      if (c < D) ob[(size_t)qi * rs + c] = stk::from_f<T>(acc[r][t]);
    }
  }
}

// ---------------------------------------------------------------------------
// bf16 on the tensor cores
// ---------------------------------------------------------------------------
using bf16 = __nv_bfloat16;
constexpr int DH = 64;  // columns of a panel: one 128-byte swizzled row
constexpr int MAX_DK = 256;  // the widest instance: four panels
constexpr float LOG2E = 1.4426950408889634f;
// Design knobs (kernel_variants.py builds other values): consumer
// warpgroups a block (64 queries each), keys a ring stage (the N of the
// S product), ring depth, blocks an SM (which sets the register split).
constexpr int CONSUMERS = 1;
constexpr int STAGE_KEYS = 64;
constexpr int STAGES = 4;
constexpr int BLOCKS_PER_SM = 2;
constexpr int STAGES_TWO_PANELS = 2;  // ring depth at DK 80-128
// three and four panels: one block an SM, the stages that fit 227 KB
template <int NP> constexpr int stages_of() {
  return NP == 1 ? STAGES : NP == 2 ? STAGES_TWO_PANELS : NP == 3 ? 4 : 3;
}
template <int NP> constexpr int blocks_of() { return NP <= 2 ? BLOCKS_PER_SM : 1; }

// NP panels of DH columns: a panel of a tile is rows x DH, swizzled
template <int NC, int BKT, int NS, int NP>
struct AttnSmem {
  bf16 q[NC][NP][64 * DH];   // each consumer's Q tile; at the end its output staging
  bf16 k[NS][NP][BKT * DH];  // the ring: K of every step, V of pass 2's steps
  bf16 v[NS][NP][BKT * DH];
  float bias[NS][BKT];       // the stage's key bias in log2 units, -inf past Tk
  uint64_t full[NS], empty[NS], q_full;
};

// pins P's A fragments at this point (wgmma reads them asynchronously)
template <int KK>
__device__ __forceinline__ void fence_p(uint32_t (&p)[KK][4]) {
#pragma unroll
  for (int kk = 0; kk < KK; ++kk)
#pragma unroll
    for (int e = 0; e < 4; ++e) asm volatile("" : "+r"(p[kk][e])::"memory");
}

// DK: the tensors' head width, a multiple of 16 (16 .. 128), in NP panels
template <int NC, int BKT, int NS, int BPS, int DK>
__global__ void __launch_bounds__((NC + 1) * 128, BPS)
attn_wgmma(__grid_constant__ const CUtensorMap tm_q, __grid_constant__ const CUtensorMap tm_k,
           __grid_constant__ const CUtensorMap tm_v, const float* __restrict__ mask,
           bf16* __restrict__ out, int Tq, int Tk, int H, float scale_log2) {
  static_assert(DK % 16 == 0 && DK <= MAX_DK, "head width in steps of 16 up to 256");
  constexpr int NP = (DK + DH - 1) / DH;
  using Smem = AttnSmem<NC, BKT, NS, NP>;
  extern __shared__ __align__(1024) unsigned char raw[];
  // swizzled tiles need 1024-byte alignment; the launch adds the slack
  Smem& sm = *reinterpret_cast<Smem*>(raw + ((1024 - (stk::smem_u32(raw) & 1023)) & 1023));
  const int wg = threadIdx.x / 128, warp = (threadIdx.x / 32) & 3, lane = threadIdx.x & 31;
  const int b = blockIdx.z, h = blockIdx.y, q0 = blockIdx.x * 64 * NC;
  const int n_tiles = (Tk + BKT - 1) / BKT;
  if (threadIdx.x == 0) {
#pragma unroll
    for (int s = 0; s < NS; ++s) {
      stk::mbar_init(&sm.full[s], 32);        // the producer warp's lanes
      stk::mbar_init(&sm.empty[s], 4 * NC);  // each consumer warp
    }
    stk::mbar_init(&sm.q_full, 1);
    stk::mbar_fence_init();
  }
  __syncthreads();

  if (wg == NC) {
    // producer warpgroup: its first warp walks the ring, pass 1 (K) then
    // pass 2 (K and V). Lane 0 issues the stage's TMA boxes; every lane
    // writes its keys' bias, loaded from the mask one step ahead so that the
    // loads' latency passes while the stage is still in use, and arrives
    // after its own writes.
    stk::regs_dealloc<stk::kProducerRegs>();
    if (warp != 0) return;
    if (lane == 0) {
      stk::mbar_arrive_tx(&sm.q_full, NC * NP * 64 * DH * 2);
#pragma unroll
      for (int c = 0; c < NC; ++c)
#pragma unroll
        for (int p = 0; p < NP; ++p)
          stk::tma_load_4d(sm.q[c][p], &tm_q, &sm.q_full, DH * p, h, q0 + 64 * c, b);
    }
    const float* mb = mask ? mask + (size_t)b * Tk : nullptr;
    float bias[BKT / 32];  // this lane's keys of the next step
    auto load_bias = [&](int step) {
      const int k0 = (step >= n_tiles ? step - n_tiles : step) * BKT;
#pragma unroll
      for (int i = 0; i < BKT / 32; ++i) {
        const int kj = k0 + lane + 32 * i;
        bias[i] = kj >= Tk ? -INFINITY : (mb ? (1.0f - mb[kj]) * (-1e9f * LOG2E) : 0.0f);
      }
    };
    load_bias(0);
    for (int step = 0; step < 2 * n_tiles; ++step) {
      const int s = step % NS;
      const bool with_v = step >= n_tiles;
      const int k0 = (with_v ? step - n_tiles : step) * BKT;
      stk::mbar_wait(&sm.empty[s], ((step / NS) & 1) ^ 1);
      if (lane == 0) {
        stk::mbar_expect_tx(&sm.full[s], (with_v ? 2 : 1) * NP * BKT * DH * 2);
        // keys past Tk are zero-filled by the map's T extent, never the next
        // row's, and columns past DK by its Dh extent
#pragma unroll
        for (int p = 0; p < NP; ++p) {
          stk::tma_load_4d(sm.k[s][p], &tm_k, &sm.full[s], DH * p, h, k0, b);
          if (with_v) stk::tma_load_4d(sm.v[s][p], &tm_v, &sm.full[s], DH * p, h, k0, b);
        }
      }
#pragma unroll
      for (int i = 0; i < BKT / 32; ++i) sm.bias[s][lane + 32 * i] = bias[i];
      stk::mbar_arrive(&sm.full[s]);
      if (step + 1 < 2 * n_tiles) load_bias(step + 1);
    }
  } else {
    // consumer warpgroup wg: queries [q0 + 64 wg, + 64), thread rows
    // 16 warp + g and + 8 in the wgmma accumulator layout (csrc/wgmma.cuh)
    stk::regs_alloc<stk::consumer_regs(NC, BPS)>();
    const int g = lane >> 2, t = lane & 3;
    const uint32_t q_addr = stk::smem_u32(sm.q[wg]);
    constexpr int NJ = BKT / 8;
    constexpr int SN = BKT / 2;  // S accumulators a thread
    float s[SN], o[NP][32];  // S of the current tile, O by panel
    uint32_t pa[BKT / 16][4];  // P's A fragments, key step kk

    // ring step `step` (pass 1: key tile step; pass 2: step - n_tiles) has
    // landed: start s = Q.K^T of its stage (DK / 16 products over Dh, k16
    // step kk in panel kk / 4, the first overwriting s), committed as one
    // group
    auto issue_s = [&](int step) {
      const int st = step % NS;
      stk::mbar_wait(&sm.full[st], (step / NS) & 1);
      const uint32_t k_addr = stk::smem_u32(sm.k[st]);
      stk::wgmma_fence();
#pragma unroll
      for (int kk = 0; kk < DK / 16; ++kk)
        stk::Wgmma<BKT>::template ss<0>(
            s, stk::desc_sw128(q_addr + (kk / 4) * 64 * DH * 2 + 32 * (kk % 4)),
            stk::desc_sw128(k_addr + (kk / 4) * BKT * DH * 2 + 32 * (kk % 4)), kk);
      stk::wgmma_commit();
    };
    // every product in flight has completed: s, scaled and biased in log2
    // units (in place: nothing is in flight that writes it)
    auto finish_s = [&](int step) {
      stk::wgmma_wait<0>();
      stk::fence_regs(s);
      const float* bias = sm.bias[step % NS];
#pragma unroll
      for (int j = 0; j < NJ; ++j) {
        const float2 bj = *reinterpret_cast<const float2*>(bias + 8 * j + 2 * t);
        s[4 * j] = fmaf(s[4 * j], scale_log2, bj.x);
        s[4 * j + 1] = fmaf(s[4 * j + 1], scale_log2, bj.y);
        s[4 * j + 2] = fmaf(s[4 * j + 2], scale_log2, bj.x);
        s[4 * j + 3] = fmaf(s[4 * j + 3], scale_log2, bj.y);
      }
    };
    // the stage of `step` is read (products complete, bias loaded): one
    // arrival a warp
    auto release = [&](int step) {
      __syncwarp();
      if (lane == 0) stk::mbar_arrive(&sm.empty[step % NS]);
    };

    // a warpgroup whose queries all lie past Tq (the last block of an odd
    // number of 64-query tiles) only releases each stage it would have read
    if (q0 + 64 * wg >= Tq) {
      for (int step = 0; step < 2 * n_tiles; ++step) {
        stk::mbar_wait(&sm.full[step % NS], (step / NS) & 1);
        release(step);
      }
      return;
    }
    stk::mbar_wait(&sm.q_full, 0);
    // pass 1: running max and sum per row over this thread's keys, reduced
    // in trees (short dependency chains). The softmax of one block overlaps
    // another's products: BLOCKS_PER_SM blocks share an SM.
    float m[2] = {-INFINITY, -INFINITY}, l[2] = {0.0f, 0.0f};
    for (int tile = 0; tile < n_tiles; ++tile) {
      issue_s(tile);
      finish_s(tile);
      release(tile);
#pragma unroll
      for (int r = 0; r < 2; ++r) {
        float v[NJ];
#pragma unroll
        for (int j = 0; j < NJ; ++j) v[j] = fmaxf(s[4 * j + 2 * r], s[4 * j + 2 * r + 1]);
#pragma unroll
        for (int w = NJ / 2; w > 0; w /= 2)
#pragma unroll
          for (int j = 0; j < w; ++j) v[j] = fmaxf(v[j], v[j + w]);
        const float mx = fmaxf(m[r], v[0]);
        if (mx == -INFINITY) continue;  // none of this thread's keys below Tk yet
#pragma unroll
        for (int j = 0; j < NJ; ++j)
          v[j] = stk::exp2_ftz(s[4 * j + 2 * r] - mx) + stk::exp2_ftz(s[4 * j + 2 * r + 1] - mx);
#pragma unroll
        for (int w = NJ / 2; w > 0; w /= 2)
#pragma unroll
          for (int j = 0; j < w; ++j) v[j] += v[j + w];
        l[r] = l[r] * stk::exp2_ftz(m[r] - mx) + v[0];
        m[r] = mx;
      }
    }
    // the four threads of a row (a quad) combine; the row max is finite (Tk >= 1)
    float inv_l[2];
#pragma unroll
    for (int r = 0; r < 2; ++r) {
      float mx = fmaxf(m[r], __shfl_xor_sync(0xffffffffu, m[r], 1));
      mx = fmaxf(mx, __shfl_xor_sync(0xffffffffu, mx, 2));
      float part = m[r] == -INFINITY ? 0.0f : l[r] * stk::exp2_ftz(m[r] - mx);
      part += __shfl_xor_sync(0xffffffffu, part, 1);
      part += __shfl_xor_sync(0xffffffffu, part, 2);
      m[r] = mx;
      inv_l[r] = 1.0f / part;
    }

    // pass 2: p = exp2(s - max) / sum rounded to bf16, repacked from the S
    // accumulators straight into wgmma's A fragments (key step kk = column
    // groups 2kk and 2kk + 1), O += P.V with V the MN-major B operand. A
    // tile's P.V products run on beside the next tile's S products; the wait
    // for both completes the last tile's stage, which is then released.
    for (int tile = 0; tile < n_tiles; ++tile) {
      const int step = n_tiles + tile;
      issue_s(step);
      finish_s(step);
      fence_p(pa);  // the last P.V read them
      if (tile > 0) release(step - 1);
#pragma unroll
      for (int kk = 0; kk < BKT / 16; ++kk)
#pragma unroll
        for (int hh = 0; hh < 2; ++hh) {
          const float* c = s + 4 * (2 * kk + hh);
          pa[kk][2 * hh] = stk::pack_bf16(stk::exp2_ftz(c[0] - m[0]) * inv_l[0],
                                          stk::exp2_ftz(c[1] - m[0]) * inv_l[0]);
          pa[kk][2 * hh + 1] = stk::pack_bf16(stk::exp2_ftz(c[2] - m[1]) * inv_l[1],
                                              stk::exp2_ftz(c[3] - m[1]) * inv_l[1]);
        }
      const uint32_t v_addr = stk::smem_u32(sm.v[step % NS]);
      stk::wgmma_fence();
#pragma unroll
      for (int kk = 0; kk < BKT / 16; ++kk)
#pragma unroll
        for (int p = 0; p < NP; ++p)
          stk::Wgmma<DH>::template rs<1>(
              o[p], pa[kk], stk::desc_sw128(v_addr + p * BKT * DH * 2 + kk * 16 * DH * 2),
              tile > 0 || kk > 0);
      stk::wgmma_commit();
    }
    stk::wgmma_wait<0>();
#pragma unroll
    for (int p = 0; p < NP; ++p) stk::fence_regs(o[p]);
    fence_p(pa);

    // O -> bf16 through this warpgroup's Q tile (its last reader, the last
    // S product, has completed), each warp its own 16 rows of each panel,
    // then 16-byte stores of whole rows, the columns below DK
    const int r0 = 16 * warp;
#pragma unroll
    for (int p = 0; p < NP; ++p) {
      bf16* stage = sm.q[wg][p];
#pragma unroll
      for (int j = 0; j < 8; ++j) {
        *reinterpret_cast<uint32_t*>(stage + stk::swz<DH>(r0 + g, j) + 2 * t) =
            stk::pack_bf16(o[p][4 * j], o[p][4 * j + 1]);
        *reinterpret_cast<uint32_t*>(stage + stk::swz<DH>(r0 + g + 8, j) + 2 * t) =
            stk::pack_bf16(o[p][4 * j + 2], o[p][4 * j + 3]);
      }
    }
    __syncwarp();
    const size_t rs = (size_t)H * DK;
    bf16* ob = out + (size_t)b * Tq * rs + (size_t)h * DK;
#pragma unroll
    for (int p = 0; p < NP; ++p)
#pragma unroll
      for (int it = 0; it < 4; ++it) {
        const int c = lane + 32 * it, r = r0 + (c >> 3), ch = c & 7, qi = q0 + 64 * wg + r;
        if (qi < Tq && (DK % DH == 0 || DH * p + ch * 8 < DK))
          *reinterpret_cast<uint4*>(ob + (size_t)qi * rs + DH * p + ch * 8) =
              *reinterpret_cast<const uint4*>(sm.q[wg][p] + stk::swz<DH>(r, ch));
      }
  }
}

// one TMA map over [B, T, H, Dh] as (Dh, H, T, B), box (64, 1, rows, 1):
// a box never crosses a batch row, and rows past T and columns past Dh read
// as zeros
int encode_bthd(CUtensorMap* map, const void* base, int B, int T, int H, int rows, int dh) {
  const cuuint64_t dims[4] = {(cuuint64_t)dh, (cuuint64_t)H, (cuuint64_t)T, (cuuint64_t)B};
  const cuuint64_t strides[3] = {(cuuint64_t)dh * 2, (cuuint64_t)H * dh * 2,
                                 (cuuint64_t)T * H * dh * 2};
  const cuuint32_t box[4] = {DH, 1, (cuuint32_t)rows, 1};
  return stk::encode_tma(map, base, 4, dims, strides, box);
}

template <int NC, int BKT, int NS, int BPS, int DK>
int launch_wgmma(const bf16* q, const bf16* k, const bf16* v, const float* mask, bf16* out,
                 int B, int Tq, int Tk, int H, float scale_log2, cudaStream_t st) {
  // encoded at every launch: a graph capture keeps this launch's maps
  CUtensorMap tq, tk, tv;
  if (int err = encode_bthd(&tq, q, B, Tq, H, 64, DK)) return err;
  if (int err = encode_bthd(&tk, k, B, Tk, H, BKT, DK)) return err;
  if (int err = encode_bthd(&tv, v, B, Tk, H, BKT, DK)) return err;
  constexpr size_t smem = sizeof(AttnSmem<NC, BKT, NS, (DK + DH - 1) / DH>) + 1024;
  static_assert(smem * BPS <= 232448, "the blocks' shared memory");
  auto kernel = attn_wgmma<NC, BKT, NS, BPS, DK>;
  static size_t configured[stk::kMaxDevices] = {};
  if (int err = stk::allow_dynamic_smem(kernel, smem, configured)) return err;
  static int regs_at_entry = 0;
  if (int err = stk::check_reg_split(kernel, 128, NC * 128, stk::consumer_regs(NC, BPS),
                                     regs_at_entry))
    return err;
  dim3 grid((Tq + 64 * NC - 1) / (64 * NC), H, B);
  kernel<<<grid, (NC + 1) * 128, smem, st>>>(tq, tk, tv, mask, out, Tq, Tk, H, scale_log2);
  return (int)cudaGetLastError();
}

template <int DK>
int launch_bf16(const void* q, const void* k, const void* v, const float* mask, void* out,
                int B, int Tq, int Tk, int H, float scale, cudaStream_t st) {
  constexpr int NP = (DK + DH - 1) / DH;
  return launch_wgmma<CONSUMERS, STAGE_KEYS, stages_of<NP>(), blocks_of<NP>(), DK>(
      (const bf16*)q, (const bf16*)k, (const bf16*)v, mask, (bf16*)out, B, Tq, Tk, H,
      scale * LOG2E, st);
}

template <typename T>
int launch_wide(const void* q, const void* k, const void* v, const float* mask, void* out,
                int B, int Tq, int Tk, int H, int D, float scale, cudaStream_t st) {
  const long long slices = H * (long long)((D + WIDE_DS - 1) / WIDE_DS);
  if (slices > 65535) return (int)cudaErrorInvalidValue;
  dim3 grid((Tq + BQ - 1) / BQ, (unsigned)slices, B);
  attn_wide<T><<<grid, NW * 32, 0, st>>>((const T*)q, (const T*)k, (const T*)v, mask, (T*)out,
                                          Tq, Tk, H, D, scale);
  return (int)cudaGetLastError();
}

// D: the tensors' head width (bf16 up to MAX_DK: a multiple of 16)
int launch(const void* q, const void* k, const void* v, const float* mask, void* out,
           int B, int Tq, int Tk, int H, int D, int dtype, float scale, cudaStream_t st) {
  if (D < 1 || Tk < 1) return (int)cudaErrorInvalidValue;
  if (dtype == 1) {
    if (D > MAX_DK) return launch_wide<bf16>(q, k, v, mask, out, B, Tq, Tk, H, D, scale, st);
    switch (D) {
      case 16: return launch_bf16<16>(q, k, v, mask, out, B, Tq, Tk, H, scale, st);
      case 32: return launch_bf16<32>(q, k, v, mask, out, B, Tq, Tk, H, scale, st);
      case 48: return launch_bf16<48>(q, k, v, mask, out, B, Tq, Tk, H, scale, st);
      case 64: return launch_bf16<64>(q, k, v, mask, out, B, Tq, Tk, H, scale, st);
      case 80: return launch_bf16<80>(q, k, v, mask, out, B, Tq, Tk, H, scale, st);
      case 96: return launch_bf16<96>(q, k, v, mask, out, B, Tq, Tk, H, scale, st);
      case 112: return launch_bf16<112>(q, k, v, mask, out, B, Tq, Tk, H, scale, st);
      case 128: return launch_bf16<128>(q, k, v, mask, out, B, Tq, Tk, H, scale, st);
      case 144: return launch_bf16<144>(q, k, v, mask, out, B, Tq, Tk, H, scale, st);
      case 160: return launch_bf16<160>(q, k, v, mask, out, B, Tq, Tk, H, scale, st);
      case 176: return launch_bf16<176>(q, k, v, mask, out, B, Tq, Tk, H, scale, st);
      case 192: return launch_bf16<192>(q, k, v, mask, out, B, Tq, Tk, H, scale, st);
      case 208: return launch_bf16<208>(q, k, v, mask, out, B, Tq, Tk, H, scale, st);
      case 224: return launch_bf16<224>(q, k, v, mask, out, B, Tq, Tk, H, scale, st);
      case 240: return launch_bf16<240>(q, k, v, mask, out, B, Tq, Tk, H, scale, st);
      case 256: return launch_bf16<256>(q, k, v, mask, out, B, Tq, Tk, H, scale, st);
      default: return (int)cudaErrorInvalidValue;
    }
  }
  if (dtype != 0) return (int)cudaErrorInvalidValue;
  return launch_wide<float>(q, k, v, mask, out, B, Tq, Tk, H, D, scale, st);
}

}  // namespace

// q [B,Tq,H,D], k/v [B,Tk,H,D], out [B,Tq,H,D], contiguous and 16-byte
// aligned, of one storage type (dtype 0 = float, 1 = bfloat16); mask [B,Tk]
// float or null. D >= 1 (in bf16 up to 256 a multiple of 16), Tk >= 1; the
// logits are q.k * scale. scale comes after the stream, so that the earlier
// design's entry (csrc/earlier/), which lacks it (1/sqrt(D), D = 64), takes
// the same call.
extern "C" int stk_attention(const void* q, const void* k, const void* v,
                             const void* mask, void* out, int B, int Tq, int Tk,
                             int H, int D, int dtype, void* stream, float scale) {
  return launch(q, k, v, (const float*)mask, out, B, Tq, Tk, H, D, dtype, scale,
                (cudaStream_t)stream);
}

// the bf16 kernel's tiles: queries a block, keys a ring stage, ring stages,
// blocks an SM
extern "C" int stk_attention_tiles(int* tiles) {
  tiles[0] = 64 * CONSUMERS;
  tiles[1] = STAGE_KEYS;
  tiles[2] = STAGES;
  tiles[3] = BLOCKS_PER_SM;
  return 0;
}
