// Not on the path: the conv kernel's first design (one output tile a block,
// not persistent, the epilogue staged through the ring and windows; bf16 at
// k 3, 5, 7 only, channels in multiples of 8, reach <= 64 frames), which the
// persistent design of csrc/conv1d.cu replaced; kernel_variants.py conv1d
// builds it and times it beside the committed kernel (the package builds
// csrc/*.cu only).
//
// One conv1d of the vocoder or the text encoder's prenet with the
// elementwise ops around it, on x [B, T, Cin] in the JAX layout (NHC, the
// weights HIO [k, Cin, Cout]):
//   s   = silu(x), rounded to the storage type          (silu_in)
//   y   = rnd(sum_{tap, ci} s[t + (tap - (k-1)/2) d][ci] w[tap][ci][n] + bias[n])
//         f32 sums, the f32 bias added before the one rounding, s zero
//         outside [0, T) of each batch row (SAME padding, no copy)
//   y   = rnd(silu(y))                                   (silu_out)
//   y   = rnd(y * mask[t * fold + n / (Cout / fold)])    (mask, 0/1)
//   y   = rnd(residual + y)                              (residual)
//   out = tanh(y) in f32, or y in the storage type       (tanh_f32)
// where rnd rounds to the storage type (nothing in f32). With fold = f the
// output [B, T, Cout] is read as [B, T * f, Cout / f] (the vocoder's
// depth-to-space: a view of the same bytes), so the mask is the fine one.
//
// It replaces the XLA fusions of the JAX package around
// supertonic_tpu/models/layers.py:127-145 (conv1d): the vocoder's pre conv
// and its mask (supertonic_tpu/models/vocoder.py:160-162 of the port's
// file; the JAX apply's `x = L.conv1d(...); x = x * m`), the up convs with
// silu, depth-to-space and mask (:168-173), the head with silu and tanh
// (:175-177), both convs of each _resblock pair (:41-52: conv a with silu
// in and mask, conv b with silu in, mask and residual = x), and the text
// encoder's prenet (supertonic_tpu/models/text_encoder.py:55-56: silu out,
// mask, residual = x). XLA fuses silu into the conv's input and the bias,
// mask and residual into its output; so does this kernel.
//
// Bound on the H100 (3.35 TB/s, 989 TFLOP/s bf16), per b64/5-step batch at
// T = 448: pre 96 -> 512, k 7 over 28,672 rows 0.020 ms; each of the six
// C 512 pre_res convs (k 3) 0.0456 ms; up 1 512 -> 2048, k 5, 0.304 ms; up
// 2 256 -> 1024 over 229,376 rows 0.608 ms; the head 128 -> 32 over
// 1,835,008 rows with an f32 result 0.210 ms (bytes); the prenet 256 ->
// 256, k 5 over 20,480 rows 0.0136 ms each: operations everywhere but the
// head, ~1.44 ms a batch.
//
// bf16 design (conv_wgmma), on Hopper's own instructions: an implicit GEMM
// whose A, the input window, is read by the products straight from shared
// memory at each tap's shifted row. A block is two consumer warpgroups and
// a producer of 1 + SW warps; it owns BM output frames of one batch row
// and NP 64-column panels of the output channels: 128 x 256 (one 64-row M
// tile a consumer, m64n256 products, SW = 3; 128 x 128 at Cout <= 128),
// or at Cout <= 64 (the head) 256 x 64 (two M tiles a consumer, SW = 7);
// at most 128 accumulator registers a consumer (the kernel compiles to
// 168 registers a thread at 384 threads, 128 at 512).
// The input channels go in chunks of KC = 64. The producer's warp 0
// streams the taps' [64 input channels, NP 64 outputs] slices of the
// weights ([k Cin, Cout] row-major) by TMA through a ring of STAGES stages
// behind full/empty mbarriers, one thread running ahead across chunks;
// its other SW warps stage each chunk's window, BM + (k - 1) d frames x 64
// channels, by cp.async (zero-filled outside [0, T) and past Cin: SAME
// padding with no copy) into a ring of up to four buffers, copies running
// NW - 2 chunks ahead of the silu they then apply in place (the fast
// exponential and division, a few f32 ulp before the bf16 rounding, as the
// chain kernel's), and hand each window over on its mbarrier. A window is
// stored without swizzle as 8 columns of 16-byte chunks (8 channels), each
// a column of rows 16 bytes apart: wgmma's plain K-major layout, whose
// 8-row core matrices need no alignment to an 8-row atom, so a matrix
// descriptor can start at any row (the 128-byte swizzle of the weights
// cannot: the chain kernel therefore loads its A by ldmatrix into
// registers; that design, measured slower here, is
// csrc/variants/conv1d_register_a.cu). A consumer runs one stage a tap:
// wgmma m64 x (NP 64) x k16 with A and B from shared memory (B MN-major
// across the stage's panels, the descriptor's LBO their distance), f32
// accumulators, one group of products in flight; a window goes back to the
// staging warps once the products that read it are complete. The K sum
// runs in a fixed order (channel chunk, tap, the product's 16 channels):
// no split of K, so an output is the same whatever tile it lands in
// (windowed vocoding equals whole vocoding, a graph replay equals eager).
// The epilogue adds the f32 bias to the f32 sum, rounds once, takes
// silu_out in the registers and writes the rounded tile into the ring and
// windows (free by then); the 256 consumer threads then store it in
// 16-byte row chunks, reading the mask and the residual in the same
// coalesced chunks, so the next kernel reads [B, T, Cout] (or [B, T f,
// Cout / f]) with no copy.
// Zero padding: a chunk past Cin reads zero activations (the weights it
// meets there belong to the next tap, or are TMA's zero fill past k Cin
// rows); panels past Cout are not loaded and their columns not stored.
// What limits it (kernel_variants.py conv1d --split, from replayed graphs):
// not the products (taking them out saves 13-20% at the b64 shapes), but
// what the block does around them one block an SM: the epilogue, which no
// other block's products overlap (34% of up 2, 49% of the prenet), and the
// window's silu, recomputed for every 256-column tile (at 128 x 128 tiles
// it was 40% of pre_res and 36% of up 1, which 128 x 256 tiles halved).
// Measured slower: 128 x 128 and 256 x 128 tiles, A in registers from
// swizzled windows (csrc/variants/conv1d_register_a.cu), 3 staging warps
// at the head (where the silu, once a frame, sets the pace).
//
// f32 (conv_simt): SIMT, exact f32 FMA (no TF32), 128 frames x 64 output
// channels a block of 256 threads, each 8 frames x 4 channels; each chunk
// of 32 input channels is staged once for all taps, silu applied; the
// weights are read from device memory (L1). The same epilogue.
//
// Domain (ops/conv1d.py supports): Cin and Cout in multiples of 8 (16-byte
// rows), an odd k whose reach (k - 1) d is at most MAX_SPAN = 64 frames
// (the window's slack: k 7 at d 9 reaches 54), bf16 at k 3, 5 or 7 (an
// instance each, the taps unrolled), f32 any odd k. A masked fold takes
// Cout / fold in multiples of 8.
#include <type_traits>

#include "elementwise.cuh"
#include "wgmma.cuh"

namespace {

using bf16 = __nv_bfloat16;

constexpr int MAX_SPAN = 64;

// what every instance does after the sums
struct Epi {
  const float* bias;   // [Cout]
  const float* mask;   // [T * fold] a batch row at b * mstride, or null
  long long mstride;
  const void* res;     // [B, T, Cout] in the storage type, or null
  void* out;           // [B, T, Cout]: the storage type, or f32 with tanh
  int fold, silu_out, tanh_f32;
};

// N consecutive output columns n.. of frame tg in batch row b, their sums
// already biased, rounded and through silu_out, with the mask value `mk`
// and the residual `r` read for them (unread where absent): the mask, the
// residual and the store
template <typename T, int N>
__device__ __forceinline__ void finish(float (&v)[N], const Epi& e, float mk, const float (&r)[N],
                                       int b, int tg, int n, int Tlen, int Cout) {
  const size_t off = ((size_t)b * Tlen + tg) * Cout + n;
  if (e.mask) {
    const float m = stk::rnd<T>(mk);
#pragma unroll
    for (int i = 0; i < N; ++i) v[i] = stk::rnd<T>(__fmul_rn(v[i], m));
  }
  if (e.res) {
#pragma unroll
    for (int i = 0; i < N; ++i) v[i] = stk::rnd<T>(__fadd_rn(r[i], v[i]));
  }
  if (e.tanh_f32) {
#pragma unroll
    for (int i = 0; i < N; ++i) v[i] = tanhf(v[i]);
    stk::store_n<float, N>(static_cast<float*>(e.out) + off, v);
  } else {
    stk::store_n<T, N>(static_cast<T*>(e.out) + off, v);
  }
}

// the mask value of output column n of frame tg in batch row b
__device__ __forceinline__ float mask_at(const Epi& e, int b, int tg, int n, int Cout) {
  return e.mask ? e.mask[b * e.mstride + tg * e.fold + n / (Cout / e.fold)] : 1.0f;
}

// ---------------------------------------------------------------------------
// f32: SIMT
// ---------------------------------------------------------------------------
constexpr int S_THREADS = 256, S_FRAMES = 8, S_CG = 16;  // 16 channel groups of 4
constexpr int S_BM = S_THREADS / S_CG * S_FRAMES;       // 128 frames a block
constexpr int S_BN = 4 * S_CG;                          // 64 channels a block
constexpr int S_KC = 32;                                // input channels a chunk

__global__ void __launch_bounds__(S_THREADS)
conv_simt(const float* __restrict__ x, const float* __restrict__ w, Epi e, int Tlen, int Cin,
          int Cout, int k, int d, int silu_in) {
  __shared__ float rows[(S_BM + MAX_SPAN) * S_KC];
  const int cg = threadIdx.x % S_CG, f0 = threadIdx.x / S_CG * S_FRAMES;
  const int t0 = blockIdx.x * S_BM, n = blockIdx.y * S_BN + 4 * cg, b = blockIdx.z;
  const int span = (k - 1) * d, pad = span / 2, nrows = S_BM + span;
  const float* xb = x + (size_t)b * Tlen * Cin;
  float acc[S_FRAMES][4];
#pragma unroll
  for (int j = 0; j < S_FRAMES; ++j)
#pragma unroll
    for (int i = 0; i < 4; ++i) acc[j][i] = 0.0f;
  for (int c0 = 0; c0 < Cin; c0 += S_KC) {
    __syncthreads();  // the last chunk's rows are read
    for (int i = threadIdx.x; i < nrows * S_KC; i += S_THREADS) {
      const int r = i / S_KC, ci = c0 + i % S_KC, tg = t0 - pad + r;
      float v = 0.0f;
      if (tg >= 0 && tg < Tlen && ci < Cin) {
        v = xb[(size_t)tg * Cin + ci];
        if (silu_in) v = stk::silu_f(v);
      }
      rows[i] = v;
    }
    __syncthreads();
    if (n >= Cout) continue;
    const int kc = min(S_KC, Cin - c0);
    for (int tap = 0; tap < k; ++tap) {
      const float* rt = rows + (f0 + tap * d) * S_KC;
      const float* wt = w + ((size_t)tap * Cin + c0) * Cout + n;
      for (int ci = 0; ci < kc; ++ci) {
        float wv[4];
        stk::load4(wt + (size_t)ci * Cout, wv);
#pragma unroll
        for (int j = 0; j < S_FRAMES; ++j) {
          const float a = rt[j * S_KC + ci];
#pragma unroll
          for (int i = 0; i < 4; ++i) acc[j][i] = fmaf(a, wv[i], acc[j][i]);
        }
      }
    }
  }
  if (n >= Cout) return;
  float bv[4];
  stk::load4(e.bias + n, bv);
#pragma unroll
  for (int j = 0; j < S_FRAMES; ++j) {
    const int tg = t0 + f0 + j;
    if (tg >= Tlen) break;
    float v[4], r[4];
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      v[i] = acc[j][i] + bv[i];
      if (e.silu_out) v[i] = stk::silu_f(v[i]);
    }
    if (e.res) stk::load_n<float, 4>(static_cast<const float*>(e.res) +
                                         ((size_t)b * Tlen + tg) * Cout + n, r);
    finish<float, 4>(v, e, mask_at(e, b, tg, n, Cout), r, b, tg, n, Tlen, Cout);
  }
}

// ---------------------------------------------------------------------------
// bf16 on the tensor cores
// ---------------------------------------------------------------------------
constexpr int KC = 64;                   // input channels a chunk (B rows a stage)
constexpr int NCONS = 2;                 // consumer warpgroups
constexpr int CONSUMERS = NCONS * 128;
constexpr int STAGES = 4;
constexpr int PANEL = KC * 128;          // bytes of a stage's 64-column panel

// K-major operand in shared memory without swizzle: 8-row core matrices of
// 16-byte rows, `sbo` bytes between 8-row groups, `lbo` bytes between the
// two 8-element halves of a k16 step; any 16-byte-aligned start address,
// so a descriptor may begin at any row
__device__ __forceinline__ uint64_t desc_plain(uint32_t addr, uint32_t lbo, uint32_t sbo) {
  return (uint64_t)((addr & 0x3FFFF) >> 4) | ((uint64_t)((lbo & 0x3FFFF) >> 4) << 16) |
         ((uint64_t)((sbo & 0x3FFFF) >> 4) << 32);
}

// NP 64-column panels of the output a block, MT 64-row M tiles a consumer
// (MT NP 32 accumulator registers a consumer), SW staging warps beside the
// weights' warp: 2 consumer warpgroups + 32 (SW + 1) threads, one block an
// SM (at 384 threads 168 registers a thread, at 512 128)
template <int NP, int MT, int SW>
struct Layout {
  static constexpr int STAGERS = 32 * SW;
  static constexpr int THREADS = CONSUMERS + 32 + STAGERS;
  static constexpr int ITER = 64 * MT * NCONS * NP * 8 / CONSUMERS;  // a thread's store chunks
  static constexpr int BM = 64 * MT * NCONS;        // output frames a block
  static constexpr int WROWS = BM + MAX_SPAN;       // window rows a buffer
  // a window is 8 columns of 16-byte chunks (8 channels), each WROWS rows
  // of 16 bytes, CS bytes apart: one chunk more than the rows, so the 8
  // chunks of a row fall in 8 distinct bank groups
  static constexpr int CS = (WROWS + 1) * 16;
  static constexpr size_t WIN = (size_t)8 * CS;     // bytes of a window buffer
  static constexpr int STAGE = NP * PANEL;
  static constexpr int TS = NP * 64 + 8;            // the epilogue tile's row, padded
  // window buffers: as many as fit beside the ring, up to 4
  static constexpr int NW =
      (232448 - 2048 - (size_t)STAGES * STAGE) / WIN < 4
          ? (int)((232448 - 2048 - (size_t)STAGES * STAGE) / WIN) : 4;
  // slack for the 1024-byte alignment | ring | windows | barriers: full,
  // empty (the ring), window full, window empty
  static constexpr size_t BYTES =
      1024 + (size_t)STAGES * STAGE + NW * WIN + 8 * (2 * STAGES + 2 * NW);
  static_assert(NW >= 3 && BYTES <= 232448, "shared memory");
  static_assert((size_t)BM * TS * 2 <= (size_t)STAGES * STAGE + NW * WIN,
                "the epilogue tile in the ring and windows");
};

template <int NP, int MT, int SW, int KT>
__global__ void __launch_bounds__(Layout<NP, MT, SW>::THREADS, 1)
conv_wgmma(__grid_constant__ const CUtensorMap tm_w, const bf16* __restrict__ x, Epi e, int Tlen,
           int Cin, int Cout, int d, int silu_in) {
  using L = Layout<NP, MT, SW>;
  constexpr int STAGERS = L::STAGERS;
  constexpr int BM = L::BM, NW = L::NW, CS = L::CS;
  extern __shared__ __align__(1024) unsigned char raw[];
  uint8_t* ring = raw + ((1024 - (stk::smem_u32(raw) & 1023)) & 1023);
  uint8_t* win = ring + STAGES * L::STAGE;  // NW windows of L::WIN bytes
  uint64_t* full = reinterpret_cast<uint64_t*>(win + NW * L::WIN);
  uint64_t* empty = full + STAGES;
  uint64_t* wfull = empty + STAGES;  // [NW]: a window staged
  uint64_t* wempty = wfull + NW;     // [NW]: a window read
  const int wg = threadIdx.x / 128, warp = (threadIdx.x / 32) & 3, lane = threadIdx.x & 31;
  const int t0 = blockIdx.x * BM, n0 = blockIdx.y * NP * 64, b = blockIdx.z;
  const int nch = (Cin + KC - 1) / KC, steps = nch * KT;
  const int span = (KT - 1) * d, pad = span / 2, nrows = BM + span;
  if (threadIdx.x == 0) {
#pragma unroll
    for (int s = 0; s < STAGES; ++s) {
      stk::mbar_init(&full[s], 1);
      stk::mbar_init(&empty[s], 4 * NCONS);  // every consumer warp
    }
#pragma unroll
    for (int i = 0; i < NW; ++i) {
      stk::mbar_init(&wfull[i], STAGERS / 32);  // every staging warp
      stk::mbar_init(&wempty[i], 4 * NCONS);
    }
    stk::mbar_fence_init();
  }
  __syncthreads();

  if (threadIdx.x >= CONSUMERS) {
    if (threadIdx.x < CONSUMERS + 32) {
      // one thread streams stage s = rows [tap Cin + c KC, + KC) of the
      // [k Cin, Cout] weights, c = s / KT, tap = s % KT; only the panels
      // that hold output channels
      if (lane == 0) {
        const int panels = min(NP, (Cout - n0 + 63) / 64);
        for (int s = 0; s < steps; ++s) {
          const int st = s % STAGES;
          stk::mbar_wait(&empty[st], ((s / STAGES) & 1) ^ 1);
          stk::mbar_arrive_tx(&full[st], panels * PANEL);
          const int row = (s % KT) * Cin + (s / KT) * KC;
          for (int p = 0; p < panels; ++p)
            stk::tma_load_2d(ring + st * L::STAGE + p * PANEL, &tm_w, &full[st], n0 + 64 * p,
                             row);
        }
      }
      return;
    }
    // the other SW warps stage chunk c's window into buffer c % NW: row r = frame t0 -
    // pad + r at r * 16 bytes of column ch = channels c KC + 8 ch, zero
    // outside [0, T) and past Cin, by cp.async, AHEAD chunks ahead of the
    // one they finish: silu in place over the same chunks, then the
    // hand-over. A buffer comes back once the products that read it are
    // complete, which the consumers see one chunk later: AHEAD = NW - 2.
    constexpr int AHEAD = NW - 2;
    const int st_id = threadIdx.x - CONSUMERS - 32;
    const bf16* xb = x + (size_t)b * Tlen * Cin;
    auto at = [&](int c, int el) {  // shared address of element el of chunk c's window
      return (uint32_t)((c % NW) * L::WIN + (el & 7) * CS + (el >> 3) * 16);
    };
    const uint32_t win_u32 = stk::smem_u32(win);
    auto issue = [&](int c) {
      if (c >= nch) return;
      stk::mbar_wait(&wempty[c % NW], ((c / NW) & 1) ^ 1);
      for (int el = st_id; el < nrows * 8; el += STAGERS) {
        const int tg = t0 - pad + (el >> 3), ci = c * KC + (el & 7) * 8;
        const bool valid = tg >= 0 && tg < Tlen && ci < Cin;
        stk::cp_async16(win_u32 + at(c, el), valid ? xb + (size_t)tg * Cin + ci : xb, valid);
      }
      stk::cp_async_commit();
    };
#pragma unroll
    for (int c = 0; c < AHEAD; ++c) issue(c);
    for (int c = 0; c < nch; ++c) {
      issue(c + AHEAD);
      // chunk c's copies complete: every group but the AHEAD newest, or all
      if (c + AHEAD < nch) {
        stk::cp_async_wait<AHEAD>();
      } else {
        stk::cp_async_wait<0>();
      }
      if (silu_in) {
#pragma unroll 4
        for (int el = st_id; el < nrows * 8; el += STAGERS) {
          uint4* q = reinterpret_cast<uint4*>(win + at(c, el));
          uint4 v = *q;
          uint32_t* pr = reinterpret_cast<uint32_t*>(&v);
#pragma unroll
          for (int j = 0; j < 4; ++j) {
            const float2 f = __bfloat1622float2(*reinterpret_cast<__nv_bfloat162*>(&pr[j]));
            pr[j] = stk::pack_bf16(stk::silu_fast(f.x), stk::silu_fast(f.y));
          }
          *q = v;
        }
      }
      // the window's generic writes, visible to the products' async reads
      stk::fence_proxy_async();
      __syncwarp();
      if (lane == 0) stk::mbar_arrive(&wfull[c % NW]);
    }
    return;
  }

  float acc[MT][NP * 32];
  auto release = [&](uint64_t* bar) {
    __syncwarp();
    if (lane == 0) stk::mbar_arrive(bar);
  };
  const uint32_t ring_u32 = stk::smem_u32(ring), win_u32 = stk::smem_u32(win);
  int step = 0;
  for (int c = 0; c < nch; ++c) {
    const int buf = c % NW;
    stk::mbar_wait(&wfull[buf], (c / NW) & 1);
    // A of M tile i at tap `tap`: rows (wg MT + i) 64 + tap d of the window
    const uint32_t wb = win_u32 + buf * (uint32_t)L::WIN;
#pragma unroll
    for (int tap = 0; tap < KT; ++tap) {
      // one stage a tap: m64 x (NP 64) x k16 products, A and B from shared
      // memory; the previous stage's are complete on return (its stage
      // released, and at a chunk's first tap the previous chunk's window)
      const int st = step % STAGES;
      stk::mbar_wait(&full[st], (step / STAGES) & 1);
      const uint32_t base = ring_u32 + st * L::STAGE;
      stk::wgmma_fence();
#pragma unroll
      for (int kk = 0; kk < 4; ++kk)
#pragma unroll
        for (int i = 0; i < MT; ++i)
          stk::Wgmma<NP * 64>::template ss<1>(
              acc[i], desc_plain(wb + 2 * kk * CS + ((wg * MT + i) * 64 + tap * d) * 16, CS, 128),
              stk::desc_sw128_mn(base + kk * 2048, PANEL), c > 0 || tap > 0 || kk > 0);
      stk::wgmma_commit();
      stk::wgmma_wait<1>();
      if (step > 0) release(&empty[(step - 1) % STAGES]);
      if (tap == 0 && c > 0) release(&wempty[(c - 1) % NW]);
      ++step;
    }
  }
  stk::wgmma_wait<0>();
  release(&empty[(step - 1) % STAGES]);
#pragma unroll
  for (int i = 0; i < MT; ++i) stk::fence_regs(acc[i]);
  // every product of both consumers is complete: the ring and the windows
  // take the epilogue tile
  stk::named_bar_sync(1, CONSUMERS);

  // the biased, rounded tile (and silu_out) into shared memory: rows g, g + 8
  // of the warp's 16, columns 2t, 2t + 1 of each n8 group
  bf16* tile = reinterpret_cast<bf16*>(ring);
  const int g = lane >> 2, t = lane & 3;
#pragma unroll
  for (int j = 0; j < NP * 8; ++j) {
    const int col = j * 8 + 2 * t, n = n0 + col;
    const float b0 = n < Cout ? e.bias[n] : 0.0f, b1 = n < Cout ? e.bias[n + 1] : 0.0f;
#pragma unroll
    for (int i = 0; i < MT; ++i)
#pragma unroll
      for (int h = 0; h < 2; ++h) {
        const int row = (wg * MT + i) * 64 + 16 * warp + g + 8 * h;
        float v0 = stk::rnd<bf16>(__fadd_rn(acc[i][4 * j + 2 * h], b0));
        float v1 = stk::rnd<bf16>(__fadd_rn(acc[i][4 * j + 2 * h + 1], b1));
        if (e.silu_out) {
          v0 = stk::silu_fast(v0);
          v1 = stk::silu_fast(v1);
        }
        *reinterpret_cast<uint32_t*>(tile + row * L::TS + col) = stk::pack_bf16(v0, v1);
      }
  }
  stk::named_bar_sync(1, CONSUMERS);
  // the tile in 16-byte row chunks: this thread's masks and residuals are
  // all loaded before any is used (one wait on device memory, not ITER),
  // then mask, residual, store
  const int tid = threadIdx.x;
  float mk[L::ITER];
  uint4 res[L::ITER];
#pragma unroll
  for (int i = 0; i < L::ITER; ++i) {
    const int el = tid + CONSUMERS * i, row = el / (NP * 8), cc = el % (NP * 8);
    const int tg = t0 + row, n = n0 + cc * 8;
    const bool in = tg < Tlen && n < Cout;
    mk[i] = in ? mask_at(e, b, tg, n, Cout) : 1.0f;
    res[i] = in && e.res ? *reinterpret_cast<const uint4*>(
                               static_cast<const bf16*>(e.res) + ((size_t)b * Tlen + tg) * Cout + n)
                         : make_uint4(0, 0, 0, 0);
  }
#pragma unroll
  for (int i = 0; i < L::ITER; ++i) {
    const int el = tid + CONSUMERS * i, row = el / (NP * 8), cc = el % (NP * 8);
    const int tg = t0 + row, n = n0 + cc * 8;
    if (tg >= Tlen || n >= Cout) continue;
    float v[8], r[8];
    stk::load_n<bf16, 8>(tile + row * L::TS + cc * 8, v);
    stk::load_n<bf16, 8>(reinterpret_cast<const bf16*>(&res[i]), r);
    finish<bf16, 8>(v, e, mk[i], r, b, tg, n, Tlen, Cout);
  }
}

// ---------------------------------------------------------------------------
// launch
// ---------------------------------------------------------------------------

template <int NP, int MT, int SW, int KT>
int launch_wgmma(const bf16* x, const bf16* w, const Epi& e, int B, int Tlen, int Cin, int Cout,
                 int d, int silu_in, cudaStream_t st) {
  using L = Layout<NP, MT, SW>;
  // the weights [k Cin, Cout], boxes of 64 rows x 64 columns; encoded at
  // every launch: a graph capture keeps this launch's map
  CUtensorMap tm;
  const cuuint64_t dims[2] = {(cuuint64_t)Cout, (cuuint64_t)KT * Cin};
  const cuuint64_t strides[1] = {(cuuint64_t)Cout * sizeof(bf16)};
  const cuuint32_t box[2] = {64, (cuuint32_t)KC};
  if (int err = stk::encode_tma(&tm, w, 2, dims, strides, box)) return err;
  auto kernel = conv_wgmma<NP, MT, SW, KT>;
  static size_t configured[stk::kMaxDevices] = {};
  if (int err = stk::allow_dynamic_smem(kernel, L::BYTES, configured)) return err;
  dim3 grid((Tlen + L::BM - 1) / L::BM, (Cout + NP * 64 - 1) / (NP * 64), B);
  kernel<<<grid, L::THREADS, L::BYTES, st>>>(tm, x, e, Tlen, Cin, Cout, d, silu_in);
  return (int)cudaGetLastError();
}

// 128 x 256 tiles (one M tile a consumer, m64n256 products), 3 staging
// warps; at Cout <= 128 128 x 128 (no product on columns past Cout); at
// Cout <= 64 (the head: one 64-column panel) 256 x 64 tiles and 7 staging
// warps (the window's silu, once a frame there, sets the pace)
template <int KT>
int launch_bf16(const bf16* x, const bf16* w, const Epi& e, int B, int Tlen, int Cin, int Cout,
                int d, int silu_in, cudaStream_t st) {
  if (Cout <= 64) return launch_wgmma<1, 2, 7, KT>(x, w, e, B, Tlen, Cin, Cout, d, silu_in, st);
  if (Cout <= 128) return launch_wgmma<2, 1, 3, KT>(x, w, e, B, Tlen, Cin, Cout, d, silu_in, st);
  return launch_wgmma<4, 1, 3, KT>(x, w, e, B, Tlen, Cin, Cout, d, silu_in, st);
}

}  // namespace

// x [B, T, Cin], w [k, Cin, Cout] (HIO), residual and out [B, T, Cout], all
// contiguous and 16-byte aligned, in the storage type (dtype 0 = f32, 1 =
// bf16; out f32 with tanh_f32); bias [Cout] f32; mask f32 [T * fold], a
// batch row at b * mstride (0: one row for all), or null; residual or null.
extern "C" int stk_conv1d(const void* x, const void* w, const void* bias, const void* mask,
                          long long mstride, const void* res, void* out, int B, int Tlen, int Cin,
                          int Cout, int k, int d, int silu_in, int silu_out, int fold,
                          int tanh_f32, int dtype, void* stream) {
  if (B < 1 || Tlen < 1 || Cin < 8 || Cin % 8 || Cout < 8 || Cout % 8 || k < 1 || k % 2 == 0 ||
      d < 1 || (k - 1) * d > MAX_SPAN || fold < 1 || Cout % fold || mstride < 0 ||
      (mask && (Cout / fold) % 8))
    return (int)cudaErrorInvalidValue;
  cudaStream_t st = (cudaStream_t)stream;
  const Epi e = {static_cast<const float*>(bias), static_cast<const float*>(mask), mstride, res,
                 out, fold, silu_out, tanh_f32};
  if (dtype == 0) {
    dim3 grid((Tlen + S_BM - 1) / S_BM, (Cout + S_BN - 1) / S_BN, B);
    conv_simt<<<grid, S_THREADS, 0, st>>>(static_cast<const float*>(x),
                                          static_cast<const float*>(w), e, Tlen, Cin, Cout, k,
                                          d, silu_in);
    return (int)cudaGetLastError();
  }
  if (dtype != 1) return (int)cudaErrorInvalidValue;
  const bf16* xb = static_cast<const bf16*>(x);
  const bf16* wb = static_cast<const bf16*>(w);
  if (k == 3) return launch_bf16<3>(xb, wb, e, B, Tlen, Cin, Cout, d, silu_in, st);
  if (k == 5) return launch_bf16<5>(xb, wb, e, B, Tlen, Cin, Cout, d, silu_in, st);
  if (k == 7) return launch_bf16<7>(xb, wb, e, B, Tlen, Cin, Cout, d, silu_in, st);
  return (int)cudaErrorInvalidValue;
}
