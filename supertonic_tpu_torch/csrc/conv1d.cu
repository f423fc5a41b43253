// One conv1d of the vocoder or the text encoder's prenet with the
// elementwise ops around it, on x [B, T, Cin] in the JAX layout (NHC, the
// weights HIO [k, Cin, Cout]):
//   s   = silu(x), rounded to the storage type          (silu_in)
//   y   = rnd(sum_{tap, ci} s[t - pad + tap d][ci] w[tap][ci][n] + bias[n])
//         f32 sums, the f32 bias added before the one rounding, s zero
//         outside [0, T) of each batch row (SAME padding with pad = (k - 1)
//         d / 2 frames on the left and the rest on the right, as JAX pads an
//         even size; no copy)
//   y   = rnd(silu(y))                                   (silu_out)
//   y   = rnd(y * mask[t * fold + n / (Cout / fold)])    (mask, 0/1)
//   y   = rnd(residual + y)                              (residual)
//   out = tanh(y) in f32, or y in the storage type       (tanh_f32)
//   out = int16(clamp(tanh(y) * 32767, -32768, 32767))    (int16, with tanh_f32)
// where rnd rounds to the storage type (nothing in f32). The int16 form is
// the engine's int16 egress (supertonic_tpu/engine/synthesis.py:228-229,
// :321-322) of the vocoder head's samples: the product an IEEE multiply
// (__fmul_rn), the cast truncating toward zero, as torch's .to(int16). With fold = f the
// output [B, T, Cout] is read as [B, T * f, Cout / f] (the vocoder's
// depth-to-space: a view of the same bytes), so the mask is the fine one.
//
// It replaces the XLA fusions of the JAX package around
// supertonic_tpu/models/layers.py:127-145 (conv1d): the vocoder's pre conv
// and its mask, the up convs with silu, depth-to-space and mask, the head
// with silu and tanh, both convs of each _resblock pair (conv a with silu
// in, silu out and mask, so that conv b reads silu(h) as it is: its mask
// and residual = x), and the text encoder's prenet
// (supertonic_tpu/models/text_encoder.py:55-56: silu out, mask, residual =
// x). XLA fuses silu into the conv's input and the bias, mask and residual
// into its output; so does this kernel.
//
// Domain: any Cin, Cout, k, dilation and masked fold, in f32 and bf16.
// bf16 weights come in rows of Cout rounded up to 8 elements (16 bytes, a
// TMA map's row; ops/conv1d.py pads them); the taps go in groups whose
// reach (taps - 1) d is at most MAX_SPAN frames, each group's window staged
// at its own origin and summed into the same f32 accumulators before the
// one rounding.
//
// Bound on the H100 (3.35 TB/s, 989 TFLOP/s bf16), per b64/5-step batch at
// T = 448: pre 96 -> 512, k 7 over 28,672 rows 0.020 ms; each of the six
// C 512 pre_res convs (k 3) 0.0456 ms; up 1 512 -> 2048, k 5, 0.304 ms; up
// 2 256 -> 1024 over 229,376 rows 0.608 ms; the head 128 -> 32 over
// 1,835,008 rows with an f32 result 0.210 ms (bytes); the prenet 256 ->
// 256, k 5 over 20,480 rows 0.0136 ms each: operations everywhere but the
// head, ~1.44 ms a batch.
//
// bf16 design (conv_wgmma): a persistent, warp-specialised implicit GEMM
// whose A, the input window, is read by the products straight from shared
// memory at each tap's shifted row. One block an SM walks a static list of
// tiles of output frames of one batch row x BN output channels (BN = 128,
// or 64 at Cout <= 64), the column tiles of one time tile back to back. A
// block is two consumer warpgroups and a producer side of 1 + SW warps
// (setmaxnreg: the producer side keeps PREGS registers, the consumers take
// the rest):
//  - the consumers either own whole 128-frame tiles, taking turns (turn
//    barriers keep their mainloops in ring order, as the FFN's GEMM
//    template does, csrc/wgmma_gemm.cuh), so that one consumer's epilogue
//    runs beside the other's products; or, in the cooperative instances
//    (the head, the prenet, and the masked convs whose 256-frame windows
//    stay for all their column tiles: up 2), share 256-frame tiles, 128
//    rows each, one weight stage feeding both (half the weights' reads
//    from L2), the two epilogues beside the next tile's loads. A
//    consumer's products run m64 x BN x k16,
//    two 64-row M tiles, A and B from shared memory, f32 accumulators, one
//    group in flight. Its epilogue runs from the registers: the bias of its
//    columns and the mask of its rows are loaded into registers before the
//    products (loads in the epilogue would wait behind the memory traffic
//    the products keep up), each row's residual pairs are loaded together,
//    then bias, one rounding, silu_out, mask, residual, tanh, and 4-byte
//    stores of column pairs. Each instance is compiled for the options of
//    its calls (E_*; measured several times faster than one epilogue that
//    reads its options at run time), with one instance for every other
//    call;
//  - the producer's warp 0 streams the taps' [64 input channels, BN
//    outputs] slices of the weights ([k Cin, Cout] row-major) by TMA
//    through a ring of STAGES stages behind full/empty mbarriers, one
//    thread running ahead across tiles;
//  - its other SW warps stage the windows: one unit is a tap group's
//    tile frames + reach x 64 input channels, copied by cp.async (zero
//    outside [0, T) and past Cin; 8 scalar loads a 16-byte chunk where Cin
//    is no multiple of 8), then silu'd in place (the fast exponential and
//    division, a few f32 ulp before the bf16 rounding, as the chain
//    kernel's) and handed over on its mbarrier. The units go through
//    NWB buffers, as many as the shared memory beside the ring holds (at
//    most NWB_MAX). Where all of a time tile's units fit (up 1: 8 units,
//    pre_res: 8, up 2: 4), they stay for all its column tiles: one staging
//    and one silu an element, however many column tiles read it (the
//    earlier design silu'd a window once per column tile: 8x at up 1); the
//    last column tile hands each unit back once its products are complete.
//    Else each tile stages its own.
// A window is stored without swizzle as 8 columns of 16-byte chunks (8
// channels), each a column of rows 16 bytes apart, one chunk more than
// the rows between columns (the 8 chunks of a row in 8 bank groups):
// wgmma's plain K-major layout, whose descriptor may start at any row.
// The K sum runs in a fixed order (tap group, channel chunk, tap, the
// product's 16 channels): no split of K and no stream-K, so an output is the
// same whatever tile it lands in (windowed vocoding equals whole vocoding,
// a graph replay equals eager).
// Shared memory (232,448 bytes a block): 1,024 of alignment slack; the ring,
// STAGES x BN / 64 x 8 KB (64 KB at BN = 128, 32 KB at BN = 64); 336 bytes
// of barriers (full and empty a stage, two turns, full and empty a window
// buffer); the rest, 165,552 (or 198,320) bytes, holds the window buffers
// of 8 (frames + reach + 1) x 16 bytes each: at 128 frames 16,768 at reach 2
// (9 buffers at BN = 128), 18,816 at reach 18 (8). No epilogue buffer: the
// epilogue stores from the registers, so the next tile's weights and
// windows load while it runs.
// Zero padding: a chunk past Cin reads zero activations (the weights it
// meets there belong to the next tap, or are TMA's zero fill past k Cin
// rows); panels past Cout are not loaded and their columns not stored.
// What limits it (kernel_variants.py conv1d --split, from replayed graphs):
// at up 1, in turns, the products' loop (taking the products out saves 22%,
// the epilogue 3%), fed one weight stage from L2 for every 128 x 128 tile;
// at up 2, cooperative, the products and the stores the shared tiles leave
// exposed (taking them out saves 30% and 24%).
//
// f32 (conv_simt): SIMT, exact f32 FMA (no TF32), 128 frames x 64 output
// channels a block of 256 threads, each 8 frames x 4 channels; each chunk
// of 32 input channels of a tap group is staged once for its taps, silu
// applied; the weights are read from device memory (L1). The same epilogue,
// element by element where Cout is no multiple of 4.
#include <algorithm>

#include "elementwise.cuh"
#include "wgmma.cuh"

namespace {

using bf16 = __nv_bfloat16;

constexpr int MAX_SPAN = 64;  // the most frames a tap group's window reaches past its tile

// taps a group: all k where the reach (k - 1) d fits in MAX_SPAN, else as
// many as fit (one at d > MAX_SPAN)
__host__ __device__ inline int group_taps(int k, int d) {
  return d > MAX_SPAN ? 1 : (k < MAX_SPAN / d + 1 ? k : MAX_SPAN / d + 1);
}

// what every instance does after the sums
struct Epi {
  const float* bias;   // [Cout]
  const float* mask;   // [T * fold] a batch row at b * mstride, or null
  long long mstride;
  const void* res;     // [B, T, Cout] in the storage type, or null
  void* out;           // [B, T, Cout]: the storage type, or f32 with tanh, or int16
  int fold, silu_out, tanh_f32, int16;
};

// tanh(y) as the int16 egress sample: clamp(t * 32767, -32768, 32767)
// truncated toward zero
__device__ __forceinline__ uint16_t egress_i16(float t) {
  const float v = fminf(fmaxf(__fmul_rn(t, 32767.0f), -32768.0f), 32767.0f);
  return (uint16_t)(int16_t)__float2int_rz(v);
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
  const int pad = (k - 1) * d / 2, G = group_taps(k, d);
  const bool vec = Cout % 4 == 0;
  const float* xb = x + (size_t)b * Tlen * Cin;
  float acc[S_FRAMES][4];
#pragma unroll
  for (int j = 0; j < S_FRAMES; ++j)
#pragma unroll
    for (int i = 0; i < 4; ++i) acc[j][i] = 0.0f;
  for (int g0 = 0; g0 < k; g0 += G) {
    const int taps = min(G, k - g0), nrows = S_BM + (taps - 1) * d;
    const int origin = t0 - pad + g0 * d;  // the group's first window frame
    for (int c0 = 0; c0 < Cin; c0 += S_KC) {
      __syncthreads();  // the last chunk's rows are read
      for (int i = threadIdx.x; i < nrows * S_KC; i += S_THREADS) {
        const int r = i / S_KC, ci = c0 + i % S_KC, tg = origin + r;
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
      for (int tp = 0; tp < taps; ++tp) {
        const float* rt = rows + (f0 + tp * d) * S_KC;
        const float* wt = w + ((size_t)(g0 + tp) * Cin + c0) * Cout + n;
        for (int ci = 0; ci < kc; ++ci) {
          float wv[4];
          if (vec) {
            stk::load4(wt + (size_t)ci * Cout, wv);
          } else {
#pragma unroll
            for (int i = 0; i < 4; ++i) wv[i] = n + i < Cout ? wt[(size_t)ci * Cout + i] : 0.0f;
          }
#pragma unroll
          for (int j = 0; j < S_FRAMES; ++j) {
            const float a = rt[j * S_KC + ci];
#pragma unroll
            for (int i = 0; i < 4; ++i) acc[j][i] = fmaf(a, wv[i], acc[j][i]);
          }
        }
      }
    }
  }
  if (n >= Cout) return;
  const int nn = min(4, Cout - n);  // this thread's columns
  float bv[4];
#pragma unroll
  for (int i = 0; i < 4; ++i) bv[i] = i < nn ? e.bias[n + i] : 0.0f;
#pragma unroll
  for (int j = 0; j < S_FRAMES; ++j) {
    const int tg = t0 + f0 + j;
    if (tg >= Tlen) break;
    const size_t off = ((size_t)b * Tlen + tg) * Cout + n;
    float v[4];
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      v[i] = acc[j][i] + bv[i];
      if (e.silu_out) v[i] = stk::silu_f(v[i]);
      if (e.mask) v[i] = __fmul_rn(v[i], mask_at(e, b, tg, n + i < Cout ? n + i : n, Cout));
      if (e.res && i < nn) v[i] = __fadd_rn(static_cast<const float*>(e.res)[off + i], v[i]);
      if (e.tanh_f32) v[i] = tanhf(v[i]);
    }
    if (e.int16) {
      uint16_t* o = static_cast<uint16_t*>(e.out) + off;
#pragma unroll
      for (int i = 0; i < 4; ++i)
        if (i < nn) o[i] = egress_i16(v[i]);
      continue;
    }
    float* o = static_cast<float*>(e.out) + off;
    if (vec) {
      stk::store_n<float, 4>(o, v);
    } else {
#pragma unroll
      for (int i = 0; i < 4; ++i)
        if (i < nn) o[i] = v[i];
    }
  }
}

// ---------------------------------------------------------------------------
// bf16 on the tensor cores
// ---------------------------------------------------------------------------
constexpr int KC = 64;                   // input channels a unit (B rows a stage)
constexpr int CM = 128;                  // output frames of a consumer's tile: two 64-row M tiles
constexpr int MT = CM / 64;
constexpr int CONSUMERS = 256;           // two consumer warpgroups
constexpr int STAGES = 4;
constexpr int PANEL = KC * 128;          // bytes of a stage's 64-column panel
// An instance either has each consumer own whole tiles of CM frames, taking
// turns (COOP false: one consumer's epilogue runs beside the other's
// products), or both consumers share each tile of 2 CM frames, each its CM
// rows (COOP: one weight stage feeds 256 rows; the epilogues run together,
// beside the next tile's loads and staging): the frames of a tile, and the
// units whose copies run ahead of the one being silu'd
__host__ __device__ constexpr int tile_frames(bool coop) { return coop ? 2 * CM : CM; }
__host__ __device__ constexpr int ahead(bool coop) { return coop ? 1 : 2; }
constexpr int NWB_MAX = 16;              // window buffers at most
constexpr int SMEM = 232448;             // a block's shared memory
constexpr int PREGS = 64;                // registers a producer-side thread keeps
// The epilogue's options, compiled into each instance: an instance for each
// set of options the path gives the kernel at an even Cout and a mask with
// one fine frame a tile row (E_SILU: silu_out, E_MASK, E_RES: the residual,
// E_TANH: tanh into f32, E_I16: and on into int16 samples), and E_ANY for
// every other call (the options read
// at run time, any Cout, a fine frame a column). Measured: an epilogue
// compiled for every option at once ran several times slower than one
// compiled for the options of its call (kernel_variants.py conv1d).
constexpr int E_SILU = 1, E_MASK = 2, E_RES = 4, E_TANH = 8, E_ANY = 16, E_I16 = 32;

// K-major operand in shared memory without swizzle: 8-row core matrices of
// 16-byte rows, `sbo` bytes between 8-row groups, `lbo` bytes between the
// two 8-element halves of a k16 step; any 16-byte-aligned start address,
// so a descriptor may begin at any row
__device__ __forceinline__ uint64_t desc_plain(uint32_t addr, uint32_t lbo, uint32_t sbo) {
  return (uint64_t)((addr & 0x3FFFF) >> 4) | ((uint64_t)((lbo & 0x3FFFF) >> 4) << 16) |
         ((uint64_t)((sbo & 0x3FFFF) >> 4) << 32);
}

// BN output channels a tile (BN / 64 panels a stage, MT * BN / 2 accumulator
// registers a consumer), SW staging warps beside the weights' warp: 2
// consumer warpgroups + 32 (SW + 1) threads, one block an SM (at 384
// threads 168 registers a thread, at 512 128)
template <int BN, int SW, bool COOP>
struct Layout {
  static constexpr int BM = tile_frames(COOP), AHEAD = ahead(COOP);
  static constexpr int NP = BN / 64;
  static constexpr int STAGERS = 32 * SW;
  static constexpr int THREADS = CONSUMERS + 32 + STAGERS;
  static_assert(THREADS % 128 == 0, "the producer side in whole warpgroups (setmaxnreg)");
  // registers a thread at entry (the __launch_bounds__ cap, rounded down to
  // 8), and a consumer's once the producer side keeps PREGS
  static constexpr int ENTRY = (65536 / THREADS < 255 ? 65536 / THREADS : 255) / 8 * 8;
  static constexpr int CREGS_ =
      (ENTRY * THREADS / 128 - (THREADS - CONSUMERS) / 128 * PREGS) / 2 / 8 * 8;
  static constexpr int CREGS = CREGS_ < 240 ? CREGS_ : 240;
  static constexpr int STAGE = NP * PANEL;
  // full, empty a stage; two turns; full, empty a window buffer
  static constexpr int BARS = 8 * (2 * STAGES + 2 + 2 * NWB_MAX);
  // what the window buffers may take: the block's shared memory less the
  // alignment slack, the ring and the barriers
  static constexpr int WINDOWS = SMEM - 1024 - STAGES * STAGE - BARS;
  static_assert(WINDOWS >= (AHEAD + 2) * 8 * (BM + MAX_SPAN + 1) * 16, "window buffers");
};

// a launch's shape, derived on the host
struct Conv {
  const bf16* x;
  int Tlen, Cin, Cout, k, d, silu_in;
  int pad;     // frames of SAME padding on the left
  int G;       // taps a group
  int nch;     // 64-channel chunks of Cin
  int nunits;  // units of a tile's windows: groups x chunks
  int CS;      // bytes between a window's 8-channel columns
  int NWB;     // window buffers
  int NT;      // column tiles
  int TT;      // time tiles a batch row
  int L;       // tiles a staging pass: NT where a time tile's units stay, else 1
  int passes;  // staging passes of the launch
};

template <int BN, int SW, int EPI, bool COOP>
__global__ void __launch_bounds__(Layout<BN, SW, COOP>::THREADS, 1)
conv_wgmma(__grid_constant__ const CUtensorMap tm_w, const Conv p, Epi e) {
  using Lay = Layout<BN, SW, COOP>;
  constexpr int BM = Lay::BM, AHEAD = Lay::AHEAD;
  constexpr int NP = Lay::NP, STAGERS = Lay::STAGERS;
  extern __shared__ __align__(1024) unsigned char raw[];
  uint8_t* ring = raw + ((1024 - (stk::smem_u32(raw) & 1023)) & 1023);
  uint64_t* full = reinterpret_cast<uint64_t*>(ring + STAGES * Lay::STAGE);
  uint64_t* empty = full + STAGES;
  uint64_t* turn = empty + STAGES;   // [2]: a consumer may start its next tile
  uint64_t* wfull = turn + 2;        // [NWB_MAX]: a unit staged
  uint64_t* wempty = wfull + NWB_MAX;  // [NWB_MAX]: a unit read by its last tile
  uint8_t* win = reinterpret_cast<uint8_t*>(wempty + NWB_MAX);  // NWB buffers of UB bytes
  const int UB = 8 * p.CS, NWB = p.NWB, CS = p.CS;
  const int lane = threadIdx.x & 31;
  // the block's passes are blockIdx.x + q gridDim.x, each of L tiles; tile i
  // of the block is global tile (blockIdx.x + (i / L) gridDim.x) L + i % L,
  // column tile fastest
  const int my_passes = (p.passes - 1 - (int)blockIdx.x) / (int)gridDim.x + 1;
  const int ntiles = my_passes * p.L;
  const int steps = p.k * p.nch;  // weight stages a tile
  if (threadIdx.x == 0) {
#pragma unroll
    for (int s = 0; s < STAGES; ++s) {
      stk::mbar_init(&full[s], 1);
      stk::mbar_init(&empty[s], COOP ? 8 : 4);  // the warps of the tile's consumers
    }
    stk::mbar_init(&turn[0], 1);
    stk::mbar_init(&turn[1], 1);
    for (int i = 0; i < NWB; ++i) {
      stk::mbar_init(&wfull[i], SW);  // every staging warp
      stk::mbar_init(&wempty[i], COOP ? 8 : 4);  // the warps of the last tile's consumers
    }
    stk::mbar_fence_init();
  }
  __syncthreads();

  if (threadIdx.x >= CONSUMERS) {
    stk::regs_dealloc<PREGS>();
    if (threadIdx.x < CONSUMERS + 32) {
      // one thread streams each tile's stages: tap group, chunk c, tap:
      // rows [tap Cin + c KC, + KC) of the [k Cin, Cout] weights, only the
      // panels that hold output channels
      if (lane == 0) {
        int gstep = 0;
        for (int i = 0; i < ntiles; ++i) {
          const int gt = (blockIdx.x + (i / p.L) * gridDim.x) * p.L + i % p.L;
          const int n0 = (gt % p.NT) * BN;
          const int panels = min(NP, (p.Cout - n0 + 63) / 64);
          for (int g0 = 0; g0 < p.k; g0 += p.G) {
            const int taps = min(p.G, p.k - g0);
            for (int c = 0; c < p.nch; ++c)
              for (int tp = 0; tp < taps; ++tp, ++gstep) {
                const int st = gstep % STAGES;
                stk::mbar_wait(&empty[st], ((gstep / STAGES) & 1) ^ 1);
                stk::mbar_arrive_tx(&full[st], panels * PANEL);
                const int row = (g0 + tp) * p.Cin + c * KC;
                for (int q = 0; q < panels; ++q)
                  stk::tma_load_2d(ring + st * Lay::STAGE + q * PANEL, &tm_w, &full[st],
                                   n0 + 64 * q, row);
              }
          }
        }
      }
      return;
    }
    // the other SW warps stage each pass's units in order into buffer seq %
    // NWB (seq = q nunits + u): row r = frame origin + r at r * 16 bytes of
    // column ch = channels c KC + 8 ch, zero outside [0, T) and past Cin, by
    // cp.async, AHEAD units of the pass ahead of the one they finish: silu
    // in place over the same chunks, then the hand-over. A buffer comes back
    // once the last tile reading it has its products complete.
    const int st_id = threadIdx.x - CONSUMERS - 32;
    const bool vec = p.Cin % 8 == 0;
    const uint32_t win_u32 = stk::smem_u32(win);
    for (int q = 0; q < my_passes; ++q) {
      const int w = (blockIdx.x + q * gridDim.x) * p.L / p.NT;
      const int b = w / p.TT, t0 = (w % p.TT) * BM;
      const bf16* xb = p.x + (size_t)b * p.Tlen * p.Cin;
      auto rows_of = [&](int u) { return BM + (min(p.G, p.k - (u / p.nch) * p.G) - 1) * p.d; };
      auto issue = [&](int u) {
        const int seq = q * p.nunits + u, slot = seq % NWB;
        stk::mbar_wait(&wempty[slot], ((seq / NWB) & 1) ^ 1);
        const int c = u % p.nch, rows = rows_of(u);
        const int origin = t0 - p.pad + (u / p.nch) * p.G * p.d;
        for (int el = st_id; el < rows * 8; el += STAGERS) {
          const int r = el >> 3, tg = origin + r, ci = c * KC + (el & 7) * 8;
          const uint32_t off = slot * UB + (el & 7) * CS + r * 16;
          const bool in_t = tg >= 0 && tg < p.Tlen;
          if (vec) {
            const bool valid = in_t && ci < p.Cin;
            stk::cp_async16(win_u32 + off, valid ? xb + (size_t)tg * p.Cin + ci : xb, valid);
          } else {  // rows no multiple of 16 bytes: 8 scalar loads
            const uint16_t* xr =
                reinterpret_cast<const uint16_t*>(xb) + (in_t ? (size_t)tg * p.Cin : 0);
            uint32_t v[4];
#pragma unroll
            for (int j = 0; j < 4; ++j) {
              const uint32_t lo = in_t && ci + 2 * j < p.Cin ? xr[ci + 2 * j] : 0u;
              const uint32_t hi = in_t && ci + 2 * j + 1 < p.Cin ? xr[ci + 2 * j + 1] : 0u;
              v[j] = lo | (hi << 16);
            }
            *reinterpret_cast<uint4*>(win + off) = make_uint4(v[0], v[1], v[2], v[3]);
          }
        }
        stk::cp_async_commit();
      };
      for (int u = 0; u < AHEAD && u < p.nunits; ++u) issue(u);
      for (int u = 0; u < p.nunits; ++u) {
        // unit u's copies complete: every group but the AHEAD newest, or all
        if (u + AHEAD < p.nunits) {
          issue(u + AHEAD);
          stk::cp_async_wait<AHEAD>();
        } else {
          stk::cp_async_wait<0>();
        }
        const int slot = (q * p.nunits + u) % NWB;
        if (p.silu_in) {
          const int rows = rows_of(u);
#pragma unroll 4
          for (int el = st_id; el < rows * 8; el += STAGERS) {
            uint4* ptr = reinterpret_cast<uint4*>(win + slot * UB + (el & 7) * CS + (el >> 3) * 16);
            uint4 v = *ptr;
            uint32_t* pr = reinterpret_cast<uint32_t*>(&v);
#pragma unroll
            for (int j = 0; j < 4; ++j) {
              const float2 f = __bfloat1622float2(*reinterpret_cast<__nv_bfloat162*>(&pr[j]));
              pr[j] = stk::pack_bf16(stk::silu_fast(f.x), stk::silu_fast(f.y));
            }
            *ptr = v;
          }
        }
        // the window's generic writes, visible to the products' async reads
        stk::fence_proxy_async();
        __syncwarp();
        if (lane == 0) stk::mbar_arrive(&wfull[slot]);
      }
    }
    return;
  }

  // the epilogue's options: compiled in, or read at run time (E_ANY)
  constexpr bool ANY = EPI & E_ANY;
  const bool silu_out = ANY ? e.silu_out != 0 : (EPI & E_SILU) != 0;
  const bool masked = ANY ? e.mask != nullptr : (EPI & E_MASK) != 0;
  const bool residual = ANY ? e.res != nullptr : (EPI & E_RES) != 0;
  const bool tanh_out = ANY ? e.tanh_f32 != 0 : (EPI & E_TANH) != 0;
  const bool int16_out = ANY ? e.int16 != 0 : (EPI & E_I16) != 0;
  const bool even = ANY ? p.Cout % 2 == 0 : true;
  // consumer warpgroup wg takes the block's tiles i = wg, wg + 2, ... (COOP:
  // every tile, its rows row0..)
  stk::regs_alloc<Lay::CREGS>();
  const int wg = threadIdx.x / 128, warp = (threadIdx.x / 32) & 3;
  const int row0 = COOP ? CM * wg : 0;
  const int g = lane >> 2, t = lane & 3;
  float acc[MT][BN / 2];
  auto release = [&](uint64_t* bar) {
    __syncwarp();
    if (lane == 0) stk::mbar_arrive(bar);
  };
  const uint32_t ring_u32 = stk::smem_u32(ring), win_u32 = stk::smem_u32(win);
  for (int i = COOP ? 0 : wg; i < ntiles; i += COOP ? 1 : 2) {
    const int q = i / p.L;
    const bool last = i % p.L == p.L - 1;  // the pass's last tile hands its units back
    const int gt = (blockIdx.x + q * gridDim.x) * p.L + i % p.L;
    const int w = gt / p.NT, n0 = (gt % p.NT) * BN;
    const int b = w / p.TT, t0 = (w % p.TT) * BM;
    const int gstep0 = i * steps;
    // what the epilogue reads, loaded into registers while the products run:
    // the bias of this thread's columns 8j + 2t (+ 1) and, where all the
    // tile's columns of a row lie in one fine frame (always at fold 1, and
    // at the up convs), the mask values of its rows. Loads in the epilogue
    // itself would wait on the memory the products keep busy.
    const int cgrp = p.Cout / e.fold;
    const int f_lo = n0 / cgrp, f_hi = (min(n0 + BN, p.Cout) - 1) / cgrp;
    const bool uniform = ANY ? f_lo == f_hi : true;
    float bias_r[BN / 8][2], mask_r[MT][2];
#pragma unroll
    for (int j = 0; j < BN / 8; ++j) {
      const int n = n0 + 8 * j + 2 * t;
      bias_r[j][0] = n < p.Cout ? __ldg(e.bias + n) : 0.0f;
      bias_r[j][1] = n + 1 < p.Cout ? __ldg(e.bias + n + 1) : 0.0f;
    }
#pragma unroll
    for (int mi = 0; mi < MT; ++mi)
#pragma unroll
      for (int h = 0; h < 2; ++h) {
        const int tg = t0 + row0 + mi * 64 + 16 * warp + g + 8 * h;
        mask_r[mi][h] = masked && uniform && tg < p.Tlen
                            ? __ldg(e.mask + b * e.mstride + (size_t)tg * e.fold + f_lo)
                            : 1.0f;
      }
    // start once the other consumer has seen its tile's last stage arrive
    if (!COOP && i > 0) stk::mbar_wait(&turn[wg], ((i - 1) / 2) & 1);
    int s = 0;
    for (int u = 0; u < p.nunits; ++u) {
      const int seq = q * p.nunits + u, slot = seq % NWB;
      stk::mbar_wait(&wfull[slot], (seq / NWB) & 1);
      const int taps = min(p.G, p.k - (u / p.nch) * p.G);
      const uint32_t wb = win_u32 + slot * (uint32_t)UB;
      for (int tp = 0; tp < taps; ++tp, ++s) {
        // one stage a tap: m64 x BN x k16 products of both M tiles, A and
        // B from shared memory; the previous stage's are complete on
        // return (its stage released, and at a unit's first tap the
        // previous unit, where this is its last tile)
        const int gstep = gstep0 + s, st = gstep % STAGES;
        stk::mbar_wait(&full[st], (gstep / STAGES) & 1);
        if (!COOP && s == steps - 1 && threadIdx.x % 128 == 0) stk::mbar_arrive(&turn[wg ^ 1]);
        const uint32_t base = ring_u32 + st * Lay::STAGE;
        stk::wgmma_fence();
#pragma unroll
        for (int kk = 0; kk < 4; ++kk)
#pragma unroll
          for (int mi = 0; mi < MT; ++mi)
            stk::Wgmma<BN>::template ss<1>(
                acc[mi], desc_plain(wb + 2 * kk * CS + (row0 + mi * 64 + tp * p.d) * 16, CS, 128),
                stk::desc_sw128_mn(base + kk * 2048, PANEL), s > 0 || kk > 0);
        stk::wgmma_commit();
        stk::wgmma_wait<1>();
        if (s > 0) release(&empty[(gstep - 1) % STAGES]);
        if (tp == 0 && u > 0 && last) release(&wempty[(seq - 1) % NWB]);
      }
    }
    stk::wgmma_wait<0>();
    release(&empty[(gstep0 + steps - 1) % STAGES]);
    if (last) release(&wempty[(q * p.nunits + p.nunits - 1) % NWB]);
#pragma unroll
    for (int mi = 0; mi < MT; ++mi) stk::fence_regs(acc[mi]);

    // the epilogue from the registers, a row (its 16-row group's g, g + 8) at
    // a time: its residual pairs loaded together, then bias, one rounding,
    // silu_out, mask, residual and the store of each column pair
#pragma unroll
    for (int mi = 0; mi < MT; ++mi)
#pragma unroll
      for (int h = 0; h < 2; ++h) {
        const int tg = t0 + row0 + mi * 64 + 16 * warp + g + 8 * h;
        if (tg >= p.Tlen) continue;
        const size_t row = ((size_t)b * p.Tlen + tg) * p.Cout;
        uint32_t res[BN / 8];
#pragma unroll
        for (int j = 0; j < BN / 8; ++j) {
          const int n = n0 + 8 * j + 2 * t;
          res[j] = 0u;
          if (residual && n < p.Cout) {
            const unsigned short* rp = static_cast<const unsigned short*>(e.res) + row + n;
            res[j] = even ? __ldg(reinterpret_cast<const unsigned int*>(rp))
                          : (uint32_t)__ldg(rp) |
                                (n + 1 < p.Cout ? (uint32_t)__ldg(rp + 1) << 16 : 0u);
          }
        }
        const float mk = stk::rnd<bf16>(mask_r[mi][h]);
#pragma unroll
        for (int j = 0; j < BN / 8; ++j) {
          const int n = n0 + 8 * j + 2 * t;
          if (n >= p.Cout) continue;
          const bool two = n + 1 < p.Cout;
          float v0 = stk::rnd<bf16>(__fadd_rn(acc[mi][4 * j + 2 * h], bias_r[j][0]));
          float v1 = stk::rnd<bf16>(__fadd_rn(acc[mi][4 * j + 2 * h + 1], bias_r[j][1]));
          if (silu_out) {
            v0 = stk::rnd<bf16>(stk::silu_fast(v0));
            v1 = stk::rnd<bf16>(stk::silu_fast(v1));
          }
          if (masked) {
            float k0 = mk, k1 = mk;
            if (!uniform) {  // a fine frame a column (masked folds off the tile's grid)
              const float* mr = e.mask + b * e.mstride + (size_t)tg * e.fold;
              k0 = stk::rnd<bf16>(__ldg(mr + n / cgrp));
              k1 = two ? stk::rnd<bf16>(__ldg(mr + (n + 1) / cgrp)) : k0;
            }
            v0 = stk::rnd<bf16>(__fmul_rn(v0, k0));
            v1 = stk::rnd<bf16>(__fmul_rn(v1, k1));
          }
          if (residual) {
            v0 = stk::rnd<bf16>(__fadd_rn(__uint_as_float(res[j] << 16), v0));
            v1 = stk::rnd<bf16>(__fadd_rn(__uint_as_float(res[j] & 0xffff0000u), v1));
          }
          if (int16_out) {
            uint16_t* o = static_cast<uint16_t*>(e.out) + row + n;
            const uint16_t s0 = egress_i16(tanhf(v0)), s1 = egress_i16(tanhf(v1));
            if (even) {
              *reinterpret_cast<uint32_t*>(o) = (uint32_t)s0 | (uint32_t)s1 << 16;
            } else {
              o[0] = s0;
              if (two) o[1] = s1;
            }
          } else if (tanh_out) {
            float* o = static_cast<float*>(e.out) + row + n;
            v0 = tanhf(v0);
            v1 = tanhf(v1);
            if (even) {
              *reinterpret_cast<float2*>(o) = make_float2(v0, v1);
            } else {
              o[0] = v0;
              if (two) o[1] = v1;
            }
          } else {
            uint16_t* o = static_cast<uint16_t*>(e.out) + row + n;
            const uint32_t pair = stk::pack_bf16(v0, v1);
            if (even) {
              *reinterpret_cast<uint32_t*>(o) = pair;
            } else {
              o[0] = (uint16_t)(pair & 0xffffu);
              if (two) o[1] = (uint16_t)(pair >> 16);
            }
          }
        }
      }
  }
}

// ---------------------------------------------------------------------------
// launch
// ---------------------------------------------------------------------------

template <int BN, int SW, int EPI, bool COOP>
int launch_wgmma(const bf16* x, const bf16* w, const Epi& e, int B, int Tlen, int Cin, int Cout,
                 int k, int d, int silu_in, cudaStream_t st) {
  using Lay = Layout<BN, SW, COOP>;
  constexpr int BM = Lay::BM;
  Conv p;
  p.x = x;
  p.Tlen = Tlen, p.Cin = Cin, p.Cout = Cout, p.k = k, p.d = d, p.silu_in = silu_in;
  p.pad = (k - 1) * d / 2;
  p.G = group_taps(k, d);
  p.nch = (Cin + KC - 1) / KC;
  p.nunits = (k + p.G - 1) / p.G * p.nch;
  p.CS = (BM + (p.G - 1) * d + 1) * 16;
  p.NWB = std::min(NWB_MAX, Lay::WINDOWS / (8 * p.CS));
  p.NT = (Cout + BN - 1) / BN;
  p.TT = (Tlen + BM - 1) / BM;
  p.L = p.nunits <= p.NWB ? p.NT : 1;
  const long long tiles = (long long)B * p.TT * p.NT;
  if (tiles > 0x7fffffff || (long long)k * Cin > 0x7fffffff) return (int)cudaErrorInvalidValue;
  p.passes = (int)(tiles / p.L);
  int sms = 0;
  if (int err = stk::sm_count(sms)) return err;
  // the weights [k Cin, Cout] in rows of Cout rounded up to 8 elements,
  // boxes of 64 rows x 64 columns (zero past Cout and past k Cin rows);
  // encoded at every launch: a graph capture keeps this launch's map
  CUtensorMap tm;
  const cuuint64_t dims[2] = {(cuuint64_t)Cout, (cuuint64_t)k * Cin};
  const cuuint64_t strides[1] = {(cuuint64_t)((Cout + 7) / 8 * 8) * sizeof(bf16)};
  const cuuint32_t box[2] = {64, (cuuint32_t)KC};
  if (int err = stk::encode_tma(&tm, w, 2, dims, strides, box)) return err;
  auto kernel = conv_wgmma<BN, SW, EPI, COOP>;
  static size_t configured[stk::kMaxDevices] = {};
  if (int err = stk::allow_dynamic_smem(kernel, SMEM, configured)) return err;
  static int regs_at_entry = 0;
  if (int err = stk::check_reg_split(kernel, Lay::THREADS - CONSUMERS, CONSUMERS, Lay::CREGS,
                                     regs_at_entry, PREGS))
    return err;
  kernel<<<std::min(p.passes, sms), Lay::THREADS, SMEM, st>>>(tm, p, e);
  return (int)cudaGetLastError();
}

}  // namespace

// x [B, T, Cin], w [k, Cin, Cout] (HIO), residual and out [B, T, Cout], all
// contiguous and 16-byte aligned, in the storage type (dtype 0 = f32, 1 =
// bf16; out f32 with tanh_f32, int16 with int16 too); bf16 w in rows of Cout
// rounded up to 8 elements; bias [Cout] f32; mask f32 [T * fold], a batch row
// at b * mstride (0: one row for all), or null; residual or null. int16 comes
// after the stream, so that the earlier design's entry (csrc/earlier/),
// which lacks it, takes the same call without it.
extern "C" int stk_conv1d(const void* x, const void* w, const void* bias, const void* mask,
                          long long mstride, const void* res, void* out, int B, int Tlen, int Cin,
                          int Cout, int k, int d, int silu_in, int silu_out, int fold,
                          int tanh_f32, int dtype, void* stream, int int16) {
  if (B < 1 || Tlen < 1 || Cin < 1 || Cout < 1 || k < 1 || d < 1 || fold < 1 || Cout % fold ||
      mstride < 0 || (int16 && !tanh_f32))
    return (int)cudaErrorInvalidValue;
  cudaStream_t st = (cudaStream_t)stream;
  const Epi e = {static_cast<const float*>(bias), static_cast<const float*>(mask), mstride, res,
                 out, fold, silu_out, tanh_f32, int16};
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
  // 128 x 128 tiles; at Cout <= 64 (the head: one 64-column panel) 128 x 64
  // tiles and 7 staging warps (the window's silu, once a frame there, sets
  // the pace). The epilogue's options compiled in where an instance has
  // them: the b64 path's pre and up convs (mask), pre_res pairs (silu out
  // and mask; mask and residual), prenet (all three), head (tanh, and on
  // into int16 samples). The
  // prenet and the head cooperative; the masked convs (pre, up) so where a
  // time tile's 256-frame windows stay for all its column tiles (up 2, not
  // up 1): measured faster there, slower where they do not
  const int opts = (silu_out ? E_SILU : 0) | (mask ? E_MASK : 0) | (res ? E_RES : 0) |
                   (tanh_f32 ? E_TANH : 0) | (int16 ? E_I16 : 0);
  const int bn = Cout <= 64 ? 64 : 128;
  const bool compiled = Cout % 2 == 0 && (!mask || fold == 1 || (Cout / fold) % bn == 0);
  const int G = group_taps(k, d), units = (k + G - 1) / G * ((Cin + KC - 1) / KC);
  const bool coop_stays =
      units <= Layout<128, 3, true>::WINDOWS / (8 * (tile_frames(true) + (G - 1) * d + 1) * 16);
#define STK_CONV(BN_, SW_, EPI_, COOP_) \
  launch_wgmma<BN_, SW_, EPI_, COOP_>(xb, wb, e, B, Tlen, Cin, Cout, k, d, silu_in, st)
  if (bn == 64) {
    if (compiled && opts == E_TANH) return STK_CONV(64, 7, E_TANH, true);
    if (compiled && opts == (E_TANH | E_I16)) return STK_CONV(64, 7, E_TANH | E_I16, true);
    return STK_CONV(64, 7, E_ANY, false);
  }
  if (compiled) {
    switch (opts) {
      case E_MASK:
        return coop_stays ? STK_CONV(128, 3, E_MASK, true) : STK_CONV(128, 3, E_MASK, false);
      case E_SILU | E_MASK: return STK_CONV(128, 3, E_SILU | E_MASK, false);
      case E_MASK | E_RES: return STK_CONV(128, 3, E_MASK | E_RES, false);
      case E_SILU | E_MASK | E_RES: return STK_CONV(128, 3, E_SILU | E_MASK | E_RES, true);
      default: break;
    }
  }
  return STK_CONV(128, 3, E_ANY, false);
#undef STK_CONV
}
