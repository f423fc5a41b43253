// Dilated residual chain of the vocoder's fine timelines, up to MAX_P conv
// pairs a launch:
//   for each dilation d_i:  h = mask * (conv_{k,d_i}(silu x) + ba_i)
//                           x = x + mask * (conv_{k,1}(silu h) + bb_i)
//
// Replaces supertonic_tpu/ops/vocoder_fused.py:_kernel (resblock_chain).
// Numerics follow it: silu in f32 rounded to the storage type; each conv
// accumulates in f32 with its f32 bias, is rounded to the storage type and
// then multiplied by the 0/1 frame mask; the residual add is in the storage
// type. The mask is the batch-shared frame mask, zero outside [0, T), which
// reproduces SAME zero padding at the sequence edges: after every conv,
// frames outside [0, T) and masked frames are exactly 0.
//
// Tiling of the fused kernels (both types): one block per (batch row, tile
// of TT output frames). The block holds W = TT + 2*halo frames (halo = the
// chain's one-sided reach, 16 for k=3 and dilations 1,3,9) in shared
// memory, zero outside [0, T), and runs all the convs between three shared
// buffers (x, silu(x), silu(h)) in the storage type. A conv reads its
// input at shifted rows; the rows it reads past the window feed only
// frames outside the exact region, whose frontier moves inward by each
// conv's reach, so after the chain the central TT frames are exact (the
// argument of the JAX kernel's docstring). Only the central tile is
// written. chain_tiling holds the layout and chooses W.
//
// Bound on the H100: 6 convs of 3*C*C multiply-adds per frame, 1.08 TFLOP
// at C=128 over 64 x 28,672 frames and 0.54 at C=256 over 64 x 3,584 (the
// path's b64 shapes), against two passes over the activation:
// compute-bound, on the tensor cores in bf16.
//
// bf16 design (chain_wgmma), on Hopper's own instructions: a block is one
// producer warpgroup and two or four consumer warpgroups. Each conv is an
// implicit GEMM [W frames, kC] x [kC, C] (any odd conv size k; 3 on the
// path, with instances of its own): a consumer owns 64-frame M tiles of
// the window (or, where a block holds fewer M tiles than consumers, a
// share of the output panels), and runs wgmma.m64n128k16 over its two
// 64-column panels of output channels (m64n64k16 a panel where it holds one
// or three), A from registers, B from shared memory. A, the activation at
// the tap's shifted row, comes by ldmatrix.x4 from the XOR-swizzled
// activation buffer (stk::swz: 16-byte chunk c of row r at c ^ (r % 8), so
// the eight rows of an ldmatrix at any row offset hit eight distinct bank
// groups): a matrix descriptor cannot start at an arbitrary row of a
// swizzled tile, and wgmma's register A fragment is mma.sync's, warp by
// warp. B, the tap's [C_in, C_out] weights, arrives by TMA in KC-row
// stages of 64-column panels, 128-byte swizzled, read through MN-major
// descriptors (as attention's P.V reads V). The producer's one thread
// streams the weights of all 2P convs through a ring of STAGES stages
// behind full/empty mbarriers, running ahead across conv boundaries (the
// weights do not depend on the activations); a consumer loads the next
// stage's A fragments (a second register bank) while the current stage's
// products run, keeps one group of products in flight and releases a stage
// once its products have completed. No block barrier orders the weight
// stream: the one barrier left is a named barrier among the consumers at
// each conv boundary, where the next conv reads rows the other consumer
// wrote. The epilogue works on the accumulator registers: bias, round,
// mask, silu and bf16-pair stores into the swizzled buffers, a pair's
// rounding one conversion and its mask product and residual add bf16x2
// operations, exact as the f32 ones are (the products by 0 or 1 are; the
// f32 sum of two bf16 values rounds as their bf16 sum); each thread's frame
// mask stays in registers as a bf16 pair. silu takes the fast exponential
// and division (__expf, __fdividef, a few f32 ulp before the bf16
// rounding). The window's rows past its ends are not padded: the reads
// there land in the ring or the neighbouring buffer and feed only inexact
// frames.
// The layout per C (WgLayout): W = 256 frames at C 64 and 128, 128 at 192
// and 256, 64 at 320 and 384 (three [W, C] bf16 buffers and the ring fit
// 227 KB); where a block holds fewer 64-frame M tiles than there are
// consumers, the consumers split the output panels instead, a stage
// padded with zero panels to an even split (C 320), so that no branch lies
// between two products: ptxas serialises every wgmma of a kernel that
// issues them under a branch (C7520). At a grid too small to fill the card
// (a B=1 vocoder window) chain_tiling takes the instance at half the
// frames (C <= 256), which gives more blocks for the same frames at a
// higher halo cost. The designs this replaces (two m64n64k16 products a
// k-step and the epilogue in f32: substitutions on this source; the
// mma.sync design before it, csrc/earlier/resblock_chain_mma_sync.cu) are
// kernel_variants.py's "earlier" variants. A chain whose halo this
// kernel's W cannot hold has no fused bf16 kernel: the caller splits it
// into groups of pairs that fit, and runs a pair that fits no W per conv
// (conv_pass, below).
// What limits it (kernel_variants.py resblock_chain --split, ms a launch
// from graphs at C 128 x 28,672 frames, B 64, NVIDIA H100 80GB HBM3, 700 W;
// the kernel 4.42): the epilogue, bound by instruction issue more than by
// the SFU, does not overlap the products, since every consumer reaches the
// conv-boundary barrier together (without the epilogue 2.56; silu as the
// identity 3.31); the products alone 2.44-2.47, 2.2x their bound: ptxas
// compiles the four-consumer instances within the launch bounds' 96
// registers a thread (setmaxnreg gives the consumers 112 only at run
// time) and serialises their products (C7512). Measured slower
// (kernel_variants.py): clusters of 2 and 4 blocks with each weight stage
// multicast (csrc/variants/resblock_chain_cluster.cu), two consumers
// everywhere, half of silu's exponentials on an FMA-pipe polynomial, the
// accurate silu, stages of at most 32 input channels; consumer groups splitting
// the output channels, each its own ring, with readiness barriers a group so
// that one group's epilogue runs beside the other's products (every group
// then reads all of A: 5.27-6.09 against 4.92 for the replaced design).
// Without a producer warpgroup (its first thread loading the ring under a
// predicate, every thread running the same instructions: 128 registers a
// thread and no C7512; kernel_variants.py's substitution) C 128 ran 3.97
// against 4.40-4.48 and C 256 2.86-2.88 against 2.30-2.31: a choice by
// instance is open (a branch around the loads instead serialised the
// products, C7518).
//
// f32 (chain_kernel): SIMT, exact to f32 rounding, each thread 16 frames x 4
// channels, W the largest multiple of 16 whose buffers fit SMEM_BUDGET.
// Only the buffers read at shifted rows carry pad rows. Rows of more than
// 1 KB (f32 above C = 256) leave no room for three buffers past the halo:
// the kernel then keeps two (x, silu h) and takes silu(x) as it reads x.
//
// Domain: any odd conv size k and any dilations >= 1. The fused kernels
// take every conv pair that reaches at most MAX_REACH frames ((d + 1) *
// (k - 1) / 2; 23 in f32, 31 in bf16): a static_assert below holds every
// instance to a lone pair of that reach. The caller runs a longer chain,
// or one whose halo outgrows W, as consecutive launches over groups of
// pairs, each writing x for the next: the same values as one launch, since
// x between pairs is stored in the storage type either way and each launch
// zeroes frames outside [0, T). A pair that no fused kernel can tile runs
// as two launches of conv_pass, one a conv, which keep no halo in shared
// memory: each tap's [frames, C] input rows are read from device memory at
// the tap's frame offset (zero outside [0, T), SAME padding), conv a writes
// silu(h), masked and rounded, to a device scratch [B, T, C], and conv b
// adds its masked, rounded output to x; the same rounding points, and in
// f32 the same sum order as chain_kernel.
//
// Widths: one instance per C in CHAIN_WIDTHS (multiples of 64 up to 384, the
// Pallas kernel's VMEM rule): the swizzle of 16-byte chunks by the row needs
// rows of a multiple of 8 chunks. The wrapper pads another C <= 384 with
// zero channels to the next instance: zero weights and biases keep the
// padded channels at exactly 0, so the real ones are as without them.
#include <type_traits>

#include "wgmma_gemm.cuh"

namespace {

using bf16 = __nv_bfloat16;
constexpr int NT = 256, TF = 16, MAX_P = 4;

struct Dil { int d[MAX_P]; };

// SIMT conv of size k at dilation d: out[f][c] for this thread's frames and
// channels. in points at frame 0 of a buffer with d * (k - 1) / 2 readable
// rows on each side. SILU_IN: the buffer holds x and the conv reads silu(x).
template <typename T, int C, bool SILU_IN, typename Epi>
__device__ __forceinline__ void conv_simt(const T* in, const T* __restrict__ w,
                                          const float* __restrict__ bias, int d, int k,
                                          int W, Epi epi) {
  constexpr int CG = C / 4, FG = NT / CG;
  const int cg = threadIdx.x % CG, fg = threadIdx.x / CG, c0 = cg * 4;
  if (FG * CG != NT && fg >= FG) return;  // threads past whole frame groups idle
  float bv[4];
#pragma unroll
  for (int i = 0; i < 4; ++i) bv[i] = bias[c0 + i];
  for (int f0 = fg * TF; f0 < W; f0 += FG * TF) {
    float acc[TF][4];
#pragma unroll
    for (int j = 0; j < TF; ++j)
#pragma unroll
      for (int i = 0; i < 4; ++i) acc[j][i] = bv[i];
    for (int tap = 0; tap < k; ++tap) {
      const T* rows = in + (ptrdiff_t)(f0 + (tap - (k - 1) / 2) * d) * C;
      const T* wt = w + (size_t)tap * C * C + c0;
      for (int ci = 0; ci < C; ++ci) {
        float wv[4];
        stk::load4(wt + (size_t)ci * C, wv);
#pragma unroll
        for (int j = 0; j < TF; ++j) {
          float a = stk::to_f(rows[j * C + ci]);
          if (SILU_IN) a = stk::silu_f(a);
#pragma unroll
          for (int i = 0; i < 4; ++i) acc[j][i] += a * wv[i];
        }
      }
    }
#pragma unroll
    for (int j = 0; j < TF; ++j)
#pragma unroll
      for (int i = 0; i < 4; ++i) epi(f0 + j, c0 + i, acc[j][i]);
  }
}

// ---------------------------------------------------------------------------
// f32: SIMT
// ---------------------------------------------------------------------------
constexpr size_t SMEM_BUDGET = 224 * 1024;
template <typename T>
constexpr int MAX_REACH = sizeof(T) == 4 ? 23 : 31;

template <typename T, int C>
constexpr int NBUF = C * sizeof(T) > 1024 ? 2 : 3;

// Dynamic shared memory of one SIMT block holding W frames, in this order
// (chain_kernel carves it up the same way): three buffers x [W], silu x
// [W + 2 pad], silu h [W + 2 hk], or two, x [W + 2 pad] and silu h
// [W + 2 hk]; then the [W] f32 frame mask. reach = pad + hk: the largest
// pair's reach.
template <typename T, int C>
constexpr size_t smem_bytes(int W, int reach) {
  return ((size_t)NBUF<T, C> * W + 2 * reach) * C * sizeof(T) + (size_t)W * sizeof(float);
}

// the most frames (a multiple of TF) a SIMT block holds at this reach
template <typename T, int C>
constexpr int simt_frames(int reach) {
  int W = 1024;
  while (W > 0 && smem_bytes<T, C>(W, reach) > SMEM_BUDGET) W -= TF;
  return W;
}

template <typename T, int C>
__global__ void __launch_bounds__(NT, 1)
chain_kernel(const T* __restrict__ x, const float* __restrict__ fmask,
             const T* __restrict__ wa, const float* __restrict__ ba,
             const T* __restrict__ wb, const float* __restrict__ bb,
             T* __restrict__ out, int Tlen, int P, int k, Dil dil, int W, int halo,
             int pad) {
  constexpr bool TWO = NBUF<T, C> == 2;  // no silu(x) buffer: conv a takes silu as it reads x
  extern __shared__ __align__(128) unsigned char smem[];
  const int hk = (k - 1) / 2;  // the reach of a conv b
  T* X = reinterpret_cast<T*>(smem) + (TWO ? (size_t)pad * C : 0);
  T* S = TWO ? X : X + (size_t)(W + pad) * C;  // silu(x), pad rows each side
  T* Hs = S + (size_t)(W + pad + hk) * C;      // silu(h), hk rows each side
  float* M = reinterpret_cast<float*>(Hs + (size_t)(W + hk) * C);
  const int TT = W - 2 * halo;
  const int b = blockIdx.y, t0 = blockIdx.x * TT - halo;
  const T* xb = x + (size_t)b * Tlen * C;

  // zero the pad rows (read only by inexact frames)
  const T zero = stk::from_f<T>(0.0f);
  for (int e = threadIdx.x; e < pad * C; e += NT) {
    S[e - pad * C] = zero;
    S[(size_t)W * C + e] = zero;
  }
  for (int e = threadIdx.x; e < hk * C; e += NT) {
    Hs[e - hk * C] = zero;
    Hs[(size_t)W * C + e] = zero;
  }
  for (int e = threadIdx.x; e < W * C; e += NT) {
    int f = e / C, tg = t0 + f;
    float v = (tg >= 0 && tg < Tlen) ? stk::to_f(xb[(size_t)tg * C + e % C]) : 0.0f;
    X[e] = stk::from_f<T>(v);
    if (!TWO) S[e] = stk::from_f<T>(stk::silu_f(v));
  }
  for (int f = threadIdx.x; f < W; f += NT) {
    int tg = t0 + f;
    M[f] = (tg >= 0 && tg < Tlen) ? (fmask ? fmask[tg] : 1.0f) : 0.0f;
  }
  __syncthreads();

  // h = mask * round(conv_d(silu x) + ba); store silu(h)
  auto epi_a = [&](int f, int c, float acc) {
    float h = stk::rnd<T>(acc) * M[f];
    Hs[(size_t)f * C + c] = stk::from_f<T>(stk::silu_f(h));
  };
  // x = x + mask * round(conv_1(silu h) + bb); store x and silu(x)
  auto epi_b = [&](int f, int c, float acc) {
    size_t i = (size_t)f * C + c;
    float xn = stk::rnd<T>(stk::to_f(X[i]) + stk::rnd<T>(acc) * M[f]);
    X[i] = stk::from_f<T>(xn);
    if (!TWO) S[i] = stk::from_f<T>(stk::silu_f(xn));
  };
  for (int p = 0; p < P; ++p) {
    const T* wpa = wa + (size_t)p * k * C * C;
    const T* wpb = wb + (size_t)p * k * C * C;
    conv_simt<T, C, TWO>(S, wpa, ba + p * C, dil.d[p], k, W, epi_a);
    __syncthreads();
    conv_simt<T, C, false>(Hs, wpb, bb + p * C, 1, k, W, epi_b);
    __syncthreads();
  }

  T* ob = out + (size_t)b * Tlen * C;
  for (int e = threadIdx.x; e < TT * C; e += NT) {
    int f = halo + e / C, tg = t0 + f;
    if (tg < Tlen) ob[(size_t)tg * C + e % C] = X[(size_t)f * C + e % C];
  }
}

// ---------------------------------------------------------------------------
// one conv, any reach: a pair that no fused kernel tiles
// ---------------------------------------------------------------------------
// Frames a conv_pass block computes: FG frame groups of TF, CG channel
// groups of 4 (threads past whole frame groups idle).
template <int C>
constexpr int conv_frames() { return NT / (C / 4) * TF; }

// out = conv a: silu(mask * round(conv_{k,d}(silu in) + bias)), in = x;
//       conv b: round(x + mask * round(conv_{k,d}(in) + bias)), in = silu h.
// Each tap's input rows go through shared memory (zero outside [0, T));
// the sums run tap by tap, channel by channel, as in conv_simt.
template <typename T, int C>
__global__ void __launch_bounds__(NT)
conv_pass(const T* __restrict__ in, const T* __restrict__ x, const float* __restrict__ fmask,
          const T* __restrict__ w, const float* __restrict__ bias, T* __restrict__ out,
          int Tlen, int k, int d, int is_b) {
  constexpr int CG = C / 4, FG = NT / CG, FT = FG * TF;
  extern __shared__ __align__(128) unsigned char smem[];
  T* rows = reinterpret_cast<T*>(smem);  // [FT][C]: the current tap's input rows
  const int cg = threadIdx.x % CG, fg = threadIdx.x / CG, c0 = cg * 4, f0 = fg * TF;
  const bool active = fg < FG;
  const int b = blockIdx.y, t0 = blockIdx.x * FT;
  const T* ib = in + (size_t)b * Tlen * C;
  float acc[TF][4];
#pragma unroll
  for (int j = 0; j < TF; ++j)
#pragma unroll
    for (int i = 0; i < 4; ++i) acc[j][i] = active ? bias[c0 + i] : 0.0f;
  for (int tap = 0; tap < k; ++tap) {
    const int shift = (tap - (k - 1) / 2) * d;
    __syncthreads();  // the last tap's rows are read
    for (int e = threadIdx.x; e < FT * C; e += NT) {
      const int tg = t0 + e / C + shift;
      float v = (tg >= 0 && tg < Tlen) ? stk::to_f(ib[(size_t)tg * C + e % C]) : 0.0f;
      if (!is_b) v = stk::silu_f(v);
      rows[e] = stk::from_f<T>(v);
    }
    __syncthreads();
    if (!active) continue;
    const T* wt = w + (size_t)tap * C * C + c0;
    for (int ci = 0; ci < C; ++ci) {
      float wv[4];
      stk::load4(wt + (size_t)ci * C, wv);
#pragma unroll
      for (int j = 0; j < TF; ++j) {
        const float a = stk::to_f(rows[(f0 + j) * C + ci]);
#pragma unroll
        for (int i = 0; i < 4; ++i) acc[j][i] += a * wv[i];
      }
    }
  }
  if (!active) return;
  T* ob = out + (size_t)b * Tlen * C;
  const T* xb = x + (size_t)b * Tlen * C;
#pragma unroll
  for (int j = 0; j < TF; ++j) {
    const int tg = t0 + f0 + j;
    if (tg >= Tlen) continue;
    const float m = fmask ? fmask[tg] : 1.0f;
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      const size_t e = (size_t)tg * C + c0 + i;
      const float v = stk::rnd<T>(acc[j][i]) * m;
      ob[e] = stk::from_f<T>(is_b ? stk::to_f(xb[e]) + v : stk::silu_f(v));
    }
  }
}

// ---------------------------------------------------------------------------
// bf16 on the tensor cores
// ---------------------------------------------------------------------------
// consumer warpgroups a block: WIDE_CONSUMERS where they split the M tiles
// and panels evenly, else two
constexpr int WIDE_CONSUMERS = 4;
// registers of the producer warpgroup (one thread issues): the rest go to
// the consumers (112 each of four, 224 each of two)
constexpr int PRODUCER_REGS = 24;
constexpr int MAX_STAGES = 8;
constexpr size_t WG_SMEM_MAX = 232448;  // the most a block may have (227 KB)

// the largest frames a block holds at C: three [W, C] bf16 buffers and the
// ring fit 227 KB; each C also has an instance at half of it (C <= 256)
template <int C>
constexpr int wg_frames() { return C <= 128 ? 256 : C <= 256 ? 128 : 64; }

// The layout of the instance at C holding W frames: the consumers split
// its M tiles (CM of them), or, where the tiles are fewer than the
// consumers, the output panels (CN); a stage holds CN * NPC panels of KC
// rows, those past C zero (never loaded), so that every consumer runs the
// same products and no branch lies between two of them.
template <int C, int W_>
struct WgLayout {
  static constexpr int W = W_;                        // frames a block
  static constexpr int NC = W / 64 * (C / 64) % WIDE_CONSUMERS == 0 &&
                                    (C / 64) % (WIDE_CONSUMERS / (W / 64 < WIDE_CONSUMERS
                                                                      ? W / 64
                                                                      : WIDE_CONSUMERS)) == 0
                                ? WIDE_CONSUMERS
                                : 2;
  static constexpr int THREADS = (NC + 1) * 128;
  static constexpr int NP = C / 64;                   // 64-column panels of a row
  static constexpr int CM = W / 64 < NC ? W / 64 : NC;  // consumers across the M tiles
  static constexpr int CN = NC / CM;                  // consumers across the panels
  static constexpr int NPC = (NP + CN - 1) / CN;      // panels a consumer
  static constexpr int NPS = CN * NPC;                // panels a stage
  static constexpr int MT = W / 64 / CM;              // M tiles a consumer
  // silu h [W] | silu x [W] | x [W], after the ring: a conv's reads past
  // its buffer's ends land in the ring or the neighbouring buffer (a conv
  // b reaches (k - 1) / 2 rows, a conv a less than W / 2, and the ring
  // holds at least W / 2 rows); x is never read at shifted rows
  static constexpr size_t BUFS = (size_t)3 * W * C * sizeof(bf16);
  // input channels (B rows) a stage: 64 where the buffers leave room for
  // several such stages (fewer handshakes a conv), else 32, 16 at C 256
  static constexpr int KC = BUFS <= 128 * 1024 && (C / 64) % 2 == 0 ? 64
                            : C == 256 ? 16 : 32;
  static constexpr int NKT = C / KC;                  // stages a tap (k NKT a conv)
  static constexpr int PANEL = KC * 128;              // bytes of a stage's panel
  static constexpr int STAGE = NPS * PANEL;
  static constexpr int FIT = (int)((WG_SMEM_MAX - 1024 - BUFS) / (STAGE + 16));
  static constexpr int STAGES = FIT < MAX_STAGES ? FIT : MAX_STAGES;
  // slack for the 1024-byte alignment | ring | buffers | full, empty barriers
  static constexpr size_t BYTES = 1024 + (size_t)STAGES * STAGE + BUFS + 16 * STAGES;
  static_assert(STAGES >= 2 && NKT % 2 == 0 && MT >= 1 && BYTES <= WG_SMEM_MAX &&
                    (size_t)STAGES * STAGE >= (size_t)W / 2 * C * sizeof(bf16), "layout");
  static_assert(CM * CN == NC && MT * CM * 64 == W && C % KC == 0 &&
                KC % 16 == 0, "layout");
};

// silu of two values, rounded to bf16 and packed: the fast exponential and
// division, two MUFU operations each
__device__ __forceinline__ uint32_t silu_pair(float a, float b) {
  return stk::pack_bf16(stk::silu_fast(a), stk::silu_fast(b));
}

// KT: the conv size, or 0 for any odd size (k_); the path's 3 has its own
// instances, which run its stages ~10% faster at C 256 (kernel_variants.py)
template <int C, int W, int KT>
__global__ void __launch_bounds__(WgLayout<C, W>::THREADS, 1)
chain_wgmma(__grid_constant__ const CUtensorMap tm_wa, __grid_constant__ const CUtensorMap tm_wb,
            const bf16* __restrict__ x, const float* __restrict__ fmask,
            const float* __restrict__ ba, const float* __restrict__ bb, bf16* __restrict__ out,
            int Tlen, int P, int k_, Dil dil, int halo) {
  using L = WgLayout<C, W>;
  const int k = KT ? KT : k_;
  constexpr int NS = L::STAGES, KC = L::KC, MT = L::MT, NPC = L::NPC, CH = C / 8;
  const int NK = k * L::NKT;  // stages a conv: even, as NKT is
  constexpr int KS = KC / 16;  // k16 steps a stage
  extern __shared__ __align__(1024) unsigned char raw[];
  // swizzled stages need 1024-byte alignment; the launch adds the slack
  uint8_t* ring = raw + ((1024 - (stk::smem_u32(raw) & 1023)) & 1023);
  bf16* Hs = reinterpret_cast<bf16*>(ring + NS * L::STAGE);  // row f: frame f
  bf16* S = Hs + L::W * C;
  bf16* X = S + L::W * C;
  uint64_t* full = reinterpret_cast<uint64_t*>(X + L::W * C);
  uint64_t* empty = full + NS;
  const int wg = threadIdx.x / 128, warp = (threadIdx.x / 32) & 3, lane = threadIdx.x & 31;
  const int TT = W - 2 * halo;
  const int b = blockIdx.y, t0 = blockIdx.x * TT - halo;
  const int steps = 2 * P * NK;
  if (threadIdx.x == 0) {
#pragma unroll
    for (int s = 0; s < NS; ++s) {
      stk::mbar_init(&full[s], 1);
      stk::mbar_init(&empty[s], 4 * L::NC);  // every consumer warp
    }
    stk::mbar_fence_init();
  }
  __syncthreads();

  if (wg == L::NC) {
    // producer: one thread streams stage s = rows [r KC, r KC + KC) of conv
    // s / NK's tap-major [k*C, C] weights (convs a, b, a, b, ...), r = s % NK
    stk::regs_dealloc<PRODUCER_REGS>();
    if (threadIdx.x % 128 == 0) {
      for (int s = 0; s < steps; ++s) {
        const int st = s % NS, conv = s / NK;
        stk::mbar_wait(&empty[st], ((s / NS) & 1) ^ 1);
        stk::mbar_arrive_tx(&full[st], L::NP * L::PANEL);
        const CUtensorMap* map = (conv & 1) ? &tm_wb : &tm_wa;
        const int row = (conv >> 1) * k * C + (s % NK) * KC;
#pragma unroll
        for (int p = 0; p < L::NP; ++p)
          stk::tma_load_2d(ring + st * L::STAGE + p * L::PANEL, map, &full[st], 64 * p, row);
      }
    }
    return;
  }

  stk::regs_alloc<stk::consumer_regs(L::NC, 1, PRODUCER_REGS)>();
  const int g = lane >> 2, t = lane & 3;
  const int cm = wg % L::CM, cn = wg / L::CM;
  // the window: x and silu(x), zero outside [0, T)
  const bf16* xb = x + (size_t)b * Tlen * C;
  for (int e = threadIdx.x; e < W * CH; e += L::NC * 128) {
    const int f = e / CH, ch = e % CH, tg = t0 + f;
    uint4 v = make_uint4(0, 0, 0, 0);
    if (tg >= 0 && tg < Tlen) v = *reinterpret_cast<const uint4*>(xb + (size_t)tg * C + ch * 8);
    *reinterpret_cast<uint4*>(X + stk::swz<C>(f, ch)) = v;
    uint32_t* pr = reinterpret_cast<uint32_t*>(&v);
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      const float2 xf = __bfloat1622float2(*reinterpret_cast<__nv_bfloat162*>(&pr[i]));
      pr[i] = silu_pair(xf.x, xf.y);
    }
    *reinterpret_cast<uint4*>(S + stk::swz<C>(f, ch)) = v;
  }
  // the stages' panels past C, read as zeros by the products
  if constexpr (L::NPS > L::NP) {
    for (int e = threadIdx.x; e < NS * (L::NPS - L::NP) * L::PANEL / 16;
         e += L::NC * 128) {
      const int per = (L::NPS - L::NP) * L::PANEL / 16;
      *reinterpret_cast<uint4*>(ring + (e / per) * L::STAGE + L::NP * L::PANEL +
                                (e % per) * 16) = make_uint4(0, 0, 0, 0);
    }
    stk::fence_proxy_async();
  }
  // this thread's rows: 64 m + 16 warp + g (+ 8) of M tile m = cm + CM i;
  // their frame mask, 0 outside [0, T), as a bf16 pair
  __nv_bfloat162 mrow[MT][2];
#pragma unroll
  for (int i = 0; i < MT; ++i)
#pragma unroll
    for (int h = 0; h < 2; ++h) {
      const int tg = t0 + (cm + L::CM * i) * 64 + 16 * warp + g + 8 * h;
      mrow[i][h] = __float2bfloat162_rn((tg >= 0 && tg < Tlen) ? (fmask ? fmask[tg] : 1.0f)
                                                                : 0.0f);
    }
  stk::named_bar_sync(1, L::NC * 128);

  float acc[MT][32 * NPC];
  uint32_t a0[MT][KS][4], a1[MT][KS][4];  // A fragments, two banks
  auto release = [&](int s) {
    __syncwarp();
    if (lane == 0) stk::mbar_arrive(&empty[s % NS]);
  };
  int step = 0;
  for (int conv = 0; conv < 2 * P; ++conv) {
    const bool is_b = conv & 1;
    const int d = is_b ? 1 : dil.d[conv >> 1];
    const bf16* in = is_b ? Hs : S;
    // stage r of this conv: A at the tap's row offset into bank a, then
    // wgmma over the stage's panels; the previous stage's products are
    // complete on return (its stage released, its A bank free)
    auto mma_step = [&](int r, uint32_t (&a)[MT][KS][4]) {
      const int st = step % NS;
      const int tap = r / L::NKT, kc = (r % L::NKT) * KC, off = (tap - (k - 1) / 2) * d;
#pragma unroll
      for (int i = 0; i < MT; ++i) {
        const int m = cm + L::CM * i;
#pragma unroll
        for (int kk = 0; kk < KS; ++kk)
          stk::ldmatrix_x4(a[i][kk], stk::smem_u32(in + stk::swz<C>(
                                         m * 64 + 16 * warp + (lane & 15) + off,
                                         (kc >> 3) + 2 * kk + (lane >> 4))));
      }
      stk::mbar_wait(&full[st], (step / NS) & 1);
      const uint32_t base = stk::smem_u32(ring + st * L::STAGE);
      stk::wgmma_fence();
#pragma unroll
      for (int kk = 0; kk < KS; ++kk)
#pragma unroll
        for (int i = 0; i < MT; ++i) {
          if constexpr (NPC == 2) {  // both panels in one product
            stk::Wgmma<128>::template rs<1>(
                acc[i], a[i][kk],
                stk::desc_sw128_mn(base + cn * NPC * L::PANEL + kk * 2048, L::PANEL),
                r > 0 || kk > 0);
          } else {
#pragma unroll
            for (int j = 0; j < NPC; ++j)
              stk::Wgmma<64>::template rs<1>(
                  *reinterpret_cast<float(*)[32]>(&acc[i][32 * j]), a[i][kk],
                  stk::desc_sw128(base + (cn * NPC + j) * L::PANEL + kk * 2048),
                  r > 0 || kk > 0);
          }
        }
      stk::wgmma_commit();
      stk::wgmma_wait<1>();
      if (r > 0) release(step - 1);
      ++step;
    };
    for (int r = 0; r < NK; r += 2) {
      mma_step(r, a0);
      mma_step(r + 1, a1);
    }
    stk::wgmma_wait<0>();
    release(step - 1);
#pragma unroll
    for (int i = 0; i < MT; ++i) stk::fence_regs(acc[i]);

    // conv a: h = mask * round(acc + ba), store silu(h); conv b: x =
    // round(x + mask * round(acc + bb)), store x and silu(x). Rows g, g + 8
    // of the warp's 16, channels 2t, 2t + 1 of each n8 group, two a store.
    // A pair's rounding is one conversion, its mask product and residual
    // add bf16x2 operations: exact as the f32 ones are (the products by 0
    // or 1 are; the f32 sum of two bf16 values rounds as their bf16 sum)
    const float* bias = (is_b ? bb : ba) + (conv >> 1) * C;
    const bool last = conv == 2 * P - 1;
#pragma unroll
    for (int i = 0; i < MT; ++i) {
      const int m = cm + L::CM * i;
#pragma unroll
      for (int j = 0; j < NPC; ++j) {
        const int p = cn * NPC + j;
        if (p >= L::NP) continue;  // a zero panel
#pragma unroll
        for (int jj = 0; jj < 8; ++jj) {
          const int c = p * 64 + jj * 8 + 2 * t;
          const float2 bv = *reinterpret_cast<const float2*>(bias + c);
#pragma unroll
          for (int h = 0; h < 2; ++h) {
            const int f = m * 64 + 16 * warp + g + 8 * h;
            const int e = 32 * j + 4 * jj + 2 * h;
            const __nv_bfloat162 v = __hmul2_rn(
                __floats2bfloat162_rn(acc[i][e] + bv.x, acc[i][e + 1] + bv.y), mrow[i][h]);
            const int at = stk::swz<C>(f, c >> 3) + (c & 7);
            if (!is_b) {
              const float2 vf = __bfloat1622float2(v);
              *reinterpret_cast<uint32_t*>(Hs + at) = silu_pair(vf.x, vf.y);
            } else {
              __nv_bfloat162* xp = reinterpret_cast<__nv_bfloat162*>(X + at);
              const __nv_bfloat162 xn = __hadd2_rn(*xp, v);
              *xp = xn;
              if (!last) {  // the last conv's silu(x) has no reader
                const float2 xf = __bfloat1622float2(xn);
                *reinterpret_cast<uint32_t*>(S + at) = silu_pair(xf.x, xf.y);
              }
            }
          }
        }
      }
    }
    // the next conv reads rows the other consumer wrote
    stk::named_bar_sync(1, L::NC * 128);
  }

  bf16* ob = out + (size_t)b * Tlen * C;
  for (int e = threadIdx.x; e < TT * CH; e += L::NC * 128) {
    const int f = halo + e / CH, ch = e % CH, tg = t0 + f;
    if (tg < Tlen)
      *reinterpret_cast<uint4*>(ob + (size_t)tg * C + ch * 8) =
          *reinterpret_cast<const uint4*>(X + stk::swz<C>(f, ch));
  }
}

// ---------------------------------------------------------------------------
// tiling and launch
// ---------------------------------------------------------------------------
// halo = the chain's one-sided reach, pad = the largest reach of one conv
// a (the pad of silu x in the SIMT kernel), hk = a conv b's reach, W =
// frames a block holds (tile = W - 2*halo); W is 0 when no fused kernel
// tiles the chain.
struct Tiling { int halo, pad, hk, W; };

// bf16: the tensor-core kernel's largest W, or at a launch's shape (B,
// Tlen > 0) half of it (C <= 256) where that fills the card better: the
// one of least ceil(blocks / SMs) * W, the larger on a tie. f32: the SIMT
// kernel's W.
template <typename T, int C>
Tiling chain_tiling(const Dil& dil, int P, int k, int B, int Tlen) {
  const int hk = (k - 1) / 2;
  Tiling t = {0, 0, hk, 0};
  for (int i = 0; i < P; ++i) {
    t.halo += dil.d[i] * hk + hk;
    t.pad = dil.d[i] * hk > t.pad ? dil.d[i] * hk : t.pad;
  }
  if constexpr (std::is_same<T, bf16>::value) {
    constexpr int W0 = wg_frames<C>();
    if (W0 <= 2 * t.halo) return t;
    t.W = W0;
    int sms = 0;
    if (C <= 256 && W0 / 2 > 2 * t.halo && B > 0 && Tlen > 0 && !stk::sm_count(sms)) {
      auto cost = [&](int w) {
        const long long blocks = (long long)B * ((Tlen + w - 2 * t.halo - 1) / (w - 2 * t.halo));
        return (blocks + sms - 1) / sms * w;
      };
      if (cost(W0 / 2) < cost(W0)) t.W = W0 / 2;
    }
  } else {
    const int W = simt_frames<T, C>(t.pad + hk);
    t.W = W > 2 * t.halo ? W : 0;
  }
  return t;
}

template <int C, int W, int KT>
int launch_wgmma(const bf16* x, const float* m, const bf16* wa, const float* ba, const bf16* wb,
                 const float* bb, bf16* out, int B, int Tlen, int P, int k, Dil dil,
                 const Tiling& t, cudaStream_t st) {
  using L = WgLayout<C, W>;
  // the weights [P*k*C_in, C_out], boxes of KC rows x 64 columns; encoded at
  // every launch: a graph capture keeps this launch's maps
  CUtensorMap ta, tb;
  const cuuint64_t dims[2] = {(cuuint64_t)C, (cuuint64_t)P * k * C};
  const cuuint64_t strides[1] = {(cuuint64_t)C * sizeof(bf16)};
  const cuuint32_t box[2] = {64, (cuuint32_t)L::KC};
  if (int err = stk::encode_tma(&ta, wa, 2, dims, strides, box)) return err;
  if (int err = stk::encode_tma(&tb, wb, 2, dims, strides, box)) return err;
  auto kernel = chain_wgmma<C, W, KT>;
  static size_t configured[stk::kMaxDevices] = {};
  if (int err = stk::allow_dynamic_smem(kernel, L::BYTES, configured)) return err;
  static int regs_at_entry = 0;
  if (int err = stk::check_reg_split(kernel, 128, L::NC * 128,
                                     stk::consumer_regs(L::NC, 1, PRODUCER_REGS), regs_at_entry,
                                     PRODUCER_REGS))
    return err;
  const int TT = t.W - 2 * t.halo;
  dim3 grid((Tlen + TT - 1) / TT, B);
  kernel<<<grid, L::THREADS, L::BYTES, st>>>(ta, tb, x, m, ba, bb, out, Tlen, P, k, dil, t.halo);
  return (int)cudaGetLastError();
}

template <typename T, int C>
int launch(const void* x, const float* m, const void* wa, const float* ba,
           const void* wb, const float* bb, void* out, int B, int Tlen, int P, int k,
           Dil dil, cudaStream_t st) {
  const Tiling t = chain_tiling<T, C>(dil, P, k, B, Tlen);
  if (!t.W) return (int)cudaErrorInvalidValue;
  if constexpr (std::is_same<T, bf16>::value) {
    static_assert(wg_frames<C>() > 2 * MAX_REACH<T>,
                  "every instance takes a lone conv pair of MAX_REACH");
    // the instance at W0 or W0 / 2 frames, for k = 3 or any k
    auto run = [&](auto w, auto kt) {
      return launch_wgmma<C, decltype(w)::value, decltype(kt)::value>(
          (const bf16*)x, m, (const bf16*)wa, ba, (const bf16*)wb, bb, (bf16*)out, B, Tlen, P, k,
          dil, t, st);
    };
    using W0 = std::integral_constant<int, wg_frames<C>()>;
    using K3 = std::integral_constant<int, 3>;
    using KANY = std::integral_constant<int, 0>;
    if (t.W == W0::value) return k == 3 ? run(W0(), K3()) : run(W0(), KANY());
    if constexpr (C <= 256) {
      using W1 = std::integral_constant<int, W0::value / 2>;
      return k == 3 ? run(W1(), K3()) : run(W1(), KANY());
    }
    return (int)cudaErrorInvalidValue;
  } else {
    static_assert(simt_frames<T, C>(MAX_REACH<T>) > 2 * MAX_REACH<T>,
                  "every instance takes a lone conv pair of MAX_REACH");
    const int TT = t.W - 2 * t.halo;
    dim3 grid((Tlen + TT - 1) / TT, B);
    static size_t configured[stk::kMaxDevices] = {};
    const size_t bytes = smem_bytes<T, C>(t.W, t.pad + t.hk);
    if (int err = stk::allow_dynamic_smem(chain_kernel<T, C>, bytes, configured)) return err;
    chain_kernel<T, C><<<grid, NT, bytes, st>>>((const T*)x, m, (const T*)wa, ba, (const T*)wb,
                                                bb, (T*)out, Tlen, P, k, dil, t.W, t.halo,
                                                t.pad);
    return (int)cudaGetLastError();
  }
}

template <typename T, int C>
int launch_conv(const void* in, const void* x, const float* m, const void* w, const float* bias,
                void* out, int B, int Tlen, int k, int d, int is_b, cudaStream_t st) {
  constexpr int FT = conv_frames<C>();
  constexpr size_t bytes = (size_t)FT * C * sizeof(T);
  static size_t configured[stk::kMaxDevices] = {};
  if (int err = stk::allow_dynamic_smem(conv_pass<T, C>, bytes, configured)) return err;
  dim3 grid((Tlen + FT - 1) / FT, B);
  conv_pass<T, C><<<grid, NT, bytes, st>>>((const T*)in, (const T*)x, m, (const T*)w, bias,
                                           (T*)out, Tlen, k, d, is_b);
  return (int)cudaGetLastError();
}

template <typename T, int C>
int tile_frames(Dil dil, int P, int k, int B, int Tlen) {
  const Tiling t = chain_tiling<T, C>(dil, P, k, B, Tlen);
  return t.W ? t.W - 2 * t.halo : -1;
}

template <int C, int W>
void layout_info(int* info) {
  using L = WgLayout<C, W>;
  const int v[7] = {L::W, L::NC, L::MT, L::NPC, L::KC, L::STAGES, (int)L::BYTES};
  for (int i = 0; i < 7; ++i) info[i] = v[i];
}

template <int C>
int layout_of(int half, int* info) {
  if (!half) {
    layout_info<C, wg_frames<C>()>(info);
    return 0;
  }
  if constexpr (C <= 256) {
    layout_info<C, wg_frames<C>() / 2>(info);
    return 0;
  }
  return -1;
}

bool read_args(const int* dils, int P, int k, Dil* dil) {
  if (P < 1 || P > MAX_P || k < 1 || k % 2 == 0) return false;
  for (int i = 0; i < P; ++i) {
    if (dils[i] < 1) return false;
    dil->d[i] = dils[i];
  }
  return true;
}

}  // namespace

// x/out [B,T,C]; wa/wb [P,k,C,C] (HIO per conv) in the storage type (dtype
// 0 float, 1 bf16); ba/bb [P,C] float; fmask [T] float or null; dils [P],
// 1 <= P <= 4; k odd. All contiguous and 16-byte aligned; C one of the
// instances (64, 128, 192, 256, 320, 384). The kernel picks its own time
// tiling, and fails when the chain's halo leaves no tile.
#define STK_CHAIN_WIDTHS(X) X(64) X(128) X(192) X(256) X(320) X(384)

extern "C" int stk_resblock_chain(const void* x, const void* fmask, const void* wa,
                                  const void* ba, const void* wb, const void* bb,
                                  void* out, int B, int Tlen, int C, int k, int P,
                                  const int* dils, int dtype, void* stream) {
  Dil dil = {};
  if (!read_args(dils, P, k, &dil)) return (int)cudaErrorInvalidValue;
  cudaStream_t st = (cudaStream_t)stream;
  const float* m = (const float*)fmask;
  const float* fa = (const float*)ba;
  const float* fb = (const float*)bb;
#define STK_LAUNCH(W)                                                                    \
  if (dtype == 0 && C == W)                                                              \
    return launch<float, W>(x, m, wa, fa, wb, fb, out, B, Tlen, P, k, dil, st);          \
  if (dtype == 1 && C == W)                                                              \
    return launch<bf16, W>(x, m, wa, fa, wb, fb, out, B, Tlen, P, k, dil, st);
  STK_CHAIN_WIDTHS(STK_LAUNCH)
#undef STK_LAUNCH
  return (int)cudaErrorInvalidValue;
}

// One conv of a pair that no fused kernel tiles, any reach: in/x/out
// [B,T,C], w [k,C,C] (HIO) in the storage type, bias [C] float, fmask [T]
// float or null; is_b 0: conv a at dilation d, out = silu(h) (in = x);
// is_b 1: conv b, out = x + its masked output (in = silu h).
extern "C" int stk_resblock_conv(const void* in, const void* x, const void* fmask,
                                 const void* w, const void* bias, void* out, int B, int Tlen,
                                 int C, int k, int d, int is_b, int dtype, void* stream) {
  if (k < 1 || k % 2 == 0 || d < 1) return (int)cudaErrorInvalidValue;
  cudaStream_t st = (cudaStream_t)stream;
  const float* m = (const float*)fmask;
  const float* bv = (const float*)bias;
#define STK_CONV(W)                                                                      \
  if (dtype == 0 && C == W)                                                              \
    return launch_conv<float, W>(in, x, m, w, bv, out, B, Tlen, k, d, is_b, st);         \
  if (dtype == 1 && C == W)                                                              \
    return launch_conv<bf16, W>(in, x, m, w, bv, out, B, Tlen, k, d, is_b, st);
  STK_CHAIN_WIDTHS(STK_CONV)
#undef STK_CONV
  return (int)cudaErrorInvalidValue;
}

// Output frames per block of the fused kernel that takes these arguments
// (bf16: the tensor-core kernel, f32: the SIMT kernel; at B x Tlen when
// both are > 0, else its largest tile), or -1 when it does not tile them.
extern "C" int stk_resblock_chain_tile(int C, int k, int P, const int* dils, int dtype, int B,
                                       int Tlen) {
  Dil dil = {};
  if (!read_args(dils, P, k, &dil)) return -1;
#define STK_TILE(W)                                                                       \
  if (dtype == 0 && C == W) return tile_frames<float, W>(dil, P, k, B, Tlen);             \
  if (dtype == 1 && C == W) return tile_frames<bf16, W>(dil, P, k, B, Tlen);
  STK_CHAIN_WIDTHS(STK_TILE)
#undef STK_TILE
  return -1;
}

// The largest reach of one conv pair that the fused kernels take at every
// instance in dtype (past it, a pair may need the per-conv form).
extern "C" int stk_resblock_chain_max_reach(int dtype) {
  return dtype == 0 ? MAX_REACH<float> : dtype == 1 ? MAX_REACH<bf16> : -1;
}

// The tensor-core kernel's layout at C, of its largest instance (half =
// 0) or of the one at half its frames: frames a block, consumer
// warpgroups, M tiles and panels a consumer, input channels a ring stage,
// ring stages, bytes of shared memory; into info[0..6]. Returns 0, or -1
// for no instance.
extern "C" int stk_resblock_chain_layout(int C, int half, int* info) {
#define STK_LAYOUT(CW) \
  if (C == CW) return layout_of<CW>(half, info);
  STK_CHAIN_WIDTHS(STK_LAYOUT)
#undef STK_LAYOUT
  return -1;
}
