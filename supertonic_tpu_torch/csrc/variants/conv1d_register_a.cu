// Not on the path: the conv kernel's design with A in registers (ldmatrix at
// each tap's shifted row of XOR-swizzled windows, two banks), measured
// against the committed one by kernel_variants.py conv1d (the package
// builds csrc/*.cu only).
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
// bf16 design (conv_wgmma), on Hopper's own instructions; it reuses what
// resblock_chain.cu's chain_wgmma proves (A by ldmatrix at a tap's shifted
// row of an XOR-swizzled buffer, B by TMA through an mbarrier ring) but
// not its structure. A block is two consumer warpgroups and one producer
// warpgroup; it owns BM output frames of one batch row and NP 64-column
// panels of the output channels: NP = 2 and one 64-row M tile a consumer
// (BM 128), or at Cout <= 64 (the head) NP = 1 and two M tiles (BM 256),
// 64 accumulator registers a consumer either way (the kernel compiles to
// 168 registers a thread; NP = 4 spilled and ptxas serialised its wgmma,
// C7512). The input channels go in chunks of KC = 64. The producer's warp
// 0 streams the tap's [64 input channels, NP * 64 outputs] slices of the
// weights ([k Cin, Cout] row-major) through a ring of STAGES stages, one
// thread running ahead across chunks; its warps 1-3 stage each chunk's
// window, BM + (k - 1) d frames x 64 channels, into a ring of up to four
// buffers by cp.async (zero-filled outside [0, T) and past Cin: SAME
// padding with no copy), then silu in place (the fast exponential and
// division, a few f32 ulp before the bf16 rounding, as the chain kernel's),
// and hand it over on the buffer's mbarrier, each warp's copies two chunks
// ahead of the silu it runs; the consumers give a buffer back once its A
// fragments are loaded, so staging runs up to four chunks ahead of the
// products.
// A consumer runs one stage a tap: A by ldmatrix at the tap's shifted row,
// one wgmma m64 x (NP 64) x k16 a k-step with A from registers and B
// MN-major across the stage's panels (the descriptor's LBO), f32
// accumulators, one group of products in flight; the A registers take two
// banks alternating by tap, and chunks run in pairs (their count padded to
// even with a zero chunk) so that a chunk never waits for the last products
// of the one before. The K sum runs in a fixed order (channel chunk, tap,
// the product's 16 channels): no split of K, so an output is the same
// whatever tile it lands in (windowed vocoding equals whole vocoding, a
// graph replay equals eager).
// The epilogue adds the f32 bias to the f32 sum, rounds once, takes
// silu_out in the registers and writes the rounded tile into the ring and
// windows (free by then); the 256 consumer threads then store it in
// 16-byte row chunks, reading the mask and the residual in the same
// coalesced chunks, so the next kernel reads [B, T, Cout] (or [B, T f,
// Cout / f]) with no copy.
// Zero padding: a chunk past Cin reads zero activations (the weights it
// meets there belong to the next tap, or are TMA's zero fill past k Cin
// rows); panels past Cout are not loaded and their columns not stored.
//
// f32 (conv_simt): SIMT, exact f32 FMA (no TF32), 128 frames x 64 output
// channels a block of 256 threads, each 8 frames x 4 channels; each chunk
// of 32 input channels is staged once for all taps, silu applied; the
// weights are read from device memory (L1). The same epilogue.
//
// Domain (ops/conv1d.py supports): Cin and Cout in multiples of 8 (16-byte
// rows), an odd k whose reach (k - 1) d is at most MAX_SPAN = 128 frames
// (the window's slack), bf16 at k 3, 5 or 7 (an instance each: the taps
// are unrolled so that the A registers alternate at compile time), f32 any
// odd k. A masked fold takes Cout / fold in multiples of 8.
#include <type_traits>

#include "elementwise.cuh"
#include "wgmma.cuh"

namespace {

using bf16 = __nv_bfloat16;

constexpr int MAX_SPAN = 128;

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
// already biased, rounded and through silu_out: the mask, the residual and
// the store
template <typename T, int N>
__device__ __forceinline__ void finish(float (&v)[N], const Epi& e, int b, int tg, int n,
                                       int Tlen, int Cout) {
  const size_t off = ((size_t)b * Tlen + tg) * Cout + n;
  if (e.mask) {
    const int fine = tg * e.fold + n / (Cout / e.fold);
    const float m = stk::rnd<T>(e.mask[b * e.mstride + fine]);
#pragma unroll
    for (int i = 0; i < N; ++i) v[i] = stk::rnd<T>(__fmul_rn(v[i], m));
  }
  if (e.res) {
    float r[N];
    stk::load_n<T, N>(static_cast<const T*>(e.res) + off, r);
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

// the sum's first rounding and silu_out
template <typename T>
__device__ __forceinline__ float first(float acc, float bias, int silu_out) {
  float v = stk::rnd<T>(__fadd_rn(acc, bias));
  return silu_out ? stk::rnd<T>(stk::silu_f(v)) : v;
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
    float v[4];
#pragma unroll
    for (int i = 0; i < 4; ++i) v[i] = first<float>(acc[j][i], bv[i], e.silu_out);
    finish<float, 4>(v, e, b, tg, n, Tlen, Cout);
  }
}

// ---------------------------------------------------------------------------
// bf16 on the tensor cores
// ---------------------------------------------------------------------------
constexpr int KC = 64;                   // input channels a chunk (B rows a stage)
constexpr int NCONS = 2;                 // consumer warpgroups
constexpr int THREADS = (NCONS + 1) * 128;
constexpr int CONSUMERS = NCONS * 128;
constexpr int STAGERS = 96;              // the producer warpgroup's warps 1-3: the windows
constexpr int STAGES = 4;
constexpr int PANEL = KC * 128;          // bytes of a stage's 64-column panel

// NP 64-column panels of the output a block, MT 64-row M tiles a consumer:
// 64 accumulator registers a consumer either way (the compiled kernel has
// 168 registers a thread: 384 threads, one block an SM)
template <int NP, int MT>
struct Layout {
  static constexpr int BM = 64 * MT * NCONS;        // output frames a block
  static constexpr int WROWS = BM + MAX_SPAN;       // window rows a buffer
  static constexpr int STAGE = NP * PANEL;
  static constexpr int TS = NP * 64 + 8;            // the epilogue tile's row, padded
  static constexpr size_t WIN = (size_t)WROWS * 128;  // bytes of a window buffer
  // window buffers: as many as fit beside the ring, up to 4
  static constexpr int NW =
      (232448 - 2048 - (size_t)STAGES * STAGE) / WIN < 4
          ? (int)((232448 - 2048 - (size_t)STAGES * STAGE) / WIN) : 4;
  // slack for the 1024-byte alignment | ring | windows | barriers: full,
  // empty (the ring), window full, window empty
  static constexpr size_t BYTES =
      1024 + (size_t)STAGES * STAGE + NW * WIN + 8 * (2 * STAGES + 2 * NW);
  // the staging warps copy two chunks ahead of the one they hand over
  static_assert(NW >= 3 && BYTES <= 232448, "shared memory");
  static_assert((size_t)BM * TS * 2 <= (size_t)STAGES * STAGE + NW * WIN,
                "the epilogue tile in the ring and windows");
};

template <int NP, int MT, int KT>
__global__ void __launch_bounds__(THREADS, 1)
conv_wgmma(__grid_constant__ const CUtensorMap tm_w, const bf16* __restrict__ x, Epi e, int Tlen,
           int Cin, int Cout, int d, int silu_in) {
  using L = Layout<NP, MT>;
  constexpr int BM = L::BM, WROWS = L::WROWS;
  extern __shared__ __align__(1024) unsigned char raw[];
  uint8_t* ring = raw + ((1024 - (stk::smem_u32(raw) & 1023)) & 1023);
  constexpr int NW = L::NW;
  bf16* win = reinterpret_cast<bf16*>(ring + STAGES * L::STAGE);  // NW [WROWS][64]
  uint64_t* full = reinterpret_cast<uint64_t*>(win + NW * WROWS * 64);
  uint64_t* empty = full + STAGES;
  uint64_t* wfull = empty + STAGES;  // [NW]: a window staged
  uint64_t* wempty = wfull + NW;     // [NW]: a window read
  const int wg = threadIdx.x / 128, warp = (threadIdx.x / 32) & 3, lane = threadIdx.x & 31;
  const int t0 = blockIdx.x * BM, n0 = blockIdx.y * NP * 64, b = blockIdx.z;
  // chunks of KC input channels, padded to an even count (the consumers
  // run them in pairs; a chunk past Cin reads zero activations)
  const int nch = ((Cin + KC - 1) / KC + 1) / 2 * 2, steps = nch * KT;
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

  if (wg == NCONS) {
    if (warp == 0) {
      // one thread streams stage s = rows [tap Cin + c KC, + KC) of the
      // [k Cin, Cout] weights, c = s / KT, tap = s % KT; only the panels
      // that hold output channels
      if (lane == 0) {
        const int panels = min(NP, (Cout - n0 + 63) / 64);
        for (int s = 0; s < steps; ++s) {
          const int st = s % STAGES;
          stk::mbar_wait(&empty[st], ((s / STAGES) & 1) ^ 1);
          stk::mbar_arrive_tx(&full[st], panels * PANEL);
          // a zero chunk's stages take rows 0.. (finite weights: its
          // activations are zero)
          const int c = s / KT;
          const int row = c * KC < Cin ? (s % KT) * Cin + c * KC : 0;
          for (int p = 0; p < panels; ++p)
            stk::tma_load_2d(ring + st * L::STAGE + p * PANEL, &tm_w, &full[st], n0 + 64 * p,
                             row);
        }
      }
      return;
    }
    // warps 1-3 stage chunk c's window into buffer c % NW: row r = frame t0 -
    // pad + r, 16-byte chunk ch = channels c KC + 8 ch, zero outside [0, T)
    // and past Cin, by cp.async, two chunks ahead of the one they finish:
    // silu in place over the same chunks, then the hand-over
    const int st_id = threadIdx.x - CONSUMERS - 32;
    const bf16* xb = x + (size_t)b * Tlen * Cin;
    auto issue = [&](int c) {
      const int buf = c % NW;
      stk::mbar_wait(&wempty[buf], ((c / NW) & 1) ^ 1);
      bf16* wb = win + buf * WROWS * 64;
      for (int el = st_id; el < nrows * 8; el += STAGERS) {
        const int r = el >> 3, ch = el & 7, tg = t0 - pad + r, ci = c * KC + ch * 8;
        const bool valid = tg >= 0 && tg < Tlen && ci < Cin;
        stk::cp_async16(stk::smem_u32(wb + stk::swz<64>(r, ch)),
                        valid ? xb + (size_t)tg * Cin + ci : xb, valid);
      }
      stk::cp_async_commit();
    };
    issue(0);
    issue(1);  // nch is even
    for (int c = 0; c < nch; ++c) {
      if (c + 2 < nch) {
        issue(c + 2);
        stk::cp_async_wait<2>();
      } else if (c + 1 < nch) {
        stk::cp_async_wait<1>();
      } else {
        stk::cp_async_wait<0>();
      }
      const int buf = c % NW;
      if (silu_in) {
        bf16* wb = win + buf * WROWS * 64;
#pragma unroll 4
        for (int el = st_id; el < nrows * 8; el += STAGERS) {
          uint4* q = reinterpret_cast<uint4*>(wb + stk::swz<64>(el >> 3, el & 7));
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
      __syncwarp();
      if (lane == 0) stk::mbar_arrive(&wfull[buf]);
    }
    return;
  }

  float acc[MT][NP * 32];
  uint32_t a0[MT][4][4], a1[MT][4][4];  // A fragments of a stage's four k16 steps, two banks
  auto release = [&](uint64_t* bar) {
    __syncwarp();
    if (lane == 0) stk::mbar_arrive(bar);
  };
  const uint32_t ring_u32 = stk::smem_u32(ring);
  int step = 0;
  // one stage a tap: A at the tap's row offset, then the stage's products
  // (m64 x NP*64 x k16, B across the NP panels); the previous stage's are
  // complete on return (its stage released, its A bank free)
  auto mma_step = [&](const bf16* wb, bool first, int tap, uint32_t (&a)[MT][4][4]) {
    const int st = step % STAGES;
#pragma unroll
    for (int i = 0; i < MT; ++i)
#pragma unroll
      for (int kk = 0; kk < 4; ++kk)
        stk::ldmatrix_x4(a[i][kk], stk::smem_u32(wb + stk::swz<64>(
                                       (wg * MT + i) * 64 + 16 * warp + (lane & 15) + tap * d,
                                       2 * kk + (lane >> 4))));
    stk::mbar_wait(&full[st], (step / STAGES) & 1);
    const uint32_t base = ring_u32 + st * L::STAGE;
    stk::wgmma_fence();
#pragma unroll
    for (int kk = 0; kk < 4; ++kk)
#pragma unroll
      for (int i = 0; i < MT; ++i)
        stk::Wgmma<NP * 64>::template rs<1>(acc[i], a[i][kk],
                                            stk::desc_sw128_mn(base + kk * 2048, PANEL),
                                            !first || tap > 0 || kk > 0);
    stk::wgmma_commit();
    stk::wgmma_wait<1>();
    if (step > 0) release(&empty[(step - 1) % STAGES]);
    ++step;
  };
  // chunk c: its KT stages, the A banks alternating by tap and starting on
  // the bank the chunk before did not end on (ODD = c % 2 and an odd KT),
  // so no chunk waits for the last products of the one before
  auto chunk = [&](int c, auto odd) {
    constexpr int ODD = decltype(odd)::value;
    const int buf = c % NW;
    const bf16* wb = win + buf * WROWS * 64;
    stk::mbar_wait(&wfull[buf], (c / NW) & 1);
#pragma unroll
    for (int tap = 0; tap < KT; ++tap) {
      if (((tap + ODD) & 1) == 0)
        mma_step(wb, c == 0, tap, a0);
      else
        mma_step(wb, c == 0, tap, a1);
    }
    release(&wempty[buf]);  // its A fragments are loaded (ldmatrix is synchronous)
  };
  for (int c = 0; c < nch; c += 2) {
    chunk(c, std::integral_constant<int, 0>());
    chunk(c + 1, std::integral_constant<int, KT & 1>());
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
  // the tile in 16-byte row chunks: mask, residual, store
  const int tid = threadIdx.x;
  for (int el = tid; el < BM * NP * 8; el += CONSUMERS) {
    const int row = el / (NP * 8), cc = el % (NP * 8);
    const int tg = t0 + row, n = n0 + cc * 8;
    if (tg >= Tlen || n >= Cout) continue;
    float v[8];
    stk::load_n<bf16, 8>(tile + row * L::TS + cc * 8, v);
    finish<bf16, 8>(v, e, b, tg, n, Tlen, Cout);
  }
}

// ---------------------------------------------------------------------------
// launch
// ---------------------------------------------------------------------------

template <int NP, int MT, int KT>
int launch_wgmma(const bf16* x, const bf16* w, const Epi& e, int B, int Tlen, int Cin, int Cout,
                 int d, int silu_in, cudaStream_t st) {
  using L = Layout<NP, MT>;
  // the weights [k Cin, Cout], boxes of 64 rows x 64 columns; encoded at
  // every launch: a graph capture keeps this launch's map
  CUtensorMap tm;
  const cuuint64_t dims[2] = {(cuuint64_t)Cout, (cuuint64_t)KT * Cin};
  const cuuint64_t strides[1] = {(cuuint64_t)Cout * sizeof(bf16)};
  const cuuint32_t box[2] = {64, (cuuint32_t)KC};
  if (int err = stk::encode_tma(&tm, w, 2, dims, strides, box)) return err;
  auto kernel = conv_wgmma<NP, MT, KT>;
  static size_t configured[stk::kMaxDevices] = {};
  if (int err = stk::allow_dynamic_smem(kernel, L::BYTES, configured)) return err;
  dim3 grid((Tlen + L::BM - 1) / L::BM, (Cout + NP * 64 - 1) / (NP * 64), B);
  kernel<<<grid, THREADS, L::BYTES, st>>>(tm, x, e, Tlen, Cin, Cout, d, silu_in);
  return (int)cudaGetLastError();
}

// 64 output channels a block and two M tiles a consumer at Cout <= 64 (the
// head), else 128 channels and one M tile
template <int KT>
int launch_bf16(const bf16* x, const bf16* w, const Epi& e, int B, int Tlen, int Cin, int Cout,
                int d, int silu_in, cudaStream_t st) {
  if (Cout <= 64) return launch_wgmma<1, 2, KT>(x, w, e, B, Tlen, Cin, Cout, d, silu_in, st);
  return launch_wgmma<2, 1, KT>(x, w, e, B, Tlen, Cin, Cout, d, silu_in, st);
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
