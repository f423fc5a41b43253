// Not on the path: the mma.sync design that csrc/resblock_chain.cu replaced, kept whole
// so that kernel_variants.py can build it as its "earlier" variant (the
// package builds csrc/*.cu only).
//
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
// Tiling (both types): one block per (batch row, tile of TT output frames).
// The block holds W = TT + 2*halo frames (halo = the chain's one-sided
// reach, 16 for k=3 and dilations 1,3,9) in shared memory, zero outside
// [0, T), and runs all the convs between three shared buffers (x, silu(x),
// silu(h)) in the storage type. A buffer that a conv reads at shifted rows
// has zero pad rows on both sides (that conv's reach), so the reads stay
// inside it; the values they feed lie outside the exact region, whose
// frontier moves inward by each conv's reach, so after the chain the central
// TT frames are exact (the argument of the JAX kernel's docstring). Only the
// central tile is written. chain_tiling holds the layout and chooses W.
//
// Bound on the H100: 6 convs of 3*C*C multiply-adds per frame, 1.55 TFLOP
// at C=128 over 64 x 40,960 frames and 0.77 at C=256 over 64 x 5,120 (the
// path's b64 shapes), against two passes over the activation:
// compute-bound, on the tensor cores in bf16.
//
// bf16 design (chain_mma): each conv is an implicit GEMM [W frames, 3C] x
// [3C, C] on mma.sync.m16n8k16 (bf16 -> f32). 8 warps (one block an SM,
// up to 255 registers a thread) each own a 64-frame x 64-channel tile of
// the output, so each B fragment serves four A fragments and each A
// fragment eight B fragments; that sets W = 256 frames at C=128 and 128 at
// C=256 (TT 224 and 96). A fragments come by ldmatrix.x4
// straight from the input buffer at the tap's row offset (+-1, +-3, +-9
// rows), B fragments by ldmatrix.x4.trans from the [ci, co] weight stage.
// Every buffer and stage keeps rows of C bf16 with their 16-byte chunks
// XOR-swizzled by the row, so the eight rows of an ldmatrix at any offset
// hit eight distinct bank groups. Only the buffers read at shifted rows
// carry pad rows (silu x: the largest dilation; silu h: 1). The weights of
// the six convs stream as one sequence of KC-input-channel chunks (KC 32 at
// C=128, 16 at C=256) through a 3-stage cp.async ring, one block barrier a
// chunk; that barrier also orders each conv's epilogue before the next
// conv's reads. The epilogue works on the accumulator registers: bias,
// round, mask, silu, and bf16-pair stores into the swizzled buffers. silu
// here takes the fast exponential and division (__expf, __fdividef, a few
// f32 ulp before the bf16 rounding): with the accurate ones the kernel
// takes ~1.5x as long at C=128, and 16 warps of 32 x 64 (128 registers a
// thread) spill and run slower (kernel_variants.py).
//
// f32 (chain_kernel): SIMT, exact to f32 rounding, each thread 16 frames x 4
// channels, W the largest multiple of 16 whose buffers fit SMEM_BUDGET.
// Only the buffers read at shifted rows carry pad rows, as in bf16. Rows of
// more than 1 KB (f32 above C = 256) leave no room for three buffers past
// the halo: the kernel then keeps two (x, silu h) and takes silu(x) as it
// reads x. The SIMT kernel also runs bf16 chains that the tensor-core
// kernel does not take: a conv size other than 3, or a pad past its shared
// memory or a halo past its W.
//
// Domain: any odd conv size k and any dilations >= 1 whose one conv pair
// reaches at most MAX_REACH frames ((d + 1) * (k - 1) / 2; 23 in f32, 31 in
// bf16): static_asserts below hold every instance to a lone pair of that
// reach. The caller runs a longer chain, or one whose halo outgrows W, as
// consecutive launches over groups of pairs, each writing x for the next:
// the same values as one launch, since x between pairs is stored in the
// storage type either way and each launch zeroes frames outside [0, T).
//
// Widths: one instance per C in CHAIN_WIDTHS (multiples of 64 up to 384, the
// Pallas kernel's VMEM rule): the swizzle of 16-byte chunks by the row needs
// rows of a multiple of 8 chunks. The wrapper pads another C <= 384 with
// zero channels to the next instance: zero weights and biases keep the
// padded channels at exactly 0, so the real ones are as without them. In
// bf16 the 8 warps tile [W frames, C channels] as FG x CG warps of WM x WN
// (MmaLayout): C = 64 takes W = 512 frames; 192 and 384 warp tiles 48
// channels wide; 320 and 384 hold 64 frames, since the three buffers of
// [W, C] bf16 must fit in 227 KB. C = 128 and 256 keep the layout above.
#include <type_traits>

#include "common.cuh"

namespace {

using bf16 = __nv_bfloat16;
// K: the tensor-core kernel's conv size; the SIMT kernel takes any odd size
constexpr int NT = 256, TF = 16, K = 3, MAX_P = 4;

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
// SIMT (every f32 chain; bf16 chains the tensor-core kernel does not take)
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
// bf16 on the tensor cores
// ---------------------------------------------------------------------------
constexpr int MMA_NT = 256;        // 8 warps
constexpr int WM = 64, WN = 64;    // warp tile at C = 128 and 256: frames x output channels
constexpr int WSTAGES = 3;         // depth of the weight ring
constexpr int HPAD = (K - 1) / 2;  // pad rows of silu(h): conv b's reach
constexpr size_t MMA_SMEM_MAX = 232448;  // the most a block may have (227 KB)

template <int C>
struct MmaLayout {
  // the 8 warps as FG frame groups x CG channel groups, each warp WM frames x
  // WN output channels (WN a multiple of 16, one ldmatrix.x4.trans a step)
  static constexpr int CG = C == 64 ? 1 : C == 384 ? 8 : C == 192 || C == 320 ? 4 : C / WN;
  static constexpr int WN_ = C / CG;                  // 64, 64, 48, 64, 80, 48
  static constexpr int WM_ = C == 320 ? 32 : WM;
  static constexpr int FG = (MMA_NT / 32) / CG;
  static constexpr int MI = WM_ / 16, NJ = WN_ / 8;   // m16 and n8 tiles of a warp tile
  static constexpr int W = FG * WM_;                  // frames a block holds
  static constexpr int KC = C <= 128 ? 32 : 16;       // input channels a stage
  static constexpr int CH = C / 8;                        // 16-byte chunks a row
  static constexpr int NK = K * C / KC;                   // weight stages a conv
  static constexpr int STAGE = KC * C;                    // elements a stage
  // weight ring | x [W] | silu x [W + 2 pad] | silu h [W + 2 HPAD] | mask [W] f32
  static constexpr size_t bytes(int pad) {
    return ((size_t)WSTAGES * STAGE + (size_t)(3 * W + 2 * pad + 2 * HPAD) * C) *
               sizeof(bf16) + (size_t)W * sizeof(float);
  }
};

template <int C>
__global__ void __launch_bounds__(MMA_NT, 1)
chain_mma(const bf16* __restrict__ x, const float* __restrict__ fmask,
          const bf16* __restrict__ wa, const float* __restrict__ ba,
          const bf16* __restrict__ wb, const float* __restrict__ bb,
          bf16* __restrict__ out, int Tlen, int P, Dil dil, int halo, int pad) {
  using L = MmaLayout<C>;
  constexpr int W = L::W, KC = L::KC, CH = L::CH, NK = L::NK;
  constexpr int MI = L::MI, NJ = L::NJ, WM = L::WM_, WN = L::WN_;
  static_assert(L::FG * L::CG == MMA_NT / 32 && WN % 16 == 0 && C % KC == 0, "warp tiling");
  extern __shared__ __align__(128) unsigned char smem[];
  bf16* ring = reinterpret_cast<bf16*>(smem);
  bf16* X = ring + WSTAGES * L::STAGE;  // row f: frame f
  bf16* S = X + W * C;                  // row f + pad: frame f
  bf16* Hs = S + (W + 2 * pad) * C;     // row f + HPAD: frame f
  float* M = reinterpret_cast<float*>(Hs + (W + 2 * HPAD) * C);
  const int tid = threadIdx.x, warp = tid >> 5, lane = tid & 31;
  const int g = lane >> 2, t = lane & 3;
  const int TT = W - 2 * halo;
  const int b = blockIdx.y, t0 = blockIdx.x * TT - halo;
  const int f0 = (warp / L::CG) * WM, n0 = (warp % L::CG) * WN;
  const int steps = 2 * P * NK;

  // weight stage s: conv s / NK (a, b, a, b, ...), rows [r KC, r KC + KC) of
  // its tap-major [K*C, C] weights, r = s % NK
  auto load_w = [&](int s) {
    const int conv = s / NK, r = s % NK;
    const bf16* src = ((conv & 1) ? wb : wa) + (size_t)(conv >> 1) * K * C * C +
                      (size_t)r * L::STAGE;
    bf16* dst = ring + (s % WSTAGES) * L::STAGE;
    for (int c = tid; c < KC * CH; c += MMA_NT) {
      const int row = c / CH, ch = c % CH;
      stk::cp_async16(stk::smem_u32(dst + stk::swz<C>(row, ch)), src + row * C + ch * 8,
                      true);
    }
  };
#pragma unroll
  for (int s = 0; s < WSTAGES - 1; ++s) {  // in flight while the window loads
    load_w(s);
    stk::cp_async_commit();
  }

  // the window: x and silu(x), zero outside [0, T); zero pad rows; the mask
  const bf16* xb = x + (size_t)b * Tlen * C;
  for (int e = tid; e < W * CH; e += MMA_NT) {
    const int f = e / CH, ch = e % CH, tg = t0 + f;
    uint4 v = make_uint4(0, 0, 0, 0);
    if (tg >= 0 && tg < Tlen) v = *reinterpret_cast<const uint4*>(xb + (size_t)tg * C + ch * 8);
    *reinterpret_cast<uint4*>(X + stk::swz<C>(f, ch)) = v;
    uint32_t* pr = reinterpret_cast<uint32_t*>(&v);
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      const float2 xf = __bfloat1622float2(*reinterpret_cast<__nv_bfloat162*>(&pr[i]));
      pr[i] = stk::pack_bf16(stk::silu_fast(xf.x), stk::silu_fast(xf.y));
    }
    *reinterpret_cast<uint4*>(S + stk::swz<C>(f + pad, ch)) = v;
  }
  const uint4 zero = make_uint4(0, 0, 0, 0);
  for (int e = tid; e < pad * CH; e += MMA_NT) {
    reinterpret_cast<uint4*>(S)[e] = zero;
    reinterpret_cast<uint4*>(S + (size_t)(W + pad) * C)[e] = zero;
  }
  for (int e = tid; e < HPAD * CH; e += MMA_NT) {
    reinterpret_cast<uint4*>(Hs)[e] = zero;
    reinterpret_cast<uint4*>(Hs + (size_t)(W + HPAD) * C)[e] = zero;
  }
  for (int f = tid; f < W; f += MMA_NT) {
    const int tg = t0 + f;
    M[f] = (tg >= 0 && tg < Tlen) ? (fmask ? fmask[tg] : 1.0f) : 0.0f;
  }

  float acc[MI][NJ][4];  // [m16 tile][n8 tile][fragment]
  auto clear = [&]() {
#pragma unroll
    for (int i = 0; i < MI; ++i)
#pragma unroll
      for (int j = 0; j < NJ; ++j) acc[i][j][0] = acc[i][j][1] = acc[i][j][2] = acc[i][j][3] = 0.0f;
  };
  // conv a: h = mask * round(acc + ba), store silu(h); conv b: x = round(x +
  // mask * round(acc + bb)), store x and silu(x). Rows g, g + 8 of each m16
  // tile, channels 2t, 2t + 1 of each n8 tile, two channels a store.
  auto epilogue = [&](int conv) {
    const bool is_b = conv & 1;
    const float* bias = (is_b ? bb : ba) + (conv >> 1) * C;
#pragma unroll
    for (int j = 0; j < NJ; ++j) {
      const int c = n0 + j * 8 + 2 * t;
      const float2 bv = *reinterpret_cast<const float2*>(bias + c);
#pragma unroll
      for (int i = 0; i < MI; ++i)
#pragma unroll
        for (int hh = 0; hh < 2; ++hh) {
          const int f = f0 + i * 16 + g + 8 * hh;
          const float mf = M[f];
          const float v0 = stk::rnd<bf16>(acc[i][j][2 * hh] + bv.x) * mf;
          const float v1 = stk::rnd<bf16>(acc[i][j][2 * hh + 1] + bv.y) * mf;
          if (!is_b) {
            *reinterpret_cast<uint32_t*>(Hs + stk::swz<C>(f + HPAD, c >> 3) + (c & 7)) =
                stk::pack_bf16(stk::silu_fast(v0), stk::silu_fast(v1));
          } else {
            uint32_t* xp = reinterpret_cast<uint32_t*>(X + stk::swz<C>(f, c >> 3) + (c & 7));
            const float2 xf = __bfloat1622float2(*reinterpret_cast<const __nv_bfloat162*>(xp));
            const float x0 = stk::rnd<bf16>(xf.x + v0), x1 = stk::rnd<bf16>(xf.y + v1);
            *xp = stk::pack_bf16(x0, x1);
            *reinterpret_cast<uint32_t*>(S + stk::swz<C>(f + pad, c >> 3) + (c & 7)) =
                stk::pack_bf16(stk::silu_fast(x0), stk::silu_fast(x1));
          }
        }
    }
  };

  clear();
  for (int s = 0; s < steps; ++s) {
    // stage s has landed for every thread and stage s - 1 (with the epilogue
    // of a finished conv) is done by every warp
    stk::cp_async_wait<WSTAGES - 2>();
    __syncthreads();
    if (s + WSTAGES - 1 < steps) load_w(s + WSTAGES - 1);
    stk::cp_async_commit();
    const int conv = s / NK, r = s % NK, tap = r / (C / KC), kc = (r % (C / KC)) * KC;
    const bool is_b = conv & 1;
    const int off = (tap - (K - 1) / 2) * (is_b ? 1 : dil.d[conv >> 1]);
    const bf16* in = is_b ? Hs : S;
    const int row0 = (is_b ? HPAD : pad) + f0 + off;  // the warp's first input row
    const bf16* ws = ring + (s % WSTAGES) * L::STAGE;
#pragma unroll
    for (int kk = 0; kk < KC / 16; ++kk) {
      // A: matrices frames (0-7 | 8-15) x channels (low | high 8 of the step)
      uint32_t a[MI][4];
#pragma unroll
      for (int i = 0; i < MI; ++i)
        stk::ldmatrix_x4(a[i], stk::smem_u32(in + stk::swz<C>(row0 + i * 16 + (lane & 15),
                                                              (kc >> 3) + kk * 2 + (lane >> 4))));
#pragma unroll
      for (int jp = 0; jp < WN / 16; ++jp) {
        // B: matrices input channels (0-7 | 8-15) x output channels 16jp + (0-7 | 8-15)
        uint32_t bw[4];
        const int row = kk * 16 + (((lane >> 3) & 1) << 3) + (lane & 7);
        stk::ldmatrix_x4_trans(bw, stk::smem_u32(ws + stk::swz<C>(row, (n0 >> 3) + jp * 2 +
                                                                       (lane >> 4))));
#pragma unroll
        for (int i = 0; i < MI; ++i) {
          stk::mma_bf16(acc[i][2 * jp], a[i], bw[0], bw[1]);
          stk::mma_bf16(acc[i][2 * jp + 1], a[i], bw[2], bw[3]);
        }
      }
    }
    if (r == NK - 1) {
      epilogue(conv);
      clear();
    }
  }
  __syncthreads();

  bf16* ob = out + (size_t)b * Tlen * C;
  for (int e = tid; e < TT * CH; e += MMA_NT) {
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
// a (the pad of silu x), hk = a conv b's reach, W = frames a block holds
// (tile = W - 2*halo), mma: the tensor-core kernel runs it.
struct Tiling { int halo, pad, hk, W; bool mma; };

template <typename T, int C>
Tiling chain_tiling(const Dil& dil, int P, int k) {
  const int hk = (k - 1) / 2;
  Tiling t = {0, 0, hk, 0, false};
  for (int i = 0; i < P; ++i) {
    t.halo += dil.d[i] * hk + hk;
    t.pad = dil.d[i] * hk > t.pad ? dil.d[i] * hk : t.pad;
  }
  if constexpr (std::is_same<T, bf16>::value) {
    if (k == K && MmaLayout<C>::bytes(t.pad) <= MMA_SMEM_MAX && MmaLayout<C>::W > 2 * t.halo) {
      t.W = MmaLayout<C>::W;
      t.mma = true;
      return t;
    }
  }
  t.W = simt_frames<T, C>(t.pad + hk);
  return t;
}

template <typename T, int C>
int launch(const void* x, const float* m, const void* wa, const float* ba,
           const void* wb, const float* bb, void* out, int B, int Tlen, int P, int k,
           Dil dil, cudaStream_t st) {
  static_assert(simt_frames<T, C>(MAX_REACH<T>) > 2 * MAX_REACH<T>,
                "every instance takes a lone conv pair of MAX_REACH");
  const Tiling t = chain_tiling<T, C>(dil, P, k);
  if (t.W <= 2 * t.halo) return (int)cudaErrorInvalidValue;
  const int TT = t.W - 2 * t.halo;
  dim3 grid((Tlen + TT - 1) / TT, B);
  if constexpr (std::is_same<T, bf16>::value) {
    if (t.mma) {
      static size_t configured[stk::kMaxDevices] = {};
      const size_t bytes = MmaLayout<C>::bytes(t.pad);
      if (int err = stk::allow_dynamic_smem(chain_mma<C>, bytes, configured)) return err;
      chain_mma<C><<<grid, MMA_NT, bytes, st>>>((const bf16*)x, m, (const bf16*)wa, ba,
                                                (const bf16*)wb, bb, (bf16*)out, Tlen, P,
                                                dil, t.halo, t.pad);
      return (int)cudaGetLastError();
    }
  }
  static size_t configured[stk::kMaxDevices] = {};
  const size_t bytes = smem_bytes<T, C>(t.W, t.pad + t.hk);
  if (int err = stk::allow_dynamic_smem(chain_kernel<T, C>, bytes, configured)) return err;
  chain_kernel<T, C><<<grid, NT, bytes, st>>>((const T*)x, m, (const T*)wa, ba, (const T*)wb,
                                              bb, (T*)out, Tlen, P, k, dil, t.W, t.halo,
                                              t.pad);
  return (int)cudaGetLastError();
}

template <typename T, int C>
int tile_frames(Dil dil, int P, int k, int* mma) {
  const Tiling t = chain_tiling<T, C>(dil, P, k);
  if (mma) *mma = t.mma;
  return t.W > 2 * t.halo ? t.W - 2 * t.halo : -1;
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

// Output frames per block the kernel uses for these arguments, or -1; *mma
// (when not null): whether the tensor-core kernel runs them.
extern "C" int stk_resblock_chain_tile(int C, int k, int P, const int* dils, int dtype,
                                       int* mma) {
  Dil dil = {};
  if (!read_args(dils, P, k, &dil)) return -1;
#define STK_TILE(W)                                                        \
  if (dtype == 0 && C == W) return tile_frames<float, W>(dil, P, k, mma);  \
  if (dtype == 1 && C == W) return tile_frames<bf16, W>(dil, P, k, mma);
  STK_CHAIN_WIDTHS(STK_TILE)
#undef STK_TILE
  return -1;
}

// The largest reach of one conv pair that every instance takes in dtype.
extern "C" int stk_resblock_chain_max_reach(int dtype) {
  return dtype == 0 ? MAX_REACH<float> : dtype == 1 ? MAX_REACH<bf16> : -1;
}
