// A design alternative of the bf16 resblock chain (csrc/resblock_chain.cu),
// not on the path: chain_wgmma launched as thread-block clusters of CLUSTER
// blocks on neighbouring time tiles of one batch row, each weight stage
// multicast by TMA into every block of the cluster (panel p issued by the
// block of rank p % CLUSTER), and a ring stage released to the producers of
// all the cluster's blocks by remote mbarrier arrivals. Otherwise the
// path's kernel as it stood when this alternative was measured slower than
// it (clusters of 2 and 4: kernel_variants.py, which builds this file as
// its cluster variants; PERF.md section 6). bf16 only; the entry takes the
// path library's arguments.
#include <type_traits>

#include "wgmma_gemm.cuh"

namespace stk {

// ---------------------------------------------------------------------------
// device: thread block clusters
// ---------------------------------------------------------------------------
// the same box into `dst` of every block of the cluster in `mask`, each
// completing its bytes on its own barrier at `bar`'s offset
__device__ __forceinline__ void tma_load_2d_multicast(void* dst, const CUtensorMap* map,
                                                      uint64_t* bar, int c0, int c1,
                                                      uint16_t mask) {
  asm volatile(
      "cp.async.bulk.tensor.2d.shared::cluster.global.mbarrier::complete_tx::bytes"
      ".multicast::cluster [%0], [%1, {%3, %4}], [%2], %5;\n" ::"r"(smem_u32(dst)),
      "l"(reinterpret_cast<uint64_t>(map)), "r"(smem_u32(bar)), "r"(c0), "r"(c1), "h"(mask)
      : "memory");
}
__device__ __forceinline__ uint32_t cluster_rank() {
  uint32_t r;
  asm volatile("mov.u32 %0, %%cluster_ctarank;\n" : "=r"(r));
  return r;
}
// (cluster_sync: wgmma.cuh's)
// one arrival on the mbarrier at `bar`'s offset in block `rank` of the cluster
__device__ __forceinline__ void mbar_arrive_cluster(uint64_t* bar, uint32_t rank) {
  asm volatile(
      "{\n.reg .b32 remote;\n"
      "mapa.shared::cluster.u32 remote, %0, %1;\n"
      "mbarrier.arrive.release.cluster.shared::cluster.b64 _, [remote];\n}\n" ::"r"(
          smem_u32(bar)),
      "r"(rank)
      : "memory");
}

}  // namespace stk

namespace {

using bf16 = __nv_bfloat16;
constexpr int MAX_P = 4;

struct Dil { int d[MAX_P]; };

// consumer warpgroups a block: WIDE_CONSUMERS where they split the M tiles
// and panels evenly, else two
constexpr int WIDE_CONSUMERS = 4;
// registers of the producer warpgroup (one thread issues): the rest go to
// the consumers (112 each of four, 224 each of two)
constexpr int PRODUCER_REGS = 24;
// blocks a cluster: neighbouring time tiles of one batch row, each weight
// stage multicast into all of them by TMA (kernel_variants.py builds 2 and 4)
constexpr int CLUSTER = 2;
static_assert(CLUSTER > 1 && CLUSTER <= 4, "a cluster of 2 to 4 blocks");
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
      stk::mbar_init(&empty[s], 4 * L::NC * CLUSTER);  // every consumer warp of the cluster
    }
    stk::mbar_fence_init();
  }
  __syncthreads();
  stk::cluster_sync();  // the peers' barriers are initialised

  if (wg == L::NC) {
    // producer: one thread streams stage s = rows [r KC, r KC + KC) of conv
    // s / NK's tap-major [k*C, C] weights (convs a, b, a, b, ...), r = s % NK;
    // panel p by the block of rank p % CLUSTER into every block
    stk::regs_dealloc<PRODUCER_REGS>();
    if (threadIdx.x % 128 == 0) {
      const uint32_t rank = stk::cluster_rank();
      for (int s = 0; s < steps; ++s) {
        const int st = s % NS, conv = s / NK;
        stk::mbar_wait(&empty[st], ((s / NS) & 1) ^ 1);
        stk::mbar_arrive_tx(&full[st], L::NP * L::PANEL);
        const CUtensorMap* map = (conv & 1) ? &tm_wb : &tm_wa;
        const int row = (conv >> 1) * k * C + (s % NK) * KC;
#pragma unroll
        for (int p = 0; p < L::NP; ++p) {
          if (p % CLUSTER == (int)rank)
            stk::tma_load_2d_multicast(ring + st * L::STAGE + p * L::PANEL, map, &full[st],
                                       64 * p, row, (uint16_t)((1 << CLUSTER) - 1));
        }
      }
    }
    // no block leaves while a peer may still write into it
    stk::cluster_sync();
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
  // their frame mask, 0 outside [0, T)
  float mrow[MT][2];
#pragma unroll
  for (int i = 0; i < MT; ++i)
#pragma unroll
    for (int h = 0; h < 2; ++h) {
      const int tg = t0 + (cm + L::CM * i) * 64 + 16 * warp + g + 8 * h;
      mrow[i][h] = (tg >= 0 && tg < Tlen) ? (fmask ? fmask[tg] : 1.0f) : 0.0f;
    }
  stk::named_bar_sync(1, L::NC * 128);

  float acc[MT][NPC][32];
  uint32_t a0[MT][KS][4], a1[MT][KS][4];  // A fragments, two banks
  auto release = [&](int s) {
    __syncwarp();
    if (lane == 0) {
#pragma unroll
      for (int r = 0; r < CLUSTER; ++r) stk::mbar_arrive_cluster(&empty[s % NS], r);
    }
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
        for (int i = 0; i < MT; ++i)
#pragma unroll
          for (int j = 0; j < NPC; ++j)
            stk::Wgmma<64>::template rs<1>(
                acc[i][j], a[i][kk],
                stk::desc_sw128(base + (cn * NPC + j) * L::PANEL + kk * 2048), r > 0 || kk > 0);
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
    for (int i = 0; i < MT; ++i)
#pragma unroll
      for (int j = 0; j < NPC; ++j) stk::fence_regs(acc[i][j]);

    // conv a: h = mask * round(acc + ba), store silu(h); conv b: x =
    // round(x + mask * round(acc + bb)), store x and silu(x). Rows g, g + 8
    // of the warp's 16, channels 2t, 2t + 1 of each n8 group, two a store.
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
            const float mf = mrow[i][h];
            const float v0 = stk::rnd<bf16>(acc[i][j][4 * jj + 2 * h] + bv.x) * mf;
            const float v1 = stk::rnd<bf16>(acc[i][j][4 * jj + 2 * h + 1] + bv.y) * mf;
            const int at = stk::swz<C>(f, c >> 3) + (c & 7);
            if (!is_b) {
              *reinterpret_cast<uint32_t*>(Hs + at) = silu_pair(v0, v1);
            } else {
              uint32_t* xp = reinterpret_cast<uint32_t*>(X + at);
              const float2 xf = __bfloat1622float2(*reinterpret_cast<const __nv_bfloat162*>(xp));
              const float x0 = stk::rnd<bf16>(xf.x + v0), x1 = stk::rnd<bf16>(xf.y + v1);
              *xp = stk::pack_bf16(x0, x1);
              if (!last)  // the last conv's silu(x) has no reader
                *reinterpret_cast<uint32_t*>(S + at) = silu_pair(x0, x1);
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
  stk::cluster_sync();
}

// halo = the chain's one-sided reach, W = frames a block holds (tile = W -
// 2*halo); W is 0 when the kernel does not tile the chain
struct Tiling { int halo, W; };

// the path's tiling: its largest W, or half of it (C <= 256) where that
// takes fewer waves of blocks at this shape
template <int C>
Tiling chain_tiling(const Dil& dil, int P, int k, int B, int Tlen) {
  const int hk = (k - 1) / 2;
  Tiling t = {0, 0};
  for (int i = 0; i < P; ++i) t.halo += dil.d[i] * hk + hk;
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
  return t;
}

template <int C, int W, int KT>
int launch_wgmma(const bf16* x, const float* m, const bf16* wa, const float* ba, const bf16* wb,
                 const float* bb, bf16* out, int B, int Tlen, int P, int k, Dil dil,
                 const Tiling& t, cudaStream_t st) {
  using L = WgLayout<C, W>;
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
  // a cluster's blocks take neighbouring tiles; blocks past the last tile
  // write nothing
  const int TT = t.W - 2 * t.halo;
  const int tiles = (Tlen + TT - 1) / TT;
  cudaLaunchConfig_t cfg = {};
  cfg.gridDim = dim3((tiles + CLUSTER - 1) / CLUSTER * CLUSTER, B);
  cfg.blockDim = dim3(L::THREADS);
  cfg.dynamicSmemBytes = L::BYTES;
  cfg.stream = st;
  cudaLaunchAttribute attr[1];
  attr[0].id = cudaLaunchAttributeClusterDimension;
  attr[0].val.clusterDim.x = CLUSTER;
  attr[0].val.clusterDim.y = 1;
  attr[0].val.clusterDim.z = 1;
  cfg.attrs = attr;
  cfg.numAttrs = 1;
  if (int err = (int)cudaLaunchKernelEx(&cfg, kernel, ta, tb, x, m, ba, bb, out, Tlen, P, k, dil,
                                        t.halo))
    return err;
  return (int)cudaGetLastError();
}

template <int C>
int launch(const void* x, const float* m, const void* wa, const float* ba, const void* wb,
           const float* bb, void* out, int B, int Tlen, int P, int k, Dil dil, cudaStream_t st) {
  const Tiling t = chain_tiling<C>(dil, P, k, B, Tlen);
  if (!t.W) return (int)cudaErrorInvalidValue;
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
}

}  // namespace

// The path library's stk_resblock_chain, bf16 (dtype 1) only.
extern "C" int stk_resblock_chain(const void* x, const void* fmask, const void* wa,
                                  const void* ba, const void* wb, const void* bb,
                                  void* out, int B, int Tlen, int C, int k, int P,
                                  const int* dils, int dtype, void* stream) {
  if (dtype != 1 || P < 1 || P > MAX_P || k < 1 || k % 2 == 0) return (int)cudaErrorInvalidValue;
  Dil dil = {};
  for (int i = 0; i < P; ++i) {
    if (dils[i] < 1) return (int)cudaErrorInvalidValue;
    dil.d[i] = dils[i];
  }
  cudaStream_t st = (cudaStream_t)stream;
#define STK_LAUNCH(W)                                                                       \
  if (C == W)                                                                               \
    return launch<W>(x, (const float*)fmask, wa, (const float*)ba, wb, (const float*)bb, out, \
                     B, Tlen, P, k, dil, st);
  STK_LAUNCH(64) STK_LAUNCH(128) STK_LAUNCH(192) STK_LAUNCH(256) STK_LAUNCH(320) STK_LAUNCH(384)
#undef STK_LAUNCH
  return (int)cudaErrorInvalidValue;
}
