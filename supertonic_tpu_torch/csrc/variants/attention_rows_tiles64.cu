// Not on the path: the whole-row form as first built: each consumer
// warpgroup's keys are up to four tiles of 64, S one m64n64k16 product
// group a tile (Q re-read from shared memory for each), and a row's keys
// are padded to 128 a warpgroup pair (Tk 448 computes 512).
// Only the whole-row form, at bf16 Dh 64, of csrc/attention.cu as it stood
// when this design was measured: kernel_variants.py builds and times it
// beside the committed kernel (the package builds csrc/*.cu only).
#include <type_traits>

#include "wgmma.cuh"

namespace {

using bf16 = __nv_bfloat16;
constexpr int DH = 64;  // columns of a panel: one 128-byte swizzled row
constexpr float LOG2E = 1.4426950408889634f;

// pins P's A fragments at this point (wgmma reads them asynchronously)
template <int KK>
__device__ __forceinline__ void fence_p(uint32_t (&p)[KK][4]) {
#pragma unroll
  for (int kk = 0; kk < KK; ++kk)
#pragma unroll
    for (int e = 0; e < 4; ++e) asm volatile("" : "+r"(p[kk][e])::"memory");
}

// ---------------------------------------------------------------------------
// the whole-row form (bf16, Dh 64, Tk <= ROW_KEYS): see the header
// ---------------------------------------------------------------------------
constexpr int ROW_TILES = 4;                       // key tiles of 64 a consumer warpgroup, at most
constexpr int ROW_KEYS = 2 * ROW_TILES * DH;       // the form's cap on Tk: 512
constexpr int ROW_THREADS = 3 * 128;               // two consumer warpgroups and the producer's
constexpr int ROW_BAR = 1;                         // the consumers' named barrier (256 threads)
template <int NT> constexpr int row_blocks() { return NT == 1 ? 2 : 1; }  // blocks an SM

// the block's shared memory: Q in two buffers, every key tile of K and V of
// the row (consumer c's tiles c NT .. c NT + NT - 1), the key bias, the
// consumers' row statistics, the partial O's they exchange and the output's
// staging
template <int NT>
struct RowSmem {
  bf16 q[2][64 * DH];
  bf16 k[2 * NT][64 * DH];
  bf16 v[2 * NT][64 * DH];
  bf16 o[64 * DH];           // the output tile, swizzled: each warpgroup its 32 columns
  float4 xch[2][4][8][32];   // each consumer thread's partial O (32 floats)
  float bias[2 * NT * 64];   // the key bias in log2 units, -inf past Tk
  float red_max[2][64], red_sum[2][64];  // each consumer's row max and row sum
  uint64_t k_full[2 * NT], v_full[2 * NT], q_full[2], q_empty[2];
};

// f(std::integral_constant<int, J>) for J = 0 .. N - 1, each J a constant
// expression (a wgmma wait count)
template <int N, int J = 0, typename F>
__device__ __forceinline__ void static_for(F&& f) {
  if constexpr (J < N) {
    f(std::integral_constant<int, J>{});
    static_for<N, J + 1>(f);
  }
}

// NT: key tiles of 64 a consumer warpgroup (the row's keys are tiles 0 ..
// 2 NT - 1); G: query tiles of 64 a block, all of one (batch, head)
template <int NT, int BPS>
__global__ void __launch_bounds__(ROW_THREADS, BPS)
attn_rows(__grid_constant__ const CUtensorMap tm_q, __grid_constant__ const CUtensorMap tm_k,
          __grid_constant__ const CUtensorMap tm_v, const float* __restrict__ mask,
          bf16* __restrict__ out, int Tq, int Tk, int H, float scale_log2, int G) {
  using Smem = RowSmem<NT>;
  extern __shared__ __align__(1024) unsigned char raw[];
  Smem& sm = *reinterpret_cast<Smem*>(raw + ((1024 - (stk::smem_u32(raw) & 1023)) & 1023));
  const int wg = threadIdx.x / 128, warp = (threadIdx.x / 32) & 3, lane = threadIdx.x & 31;
  const int b = blockIdx.z, h = blockIdx.y, qt0 = blockIdx.x * G;
  const int n_q = min(G, (Tq + 63) / 64 - qt0);  // this block's query tiles
  const int n_tiles = (Tk + DH - 1) / DH;         // key tiles holding keys below Tk
  if (threadIdx.x == 0) {
#pragma unroll
    for (int t = 0; t < 2 * NT; ++t) {
      stk::mbar_init(&sm.k_full[t], 32);  // the producer warp's lanes (the bias)
      stk::mbar_init(&sm.v_full[t], 1);
    }
#pragma unroll
    for (int i = 0; i < 2; ++i) {
      stk::mbar_init(&sm.q_full[i], 1);
      stk::mbar_init(&sm.q_empty[i], 8);  // each consumer warp
    }
    stk::mbar_fence_init();
  }
  __syncthreads();

  if (wg == 2) {
    // producer warpgroup: its first warp loads Q tile 0, every key tile of
    // K (the two consumers' tiles in turns) and of V once, then the block's
    // other Q tiles as the consumers free a buffer. A key tile wholly past
    // Tk (one, when the row's tiles are odd) is loaded from the last tile:
    // its bias is -inf, so its keys weigh 0.
    stk::regs_dealloc<stk::kProducerRegs>();
    if (warp != 0) return;
    auto key_row = [&](int t) { return DH * min(t, n_tiles - 1); };
    if (lane == 0) {
      stk::mbar_arrive_tx(&sm.q_full[0], 64 * DH * 2);
      stk::tma_load_4d(sm.q[0], &tm_q, &sm.q_full[0], 0, h, 64 * qt0, b);
#pragma unroll
      for (int j = 0; j < NT; ++j)
#pragma unroll
        for (int c = 0; c < 2; ++c) {
          const int t = c * NT + j;
          stk::mbar_expect_tx(&sm.k_full[t], DH * DH * 2);
          stk::tma_load_4d(sm.k[t], &tm_k, &sm.k_full[t], 0, h, key_row(t), b);
        }
#pragma unroll
      for (int j = 0; j < NT; ++j)
#pragma unroll
        for (int c = 0; c < 2; ++c) {
          const int t = c * NT + j;
          stk::mbar_arrive_tx(&sm.v_full[t], DH * DH * 2);
          stk::tma_load_4d(sm.v[t], &tm_v, &sm.v_full[t], 0, h, key_row(t), b);
        }
    }
    const float* mb = mask ? mask + (size_t)b * Tk : nullptr;
#pragma unroll
    for (int t = 0; t < 2 * NT; ++t) {
#pragma unroll
      for (int i = 0; i < 2; ++i) {
        const int kj = DH * t + lane + 32 * i;
        sm.bias[kj] = kj >= Tk ? -INFINITY : (mb ? (1.0f - mb[kj]) * (-1e9f * LOG2E) : 0.0f);
      }
      stk::mbar_arrive(&sm.k_full[t]);
    }
    if (lane == 0)
      for (int i = 1; i < n_q; ++i) {
        const int qb = i & 1;
        stk::mbar_wait(&sm.q_empty[qb], ((i >> 1) & 1) ^ 1);
        stk::mbar_arrive_tx(&sm.q_full[qb], 64 * DH * 2);
        stk::tma_load_4d(sm.q[qb], &tm_q, &sm.q_full[qb], 0, h, 64 * (qt0 + i), b);
      }
    return;
  }

  // consumer warpgroup c = wg: the keys of tiles c NT .. c NT + NT - 1 of
  // every query tile of the block; thread rows 16 warp + g and + 8 in the
  // wgmma accumulator layout (csrc/wgmma.cuh)
  stk::regs_alloc<stk::consumer_regs(2, BPS)>();
  const int c = wg, g = lane >> 2, t4 = lane & 3;
  const int row0 = 16 * warp + g;
  float s[NT][32], o[32];
  uint32_t pa[NT][4][4];
  const size_t rs = (size_t)H * DH;
  bf16* ob = out + (size_t)b * Tq * rs + (size_t)h * DH;

  for (int i = 0; i < n_q; ++i) {
    const int qb = i & 1;
    // S = Q.K^T of each own key tile, one commit group a tile
    stk::mbar_wait(&sm.q_full[qb], (i >> 1) & 1);
    const uint32_t q_addr = stk::smem_u32(sm.q[qb]);
#pragma unroll
    for (int j = 0; j < NT; ++j) {
      // the wait (a loop each thread leaves on its own) before the fence: a
      // fence with a wait between it and the products makes the compiler
      // serialise them
      stk::mbar_wait(&sm.k_full[c * NT + j], 0);
      const uint32_t k_addr = stk::smem_u32(sm.k[c * NT + j]);
      stk::wgmma_fence();
#pragma unroll
      for (int kk = 0; kk < DH / 16; ++kk)
        stk::Wgmma<DH>::template ss<0>(s[j], stk::desc_sw128(q_addr + 32 * kk),
                                       stk::desc_sw128(k_addr + 32 * kk), kk);
      stk::wgmma_commit();
    }
    // each tile, as its products complete: scale and bias in log2 units, the
    // row max over this thread's keys
    float mx[2] = {-INFINITY, -INFINITY};
    static_for<NT>([&](auto tile) {
      constexpr int j = decltype(tile)::value;
      stk::wgmma_wait<NT - 1 - j>();
      stk::fence_regs(s[j]);
      const float* bias = sm.bias + DH * (c * NT + j);
#pragma unroll
      for (int jj = 0; jj < 8; ++jj) {
        const float2 bj = *reinterpret_cast<const float2*>(bias + 8 * jj + 2 * t4);
        s[j][4 * jj] = fmaf(s[j][4 * jj], scale_log2, bj.x);
        s[j][4 * jj + 1] = fmaf(s[j][4 * jj + 1], scale_log2, bj.y);
        s[j][4 * jj + 2] = fmaf(s[j][4 * jj + 2], scale_log2, bj.x);
        s[j][4 * jj + 3] = fmaf(s[j][4 * jj + 3], scale_log2, bj.y);
        mx[0] = fmaxf(mx[0], fmaxf(s[j][4 * jj], s[j][4 * jj + 1]));
        mx[1] = fmaxf(mx[1], fmaxf(s[j][4 * jj + 2], s[j][4 * jj + 3]));
      }
    });
    // every product that read this Q tile has completed: free its buffer
    __syncwarp();
    if (lane == 0) stk::mbar_arrive(&sm.q_empty[qb]);
    // the row max over both warpgroups' keys (the quad's four threads, then
    // the other warpgroup's through shared memory). It is finite: key 0 is
    // below Tk and its bias finite.
    float m[2];
#pragma unroll
    for (int r = 0; r < 2; ++r) {
      mx[r] = fmaxf(mx[r], __shfl_xor_sync(0xffffffffu, mx[r], 1));
      mx[r] = fmaxf(mx[r], __shfl_xor_sync(0xffffffffu, mx[r], 2));
      if (t4 == 0) sm.red_max[c][row0 + 8 * r] = mx[r];
    }
    stk::named_bar_sync(ROW_BAR, 256);
#pragma unroll
    for (int r = 0; r < 2; ++r) m[r] = fmaxf(mx[r], sm.red_max[c ^ 1][row0 + 8 * r]);
    // one exponential a logit, kept in place; the row sums in short chains
    float part[2][4] = {};
#pragma unroll
    for (int j = 0; j < NT; ++j)
#pragma unroll
      for (int jj = 0; jj < 8; ++jj)
#pragma unroll
        for (int e = 0; e < 4; ++e) {
          float& x = s[j][4 * jj + e];
          x = stk::exp2_ftz(x - m[e >> 1]);
          part[e >> 1][(jj & 1) * 2 + (e & 1)] += x;
        }
    float inv_l[2];
#pragma unroll
    for (int r = 0; r < 2; ++r) {
      float l = (part[r][0] + part[r][1]) + (part[r][2] + part[r][3]);
      l += __shfl_xor_sync(0xffffffffu, l, 1);
      l += __shfl_xor_sync(0xffffffffu, l, 2);
      if (t4 == 0) sm.red_sum[c][row0 + 8 * r] = l;
    }
    stk::named_bar_sync(ROW_BAR, 256);
    // both warpgroups add the two sums in one order: the same 1 / sum
#pragma unroll
    for (int r = 0; r < 2; ++r)
      inv_l[r] = 1.0f / (sm.red_sum[0][row0 + 8 * r] + sm.red_sum[1][row0 + 8 * r]);
    // p = exp2(s - max) / sum rounded to bf16, repacked from the S
    // accumulators into wgmma's A fragments (key step kk = column groups 2kk
    // and 2kk + 1), O += P.V with V the MN-major B operand; a tile's P.V
    // products run on while the next tile's P is packed
#pragma unroll
    for (int j = 0; j < NT; ++j) {
#pragma unroll
      for (int kk = 0; kk < DH / 16; ++kk)
#pragma unroll
        for (int hh = 0; hh < 2; ++hh) {
          const float* x = s[j] + 4 * (2 * kk + hh);
          pa[j][kk][2 * hh] = stk::pack_bf16(x[0] * inv_l[0], x[1] * inv_l[0]);
          pa[j][kk][2 * hh + 1] = stk::pack_bf16(x[2] * inv_l[1], x[3] * inv_l[1]);
        }
      stk::mbar_wait(&sm.v_full[c * NT + j], 0);
      const uint32_t v_addr = stk::smem_u32(sm.v[c * NT + j]);
      stk::wgmma_fence();
#pragma unroll
      for (int kk = 0; kk < DH / 16; ++kk)
        stk::Wgmma<DH>::template rs<1>(o, pa[j][kk], stk::desc_sw128(v_addr + kk * 16 * DH * 2),
                                       j > 0 || kk > 0);
      stk::wgmma_commit();
    }
    stk::wgmma_wait<0>();
    stk::fence_regs(o);
#pragma unroll
    for (int j = 0; j < NT; ++j) fence_p(pa[j]);

    // the two partial O's summed in f32: warpgroup c finishes columns 32 c ..
    // 32 c + 31 of every row. Each thread writes its partial to shared
    // memory and reads back its own and the other warpgroup's same thread's
    // values of its half (every warp of a warpgroup on one path, no register
    // chosen by the warpgroup's index: either makes the compiler serialise
    // the products), rounds the sums to bf16 through the staging tile, and
    // each warp stores the half rows of its 16 in 16-byte stores.
    float4* mine = sm.xch[c][warp][0] + lane;
#pragma unroll
    for (int jj = 0; jj < 8; ++jj)
      mine[32 * jj] = make_float4(o[4 * jj], o[4 * jj + 1], o[4 * jj + 2], o[4 * jj + 3]);
    stk::named_bar_sync(ROW_BAR, 256);
    const float4* own = sm.xch[c][warp][4 * c] + lane;
    const float4* theirs = sm.xch[c ^ 1][warp][4 * c] + lane;
    const int r0 = 16 * warp;
#pragma unroll
    for (int jj = 0; jj < 4; ++jj) {
      const float4 x = own[32 * jj], y = theirs[32 * jj];
      *reinterpret_cast<uint32_t*>(sm.o + stk::swz<DH>(r0 + g, 4 * c + jj) + 2 * t4) =
          stk::pack_bf16(x.x + y.x, x.y + y.y);
      *reinterpret_cast<uint32_t*>(sm.o + stk::swz<DH>(r0 + g + 8, 4 * c + jj) + 2 * t4) =
          stk::pack_bf16(x.z + y.z, x.w + y.w);
    }
    __syncwarp();
#pragma unroll
    for (int it = 0; it < 2; ++it) {
      const int cc = lane + 32 * it, r = r0 + (cc >> 2), ch = 4 * c + (cc & 3);
      const int qi = 64 * (qt0 + i) + r;
      if (qi < Tq)
        *reinterpret_cast<uint4*>(ob + (size_t)qi * rs + ch * 8) =
            *reinterpret_cast<const uint4*>(sm.o + stk::swz<DH>(r, ch));
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

// the whole-row form: NT key tiles a consumer warpgroup; G query tiles a
// block, as many as leave about two blocks for every block slot of the card
// and no fewer than one, spread evenly over the (batch, head)'s blocks
template <int NT>
int launch_rows(const bf16* q, const bf16* k, const bf16* v, const float* mask, bf16* out,
                int B, int Tq, int Tk, int H, float scale_log2, cudaStream_t st) {
  constexpr int BPS = row_blocks<NT>();
  CUtensorMap tq, tk, tv;
  if (int err = encode_bthd(&tq, q, B, Tq, H, 64, DH)) return err;
  if (int err = encode_bthd(&tk, k, B, Tk, H, DH, DH)) return err;
  if (int err = encode_bthd(&tv, v, B, Tk, H, DH, DH)) return err;
  constexpr size_t smem = sizeof(RowSmem<NT>) + 1024;
  static_assert(smem * BPS <= 232448, "the blocks' shared memory");
  auto kernel = attn_rows<NT, BPS>;
  static size_t configured[stk::kMaxDevices] = {};
  if (int err = stk::allow_dynamic_smem(kernel, smem, configured)) return err;
  static int regs_at_entry = 0;
  if (int err = stk::check_reg_split(kernel, 128, 256, stk::consumer_regs(2, BPS),
                                     regs_at_entry))
    return err;
  int sms = 0;
  if (int err = stk::sm_count(sms)) return err;
  const int nq = (Tq + 63) / 64;
  const long long per_block = (long long)nq * H * B / (2LL * sms * BPS);
  int G = per_block < 1 ? 1 : per_block > nq ? nq : (int)per_block;
  G = (nq + (nq + G - 1) / G - 1) / ((nq + G - 1) / G);  // nq over that many blocks, evenly
  dim3 grid((nq + G - 1) / G, H, B);
  kernel<<<grid, ROW_THREADS, smem, st>>>(tq, tk, tv, mask, out, Tq, Tk, H, scale_log2, G);
  return (int)cudaGetLastError();
}

// bf16 at D = 64 only (the shapes kernel_variants.py times); other shapes are
// refused
int launch(const void* q, const void* k, const void* v, const float* mask, void* out,
           int B, int Tq, int Tk, int H, int D, int dtype, float scale, cudaStream_t st) {
  if (D != DH || dtype != 1 || Tk < 1) return (int)cudaErrorInvalidValue;
  const int nt = (Tk + 2 * DH - 1) / (2 * DH);  // key tiles a consumer warpgroup
  const bf16 *qb = (const bf16*)q, *kb = (const bf16*)k, *vb = (const bf16*)v;
  const float sl = scale * LOG2E;
  switch (nt) {
    case 1: return launch_rows<1>(qb, kb, vb, mask, (bf16*)out, B, Tq, Tk, H, sl, st);
    case 2: return launch_rows<2>(qb, kb, vb, mask, (bf16*)out, B, Tq, Tk, H, sl, st);
    case 3: return launch_rows<3>(qb, kb, vb, mask, (bf16*)out, B, Tq, Tk, H, sl, st);
    case 4: return launch_rows<4>(qb, kb, vb, mask, (bf16*)out, B, Tq, Tk, H, sl, st);
    default: return (int)cudaErrorInvalidValue;
  }
}

}  // namespace

extern "C" int stk_attention(const void* q, const void* k, const void* v,
                             const void* mask, void* out, int B, int Tq, int Tk,
                             int H, int D, int dtype, void* stream, float scale) {
  return launch(q, k, v, (const float*)mask, out, B, Tq, Tk, H, D, dtype, scale,
                (cudaStream_t)stream);
}
