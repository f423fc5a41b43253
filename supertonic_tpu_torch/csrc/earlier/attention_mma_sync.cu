// Not on the path: the mma.sync design that csrc/attention.cu replaced, kept whole so
// that kernel_variants.py can build it as its "earlier" variant (the
// package builds csrc/*.cu only).
//
// Masked multi-head softmax attention, [B, T, H, Dh] in and out.
//
// Replaces supertonic_tpu/ops/attention.py:_attn_kernel_rows (the Pallas
// kernel behind fused_attention): out = softmax(q.k^T * scale + bias) v with
// bias = (1 - key_mask) * -1e9 added after the scale product, logits and
// softmax statistics in f32, probabilities rounded to v's storage type
// before the PV product, PV accumulated in f32, output in q's type. Keys
// past Tk get -inf; a fully masked row sees every logit at -1e9 and so gives
// the uniform mean of v, never NaN. Dh = 64 only; any Tq and Tk (keys
// stream through shared memory, so there is no length cap).
//
// Bound on the H100: at the path's shapes (Tq, Tk <= ~700, Dh = 64) the
// arithmetic is 4*Tq*Tk*Dh per head against 4*(Tq+Tk)*Dh*size bytes. In
// bf16 that puts the tensor-core bound near the memory bound, so what sets
// the pace is everything around the products: moving K and V into shared
// memory, the softmax's exponentials and the data movement between products
// and softmax. Keeping the Pallas kernel's rounding point (probabilities
// normalised, then rounded) needs two passes over the keys, so q.k is
// computed twice.
//
// bf16 design (attn_mma), FlashAttention-2 style on mma.sync: a block of 4
// warps owns 64 queries of one (batch, head), 16 per warp. Q is loaded once
// and held in registers as mma A fragments for both passes. K and V stream
// in 64-key tiles through a 2-stage cp.async ring in shared memory, with the
// tile's key mask beside them; rows of 64 bf16 are XOR-swizzled by 16-byte
// chunk so that every ldmatrix is free of bank conflicts, and the next tile
// is in flight while the current one multiplies, with one block barrier per
// tile. Two stages (41 KB) let 4 blocks share an SM, which measured faster
// than three stages (3 blocks) or 8 warps with 128 queries a block
// (kernel_variants.py): the pace is set by the softmax and the products,
// not by the copies.
// Pass 1 streams K only: S = Q.K^T by mma.sync.m16n8k16 (bf16 -> f32,
// K's B fragments by ldmatrix), scale and bias in registers, and a running
// max and sum per row and thread, combined across the row's four threads at
// the end. Pass 2 streams K and V: S again, p = exp(s - max) / sum rounded
// to bf16 and packed straight from the S accumulators into the A fragments
// of P.V (V's B fragments by ldmatrix.trans), O accumulated in registers.
// Nothing passes through shared memory but the K/V tiles; the exponentials
// are exp2 with log2(e) folded into the scale and bias, and 1/sum is taken
// once per row. O leaves as bf16 through the warp's own rows of the Q tile,
// in 16-byte stores.
//
// f32 (attn_kernel): SIMT, exact to f32 rounding: one block of 4 warps per
// (batch, head, 16 queries), each warp 4 rows, lanes over keys for q.k and
// over Dh for p.v, K and V through shared memory in 64-key tiles, the same
// two passes.
#include <type_traits>

#include "common.cuh"

namespace {

constexpr int BQ = 16;   // queries per block
constexpr int BK = 64;   // keys per shared-memory tile
constexpr int NW = 4;    // warps per block
constexpr int R = BQ / NW;  // query rows per warp

template <typename T, int D>
__global__ void __launch_bounds__(NW * 32)
attn_kernel(const T* __restrict__ q, const T* __restrict__ k,
            const T* __restrict__ v, const float* __restrict__ mask,
            T* __restrict__ out, int Tq, int Tk, int H, float scale) {
  constexpr int DL = D / 32;  // output dims per lane
  __shared__ float Qs[BQ][D];
  __shared__ float Ks[BK][D + 1];
  __shared__ float Vs[BK][D + 1];
  __shared__ float Ps[NW][R][BK];
  __shared__ float Bs[BK];

  const int tid = threadIdx.x, warp = tid >> 5, lane = tid & 31;
  const int b = blockIdx.z, h = blockIdx.y, q0 = blockIdx.x * BQ;
  const size_t rs = (size_t)H * D;  // stride between time steps
  const T* qb = q + (size_t)b * Tq * rs + (size_t)h * D;
  const T* kb = k + (size_t)b * Tk * rs + (size_t)h * D;
  const T* vb = v + (size_t)b * Tk * rs + (size_t)h * D;

  for (int e = tid; e < BQ * D; e += NW * 32) {
    int r = e / D, d = e % D, qi = q0 + r;
    Qs[r][d] = qi < Tq ? stk::to_f(qb[(size_t)qi * rs + d]) : 0.0f;
  }

  auto load_tile = [&](int k0, bool with_v) {
    __syncthreads();  // the previous tile is no longer read
    for (int e = tid; e < BK * D; e += NW * 32) {
      int j = e / D, d = e % D, kj = k0 + j;
      bool ok = kj < Tk;
      Ks[j][d] = ok ? stk::to_f(kb[(size_t)kj * rs + d]) : 0.0f;
      if (with_v) Vs[j][d] = ok ? stk::to_f(vb[(size_t)kj * rs + d]) : 0.0f;
    }
    if (tid < BK) {
      int kj = k0 + tid;
      Bs[tid] = kj >= Tk ? -INFINITY
                : (mask ? (1.0f - mask[(size_t)b * Tk + kj]) * -1e9f : 0.0f);
    }
    __syncthreads();
  };

  // logits of this warp's R rows against key j of the current tile
  auto logits = [&](int j, float s[R]) {
#pragma unroll
    for (int r = 0; r < R; ++r) s[r] = 0.0f;
#pragma unroll 8
    for (int d = 0; d < D; ++d) {
      float kv = Ks[j][d];
#pragma unroll
      for (int r = 0; r < R; ++r) s[r] += Qs[warp * R + r][d] * kv;
    }
#pragma unroll
    for (int r = 0; r < R; ++r) s[r] = s[r] * scale + Bs[j];
  };

  // pass 1: running max and sum per row, per lane, then across the warp
  float m[R], l[R];
#pragma unroll
  for (int r = 0; r < R; ++r) { m[r] = -INFINITY; l[r] = 0.0f; }
  for (int k0 = 0; k0 < Tk; k0 += BK) {
    load_tile(k0, false);
#pragma unroll
    for (int jj = 0; jj < BK / 32; ++jj) {
      float s[R];
      logits(lane + 32 * jj, s);
#pragma unroll
      for (int r = 0; r < R; ++r) {
        if (s[r] == -INFINITY) continue;  // key past Tk
        if (s[r] > m[r]) { l[r] = l[r] * expf(m[r] - s[r]) + 1.0f; m[r] = s[r]; }
        else l[r] += expf(s[r] - m[r]);
      }
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
  for (int k0 = 0; k0 < Tk; k0 += BK) {
    load_tile(k0, true);
#pragma unroll
    for (int jj = 0; jj < BK / 32; ++jj) {
      int j = lane + 32 * jj;
      float s[R];
      logits(j, s);
#pragma unroll
      for (int r = 0; r < R; ++r)
        Ps[warp][r][j] = s[r] == -INFINITY ? 0.0f
                         : stk::rnd<T>(expf(s[r] - m[r]) / l[r]);
    }
    __syncwarp();
    for (int j = 0; j < BK; ++j) {
#pragma unroll
      for (int t = 0; t < DL; ++t) {
        float vv = Vs[j][lane + 32 * t];
#pragma unroll
        for (int r = 0; r < R; ++r) acc[r][t] += Ps[warp][r][j] * vv;
      }
    }
    __syncwarp();
  }

  T* ob = out + (size_t)b * Tq * rs + (size_t)h * D;
#pragma unroll
  for (int r = 0; r < R; ++r) {
    int qi = q0 + warp * R + r;
    if (qi >= Tq) continue;
#pragma unroll
    for (int t = 0; t < DL; ++t)
      ob[(size_t)qi * rs + lane + 32 * t] = stk::from_f<T>(acc[r][t]);
  }
}


// ---------------------------------------------------------------------------
// bf16 on the tensor cores
// ---------------------------------------------------------------------------
using bf16 = __nv_bfloat16;
constexpr int DH = 64;      // head dim: 8 chunks of 16 bytes a row
constexpr int MQ = 64;      // queries per block, 16 per warp
constexpr int KT = 64;      // keys per ring stage
constexpr int STAGES = 2;   // depth of the K/V ring
constexpr float LOG2E = 1.4426950408889634f;

struct Stage {
  bf16 k[KT * DH];  // swizzled rows (stk::swz)
  bf16 v[KT * DH];
  float mask[KT];   // the key mask of these keys
};
struct MmaSmem {
  bf16 q[MQ * DH];  // swizzled; at the end each warp's output staging
  Stage ring[STAGES];
};

__global__ void __launch_bounds__(NW * 32, 4)
attn_mma(const bf16* __restrict__ q, const bf16* __restrict__ k,
         const bf16* __restrict__ v, const float* __restrict__ mask,
         bf16* __restrict__ out, int Tq, int Tk, int H, float scale_log2) {
  extern __shared__ __align__(128) unsigned char raw[];
  MmaSmem& sm = *reinterpret_cast<MmaSmem*>(raw);
  const int tid = threadIdx.x, warp = tid >> 5, lane = tid & 31;
  const int g = lane >> 2, t = lane & 3;
  const int b = blockIdx.z, h = blockIdx.y, q0 = blockIdx.x * MQ;
  const size_t rs = (size_t)H * DH;  // stride between time steps
  const bf16* qb = q + (size_t)b * Tq * rs + (size_t)h * DH;
  const bf16* kb = k + (size_t)b * Tk * rs + (size_t)h * DH;
  const bf16* vb = v + (size_t)b * Tk * rs + (size_t)h * DH;
  const float* mb = mask ? mask + (size_t)b * Tk : nullptr;
  const int n_tiles = (Tk + KT - 1) / KT, steps = 2 * n_tiles;

  // ring step i: key tile i (pass 1, K only) or i - n_tiles (pass 2, K and
  // V); keys past Tk are zero-filled
  auto load_step = [&](int i) {
    const bool with_v = i >= n_tiles;
    const int k0 = (with_v ? i - n_tiles : i) * KT;
    Stage& st = sm.ring[i % STAGES];
    for (int c = tid; c < KT * 8; c += NW * 32) {
      const int j = c >> 3, ch = c & 7, kj = k0 + j;
      const bool ok = kj < Tk;
      const size_t src = (size_t)(ok ? kj : 0) * rs + ch * 8;
      stk::cp_async16(stk::smem_u32(st.k + stk::swz<DH>(j, ch)), kb + src, ok);
      if (with_v) stk::cp_async16(stk::smem_u32(st.v + stk::swz<DH>(j, ch)), vb + src, ok);
    }
    if (mb && tid < KT) {
      const int kj = k0 + tid;
      stk::cp_async4(stk::smem_u32(&st.mask[tid]), mb + (kj < Tk ? kj : 0), kj < Tk);
    }
  };
  // the Q tile joins the first group, then STAGES - 1 ring steps in flight
  for (int c = tid; c < MQ * 8; c += NW * 32) {
    const int r = c >> 3, ch = c & 7, qi = q0 + r;
    const bool ok = qi < Tq;
    stk::cp_async16(stk::smem_u32(sm.q + stk::swz<DH>(r, ch)),
                    qb + (size_t)(ok ? qi : 0) * rs + ch * 8, ok);
  }
#pragma unroll
  for (int i = 0; i < STAGES - 1; ++i) {
    if (i < steps) load_step(i);
    stk::cp_async_commit();
  }
  // step i has landed for every thread and step i - 1 is consumed by every
  // warp (one barrier); the step STAGES - 1 ahead goes into step i - 1's slot
  auto advance = [&](int i) {
    stk::cp_async_wait<STAGES - 2>();
    __syncthreads();
    if (i + STAGES - 1 < steps) load_step(i + STAGES - 1);
    stk::cp_async_commit();
  };

  // this warp's 16 x 64 logits of a stage in log2 units, in mma accumulator
  // layout: s[j] = keys 8j + 2t, 8j + 2t + 1 of rows g (s[j][0..1]) and
  // g + 8 (s[j][2..3])
  uint32_t qf[4][4];  // Q's A fragments, 4 steps of 16 dims
  auto logits = [&](const Stage& st, int k0, float s[8][4]) {
#pragma unroll
    for (int j = 0; j < 8; ++j) s[j][0] = s[j][1] = s[j][2] = s[j][3] = 0.0f;
#pragma unroll
    for (int kk = 0; kk < 4; ++kk)
#pragma unroll
      for (int jp = 0; jp < 4; ++jp) {
        // matrices: keys 16jp + (0-7 | 8-15) x dims (low | high 8 of the step)
        uint32_t bk[4];
        const int row = jp * 16 + ((lane >> 4) << 3) + (lane & 7);
        stk::ldmatrix_x4(bk, stk::smem_u32(st.k + stk::swz<DH>(row, kk * 2 + ((lane >> 3) & 1))));
        stk::mma_bf16(s[2 * jp], qf[kk], bk[0], bk[1]);
        stk::mma_bf16(s[2 * jp + 1], qf[kk], bk[2], bk[3]);
      }
#pragma unroll
    for (int j = 0; j < 8; ++j)
#pragma unroll
      for (int e = 0; e < 2; ++e) {
        const int key = j * 8 + 2 * t + e;
        const float bias = k0 + key >= Tk ? -INFINITY
                           : (mb ? (1.0f - st.mask[key]) * (-1e9f * LOG2E) : 0.0f);
        s[j][e] = fmaf(s[j][e], scale_log2, bias);
        s[j][e + 2] = fmaf(s[j][e + 2], scale_log2, bias);
      }
  };

  // pass 1: running max and sum per row over this thread's keys
  float m[2] = {-INFINITY, -INFINITY}, l[2] = {0.0f, 0.0f};
  int i = 0;
  for (int tile = 0; tile < n_tiles; ++tile, ++i) {
    advance(i);
    if (tile == 0) {  // Q landed with step 0
#pragma unroll
      for (int kk = 0; kk < 4; ++kk)
        stk::ldmatrix_x4(qf[kk], stk::smem_u32(sm.q + stk::swz<DH>(warp * 16 + (lane & 15),
                                                                   kk * 2 + (lane >> 4))));
    }
    float s[8][4];
    logits(sm.ring[i % STAGES], tile * KT, s);
#pragma unroll
    for (int r = 0; r < 2; ++r) {
      float mx = m[r];
#pragma unroll
      for (int j = 0; j < 8; ++j) mx = fmaxf(mx, fmaxf(s[j][2 * r], s[j][2 * r + 1]));
      if (mx == -INFINITY) continue;  // no key below Tk yet
      float part = 0.0f;
#pragma unroll
      for (int j = 0; j < 8; ++j)
        part += exp2f(s[j][2 * r] - mx) + exp2f(s[j][2 * r + 1] - mx);
      l[r] = l[r] * exp2f(m[r] - mx) + part;
      m[r] = mx;
    }
  }
  // the four threads of a row (a quad) combine; row max is finite (Tk >= 1)
  float inv_l[2];
#pragma unroll
  for (int r = 0; r < 2; ++r) {
    float mx = fmaxf(m[r], __shfl_xor_sync(0xffffffffu, m[r], 1));
    mx = fmaxf(mx, __shfl_xor_sync(0xffffffffu, mx, 2));
    float part = m[r] == -INFINITY ? 0.0f : l[r] * exp2f(m[r] - mx);
    part += __shfl_xor_sync(0xffffffffu, part, 1);
    part += __shfl_xor_sync(0xffffffffu, part, 2);
    m[r] = mx;
    inv_l[r] = 1.0f / part;
  }

  // pass 2: probabilities rounded to bf16, O += P.V
  float o[8][4];
#pragma unroll
  for (int j = 0; j < 8; ++j) o[j][0] = o[j][1] = o[j][2] = o[j][3] = 0.0f;
  for (int tile = 0; tile < n_tiles; ++tile, ++i) {
    advance(i);
    const Stage& st = sm.ring[i % STAGES];
    float s[8][4];
    logits(st, tile * KT, s);
    // the accumulators of key tiles 2kk and 2kk + 1 are, element for
    // element, the A fragment of P for key step kk
    uint32_t pf[4][4];
#pragma unroll
    for (int kk = 0; kk < 4; ++kk)
#pragma unroll
      for (int hh = 0; hh < 2; ++hh) {
        const float* c = s[2 * kk + hh];
        pf[kk][2 * hh] = stk::pack_bf16(exp2f(c[0] - m[0]) * inv_l[0],
                                        exp2f(c[1] - m[0]) * inv_l[0]);
        pf[kk][2 * hh + 1] = stk::pack_bf16(exp2f(c[2] - m[1]) * inv_l[1],
                                            exp2f(c[3] - m[1]) * inv_l[1]);
      }
#pragma unroll
    for (int kk = 0; kk < 4; ++kk)
#pragma unroll
      for (int dp = 0; dp < 4; ++dp) {
        // matrices: keys 16kk + (0-7 | 8-15) x dims 16dp + (0-7 | 8-15), transposed
        uint32_t bv[4];
        const int row = kk * 16 + (((lane >> 3) & 1) << 3) + (lane & 7);
        stk::ldmatrix_x4_trans(bv, stk::smem_u32(st.v + stk::swz<DH>(row, dp * 2 + (lane >> 4))));
        stk::mma_bf16(o[2 * dp], pf[kk], bv[0], bv[1]);
        stk::mma_bf16(o[2 * dp + 1], pf[kk], bv[2], bv[3]);
      }
  }

  // O -> bf16 through this warp's own 16 rows of the Q tile (read by this
  // warp alone, at the first tile), then 16-byte stores of whole rows
  bf16* stage = sm.q + warp * 16 * DH;
#pragma unroll
  for (int j = 0; j < 8; ++j) {
    *reinterpret_cast<uint32_t*>(stage + stk::swz<DH>(g, j) + 2 * t) =
        stk::pack_bf16(o[j][0], o[j][1]);
    *reinterpret_cast<uint32_t*>(stage + stk::swz<DH>(g + 8, j) + 2 * t) =
        stk::pack_bf16(o[j][2], o[j][3]);
  }
  __syncwarp();
  bf16* ob = out + (size_t)b * Tq * rs + (size_t)h * DH;
#pragma unroll
  for (int it = 0; it < 4; ++it) {
    const int c = lane + 32 * it, r = c >> 3, ch = c & 7, qi = q0 + warp * 16 + r;
    if (qi < Tq)
      *reinterpret_cast<uint4*>(ob + (size_t)qi * rs + ch * 8) =
          *reinterpret_cast<const uint4*>(stage + stk::swz<DH>(r, ch));
  }
}

template <typename T>
int launch(const void* q, const void* k, const void* v, const float* mask,
           void* out, int B, int Tq, int Tk, int H, int D, cudaStream_t st) {
  if (D != 64 || Tk < 1) return (int)cudaErrorInvalidValue;
  const float scale = 1.0f / sqrtf((float)D);
  if constexpr (std::is_same<T, bf16>::value) {
    static size_t configured[stk::kMaxDevices] = {};
    if (int err = stk::allow_dynamic_smem(attn_mma, sizeof(MmaSmem), configured)) return err;
    dim3 grid((Tq + MQ - 1) / MQ, H, B);
    attn_mma<<<grid, NW * 32, sizeof(MmaSmem), st>>>(
        (const bf16*)q, (const bf16*)k, (const bf16*)v, mask, (bf16*)out, Tq, Tk, H,
        scale * LOG2E);
  } else {
    dim3 grid((Tq + BQ - 1) / BQ, H, B);
    attn_kernel<T, 64><<<grid, NW * 32, 0, st>>>(
        (const T*)q, (const T*)k, (const T*)v, mask, (T*)out, Tq, Tk, H, scale);
  }
  return (int)cudaGetLastError();
}

}  // namespace

// q [B,Tq,H,D], k/v [B,Tk,H,D], out [B,Tq,H,D], contiguous and 16-byte
// aligned, of one storage type (dtype 0 = float, 1 = bfloat16); mask [B,Tk]
// float or null. D = 64, Tk >= 1.
extern "C" int stk_attention(const void* q, const void* k, const void* v,
                             const void* mask, void* out, int B, int Tq, int Tk,
                             int H, int D, int dtype, void* stream) {
  cudaStream_t st = (cudaStream_t)stream;
  const float* m = (const float*)mask;
  if (dtype == 0) return launch<float>(q, k, v, m, out, B, Tq, Tk, H, D, st);
  if (dtype == 1) return launch<__nv_bfloat16>(q, k, v, m, out, B, Tq, Tk, H, D, st);
  return (int)cudaErrorInvalidValue;
}
