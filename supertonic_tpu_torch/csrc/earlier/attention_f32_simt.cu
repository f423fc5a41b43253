// The f32 attention kernel that attn_wide (csrc/attention.cu) replaced, not
// on the path: SIMT, exact to f32 rounding, one block of 4 warps per
// (batch, head, 16 queries), each warp 4 rows, lanes over keys for q.k and
// over Dh for p.v, K and V through shared memory in 64-key tiles (32 above
// Dh = 64, to stay within 48 KB of static shared memory), two passes over
// the keys (max and sum, then the probabilities rounded to v's type and
// p.v). One instance per D = 32, 64, 96 and 128. attn_wide runs the same
// passes with the same sum orders at every head width;
// kernel_variants.py builds this file as its f32 attention's "earlier"
// variant.
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
  constexpr int BK = D <= 64 ? ::BK : 32;  // keys a tile
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

template <int D>
int launch_f32(const void* q, const void* k, const void* v, const float* mask, void* out,
               int B, int Tq, int Tk, int H, float scale, cudaStream_t st) {
  dim3 grid((Tq + BQ - 1) / BQ, H, B);
  attn_kernel<float, D><<<grid, NW * 32, 0, st>>>(
      (const float*)q, (const float*)k, (const float*)v, mask, (float*)out, Tq, Tk, H, scale);
  return (int)cudaGetLastError();
}

}  // namespace

// The path library's stk_attention, f32 (dtype 0) at D 32, 64, 96 and 128.
extern "C" int stk_attention(const void* q, const void* k, const void* v,
                             const void* mask, void* out, int B, int Tq, int Tk,
                             int H, int D, int dtype, void* stream, float scale) {
  if (dtype != 0 || Tk < 1) return (int)cudaErrorInvalidValue;
  const float* m = (const float*)mask;
  cudaStream_t st = (cudaStream_t)stream;
  switch (D) {
    case 32: return launch_f32<32>(q, k, v, m, out, B, Tq, Tk, H, scale, st);
    case 64: return launch_f32<64>(q, k, v, m, out, B, Tq, Tk, H, scale, st);
    case 96: return launch_f32<96>(q, k, v, m, out, B, Tq, Tk, H, scale, st);
    case 128: return launch_f32<128>(q, k, v, m, out, B, Tq, Tk, H, scale, st);
    default: return (int)cudaErrorInvalidValue;
  }
}
