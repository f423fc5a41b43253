// The warp-specialised wgmma GEMM of the bf16 FFN (csrc/ffn.cu) and of the
// int8 product (csrc/int8_matmul.cu):
//   C [M, N] = A [M, K] . W [N, K]^T,  both operands contiguous in K (torch's
// linear layout), each C element pair handed to the caller's epilogue
// straight from the accumulator registers.
//
// Design: persistent blocks of one producer warpgroup (one thread of it
// issues) and NC consumer warpgroups. The producer streams K in slices of
// 128 bytes (64 bf16, 128 int8) through a ring of NS stages by TMA, a tile's
// A rows and W rows a stage, 128-byte swizzled, behind full/empty
// mbarriers. Each consumer owns whole tiles of 64 MI rows x BN columns,
// taking turns with the other (turn barriers keep their mainloops in ring
// order), runs MI products of 32 bytes of K each (wgmma.m64nBNk16 bf16,
// m64nBNk32 s8) four times a stage with both operands K-major from shared
// memory,
// keeps one group of products in flight while it waits for the next stage,
// and releases a stage once the products that read it have completed; its
// epilogue then runs beside the other consumer's products, straight from
// the accumulator registers into its own swizzled output buffer, stored by
// TMA (or, TMA_STORE off, by each thread). COOP instead lets the consumers
// share a tile, each its own rows. setmaxnreg gives the consumers'
// accumulators (MI * BN / 2 f32 a thread) the producer's registers. Rows
// past M and columns past N load as zeros and are never stored.
//
// The operand type is a template argument (Op: WgmmaBf16, WgmmaS8), and so
// is the stored type (the epilogue's Out: bf16 unless it names another):
// 2-byte results leave in TMA boxes of 64 columns, 4-byte ones (int32,
// f32) in boxes of 32, both 128 bytes a row under the same swizzle. A tile
// with ANY_N stores from the registers at any N (an odd N element by
// element), where C's rows cannot be a TMA map's (N * size not a multiple
// of 16 bytes).
#pragma once

#include <type_traits>

#include "wgmma.cuh"

namespace stk {

struct WgmmaBf16 {
  using In = __nv_bfloat16;
  using Acc = float;
  static constexpr CUtensorMapDataType kTmaType = CU_TENSOR_MAP_DATA_TYPE_BFLOAT16;
  // one product over 32 bytes of K (16 bf16) into d
  template <int BN>
  static __device__ __forceinline__ void mma(Acc (&d)[BN / 2], uint64_t a, uint64_t w) {
    Wgmma<BN>::template ss<0>(d, a, w, 1);
  }
};

struct WgmmaS8 {
  using In = int8_t;
  using Acc = int;
  // TMA has no signed 8-bit type: the unsigned one moves the bytes as they are
  static constexpr CUtensorMapDataType kTmaType = CU_TENSOR_MAP_DATA_TYPE_UINT8;
  // one product over 32 bytes of K (32 int8) into d
  template <int BN>
  static __device__ __forceinline__ void mma(Acc (&d)[BN / 2], uint64_t a, uint64_t w) {
    WgmmaInt8<BN>::ss(d, a, w, 1);
  }
};

// the stored element type of an epilogue: Epi::Out, else bf16
template <typename Epi, typename = void> struct EpiOut { using type = __nv_bfloat16; };
template <typename Epi> struct EpiOut<Epi, std::void_t<typename Epi::Out>> {
  using type = typename Epi::Out;
};

// shared memory an epilogue keeps for the block (Epi::TABLE_BYTES, filled by
// Epi::fill at the block's start and handed to Epi::row), else none
template <typename Epi, typename = void> struct EpiTable {
  static constexpr size_t bytes = 0;
};
template <typename Epi> struct EpiTable<Epi, std::void_t<decltype(Epi::TABLE_BYTES)>> {
  static constexpr size_t bytes = Epi::TABLE_BYTES;
};

// the epilogue's functor for row r (with the block's table where it keeps one)
template <typename Epi>
__device__ __forceinline__ auto epi_row(const Epi& epi, int r, const uint8_t* table) {
  if constexpr (EpiTable<Epi>::bytes > 0)
    return epi.row(r, table);
  else
    return epi.row(r);
}

template <typename T> struct TmaType;
template <> struct TmaType<__nv_bfloat16> {
  static constexpr CUtensorMapDataType value = CU_TENSOR_MAP_DATA_TYPE_BFLOAT16;
};
template <> struct TmaType<float> {
  static constexpr CUtensorMapDataType value = CU_TENSOR_MAP_DATA_TYPE_FLOAT32;
};
template <> struct TmaType<int32_t> {
  static constexpr CUtensorMapDataType value = CU_TENSOR_MAP_DATA_TYPE_INT32;
};

// Tile shape of a launch: NC consumer warpgroups a block, each running MI
// products of 64 rows x BN columns a K step; NS ring stages, BPS blocks an
// SM. Each consumer owns whole tiles of 64 MI rows (taking turns), or with
// COOP the consumers share tiles of 64 MI NC rows, each its own rows.
// PERSISTENT: one wave of blocks walks all tiles, else one tile a consumer
// (a block, with COOP).
// TMA_STORE: each consumer writes its tile's results (ES bytes an element)
// into its own 128-byte-swizzled buffer and one thread stores it by TMA
// (boxes of 128 / ES columns); else each thread stores its column pairs
// from the registers (ANY_N: at any N, else N * ES a multiple of 16).
template <int NC_, int MI_, int BN_, int NS_, int BPS_, bool PERSISTENT_, bool COOP_ = false,
          bool TMA_STORE_ = true, int ES_ = 2, bool ANY_N_ = false>
struct WgTile {
  static constexpr int NC = NC_, MI = MI_, BN = BN_, NS = NS_, BPS = BPS_, ES = ES_;
  static constexpr int BM = 64 * MI_ * (COOP_ ? NC_ : 1);  // rows of a tile
  static constexpr bool PERSISTENT = PERSISTENT_, COOP = COOP_, TMA_STORE = TMA_STORE_;
  static constexpr bool ANY_N = ANY_N_;
  static constexpr int THREADS = (NC_ + 1) * 128;
  static constexpr int STAGE_A = BM * 128, STAGE_W = BN_ * 128;  // bytes
  static constexpr int BOX = 128 / ES_;  // columns of a stored box
  static constexpr int OUT = TMA_STORE_ ? 64 * MI_ * BN_ * ES_ : 0;  // a consumer's output buffer
  // the ring, the output buffers, the ring's full and empty barriers, the
  // consumers' turn barriers, and slack for the 1024-byte alignment
  static constexpr size_t SMEM =
      (size_t)NS_ * (STAGE_A + STAGE_W) + (size_t)NC_ * OUT + 16 * NS_ + 8 * NC_ + 1024;
  static_assert(ES_ == 2 || ES_ == 4, "2- or 4-byte results");
  static_assert(!(TMA_STORE_ && ANY_N_), "a TMA store takes N * ES a multiple of 16");
  static_assert(!TMA_STORE_ || BN_ % BOX == 0, "stored in boxes of 128 bytes a row");
  static_assert(BN_ % 8 == 0 && BN_ <= 256, "wgmma takes N up to 256 in steps of 8");
  static_assert(SMEM * BPS_ <= 232448, "the blocks' shared memory");
};

// a column pair of results as the epilogue returns it: two bf16 in one
// word, or two 4-byte values
template <int ES> using Pair = std::conditional_t<ES == 2, uint32_t, uint2>;

// the pair v at C[i], C[i + 1] (i = row * N + col, col < N), element by
// element where N is odd (the pair's address then is not aligned)
template <typename T>
__device__ __forceinline__ void store_pair_any(T* C, size_t i, int col, int N, Pair<sizeof(T)> v) {
  if (N % 2 == 0) {
    *reinterpret_cast<Pair<sizeof(T)>*>(C + i) = v;
    return;
  }
  if constexpr (sizeof(T) == 2) {
    reinterpret_cast<uint16_t*>(C)[i] = (uint16_t)(v & 0xffffu);
    if (col + 1 < N) reinterpret_cast<uint16_t*>(C)[i + 1] = (uint16_t)(v >> 16);
  } else {
    reinterpret_cast<uint32_t*>(C)[i] = v.x;
    if (col + 1 < N) reinterpret_cast<uint32_t*>(C)[i + 1] = v.y;
  }
}

template <typename Op, typename S, typename Epi>
__global__ void __launch_bounds__(S::THREADS, S::BPS)
wgmma_gemm(__grid_constant__ const CUtensorMap tm_a, __grid_constant__ const CUtensorMap tm_w,
           __grid_constant__ const CUtensorMap tm_c, typename EpiOut<Epi>::type* __restrict__ C,
           int M, int N, int K, int n_tiles, int tiles, Epi epi) {
  constexpr int NC = S::NC, MI = S::MI, BN = S::BN, NS = S::NS;
  constexpr bool COOP = S::COOP;
  extern __shared__ __align__(1024) unsigned char raw[];
  // swizzled stages need 1024-byte alignment; the launch adds the slack
  uint8_t* ring = raw + ((1024 - (smem_u32(raw) & 1023)) & 1023);
  uint8_t* out_buf = ring + NS * (S::STAGE_A + S::STAGE_W);  // NC buffers of S::OUT bytes
  uint64_t* full = reinterpret_cast<uint64_t*>(out_buf + NC * S::OUT);
  uint64_t* empty = full + NS;
  uint64_t* turn = empty + NS;
  uint8_t* table = reinterpret_cast<uint8_t*>(turn + NC);  // the epilogue's, if it keeps one
  auto stage_a = [&](int s) { return ring + s * (S::STAGE_A + S::STAGE_W); };
  auto stage_w = [&](int s) { return ring + s * (S::STAGE_A + S::STAGE_W) + S::STAGE_A; };
  const int wg = threadIdx.x / 128, warp = (threadIdx.x / 32) & 3, lane = threadIdx.x & 31;
  constexpr int KS = 128 / (int)sizeof(typename Op::In);  // K elements a stage
  const int kt_n = (K + KS - 1) / KS;
  if (threadIdx.x == 0) {
#pragma unroll
    for (int s = 0; s < NS; ++s) {
      mbar_init(&full[s], 1);
      mbar_init(&empty[s], COOP ? 4 * NC : 4);  // the warps that read it
    }
#pragma unroll
    for (int c = 0; c < NC; ++c) mbar_init(&turn[c], 1);
    mbar_fence_init();
  }
  if constexpr (EpiTable<Epi>::bytes > 0) Epi::fill(table, threadIdx.x, S::THREADS);
  __syncthreads();

  // the block's tiles are blockIdx.x + i gridDim.x, i = 0, 1, ...; consumer
  // c takes those with i % NC == c. Their K steps pass through the ring in
  // the order of i, so the consumers' mainloops take turns and each one's
  // epilogue runs beside the next one's products; n fastest, so the tiles
  // in flight across the card share their A rows in L2. A consumer starts
  // waiting on tile i's stages only once the consumer of tile i - 1 has seen
  // its last stage arrive (turn barriers): a full barrier's parity then
  // never refers to a phase two rounds back.
  if (wg == NC) {  // producer warpgroup: one thread issues
    regs_dealloc<kProducerRegs>();
    if (threadIdx.x % 128 != 0) return;
    int step = 0;
    for (int tile = blockIdx.x; tile < tiles; tile += gridDim.x) {
      const int m0 = (tile / n_tiles) * S::BM, n0 = (tile % n_tiles) * BN;
      for (int kt = 0; kt < kt_n; ++kt, ++step) {
        const int s = step % NS;
        mbar_wait(&empty[s], ((step / NS) & 1) ^ 1);
        mbar_arrive_tx(&full[s], S::STAGE_A + S::STAGE_W);
        tma_load_2d(stage_a(s), &tm_a, &full[s], kt * KS, m0);
        tma_load_2d(stage_w(s), &tm_w, &full[s], kt * KS, n0);
      }
    }
  } else {
    regs_alloc<consumer_regs(NC, S::BPS)>();
    const int g = lane >> 2, t = lane & 3;
    typename Op::Acc acc[MI][BN / 2];
    constexpr int STRIDE = COOP ? 1 : NC;  // the consumer's turns among the block's tiles
    const int row0 = COOP ? 64 * MI * wg : 0;  // its rows of a tile
    for (int i = COOP ? 0 : wg, tile = blockIdx.x + i * gridDim.x; tile < tiles;
         i += STRIDE, tile += STRIDE * gridDim.x) {
      const int m0 = (tile / n_tiles) * S::BM, n0 = (tile % n_tiles) * BN;
#pragma unroll
      for (int r = 0; r < MI; ++r)
#pragma unroll
        for (int e = 0; e < BN / 2; ++e) acc[r][e] = 0;
      const int step0 = i * kt_n;
      if (!COOP && NC > 1 && i > 0) mbar_wait(&turn[wg], ((i - 1) / NC) & 1);
      for (int kt = 0; kt < kt_n; ++kt) {
        const int step = step0 + kt, s = step % NS;
        mbar_wait(&full[s], (step / NS) & 1);
        if (!COOP && NC > 1 && kt == kt_n - 1 && threadIdx.x % 128 == 0)
          mbar_arrive(&turn[(wg + 1) % NC]);  // the next tile's consumer may start
        const uint32_t a_addr = smem_u32(stage_a(s)) + row0 * 128, w_addr = smem_u32(stage_w(s));
        wgmma_fence();
#pragma unroll
        for (int kk = 0; kk < 4; ++kk)
#pragma unroll
          for (int r = 0; r < MI; ++r)
            Op::template mma<BN>(acc[r], desc_sw128(a_addr + r * 64 * 128 + 32 * kk),
                                 desc_sw128(w_addr + 32 * kk));
        wgmma_commit();
        wgmma_wait<1>();  // the previous step's products are done with its stage
        if (kt > 0 && lane == 0) mbar_arrive(&empty[(step - 1) % NS]);
      }
      wgmma_wait<0>();
      if (lane == 0) mbar_arrive(&empty[(step0 + kt_n - 1) % NS]);
#pragma unroll
      for (int r = 0; r < MI; ++r) fence_regs(acc[r]);
      // epilogue from the registers: rows 64r + 16 warp + g (+ 8) of the
      // consumer's rows, columns 8j + 2t (+ 1), a column pair a value
      if constexpr (S::TMA_STORE) {
        uint8_t* buf = out_buf + wg * S::OUT;
        const int tid = threadIdx.x % 128;
        if (tid == 0) bulk_wait_read<0>();  // the last tile's store has read the buffer
        named_bar_sync(1 + wg, 128);
#pragma unroll
        for (int r = 0; r < MI; ++r)
#pragma unroll
          for (int half = 0; half < 2; ++half) {
            const int rr = 64 * r + 16 * warp + g + 8 * half, row = m0 + row0 + rr;
            const auto at = epi_row(epi, row < M ? row : M - 1, table);  // rows past M: not stored
#pragma unroll
            for (int j = 0; j < BN / 8; ++j) {
              const int col = n0 + 8 * j + 2 * t;
              if constexpr (S::ES == 2) {
                const uint32_t v = col < N ? at(col, acc[r][4 * j + 2 * half],
                                               acc[r][4 * j + 2 * half + 1])
                                           : 0u;
                // box j / 8 of 64 columns: rows of 128 bytes, chunk j % 8 swizzled by the row
                *reinterpret_cast<uint32_t*>(buf + (j / 8) * 64 * MI * 128 + rr * 128 +
                                             (((j % 8) ^ (rr % 8)) << 4) + 4 * t) = v;
              } else {
                const uint2 v = col < N ? at(col, acc[r][4 * j + 2 * half],
                                            acc[r][4 * j + 2 * half + 1])
                                        : make_uint2(0u, 0u);
                // box j / 4 of 32 columns: the pair is 8 bytes at byte 32 (j % 4) + 8 t
                // of the row, chunk 2 (j % 4) + t / 2 swizzled by the row
                *reinterpret_cast<uint2*>(buf + (j / 4) * 64 * MI * 128 + rr * 128 +
                                          (((2 * (j % 4) + t / 2) ^ (rr % 8)) << 4) +
                                          8 * (t % 2)) = v;
              }
            }
          }
        fence_proxy_async();
        named_bar_sync(1 + wg, 128);
        if (tid == 0) {
#pragma unroll
          for (int h = 0; h < BN / S::BOX; ++h)
            tma_store_2d(&tm_c, buf + h * 64 * MI * 128, n0 + S::BOX * h, m0 + row0);
          bulk_commit();
        }
      } else {
#pragma unroll
        for (int r = 0; r < MI; ++r)
#pragma unroll
          for (int half = 0; half < 2; ++half) {
            const int row = m0 + row0 + 64 * r + 16 * warp + g + 8 * half;
            if (row >= M) continue;
            const auto at = epi_row(epi, row, table);
#pragma unroll
            for (int j = 0; j < BN / 8; ++j) {
              const int col = n0 + 8 * j + 2 * t;
              if constexpr (S::ANY_N) {
                if (col < N)
                  store_pair_any(C, (size_t)row * N + col, col, N,
                                 at(col, acc[r][4 * j + 2 * half], acc[r][4 * j + 2 * half + 1]));
              } else if (col < N) {
                *reinterpret_cast<Pair<S::ES>*>(C + (size_t)row * N + col) =
                    at(col, acc[r][4 * j + 2 * half], acc[r][4 * j + 2 * half + 1]);
              }
            }
          }
      }
    }
    if (S::TMA_STORE && threadIdx.x % 128 == 0) bulk_wait<0>();  // the stores have landed
  }
}

// a 2-D map over a row-major [rows, cols] array of T, box (128 bytes of a
// row, box_rows)
template <typename T>
int encode_rows(CUtensorMap* map, const void* base, int rows, int cols, int box_rows,
                CUtensorMapDataType type) {
  const cuuint64_t dims[2] = {(cuuint64_t)cols, (cuuint64_t)rows};
  const cuuint64_t strides[1] = {(cuuint64_t)cols * sizeof(T)};
  const cuuint32_t box[2] = {(cuuint32_t)(128 / sizeof(T)), (cuuint32_t)box_rows};
  return encode_tma(map, base, 2, dims, strides, box, type);
}

// a 2-D map over a row-major [rows, K] operand, box (one stage row of K, box_rows)
template <typename Op>
int encode_kmajor(CUtensorMap* map, const void* base, int rows, int K, int box_rows) {
  return encode_rows<typename Op::In>(map, base, rows, K, box_rows, Op::kTmaType);
}

// tiles of S over C [M, N]
template <typename S>
long long gemm_tiles(int M, int N) {
  return (long long)((M + S::BM - 1) / S::BM) * ((N + S::BN - 1) / S::BN);
}

// launches wgmma_gemm<Op, S, Epi> over C [M, N]; returns a CUDA error code
// (or kTmaEncodeError + the driver's)
template <typename Op, typename S, typename Epi>
int launch_wgmma_gemm(const typename Op::In* A, const typename Op::In* W,
                      typename EpiOut<Epi>::type* C, int M, int N, int K, Epi epi,
                      cudaStream_t st) {
  using Out = typename EpiOut<Epi>::type;
  static_assert(sizeof(Out) == S::ES, "the tile's result size is the epilogue's");
  if (M < 1 || N < 1 || K < 1 || (K * sizeof(typename Op::In)) % 16 ||
      (!S::ANY_N && (N * S::ES) % 16))
    return (int)cudaErrorInvalidValue;
  const long long tiles = gemm_tiles<S>(M, N);
  if (tiles > 0x7fffffff) return (int)cudaErrorInvalidValue;
  int sms = 0;
  if (int err = sm_count(sms)) return err;
  const long long per_consumer = S::COOP ? tiles : (tiles + S::NC - 1) / S::NC;
  const int blocks = (int)(S::PERSISTENT && per_consumer > (long long)sms * S::BPS
                               ? (long long)sms * S::BPS : per_consumer);
  // encoded at every launch: a graph capture keeps this launch's maps
  CUtensorMap ta, tw, tc = {};
  if (int err = encode_kmajor<Op>(&ta, A, M, K, S::BM)) return err;
  if (int err = encode_kmajor<Op>(&tw, W, N, K, S::BN)) return err;
  // C [M, N] in boxes of 128 bytes of a row x a consumer's rows (no map at
  // an N whose rows a map cannot take: ANY_N stores from the registers)
  if constexpr (!S::ANY_N)
    if (int err = encode_rows<Out>(&tc, C, M, N, 64 * S::MI, TmaType<Out>::value))
      return err;
  auto kernel = wgmma_gemm<Op, S, Epi>;
  constexpr size_t smem = S::SMEM + EpiTable<Epi>::bytes;
  static_assert(smem * S::BPS <= 232448, "the blocks' shared memory with the epilogue's table");
  static size_t smem_set[kMaxDevices] = {};  // one per instantiation
  if (int err = allow_dynamic_smem(kernel, smem, smem_set)) return err;
  static int regs_at_entry = 0;
  if (int err = check_reg_split(kernel, 128, S::NC * 128, consumer_regs(S::NC, S::BPS),
                                regs_at_entry))
    return err;
  kernel<<<blocks, S::THREADS, smem, st>>>(ta, tw, tc, C, M, N, K, (N + S::BN - 1) / S::BN,
                                               (int)tiles, epi);
  return (int)cudaGetLastError();
}

}  // namespace stk
