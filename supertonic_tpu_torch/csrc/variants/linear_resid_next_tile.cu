// Design alternatives of the linear kernel's residual forms (csrc/linear.cu,
// MODE_RESID of linear_wgmma and w8a8_wgmma), each measured slower than the
// committed design (kernel_variants.py linear w8a8_forms --residual, ms a
// launch from graphs, NVIDIA H100 80GB HBM3, 700 W; PERF.md section 6):
//  - ResidNext: each of the three consumers of the 64 x 128 tiles has a
//    buffer for the residual beside its output buffer, and loads its next
//    tile's residual, bias columns, weight scales and gate rows as soon as
//    its epilogue has read this tile's (5 ring stages fit beside the six
//    buffers). W8A8 at the VE's O 0.0368-0.0375, FFN-out (K 2,048)
//    0.0792-0.0795; the committed tiles with the same packed gated
//    residual 0.0339-0.0340, 0.0759: the two ring stages it gives up cost
//    more than the loads it moves.
//  - ResidW, ResidW8: W resident in the block where its 128 columns fit (K
//    up to 512), the blocks of a column tile walking its row tiles; and
//    ResidPair beyond: a cluster of two blocks along M, each loading half of
//    every W stage by TMA multicast into both (kernel_variants.py routes the
//    residual form to them by a substitution in pick). W8A8 VE O
//    0.0344-0.0347, bf16 0.0491-0.0495; the clusters at K 1,024 and 2,048
//    0.112-0.113 and 0.267: a split of the replaced design had shown that
//    W's traffic through L2 does not set the form's pace.
// Otherwise the kernel as it stood when these were measured.
//
// The bf16 linear with the output fusion XLA makes of the JAX package's
// layers.linear (supertonic_tpu/models/layers.py:55-62) and of what its
// callers do with the result:
//   Y[M, N] = X[M, K] . W[N, K]^T, f32 sums, then per element
//   o = rnd(rnd(y) + rnd(bias))          the bf16 product plus the bf16 bias
//                                        (MODE_BIAS: o stored in bf16)
//   s = rnd(o / (1 + exp(-o)))           MODE_SILU: jax.nn.silu(linear(...)),
//                                        the FFN's first linear
//                                        (supertonic_tpu/models/layers.py:365),
//                                        the time MLP and the DP head
//   v = o * mask[row]                    MODE_TAIL: the flow step's tail
//   x = x_in[row, col] + dt[batch] * v   (supertonic_tpu/models/
//   out = x * mask[row], stored in f32   vector_estimator.py:156, :185-186)
//   MODE_ROPE: a Q or K projection, apply_rope(_split_heads(linear(...)))
//   (supertonic_tpu/models/layers.py:292-294, :317-323, :346-349): the bias
//   forms a, b of columns c and c + Dh / 2 of a head (c in its first half)
//   and the row's cos, sin of c (f32) give
//   rnd(a cos - b sin) at c, rnd(a sin + b cos) at c + Dh / 2
//   MODE_RESID: x = x + gate * linear(p["o"], ...) (layers.py:428, :433,
//   :454): rnd(res[row, col] + rnd(gate[batch, col] * o)) (no gate: rnd(res
//   + o)), the residual and the gate bf16
// where rnd rounds to bf16 (nearest even). Each sum and product is its own
// IEEE operation (__fadd_rn, __fmul_rn), as eager PyTorch rounds them: nvcc
// would otherwise contract a*b+c into one FMA. Silu is F.silu on the card
// bit for bit: on tiles of several consumers (ManySilu, SiluQ) from the
// block's table of that function of 16 bits (silu_table.cuh), whose entries
// the IEEE division's fast sequence of stk::silu_bf16_torch (common.cuh)
// makes; elsewhere by that sequence a value. chip_smoke.py checks every
// finite bf16 value through each instance that runs the silu form.
//
// It replaces no Pallas kernel: XLA fuses the bias add (and the silu, the
// Euler update, the rotary embedding, the gated residual) into the dot's
// output. A cuBLAS bias epilogue adds the bias in f32 before it rounds, which
// is not JAX's rounding. The rope and residual forms are bit for bit
// csrc/rope.cu and csrc/gated_residual.cu applied to this kernel's own bias
// form: the same operations in the same order.
//
// The W8A8 product's rope and residual forms (ops/w8a8.py, C entry
// stk_w8a8_epilogue: the int8 path's Q, K and O, JAX's _linear_w8a8,
// supertonic_tpu/models/layers.py:77-91, then apply_rope or the gated
// residual) run the same kernel on int8 X and W (w8a8_wgmma: wgmma
// s32.s8.s8, 128 elements of K a stage, the same swizzle and fragment
// layout; w8a8_simt) with csrc/int8_matmul.cu's rescale in place of JAX's
// bf16 bias rounding, o = rnd((float(sum) * sx[row]) * ws[col] + bias[col])
// (the tile's weight scales staged beside its bias columns, the row's sx
// loaded before the products), then the rotation or the gated residual as
// above: bit for bit the W8A8 product followed by csrc/rope.cu or
// csrc/gated_residual.cu.
//
// The W8A8 silu-quantize form (MODE_SILUQ, C entry stk_w8a8_silu_quantize:
// the int8 FFN-in, jax.nn.silu(_linear_w8a8(...)), layers.py:365, whose
// output only the FFN-out reads, and that linear's quantize pass, :77-91):
// the W8A8 silu form's values, rnd(silu(o)), leave as the FFN-out's (xq [M,
// N] int8, sx [M]) and the bf16 [M, N] activation is never stored: bit for
// bit the silu form followed by csrc/quantize.cu. A row's amax spans all N
// columns, so the N / BN blocks of a row block run as one thread-block
// cluster (SiluQ: 64 x 128 tiles, three consumers in turns, the cluster's
// blocks the row block's column tiles, N up to 2,048: 16 blocks, past the
// portable 8). Each consumer reduces its rows' partial maxima over its tile,
// its rows' four threads store them into the same exchange slot of every
// block of the cluster, four blocks each (st.async to the address mapa
// gives, completing its bytes on that block's slot barrier: no cluster-wide
// barrier a tile, so the consumers stay out of step with each other and with
// the producer), waits for the cluster's partials of its rows, then
// quantizes its tile from the bf16 values it held in registers (the row's
// reciprocal made once, each quotient by the IEEE division's fast sequence,
// quantize8.cuh) and stores the int8 tile by TMA; rank 0 stores sx. Two
// slots a consumer, used in alternate rounds: a block writes round r + 2
// into a slot only after every block has written round r + 1, so after each
// has read round r. W's 128 columns x K (K up to 512) stay in shared memory
// for the block's whole run and the ring carries X alone: streamed with X,
// every 64-row tile read its slice of W again from L2. Bound at the FFN-in
// (M 28,672, K 512, N 2,048): the int8 operations, 60.1 G, 0.0304 ms (bytes
// 74.4 MB, 0.0222).
// The silu set the design's pace (a split of the replaced one, the exact
// sequence a value on 64 x 256 tiles of two consumers in clusters of 8,
// csrc/earlier/linear_siluq_exact.cu: 0.184-0.188 ms a launch from graphs, 0.108-
// 0.110 with silu as the identity; kernel_variants.py silu_quantize --split,
// NVIDIA H100 80GB HBM3, 700 W). o is a bf16 value, so silu is a function of
// 16 bits: each block fills the 9 KB table of silu_table.cuh at its start;
// the epilogue makes the tile's rescaled pairs, gathering each half's least
// and greatest |o|, then takes silu in place by the table's fast path (two
// ld.shared and about seven integer instructions a pair) or, in a thread
// with a value off it (subnormals, |o| from 256, NaN: none, as a rule; the
// zeros are on it, since random weights' zero biases make them), pair by
// pair. The table freed registers for a third consumer on narrower tiles,
// which needs the clusters of 16. Measured (ms a launch from graphs, the
// same split, NVIDIA H100 80GB HBM3, 700 W): 0.153-0.157 at M 28,672 (the
// replaced design 0.184-0.189, the pair it replaces 0.210, the exact
// sequence on these tiles 0.208-0.213); on the int8 network's own FFN-in
// operands (M 40,960) 0.212-0.220 (0.264-0.275); at a streamed chunk's M
// 448 0.0121 (0.0147-0.0152). Four consumers (96 registers, spills) 0.157-0.159,
// two 0.172, the table on the replaced tiles 0.171, each quotient by
// __fdiv_rn 0.202-0.205. Split: silu as the identity 0.121, no quantize
// 0.142, no cluster exchange 0.138, no stores 0.152, the lookups without
// bank conflicts 0.143. The packed integer instructions matter: integer
// arithmetic runs at half the FP32 rate here, and a lookup handling every
// case by selects (about fifteen integer instructions a value) cost as much
// as the exact sequence.
//
// Bound on the H100 (3.35 TB/s, 989 TFLOP/s bf16), per launch at the b64
// cell's shapes (T = 448), bytes everywhere: the VE's self V (M 28,672, K
// 512, N 512) 59.3 MB, 0.0177 ms (its products 0.0152); the FFN-in with silu
// (M 20,480, K 256, N 1,024) 0.0158; out_proj with the tail (M 28,672, K
// 512, N 96: X, x_in and the f32 result) 0.0154; AdaLN (M 64, K 512, N
// 4,608: its weights) 0.0016; 1.06 ms for a b64/5-step batch's 128. The rope
// form at the VE's self Q (M 28,672, K 512, N 512, Dh 64: X, W, the result
// and the f32 cos and sin) 66.6 MB, 0.0199 ms (F.linear and rope.cu
// apart: 0.0177 + 0.0197); the residual form at its O (X, W, the residual,
// the result) 88.7 MB, 0.0265 (apart: 0.0177 + 0.0263).
//
// Design (the replaced one, on the FFN's template in wgmma_gemm.cuh, is
// csrc/earlier/linear_pr17.cu): a warp-specialised persistent GEMM of its
// own. A producer warp streams 64-element K slices of X and W by TMA
// through a ring (rows past M and N and columns past K load as zeros);
// consumer warpgroups run wgmma.m64nBNk16 from shared memory and take whole
// tiles in turns, so one's epilogue runs beside the next one's products.
// What a split of the replaced kernel showed (kernel_variants.py linear --split,
// ms a launch from replayed graphs, NVIDIA H100 80GB HBM3, 700 W), and
// what this design does about each:
//  - VE self V, 0.0353: its loads alone took 0.018, yet removing the
//    products, the epilogue math or the stores alone saved only 0.003-0.005
//    each: loads and the consumers' work overlapped poorly, four ring
//    stages (half a 128 x 128 tile at K 512) short of the loads' latency.
//    Five stages (what fits beside two 32 KB output buffers): 0.0336 ->
//    0.0312 (F.linear 0.034). Lost: 128 x 256 tiles shared by both
//    consumers (less L2 traffic; no epilogue beside the products) 0.0353,
//    stores from the registers with six stages 0.045-0.047.
//  - The epilogue math (in_proj, K 96: 0.0241, 0.0138 without it): JAX's
//    rounding by packed conversions (cvt.rn.bf16x2, one instruction a
//    pair) instead of three scalar roundings a value, and the tile's bias
//    columns staged once by cp.async during the products instead of read
//    from global memory for every row pair: in_proj 0.0146 (F.linear
//    0.021), TE/DP V 0.0134 -> 0.0092 (F.linear 0.0082).
//  - The tail, 0.0368 (0.017 without its epilogue): the tile's x_in lands by
//    TMA in its consumer's output buffer during the products (issued by the
//    consumer at the top of the tile, after its own wait for its last store
//    to read the buffer, so the producer never waits on an epilogue; issued
//    by the producer behind a buffer-free barrier it measured the same);
//    mask and dt are loaded before the products; the f32 results overwrite
//    x_in in place and leave by TMA: 0.0214 (x_in from global memory and
//    stores from the registers: 0.0352). 64 x 96 tiles (wgmma n96) compute
//    no zero columns at N 96 (64 x 128: 0.0236). Without its stores 0.0132,
//    its loads alone 0.0126: device memory (the bound 0.0154).
//  - The M = 64 linears (AdaLN, 0.0066): 72 tiles of 64 x 64 on 36 blocks of
//    two consumers. One consumer a block, two blocks an SM: 72 SMs, 0.0042
//    (F.linear 0.0038); with fewer 64 x 64 tiles than half the SMs, more
//    64 x 32 ones, stored from the registers.
//  - The silu form (FFN-in, 0.0690; there four consumers on 64 x 64
//    tiles to spread an epilogue that outlasted the products): 64 x 128
//    tiles, four consumers in turns, the exact sequence for every value:
//    0.0500. A fast quotient on ex2.approx and rcp.approx, kept where a
//    guard finds it far from a bf16 rounding midpoint and redone by the
//    exact sequence in a second pass elsewhere
//    (csrc/variants/linear_fast_silu.cu), took 0.0456 on the same tiles:
//    0.044 ms of a 43 ms device batch, less than two runs differ, for a
//    guard whose margin rests on an error model of the approximations; not
//    taken. Split of this kernel there: without the epilogue math 0.0332,
//    without the products 0.0403, the loads alone 0.0213; F.linear without
//    silu 0.0271. Silu from the block's table (silu_table.cuh, since the
//    silu-quantize form's redesign): 0.0480 against the exact sequence's
//    0.0494 (kernel_variants.py silu_quantize); not on Few and AnyN, one
//    consumer a block, where the table's fill outweighed it at M 64.
//  - The rope form: a wgmma accumulator gives a thread columns 8j + 2t, + 1,
//    so where a tile holds whole heads and Dh / 2 is a multiple of 8 a
//    column's partner c + Dh / 2 sits in the same thread (j + Dh / 16): the
//    rotation runs in registers on the bias forms, Dh a template parameter
//    (RopeMany's 128 x 128 tiles at Dh 16, 32, 64, 128; Few at Dh 64 where
//    they would not fill the card; 64 x 192 tiles at Dh 96 and 192, wgmma
//    n192; 64 x 256 at Dh 256). Any other even Dh runs linear_simt, whose
//    block takes 32 rotated pairs and their partners. The replaced design
//    (csrc/earlier/linear_rope_l2.cu) read each row's cos and sin from
//    device memory (L2) in the epilogue, after the products, a pair a row
//    for the tile's heads. Its split at the VE's self Q (M 28,672, K 512, N
//    512, Dh 64; ms a launch from graphs, kernel_variants.py linear
//    w8a8_forms --split, NVIDIA H100 80GB HBM3, 700 W): 0.0425-0.0433,
//    without those loads 0.0342, without its rotation no faster, without
//    its stores 0.035; the bias form 0.0312. The loads were the excess.
//    A row's cos and sin at Dh 64 are one 128-byte box row each, so the
//    consumer brings its rows' angles by TMA into its output buffer at the
//    top of the tile (cos in the first ROWS x 128 bytes, sin in the next:
//    the bytes where the row's results go), during the products, as the
//    residual form brings its residual (angles_by_tma: where the buffer
//    holds both boxes, 128 columns a tile). The epilogue first makes the
//    tile's bias forms, two bf16 a word, then a row at a time reads the
//    row's angle pairs into registers (swizzled as TMA lays them: no bank
//    conflicts), waits at the warp's barrier and writes the row's results
//    over them; a row's bytes are read and written by its four threads
//    alone. The bias forms first free half the sums' registers: with the
//    sums live, the row's 16 angle registers spilled on these tiles (168
//    registers a thread, 128 of them sums; 0.0418-0.0424, no faster than
//    the L2 loads). Measured: 0.0359-0.0360 against the replaced design's
//    0.0435 in the same run (64 x 128 tiles of three consumers 0.0403-
//    0.0407, the replaced design on those 0.0403-0.0405, F.linear then rope.cu
//    0.056); its split: without the rotation 0.0335, without the angles
//    0.0352, without the stores 0.0296 (the bias form 0.0312, loads alone
//    0.0211). Staged by cp.async the angles leave room for 3 ring
//    stages only (csrc/variants/linear_rope_staged.cu: 0.0420 on 64 x 256
//    tiles, 0.0445 on 128 x 128, 0.062 on 64 x 128 tiles of four
//    consumers). Few's 64 x 64 tiles (a streamed chunk's M) keep the L2
//    loads: their buffer holds half the angles, the loads cost 0.0001-0.0002
//    of 0.0046 there, and 64 x 128 tiles of one consumer with the angles by
//    TMA took 0.0050.
//  - The residual form: the residual arrives as the tail's x_in does, by
//    TMA into the consumer's output buffer (the consumer issues it, so the
//    producer waits on no epilogue), and the results overwrite it; the gate
//    rows of the tile's first two batch rows are staged by cp.async beside
//    the bias columns (other rows read theirs from device memory). Its
//    epilogue outweighs the bias form's: at the VE's O (bias form 0.0309;
//    F.linear, then gated_residual.cu 0.0632) the form takes 0.0408 without
//    its epilogue math. Three consumers on 64 x 128 tiles, 7 ring stages,
//    spread it: 0.0474-0.0494 (Many's two consumers, 4 stages: 0.0653-
//    0.0662; four consumers, 6 stages: 0.0501 at 96 registers with spills;
//    the gate from device memory: 0.0678-0.0688). Where Many's tiles would
//    not fill the card (a streamed chunk's B = 1 shapes) the form runs
//    Few's 64 x 64 tiles, the residual by TMA as on ManyResid, not the 64 x
//    32 tiles the bias form takes there, stored from the registers, whose
//    residual and gate loads wait for the products: at the VE's O at M 448
//    0.0053 against 0.0066 (0.0062 with those loads issued before the
//    products; the pair 0.0056); at the TE's and DP's FFN-out (M 320, K
//    1,024) 0.0064 against 0.0063 (the pair 0.0054).
//  - The W8A8 forms (ms from graphs, kernel_variants.py w8a8_forms, NVIDIA
//    H100 80GB HBM3, 700 W): at the VE's self Q (M 28,672, K 512, N 512, Dh
//    64) the rope form with its angles from L2 took 0.0354 on 128 x 128
//    tiles with the four ring stages that fit beside the weight scales'
//    slices, 0.0332 on 64 x 128 tiles of three consumers (7 stages), 0.0243
//    there without the angle loads (the product alone 0.0255). With the
//    angles by TMA as above (RopeMany8): 0.0255-0.0256 on 128 x 128 tiles
//    of two consumers, 4 stages, against the replaced design's 0.0332-0.0333
//    in the same run (64 x 128 of three 0.0258-0.0260; 128 x 128 with 5
//    stages and the scales from device memory 0.0254-0.0257; the product,
//    then rope.cu, 0.0487-0.0488; without the rotation 0.0244, without the
//    stores 0.0205). The residual form keeps ManyResid: at the
//    VE's O 0.0407 and FFN-out (K 2,048) 0.0743 against the pairs' 0.058-0.068
//    and 0.0889; 128 x 128 tiles of two consumers (0.0583, 0.0791) and 64 x
//    128 of four (0.0439, 0.0866) lost.
// Each mode and tile is its own instance (an epilogue reading its options
// at run time ran several times slower, csrc/conv1d.cu); pick() chooses by
// shape, and stk_linear_instance reports its choice. A K that
// is no multiple of 8 (a row no TMA map takes: the latent width 15 of a
// reference config) runs linear_simt: 64 x 64 tiles from scalar loads, f32
// FMA sums, the same epilogue.
#include <type_traits>

#include "quantize8.cuh"
#include "silu_table.cuh"
#include "wgmma_gemm.cuh"  // encode_rows, Pair, store_pair_any

namespace {

using bf16 = __nv_bfloat16;

constexpr int MODE_BIAS = 0, MODE_SILU = 1, MODE_TAIL = 2, MODE_ROPE = 3, MODE_RESID = 4,
              MODE_SILUQ = 5;
// the silu-quantize form's rows: a cluster of N / BN blocks, up to 16 (past
// the portable 8: the launch allows the non-portable sizes), so N up to 16 BN
constexpr int SQ_BLOCKS = 16;
// the tensor-core kernel's silu and silu-quantize forms take silu from the
// block's table in shared memory (silu_table.cuh), else by the exact
// sequence (stk::silu_bf16_torch) a value
constexpr bool SILU_BY_TABLE = true;

// ---------------------------------------------------------------------------
// the epilogue of a column pair, shared by both kernels
// ---------------------------------------------------------------------------

// a word of two bf16 (the lower column in the low half), as floats
__device__ __forceinline__ float2 unpack(uint32_t p) {
  return make_float2(__uint_as_float(p << 16), __uint_as_float(p & 0xffff0000u));
}

// two floats rounded to bf16, as floats
__device__ __forceinline__ float2 bf16_pair(float lo, float hi) {
  return unpack(stk::pack_bf16(lo, hi));
}

// JAX's bf16 bias add on the f32 sums (v0, v1) and the bf16-rounded bias
// pair b: the sums rounded, plus the bias, rounded once more (one packed
// conversion each); two bf16 in one word
__device__ __forceinline__ uint32_t bias_pair(float v0, float v1, float2 b) {
  const float2 y = bf16_pair(v0, v1);
  return stk::pack_bf16(__fadd_rn(y.x, b.x), __fadd_rn(y.y, b.y));
}

// the W8A8 product's rescale of a column pair: its bias b and weight scales
// w (f32, unrounded) and the row's activation scale s
struct Scale {
  float2 b, w;
  float s;
};

// The W8A8 linear's bias form on the exact int32 sums (v0, v1), made float
// as __int2float_rn makes them: (v * s) * w + b in f32, rounded once to bf16
// (csrc/int8_matmul.cu's ScaleOut, the same operations in the same order)
__device__ __forceinline__ uint32_t bias_pair(float v0, float v1, const Scale& q) {
  return stk::pack_bf16(__fadd_rn(__fmul_rn(__fmul_rn(v0, q.s), q.w.x), q.b.x),
                        __fadd_rn(__fmul_rn(__fmul_rn(v1, q.s), q.w.y), q.b.y));
}

// what bias_pair takes besides the sums: the bf16 bias pair b, or (Q8) the
// W8A8 rescale of the f32 bias pair b, the weight scales w and the row's s
template <bool Q8>
__device__ __forceinline__ auto with_scale(float2 b, float2 w, float s) {
  if constexpr (Q8)
    return Scale{b, w, s};
  else
    return b;
}

// The result pair of MODE from the sums (v0, v1), the bias pair b (or the
// W8A8 rescale, a Scale) and, for the tail, x_in's pair x, the row's mask m
// and its batch row's dt, for the residual form the residual's pair x and the
// gate's g: the bias form, then silu (the exact sequence,
// stk::silu_bf16_torch), the gated residual (csrc/gated_residual.cu's order:
// rnd(x + rnd(g * o)); g = 1 without a gate, 1 * o is exact) or the tail.
template <int MODE, typename B>
__device__ __forceinline__ stk::Pair<MODE == MODE_TAIL ? 4 : 2> epi_pair(float v0, float v1,
                                                                          B b, float2 x,
                                                                          float2 g, float m,
                                                                          float dt) {
  const uint32_t o = bias_pair(v0, v1, b);
  if constexpr (MODE == MODE_BIAS) {
    return o;
  } else {
    const float o0 = __uint_as_float(o << 16), o1 = __uint_as_float(o & 0xffff0000u);
    if constexpr (MODE == MODE_SILU) {
      return stk::pack_bf16(stk::silu_bf16_torch(o0), stk::silu_bf16_torch(o1));
    } else if constexpr (MODE == MODE_RESID) {
      const float2 go = bf16_pair(__fmul_rn(g.x, o0), __fmul_rn(g.y, o1));
      return stk::pack_bf16(__fadd_rn(x.x, go.x), __fadd_rn(x.y, go.y));
    } else {
      const float r0 = __fmul_rn(__fadd_rn(x.x, __fmul_rn(dt, __fmul_rn(o0, m))), m);
      const float r1 = __fmul_rn(__fadd_rn(x.y, __fmul_rn(dt, __fmul_rn(o1, m))), m);
      return make_uint2(__float_as_uint(r0), __float_as_uint(r1));
    }
  }
}

// epi_pair (the silu-quantize form: its silu form's) with silu from the
// block's table tab where the launch takes it (TAB)
template <int MODE, bool TAB, typename B>
__device__ __forceinline__ auto epi_pair_tab(const uint32_t* tab, float v0, float v1, B b,
                                             float2 x, float2 g, float m, float dt) {
  if constexpr (TAB)
    return stk::silu_bf16x2(tab, bias_pair(v0, v1, b));
  else
    return epi_pair<MODE == MODE_SILUQ ? MODE_SILU : MODE>(v0, v1, b, x, g, m, dt);
}

// The residual form's result pair on TMA-stored tiles from the bias form o,
// the residual's pair x and the gate's g (two bf16 a word each): rnd(x +
// rnd(g o)), csrc/gated_residual.cu's order. The operands are bf16, so the
// f32 product is exact and the f32 sum of two bf16 values rounds to bf16 as
// their sum does: the packed bf16 operations give epi_pair's result bit for
// bit, two instructions a pair.
__device__ __forceinline__ uint32_t gated_pair(uint32_t o, uint32_t x, uint32_t g) {
  const __nv_bfloat162 r = __hadd2_rn(*reinterpret_cast<const __nv_bfloat162*>(&x),
                                      __hmul2_rn(*reinterpret_cast<const __nv_bfloat162*>(&g),
                                                 *reinterpret_cast<const __nv_bfloat162*>(&o)));
  return *reinterpret_cast<const uint32_t*>(&r);
}

// The rope form's rotation of a head's pair of column pairs (csrc/rope.cu's
// order): from the bias forms a (the head's first half) and b (its second
// half) and their angles' cos c and sin s, o1 = rnd(a c - b s) and o2 =
// rnd(a s + b c), each product and sum in f32.
__device__ __forceinline__ void rotate(uint32_t a, uint32_t b, float2 c, float2 s, uint32_t& o1,
                                       uint32_t& o2) {
  const float2 x = unpack(a), y = unpack(b);
  o1 = stk::pack_bf16(__fsub_rn(__fmul_rn(x.x, c.x), __fmul_rn(y.x, s.x)),
                      __fsub_rn(__fmul_rn(x.y, c.y), __fmul_rn(y.y, s.y)));
  o2 = stk::pack_bf16(__fadd_rn(__fmul_rn(x.x, s.x), __fmul_rn(y.x, c.x)),
                      __fadd_rn(__fmul_rn(x.y, s.y), __fmul_rn(y.y, c.y)));
}

// what a launch reads besides X and W, and where a register-stored result goes
struct Args {
  const float* bias;   // [N]
  const float* x_in;   // MODE_TAIL: [M, N] f32
  const float* mask;   // MODE_TAIL: [M] f32 (0/1)
  const float* dt;     // MODE_TAIL: [M / T] f32
  const float* cs;     // MODE_ROPE: cos [M, dh / 2] f32
  const float* sn;     // MODE_ROPE: sin [M, dh / 2] f32
  const bf16* res;     // MODE_RESID: the residual [M, N]
  const bf16* gate;    // MODE_RESID: rows of N, batch row i at i * gstride, or null
  long long gstride;
  void* y;             // [M, N] bf16 (f32 for the tail)
  int M, N, K, T, dh;  // T rows a batch row; dh the rope form's head width
  const float* sx;     // the W8A8 forms: the rows' activation scales [M]
  const float* ws;     // the W8A8 forms: the weight scales [N]
  float* sxo;          // the silu-quantize form: the output rows' scales [M] (y: xq, int8)
};

// the pair at element e (column col) of rows of N bf16, as floats (a lone
// last column with 0)
__device__ __forceinline__ float2 load_pair(const bf16* p, size_t e, int col, int N) {
  if (N % 2 == 0) return unpack(__ldg(reinterpret_cast<const unsigned int*>(p + e)));
  const unsigned short* q = reinterpret_cast<const unsigned short*>(p);
  return make_float2(__uint_as_float((uint32_t)q[e] << 16),
                     col + 1 < N ? __uint_as_float((uint32_t)q[e + 1] << 16) : 0.0f);
}

// the residual form's gate pair at column col of row `row` (a row past M
// reads the last row's); 1 without a gate, or past N
__device__ __forceinline__ float2 gate_pair(const Args& p, int row, int col) {
  if (!p.gate || col >= p.N) return make_float2(1.0f, 1.0f);
  const long long ofs = (long long)((row < p.M ? row : p.M - 1) / p.T) * p.gstride;
  return load_pair(p.gate, (size_t)(ofs + col), col, p.N);
}

// shared memory a launch of MODE on tiles S takes besides a silu table: the
// tile's, for the residual form on TMA-stored tiles each consumer's gate
// rows of two batch rows (4 BN bytes), for a W8A8 form (Q8) each consumer's
// weight scales of the tile's columns (4 BN bytes), the resident W's
// barrier, and for the silu-quantize form the barriers of each consumer's
// two exchange slots, and the slots (the partial row maxima of the
// cluster's blocks)
template <int MODE, typename S, bool Q8>
__host__ __device__ constexpr size_t smem_base() {
  return S::SMEM + (MODE == MODE_RESID && S::TMA_STORE ? (size_t)S::NC * 4 * S::BN : 0) +
         (Q8 ? (size_t)S::NC * 4 * S::BN : 0) + (S::WRS > 0 ? 8 : 0) +
         (MODE == MODE_SILUQ ? 8 * 2 * S::NC + (size_t)S::NC * 2 * SQ_BLOCKS * S::ROWS * 4 : 0);
}

// whether a launch of MODE on tiles S takes silu from the block's table:
// the silu and silu-quantize forms on tiles of several consumers, whose
// blocks each take many tiles (the table's fill outweighed the exact
// sequence at M 64 on AnyN's one consumer), where the table fits beside the
// tile's shared memory
template <int MODE, typename S, bool Q8 = false>
__host__ __device__ constexpr bool silu_table() {
  return SILU_BY_TABLE && (MODE == MODE_SILU || MODE == MODE_SILUQ) && S::NC > 1 &&
         (smem_base<MODE, S, Q8>() + stk::SILU_TAB_BYTES) * S::BPS <= 232448;
}

// the shared memory of a launch of MODE on tiles S
template <int MODE, typename S, bool Q8 = false>
__host__ __device__ constexpr size_t smem_of() {
  return smem_base<MODE, S, Q8>() + (silu_table<MODE, S, Q8>() ? (size_t)stk::SILU_TAB_BYTES : 0);
}

// ---------------------------------------------------------------------------
// the tensor-core kernel (bf16 operands, or int8 for the W8A8 forms)
// ---------------------------------------------------------------------------

// A launch's tile: NC consumer warpgroups a block, each running MI products
// of 64 rows x BN columns a K step; NS ring stages of 128 bytes of K (64
// bf16, 128 int8), BPS blocks an SM. Each consumer owns whole tiles of 64 MI rows (in turns with
// the others), or with COOP the consumers share tiles of 64 MI NC rows, each
// its own rows. TMA_STORE: results of ES bytes leave through the consumer's
// 128-byte-swizzled buffer by TMA (the tail's x_in arrives there by TMA
// first), else from the registers at any N (x_in read from device memory).
// WRS: W's BN rows stay in shared memory for every tile of the block, WRS
// stages of K of them (K up to 128 WRS bytes), and the ring carries X alone.
// CM > 1: a cluster of CM blocks takes CM adjacent row tiles of one column
// tile at a time, each block loading BN / CM rows of every W stage by TMA
// multicast into all of them. RB: the residual form's residual lands in a
// buffer of its own beside each consumer's output buffer, the consumer's
// next tile's as soon as this tile's epilogue has read it.
template <int NC_, int MI_, int BN_, int NS_, int BPS_, bool COOP_, bool TMA_STORE_, int ES_,
          int WRS_ = 0, int CM_ = 1, bool RB_ = false>
struct Tile {
  static constexpr int NC = NC_, MI = MI_, BN = BN_, NS = NS_, BPS = BPS_, ES = ES_, WRS = WRS_,
                       CM = CM_;
  static constexpr bool COOP = COOP_, TMA_STORE = TMA_STORE_, RB = RB_;
  static constexpr int ROWS = 64 * MI_;               // a consumer's rows of a tile
  static constexpr int BM = ROWS * (COOP_ ? NC_ : 1);  // rows of a tile
  static constexpr int THREADS = (NC_ + 1) * 128;
  static constexpr int STAGE_A = BM * 128, STAGE_W = BN_ * 128;  // bytes
  static constexpr int BOX = 128 / ES_;  // columns of a stored box
  static constexpr int OUT = TMA_STORE_ ? ROWS * BN_ * ES_ : 0;  // a consumer's buffer
  static constexpr int STEP = STAGE_A + (WRS_ ? 0 : STAGE_W);    // bytes of a ring stage
  // the ring, the resident W, the consumers' output (and residual) buffers
  // and bias slices, the ring's full and empty barriers, the consumers' turn
  // and x_in-full barriers, and slack for the 1024-byte alignment
  static constexpr size_t SMEM = (size_t)NS_ * STEP + (size_t)WRS_ * STAGE_W +
                                 (size_t)NC_ * (OUT * (RB_ ? 2 : 1) + 4 * BN_) + 16 * NS_ +
                                 16 * NC_ + 1024;
  static_assert(BN_ % 8 == 0 && BN_ <= 256, "wgmma takes N up to 256 in steps of 8");
  static_assert(!TMA_STORE_ || BN_ % BOX == 0, "stored in boxes of 128 bytes a row");
  static_assert(SMEM * BPS_ <= 232448, "the blocks' shared memory");
  static_assert(CM_ == 1 || (WRS_ == 0 && !COOP_ && BN_ % (8 * CM_) == 0),
                "a cluster shares streamed W stages in slices of whole 8-row swizzle groups");
  static_assert(!RB_ || (TMA_STORE_ && !COOP_), "the residual's buffer: a consumer's TMA tiles");
};

// the pair (row rr of the consumer's rows, columns 8j + 2t, + 1) in the
// consumer's output buffer: box j / 8 of 64 bf16 columns (chunk j % 8 of
// the row), or box j / 4 of 32 f32 columns (8 bytes at 32 (j % 4) + 8 t),
// chunks swizzled by the row as TMA's 128-byte swizzle lays them
template <typename S>
__device__ __forceinline__ uint8_t* pair_at(uint8_t* buf, int j, int rr, int t) {
  if constexpr (S::ES == 1)  // box j / 16 of 128 int8 columns, byte 8 (j % 16) + 2 t of it
    return buf + (j / 16) * S::ROWS * 128 + rr * 128 + ((((j % 16) / 2) ^ (rr % 8)) << 4) +
           8 * (j % 2) + 2 * t;
  else if constexpr (S::ES == 2)
    return buf + (j / 8) * S::ROWS * 128 + rr * 128 + (((j % 8) ^ (rr % 8)) << 4) + 4 * t;
  else
    return buf + (j / 4) * S::ROWS * 128 + rr * 128 + (((2 * (j % 4) + t / 2) ^ (rr % 8)) << 4) +
           8 * (t % 2);
}

// Whether the rope form at heads of DH on tiles S brings its tile's angles
// by TMA into the consumer's output buffer during the products: cos and sin
// of a row are DH / 2 f32 each, one 128-byte box row each at DH 64, and the
// two boxes of the consumer's rows fit in its output buffer where its tiles
// hold 128 bf16 columns or more (RopeMany, RopeMany8). Elsewhere (Few's 64
// columns, Dh 16, 32, 96, 128, 192, 256) the epilogue reads them from
// device memory.
template <typename S, int DH>
__host__ __device__ constexpr bool angles_by_tma() {
  return DH == 64 && S::TMA_STORE && !S::COOP && S::ES == 2 && 2 * S::ROWS * 128 <= S::OUT;
}

// box at (c0, c1) of `map` into shared `dst` of every block of the cluster
// in `mask`, each completing its bytes on its own barrier at `bar`'s offset
__device__ __forceinline__ void tma_load_2d_multicast(void* dst, const CUtensorMap* map,
                                                      uint64_t* bar, int c0, int c1,
                                                      uint16_t mask) {
  asm volatile(
      "cp.async.bulk.tensor.2d.shared::cluster.global.mbarrier::complete_tx::bytes"
      ".multicast::cluster [%0], [%1, {%3, %4}], [%2], %5;\n" ::"r"(stk::smem_u32(dst)),
      "l"(reinterpret_cast<uint64_t>(map)), "r"(stk::smem_u32(bar)), "r"(c0), "r"(c1), "h"(mask)
      : "memory");
}
// one arrival on the barrier at `bar`'s offset in each of the cluster's CM blocks
template <int CM>
__device__ __forceinline__ void mbar_arrive_all(uint64_t* bar) {
  if constexpr (CM == 1) {
    stk::mbar_arrive(bar);
  } else {
#pragma unroll
    for (int r = 0; r < CM; ++r)
      asm volatile("mbarrier.arrive.release.cluster.shared::cluster.b64 _, [%0];\n" ::"r"(
                       stk::mapa(stk::smem_u32(bar), r))
                   : "memory");
  }
}

// The body of both tensor-core kernels. Q8: the W8A8 forms, int8 X and W
// (wgmma s32.s8.s8, 128 of K a stage) and the rescale by sx and ws in place
// of JAX's bf16 bias rounding. DH: the rope form's head width (0 in the
// other forms). tm_xin: the tail's x_in, the residual, or the rope form's
// cos (tm_sn its sin) where angles_by_tma.
template <bool Q8, int MODE, typename S, int DH>
__device__ __forceinline__ void wgmma_body(const CUtensorMap& tm_x, const CUtensorMap& tm_w,
                                           const CUtensorMap& tm_y, const CUtensorMap& tm_xin,
                                           const CUtensorMap& tm_sn, const Args& p, int n_tiles,
                                           int tiles) {
  constexpr int NC = S::NC, MI = S::MI, BN = S::BN, NS = S::NS;
  constexpr int KE = Q8 ? 128 : 64;  // elements of K a stage
  using Acc = std::conditional_t<Q8, int, float>;
  static_assert(!Q8 || MODE == MODE_ROPE || MODE == MODE_RESID || MODE == MODE_SILUQ,
                "the W8A8 forms");
  // the silu-quantize form: the n_tiles blocks of a cluster take the column
  // tiles of the same rows, W resident, one row block a consumer's turn
  constexpr bool SILUQ = MODE == MODE_SILUQ;
  static_assert((!SILUQ || S::WRS > 0) && (!SILUQ || (Q8 && MI == 1 && !S::COOP && S::ES == 1)),
                "the silu-quantize form: W8A8, W resident, 64-row tiles of int8 results");
  // W resident or shared by a cluster along M: the residual form's tiles
  static_assert((S::WRS == 0 || SILUQ || MODE == MODE_RESID) && (S::CM == 1 || MODE == MODE_RESID),
                "resident W: the silu-quantize and residual forms; a cluster along M: the "
                "residual form");
  // a cluster along M: block crank of the cluster takes row tile CM u +
  // crank of the cluster's units u (a unit: CM row tiles of one column tile)
  constexpr int CM = S::CM;
  const int crank = blockIdx.x % CM, unit0 = blockIdx.x / CM, units = gridDim.x / CM;
  // the tail's x_in, the residual or the rope form's angles land by TMA in
  // the consumer's output buffer (the angles: cos in its first ROWS x 128
  // bytes, sin in the next, each row's where that row's results go)
  constexpr bool ANG_TMA = MODE == MODE_ROPE && angles_by_tma<S, DH>();
  constexpr bool COOP = S::COOP,
                 IN_TMA = ((MODE == MODE_TAIL || MODE == MODE_RESID) && S::TMA_STORE) || ANG_TMA;
  // the residual in a buffer of its own (S::RB): the consumer's next tile's
  // residual, bias columns, weight scales and gate rows load as soon as this
  // tile's epilogue has read them, so they land during the other consumers'
  // epilogues and its own products
  constexpr bool NEXT = MODE == MODE_RESID && S::RB;
  static_assert(!(IN_TMA && COOP), "x_in or the residual arrives a consumer's tile at a time");
  static_assert(MODE != MODE_ROPE || (S::TMA_STORE && DH % 16 == 0 && BN % DH == 0),
                "a rope tile holds whole heads, each half in whole 8-column groups");
  using Out = std::conditional_t<MODE == MODE_TAIL, float,
                                 std::conditional_t<SILUQ, int8_t, bf16>>;
  static_assert(sizeof(Out) == S::ES, "the tile's result size is the mode's");
  constexpr bool TAB = silu_table<MODE, S, Q8>();  // silu from the block's table
  static_assert(!SILUQ || TAB == SILU_BY_TABLE, "the silu-quantize form's tile holds the table");
  extern __shared__ __align__(1024) unsigned char raw[];
  uint8_t* ring = raw + ((1024 - (stk::smem_u32(raw) & 1023)) & 1023);
  uint8_t* wres = ring + NS * S::STEP;  // the resident W: S::WRS stages of K
  uint8_t* out_buf = wres + S::WRS * S::STAGE_W;  // NC buffers of S::OUT bytes (RB: 2 NC)
  float* bias_buf = reinterpret_cast<float*>(out_buf + NC * S::OUT * (S::RB ? 2 : 1));  // NC of BN
  uint64_t* full = reinterpret_cast<uint64_t*>(bias_buf + NC * BN);
  uint64_t* empty = full + NS;
  uint64_t* turn = empty + NS;
  uint64_t* xfull = turn + NC;  // x_in or the residual has landed in the consumer's buffer
  // the residual form: NC slices of the gate rows of the tile's first two
  // batch rows, BN / 2 bf16 pairs a row
  uint32_t* gate_buf = reinterpret_cast<uint32_t*>(xfull + NC);
  // a W8A8 form: NC slices of the tile's weight scales, BN a slice
  float* ws_buf = reinterpret_cast<float*>(
      gate_buf + (MODE == MODE_RESID && S::TMA_STORE ? NC * BN : 0));
  // the silu-quantize form: the resident W's barrier, each consumer's two
  // exchange barriers, and its two exchange slots, each the partial maxima
  // of its tile's rows from each block of the cluster, [rank][ROWS]
  uint64_t* wfull = reinterpret_cast<uint64_t*>(ws_buf + (Q8 ? NC * BN : 0));
  uint64_t* xbar = wfull + 1;
  float* xch = reinterpret_cast<float*>(xbar + 2 * NC);
  // the silu table: after the exchange slots (the silu-quantize form), or
  // where the silu form's shared memory ends
  uint32_t* silu_tab = reinterpret_cast<uint32_t*>(
      SILUQ ? reinterpret_cast<uint8_t*>(xch + NC * 2 * SQ_BLOCKS * S::ROWS)
            : reinterpret_cast<uint8_t*>(wfull));
  auto stage_a = [&](int s) { return ring + s * S::STEP; };
  auto stage_w = [&](int s) { return ring + s * S::STEP + S::STAGE_A; };
  const int wg = threadIdx.x / 128, warp = (threadIdx.x / 32) & 3, lane = threadIdx.x & 31;
  const int kt_n = (p.K + KE - 1) / KE;
  if (threadIdx.x == 0) {
#pragma unroll
    for (int s = 0; s < NS; ++s) {
      stk::mbar_init(&full[s], 1);
      stk::mbar_init(&empty[s], COOP ? 4 * NC : 4 * CM);  // the warps that read it
    }
#pragma unroll
    for (int c = 0; c < NC; ++c) {
      stk::mbar_init(&turn[c], 1);
      stk::mbar_init(&xfull[c], 1);
    }
    if constexpr (S::WRS > 0) stk::mbar_init(wfull, 1);
    if constexpr (SILUQ) {
      // each exchange slot expects the partials of the cluster's n_tiles
      // blocks for its first round; a consumer re-arms it for its round after
      // next once it has read it
#pragma unroll
      for (int b = 0; b < 2 * NC; ++b) {
        stk::mbar_init(&xbar[b], 1);
        stk::mbar_arrive_tx(&xbar[b], n_tiles * S::ROWS * 4);
      }
    }
    stk::mbar_fence_init();
  }
  // the block's silu table, from all its threads (read after the barrier)
  if constexpr (TAB) stk::silu_table_fill(silu_tab, threadIdx.x, S::THREADS);
  // the cluster's blocks write into each other's exchange slots or ring
  // stages: all have started, their barriers set, before any does
  if constexpr (SILUQ || CM > 1)
    stk::cluster_sync();
  else
    __syncthreads();

  // the block's tiles are blockIdx.x + i gridDim.x, i = 0, 1, ... (with a
  // cluster along M, its row tile of unit unit0 + i units); consumer c takes
  // those with i % NC == c (all of them, with COOP). Their K steps
  // pass through the ring in the order of i, so the consumers' mainloops
  // take turns and each one's epilogue runs beside the next one's
  // products; n fastest, so the tiles in flight across the card share their
  // X rows in L2. Turn barriers: a consumer starts waiting on tile i's stages
  // once the consumer of tile i - 1 has seen its last stage arrive.
  if (wg == NC) {  // producer warpgroup: one thread issues
    stk::regs_dealloc<stk::kProducerRegs>();
    if (threadIdx.x % 128 == 0) {
      if constexpr (S::WRS > 0) {  // the block's columns of W, once (gridDim.x: n_tiles blocks)
        stk::mbar_arrive_tx(wfull, kt_n * S::STAGE_W);
        for (int kt = 0; kt < kt_n; ++kt)
          stk::tma_load_2d(wres + kt * S::STAGE_W, &tm_w, wfull, kt * KE,
                           (blockIdx.x % n_tiles) * BN);
      }
      int step = 0;
      for (int i = 0, tile = unit0; tile < tiles; ++i, tile += units) {
        const int m0 = ((tile / n_tiles) * CM + crank) * S::BM, n0 = (tile % n_tiles) * BN;
        for (int kt = 0; kt < kt_n; ++kt, ++step) {
          const int s = step % NS;
          // (with a cluster: every block of it has freed the stage)
          stk::mbar_wait(&empty[s], ((step / NS) & 1) ^ 1);
          stk::mbar_arrive_tx(&full[s], S::STEP);
          stk::tma_load_2d(stage_a(s), &tm_x, &full[s], kt * KE, m0);
          if constexpr (CM > 1)  // this block's rows of the W stage, into every block's
            tma_load_2d_multicast(stage_w(s) + crank * (BN / CM) * 128, &tm_w, &full[s],
                                  kt * KE, n0 + crank * (BN / CM), (1 << CM) - 1);
          else if constexpr (S::WRS == 0)
            stk::tma_load_2d(stage_w(s), &tm_w, &full[s], kt * KE, n0);
        }
      }
    }
  } else {
    stk::regs_alloc<stk::consumer_regs(NC, S::BPS)>();
    const int tid = threadIdx.x % 128, g = lane >> 2, t = lane & 3;
    uint8_t* buf = out_buf + wg * S::OUT;
    uint8_t* rbuf = S::RB ? out_buf + (NC + wg) * S::OUT : buf;  // where x_in or the residual lands
    float* bias_s = bias_buf + wg * BN;
    uint32_t* gate_s = gate_buf + wg * BN;
    float* ws_s = ws_buf + wg * BN;
    Acc acc[MI][BN / 2];
    constexpr int STRIDE = COOP ? 1 : NC;  // the consumer's turns among the block's tiles
    const int row0 = COOP ? S::ROWS * wg : 0;  // its rows of a tile
    // the tile's residual (or x_in) by TMA into rbuf, issued by one thread
    auto load_in = [&](int m0, int n0) {
      stk::mbar_arrive_tx(&xfull[wg], S::OUT);
#pragma unroll
      for (int h = 0; h < BN / S::BOX; ++h)
        stk::tma_load_2d(rbuf + h * S::ROWS * 128, &tm_xin, &xfull[wg], n0 + S::BOX * h, m0);
    };
    // the tile's bias columns (a W8A8 form's weight scales), and the
    // residual form's gate rows of the tile's first two batch rows (zeros
    // past the last batch row or N; rows of other batch rows read theirs
    // from device memory in the epilogue), by cp.async into shared memory
    auto stage = [&](int m0, int n0) {
      for (int c = tid; c < BN; c += 128) {
        stk::cp_async4(stk::smem_u32(bias_s + c), p.bias + (n0 + c < p.N ? n0 + c : 0),
                       n0 + c < p.N);
        if constexpr (Q8)
          stk::cp_async4(stk::smem_u32(ws_s + c), p.ws + (n0 + c < p.N ? n0 + c : 0),
                         n0 + c < p.N);
      }
      if constexpr (MODE == MODE_RESID && S::TMA_STORE) {
        const int b0 = (m0 + row0) / p.T;
        if (p.gate)
          for (int c = tid; c < BN; c += 128) {
            const int bb = b0 + c / (BN / 2), col = n0 + 2 * (c % (BN / 2));
            const bool ok = bb < p.M / p.T && col < p.N;
            stk::cp_async4(stk::smem_u32(gate_s + c),
                           p.gate + (ok ? (size_t)bb * p.gstride + col : 0), ok);
          }
      }
      stk::cp_async_commit();
    };
    if constexpr (S::WRS > 0) stk::mbar_wait(wfull, 0);
    for (int i = COOP ? 0 : wg, tile = unit0 + i * units; tile < tiles;
         i += STRIDE, tile += STRIDE * units) {
      const int m0 = ((tile / n_tiles) * CM + crank) * S::BM, n0 = (tile % n_tiles) * BN;
      // the tile's bias columns into shared memory and the tail's per-row
      // mask and dt (the residual form's gate row slots) into registers, in
      // flight during the products (the last epilogue has read the slice:
      // its closing barrier, or this one); with NEXT the consumer's first
      // tile's here, the others' after the epilogue before
      const bool here = !NEXT || i == wg;
      if constexpr (!S::TMA_STORE) stk::named_bar_sync(1 + wg, 128);
      if constexpr (IN_TMA) {
        // the tile's x_in, residual or angles into the consumer's output
        // buffer (with NEXT the residual's), once the last tile's store has
        // read it: issued by the consumer itself, so the producer never waits
        // on an epilogue; it lands during the products
        if (tid == 0 && here) {
          stk::bulk_wait_read<0>();
          if constexpr (ANG_TMA) {
            stk::mbar_arrive_tx(&xfull[wg], 2 * S::ROWS * 128);
            stk::tma_load_2d(buf, &tm_xin, &xfull[wg], 0, m0);
            stk::tma_load_2d(buf + S::ROWS * 128, &tm_sn, &xfull[wg], 0, m0);
          } else {
            load_in(m0, n0);
          }
        }
      }
      if (here) stage(m0, n0);
      const int b0 = MODE == MODE_RESID ? (m0 + row0) / p.T : 0;
      float mk[MI][2], dtr[MI][2];
      float sxr[MI][2];  // a W8A8 form: the row's activation scale
      int gsel[MI][2];  // the residual form: the row's gate row in the slice, or 2 and up
      if constexpr (MODE == MODE_TAIL || MODE == MODE_RESID || Q8) {
#pragma unroll
        for (int r = 0; r < MI; ++r)
#pragma unroll
          for (int half = 0; half < 2; ++half) {
            const int row = m0 + row0 + 64 * r + 16 * warp + g + 8 * half;
            const int at = row < p.M ? row : p.M - 1;  // rows past M are not stored
            if constexpr (Q8) sxr[r][half] = p.sx[at];
            if constexpr (MODE == MODE_TAIL) {
              mk[r][half] = p.mask[at];
              dtr[r][half] = p.dt[at / p.T];
            } else if constexpr (MODE == MODE_RESID) {
              gsel[r][half] = at / p.T - b0;
            }
          }
      }
#pragma unroll
      for (int r = 0; r < MI; ++r)
#pragma unroll
        for (int e = 0; e < BN / 2; ++e) acc[r][e] = Acc(0);
      const int step0 = i * kt_n;
      if (!COOP && NC > 1 && i > 0) stk::mbar_wait(&turn[wg], ((i - 1) / NC) & 1);
      for (int kt = 0; kt < kt_n; ++kt) {
        const int step = step0 + kt, s = step % NS;
        stk::mbar_wait(&full[s], (step / NS) & 1);
        if (!COOP && NC > 1 && kt == kt_n - 1 && tid == 0)
          stk::mbar_arrive(&turn[(wg + 1) % NC]);  // the next tile's consumer may start
        const uint32_t a_addr = stk::smem_u32(stage_a(s)) + row0 * 128;
        const uint32_t w_addr =
            stk::smem_u32(S::WRS > 0 ? wres + kt * S::STAGE_W : stage_w(s));
        stk::wgmma_fence();
#pragma unroll
        for (int kk = 0; kk < 4; ++kk)
#pragma unroll
          for (int r = 0; r < MI; ++r)
            if constexpr (Q8)
              stk::WgmmaInt8<BN>::ss(acc[r], stk::desc_sw128(a_addr + r * 64 * 128 + 32 * kk),
                                     stk::desc_sw128(w_addr + 32 * kk), 1);
            else
              stk::Wgmma<BN>::template ss<0>(acc[r], stk::desc_sw128(a_addr + r * 64 * 128 + 32 * kk),
                                             stk::desc_sw128(w_addr + 32 * kk), 1);
        stk::wgmma_commit();
        stk::wgmma_wait<1>();  // the previous step's products are done with its stage
        if (kt > 0 && lane == 0) mbar_arrive_all<CM>(&empty[(step - 1) % NS]);
      }
      stk::wgmma_wait<0>();
      if (lane == 0) mbar_arrive_all<CM>(&empty[(step0 + kt_n - 1) % NS]);
#pragma unroll
      for (int r = 0; r < MI; ++r) stk::fence_regs(acc[r]);
      stk::cp_async_wait<0>();
      if constexpr (S::TMA_STORE && (!IN_TMA || NEXT))
        if (tid == 0) stk::bulk_wait_read<0>();  // the last tile's store has read the buffer
      stk::named_bar_sync(1 + wg, 128);  // and every thread's bias columns have landed
      if constexpr (IN_TMA) stk::mbar_wait(&xfull[wg], (i / NC) & 1);
      if constexpr (SILUQ) {
        // the silu form's pairs (rows 16 warp + g, + 8; columns 8j + 2t, + 1)
        // kept as bf16 pairs, and each row's largest |value| over the
        // thread's columns, then the four threads of the row's columns
        uint32_t h[BN / 8][2];
        if constexpr (TAB) {
          // the rescaled bias forms, with the least and greatest |value| bits
          // of each half; then silu in place, by the table's fast path, or
          // where a value of the thread's lies off it (a zero, |x| below
          // 2^-125 or from 256, NaN: none, as a rule) pair by pair, value by
          // value in a pair with such a value
          uint32_t lo2 = 0xffffffffu, hi2 = 0u;
#pragma unroll
          for (int j = 0; j < BN / 8; ++j) {
            const int c = 8 * j + 2 * t;
            const float2 bl = *reinterpret_cast<const float2*>(bias_s + c);
            const float2 wv = *reinterpret_cast<const float2*>(ws_s + c);
#pragma unroll
            for (int half = 0; half < 2; ++half) {
              h[j][half] = bias_pair(acc[0][4 * j + 2 * half], acc[0][4 * j + 2 * half + 1],
                                     Scale{bl, wv, sxr[0][half]});
              stk::silu_gather(h[j][half], lo2, hi2);
            }
          }
          if (stk::silu_outside(lo2, hi2)) {
#pragma unroll
            for (int j = 0; j < BN / 8; ++j)
#pragma unroll
              for (int half = 0; half < 2; ++half)
                h[j][half] = stk::silu_bf16x2<true>(silu_tab, h[j][half]);
          } else {
#pragma unroll
            for (int j = 0; j < BN / 8; ++j)
#pragma unroll
              for (int half = 0; half < 2; ++half)
                h[j][half] = stk::silu_bf16x2_table(silu_tab, h[j][half]);
          }
        } else {
#pragma unroll
          for (int j = 0; j < BN / 8; ++j) {
            const int c = 8 * j + 2 * t;
            const float2 bl = *reinterpret_cast<const float2*>(bias_s + c);
            const float2 wv = *reinterpret_cast<const float2*>(ws_s + c);
#pragma unroll
            for (int half = 0; half < 2; ++half)
              h[j][half] = epi_pair<MODE_SILU>(acc[0][4 * j + 2 * half],
                                               acc[0][4 * j + 2 * half + 1],
                                               Scale{bl, wv, sxr[0][half]}, make_float2(0.0f, 0.0f),
                                               make_float2(1.0f, 1.0f), 0.0f, 0.0f);
          }
        }
        float am[2] = {0.0f, 0.0f};
#pragma unroll
        for (int j = 0; j < BN / 8; ++j)
#pragma unroll
          for (int half = 0; half < 2; ++half) {
            const float2 f = unpack(h[j][half]);
            am[half] = fmaxf(am[half], fmaxf(fabsf(f.x), fabsf(f.y)));
          }
        const int round = i / NC, slot = 2 * wg + (round & 1);
        const int rank = blockIdx.x % n_tiles;
        float sc[2], rc[2];
#pragma unroll
        for (int half = 0; half < 2; ++half) {
          am[half] = fmaxf(am[half], __shfl_xor_sync(0xffffffffu, am[half], 1));
          am[half] = fmaxf(am[half], __shfl_xor_sync(0xffffffffu, am[half], 2));
          // the row's partial into this slot of every block of the cluster,
          // the row's four threads taking every fourth block
          const int rr = 16 * warp + g + 8 * half;
          const uint32_t at = stk::smem_u32(xch + (slot * SQ_BLOCKS + rank) * S::ROWS + rr);
          for (int peer = t; peer < n_tiles; peer += 4)
            stk::st_async_f32(stk::mapa(at, peer), am[half],
                              stk::mapa(stk::smem_u32(&xbar[slot]), peer));
        }
        // every block's partials of the rows: the rows' maxima and scales
        // (the same in every block; rank 0 stores them)
        stk::mbar_wait_cluster(&xbar[slot], (round >> 1) & 1);
        if (tid == 0) stk::mbar_arrive_tx(&xbar[slot], n_tiles * S::ROWS * 4);
#pragma unroll
        for (int half = 0; half < 2; ++half) {
          const int rr = 16 * warp + g + 8 * half, row = m0 + rr;
          float amax = 0.0f;  // the row's four threads read every fourth block's
          for (int peer = t; peer < n_tiles; peer += 4)
            amax = fmaxf(amax, xch[(slot * SQ_BLOCKS + peer) * S::ROWS + rr]);
          amax = fmaxf(amax, __shfl_xor_sync(0xffffffffu, amax, 1));
          amax = fmaxf(amax, __shfl_xor_sync(0xffffffffu, amax, 2));
          sc[half] = stk::quant_scale(amax);
          rc[half] = stk::quant_recip(sc[half]);
          if (rank == 0 && t == 0 && row < p.M) p.sxo[row] = sc[half];
        }
        // the tile's xq, two bytes a pair, into the output buffer
#pragma unroll
        for (int j = 0; j < BN / 8; ++j)
#pragma unroll
          for (int half = 0; half < 2; ++half) {
            const float2 f = unpack(h[j][half]);
            const uint32_t q0 = (uint32_t)stk::quantize1(f.x, sc[half], rc[half]) & 0xffu;
            const uint32_t q1 = (uint32_t)stk::quantize1(f.y, sc[half], rc[half]) & 0xffu;
            *reinterpret_cast<uint16_t*>(pair_at<S>(buf, j, 16 * warp + g + 8 * half, t)) =
                (uint16_t)(q0 | (q1 << 8));
          }
      } else if constexpr (MODE == MODE_ROPE) {
        // the rope form: the pair (j, jp = j + QN) of a head's two halves
        // sits in one thread (columns 8j + 2t and 8jp + 2t); each angle pair
        // (cos cv and sin sv of the head's columns 8q + 2t, + 1 at the row)
        // serves the tile's BN / DH heads
        constexpr int QN = DH / 16;  // 8-column groups of a half head
        if constexpr (ANG_TMA) {
          // the tile's bias forms first, two bf16 a word (half the sums'
          // registers; the bias and scale pairs read once a column pair),
          // then a row at a time: the row's angle pairs from the buffer
          // into registers, the warp's barrier, the row's results over
          // them. The same bytes hold a row's angles (its cos under its
          // first 64 columns, its sin under the next) and its results, and
          // only the row's four threads, one warp, read and write them.
          uint32_t bf[MI][2][BN / 8];
#pragma unroll
          for (int j = 0; j < BN / 8; ++j) {
            const float2 bl = *reinterpret_cast<const float2*>(bias_s + 8 * j + 2 * t);
            const float2 wv = Q8 ? *reinterpret_cast<const float2*>(ws_s + 8 * j + 2 * t) : bl;
#pragma unroll
            for (int r = 0; r < MI; ++r)
#pragma unroll
              for (int half = 0; half < 2; ++half)
                bf[r][half][j] = bias_pair(
                    acc[r][4 * j + 2 * half], acc[r][4 * j + 2 * half + 1],
                    with_scale<Q8>(Q8 ? bl : bf16_pair(bl.x, bl.y), wv, Q8 ? sxr[r][half] : 0.0f));
          }
#pragma unroll
          for (int r = 0; r < MI; ++r)
#pragma unroll
            for (int half = 0; half < 2; ++half) {
              const int rr = 64 * r + 16 * warp + g + 8 * half;
              float2 cvs[QN], svs[QN];
#pragma unroll
              for (int q = 0; q < QN; ++q) {
                // f32 columns 8q + 2t, + 1 of the row's 128 bytes: chunk 2q
                // + t / 2, swizzled by the row as TMA's 128-byte swizzle lays it
                const uint8_t* at = buf + rr * 128 + (((2 * q + t / 2) ^ (rr % 8)) << 4) +
                                    8 * (t % 2);
                cvs[q] = *reinterpret_cast<const float2*>(at);
                svs[q] = *reinterpret_cast<const float2*>(at + S::ROWS * 128);
              }
              __syncwarp();
#pragma unroll
              for (int q = 0; q < QN; ++q)
#pragma unroll
                for (int h = 0; h < BN / DH; ++h) {
                  const int j = h * (DH / 8) + q, jp = j + QN;
                  uint32_t o1, o2;
                  rotate(bf[r][half][j], bf[r][half][jp], cvs[q], svs[q], o1, o2);
                  *reinterpret_cast<uint32_t*>(pair_at<S>(buf, j, rr, t)) = o1;
                  *reinterpret_cast<uint32_t*>(pair_at<S>(buf, jp, rr, t)) = o2;
                }
            }
        } else {
          // the angles from device memory (L2), a pair a row at a time
#pragma unroll
          for (int q = 0; q < QN; ++q)
#pragma unroll
            for (int r = 0; r < MI; ++r)
#pragma unroll
              for (int half = 0; half < 2; ++half) {
                const int rr = 64 * r + 16 * warp + g + 8 * half, row = m0 + row0 + rr;
                const size_t ce = (size_t)(row < p.M ? row : p.M - 1) * (DH / 2) + 8 * q + 2 * t;
                const float2 cv = __ldg(reinterpret_cast<const float2*>(p.cs + ce));
                const float2 sv = __ldg(reinterpret_cast<const float2*>(p.sn + ce));
                const float s = Q8 ? sxr[r][half] : 0.0f;
#pragma unroll
                for (int h = 0; h < BN / DH; ++h) {
                  const int j = h * (DH / 8) + q, jp = j + QN;
                  const float2 ba = *reinterpret_cast<const float2*>(bias_s + 8 * j + 2 * t);
                  const float2 bb = *reinterpret_cast<const float2*>(bias_s + 8 * jp + 2 * t);
                  float2 wa = make_float2(0.0f, 0.0f), wb = wa;
                  if constexpr (Q8) {
                    wa = *reinterpret_cast<const float2*>(ws_s + 8 * j + 2 * t);
                    wb = *reinterpret_cast<const float2*>(ws_s + 8 * jp + 2 * t);
                  }
                  const uint32_t a = bias_pair(acc[r][4 * j + 2 * half], acc[r][4 * j + 2 * half + 1],
                                               with_scale<Q8>(Q8 ? ba : bf16_pair(ba.x, ba.y), wa, s));
                  const uint32_t b = bias_pair(acc[r][4 * jp + 2 * half],
                                               acc[r][4 * jp + 2 * half + 1],
                                               with_scale<Q8>(Q8 ? bb : bf16_pair(bb.x, bb.y), wb, s));
                  uint32_t o1, o2;
                  rotate(a, b, cv, sv, o1, o2);
                  *reinterpret_cast<uint32_t*>(pair_at<S>(buf, j, rr, t)) = o1;
                  *reinterpret_cast<uint32_t*>(pair_at<S>(buf, jp, rr, t)) = o2;
                }
              }
        }
      } else {
        // epilogue from the registers: rows 64r + 16 warp + g (+ 8) of the
        // consumer's rows, columns 8j + 2t (+ 1), a column pair a value
#pragma unroll
        for (int j = 0; j < BN / 8; ++j) {
          const int c = 8 * j + 2 * t, col = n0 + c;
          const float2 bl = *reinterpret_cast<const float2*>(bias_s + c);
          const float2 b = Q8 ? bl : bf16_pair(bl.x, bl.y);
          const float2 wv = Q8 ? *reinterpret_cast<const float2*>(ws_s + c) : bl;
#pragma unroll
          for (int r = 0; r < MI; ++r)
#pragma unroll
            for (int half = 0; half < 2; ++half) {
              const int rr = 64 * r + 16 * warp + g + 8 * half, row = m0 + row0 + rr;
              // (the int32 sums of Q8 made float as __int2float_rn makes them)
              const float v0 = acc[r][4 * j + 2 * half], v1 = acc[r][4 * j + 2 * half + 1];
              const auto bq = with_scale<Q8>(b, wv, Q8 ? sxr[r][half] : 0.0f);
              const float m = MODE == MODE_TAIL ? mk[r][half] : 0.0f;
              const float d = MODE == MODE_TAIL ? dtr[r][half] : 0.0f;
              float2 gv = make_float2(1.0f, 1.0f);
              uint32_t gw = 0;  // TMA-stored residual tiles: the gate pair's bf16 bits
              if constexpr (MODE == MODE_RESID) {
                if (S::TMA_STORE && p.gate && gsel[r][half] < 2) {
                  gw = gate_s[gsel[r][half] * (BN / 2) + 4 * j + t];
                } else {
                  gv = gate_pair(p, row, col);
                  gw = stk::pack_bf16(gv.x, gv.y);
                }
              }
              if constexpr (S::TMA_STORE) {
                uint8_t* at = pair_at<S>(buf, j, rr, t);
                if constexpr (MODE == MODE_RESID) {
                  // the residual's pair where the result's goes, in rbuf
                  const uint32_t x = *reinterpret_cast<const uint32_t*>(rbuf + (at - buf));
                  *reinterpret_cast<uint32_t*>(at) = gated_pair(bias_pair(v0, v1, bq), x, gw);
                } else {
                  float2 x = make_float2(0.0f, 0.0f);
                  if constexpr (MODE == MODE_TAIL) x = *reinterpret_cast<const float2*>(at);
                  *reinterpret_cast<stk::Pair<S::ES>*>(at) =
                      epi_pair_tab<MODE, TAB>(silu_tab, v0, v1, bq, x, gv, m, d);
                }
              } else if (row < p.M && col < p.N) {
                const size_t e = (size_t)row * p.N + col;
                float2 x = make_float2(0.0f, 0.0f);
                if constexpr (MODE == MODE_TAIL)
                  x = make_float2(p.x_in[e], col + 1 < p.N ? p.x_in[e + 1] : 0.0f);
                if constexpr (MODE == MODE_RESID) x = load_pair(p.res, e, col, p.N);
                const auto v = epi_pair_tab<MODE, TAB>(silu_tab, v0, v1, bq, x, gv, m, d);
                stk::store_pair_any(reinterpret_cast<Out*>(p.y), e, col, p.N, v);
              }
            }
        }
      }
      if constexpr (S::TMA_STORE) {
        stk::fence_proxy_async();
        stk::named_bar_sync(1 + wg, 128);
        if (tid == 0) {
#pragma unroll
          for (int h = 0; h < BN / S::BOX; ++h)
            stk::tma_store_2d(&tm_y, buf + h * S::ROWS * 128, n0 + S::BOX * h, m0 + row0);
          stk::bulk_commit();
        }
      }
      if constexpr (NEXT) {
        // the consumer's next tile's residual, bias columns, weight scales
        // and gate rows: this epilogue has read theirs (the barrier above)
        const int next = tile + STRIDE * units;
        if (next < tiles) {
          const int m1 = ((next / n_tiles) * CM + crank) * S::BM, n1 = (next % n_tiles) * BN;
          if (tid == 0) load_in(m1, n1);
          stage(m1, n1);
        }
      }
    }
    if (S::TMA_STORE && threadIdx.x % 128 == 0) stk::bulk_wait<0>();  // the stores have landed
  }
  // no block of a cluster leaves while another may still write into its
  // slots or stages, or arrive on its barriers
  if constexpr (SILUQ || CM > 1) stk::cluster_sync();
}

// the bf16 linear (a trace names it linear_wgmma) and the W8A8 forms
// (w8a8_wgmma): one body
template <int MODE, typename S, int DH>
__global__ void __launch_bounds__(S::THREADS, S::BPS)
linear_wgmma(__grid_constant__ const CUtensorMap tm_x, __grid_constant__ const CUtensorMap tm_w,
             __grid_constant__ const CUtensorMap tm_y, __grid_constant__ const CUtensorMap tm_xin,
             __grid_constant__ const CUtensorMap tm_sn, Args p, int n_tiles, int tiles) {
  wgmma_body<false, MODE, S, DH>(tm_x, tm_w, tm_y, tm_xin, tm_sn, p, n_tiles, tiles);
}

template <int MODE, typename S, int DH>
__global__ void __launch_bounds__(S::THREADS, S::BPS)
w8a8_wgmma(__grid_constant__ const CUtensorMap tm_x, __grid_constant__ const CUtensorMap tm_w,
           __grid_constant__ const CUtensorMap tm_y, __grid_constant__ const CUtensorMap tm_xin,
           __grid_constant__ const CUtensorMap tm_sn, Args p, int n_tiles, int tiles) {
  wgmma_body<true, MODE, S, DH>(tm_x, tm_w, tm_y, tm_xin, tm_sn, p, n_tiles, tiles);
}

// ---------------------------------------------------------------------------
// a K no multiple of 8, or a W8A8 rope form at a head width no tile holds: SIMT
// ---------------------------------------------------------------------------
constexpr int S_THREADS = 256, S_TILE = 64, S_KC = 32;

// a 64 x 64 tile of Y a block, each thread rows ty + 16 i (i < 4) and
// columns 4 tx .. 4 tx + 3 (two pairs), K in chunks of 32 staged as f32 (Q8:
// int8 staged as int, exact int32 sums). In
// the rope form (any even head width) the block's 64 columns are 32 rotated
// pairs u0 + c (u0 = 32 blockIdx.y; pair u: position u % (dh / 2) of head u /
// (dh / 2)): column c < 32 the first half's, c + 32 its partner in the
// second half; a thread's are pairs 2 tx, 2 tx + 1 and their partners.
template <bool Q8, int MODE>
__device__ __forceinline__ void simt_body(const std::conditional_t<Q8, int8_t, bf16>* __restrict__ X,
                                          const std::conditional_t<Q8, int8_t, bf16>* __restrict__ W,
                                          const Args& p) {
  using Out = std::conditional_t<MODE == MODE_TAIL, float, bf16>;
  using Acc = std::conditional_t<Q8, int, float>;
  constexpr int HT = S_TILE / 2;
  __shared__ Acc xs[S_KC][S_TILE + 1], ws[S_KC][S_TILE + 1];
  auto value = [](auto v) {  // an operand as the sums take it
    if constexpr (Q8)
      return (int)v;
    else
      return __bfloat162float(v);
  };
  const int M = p.M, N = p.N, K = p.K, hf = p.dh / 2;
  const int tx = threadIdx.x % 16, ty = threadIdx.x / 16;
  const int m0 = blockIdx.x * S_TILE, n0 = blockIdx.y * S_TILE;
  // the block's column c (past N for pairs past the last head)
  auto column = [&](int c) {
    if constexpr (MODE == MODE_ROPE) {
      const int u = blockIdx.y * HT + c % HT;
      return (u / hf) * p.dh + u % hf + (c >= HT ? hf : 0);
    } else {
      return n0 + c;
    }
  };
  // the block column of the thread's column j < 4
  auto mine = [&](int j) {
    return MODE == MODE_ROPE ? 2 * tx + (j & 1) + (j >> 1) * HT : 4 * tx + j;
  };
  Acc acc[4][4];
#pragma unroll
  for (int i = 0; i < 4; ++i)
#pragma unroll
    for (int j = 0; j < 4; ++j) acc[i][j] = Acc(0);
  for (int k0 = 0; k0 < K; k0 += S_KC) {
    for (int i = threadIdx.x; i < S_TILE * S_KC; i += S_THREADS) {
      const int r = i / S_KC, kk = i % S_KC, k = k0 + kk, n = column(r);
      xs[kk][r] = m0 + r < M && k < K ? value(X[(size_t)(m0 + r) * K + k]) : Acc(0);
      ws[kk][r] = n < N && k < K ? value(W[(size_t)n * K + k]) : Acc(0);
    }
    __syncthreads();
#pragma unroll 8
    for (int kk = 0; kk < S_KC; ++kk) {
      Acc a[4], b[4];
#pragma unroll
      for (int i = 0; i < 4; ++i) a[i] = xs[kk][ty + 16 * i];
#pragma unroll
      for (int j = 0; j < 4; ++j) b[j] = ws[kk][mine(j)];
#pragma unroll
      for (int i = 0; i < 4; ++i)
#pragma unroll
        for (int j = 0; j < 4; ++j)
          if constexpr (Q8)
            acc[i][j] += a[i] * b[j];
          else
            acc[i][j] = fmaf(a[i], b[j], acc[i][j]);
    }
    __syncthreads();
  }
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const int row = m0 + ty + 16 * i;
    if (row >= M) continue;
    const float m = MODE == MODE_TAIL ? p.mask[row] : 0.0f;
    const float d = MODE == MODE_TAIL ? p.dt[row / p.T] : 0.0f;
    const float s = Q8 ? p.sx[row] : 0.0f;
    // the bias pair of columns c0, c1 as bias_pair takes it (c1 < 0: none)
    auto bias_of = [&](int c0, int c1) {
      const float2 b = make_float2(p.bias[c0], c1 >= 0 ? p.bias[c1] : 0.0f);
      float2 w = make_float2(0.0f, 0.0f);
      if constexpr (Q8) w = make_float2(p.ws[c0], c1 >= 0 ? p.ws[c1] : 0.0f);
      return with_scale<Q8>(Q8 ? b : bf16_pair(b.x, b.y), w, s);
    };
#pragma unroll
    for (int q = 0; q < 2; ++q) {
      if constexpr (MODE == MODE_ROPE) {
        // pair u: the bias forms of its two columns, rotated
        const int u = blockIdx.y * HT + 2 * tx + q;
        if (u >= N / 2) continue;
        const int ca = column(2 * tx + q), cb = ca + hf;
        const float2 ab = unpack(bias_pair(acc[i][q], acc[i][2 + q], bias_of(ca, cb)));
        const size_t ce = (size_t)row * hf + u % hf;
        const float c = p.cs[ce], s = p.sn[ce];
        bf16* y = reinterpret_cast<bf16*>(p.y) + (size_t)row * N;
        y[ca] = __float2bfloat16_rn(__fsub_rn(__fmul_rn(ab.x, c), __fmul_rn(ab.y, s)));
        y[cb] = __float2bfloat16_rn(__fadd_rn(__fmul_rn(ab.x, s), __fmul_rn(ab.y, c)));
      } else {
        const int col = n0 + 4 * tx + 2 * q;
        if (col >= N) continue;
        const bool two = col + 1 < N;
        const size_t e = (size_t)row * N + col;
        float2 x = make_float2(0.0f, 0.0f), gv = make_float2(1.0f, 1.0f);
        if constexpr (MODE == MODE_TAIL) x = make_float2(p.x_in[e], two ? p.x_in[e + 1] : 0.0f);
        if constexpr (MODE == MODE_RESID) {
          x = load_pair(p.res, e, col, N);
          gv = gate_pair(p, row, col);
        }
        stk::store_pair_any(reinterpret_cast<Out*>(p.y), e, col, N,
                            epi_pair<MODE>(acc[i][2 * q], acc[i][2 * q + 1],
                                           bias_of(col, two ? col + 1 : -1), x, gv, m, d));
      }
    }
  }
}

template <int MODE>
__global__ void __launch_bounds__(S_THREADS) linear_simt(const bf16* __restrict__ X,
                                                         const bf16* __restrict__ W, Args p) {
  simt_body<false, MODE>(X, W, p);
}

template <int MODE>
__global__ void __launch_bounds__(S_THREADS) w8a8_simt(const int8_t* __restrict__ X,
                                                       const int8_t* __restrict__ W, Args p) {
  simt_body<true, MODE>(X, W, p);
}

// ---------------------------------------------------------------------------
// instances and launch
// ---------------------------------------------------------------------------

// NC, MI, BN, stages, blocks an SM, shared tiles, TMA store, result bytes
using Many = Tile<2, 2, 128, 5, 1, false, true, 2>;      // 128 x 128, two consumers in turns
using ManySilu = Tile<4, 1, 128, 5, 1, false, true, 2>;  // 64 x 128, four consumers in turns
using Few = Tile<1, 1, 64, 6, 2, false, true, 2>;        // 64 x 64, one consumer a block
using AnyN = Tile<1, 1, 32, 8, 2, false, false, 2>;      // 64 x 32, from the registers
using TailTile = Tile<2, 1, 96, 6, 1, false, true, 4>;   // 64 x 96 f32, x_in by TMA
using TailAnyN = Tile<1, 1, 32, 8, 2, false, false, 4>;  // 64 x 32 f32, from the registers
using ManyResid = Tile<3, 1, 128, 7, 1, false, true, 2>;  // the residual form at many tiles
// the residual form at many tiles: 64 x 128 tiles of three consumers, each
// with a buffer for its next tile's residual beside its output buffer (the
// 5 ring stages that fit beside them)
using ResidNext = Tile<3, 1, 128, 5, 1, false, true, 2, 0, 1, true>;
// the residual form at many tiles where a block's 128 columns of W fit in
// its shared memory (K up to RESID_W_K): 64 x 128 tiles of three consumers,
// W resident, X through the ring; the blocks of a column tile walk its row
// tiles (bf16: W 128 KiB, 5 stages; W8A8: W 64 KiB, 12 stages)
using ResidW = Tile<3, 1, 128, 5, 1, false, true, 2, 8>;
using ResidW8 = Tile<3, 1, 128, 12, 1, false, true, 2, 4>;
constexpr int RESID_W_K = 512;
static_assert(ResidW::WRS * 64 == RESID_W_K && ResidW8::WRS * 128 == RESID_W_K, "resident K");
// the residual form at many tiles and larger K: 64 x 128 tiles of three
// consumers, a cluster of two blocks along M sharing each W stage
using ResidPair = Tile<3, 1, 128, 7, 1, false, true, 2, 0, 2>;
using RopeMany = Tile<2, 2, 128, 5, 1, false, true, 2>;   // the rope form at Dh 16, 32, 64, 128
using Rope192 = Tile<2, 1, 192, 5, 1, false, true, 2>;   // 64 x 192: the rope form at Dh 96, 192
using Rope256 = Tile<2, 1, 256, 3, 1, false, true, 2>;   // 64 x 256: the rope form at Dh 256
// the W8A8 rope form at Dh 16, 32, 64, 128: RopeMany's 128 x 128 tiles with
// the 4 ring stages that fit beside the weight scales' slices
using RopeMany8 = Tile<2, 2, 128, 4, 1, false, true, 2>;
// the W8A8 silu-quantize form: 64 x 128 int8 tiles, three consumers in
// turns, W resident (K up to 512), X through 8 ring stages, a cluster of N /
// 128 blocks
using SiluQ = Tile<3, 1, 128, 8, 1, false, true, 1, 4>;

template <typename S>
long long tiles_of(int M, int N) {
  return (long long)((M + S::BM - 1) / S::BM) * ((N + S::BN - 1) / S::BN);
}

// Q8: a W8A8 form, x [M, K] and w [N, K] int8
template <int MODE, typename S, int DH = 0, bool Q8 = false>
int launch_tiles(const void* x, const void* w, const Args& p, cudaStream_t st) {
  using In = std::conditional_t<Q8, int8_t, bf16>;
  constexpr CUtensorMapDataType in_type =
      Q8 ? CU_TENSOR_MAP_DATA_TYPE_UINT8 : CU_TENSOR_MAP_DATA_TYPE_BFLOAT16;
  constexpr bool SILUQ = MODE == MODE_SILUQ;
  using Out = std::conditional_t<MODE == MODE_TAIL, float,
                                 std::conditional_t<SILUQ, int8_t, bf16>>;
  constexpr CUtensorMapDataType out_type =
      MODE == MODE_TAIL ? CU_TENSOR_MAP_DATA_TYPE_FLOAT32
                        : SILUQ ? CU_TENSOR_MAP_DATA_TYPE_UINT8 : CU_TENSOR_MAP_DATA_TYPE_BFLOAT16;
  const long long tiles = tiles_of<S>(p.M, p.N);
  if (tiles > 0x7fffffff) return (int)cudaErrorInvalidValue;
  int sms = 0;
  if (int err = stk::sm_count(sms)) return err;
  const long long per_block = S::COOP ? tiles : (tiles + S::NC - 1) / S::NC;
  int blocks = (int)(per_block > (long long)sms * S::BPS ? (long long)sms * S::BPS : per_block);
  const int n_tiles = (p.N + S::BN - 1) / S::BN;
  if constexpr (S::WRS > 0 && !SILUQ) {
    // W resident: the blocks of column tile c are those of blockIdx.x % n_tiles
    // == c, each walking that tile's rows in steps of gridDim.x / n_tiles
    const long long per_column = (tiles / n_tiles + S::NC - 1) / S::NC;
    const long long fit = (long long)sms * S::BPS / n_tiles;
    if (fit < 1) return (int)cudaErrorInvalidValue;
    blocks = n_tiles * (int)(per_column < fit ? per_column : fit);
  }
  // encoded at every launch: a graph capture keeps this launch's maps
  CUtensorMap tx, tw, ty = {}, txin = {}, tsn = {};
  if (int err = stk::encode_rows<In>(&tx, x, p.M, p.K, S::BM, in_type)) return err;
  if (int err = stk::encode_rows<In>(&tw, w, p.N, p.K, S::BN / S::CM, in_type)) return err;
  if constexpr (S::TMA_STORE) {  // [M, N] in boxes of 128 bytes of a row x a consumer's rows
    if (int err = stk::encode_rows<Out>(&ty, p.y, p.M, p.N, S::ROWS, out_type)) return err;
    if constexpr (MODE == MODE_TAIL)
      if (int err = stk::encode_rows<float>(&txin, p.x_in, p.M, p.N, S::ROWS, out_type))
        return err;
    if constexpr (MODE == MODE_RESID)
      if (int err = stk::encode_rows<bf16>(&txin, p.res, p.M, p.N, S::ROWS, out_type)) return err;
    if constexpr (MODE == MODE_ROPE && angles_by_tma<S, DH>()) {  // cos, sin [M, DH / 2] f32
      if (int err = stk::encode_rows<float>(&txin, p.cs, p.M, DH / 2, S::ROWS,
                                            CU_TENSOR_MAP_DATA_TYPE_FLOAT32))
        return err;
      if (int err = stk::encode_rows<float>(&tsn, p.sn, p.M, DH / 2, S::ROWS,
                                            CU_TENSOR_MAP_DATA_TYPE_FLOAT32))
        return err;
    }
  }
  auto kernel = [] {
    if constexpr (Q8)
      return w8a8_wgmma<MODE, S, DH>;
    else
      return linear_wgmma<MODE, S, DH>;
  }();
  constexpr size_t smem = smem_of<MODE, S, Q8>();
  static_assert(smem * S::BPS <= 232448, "the blocks' shared memory");
  static size_t smem_set[stk::kMaxDevices] = {};  // one per instantiation
  if (int err = stk::allow_dynamic_smem(kernel, smem, smem_set)) return err;
  static int regs_at_entry = 0;
  if (int err = stk::check_reg_split(kernel, 128, S::NC * 128,
                                     stk::consumer_regs(S::NC, S::BPS), regs_at_entry))
    return err;
  if constexpr (SILUQ || S::CM > 1) {
    // the silu-quantize form: a cluster of n_tiles blocks a row block; a
    // cluster along M: CM blocks a unit of CM row tiles. As many clusters as
    // the card holds at once (asked once per device and cluster size), each
    // walking its units in turns; none fitting raises
    const int size = SILUQ ? n_tiles : S::CM;
    const long long units = SILUQ ? tiles / n_tiles
                                  : (((p.M + S::BM - 1) / S::BM + S::CM - 1) / S::CM) * n_tiles;
    const long long wanted = SILUQ ? units : (units + S::NC - 1) / S::NC;
    cudaLaunchConfig_t cfg = {};
    cudaLaunchAttribute attr[1];
    attr[0].id = cudaLaunchAttributeClusterDimension;
    attr[0].val.clusterDim.x = size;
    attr[0].val.clusterDim.y = 1;
    attr[0].val.clusterDim.z = 1;
    cfg.blockDim = dim3(S::THREADS);
    cfg.dynamicSmemBytes = smem;
    cfg.stream = st;
    cfg.attrs = attr;
    cfg.numAttrs = 1;
    int dev = 0;
    if (int err = (int)cudaGetDevice(&dev)) return err;
    if (dev < 0 || dev >= stk::kMaxDevices) return (int)cudaErrorInvalidDevice;
    static int fits[stk::kMaxDevices][SQ_BLOCKS + 1] = {};
    if (size > SQ_BLOCKS) return (int)cudaErrorInvalidValue;
    if (!fits[dev][size]) {
      if (size > 8)  // a non-portable cluster size
        if (int err = (int)cudaFuncSetAttribute(
                kernel, cudaFuncAttributeNonPortableClusterSizeAllowed, 1))
          return err;
      cfg.gridDim = dim3(size);
      if (int err = (int)cudaOccupancyMaxActiveClusters(&fits[dev][size], kernel, &cfg))
        return err;
      if (fits[dev][size] < 1) return (int)cudaErrorInvalidConfiguration;
    }
    cfg.gridDim = dim3((unsigned)(size * (wanted < fits[dev][size] ? wanted : fits[dev][size])));
    return (int)cudaLaunchKernelEx(&cfg, kernel, tx, tw, ty, txin, tsn, p, n_tiles,
                                   (int)(SILUQ ? tiles : units));
  } else {
    kernel<<<blocks, S::THREADS, smem, st>>>(tx, tw, ty, txin, tsn, p, n_tiles, (int)tiles);
    return (int)cudaGetLastError();
  }
}

// the instances, in stk_linear_tiles' order, and the SIMT kernel
enum Instance { I_MANY, I_MANY_SILU, I_FEW, I_ANY_N, I_TAIL, I_TAIL_ANY_N, I_ROPE_192, I_ROPE_256,
                I_RESID_MANY, I_RESID_W, I_RESID_PAIR, I_SIMT };

// the instance a launch of mode at M x N x K (the rope form: heads of dh)
// takes on a card of sms SMs
Instance pick(int mode, int M, int N, int K, int dh, int sms) {
  if (K % 8) return I_SIMT;  // rows of X and W no TMA map takes
  if (mode == MODE_TAIL) return N % 4 ? I_TAIL_ANY_N : I_TAIL;
  if (mode == MODE_ROPE) {  // a tile of whole heads, each half in whole 8-column groups
    switch (dh) {
      case 16: case 32: case 128: return I_MANY;
      case 64: return tiles_of<Many>(M, N) >= 2LL * sms ? I_MANY : I_FEW;
      case 96: case 192: return I_ROPE_192;
      case 256: return I_ROPE_256;
      default: return I_SIMT;  // any other even width
    }
  }
  if (N % 8) return I_ANY_N;  // rows no TMA map takes
  if (tiles_of<Many>(M, N) >= 2LL * sms)
    return mode == MODE_SILU ? I_MANY_SILU : mode == MODE_RESID ? I_RESID_MANY : I_MANY;
  // the residual form keeps TMA-stored tiles (the residual lands during the
  // products) where the bias form takes narrower ones from the registers
  if (mode == MODE_RESID || 2 * tiles_of<Few>(M, N) >= sms) return I_FEW;
  return I_ANY_N;  // more, narrower tiles
}

// Q8: a W8A8 form (rope or residual), x and w int8
template <int MODE, bool Q8 = false>
int launch(const void* x, const void* w, const Args& p, cudaStream_t st) {
  const int M = p.M, N = p.N, K = p.K;
  if (M < 1 || N < 1 || K < 1) return (int)cudaErrorInvalidValue;
  int sms = 0;
  if (int err = stk::sm_count(sms)) return err;
  const Instance in = pick(MODE, M, N, K, p.dh, sms);
  if (in == I_SIMT) {
    const long long n_tiles = (N + S_TILE - 1) / S_TILE;
    if (n_tiles > 65535) return (int)cudaErrorInvalidValue;
    const dim3 grid((M + S_TILE - 1) / S_TILE, (unsigned)n_tiles);
    if constexpr (Q8)
      w8a8_simt<MODE><<<grid, S_THREADS, 0, st>>>((const int8_t*)x, (const int8_t*)w, p);
    else
      linear_simt<MODE><<<grid, S_THREADS, 0, st>>>((const bf16*)x, (const bf16*)w, p);
    return (int)cudaGetLastError();
  }
  if constexpr (MODE == MODE_TAIL) {
    return in == I_TAIL ? launch_tiles<MODE, TailTile>(x, w, p, st)
                        : launch_tiles<MODE, TailAnyN>(x, w, p, st);
  } else if constexpr (MODE == MODE_ROPE) {
    using RopeManyOf = std::conditional_t<Q8, RopeMany8, RopeMany>;
    if (in == I_FEW) return launch_tiles<MODE, Few, 64, Q8>(x, w, p, st);
    if (in == I_ROPE_256) return launch_tiles<MODE, Rope256, 256, Q8>(x, w, p, st);
    if (in == I_ROPE_192)
      return p.dh == 96 ? launch_tiles<MODE, Rope192, 96, Q8>(x, w, p, st)
                        : launch_tiles<MODE, Rope192, 192, Q8>(x, w, p, st);
    switch (p.dh) {
      case 16: return launch_tiles<MODE, RopeManyOf, 16, Q8>(x, w, p, st);
      case 32: return launch_tiles<MODE, RopeManyOf, 32, Q8>(x, w, p, st);
      case 64: return launch_tiles<MODE, RopeManyOf, 64, Q8>(x, w, p, st);
      default: return launch_tiles<MODE, RopeManyOf, 128, Q8>(x, w, p, st);
    }
  } else {
    using ManyOfMode = std::conditional_t<MODE == MODE_SILU, ManySilu, Many>;
    if constexpr (MODE == MODE_RESID) {
      if (in == I_RESID_W)
        return launch_tiles<MODE, std::conditional_t<Q8, ResidW8, ResidW>, 0, Q8>(x, w, p, st);
      if (in == I_RESID_PAIR) return launch_tiles<MODE, ResidPair, 0, Q8>(x, w, p, st);
      if (in == I_RESID_MANY) return launch_tiles<MODE, ResidNext, 0, Q8>(x, w, p, st);
    } else if (in == I_MANY || in == I_MANY_SILU) {
      return launch_tiles<MODE, ManyOfMode, 0, Q8>(x, w, p, st);
    }
    if (in == I_FEW) return launch_tiles<MODE, Few, 0, Q8>(x, w, p, st);
    return launch_tiles<MODE, AnyN, 0, Q8>(x, w, p, st);
  }
}

}  // namespace

// x [M, K] and w [N, K] bf16, bias [N] f32; mode 0 (bias) and 1 (bias,
// silu): y [M, N] bf16; mode 2 (the flow step's tail): x_in [M, N] f32,
// mask [M] f32, dt [M / T] f32 (T rows a batch row), y [M, N] f32. All
// contiguous and 16-byte aligned.
extern "C" int stk_linear(const void* x, const void* w, const void* bias, const void* x_in,
                          const void* mask, const void* dt, void* y, int M, int N, int K, int T,
                          int mode, void* stream) {
  auto f = [](const void* q) { return (const float*)q; };
  const bf16* xb = (const bf16*)x;
  const bf16* wb = (const bf16*)w;
  cudaStream_t st = (cudaStream_t)stream;
  if (T < 1) return (int)cudaErrorInvalidValue;
  const Args p{f(bias), f(x_in), f(mask), f(dt), nullptr, nullptr, nullptr, nullptr, 0, y,
               M, N, K, T, 0};
  if (mode == MODE_BIAS) return launch<MODE_BIAS>(xb, wb, p, st);
  if (mode == MODE_SILU) return launch<MODE_SILU>(xb, wb, p, st);
  if (mode == MODE_TAIL) return launch<MODE_TAIL>(xb, wb, p, st);
  return (int)cudaErrorInvalidValue;
}

// The Q, K and O projections' forms, x [M, K] and w [N, K] bf16, bias [N]
// f32, y [M, N] bf16: mode 3 (rope) cs, sn [M, dh / 2] f32, heads of dh
// columns (dh even, dividing N) rotated; mode 4 (the gated residual) res
// [M, N] bf16 and gate rows of N bf16, batch row i (T rows a batch row) at i
// * gstride, or null (gate and gstride 4-byte aligned at an even N). All
// else contiguous and 16-byte aligned.
extern "C" int stk_linear_epilogue(const void* x, const void* w, const void* bias, const void* cs,
                                   const void* sn, const void* res, const void* gate,
                                   long long gstride, void* y, int M, int N, int K, int T, int dh,
                                   int mode, void* stream) {
  const bf16* xb = (const bf16*)x;
  const bf16* wb = (const bf16*)w;
  cudaStream_t st = (cudaStream_t)stream;
  if (T < 1 || gstride < 0) return (int)cudaErrorInvalidValue;
  const Args p{(const float*)bias, nullptr, nullptr, nullptr, (const float*)cs, (const float*)sn,
               (const bf16*)res, (const bf16*)gate, gstride, y, M, N, K, T, dh};
  if (mode == MODE_ROPE) {
    if (dh < 2 || dh % 2 || N % dh) return (int)cudaErrorInvalidValue;
    return launch<MODE_ROPE>(xb, wb, p, st);
  }
  if (mode == MODE_RESID) return launch<MODE_RESID>(xb, wb, p, st);
  return (int)cudaErrorInvalidValue;
}

// the instances' tiles, rows x columns x ring stages: bf16 results at many
// tiles (the bias and rope forms; the silu form), at few, at fewer
// or an N whose rows no TMA map takes, then the tail's f32 results (x_in by
// TMA) and the tail's at any N, then the rope form's at Dh 96 and 192 and at
// Dh 256, and the residual form's at many tiles: streaming W, W resident
// (the bf16 instance's stages), and a cluster along M sharing W
extern "C" int stk_linear_tiles(int* tiles) {
  const int v[33] = {Many::BM,      Many::BN,      Many::NS,      ManySilu::BM, ManySilu::BN,
                     ManySilu::NS,  Few::BM,       Few::BN,       Few::NS,      AnyN::BM,
                     AnyN::BN,      AnyN::NS,      TailTile::BM,  TailTile::BN, TailTile::NS,
                     TailAnyN::BM,  TailAnyN::BN,  TailAnyN::NS,  Rope192::BM,  Rope192::BN,
                     Rope192::NS,   Rope256::BM,   Rope256::BN,   Rope256::NS,  ResidNext::BM,
                     ResidNext::BN, ResidNext::NS, ResidW::BM,    ResidW::BN,   ResidW::NS,
                     ResidPair::BM, ResidPair::BN, ResidPair::NS};
  for (int i = 0; i < 33; ++i) tiles[i] = v[i];
  return 0;
}

// the instance a launch of mode at M x N x K (the rope form: heads of dh)
// takes on the current card: an index into stk_linear_tiles' list, 11 for
// the SIMT kernel, -1 for no launch
extern "C" int stk_linear_instance(int M, int N, int K, int mode, int dh) {
  int sms = 0;
  if (M < 1 || N < 1 || K < 1 || mode < MODE_BIAS || mode > MODE_RESID ||
      (mode == MODE_ROPE && (dh < 2 || dh % 2 || N % dh)) || stk::sm_count(sms))
    return -1;
  return (int)pick(mode, M, N, K, dh, sms);
}

// The W8A8 product's Q, K and O forms, xq [M, K] and w_q [N, K] int8 (K a
// positive multiple of 32), sx [M], w_scale [N] and bias [N] f32, y [M, N]
// bf16: the bias form (v * sx) * w_scale + bias rounded once, then mode 3
// (rope) or 4 (the gated residual), the other operands as
// stk_linear_epilogue takes them. All else contiguous and 16-byte aligned.
extern "C" int stk_w8a8_epilogue(const void* xq, const void* w_q, const void* sx,
                                 const void* w_scale, const void* bias, const void* cs,
                                 const void* sn, const void* res, const void* gate,
                                 long long gstride, void* y, int M, int N, int K, int T, int dh,
                                 int mode, void* stream) {
  cudaStream_t st = (cudaStream_t)stream;
  if (T < 1 || gstride < 0 || K < 32 || K % 32) return (int)cudaErrorInvalidValue;
  const Args p{(const float*)bias, nullptr, nullptr, nullptr, (const float*)cs, (const float*)sn,
               (const bf16*)res, (const bf16*)gate, gstride, y, M, N, K, T, dh,
               (const float*)sx, (const float*)w_scale};
  if (mode == MODE_ROPE) {
    if (dh < 2 || dh % 2 || N % dh) return (int)cudaErrorInvalidValue;
    return launch<MODE_ROPE, true>(xq, w_q, p, st);
  }
  if (mode == MODE_RESID) return launch<MODE_RESID, true>(xq, w_q, p, st);
  return (int)cudaErrorInvalidValue;
}

// The W8A8 FFN-in's silu form quantized for the FFN-out: xq [M, K] and w_q
// [N, K] int8 (K a positive multiple of 32 up to 512, N a multiple of 128 up
// to 2,048), sx [M], w_scale [N] and bias [N] f32 -> the rows of
// rnd(silu(rnd((v * sx) * w_scale + bias))) quantized as csrc/quantize.cu
// quantizes them: hq [M, N] int8, hs [M] f32. All contiguous and 16-byte
// aligned.
extern "C" int stk_w8a8_silu_quantize(const void* xq, const void* w_q, const void* sx,
                                      const void* w_scale, const void* bias, void* hq, void* hs,
                                      int M, int N, int K, void* stream) {
  if (M < 1 || K < 32 || K % 32 || K > SiluQ::WRS * 128 || N < SiluQ::BN || N % SiluQ::BN ||
      N > SQ_BLOCKS * SiluQ::BN)
    return (int)cudaErrorInvalidValue;
  Args p{(const float*)bias, nullptr, nullptr, nullptr, nullptr, nullptr, nullptr, nullptr, 0,
         hq, M, N, K, 1, 0, (const float*)sx, (const float*)w_scale, (float*)hs};
  return launch_tiles<MODE_SILUQ, SiluQ, 0, true>(xq, w_q, p, (cudaStream_t)stream);
}
